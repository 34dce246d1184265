"""First-party asyncio HTTP/1.1 + WebSocket (RFC 6455) micro-framework.

The reference rides FastAPI/uvicorn/starlette; those aren't vendored here,
and a serving framework should own its runtime — so this module implements
the subset the API surface needs: routing with ``{param}`` and
``{param:path}`` captures, JSON/file responses, multipart and urlencoded
form parsing, query strings, CORS, and WebSocket upgrade with text frames.

Starlette parity detail that matters for route registration: the FIRST
registration of a duplicate route wins (the reference registers
``/task/{id}/status`` twice, back/api.py:2141 vs 2327 — SURVEY.md §7).
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import logging
import os
import re
import struct
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, unquote, urlsplit

logger = logging.getLogger(__name__)

_WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
# Transport-level cap: slightly above the 25 MB product limit
# (back/api.py:1761) so the route handler produces the parity error message
# instead of a bare 413 (64 MB was far above the product cap).
MAX_BODY = 26 * 1024 * 1024 + 64 * 1024
# Total request-header bytes cap (uvicorn/h11 default is 64 KB-class; a
# client streaming unbounded header lines must not grow server memory).
MAX_HEADER_BYTES = 64 * 1024
# Per-frame cap on RECEIVED WebSocket frames: the progress sockets only
# ever receive small client texts; anything larger is a hostile frame.
MAX_WS_FRAME = 1024 * 1024
# Idle bound on the keep-alive gap / first request line, and an overall
# deadline for reading one request's headers. Without them a socket that
# connects and drips (or sends nothing) is held open forever — slowloris
# fd exhaustion against this single-process server. Body reads stay
# unbounded like uvicorn's defaults (slow uploads are legitimate).
KEEPALIVE_TIMEOUT_S = 75.0
HEADER_TIMEOUT_S = 30.0


class HTTPException(Exception):
    def __init__(self, status_code: int, detail: str = ""):
        self.status_code = status_code
        self.detail = detail

    def __str__(self) -> str:
        # Starlette's format — upload-url's outer wrap embeds str(exc) in
        # its 400 detail (back/api.py:1988), so the text must read
        # "413: File size ..." for byte parity.
        return f"{self.status_code}: {self.detail}"


class UploadedFile:
    def __init__(self, filename: str, content_type: str, content: bytes):
        self.filename = filename
        self.content_type = content_type
        self.content = content


class Request:
    def __init__(self, method: str, path: str, headers: Dict[str, str],
                 body: bytes, query: Dict[str, str],
                 path_params: Dict[str, str]):
        self.method = method
        self.path = path
        self.headers = headers
        self.body = body
        self.query = query
        self.path_params = path_params

    def json(self) -> Any:
        return json.loads(self.body or b"null")

    def form(self) -> Dict[str, str]:
        ctype = self.headers.get("content-type", "")
        if ctype.startswith("application/x-www-form-urlencoded"):
            parsed = parse_qs(self.body.decode("utf-8", "replace"))
            return {k: v[0] for k, v in parsed.items()}
        if ctype.startswith("multipart/form-data"):
            fields, _ = parse_multipart(self.body, ctype)
            return fields
        return {}

    def files(self) -> Dict[str, UploadedFile]:
        ctype = self.headers.get("content-type", "")
        if ctype.startswith("multipart/form-data"):
            _, files = parse_multipart(self.body, ctype)
            return files
        return {}


class Response:
    def __init__(self, body: bytes = b"", status: int = 200,
                 content_type: str = "text/plain",
                 headers: Optional[Dict[str, str]] = None):
        self.body = body
        self.status = status
        self.content_type = content_type
        self.headers = headers or {}


def json_response(content: Any, status_code: int = 200) -> Response:
    return Response(json.dumps(content).encode(), status_code, "application/json")


def file_response(path: str, media_type: str = "application/octet-stream",
                  filename: Optional[str] = None) -> Response:
    with open(path, "rb") as fh:
        body = fh.read()
    headers = {}
    if filename:
        # Filenames flow in from client uploads and URL basenames; CR/LF
        # would split the response head (header injection) and a bare
        # quote breaks the quoted-string — strip all three.
        safe = "".join(c for c in filename if c not in '\r\n"')
        headers["Content-Disposition"] = f'attachment; filename="{safe}"'
    return Response(body, 200, media_type, headers)


def parse_multipart(body: bytes, content_type: str
                    ) -> Tuple[Dict[str, str], Dict[str, UploadedFile]]:
    """RFC 2046 multipart parser, binary-safe.

    Part content is everything between the CRLF that ends the part headers
    and the CRLF that precedes the next ``--boundary`` delimiter — no byte
    stripping, so binary payloads ending in 0x0D/0x0A survive intact.
    """
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        raise HTTPException(400, "missing multipart boundary")
    delim = b"--" + m.group(1).encode()
    fields: Dict[str, str] = {}
    files: Dict[str, UploadedFile] = {}
    # The delimiter is defined as CRLF + "--" + boundary; the very first one
    # may open the body without a preceding CRLF — prepend one so a single
    # split handles both, leaving sections[0] as the (usually empty) preamble.
    sections = (b"\r\n" + body).split(b"\r\n" + delim)
    for part in sections[1:]:
        if part.startswith(b"--"):  # closing delimiter "--boundary--"
            break
        # Drop transport padding + the CRLF that terminates the delimiter line.
        eol = part.find(b"\r\n")
        if eol == -1 or part[:eol].strip(b" \t"):
            continue
        part = part[eol + 2:]
        head, sep, content = part.partition(b"\r\n\r\n")
        if not sep:
            continue
        headers = {}
        for line in head.decode("utf-8", "replace").split("\r\n"):
            if ":" in line:
                k, _, v = line.partition(":")
                headers[k.strip().lower()] = v.strip()
        disp = headers.get("content-disposition", "")
        name_m = re.search(r'name="([^"]*)"', disp)
        file_m = re.search(r'filename="([^"]*)"', disp)
        if not name_m:
            continue
        name = name_m.group(1)
        if file_m:
            files[name] = UploadedFile(
                file_m.group(1),
                headers.get("content-type", "application/octet-stream"),
                content)
        else:
            fields[name] = content.decode("utf-8", "replace")
    return fields, files


# --------------------------------------------------------------- websocket

class WebSocket:
    """Server-side RFC6455 connection (text frames + close/ping)."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 path_params: Dict[str, str]):
        self._r = reader
        self._w = writer
        self.path_params = path_params
        self.closed = False
        # Serializes write+drain pairs: the progress handler runs a
        # background reader (whose pong replies drain) CONCURRENTLY with
        # the poll loop's send_json/ping drains, and asyncio's
        # FlowControlMixin supports a single drain waiter — two coroutines
        # draining the same transport under write backpressure hit
        # `assert waiter is None` (or silently lose a waiter under -O).
        self._wlock = asyncio.Lock()

    async def accept(self) -> None:
        pass  # handshake already done by the server before dispatch

    async def send_json(self, obj: Any) -> None:
        await self.send_text(json.dumps(obj))

    async def send_text(self, text: str) -> None:
        if self.closed:
            raise ConnectionError("websocket closed")
        payload = text.encode()
        header = bytes([0x81])  # FIN + text opcode
        n = len(payload)
        if n < 126:
            header += bytes([n])
        elif n < (1 << 16):
            header += bytes([126]) + struct.pack(">H", n)
        else:
            header += bytes([127]) + struct.pack(">Q", n)
        async with self._wlock:
            self._w.write(header + payload)
            await self._w.drain()

    async def ping(self) -> None:
        """Unsolicited ping — a liveness probe for write-only handlers
        (the progress loop never reads, so without one a client that
        closed or vanished leaves the poll coroutine spinning forever;
        the first write after the peer is gone raises)."""
        if self.closed:
            raise ConnectionError("websocket closed")
        async with self._wlock:
            self._w.write(bytes([0x89, 0]))
            await self._w.drain()

    async def receive_text(self) -> Optional[str]:
        """Next text frame; None on close. Handles ping transparently."""
        while True:
            frame = await self._read_frame()
            if frame is None:
                return None
            opcode, payload = frame
            if opcode == 0x8:          # close
                self.closed = True
                return None
            if opcode == 0x9:          # ping → pong
                # Control-frame payloads are capped at 125 bytes (RFC 6455
                # §5.5); echoing more would set the mask bit in the length
                # byte and emit a malformed server frame.
                pong = payload[:125]
                async with self._wlock:
                    self._w.write(bytes([0x8A, len(pong)]) + pong)
                    await self._w.drain()
                continue
            if opcode in (0x1, 0x2):
                return payload.decode("utf-8", "replace")

    async def _read_frame(self) -> Optional[Tuple[int, bytes]]:
        # The guard covers EVERY readexactly, not just the first: a client
        # that resets mid-frame (header sent, payload truncated) must read
        # as a clean close, not raise IncompleteReadError out of a
        # background drain task.
        try:
            b1b2 = await self._r.readexactly(2)
            opcode = b1b2[0] & 0x0F
            masked = b1b2[1] & 0x80
            n = b1b2[1] & 0x7F
            if n == 126:
                n = struct.unpack(">H", await self._r.readexactly(2))[0]
            elif n == 127:
                n = struct.unpack(">Q", await self._r.readexactly(8))[0]
            if n > MAX_WS_FRAME:
                # A client frame claiming up to 2^63 bytes would otherwise
                # buffer into memory without bound (the progress sockets
                # only ever receive tiny texts). Fail the connection
                # (RFC 6455 1009 Message Too Big).
                try:
                    async with self._wlock:
                        self._w.write(bytes([0x88, 2])
                                      + struct.pack(">H", 1009))
                        await self._w.drain()
                except OSError:
                    pass
                self.closed = True
                return None
            mask = await self._r.readexactly(4) if masked else b"\x00" * 4
            data = await self._r.readexactly(n)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            self.closed = True
            return None
        if masked:
            data = bytes(c ^ mask[i % 4] for i, c in enumerate(data))
        return opcode, data

    async def close(self) -> None:
        if not self.closed:
            try:
                async with self._wlock:
                    self._w.write(bytes([0x88, 0]))
                    await self._w.drain()
            except OSError:
                # ANY socket-level failure (not just ConnectionError —
                # e.g. ETIMEDOUT from drain) reads as the peer being
                # gone; close() is called from handlers' finally blocks
                # and must not raise past them.
                pass
            self.closed = True


class WebSocketDisconnect(Exception):
    pass


# --------------------------------------------------------------- router/app

_PARAM_RE = re.compile(r"{([a-zA-Z_][a-zA-Z0-9_]*)(:path)?}")


def _compile_path(pattern: str) -> re.Pattern:
    out = "^"
    pos = 0
    for m in _PARAM_RE.finditer(pattern):
        out += re.escape(pattern[pos:m.start()])
        out += f"(?P<{m.group(1)}>.+)" if m.group(2) else f"(?P<{m.group(1)}>[^/]+)"
        pos = m.end()
    out += re.escape(pattern[pos:]) + "$"
    return re.compile(out)


class App:
    def __init__(self):
        self._routes: List[Tuple[str, re.Pattern, Callable]] = []
        self._ws_routes: List[Tuple[re.Pattern, Callable]] = []
        self._registered: set = set()
        self.cors_origins = "*"
        self.on_startup: List[Callable[[], Awaitable]] = []

    def route(self, method: str, pattern: str):
        def deco(fn):
            key = (method, pattern)
            if key in self._registered:
                # Starlette parity: first registration wins; later duplicates
                # are dead code (back/api.py:2141 vs 2327).
                logger.warning("duplicate route %s %s ignored", method, pattern)
                return fn
            self._registered.add(key)
            self._routes.append((method, _compile_path(pattern), fn))
            return fn
        return deco

    def get(self, p):
        return self.route("GET", p)

    def post(self, p):
        return self.route("POST", p)

    def delete(self, p):
        return self.route("DELETE", p)

    def websocket(self, pattern: str):
        def deco(fn):
            self._ws_routes.append((_compile_path(pattern), fn))
            return fn
        return deco

    # ------------------------------------------------------------ serving
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        loop = asyncio.get_running_loop()
        try:
            while True:
                # Idle bound on the keep-alive gap / first request line —
                # without one, sockets that connect and send nothing are
                # held forever (slowloris fd exhaustion; uvicorn bounds
                # this with its keep-alive timeout). TimeoutError is an
                # OSError, so expiry lands in the clean-close except below.
                line = await asyncio.wait_for(reader.readline(),
                                              KEEPALIVE_TIMEOUT_S)
                if not line or line in (b"\r\n", b"\n"):
                    return
                try:
                    method, target, _version = line.decode().split(" ", 2)
                except ValueError:
                    return
                headers: Dict[str, str] = {}
                hbytes = 0
                # Overall header deadline (not per-readline — a
                # byte-per-second dripper would defeat that).
                hdr_deadline = loop.time() + HEADER_TIMEOUT_S
                while True:
                    hl = await asyncio.wait_for(
                        reader.readline(),
                        max(hdr_deadline - loop.time(), 0.001))
                    if hl in (b"\r\n", b"\n", b""):
                        break
                    hbytes += len(hl)
                    if hbytes > MAX_HEADER_BYTES:
                        # Unbounded header streaming would otherwise grow
                        # memory without limit (431 per RFC 6585).
                        await self._write_response(writer, json_response(
                            {"detail": "headers too large"}, 431),
                            keep=False)
                        return
                    k, _, v = hl.decode("latin-1").partition(":")
                    headers[k.strip().lower()] = v.strip()

                if headers.get("upgrade", "").lower() == "websocket":
                    await self._handle_ws(reader, writer, target, headers)
                    return

                if "chunked" in headers.get("transfer-encoding", "").lower():
                    try:
                        body = await self._read_chunked(reader)
                    except ValueError:
                        # Malformed chunk-size line: answer 400 instead of
                        # killing the connection with an unhandled error.
                        await self._write_response(writer, json_response(
                            {"detail": "malformed chunked body"}, 400),
                            keep=False)
                        return
                    if body is None:
                        # keep=False (was a stray positional "HTTP/1.1"
                        # landing in `version`): closing a keep-alive
                        # socket with the client's oversize body still
                        # unread makes the queued 413 race a TCP RST.
                        await self._write_response(writer, json_response(
                            {"detail": "body too large"}, 413), keep=False)
                        return
                else:
                    try:
                        length = int(headers.get("content-length", "0"))
                        if length < 0:
                            raise ValueError(length)
                    except ValueError:
                        # Malformed/negative Content-Length previously
                        # escaped as an unhandled ValueError (dead
                        # connection, no response).
                        await self._write_response(writer, json_response(
                            {"detail": "malformed content-length"}, 400),
                            keep=False)
                        return
                    if length > MAX_BODY:
                        await self._write_response(writer, json_response(
                            {"detail": "body too large"}, 413), keep=False)
                        return
                    body = await reader.readexactly(length) if length else b""
                response = await self._dispatch(method, target, headers, body)
                keep = headers.get("connection", "keep-alive").lower() != "close"
                await self._write_response(writer, response, keep=keep)
                if not keep:
                    return
        except ValueError:
            # A single request/header line beyond the StreamReader limit
            # surfaces as ValueError from readline (LimitOverrunError)
            # BEFORE the hbytes cap can fire — answer the intended 431
            # best-effort instead of dying with an unretrieved exception
            #. The malformed-chunked/content-length ValueErrors
            # are handled at their sites above and never reach here.
            try:
                await self._write_response(writer, json_response(
                    {"detail": "headers too large"}, 431), keep=False)
            except Exception:
                pass
        except (asyncio.IncompleteReadError, OSError):
            # OSError covers ConnectionError plus the rarer socket
            # failures (ETIMEDOUT, ENOBUFS) and asyncio's TimeoutError
            # (the read deadlines above) — a dying or idle client
            # connection must never surface as an unhandled-task log.
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _read_chunked(self, reader: asyncio.StreamReader
                            ) -> Optional[bytes]:
        """RFC 7230 §4.1 chunked request body; None when over MAX_BODY
        (previously a chunked client would hang against the content-length
        path). Raises ValueError on a malformed chunk-size
        line (caller answers 400)."""
        parts: List[bytes] = []
        total = 0
        while True:
            size_line = await reader.readline()
            if not size_line:
                # EOF at a chunk boundary is a DROPPED connection, not a
                # terminating zero chunk — treating it as one would accept
                # a truncated upload as a complete request body.
                raise asyncio.IncompleteReadError(b"", None)
            size = int(size_line.split(b";")[0].strip() or b"0", 16)
            if size == 0:
                while True:  # trailer section ends at an empty line
                    t = await reader.readline()
                    if t in (b"\r\n", b"\n", b""):
                        break
                return b"".join(parts)
            total += size
            if total > MAX_BODY:
                return None
            parts.append(await reader.readexactly(size))
            await reader.readexactly(2)            # chunk-terminating CRLF

    async def _dispatch(self, method: str, target: str,
                        headers: Dict[str, str], body: bytes) -> Response:
        parts = urlsplit(target)
        path = unquote(parts.path)
        query = {k: v[0] for k, v in parse_qs(parts.query).items()}
        if method == "OPTIONS":  # CORS preflight
            return Response(b"", 200, "text/plain")
        for m, pat, fn in self._routes:
            if m != method:
                continue
            match = pat.match(path)
            if not match:
                continue
            req = Request(method, path, headers, body, query, match.groupdict())
            try:
                result = fn(req)
                if asyncio.iscoroutine(result):
                    result = await result
                if isinstance(result, Response):
                    return result
                return json_response(result)
            except HTTPException as exc:
                return json_response({"detail": exc.detail}, exc.status_code)
            except Exception as exc:  # noqa: BLE001
                logger.error("handler error %s %s: %s", method, path, exc,
                             exc_info=True)
                return json_response({"detail": "Internal Server Error"}, 500)
        return json_response({"detail": "Not Found"}, 404)

    async def _write_response(self, writer: asyncio.StreamWriter,
                              resp: Response, version: str = "HTTP/1.1",
                              keep: bool = True) -> None:
        reason = {200: "OK", 202: "Accepted", 400: "Bad Request",
                  404: "Not Found", 413: "Payload Too Large",
                  431: "Request Header Fields Too Large",
                  500: "Internal Server Error"}.get(resp.status, "Status")
        head = [f"HTTP/1.1 {resp.status} {reason}",
                f"Content-Type: {resp.content_type}",
                f"Content-Length: {len(resp.body)}",
                "Access-Control-Allow-Origin: " + self.cors_origins,
                "Access-Control-Allow-Methods: *",
                "Access-Control-Allow-Headers: *",
                "Connection: " + ("keep-alive" if keep else "close")]
        for k, v in resp.headers.items():
            # Last line of defense against response splitting: no header
            # name or value may carry CR/LF into the head (values can
            # originate from client-controlled strings).
            k = str(k).replace("\r", "").replace("\n", "")
            v = str(v).replace("\r", "").replace("\n", "")
            head.append(f"{k}: {v}")
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + resp.body)
        await writer.drain()

    async def _handle_ws(self, reader, writer, target: str,
                         headers: Dict[str, str]) -> None:
        path = unquote(urlsplit(target).path)
        for pat, fn in self._ws_routes:
            match = pat.match(path)
            if not match:
                continue
            key = headers.get("sec-websocket-key", "")
            accept = base64.b64encode(
                hashlib.sha1((key + _WS_MAGIC).encode()).digest()).decode()
            writer.write((
                "HTTP/1.1 101 Switching Protocols\r\n"
                "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                f"Sec-WebSocket-Accept: {accept}\r\n\r\n").encode())
            await writer.drain()
            ws = WebSocket(reader, writer, match.groupdict())
            try:
                await fn(ws)
            except WebSocketDisconnect:
                pass
            except Exception as exc:  # noqa: BLE001
                logger.error("ws handler error: %s", exc, exc_info=True)
            finally:
                await ws.close()
                writer.close()
            return
        writer.write(b"HTTP/1.1 404 Not Found\r\nContent-Length: 0\r\n\r\n")
        await writer.drain()
        writer.close()

    async def serve(self, host: str = "0.0.0.0", port: int = 8000):
        for cb in self.on_startup:
            await cb()
        server = await asyncio.start_server(self._handle, host, port)
        logger.info("serving on %s:%d", host, port)
        async with server:
            await server.serve_forever()

    def run(self, host: str = "0.0.0.0", port: int = 8000):
        asyncio.run(self.serve(host, port))
