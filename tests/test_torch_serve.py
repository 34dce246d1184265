"""The port's server (clearconverse_tpu_torch/serve) against the JAX
package's, both on the DevModels backend over real sockets: the same
request sequences give byte-identical JSON bodies, status codes and
transcript text (task ids aside), mirroring tests/test_api.py,
tests/test_http.py, tests/test_pdf.py and tests/test_warmup.py case by
case; plus what the port does differently: main() refuses to start without
a CUDA device outside dev mode, and a fatal error stops the runner."""

import asyncio
import base64
import json
import os
import re
import socket
import struct
import threading
import time

import numpy as np
import pytest
import requests

import torch

from clearconverse_tpu.config import Config as JConfig, TPUConfig
from clearconverse_tpu.pipeline.dev_backend import DevModels as JDevModels
from clearconverse_tpu.pipeline.engine import TranscriptionEngine as JEngine
from clearconverse_tpu.serve import app as japp
from clearconverse_tpu.serve import http as jhttp
from clearconverse_tpu.serve import pdf as jpdf
from clearconverse_tpu.serve import tasks as jtasks

from clearconverse_tpu_torch.audio.wav import write_wav
from clearconverse_tpu_torch.config import Config, TorchConfig
from clearconverse_tpu_torch.pipeline.dev_backend import (
    SR, DevModels, synth_conversation)
from clearconverse_tpu_torch.pipeline.engine import TranscriptionEngine
from clearconverse_tpu_torch.serve import app as papp
from clearconverse_tpu_torch.serve import http as phttp
from clearconverse_tpu_torch.serve import pdf as ppdf
from clearconverse_tpu_torch.serve import tasks as ptasks

torch.set_num_threads(1)


def _port_engine():
    return TranscriptionEngine(Config(noise_reduction_amount=0.0),
                               TorchConfig(), models=DevModels(), device="cpu")


def _jax_engine():
    return JEngine(JConfig(noise_reduction_amount=0.0), TPUConfig(),
                   models=JDevModels())


def _start(create_app, factory, root):
    out_dir, temp_dir = str(root / "processed"), str(root / "uploads")
    app = create_app(out_dir, temp_dir, factory, start_cleanup=False)
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    loop = asyncio.new_event_loop()

    def run():
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(app.serve("127.0.0.1", port))
        except RuntimeError:
            pass  # loop stopped at teardown

    threading.Thread(target=run, daemon=True).start()
    base = f"http://127.0.0.1:{port}"
    for _ in range(100):
        try:
            requests.get(base + "/health", timeout=1)
            break
        except requests.exceptions.ConnectionError:
            time.sleep(0.05)
    return {"base": base, "out": out_dir, "temp": temp_dir, "port": port,
            "app": app, "loop": loop, "root": root}


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    srv = {"port": _start(papp.create_app, _port_engine,
                          tmp_path_factory.mktemp("port")),
           "jax": _start(japp.create_app, _jax_engine,
                         tmp_path_factory.mktemp("jax"))}
    wav = str(tmp_path_factory.mktemp("src") / "conv.wav")
    write_wav(wav, synth_conversation(), SR)
    srv["wav"] = wav
    yield srv
    for s in ("port", "jax"):
        srv[s]["loop"].call_soon_threadsafe(srv[s]["loop"].stop)


# -------------------------------------------------------------- scenarios
# Each scenario drives one server and returns a list of observations:
# (status code, body bytes) and plain values. Task ids and PDF date stamps
# are masked, so both servers' lists must be equal.

def _upload(s, wav, name="conv.wav"):
    with open(wav, "rb") as fh:
        return requests.post(s["base"] + "/upload-file",
                             files={"file": (name, fh, "audio/wav")})


def _wait(s, tid, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline:
        st = requests.get(f"{s['base']}/task/{tid}/status").json()
        if st.get("status") in ("completed", "error", "cancelled"):
            return st
        time.sleep(0.1)
    raise TimeoutError("task did not finish")


def _obs(r):
    return (r.status_code, r.content)


def sc_health(s, wav):
    return [_obs(requests.get(s["base"] + "/health"))]


def sc_upload_validates_extension(s, wav):
    return [_obs(requests.post(s["base"] + "/upload-file",
                               files={"file": ("x.txt", b"hi", "text/plain")})),
            _obs(requests.post(s["base"] + "/upload-file", data={"a": "b"}))]


def sc_upload_size_cap_says_10mb(s, wav):
    big = b"\0" * (26 * 1024 * 1024)
    return [_obs(requests.post(s["base"] + "/upload-file",
                               files={"file": ("big.wav", big, "audio/wav")}))]


def sc_upload_and_preview(s, wav):
    up = _upload(s, wav)
    r = requests.get(s["base"] + up.json()["preview_url"])
    return [_obs(up), _obs(r), r.headers.get("Content-Disposition")]


def sc_transcribe_lifecycle(s, wav):
    up = _upload(s, wav, "meeting.wav")
    tid = up.json()["task_id"]
    out = [_obs(up), _obs(requests.post(f"{s['base']}/transcribe/{tid}"))]
    st = _wait(s, tid)
    out += [st, _obs(requests.get(f"{s['base']}/task/{tid}/status")),
            _obs(requests.post(f"{s['base']}/transcribe/{tid}")),
            _obs(requests.get(s["base"] + st["download_url"])),
            _obs(requests.get(f"{s['base']}/transcription/{tid}")),
            _obs(requests.get(f"{s['base']}/task/{tid}/result")),
            _obs(requests.get(f"{s['base']}/model-loading-status"))]
    pdf = requests.get(f"{s['base']}/download-pdf/{tid}")
    out += [_obs(pdf), pdf.headers.get("Content-Disposition")]
    with open(os.path.join(s["out"], tid, "transcript.txt")) as fh:
        out.append(fh.read())
    return out


def sc_unknown_task(s, wav):
    return [_obs(requests.get(f"{s['base']}/task/nope/status")),
            _obs(requests.get(f"{s['base']}/transcription/nope")),
            _obs(requests.post(f"{s['base']}/transcribe/nope")),
            _obs(requests.get(f"{s['base']}/task/ghost/result")),
            _obs(requests.get(f"{s['base']}/download-pdf/nope")),
            _obs(requests.get(f"{s['base']}/download/../../etc/passwd")),
            _obs(requests.get(f"{s['base']}/preview/nope.wav")),
            _obs(requests.get(f"{s['base']}/no-such-route"))]


def sc_cancel_flow(s, wav):
    tid = _upload(s, wav).json()["task_id"]
    out = [_obs(requests.post(f"{s['base']}/cancel/{tid}")),
           _obs(requests.get(f"{s['base']}/task/{tid}/status")),
           _obs(requests.get(f"{s['base']}/transcription/{tid}")),
           _obs(requests.get(f"{s['base']}/task/{tid}/result")),
           _obs(requests.post(f"{s['base']}/transcribe/{tid}"))]
    out.append(_wait(s, tid))
    return out


def sc_cancel_completed_task(s, wav):
    tid = _upload(s, wav).json()["task_id"]
    requests.post(f"{s['base']}/transcribe/{tid}")
    out = [_wait(s, tid),
           _obs(requests.post(f"{s['base']}/cancel/{tid}")),
           _obs(requests.get(f"{s['base']}/task/{tid}/status")),
           _obs(requests.get(f"{s['base']}/task/{tid}/result"))]
    return out


def sc_cancel_unknown_task(s, wav):
    return [_obs(requests.post(f"{s['base']}/cancel/this-never-existed")),
            _obs(requests.get(f"{s['base']}/task/this-never-existed/status"))]


def sc_cleanup(s, wav):
    a = _upload(s, wav).json()["task_id"]
    b = _upload(s, wav).json()["task_id"]
    out = [_obs(requests.delete(f"{s['base']}/cleanup/{a}")),
           _obs(requests.post(f"{s['base']}/transcribe/{a}")),
           _obs(requests.delete(f"{s['base']}/cleanup/{b}",
                                params={"preserve_uploads": "true"})),
           _obs(requests.post(f"{s['base']}/cleanup/{b}"))]
    requests.post(f"{s['base']}/transcribe/{b}")
    out += [_wait(s, b), _obs(requests.delete(f"{s['base']}/cleanup/{b}"))]
    return out


def sc_admin_cleanup(s, wav):
    return [_obs(requests.post(f"{s['base']}/admin/cleanup",
                               params={"hours": "1000"}))]


def sc_retranscribe_after_cancel(s, wav):
    tid = _upload(s, wav, "rerun.wav").json()["task_id"]
    task_dir = os.path.join(s["out"], tid)
    os.makedirs(task_dir, exist_ok=True)
    with open(os.path.join(task_dir, "cancelled.txt"), "w") as fh:
        fh.write("Transcription was cancelled")
    out = [_obs(requests.get(f"{s['base']}/task/{tid}/status")),
           _obs(requests.post(f"{s['base']}/transcribe/{tid}"))]
    out += [_wait(s, tid), os.path.exists(os.path.join(task_dir,
                                                       "cancelled.txt"))]
    return out


def _ws_messages(s, tid, limit=60):
    sock = socket.create_connection(("127.0.0.1", s["port"]), timeout=30)
    key = base64.b64encode(os.urandom(16)).decode()
    sock.sendall((f"GET /ws/progress/{tid} HTTP/1.1\r\nHost: localhost\r\n"
                  f"Upgrade: websocket\r\nConnection: Upgrade\r\n"
                  f"Sec-WebSocket-Key: {key}\r\n"
                  f"Sec-WebSocket-Version: 13\r\n\r\n").encode())
    buf = b""
    while b"\r\n\r\n" not in buf:
        buf += sock.recv(4096)
    head, _, buf = buf.partition(b"\r\n\r\n")
    msgs = []
    deadline = time.time() + limit
    while time.time() < deadline:
        while len(buf) < 2:
            buf += sock.recv(4096)
        n, off = buf[1] & 0x7F, 2
        if n == 126:
            while len(buf) < 4:
                buf += sock.recv(4096)
            n, off = struct.unpack(">H", buf[2:4])[0], 4
        while len(buf) < off + n:
            buf += sock.recv(4096)
        msgs.append(json.loads(buf[off:off + n]))
        buf = buf[off + n:]
        if msgs[-1].get("progress") == 100:
            break
    sock.close()
    return head.split(b"\r\n")[0], msgs


def sc_websocket_progress(s, wav):
    tid = _upload(s, wav).json()["task_id"]
    requests.post(f"{s['base']}/transcribe/{tid}")
    _wait(s, tid)
    head, msgs = _ws_messages(s, tid)
    return [head, msgs]


def sc_websocket_cancelled(s, wav):
    tid = _upload(s, wav).json()["task_id"]
    os.makedirs(os.path.join(s["out"], tid), exist_ok=True)
    with open(os.path.join(s["out"], tid, "cancelled.txt"), "w") as fh:
        fh.write("x")
    return list(_ws_messages(s, tid))


def sc_oversized_header_line_gets_431(s, wav):
    sock = socket.create_connection(("127.0.0.1", s["port"]), timeout=10)
    sock.sendall(b"GET /health HTTP/1.1\r\nX-Big: " + b"a" * (80 * 1024)
                 + b"\r\n\r\n")
    buf = b""
    try:
        while b"\r\n\r\n" not in buf:
            chunk = sock.recv(4096)
            if not chunk:
                break
            buf += chunk
    except ConnectionResetError:
        pass
    sock.close()
    return [buf.split(b"\r\n", 1)[0]]


def sc_concurrent_transcribe_requests(s, wav):
    tids = [_upload(s, wav, f"c{i}.wav").json()["task_id"] for i in range(2)]
    for t in tids:
        requests.post(f"{s['base']}/transcribe/{t}")
    return [_wait(s, t) for t in tids]


SCENARIOS = {name[3:]: fn for name, fn in globals().items()
             if name.startswith("sc_")}


def _mask(obj, tids):
    """Task ids → <tid>; PDF date stamps → a fixed stamp of equal length."""
    if isinstance(obj, (list, tuple)):
        return [_mask(o, tids) for o in obj]
    if isinstance(obj, dict):
        return {k: _mask(v, tids) for k, v in obj.items()}
    if isinstance(obj, bytes):
        obj = re.sub(rb"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d", b"0000-00-00 00:00:00",
                     obj)
        for t in tids:
            obj = obj.replace(t.encode(), b"<tid>")
        return obj
    if isinstance(obj, str):
        for t in tids:
            obj = obj.replace(t, "<tid>")
        return obj
    return obj


_UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                   r"[0-9a-f]{12}")


def _tids(obj):
    return set(_UUID.findall(repr(obj)))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_server_matches_jax_server(servers, name):
    got = {}
    for side in ("port", "jax"):
        res = SCENARIOS[name](servers[side], servers["wav"])
        got[side] = _mask(res, _tids(res))
    assert got["port"] == got["jax"]


def test_lifecycle_transcript_has_speakers(servers):
    s = servers["port"]
    tid = _upload(s, servers["wav"], "meeting.wav").json()["task_id"]
    requests.post(f"{s['base']}/transcribe/{tid}")
    st = _wait(s, tid)
    assert st["status"] == "completed"
    text = requests.get(f"{s['base']}/transcription/{tid}").json()
    assert "[SPEAKER_" in text["transcription"]
    pdf = requests.get(f"{s['base']}/download-pdf/{tid}")
    assert pdf.content.startswith(b"%PDF-1.4")
    assert "meeting-Transcript.pdf" in pdf.headers["Content-Disposition"]


def test_upload_url_drive_flow_matches_jax(servers, monkeypatch):
    """/upload-url with the Drive download stubbed in both URL modules:
    identical responses, preview names and PDF names; the size-cap quirk
    (413 wrapped into 400) identical too."""
    from clearconverse_tpu.serve import urls as jurls
    from clearconverse_tpu_torch.serve import urls as purls

    def fake_drive(file_id, output_path=None, max_bytes=None):
        write_wav(output_path, synth_conversation(), SR)
        return output_path

    got = {}
    for side, mod in (("port", purls), ("jax", jurls)):
        s = servers[side]
        monkeypatch.setattr(mod, "download_file_from_google_drive", fake_drive)
        url = "https://drive.google.com/file/d/FILE123/view"
        r = requests.post(s["base"] + "/upload-url", data={"url": url})
        tid = r.json()["task_id"]
        requests.post(f"{s['base']}/transcribe/{tid}")
        st = _wait(s, tid)
        pdf = requests.get(f"{s['base']}/download-pdf/{tid}")

        def capped(file_id, output_path=None, max_bytes=None, mod=mod):
            raise mod._size_cap_413(12 * 1024 * 1024)
        monkeypatch.setattr(mod, "download_file_from_google_drive", capped)
        r2 = requests.post(s["base"] + "/upload-url", data={"url": url})
        bad = requests.post(s["base"] + "/upload-url", data={"url": "nope"})
        res = [_obs(r), st, pdf.headers["Content-Disposition"], _obs(r2),
               _obs(bad)]
        got[side] = _mask(res, _tids(res))
    assert got["port"] == got["jax"]


# ------------------------------------------------------- http.py, pdf.py

def _mp_body(boundary, parts):
    out = b""
    for headers, content in parts:
        out += (f"--{boundary}\r\n".encode() + headers + b"\r\n\r\n"
                + content + b"\r\n")
    return out + f"--{boundary}--\r\n".encode()


_FILE = b'Content-Disposition: form-data; name="file"; filename="a.wav"'
MULTIPART = {
    "fields_and_files": (_mp_body("XB", [
        (b'Content-Disposition: form-data; name="url"', b"http://x/y.mp3"),
        (_FILE + b"\r\nContent-Type: audio/wav", b"RIFF\x00binary\r\ndata")]),
        "multipart/form-data; boundary=XB"),
    "binary_trailing_crlf": (_mp_body("XB", [(_FILE, b"\x00RIFF\n\n\r\r")]),
                             "multipart/form-data; boundary=XB"),
    "leading_crlf_and_empty_part": (_mp_body("bnd", [
        (_FILE, b"\r\n\r\nmiddle\r\n"),
        (b'Content-Disposition: form-data; name="e"; filename="e"', b"")]),
        "multipart/form-data; boundary=bnd"),
    "preamble_no_trailing_crlf": (
        b"ignored\r\n--bb1\r\nContent-Disposition: form-data; name=\"k\""
        b"\r\n\r\nv\r\n--bb1--", "multipart/form-data; boundary=bb1"),
    "quoted_boundary": (_mp_body("qq1", [
        (b'Content-Disposition: form-data; name="k"', b"v")]),
        'multipart/form-data; boundary="qq1"'),
}


@pytest.mark.parametrize("case", sorted(MULTIPART))
def test_parse_multipart_matches_jax(case):
    body, ctype = MULTIPART[case]

    def view(res):
        fields, files = res
        return fields, {k: (f.filename, f.content_type, f.content)
                        for k, f in files.items()}
    assert view(phttp.parse_multipart(body, ctype)) == \
        view(jhttp.parse_multipart(body, ctype))


@pytest.mark.parametrize("route,path", [
    ("/task/{task_id}/status", "/task/abc-123/status"),
    ("/task/{task_id}/status", "/task/a/b/status"),
    ("/download/{file_path:path}", "/download/tid/transcript.txt")])
def test_compile_path_matches_jax(route, path):
    a = phttp._compile_path(route).match(path)
    b = jhttp._compile_path(route).match(path)
    assert (a and a.groupdict()) == (b and b.groupdict())


def test_duplicate_route_first_wins_and_json_response():
    app = phttp.App()

    @app.get("/x/{i}")
    async def first(req):
        return {"v": 1}

    @app.get("/x/{i}")
    async def second(req):
        return {"v": 2}

    assert [fn for m, p, fn in app._routes if m == "GET"] == [first]
    a, b = phttp.json_response({"a": 1}, 202), jhttp.json_response({"a": 1}, 202)
    assert (a.status, a.body, a.content_type) == (b.status, b.body,
                                                  b.content_type)


class _W:
    def __init__(self):
        self.data = b""

    def write(self, b):
        self.data += b

    async def drain(self):
        pass

    def close(self):
        pass


def _drive_raw(mod, raw: bytes) -> bytes:
    app = mod.App()

    @app.post("/x")
    async def x(req):
        return {"n": len(req.body), "text": req.body.decode(errors="replace")}

    async def run():
        reader = asyncio.StreamReader()
        writer = _W()
        reader.feed_data(raw)
        reader.feed_eof()
        await app._handle(reader, writer)
        return writer.data

    return asyncio.run(run())


RAW = {
    "chunked": b"POST /x HTTP/1.1\r\nTransfer-Encoding: chunked\r\n"
               b"Connection: close\r\n\r\n5\r\nhello\r\n6\r\n world\r\n0\r\n\r\n",
    "chunked_over_cap": b"POST /x HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n"
                        + hex(phttp.MAX_BODY + 1)[2:].encode() + b"\r\n",
    "content_length_abc": b"POST /x HTTP/1.1\r\nContent-Length: abc\r\n\r\n",
    "content_length_negative": b"POST /x HTTP/1.1\r\nContent-Length: -5\r\n\r\n",
    "content_length_float": b"POST /x HTTP/1.1\r\nContent-Length: 1e3\r\n\r\n",
    "malformed_chunk_size": b"POST /x HTTP/1.1\r\nTransfer-Encoding: chunked"
                            b"\r\n\r\nzz\r\nhello\r\n0\r\n\r\n",
    "unbounded_headers": b"POST /x HTTP/1.1\r\n"
                         + (b"x-pad: " + b"a" * 1000 + b"\r\n")
                         * (phttp.MAX_HEADER_BYTES // 1009 + 2)
                         + b"Content-Length: 0\r\n\r\n",
    "chunked_eof_mid_body": b"POST /x HTTP/1.1\r\nTransfer-Encoding: chunked"
                            b"\r\n\r\n5\r\nhello\r\n",
}


@pytest.mark.parametrize("case", sorted(RAW))
def test_raw_requests_get_the_jax_bytes(case):
    assert _drive_raw(phttp, RAW[case]) == _drive_raw(jhttp, RAW[case])


def _mask_frame(payload, mask):
    return bytes(c ^ mask[i % 4] for i, c in enumerate(payload))


_M = b"\x01\x02\x03\x04"
WS = {
    "text_ping_text_close": (
        bytes([0x81, 0x80 | 7]) + _M + _mask_frame(b'{"x":1}', _M)
        + bytes([0x89, 0x80 | 2]) + _M + _mask_frame(b"pi", _M)
        + bytes([0x81, 0x80 | 2]) + _M + _mask_frame(b"{}", _M)
        + bytes([0x88, 0x80]) + _M),
    "oversized_frame": (bytes([0x81, 0x80 | 127])
                        + struct.pack(">Q", phttp.MAX_WS_FRAME + 1) + _M),
    "oversized_ping_clamped": (
        bytes([0x89, 0x80 | 126]) + (200).to_bytes(2, "big") + _M
        + _mask_frame(b"p" * 200, _M)
        + bytes([0x81, 0x80 | 2]) + _M + _mask_frame(b"hi", _M)),
    "extended_length": (bytes([0x81, 0x80 | 126]) + struct.pack(">H", 300)
                        + _M + _mask_frame(b"x" * 300, _M)),
    "mid_frame_disconnect": bytes([0x81, 0x80 | 20]) + _M + b"abc",
}


def _ws_run(mod, incoming):
    async def run():
        reader = asyncio.StreamReader()
        writer = _W()
        ws = mod.WebSocket(reader, writer, {})
        await ws.send_json({"progress": 42, "message": "hi"})
        await ws.send_text("y" * 300)
        reader.feed_data(incoming)
        reader.feed_eof()
        got = []
        while True:
            msg = await ws.receive_text()
            got.append(msg)
            if msg is None:
                break
        return got, ws.closed, writer.data

    return asyncio.run(run())


@pytest.mark.parametrize("case", sorted(WS))
def test_websocket_codec_matches_jax(case):
    assert _ws_run(phttp, WS[case]) == _ws_run(jhttp, WS[case])


def test_file_response_sanitizes_filename_like_jax(tmp_path):
    p = tmp_path / "f"
    p.write_bytes(b"x")
    name = 'a\r\nSet-Cookie: evil=1\n"b.mp3'
    a = phttp.file_response(str(p), "audio/mpeg", name)
    b = jhttp.file_response(str(p), "audio/mpeg", name)
    assert a.headers == b.headers
    assert a.headers["Content-Disposition"] == \
        'attachment; filename="aSet-Cookie: evil=1b.mp3"'


PDF_TEXTS = {
    "dialogue": ("[SPEAKER_A] 0.00s - 3.00s\nhello there\n\n"
                 "[SPEAKER_B] 3.50s - 6.00s\nhow are you " * 40, "call.wav"),
    "long_token": ("[SPEAKER_A] 0.00s - 3.00s\nsee https://example.com/"
                   + "a" * 150 + " now\n\n", None),
    "winansi": ("[SPEAKER_A] 0.00s - 3.00s\ndon’t forget José\n\n", None),
    "unmappable": ("[SPEAKER_A] 0.00s - 1.00s\nCJK 日本 ok\n\n", "x.mp3"),
}


@pytest.mark.parametrize("case", sorted(PDF_TEXTS))
def test_pdf_bytes_match_jax(tmp_path, case):
    text, name = PDF_TEXTS[case]
    generate = {"port": ppdf.generate_transcript_pdf,
                "jax": jpdf.generate_transcript_pdf}
    data = {}
    for side, fn in generate.items():
        out = tmp_path / f"{side}.pdf"
        fn(text, str(out), name)
        data[side] = _mask(out.read_bytes(), set())
    assert data["port"] == data["jax"]
    assert data["port"].startswith(b"%PDF-1.4")


@pytest.mark.parametrize("text,width", [("start " + "x" * 200 + " end", 400),
                                        ("hello world", 400),
                                        ("a " * 300, 120)])
def test_pdf_wrap_matches_jax(text, width):
    assert ppdf._wrap(text, 11, width) == jpdf._wrap(text, 11, width)


# ------------------------------------------------------------- tasks.py

def test_task_runner_error_marker_like_jax(tmp_path):
    class Boom:
        def run(self, *a, **k):
            raise RuntimeError("synthetic failure")

    files = {}
    for side, mod in (("port", ptasks), ("jax", jtasks)):
        runner = mod.TaskRunner(str(tmp_path / side), lambda: Boom())
        task_dir = tmp_path / side / "t1"
        task_dir.mkdir(parents=True)
        (task_dir / "in_progress.txt").write_text("x")
        runner._run_task("t1", "whatever.wav", threading.Event())
        files[side] = sorted((p.name, p.read_text())
                             for p in task_dir.iterdir())
    assert files["port"] == files["jax"]
    assert ("error.txt", "Error: synthetic failure") in files["port"]


@pytest.mark.parametrize("exc", [RuntimeError("CUDA error: launch failure"),
                                 NotImplementedError("not ported")])
def test_fatal_error_fails_fast_and_reports_on_health(tmp_path, exc, caplog):
    """A fatal error still writes the task's error marker (the protocol the
    user sees), is logged at ERROR with its traceback, and stops the
    runner: later tasks fail at once, /health answers 503."""
    calls = []

    class Broken:
        def run(self, *a, **k):
            calls.append(1)
            raise exc

    app = papp.create_app(str(tmp_path / "o"), str(tmp_path / "u"),
                          lambda: Broken(), start_cleanup=False)
    runner = app.state
    with caplog.at_level("ERROR", logger="clearconverse_tpu_torch"):
        for tid in ("t1", "t2"):
            (tmp_path / "o" / tid).mkdir(parents=True)
            runner._run_task(tid, "x.wav", threading.Event())
    assert calls == [1]
    for tid in ("t1", "t2"):
        assert (tmp_path / "o" / tid / "error.txt").exists()
    assert "fatal error earlier" in (tmp_path / "o" / "t2" / "error.txt").read_text()
    assert any(r.exc_info for r in caplog.records)
    assert runner.fatal_error is exc
    health = next(fn for m, p, fn in app._routes
                  if m == "GET" and p.pattern.startswith("^/health"))
    resp = asyncio.run(health(None))
    assert resp.status == 503 and json.loads(resp.body)["status"] == "error"


def test_ordinary_error_does_not_stop_the_runner(tmp_path):
    class Flaky:
        def __init__(self):
            self.n = 0

        def run(self, f, output_dir, debug_mode, progress_callback):
            self.n += 1
            if self.n == 1:
                raise ValueError("bad file")
            with open(os.path.join(output_dir, "transcript.txt"), "w") as fh:
                fh.write("[SPEAKER_A] 0.00s - 1.00s\nok\n\n")
            return f, "text", "p"

    eng = Flaky()
    runner = ptasks.TaskRunner(str(tmp_path), lambda: eng)
    for tid in ("a", "b"):
        (tmp_path / tid).mkdir()
        runner._run_task(tid, "x.wav", threading.Event())
    assert runner.fatal_error is None
    assert (tmp_path / "a" / "error.txt").exists()
    assert (tmp_path / "b" / "completed.txt").exists()


def test_task_runner_cancel_cooperative_and_orphans(tmp_path):
    started = threading.Event()

    class Slow:
        def run(self, f, output_dir, debug_mode, progress_callback):
            progress_callback(30, "working")
            started.set()
            for _ in range(100):
                time.sleep(0.05)
                progress_callback(31, "still working")
            return f, "text", "p"

    runner = ptasks.TaskRunner(str(tmp_path), lambda: Slow())
    runner.start("t2", "x.wav")
    assert started.wait(5)
    runner.cancel("t2")
    deadline = time.time() + 10
    while runner.is_alive("t2") and time.time() < deadline:
        time.sleep(0.05)
    assert not runner.is_alive("t2")
    assert (tmp_path / "t2" / "cancelled.txt").exists()
    assert not (tmp_path / "t2" / "completed.txt").exists()
    orphan = tmp_path / "orphan"
    orphan.mkdir()
    (orphan / "in_progress.txt").write_text("x")
    runner.cancel("orphan")
    assert (orphan / "cancelled.txt").exists()
    assert not (orphan / "in_progress.txt").exists()
    runner.cancel("never-existed")
    assert not (tmp_path / "never-existed").exists()


def test_grouped_task_execution_shares_batches(tmp_path):
    paths = []
    for i in range(2):
        p = tmp_path / f"g{i}.wav"
        write_wav(str(p), synth_conversation(), SR)
        paths.append(str(p))
    fake = DevModels()
    runner = ptasks.TaskRunner(
        str(tmp_path / "out"),
        lambda: TranscriptionEngine(Config(noise_reduction_amount=0.0),
                                    TorchConfig(), models=fake, device="cpu"))
    group = [(f"t{i}", paths[i], threading.Event(), threading.Event())
             for i in range(2)]
    for tid, _, _, _ in group:
        (tmp_path / "out" / tid).mkdir(parents=True)
        (tmp_path / "out" / tid / "in_progress.txt").write_text("x")
    runner._run_group(group)
    for tid, _, _, _ in group:
        assert (tmp_path / "out" / tid / "completed.txt").exists()
        assert runner.result_store[tid]["status"] == "completed"
    assert len(fake.transcribe_calls[0]) >= 8


def test_max_group_env_override_like_jax(tmp_path, monkeypatch):
    for val in ("8", "nope", "0"):
        monkeypatch.setenv("CC_TPU_MAX_GROUP", val)
        assert (ptasks.TaskRunner(str(tmp_path), lambda: None).max_group
                == jtasks.TaskRunner(str(tmp_path), lambda: None).max_group)


# ------------------------------------------------------------- main()

def test_main_refuses_without_cuda_outside_dev_mode(monkeypatch, tmp_path):
    monkeypatch.delenv("CC_TPU_FAKE_MODELS", raising=False)
    monkeypatch.setenv("MODEL_CACHE_DIR", str(tmp_path / "models"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    started = []
    monkeypatch.setattr(papp, "create_app", lambda *a, **k: started.append(1))
    with pytest.raises(SystemExit, match="no CUDA device"):
        papp.main()
    assert started == [] and not (tmp_path / "models").exists()


def test_main_dev_mode_starts_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setenv("CC_TPU_FAKE_MODELS", "1")
    monkeypatch.setenv("MODEL_CACHE_DIR", str(tmp_path / "models"))
    monkeypatch.setenv("API_PORT", "8123")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = {}

    class FakeApp:
        def run(self, host, port):
            ran["addr"] = (host, port)

    monkeypatch.setattr(papp, "create_app", lambda *a, **k: FakeApp())
    papp.main()
    assert ran["addr"] == ("0.0.0.0", 8123)
    assert (tmp_path / "models" / "resepformer-ft").is_dir()


def test_dev_factory_runs_on_the_cpu(monkeypatch):
    from clearconverse_tpu_torch.serve.factory import default_engine_factory
    monkeypatch.setenv("CC_TPU_FAKE_MODELS", "1")
    eng = default_engine_factory()
    assert isinstance(eng.models, DevModels) and eng.device.type == "cpu"


def test_startup_warm_hook(monkeypatch, tmp_path):
    import clearconverse_tpu_torch.serve.warmup as wmod

    called = threading.Event()
    seen = {}

    def fake_warm(engine, drive):
        seen["engine"] = engine
        drive("decode long-window rows=1 prompt=none", lambda: None)
        called.set()

    monkeypatch.setattr(wmod, "warm_decode_shapes", fake_warm)
    monkeypatch.setenv("CC_TPU_STARTUP_WARM", "1")
    app = papp.create_app(str(tmp_path / "o"), str(tmp_path / "u"),
                          _port_engine, start_cleanup=False)

    async def run():
        for cb in app.on_startup:
            await cb()

    asyncio.run(run())
    assert called.wait(10)
    assert seen["engine"].models_are_loaded()


def test_startup_warm_fatal_failure_marks_runner(monkeypatch, tmp_path):
    import clearconverse_tpu_torch.serve.warmup as wmod

    done = threading.Event()

    def broken_warm(engine, drive):
        try:
            raise RuntimeError("CUDA error: an illegal memory access")
        finally:
            done.set()

    monkeypatch.setattr(wmod, "warm_decode_shapes", broken_warm)
    monkeypatch.setenv("CC_TPU_STARTUP_WARM", "1")
    app = papp.create_app(str(tmp_path / "o"), str(tmp_path / "u"),
                          _port_engine, start_cleanup=False)

    async def run():
        for cb in app.on_startup:
            await cb()

    asyncio.run(run())
    assert done.wait(10)
    deadline = time.time() + 5
    while app.state.fatal_error is None and time.time() < deadline:
        time.sleep(0.02)
    assert "illegal memory access" in str(app.state.fatal_error)


# ------------------------------------------------------------- warmup.py

def test_warmup_conversation_matches_jax():
    from clearconverse_tpu.serve.warmup import warmup_conversation as jw
    from clearconverse_tpu_torch.serve.warmup import warmup_conversation as pw
    for d in (5, 30, 60):
        np.testing.assert_array_equal(pw(d, SR), jw(d, SR))


def test_run_warmup_dev_mode(monkeypatch, capsys):
    from clearconverse_tpu_torch.serve.warmup import main, run_warmup
    lines = []
    entries = run_warmup(durations=(5,), file_counts=(1,),
                         engine_factory=_port_engine, log=lines.append)
    assert [e["drive"] for e in entries] == ["engine files=1 duration=5s"]
    assert len(lines) == 1 and "segments" in lines[0]
    monkeypatch.setenv("CC_TPU_FAKE_MODELS", "1")
    assert main(["--durations", "5", "--files", "1"]) == 0
    assert "warmup done: 1 drives" in capsys.readouterr().out


def test_run_warmup_drives_decode_shapes_before_engine_passes(monkeypatch):
    """The decode shapes come first, so their largest bucket sizes the
    decode graphs' arena before an engine pass captures a key a later
    growth would drop; the engine passes follow in their order."""
    import clearconverse_tpu_torch.serve.warmup as wmod
    order = []

    class _StubEngine:
        models = None

        def process_files(self, paths):
            order.append(f"engine {len(paths)}")
            return [{"segments": [0]} for _ in paths]

    def fake_warm(engine, drive):
        for n in (4, 1):
            drive(f"decode rows={n}", lambda n=n: order.append(f"decode {n}"))

    monkeypatch.setattr(wmod, "warm_decode_shapes", fake_warm)
    entries = wmod.run_warmup(durations=(5,), file_counts=(1, 2),
                              engine_factory=_StubEngine, log=lambda s: None)
    assert order == ["decode 4", "decode 1", "engine 1", "engine 2"]
    assert [e["drive"] for e in entries] == [
        "decode rows=4", "decode rows=1", "engine files=1 duration=5s",
        "engine files=2 duration=5s"]


def test_warm_decode_shapes_drives_every_row_bucket_like_jax():
    """The same drive labels as the JAX warm-up, largest bucket first (so
    the first drive sizes the decode graphs' arena), store-backed long
    windows, short drives alternating store and host, on a tiny port
    bundle."""
    from clearconverse_tpu_torch.models.convert import init_whisper
    from clearconverse_tpu_torch.models.tokenizer import ByteFallbackTokenizer
    from clearconverse_tpu_torch.models.whisper import WhisperDims
    from clearconverse_tpu_torch.pipeline.bundle import ModelBundle, StoreBatch
    from clearconverse_tpu_torch.serve.warmup import warm_decode_shapes

    dims = WhisperDims(n_audio_state=64, n_audio_head=2, n_audio_layer=1,
                       n_text_state=64, n_text_head=2, n_text_layer=1)
    bundle = ModelBundle(Config(transcription_batch_size=2),
                         TorchConfig(max_decode_tokens=4,
                                     compute_dtype="float32",
                                     duration_buckets=(5.0,)), device="cpu")
    bundle._whisper = (init_whisper(dims, 0, "cpu"), dims,
                       ByteFallbackTokenizer(english=True))
    bundle._loaded = True
    eng = TranscriptionEngine(bundle.config, bundle.torch_config,
                              models=bundle)
    drives, kinds = [], []
    for name in ("transcribe_long_batch", "transcribe_batch"):
        orig = getattr(bundle, name)

        def spy(audio, *a, _orig=orig, _name=name, **kw):
            kinds.append((_name, isinstance(audio, StoreBatch)))
            return _orig(audio, *a, **kw)
        setattr(bundle, name, spy)
    warm_decode_shapes(eng, lambda label, fn: (drives.append(label), fn()))
    buckets = ["p256", "p64", "p16", "p4"]
    assert drives == (
        [f"decode long-window rows={n} prompt={p}"
         for n in (2, 1) for p in buckets]
        + ["decode short store rows=2 duration=5.0s",
           "decode short host rows=2 duration=5.0s",
           "decode short store rows=1 duration=5.0s",
           "decode short host rows=1 duration=5.0s",
           "decode short store rows=2 prompt=p64",
           "decode short store rows=1 prompt=p64"])
    assert all(s for k, s in kinds if k == "transcribe_long_batch")
    assert [s for k, s in kinds if k == "transcribe_batch"] == \
        [True, False, True, False, True, True]


def test_warm_decode_shapes_noop_on_dev_backend():
    from clearconverse_tpu_torch.serve.warmup import warm_decode_shapes
    calls = []
    warm_decode_shapes(_port_engine(), lambda label, fn: calls.append(label))
    assert calls == []
