"""URL ingest: validation, generic download, Google-Drive confirm-token flow.

Behavior parity with back/api.py:358-528, with two substitutions for
unvendored deps: URL well-formedness checking is first-party (the
``validators`` package is absent) and downloads enforce the size cap
in-flight like the reference's /upload-url loop (back/api.py:1890-1930).
A copy of the JAX package's serve/urls.py, except that ``requests`` is
imported on first use (``_requests``), so the server starts where only the
URL-ingest routes would need it.
"""

from __future__ import annotations

import logging
import re
import tempfile
from typing import Optional
from urllib.parse import urlparse

from clearconverse_tpu_torch.serve.http import HTTPException

logger = logging.getLogger(__name__)


def _requests():
    """The ``requests`` package, imported by the functions that fetch."""
    import requests
    return requests

_UA = {"User-Agent": "Mozilla/5.0 (Windows NT 10.0; Win64; x64) "
       "AppleWebKit/537.36 (KHTML, like Gecko) Chrome/91.0.4472.124 Safari/537.36"}

_URL_RE = re.compile(
    r"^https?://"
    r"([a-zA-Z0-9]([a-zA-Z0-9-]{0,61}[a-zA-Z0-9])?\.)+[a-zA-Z]{2,}"
    r"(:\d{1,5})?(/[^\s]*)?$")

VALID_EXTENSIONS = (".mp3", ".wav", ".ogg", ".mp4", ".flac", ".m4a", ".aac")


def is_wellformed_url(url: str) -> bool:
    return bool(_URL_RE.match(url))


def extract_drive_file_id(url: str) -> Optional[str]:
    m = re.search(r"/file/d/([^/]+)", url)
    if m:
        return m.group(1)
    m = re.search(r"[?&]id=([^&]+)", url)
    return m.group(1) if m else None


def validate_url(url: str, check_remote: bool = True) -> bool:
    """back/api.py:470-528 semantics; raises HTTPException(400) on failure."""
    if not is_wellformed_url(url):
        raise HTTPException(400, "Invalid URL format")
    if "drive.google.com" in url:
        if not extract_drive_file_id(url):
            raise HTTPException(
                400, "Invalid Google Drive URL format. Could not extract file ID.")
        return True
    if not check_remote:
        return True
    requests = _requests()
    try:
        resp = requests.head(url, headers=_UA, timeout=10)
        if not resp.ok:
            raise HTTPException(400, f"URL returned status code {resp.status_code}. "
                                "Make sure the URL is publicly accessible.")
        ctype = resp.headers.get("Content-Type", "").lower()
        if not any(t in ctype for t in ("audio/", "video/")):
            path = urlparse(url).path.lower()
            if not any(path.endswith(e) for e in VALID_EXTENSIONS):
                logger.warning("URL may not point to audio/video content: %s", ctype)
    except requests.exceptions.Timeout:
        raise HTTPException(400, "URL request timed out. Server might be slow or unreachable.")
    except requests.exceptions.ConnectionError:
        raise HTTPException(400, "Failed to connect to the URL. Please check if "
                            "the URL is correct and the server is running.")
    except requests.exceptions.RequestException as exc:
        raise HTTPException(400, f"Error validating URL: {exc}")
    return True


def _ext_from_content_type(content_type: str, url: str) -> str:
    if "audio/wav" in content_type:
        return ".wav"
    if "audio/mpeg" in content_type or "audio/mp3" in content_type:
        return ".mp3"
    if "audio/ogg" in content_type:
        return ".ogg"
    if "video/mp4" in content_type:
        return ".mp4"
    path = urlparse(url).path
    if "." in path:
        ext = path.split(".")[-1].lower()
        if ext in ("mp3", "wav", "ogg", "mp4"):
            return f".{ext}"
    return ".mp3"


def _size_cap_413(total_bytes: int) -> HTTPException:
    # Exact reference detail text (back/api.py:1902-1905) — the size of
    # what was seen so far rides in the message.
    size_mb = total_bytes / (1024 * 1024)
    return HTTPException(
        413, "File size exceeds the maximum limit of 10MB. "
             f"File size: {size_mb:.2f}MB")


def _head_size_precheck(url: str, max_bytes: Optional[int],
                        headers: Optional[dict] = None) -> None:
    """Reject oversize files from Content-Length BEFORE downloading
    (back/api.py:1929-1939 / 1859-1872); a failed HEAD falls through to
    the in-flight check."""
    if max_bytes is None:
        return
    requests = _requests()
    try:
        resp = requests.head(url, headers=headers, timeout=10)
        length = resp.headers.get("Content-Length")
        if length and int(length) > max_bytes:
            raise _size_cap_413(int(length))
    except requests.exceptions.RequestException:
        pass


def download_file_from_url(url: str, output_path: Optional[str] = None,
                           max_bytes: Optional[int] = None) -> str:
    _head_size_precheck(url, max_bytes, headers=_UA)
    requests = _requests()
    try:
        resp = requests.get(url, headers=_UA, stream=True, timeout=30)
        resp.raise_for_status()
        if not output_path:
            ext = _ext_from_content_type(resp.headers.get("Content-Type", ""), url)
            tmp = tempfile.NamedTemporaryFile(suffix=ext, delete=False)
            output_path = tmp.name
            tmp.close()
        total = 0
        with open(output_path, "wb") as fh:
            for chunk in resp.iter_content(chunk_size=8192):
                total += len(chunk)
                if max_bytes is not None and total > max_bytes:
                    raise _size_cap_413(total)
                fh.write(chunk)
        return output_path
    except HTTPException:
        _unlink_partial(output_path)
        raise
    except Exception as exc:  # noqa: BLE001
        # Reference-exact wrap (back/api.py:1976): EVERY non-HTTPException
        # failure — request errors and local OSErrors alike — maps to 400
        # "Failed to download file: ..." so the route's outer wrap
        # composes byte-identically (previously
        # request errors said "from URL" and local errors said 500).
        _unlink_partial(output_path)
        raise HTTPException(400, f"Failed to download file: {exc}")


def _unlink_partial(path: Optional[str]) -> None:
    """A capped or failed download must not leave a partial file behind
    (the reference unlinks its temp file on every error path,
    back/api.py:1899-1920)."""
    import os
    if path:
        try:
            os.unlink(path)
        except OSError:
            pass


def download_file_from_google_drive(file_id: str,
                                    output_path: Optional[str] = None,
                                    max_bytes: Optional[int] = None) -> str:
    """Confirm-token cookie dance (back/api.py:410-468)."""
    base = "https://drive.google.com/uc?export=download"
    if not output_path:
        tmp = tempfile.NamedTemporaryFile(suffix=".mp3", delete=False)
        output_path = tmp.name
        tmp.close()
    # Content-Length pre-check on the export URL (back/api.py:1859-1872;
    # the reference sends no UA header on this HEAD).
    _head_size_precheck(f"{base}&id={file_id}", max_bytes)
    # timeout on BOTH requests: the handler runs on the single asyncio
    # event loop — an unbounded synchronous get would freeze every route
    # and WebSocket on the server. Request failures map to 400 like the
    # sibling download_file_from_url (and back/api.py:1987), not a 500.
    requests = _requests()
    try:
        session = requests.Session()
        resp = session.get(base, params={"id": file_id}, stream=True,
                           headers=_UA, timeout=30)
        token = next((v for k, v in resp.cookies.items()
                      if k.startswith("download_warning")), None)
        params = ({"id": file_id, "confirm": token} if token
                  else {"id": file_id})
        resp = session.get(base, params=params, stream=True, headers=_UA,
                           timeout=30)
        if resp.status_code != 200:
            raise HTTPException(400,
                                "Failed to download file from Google Drive. "
                                f"Status code: {resp.status_code}")
        if "text/html" in resp.headers.get("Content-Type", ""):
            logger.warning("Received HTML content instead of file. "
                           "This might indicate access restrictions.")
        total = 0
        with open(output_path, "wb") as fh:
            for chunk in resp.iter_content(chunk_size=8192):
                if chunk:
                    total += len(chunk)
                    if max_bytes is not None and total > max_bytes:
                        raise _size_cap_413(total)
                    fh.write(chunk)
    except HTTPException:
        _unlink_partial(output_path)
        raise
    except Exception as exc:  # noqa: BLE001
        # Same generic wrap as the sibling (back/api.py:1920): a disk
        # failure mid-write must unlink the partial and surface 400, not
        # escape raw.
        _unlink_partial(output_path)
        raise HTTPException(400, f"Failed to download file: {exc}")
    logger.info("Downloaded Drive file %s (%d bytes)", file_id, total)
    return output_path
