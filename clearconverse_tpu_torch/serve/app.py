"""The HTTP/WS API of the port — the JAX package's serve/app.py routes,
byte-compatible with the reference surface (back/api.py:1555-2785,
inventory SURVEY.md §2.2), in front of the port's engine.

Reproduced quirks (SURVEY.md §7): the 25 MB cap whose error text says
"10MB" (back/api.py:1761,1777) and ``/task/{id}/status``'s duplicate
registration, first version winning. Fixed gaps: ``/model-loading-status``
exists and ``/task/{id}/result`` is populated.

Where the port departs from the JAX app: ``main()`` refuses to start
without a CUDA device unless ``CC_TPU_FAKE_MODELS=1`` (the dev backend runs
no device code), and a failed startup warm-up is logged with its traceback
and, when fatal (``utils/errors.is_fatal``), marks the runner failed, which
``/health`` reports as 503.
"""

from __future__ import annotations

import asyncio
import logging
import os
import shutil
import time
import uuid
from datetime import datetime, timedelta
from pathlib import Path

from clearconverse_tpu_torch.serve import urls as urlmod
from clearconverse_tpu_torch.serve.http import (
    App, HTTPException, Request, Response, file_response, json_response)
from clearconverse_tpu_torch.serve.pdf import generate_transcript_pdf
from clearconverse_tpu_torch.serve.tasks import TaskRunner

logger = logging.getLogger(__name__)

MAX_FILE_SIZE_MB = 25
MAX_FILE_SIZE_BYTES = MAX_FILE_SIZE_MB * 1024 * 1024


def create_app(output_dir: str = "processed_audio",
               temp_dir: str = "temp_uploads",
               engine_factory=None,
               start_cleanup: bool = True) -> App:
    app = App()
    out_dir = Path(output_dir)
    temp_uploads = Path(temp_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    temp_uploads.mkdir(parents=True, exist_ok=True)

    if engine_factory is None:
        # Shared with the warmup CLI so the warmed engine IS the served one
        # (serve/factory.py).
        from clearconverse_tpu_torch.serve.factory import default_engine_factory
        engine_factory = default_engine_factory

    runner = TaskRunner(str(out_dir), engine_factory)
    app.state = runner  # exposed for tests

    # ------------------------------------------------------------- uploads
    @app.post("/upload-file")
    async def upload_file(req: Request):
        files = req.files()
        up = files.get("file")
        if up is None:
            raise HTTPException(400, "No file provided.")
        if not up.filename.endswith((".mp3", ".wav")):
            raise HTTPException(400, "Invalid file type provided.")
        content = up.content
        if len(content) > MAX_FILE_SIZE_BYTES:
            # Reference quirk: cap is 25 MB, message says 10MB (api.py:1777).
            raise HTTPException(
                413, "File size exceeds the maximum limit of 10MB. "
                f"Your file is {len(content) / (1024 * 1024):.2f}MB.")
        task_id = str(uuid.uuid4())
        ext = os.path.splitext(up.filename)[1]
        filename = f"{task_id}{ext}"
        file_path = temp_uploads / filename
        runner.original_filenames[task_id] = up.filename
        file_path.write_bytes(content)
        runner.update_progress(task_id, 0, "File uploaded")

        if str(file_path).lower().endswith(".mp3"):
            from clearconverse_tpu_torch.audio.decode import ensure_wav_format
            runner.update_progress(task_id, 5, "Converting MP3 to WAV")
            # Off-loop: the ffmpeg subprocess can take seconds for a
            # 25 MB file and would stall every other route and WS socket.
            runner.uploaded_files[task_id] = await asyncio.to_thread(
                ensure_wav_format, str(file_path))
            runner.update_progress(task_id, 10, "Conversion complete")
        else:
            runner.uploaded_files[task_id] = str(file_path)
            runner.update_progress(task_id, 10, "File ready for processing")
        return {"task_id": task_id, "preview_url": f"/preview/{filename}"}

    @app.post("/upload-url")
    async def upload_url(req: Request):
        url = req.form().get("url")
        if not url:
            raise HTTPException(400, "Invalid URL format")
        # ALL blocking network work (validation HEAD, downloads,
        # conversion subprocess) runs off the event loop: this is a
        # single-process single-loop server, and a slow-but-alive remote
        # would otherwise freeze every route and WS progress socket for
        # the transfer's duration (requests' timeout bounds one silent
        # gap, not total time). The reference blocks its loop
        # the same way, but it can afford to: its pipeline runs in a
        # separate worker process.
        await asyncio.to_thread(urlmod.validate_url, url)
        task_id = str(uuid.uuid4())
        from urllib.parse import urlparse
        parsed = urlparse(url)
        # Parity (back/api.py:1814-1817): lowercase the URL extension and
        # whitelist it, defaulting to .mp3 for anything else (Drive URLs
        # have no usable path extension, so they land on .mp3 too).
        ext = os.path.splitext(parsed.path)[1].lower()
        if ext not in (".mp3", ".wav", ".ogg", ".mp4", ".flac",
                       ".m4a", ".aac"):
            ext = ".mp3"
        filename = f"{task_id}{ext}"
        path = str(temp_uploads / filename)
        # The ORIGINAL name comes from the URL's basename (or a default),
        # recorded BEFORE the download (back/api.py:1822-1828) — it names
        # the PDF download ("{origname}-Transcript.pdf"), so storing the
        # local task-id filename here would leak uuids into user-facing
        # filenames.
        runner.original_filenames[task_id] = (
            os.path.basename(parsed.path) or f"recording{ext}")
        runner.update_progress(task_id, 5, "Starting download from URL")
        try:
            if "drive.google.com" in url:
                file_id = urlmod.extract_drive_file_id(url)
                runner.update_progress(task_id, 10,
                                       "Downloading from Google Drive")
                await asyncio.to_thread(
                    urlmod.download_file_from_google_drive,
                    file_id, path, max_bytes=MAX_FILE_SIZE_BYTES)
            else:
                runner.update_progress(task_id, 5,
                                       "Downloading audio from URL")
                await asyncio.to_thread(
                    urlmod.download_file_from_url,
                    url, path, max_bytes=MAX_FILE_SIZE_BYTES)
            runner.update_progress(task_id, 25, "Download complete")
            if path.lower().endswith(".mp3"):
                from clearconverse_tpu_torch.audio.decode import ensure_wav_format
                runner.update_progress(task_id, 5, "Converting MP3 to WAV")
                runner.uploaded_files[task_id] = await asyncio.to_thread(
                    ensure_wav_format, path)
                runner.update_progress(task_id, 10, "Conversion complete")
            else:
                runner.uploaded_files[task_id] = path
        except Exception as exc:  # noqa: BLE001 — deliberate quirk parity
            # The reference's outer wrap (back/api.py:1988-1990) catches
            # EVERYTHING — including its own just-raised HTTPExceptions —
            # and re-raises 400 "Failed to download file: <str(exc)>", so
            # even the 413 size cap surfaces to clients as a 400 whose
            # detail embeds "413: File size exceeds ...". Reproduced
            # byte-for-byte (docs/PARITY.md).
            logger.error("Error downloading file from URL %s: %s", url, exc)
            raise HTTPException(400, f"Failed to download file: {exc}")
        # preview_url carries the PRE-conversion filename — for an MP3
        # source the preview serves the original .mp3 (still on disk;
        # ensure_wav_format writes a sibling .wav), back/api.py:1999.
        return {"task_id": task_id,
                "preview_url": f"/preview/{filename}"}

    @app.get("/preview/{filename}")
    async def preview_audio(req: Request):
        file_path = temp_uploads / req.path_params["filename"]
        if not file_path.exists():
            raise HTTPException(404, "File not found")
        return file_response(str(file_path), "audio/mpeg",
                             req.path_params["filename"])

    # ---------------------------------------------------------- transcribe
    @app.post("/transcribe/{task_id}")
    async def transcribe_task(req: Request):
        task_id = req.path_params["task_id"]
        if task_id not in runner.uploaded_files:
            raise HTTPException(
                404, "Task ID not found. Please upload a file or URL first.")
        file_path = runner.uploaded_files[task_id]
        task_dir = out_dir / task_id
        if (task_dir / "completed.txt").exists():
            return {"task_id": task_id, "status": "already_completed"}
        if (task_dir / "in_progress.txt").exists():
            return {"task_id": task_id, "status": "already_in_progress"}
        task_dir.mkdir(parents=True, exist_ok=True)
        # Deliberate deviation (docs/PARITY.md #16): clear stale terminal
        # markers from a previous cancelled/errored run. The reference
        # leaves them (back/api.py:2019-2021 checks only completed/
        # in_progress), and since its status surfaces check cancelled.txt
        # FIRST, the re-transcription its /cancel explicitly preserves the
        # upload for ("allow re-transcription", api.py:2126) reports
        # "cancelled" forever even after completing.
        for stale in ("cancelled.txt", "error.txt"):
            try:
                (task_dir / stale).unlink()
            except OSError:
                pass
        (task_dir / "in_progress.txt").write_text(
            f"Started at {datetime.now().isoformat()}")
        runner.update_progress(task_id, 0, "Task queued for transcription")
        runner.stop_if_running(task_id)
        runner.start(task_id, file_path)
        runner.update_progress(task_id, 5, "Starting transcription process")
        return {"task_id": task_id}

    @app.post("/cancel/{task_id}")
    async def cancel_task(req: Request):
        task_id = req.path_params["task_id"]
        runner.update_progress(task_id, 99, "Cancelling transcription...")
        had_task = task_id in runner.active_tasks
        # Part of deviation #14 (tasks.cancel preserves a completed
        # transcript): the acknowledgement must not clobber the completed
        # result_store entry either, or /task/{id}/result says
        # "cancelled" for a transcript /task/{id}/status still reports
        # completed. The reference can't hit this (its worker never
        # populates result_store); unconditional writes for unknown ids
        # stay (api.py:2137-2139 parity).
        completed = ((out_dir / task_id / "completed.txt").exists()
                     and (out_dir / task_id / "transcript.txt").exists())

        def _ack():
            runner.update_progress(task_id, 100, "Transcription cancelled")
            if not completed:
                runner.result_store[task_id] = {
                    "status": "cancelled",
                    "message": "Transcription was cancelled"}

        try:
            runner.cancel(task_id)
            _ack()
            if had_task:
                return {"status": "cancelled",
                        "message": "Transcription cancelled successfully"}
            return {"status": "cancelled"}
        except Exception as exc:  # noqa: BLE001
            _ack()
            return {"status": "cancelled", "error": str(exc)}

    # -------------------------------------------------------------- status
    @app.get("/task/{task_id}/status")
    async def get_task_status(req: Request):
        task_id = req.path_params["task_id"]
        task_dir = out_dir / task_id
        if not task_dir.exists():
            return {"status": "not_found"}
        if (task_dir / "cancelled.txt").exists():
            return {"status": "cancelled",
                    "message": "Transcription was cancelled"}
        if (task_dir / "completed.txt").exists():
            if (task_dir / "transcript.txt").exists():
                return {"status": "completed",
                        "download_url": f"/download/{task_id}/transcript.txt"}
        if (task_dir / "error.txt").exists():
            try:
                return {"status": "error",
                        "message": (task_dir / "error.txt").read_text()}
            except OSError:
                return {"status": "error", "message": "Unknown error occurred"}
        progress_file = task_dir / "progress.json"
        if progress_file.exists():
            try:
                import json as _json
                data = _json.loads(progress_file.read_text())
                runner.progress_store[task_id] = data
                return data
            except (OSError, ValueError):
                pass
        if task_id in runner.active_tasks:
            elapsed = time.time() - runner.active_tasks[task_id]["start_time"]
            if task_id in runner.progress_store:
                return {**runner.progress_store[task_id],
                        "elapsed_seconds": elapsed}
            return {"status": "processing", "progress": 5,
                    "message": "Processing in progress...",
                    "elapsed_seconds": elapsed}
        if task_id in runner.progress_store:
            return runner.progress_store[task_id]
        return {"status": "unknown", "progress": 0, "message": "Unknown status"}

    # NOTE: the reference registers /task/{id}/status a second time at
    # back/api.py:2327; starlette keeps the first. http.py reproduces that
    # rule, so a duplicate here would be ignored the same way.

    @app.get("/task/{task_id}/result")
    async def get_task_result(req: Request):
        task_id = req.path_params["task_id"]
        store = runner.result_store
        if task_id in store and store[task_id].get("status") == "cancelled":
            return {"status": "cancelled",
                    "message": "Transcription was cancelled"}
        if task_id not in store:
            if (out_dir / task_id / "cancelled.txt").exists():
                return {"status": "cancelled",
                        "message": "Transcription was cancelled"}
            return json_response({"error": f"Task {task_id} not found"}, 404)
        result = store[task_id]
        if "download_url" in result:
            rel = result["download_url"].replace("/download/", "")
            if not (out_dir / rel).exists():
                result = {"status": "error",
                          "message": "Transcript file not found. It may have "
                          "been deleted or cleanup occurred."}
                store[task_id] = result
        return result

    @app.get("/model-loading-status")
    async def model_loading_status(req: Request):
        """Polled by the reference frontend but never implemented there
        (front/src/App.tsx:94 — SURVEY.md §2.2). Reports the loader's REAL
        staged percentages (10/40/70/100) teed into runner.model_loading."""
        engine = runner._engine
        if engine is not None and engine.models_are_loaded():
            return {"progress": 100, "message": "Models loaded"}
        return runner.model_loading

    # ------------------------------------------------------------ results
    @app.get("/transcription/{task_id}")
    async def get_transcription(req: Request):
        task_id = req.path_params["task_id"]
        tfile = out_dir / task_id / "transcript.txt"
        if (out_dir / task_id / "cancelled.txt").exists():
            return json_response({"status": "cancelled",
                                  "message": "Transcription was cancelled by the user"}, 202)
        if not tfile.exists():
            if task_id in runner.result_store:
                return json_response({
                    "error": "Transcript file not found",
                    "detail": "The transcript file may have been deleted or "
                    "the task was cancelled"}, 404)
            return json_response({
                "error": "Transcription not found",
                "detail": "No transcription data found for this task ID"}, 404)
        if tfile.stat().st_size == 0:
            return json_response({"error": "Empty transcript file",
                                  "detail": "The transcript file exists but contains no data"}, 400)
        transcript = tfile.read_text(encoding="utf-8")
        if not transcript.strip():
            return json_response({"error": "Empty transcript content",
                                  "detail": "The transcript file contains only whitespace"}, 400)
        return {"task_id": task_id, "transcription": transcript}

    @app.get("/download-pdf/{task_id}")
    async def download_pdf(req: Request):
        task_id = req.path_params["task_id"]
        tpath = out_dir / task_id / "transcript.txt"
        if not tpath.exists():
            raise HTTPException(404, "Transcript file not found.")
        try:
            pdf_path = out_dir / task_id / "transcript.pdf"
            original = runner.original_filenames.get(task_id)
            generate_transcript_pdf(tpath.read_text(encoding="utf-8"),
                                    str(pdf_path), original)
            if original:
                name = f"{os.path.splitext(original)[0]}-Transcript.pdf"
            else:
                name = "transcript.pdf"
            return file_response(str(pdf_path), "application/pdf", name)
        except Exception as exc:  # noqa: BLE001
            raise HTTPException(500, f"Failed to generate PDF: {exc}")

    @app.get("/download/{file_path:path}")
    async def download_transcript(req: Request):
        path = out_dir / req.path_params["file_path"]
        try:  # no path traversal out of the output dir
            path.resolve().relative_to(out_dir.resolve())
        except ValueError:
            raise HTTPException(404, "Transcript file not found.")
        if not path.exists():
            raise HTTPException(404, "Transcript file not found.")
        return file_response(str(path), "text/plain", path.name)

    # ------------------------------------------------------------ progress
    @app.websocket("/ws/progress/{task_id}")
    async def progress_ws(ws):
        task_id = ws.path_params["task_id"]
        task_dir = out_dir / task_id
        import json as _json

        def marker(name):
            return (task_dir / name).exists()

        if marker("cancelled.txt"):
            await ws.send_json({"progress": 100, "message": "Transcription cancelled"})
            return
        if marker("completed.txt") and marker("transcript.txt"):
            await ws.send_json({"progress": 100, "message": "Transcription complete"})
            return
        if marker("error.txt"):
            try:
                msg = (task_dir / "error.txt").read_text()
                await ws.send_json({"progress": 100, "message": f"Error: {msg}"})
            except OSError:
                await ws.send_json({"progress": 100,
                                    "message": "Error occurred during processing"})
            return

        current = runner.progress_store.get(
            task_id, {"progress": 5, "message": "Processing in progress..."})
        await ws.send_json(current)
        last = current
        ticks = 0
        # The handler is write-only at the app level, so
        # client frames (pong replies to our pings, stray texts) would
        # otherwise sit unread in the socket receive buffer for the task's
        # whole lifetime — a chatty client on a long task could fill it and
        # stall its own sends. A background reader drains and discards them
        # AT FULL SPEED (re-arming once per 0.5 s poll tick capped intake
        # at 2 frames/s — the buffer still filled, just slower)
        # — receive_text also answers client pings — and the poll loop ends
        # the moment the peer closes. The WebSocket's internal write lock
        # serializes the drain's pong replies against this loop's
        # send_json/ping (frame atomicity AND the transport's
        # single-waiter drain).
        async def _drain_forever():
            while (await ws.receive_text()) is not None:
                pass

        drain = asyncio.ensure_future(_drain_forever())
        try:
            while True:
                await asyncio.sleep(0.5)
                ticks += 1
                if drain.done():
                    break                          # peer closed or errored
                if ticks % 10 == 0:
                    # Liveness probe: the loop only writes on progress
                    # CHANGES, so a vanished client would otherwise leave
                    # this coroutine polling at 2 Hz forever. The ping
                    # raises once the peer is gone; the server's ws wrapper
                    # ends the handler.
                    await ws.ping()
                if (ticks >= 120 and not task_dir.exists()
                        and task_id not in runner.active_tasks
                        and task_id not in runner.uploaded_files):
                    # Unknown task (never uploaded, no output dir, not
                    # queued): nothing will ever produce markers — stop
                    # after 60 s instead of spinning unboundedly per
                    # connection.
                    await ws.close()
                    break
                if marker("cancelled.txt"):
                    await ws.send_json({"progress": 100,
                                        "message": "Transcription cancelled"})
                    break
                if marker("completed.txt"):
                    await ws.send_json({"progress": 100,
                                        "message": "Transcription complete"})
                    break
                if marker("error.txt"):
                    try:
                        msg = (task_dir / "error.txt").read_text()
                        await ws.send_json({"progress": 100,
                                            "message": f"Error: {msg}"})
                    except OSError:
                        await ws.send_json(
                            {"progress": 100,
                             "message": "Error occurred during processing"})
                    break
                pf = task_dir / "progress.json"
                if pf.exists():
                    try:
                        data = _json.loads(pf.read_text())
                        if data != last:
                            await ws.send_json(data)
                            last = data
                            runner.progress_store[task_id] = data
                    except (OSError, ValueError):
                        pass
                # Dead-worker detection (back/api.py:2574-2599).
                info = runner.active_tasks.get(task_id)
                if info and not runner.is_alive(task_id):
                    if not any(marker(m) for m in
                               ("completed.txt", "error.txt",
                                "cancelled.txt")):
                        await asyncio.sleep(2)
                        if not any(marker(m) for m in
                                   ("completed.txt", "error.txt",
                                    "cancelled.txt")):
                            await ws.send_json(
                                {"progress": 100,
                                 "message": "Process ended unexpectedly"})
                            task_dir.mkdir(parents=True, exist_ok=True)
                            (task_dir / "error.txt").write_text(
                                "Process ended unexpectedly")
                            break
        finally:
            # Cancel AND retrieve: a drain task that died on a socket
            # error (e.g. ConnectionResetError from its own pong write)
            # would otherwise log "Task exception was never retrieved"
            # on every abrupt disconnect.
            drain.cancel()
            try:
                await drain
            except asyncio.CancelledError:
                pass
            except Exception:
                pass

    # ------------------------------------------------------------- cleanup
    def _cleanup(task_id: str, preserve_uploads: bool):
        completed = ((out_dir / task_id / "completed.txt").exists()
                     and (out_dir / task_id / "transcript.txt").exists())
        runner.stop_if_running(task_id)
        files_removed = dirs_removed = 0
        if not completed:
            folder = out_dir / task_id
            if folder.is_dir():
                try:
                    shutil.rmtree(folder)
                    dirs_removed += 1
                except OSError as exc:
                    logger.error("Failed to remove %s: %s", folder, exc)
            if not preserve_uploads:
                for f in temp_uploads.glob(f"{task_id}*"):
                    try:
                        f.unlink()
                        files_removed += 1
                    except OSError:
                        pass
                runner.uploaded_files.pop(task_id, None)
        runner.progress_store.pop(task_id, None)
        runner.original_filenames.pop(task_id, None)
        if not completed:
            runner.result_store.pop(task_id, None)
        return {
            "status": "success",
            "message": f"Cleaned up task {task_id}",
            "details": {
                "files_removed": files_removed,
                "directories_removed": dirs_removed,
                "preserved_transcript": completed,
                "preserved_uploads": preserve_uploads,
            },
        }

    @app.delete("/cleanup/{task_id}")
    async def cleanup_task(req: Request):
        preserve = req.query.get("preserve_uploads", "false").lower() == "true"
        return _cleanup(req.path_params["task_id"], preserve)

    @app.post("/cleanup/{task_id}")
    async def cleanup_on_refresh(req: Request):
        # sendBeacon variant: always preserves uploads (back/api.py:2772-2781).
        return _cleanup(req.path_params["task_id"], True)

    @app.post("/admin/cleanup")
    async def manual_cleanup(req: Request):
        hours = int(req.query.get("hours", "1"))
        files_removed, dirs_removed = _age_sweep(hours)
        return {"status": "success",
                "message": f"Removed {files_removed} files and {dirs_removed} "
                f"directories older than {hours} hours"}

    def _age_sweep(hours: int):
        cutoff = datetime.now() - timedelta(hours=hours)
        files_removed = dirs_removed = 0
        for f in temp_uploads.glob("*"):
            if f.is_file() and datetime.fromtimestamp(f.stat().st_mtime) < cutoff:
                task_id = f.stem.split(".")[0]
                if task_id in runner.active_tasks:
                    # A queued-or-running task still needs its upload (the
                    # in-process executor can hold a backlog the reference's
                    # process-per-task model never had — a queued task
                    # hasn't even read the file yet). Old-by-mtime but
                    # active files wait for the next sweep.
                    continue
                try:
                    f.unlink()
                    files_removed += 1
                except OSError:
                    continue
                for store in (runner.progress_store, runner.result_store,
                              runner.active_tasks, runner.uploaded_files):
                    store.pop(task_id, None)
        for d in out_dir.glob("*"):
            if not d.is_dir():
                continue
            if d.name in runner.active_tasks:
                continue
            try:
                most_recent = max((x.stat().st_mtime for x in d.glob("**/*")
                                   if x.is_file()), default=d.stat().st_mtime)
                if datetime.fromtimestamp(most_recent) < cutoff:
                    shutil.rmtree(d)
                    dirs_removed += 1
                    for store in (runner.progress_store, runner.result_store,
                                  runner.active_tasks, runner.uploaded_files):
                        store.pop(d.name, None)
            except OSError as exc:
                logger.error("Failed to remove %s: %s", d, exc)
        return files_removed, dirs_removed

    async def cleanup_old_files():
        while True:
            try:
                files_removed, dirs_removed = _age_sweep(1)
                logger.info("Cleanup: removed %d files, %d dirs",
                            files_removed, dirs_removed)
                await asyncio.sleep(60 * 60)
            except Exception as exc:  # noqa: BLE001
                logger.error("Error in cleanup task: %s", exc)
                await asyncio.sleep(60)

    if start_cleanup:
        async def _startup():
            asyncio.create_task(cleanup_old_files())
        app.on_startup.append(_startup)

    if os.environ.get("CC_TPU_STARTUP_WARM") == "1":
        # Opt-in: load models and drive every decode row bucket in this
        # process at startup, so the kernels' nvcc builds and cuBLAS/cuDNN
        # set-up land before the first request. Runs on a daemon thread;
        # every engine touch holds runner._engine_lock, the lock the task
        # dispatcher serializes engine runs with, so the lazy engine cannot
        # be built twice and warm drives never overlap a request.
        async def _warm_startup():
            import threading

            def _warm():
                try:
                    with runner._engine_lock:
                        eng = runner.engine()
                        if (hasattr(eng, "models_are_loaded")
                                and not eng.models_are_loaded()):
                            eng.load_models_with_progress()
                    from clearconverse_tpu_torch.serve.warmup import (
                        warm_decode_shapes)
                    n = [0]

                    def drive(label, fn):
                        with runner._engine_lock:
                            fn()
                        n[0] += 1
                        logger.info("startup warm: %s", label)

                    warm_decode_shapes(eng, drive)
                    logger.info("startup warm done: %d decode shapes", n[0])
                except Exception as exc:  # noqa: BLE001 — thread boundary
                    logger.error("startup warm failed: %s", exc, exc_info=True)
                    runner.note_failure(exc)

            threading.Thread(target=_warm, daemon=True,
                             name="cc-startup-warm").start()
        app.on_startup.append(_warm_startup)

    @app.get("/health")
    async def health(req: Request):
        if runner.fatal_error is not None:
            return json_response({"status": "error",
                                  "detail": str(runner.fatal_error)}, 503)
        return {"status": "ok"}

    return app


def main():
    """Serve on ``API_HOST``:``API_PORT``. Outside dev mode the engine runs
    on the card, so a missing CUDA device stops the start here.

    With ``CC_TORCH_DATA_AXIS`` × ``CC_TORCH_MODEL_AXIS`` > 1 the server
    runs under torchrun, one rank a card (``torchrun --nproc-per-node N -m
    clearconverse_tpu_torch.serve``): rank 0 serves HTTP/WS with its
    engine's bundle leading the mesh, every other rank follows its calls
    (parallel/serve.py)."""
    from clearconverse_tpu_torch.config import (
        load_environment, torch_config_from_env)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s [%(levelname)s] %(message)s")
    env = load_environment()
    factory, controller = None, None
    if os.environ.get("CC_TPU_FAKE_MODELS") != "1":
        import torch
        if not torch.cuda.is_available():
            raise SystemExit(
                "clearconverse_tpu_torch.serve: no CUDA device is available; "
                "the engine runs on the card. Set CC_TPU_FAKE_MODELS=1 for "
                "the weight-free dev backend on the CPU.")
        logger.info("CUDA device: %s", torch.cuda.get_device_name(0))
        tc = torch_config_from_env()
        if tc.data_axis * tc.model_axis > 1:
            engine, controller = _join_serving_mesh(env, tc)
            if engine is None:
                return           # a follower: rank 0 has closed
            factory = lambda: engine  # noqa: E731
    # Model directory scaffold (reference setup_model_directories,
    # back/api.py:2791-2807): where checkpoints/ft overlays are looked up.
    for sub in ("", "whisper", "whisper-ft", "resepformer-ft", "embedding",
                "segmentation"):
        os.makedirs(os.path.join(env["model_cache_dir"], sub), exist_ok=True)
    app = create_app(engine_factory=factory)
    app.cors_origins = env["cors_origins"]
    try:
        app.run(env["api_host"], env["api_port"])
    finally:
        if controller is not None:
            controller.close()


# A follower waits for rank 0's next call as long as the server is idle.
_SERVING_COLLECTIVE_TIMEOUT_S = 30 * 24 * 3600.0


def _join_serving_mesh(env, tc):
    """Join torchrun's process group, one card a rank. Rank 0 returns (its
    engine, whose bundle leads the mesh, the controller); every other rank
    follows rank 0's calls on a bundle of its own and returns (None, None)
    once rank 0 closes."""
    from clearconverse_tpu_torch.config import Config
    from clearconverse_tpu_torch.parallel.mesh import init_process_group
    from clearconverse_tpu_torch.parallel.serve import follow, lead
    from clearconverse_tpu_torch.pipeline.bundle import ModelBundle
    from clearconverse_tpu_torch.serve.factory import default_engine_factory

    device = init_process_group(timeout_s=_SERVING_COLLECTIVE_TIMEOUT_S)
    if int(os.environ["RANK"]) != 0:
        follow(ModelBundle(Config(auth_token=env["hf_auth_token"],
                                  whisper_model_size=env["whisper_model_size"]),
                           tc,
                           env["model_cache_dir"], device=device))
        return None, None
    engine = default_engine_factory()
    return engine, lead(engine.models)


if __name__ == "__main__":
    main()
