"""Task orchestration: the reference's marker-file protocol with an
in-process, group-batching executor.

Protocol parity (back/api.py:1689-1754): per task directory
``{output_dir}/{task_id}/`` with ``progress.json`` + markers
``in_progress.txt`` / ``completed.txt`` / ``error.txt`` / ``cancelled.txt``
written with the same contents and ordering — the WS poller and status
endpoint read EXACTLY what the reference's do.

Execution differences (designed, SURVEY.md §5.8):
  * ONE shared TranscriptionEngine — models load once, not per forked worker
    (the reference reloads everything per task, back/api.py:1718).
  * A dispatcher thread drains the queue; when several tasks are waiting it
    runs them as ONE grouped engine call (engine.run_many) whose
    transcription batches mix segments across requests — impossible in the
    reference's process-per-task design.
  * Cancellation is cooperative: a per-task event checked at progress
    boundaries (single tasks abort mid-run; grouped tasks skip their output
    writes and their directory is already replaced by cancelled.txt).

A copy of the JAX package's serve/tasks.py, with one difference: a failed
task still gets its error marker, but is logged at ERROR with its
traceback, and an error ``utils/errors.is_fatal`` names (a CUDA failure, a
piece the port lacks) also sets ``fatal_error``. From then on every task
fails at once with that error and ``/health`` reports it, instead of the
server looking healthy on a broken device.
"""

from __future__ import annotations

import inspect
import json
import logging
import os
import shutil
import threading
import time
from collections import deque
from datetime import datetime
from typing import Callable, Dict, List, Optional, Tuple

from clearconverse_tpu_torch.pipeline.cancel import ProcessingCancelled
from clearconverse_tpu_torch.utils.errors import is_fatal

logger = logging.getLogger(__name__)


def _cancel_kwargs(run_fn: Callable, should_cancel: Callable[[], bool]) -> Dict:
    """{'should_cancel': hook} when the engine's run supports batch-granular
    cancellation (TranscriptionEngine does; minimal test fakes may not)."""
    try:
        if "should_cancel" in inspect.signature(run_fn).parameters:
            return {"should_cancel": should_cancel}
    except (TypeError, ValueError):
        pass
    return {}

MAX_GROUP = 4   # tasks batched into one engine call (CC_TPU_MAX_GROUP)


def _default_max_group() -> int:
    """CC_TPU_MAX_GROUP overrides how many queued tasks share one grouped
    engine call. 4 is a conservative default for request-latency fairness;
    throughput-oriented deployments can raise it."""
    try:
        v = int(os.environ.get("CC_TPU_MAX_GROUP", MAX_GROUP))
        return v if v >= 1 else MAX_GROUP
    except ValueError:
        return MAX_GROUP


class TaskCancelled(Exception):
    pass


class TaskRunner:
    def __init__(self, output_dir: str, engine_factory: Callable,
                 max_group: Optional[int] = None):
        self.output_dir = output_dir
        self._engine_factory = engine_factory
        self._engine = None
        self._engine_lock = threading.Lock()   # one engine run at a time
        self.max_group = (max_group if max_group is not None
                          else _default_max_group())
        # Live model-load state read by /model-loading-status (mutated in
        # place; the app handler holds a reference).
        self.model_loading: Dict = {"progress": 0,
                                    "message": "Models not loaded"}
        # In-memory stores, same roles as back/api.py:94-578.
        self.active_tasks: Dict[str, Dict] = {}
        self.progress_store: Dict[str, Dict] = {}
        self.result_store: Dict[str, Dict] = {}
        self.uploaded_files: Dict[str, str] = {}
        self.original_filenames: Dict[str, str] = {}
        self._queue: deque = deque()
        self._wakeup = threading.Event()
        self._dispatcher: Optional[threading.Thread] = None
        # Guards the spawn-vs-retire decision: without it, start() can see a
        # dispatcher that is past its final queue check but not yet dead, and
        # the enqueued task would sit until the next start().
        self._dispatch_lock = threading.Lock()
        # The first is_fatal error of a run or of the startup warm: the
        # device (or the port) cannot serve, so tasks fail fast with it.
        self.fatal_error: Optional[BaseException] = None

    # ------------------------------------------------------------- engine
    def engine(self):
        if self._engine is None:
            self._engine = self._engine_factory()
            # Surface the loader's real staged percentages (10/40/70/100,
            # back/api.py:617-655 stage order) to /model-loading-status by
            # teeing every load progress callback into self.model_loading.
            orig_load = getattr(self._engine, "load_models_with_progress",
                                None)
            if orig_load is None:  # minimal engine fakes skip loading
                return self._engine

            def load_with_status(progress_callback=None):
                def cb(pct, msg):
                    self.model_loading["progress"] = pct
                    self.model_loading["message"] = msg
                    if progress_callback:
                        progress_callback(pct, msg)
                return orig_load(cb)

            self._engine.load_models_with_progress = load_with_status
        return self._engine

    def note_failure(self, exc: BaseException) -> None:
        """Record ``exc`` as the server's fatal error if it is one."""
        if is_fatal(exc) and self.fatal_error is None:
            self.fatal_error = exc
            logger.error("fatal error, the server can no longer run tasks: "
                         "%s", exc)

    def _check_serviceable(self) -> None:
        if self.fatal_error is not None:
            raise RuntimeError(f"the server hit a fatal error earlier: "
                               f"{self.fatal_error}")

    def update_progress(self, task_id: str, percent: int, message: str) -> None:
        self.progress_store[task_id] = {"progress": percent, "message": message}
        logger.info("Task %s: %d%% - %s", task_id, percent, message)

    # -------------------------------------------------------------- start
    def start(self, task_id: str, file_path: str) -> None:
        cancel = threading.Event()
        done = threading.Event()
        self.active_tasks[task_id] = {
            "cancel": cancel, "done": done,
            "start_time": time.time(), "file_path": file_path,
        }
        with self._dispatch_lock:
            self._queue.append((task_id, file_path, cancel, done))
            self._wakeup.set()
            if self._dispatcher is None or not self._dispatcher.is_alive():
                self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                                    daemon=True)
                self._dispatcher.start()

    def is_alive(self, task_id: str) -> bool:
        info = self.active_tasks.get(task_id)
        return bool(info and not info["done"].is_set())

    def _dispatch_loop(self) -> None:
        while True:
            if not self._queue:
                self._wakeup.clear()
                if self._queue:  # enqueued between the check and the clear
                    continue
                if not self._wakeup.wait(timeout=60):
                    with self._dispatch_lock:
                        if not self._queue:
                            self._dispatcher = None
                            return  # idle: retire under the lock
                continue
            group: List[Tuple] = []
            while self._queue and len(group) < self.max_group:
                task_id, path, cancel, done = self._queue.popleft()
                if cancel.is_set():
                    done.set()
                    continue
                group.append((task_id, path, cancel, done))
            if not group:
                continue
            try:
                if len(group) == 1:
                    self._run_task(*group[0][:3])
                else:
                    self._run_group(group)
            except Exception as exc:  # noqa: BLE001 — keep dispatching
                logger.error("dispatcher error: %s", exc, exc_info=True)
            finally:
                for _, _, _, done in group:
                    done.set()

    # -------------------------------------------------------------- single
    def _make_progress_cb(self, task_id: str, task_dir: str,
                          cancel: threading.Event, raise_on_cancel: bool):
        def progress_callback(percent, message):
            if cancel.is_set():
                if raise_on_cancel:
                    raise TaskCancelled()
                return
            with open(os.path.join(task_dir, "progress.json"), "w") as fh:
                json.dump({"progress": percent, "message": message}, fh)
            logger.info("Task %s: %s%% - %s", task_id, percent, message)
        return progress_callback

    def _finish_ok(self, task_id: str, task_dir: str, cb) -> None:
        cb(100, "Transcription complete")
        # Terminal marker FIRST, in_progress removal after: a server
        # killed between the two leaves the dir with completed.txt (every
        # reader checks completed before in_progress), whereas the old
        # remove-then-write order could strand a dir with NEITHER marker —
        # which the orphan-cancel rescue (cancel(), gated on
        # in_progress.txt) can no longer rescue, so the WS observer would
        # poll it forever.
        with open(os.path.join(task_dir, "completed.txt"), "w") as fh:
            fh.write(f"Transcription completed at {datetime.now().isoformat()}")
        in_progress = os.path.join(task_dir, "in_progress.txt")
        if os.path.exists(in_progress):
            os.remove(in_progress)
        # The reference's forked worker could never write result_store
        # (separate address space — SURVEY.md §2.2 quirk); in-process we can.
        self.result_store[task_id] = {
            "status": "completed",
            "download_url": f"/download/{task_id}/transcript.txt",
        }

    def _finish_error(self, task_id: str, task_dir: str, cb, exc) -> None:
        with open(os.path.join(task_dir, "error.txt"), "w") as fh:
            fh.write(f"Error: {exc}")
        in_progress = os.path.join(task_dir, "in_progress.txt")
        if os.path.exists(in_progress):
            os.remove(in_progress)
        try:
            cb(100, f"Error: {exc}")
        except TaskCancelled:
            pass

    def _run_task(self, task_id: str, file_path: str,
                  cancel: threading.Event) -> None:
        task_dir = os.path.join(self.output_dir, task_id)
        os.makedirs(task_dir, exist_ok=True)
        if os.path.exists(os.path.join(task_dir, "completed.txt")):
            logger.info("Task %s already completed, skipping", task_id)
            return
        cb = self._make_progress_cb(task_id, task_dir, cancel,
                                    raise_on_cancel=True)
        try:
            cb(5, "Starting model initialization...")
            with self._engine_lock:
                if cancel.is_set():
                    raise TaskCancelled()
                self._check_serviceable()
                run = self.engine().run
                _, transcript, _ = run(
                    file_path, output_dir=task_dir, debug_mode=False,
                    progress_callback=cb,
                    **_cancel_kwargs(run, cancel.is_set))
            if transcript is None:
                raise RuntimeError("Processing produced no transcript")
            self._finish_ok(task_id, task_dir, cb)
        except (TaskCancelled, ProcessingCancelled):
            logger.info("Task %s cancelled", task_id)
        except Exception as exc:  # noqa: BLE001 — parity: error marker
            logger.error("Error in transcription process: %s", exc,
                         exc_info=True)
            if not cancel.is_set():
                self._finish_error(task_id, task_dir, cb, exc)
            self.note_failure(exc)

    # -------------------------------------------------------------- group
    def _run_group(self, group: List[Tuple]) -> None:
        """Several queued tasks → one engine.run_many call (cross-request
        transcription batching)."""
        inputs, cbs, live = [], [], []
        for task_id, path, cancel, _done in group:
            task_dir = os.path.join(self.output_dir, task_id)
            os.makedirs(task_dir, exist_ok=True)
            if os.path.exists(os.path.join(task_dir, "completed.txt")):
                continue
            cb = self._make_progress_cb(task_id, task_dir, cancel,
                                        raise_on_cancel=False)
            cb(5, "Starting model initialization...")
            inputs.append((path, task_dir))
            cbs.append(cb)
            live.append((task_id, task_dir, cancel, cb))
        if not inputs:
            return
        logger.info("Grouped run: %d tasks share transcription batches",
                    len(inputs))
        try:
            with self._engine_lock:
                self._check_serviceable()
                run_many = self.engine().run_many
                # Group-level batch abort only when EVERY member cancelled
                # (a surviving member still needs the shared batches).
                all_cancelled = lambda: all(c.is_set() for _, _, c, _ in live)  # noqa: E731
                results = run_many(inputs, cbs,
                                   **_cancel_kwargs(run_many, all_cancelled))
        except ProcessingCancelled:
            logger.info("Grouped run cancelled (all members)")
            return
        except Exception as exc:  # noqa: BLE001 — whole group errored
            logger.error("Error in grouped transcription: %s", exc,
                         exc_info=True)
            for task_id, task_dir, cancel, cb in live:
                if not cancel.is_set():
                    self._finish_error(task_id, task_dir, cb, exc)
            self.note_failure(exc)
            return
        for (task_id, task_dir, cancel, cb), (_, transcript, _) in zip(live, results):
            if cancel.is_set():
                logger.info("Task %s cancelled during grouped run", task_id)
                continue
            if transcript is None:
                self._finish_error(task_id, task_dir, cb,
                                   "Processing produced no transcript")
            else:
                self._finish_ok(task_id, task_dir, cb)

    # -------------------------------------------------------------- cancel
    def cancel(self, task_id: str) -> None:
        """Reference semantics (back/api.py:2073-2139): stop work, delete
        the output dir, write cancelled.txt, KEEP the upload. Disk is
        touched ONLY for an ACTIVE task — the reference's not-active branch
        (api.py:2137-2139) just acknowledges; unconditional deletion would
        destroy a finished transcript (e.g. a stale tab's sendBeacon after
        a restart) and fabricate 'cancelled' state for arbitrary IDs."""
        info = self.active_tasks.pop(task_id, None)
        if not info:
            # Restart-orphaned task: its dir holds in_progress.txt (the
            # route writes it at task start; _finish_* removes it) but no
            # terminal marker — a previous process died mid-run, so WS/poll
            # observers would otherwise spin forever. Write cancelled.txt
            # to give them a terminal state. The in_progress.txt gate is
            # the evidence the dir was produced by this server mid-run
            # : unknown IDs, foreign dirs, and dirs that
            # already reached a terminal marker stay untouched.
            task_dir = os.path.join(self.output_dir, task_id)
            if (os.path.isdir(task_dir)
                    and os.path.exists(
                        os.path.join(task_dir, "in_progress.txt"))
                    and not any(
                        os.path.exists(os.path.join(task_dir, marker))
                        for marker in ("completed.txt", "error.txt",
                                       "cancelled.txt"))):
                with open(os.path.join(task_dir, "cancelled.txt"), "w") as fh:
                    fh.write("Transcription was cancelled")
                # The rescue must also clear in_progress.txt, or
                # /transcribe forever answers "already_in_progress" for a
                # task whose status simultaneously reads "cancelled" —
                # re-transcription (which the cancel flow explicitly
                # preserves the upload for) would be dead.
                try:
                    os.remove(os.path.join(task_dir, "in_progress.txt"))
                except OSError:
                    pass
            return
        info["cancel"].set()
        task_dir = os.path.join(self.output_dir, task_id)
        if (os.path.exists(os.path.join(task_dir, "completed.txt"))
                and os.path.exists(os.path.join(task_dir, "transcript.txt"))):
            # Deliberate deviation (docs/PARITY.md #14): the reference's
            # lingering active_processes entry makes a late /cancel of an
            # ALREADY-COMPLETED task delete the finished transcript and
            # overwrite its state with cancelled.txt. We acknowledge the
            # cancel (result_store, handled by the route) but never
            # destroy a completed transcript.
            return
        if os.path.exists(task_dir):
            try:
                shutil.rmtree(task_dir)
            except OSError as exc:
                logger.error("Failed to remove output dir: %s", exc)
        os.makedirs(task_dir, exist_ok=True)
        with open(os.path.join(task_dir, "cancelled.txt"), "w") as fh:
            fh.write("Transcription was cancelled")

    def stop_if_running(self, task_id: str) -> None:
        info = self.active_tasks.pop(task_id, None)
        if info:
            info["cancel"].set()
