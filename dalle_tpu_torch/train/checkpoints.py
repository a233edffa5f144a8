"""Checkpoint save and restore with the model's identity inside.

Port of ``dalle_tpu/train/checkpoints.py``'s contract in torch format. A
checkpoint carries its metadata (``model_class``, ``hparams``, ``train``,
``vae_class_name``, ``vae_hparams``) beside the tensors, so generation can
rebuild the exact model from the directory alone; rotation keeps the
newest ``keep_n``; a pre-flight save fails fast on a directory that cannot
be written.

``load_model_checkpoint`` rebuilds a model from a checkpoint directory
alone, for the entry points; ``load_clip`` is its CLIP reranker's case.

Layout: ``<directory>/<step>/state.pt`` (``torch.save`` of a dict of
tensors) and ``<directory>/<step>/metadata.json``.

* **Asynchronous saves** (``async_save=True``, the trainers' default
  through ``TrainConfig.async_checkpointing``). ``save`` blocks only for
  the snapshot: every tensor copied to host memory, since the port's
  optimizers update the parameters and moments in place and the next step
  would change a reference under the write. The write, its fsyncs and the
  atomic rename run on a writer thread. A save issued while a write is in
  flight waits for that write first; ``wait_until_finished`` drains, as
  do ``restore``, ``load_metadata``, ``preflight``, ``close`` and the
  interpreter's exit. A failed background write is raised at the next
  ``save``, ``wait_until_finished`` or ``close``, never dropped.
  ``latest_step`` counts the step in flight. The snapshot of tensors on
  the card goes through a pinned staging area kept for the next save,
  chosen by measurement on an H100 for the 17.3 GB DALL·E-1.4B train state
  (``chip_smoke.py`` phase ``train_data``): fresh pageable memory took
  8.0–11.9 s a save, the pinned area 6.5–8.2 s the first time
  (page-locking) and 0.32–0.37 s after. The area then stays resident: the
  state's size in host memory.
* **Retried I/O.** The write and the reads run under the retry policy
  (``utils/retry.py``): ``with_retry("ckpt_save" | "ckpt_restore" |
  "ckpt_restore_meta", ...)``, the chaos ``io_hook`` inside the retried
  callable, so an injected ``fail_io`` is absorbed and counted as a real
  blip would be.
* **Atomic finalize.** A save writes ``<step>.tmp-<pid>-<n>/``, syncs its
  files and the directory to disk, and renames it to ``<step>/`` with
  ``os.replace`` (then syncs the parent); only finalized steps are listed,
  so a crash mid-write, of the process or of the machine, leaves a complete
  step or an ignored tmp directory.
* **Stale-tmp sweep.** ``gc_stale_tmp`` (run by ``restore`` and
  ``preflight``) removes tmp directories whose newest file is older than a
  grace time, so a sibling process's write in flight survives it.
* **Fallback.** ``restore(step=None)`` tries the newest step first and
  falls back to the next older one when loading fails (torn or corrupt
  files; ``ckpt.restore_fallback_total``). The failed steps are renamed
  ``<step>.corrupt`` only once some older step has loaded: if every step
  fails, nothing is renamed. A pinned ``step`` still raises, and so does a
  read whose retry budget ran out on an I/O error.
* **Loading** is ``torch.load(..., weights_only=True)``: no pickled code runs.
"""

from __future__ import annotations

import atexit
import itertools
import json
import os
import shutil
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..chaos import io_hook
from ..config import ClipConfig
from ..device import resolve_device
from ..models.clip import CLIP, init_clip
from ..obs import counter_add, gauge_set, record_event, span
from ..utils.retry import RetryBudgetExceeded, with_retry

STATE_FILE = "state.pt"
META_FILE = "metadata.json"
_TMP = ".tmp-"
_tmp_ids = itertools.count()

# every live manager, drained at the interpreter's exit so a write in
# flight lands first (weak: tests make many short-lived managers)
_LIVE: "weakref.WeakSet[CheckpointManager]" = weakref.WeakSet()
_inflight = [0]   # managers with a write in flight: the ckpt.write_inflight gauge
_inflight_lock = threading.Lock()


def _inflight_delta(d: int):
    with _inflight_lock:
        _inflight[0] = max(_inflight[0] + d, 0)
        gauge_set("ckpt.write_inflight", _inflight[0])


@atexit.register
def _drain_live_managers():
    for mgr in list(_LIVE):
        try:
            mgr.close()
        except Exception:  # noqa: BLE001 - exit must try every manager
            pass


def _fsync(path: str):
    """Flush a file's or a directory's entries to disk."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _newest_mtime(path: str) -> float:
    """The most recent mtime in ``path``'s tree: the liveness of a write."""
    newest = os.path.getmtime(path)
    for dirpath, _dirs, files in os.walk(path):
        for name in files:
            try:
                newest = max(newest, os.path.getmtime(os.path.join(dirpath, name)))
            except OSError:
                continue   # finalized or removed while walking
    return newest


def _view_key(t: torch.Tensor):
    return (t.untyped_storage().data_ptr(), t.storage_offset(), tuple(t.shape),
            t.stride(), t.dtype, t.device)


class _Snapshot:
    """Copies a state tree's tensors to host memory, views of one tensor
    (tied weights) to one copy. Tensors on the card go to page-locked
    buffers kept, by shape and dtype, for the next snapshot of the same
    tree; their copies are queued without blocking and awaited once."""

    def __init__(self):
        self._pool: Dict[Tuple, List[torch.Tensor]] = {}

    def take(self, state: Any) -> Any:
        memo: Dict[Tuple, torch.Tensor] = {}
        free = {k: list(v) for k, v in self._pool.items()}
        used: Dict[Tuple, List[torch.Tensor]] = {}
        cuda = []

        def copy(t: torch.Tensor) -> torch.Tensor:
            t = t.detach()
            key = _view_key(t)
            if key in memo:
                return memo[key]
            if t.device.type == "cuda":
                shape = (tuple(t.shape), t.dtype)
                bufs = free.get(shape)   # in the order of the last take: same tensor, same buffer
                out = bufs.pop(0) if bufs else torch.empty(t.shape, dtype=t.dtype,
                                                           pin_memory=True)
                used.setdefault(shape, []).append(out)
                out.copy_(t, non_blocking=True)
                cuda.append(t.device)
            else:
                out = t.to("cpu", copy=True)
            memo[key] = out
            return out

        def walk(tree):
            if isinstance(tree, torch.Tensor):
                return copy(tree)
            if isinstance(tree, dict):
                return {k: walk(v) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(walk(v) for v in tree)
            return tree

        out = walk(state)
        for dev in set(cuda):
            torch.cuda.synchronize(dev)
        self._pool = used
        return out


class CheckpointManager:
    """Steps of one run under ``directory``, created at the first save (a
    manager that only reads writes nothing). ``retry_kw`` is the retry
    policy of its I/O (instance-overridable: tests pin a fake sleep)."""

    retry_kw = {"attempts": 4, "base_delay_s": 0.05, "max_delay_s": 1.0}

    def __init__(self, directory: str, keep_n: Optional[int] = None,
                 async_save: bool = False, tmp_grace_s: float = 600.0):
        if keep_n is not None and keep_n < 1:
            raise ValueError(f"keep_n must be >= 1 or None, got {keep_n}")
        self.directory = os.path.abspath(directory)
        self.keep_n = keep_n
        self.async_save = bool(async_save)
        self.tmp_grace_s = float(tmp_grace_s)
        self._snapshot = _Snapshot()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.in_flight_step: Optional[int] = None
        self.last_save: Optional[Dict[str, float]] = None
        self._closed = False
        _LIVE.add(self)

    # -- listing -------------------------------------------------------------
    def all_steps(self) -> List[int]:
        """Finalized steps, oldest first."""
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        return sorted(int(n) for n in names
                      if n.isdigit() and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        """The newest finalized step, or the step in flight."""
        steps = self.all_steps()
        if self.in_flight_step is not None:
            steps.append(self.in_flight_step)
        return max(steps) if steps else None

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    # -- writing -------------------------------------------------------------
    def _write(self, step: int, state: Any, metadata: Optional[dict]) -> str:
        """``state`` and ``metadata`` into a fresh tmp directory; its path."""
        os.makedirs(self.directory, exist_ok=True)
        tmp = os.path.join(self.directory,
                           f"{int(step)}{_TMP}{os.getpid()}-{next(_tmp_ids)}")
        os.makedirs(tmp)
        try:
            with open(os.path.join(tmp, STATE_FILE), "wb") as f:
                torch.save(state, f)
                f.flush()
                os.fsync(f.fileno())
            if metadata is not None:
                with open(os.path.join(tmp, META_FILE), "w", encoding="utf-8") as f:
                    json.dump(metadata, f, indent=1, sort_keys=True)
                    f.flush()
                    os.fsync(f.fileno())
            _fsync(tmp)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        return tmp

    def _write_final(self, step: int, state: Any, metadata: Optional[dict]):
        """The retried write, the atomic rename and the rotation."""
        def attempt():
            io_hook("ckpt_save")          # chaos injection point (fail_io)
            return self._write(step, state, metadata)

        tmp = with_retry("ckpt_save", attempt, retry_kw=self.retry_kw)
        os.replace(tmp, self.step_dir(step))
        _fsync(self.directory)
        if self.keep_n is not None:
            for old in self.all_steps()[:-self.keep_n]:
                shutil.rmtree(self.step_dir(old), ignore_errors=True)

    def _writer(self, step: int, state: Any, metadata: Optional[dict], t0: float):
        try:
            self._write_final(step, state, metadata)
        except BaseException as exc:  # noqa: BLE001 - raised on the caller's thread
            self._error = exc
        finally:
            if self.last_save is not None:
                self.last_save["write_s"] = time.perf_counter() - t0

    def save(self, step: int, state: Any, metadata: Optional[dict] = None, *,
             wait: Optional[bool] = None):
        """Write ``state`` (a dict of tensors, nested dicts and plain values)
        and the JSON ``metadata`` as step ``step``, then rotate. An async
        manager returns once the host snapshot is taken; ``wait=True``
        drains before returning (the signal saves). A step that is already
        finalized, or in flight, raises ``FileExistsError``."""
        self.wait_until_finished()        # one write at a time; its error first
        final = self.step_dir(step)
        if os.path.exists(final):
            raise FileExistsError(f"checkpoint step {step} already exists in "
                                  f"{self.directory}")
        t0 = time.perf_counter()
        with span("ckpt/snapshot", step=step, asynchronous=self.async_save):
            if self.async_save:
                snap = self._snapshot.take(state)
                self.last_save = {"snapshot_s": time.perf_counter() - t0}
                self.in_flight_step = int(step)
                _inflight_delta(+1)
                self._thread = threading.Thread(
                    target=self._writer, args=(int(step), snap, metadata, t0),
                    name=f"ckpt-writer-{step}", daemon=True)
                self._thread.start()
            else:
                self._write_final(step, state, metadata)
                elapsed = time.perf_counter() - t0
                self.last_save = {"snapshot_s": elapsed, "write_s": elapsed}
        if wait if wait is not None else not self.async_save:
            self.wait_until_finished()

    def wait_until_finished(self):
        """Drain the write in flight (nothing when idle) and raise its error."""
        thread = self._thread
        if thread is not None:
            thread.join()
            self._thread = None
            self.in_flight_step = None
            _inflight_delta(-1)
        err, self._error = self._error, None
        if err is not None:
            raise err

    def preflight(self, step: int, state: Any, metadata: Optional[dict] = None):
        """Save before training, so a directory that cannot take a checkpoint
        fails now rather than at the first save: synchronous even on an
        async manager. A step already on disk (a resumed run) is written to
        a tmp directory and removed, testing the same writes without
        replacing a durable step. Also sweeps stale tmp directories a
        crashed predecessor left."""
        self.wait_until_finished()
        self.gc_stale_tmp()
        if os.path.exists(self.step_dir(step)):
            shutil.rmtree(self._write(step, state, metadata))
        else:
            self.save(step, state, metadata, wait=True)

    # -- reading -------------------------------------------------------------
    def _load(self, step: int, map_location, mmap: bool) -> Any:
        path = os.path.join(self.step_dir(step), STATE_FILE)
        if not os.path.isfile(path):      # gone for good: nothing to retry
            raise FileNotFoundError(f"no {STATE_FILE} in {self.step_dir(step)}")

        def attempt():
            io_hook("ckpt_restore")       # chaos injection point (fail_io)
            return torch.load(path, map_location=map_location, weights_only=True,
                              mmap=mmap)
        return with_retry("ckpt_restore", attempt, retry_kw=self.retry_kw)

    def restore(self, step: Optional[int] = None, map_location=None, mmap: bool = False,
                log=print) -> Tuple[Any, Optional[dict]]:
        """(state, metadata or None) of ``step``, or of the newest step that
        loads when ``step`` is None (see the module's "Fallback"). Drains a
        write in flight first. With ``mmap`` (and a CPU ``map_location``)
        the tensors are mapped from the file, not read: only those the
        caller touches cost I/O."""
        self.wait_until_finished()
        self.gc_stale_tmp(log=log)
        if step is not None:
            return self._load(step, map_location, mmap), self.load_metadata(step)
        steps = self.all_steps()[::-1]
        if not steps:
            raise FileNotFoundError(f"no checkpoint found in {self.directory}")
        bad: List[int] = []
        last_exc: Optional[BaseException] = None
        for s in steps:
            try:
                state = self._load(s, map_location, mmap)
            except RetryBudgetExceeded:
                # I/O that kept failing is the infrastructure's fault, not
                # evidence that this step is corrupt: falling back would
                # quarantine a healthy checkpoint
                raise
            except Exception as exc:  # noqa: BLE001 - a torn or corrupt file
                # raises whatever the unpickler or the zip reader raises; any
                # of them means this step is unusable
                last_exc = exc
                if not os.path.isdir(self.step_dir(s)):
                    # removed between listing and reading (a peer's rotation
                    # or quarantine): nothing on disk to quarantine
                    log(f"[ckpt] step {s} vanished during restore; falling back")
                    continue
                bad.append(s)
                counter_add("ckpt.restore_fallback_total", 1.0)
                record_event("ckpt_restore_fallback", step=int(s), error=repr(exc))
                log(f"[ckpt] restore of step {s} failed ({exc!r}); falling back "
                    "to the previous step")
                continue
            for b in bad:
                self._quarantine(b)
            return state, self.load_metadata(s)
        raise RuntimeError(f"every checkpoint in {self.directory} failed to restore "
                           f"(steps tried: {steps})") from last_exc

    def _quarantine(self, step: int):
        """Rename an unloadable step to ``<step>.corrupt``: its bytes kept, its
        number free for a later save."""
        bad = self.step_dir(step)
        try:
            os.replace(bad, bad + ".corrupt")
        except OSError:
            pass   # a peer renamed it first

    def load_metadata(self, step: Optional[int] = None) -> Optional[dict]:
        """The metadata of ``step`` (default the newest), None if absent.
        Drains a write in flight first."""
        self.wait_until_finished()
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        path = os.path.join(self.step_dir(step), META_FILE)
        if not os.path.isfile(path):
            return None

        def attempt():
            io_hook("ckpt_restore")
            with open(path, encoding="utf-8") as f:
                return json.load(f)
        return with_retry("ckpt_restore_meta", attempt, retry_kw=self.retry_kw)

    # -- housekeeping ----------------------------------------------------------
    def gc_stale_tmp(self, log=print) -> List[str]:
        """Remove interrupted ``*.tmp-*`` entries older than ``tmp_grace_s``;
        younger ones may be a live write. Returns the paths removed."""
        try:
            names = sorted(os.listdir(self.directory))
        except FileNotFoundError:
            return []
        now, reclaimed = time.time(), []
        for name in names:
            if _TMP not in name:
                continue
            path = os.path.join(self.directory, name)
            try:
                if now - _newest_mtime(path) < self.tmp_grace_s:
                    continue
            except OSError:
                continue   # finalized or swept by another process meanwhile
            if os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)
            else:
                try:
                    os.remove(path)
                except OSError:
                    pass
            if not os.path.exists(path):
                reclaimed.append(path)
        if reclaimed:
            counter_add("ckpt.tmp_reclaimed_total", float(len(reclaimed)))
            log(f"[ckpt] reclaimed {len(reclaimed)} stale checkpoint tmp entries: "
                + ", ".join(os.path.basename(r) for r in reclaimed))
        return reclaimed

    def close(self):
        """Drain the write in flight (raising its error). Idempotent; also
        run at the interpreter's exit."""
        if self._closed:
            return
        self._closed = True
        _LIVE.discard(self)
        self.wait_until_finished()


def load_model_checkpoint(ckpt_dir: str, expect_class: str, config_cls, init_fn,
                          device) -> Tuple[torch.nn.Module, dict]:
    """Rebuild a model from a checkpoint's embedded metadata: check
    ``model_class``, build ``init_fn(config_cls.from_dict(hparams))`` on
    ``device`` and load the newest step's weights. → (model, metadata).

    The file is mapped on the host, not read onto ``device``: a training
    checkpoint also holds the f32 masters and the optimizer's moments, and
    only the ``model`` tensors are copied to the card."""
    mgr = CheckpointManager(ckpt_dir)
    meta = mgr.load_metadata()
    if meta is None or meta.get("model_class") != expect_class:
        raise ValueError(f"{ckpt_dir} is not a {expect_class} checkpoint "
                         f"(model_class={meta and meta.get('model_class')})")
    model = init_fn(config_cls.from_dict(meta["hparams"]), seed=0, device=device)
    state, meta = mgr.restore(map_location="cpu", mmap=True)
    with torch.no_grad():
        model.load_state_dict(state["model"])
    return model.eval(), meta


def load_clip(ckpt_dir: str, device=None) -> Tuple[CLIP, dict]:
    """A port CLIP checkpoint (``model_class`` "CLIP", as ``train_clip``
    writes it) → (model in eval mode, metadata). The file is mapped on the
    host and only the ``model`` tensors are copied to ``device``."""
    return load_model_checkpoint(ckpt_dir, "CLIP", ClipConfig, init_clip,
                                 resolve_device(device))
