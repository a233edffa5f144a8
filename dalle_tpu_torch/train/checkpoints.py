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
  files). The failed steps are renamed ``<step>.corrupt`` only once some
  older step has loaded: if every step fails, nothing is renamed. A pinned
  ``step`` still raises.
* **Loading** is ``torch.load(..., weights_only=True)``: no pickled code runs.

Not ported yet, and waiting for the observability and chaos items of
``ROADMAP.md``: asynchronous saves, the retry policy around the I/O, the
chaos ``io_hook`` and the obs counters and events. Saves here are
synchronous, so ``close`` has nothing to drain.
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import time
from typing import Any, List, Optional, Tuple

import torch

from ..config import ClipConfig
from ..device import resolve_device
from ..models.clip import CLIP, init_clip
from ..obs.trace import span

STATE_FILE = "state.pt"
META_FILE = "metadata.json"
_TMP = ".tmp-"
_tmp_ids = itertools.count()


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


class CheckpointManager:
    """Steps of one run under ``directory``, created at the first save (a
    manager that only reads writes nothing)."""

    def __init__(self, directory: str, keep_n: Optional[int] = None,
                 tmp_grace_s: float = 600.0):
        if keep_n is not None and keep_n < 1:
            raise ValueError(f"keep_n must be >= 1 or None, got {keep_n}")
        self.directory = os.path.abspath(directory)
        self.keep_n = keep_n
        self.tmp_grace_s = float(tmp_grace_s)

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
        steps = self.all_steps()
        return steps[-1] if steps else None

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

    def save(self, step: int, state: Any, metadata: Optional[dict] = None):
        """Write ``state`` (a dict of tensors, nested dicts and plain values)
        and the JSON ``metadata`` as step ``step``, then rotate. A step that
        is already finalized raises ``FileExistsError``."""
        final = self.step_dir(step)
        if os.path.exists(final):
            raise FileExistsError(f"checkpoint step {step} already exists in "
                                  f"{self.directory}")
        with span("ckpt/snapshot", step=step, asynchronous=False):
            tmp = self._write(step, state, metadata)
            os.replace(tmp, final)
            _fsync(self.directory)
        if self.keep_n is not None:
            for old in self.all_steps()[:-self.keep_n]:
                shutil.rmtree(self.step_dir(old), ignore_errors=True)

    def preflight(self, step: int, state: Any, metadata: Optional[dict] = None):
        """Save before training, so a directory that cannot take a checkpoint
        fails now rather than at the first save. A step already on disk (a
        resumed run) is written to a tmp directory and removed, testing the
        same writes without replacing a durable step. Also sweeps stale tmp
        directories a crashed predecessor left."""
        self.gc_stale_tmp()
        if os.path.exists(self.step_dir(step)):
            shutil.rmtree(self._write(step, state, metadata))
        else:
            self.save(step, state, metadata)

    # -- reading -------------------------------------------------------------
    def _load(self, step: int, map_location, mmap: bool) -> Any:
        return torch.load(os.path.join(self.step_dir(step), STATE_FILE),
                          map_location=map_location, weights_only=True, mmap=mmap)

    def restore(self, step: Optional[int] = None, map_location=None, mmap: bool = False,
                log=print) -> Tuple[Any, Optional[dict]]:
        """(state, metadata or None) of ``step``, or of the newest step that
        loads when ``step`` is None (see the module's "Fallback"). With
        ``mmap`` (and a CPU ``map_location``) the tensors are mapped from the
        file, not read: only those the caller touches cost I/O."""
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
        """The metadata of ``step`` (default the newest), None if absent."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        path = os.path.join(self.step_dir(step), META_FILE)
        if not os.path.isfile(path):
            return None
        with open(path, encoding="utf-8") as f:
            return json.load(f)

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
            log(f"[ckpt] reclaimed {len(reclaimed)} stale checkpoint tmp entries: "
                + ", ".join(os.path.basename(r) for r in reclaimed))
        return reclaimed

    def close(self):
        """Saves are synchronous, so there is nothing to drain."""


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
