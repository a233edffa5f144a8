"""Tar-shard streaming: the WebDataset chain without the wds package.

Port of ``dalle_tpu/data/webdataset.py``: shard lists (a list, a brace
range ``shard-{000..009}.tar``, a glob, a directory or a ``pipe:``
command), samples grouped by key, decoding, ``map`` / ``select`` /
``map_dict`` / ``to_tuple`` / ``shuffle`` / ``batched`` stages, a
prefetch thread, ``write_shards``, and the handlers ``warn_and_continue``
and ``reraise``. Shards are split per process by ``torch.distributed``'s
rank and world size when a group is initialised (one process otherwise).
Images decode through the port's codec (``data/image_codec.py``), whose
``ctypes`` calls release the GIL, so ``decode(workers=N)`` decodes in
parallel threads.

``warn_and_continue`` skips a sample that fails, as the reference's does,
except an ``UnsupportedImage``: the JAX package's PIL decodes that file,
so skipping it would train on another sample set. It raises.
"""

from __future__ import annotations

import glob as _glob
import io
import itertools
import json
import queue
import random
import subprocess
import sys
import tarfile
import threading
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from ..obs.trace import span
from .image_codec import UnsupportedImage, decode, resize_bilinear

IMAGE_EXTS = ("jpg", "jpeg", "png", "bmp", "webp")


def expand_shards(urls) -> List[str]:
    """Shard-list sources: a list, a brace-range pattern ``shard-{000..009}.tar``, a glob, a directory, or a
    ``pipe:`` command. Returns concrete shard URLs in order."""
    if isinstance(urls, (list, tuple)):
        out: List[str] = []
        for u in urls:
            out.extend(expand_shards(u))
        return out
    url = str(urls)
    if url.startswith("pipe:"):
        return [url]
    if "{" in url and ".." in url:
        head, rest = url.split("{", 1)
        rng, tail = rest.split("}", 1)
        lo, hi = rng.split("..")
        width = len(lo)
        return [f"{head}{i:0{width}d}{tail}" for i in range(int(lo), int(hi) + 1)]
    import os
    if os.path.isdir(url):
        return sorted(_glob.glob(os.path.join(url, "*.tar")))
    if any(ch in url for ch in "*?["):
        return sorted(_glob.glob(url))
    return [url]


def _rank_and_world():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def split_shards_per_host(shards: Sequence[str],
                          process_index: Optional[int] = None,
                          process_count: Optional[int] = None) -> List[str]:
    """Round-robin shard assignment per process: each streams a disjoint
    subset (wds' ``split_by_node``). The defaults are
    ``torch.distributed``'s rank and world size, or 0 and 1 without a
    process group."""
    rank, world = _rank_and_world()
    pi = rank if process_index is None else process_index
    pc = world if process_count is None else process_count
    return [s for i, s in enumerate(shards) if i % pc == pi]


def _open_shard(url: str):
    """Local path → (file, None); ``pipe:CMD`` → (the command's stdout, proc)
    so the child can be reaped."""
    if url.startswith("pipe:"):
        proc = subprocess.Popen(url[5:], shell=True, stdout=subprocess.PIPE)
        return proc.stdout, proc
    return open(url, "rb"), None


def iter_tar_samples(url: str, handler: Callable[[Exception], bool]
                     ) -> Iterator[Dict[str, bytes]]:
    """Stream one tar shard, grouping members into samples by key (the path up
    to the first dot, wds convention). Yields ``{"__key__": str, ext: bytes}``."""
    proc = None
    try:
        with span("data/shard_open", url=url):
            stream, proc = _open_shard(url)
            tf = tarfile.open(fileobj=stream, mode="r|*")
    except Exception as e:              # noqa: BLE001 - shard-level skip
        if handler(e):
            return
        raise
    current: Dict[str, bytes] = {}
    key = None
    try:
        for member in tf:
            if not member.isfile():
                continue
            dirpart, _, fname = member.name.removeprefix("./").rpartition("/")
            base, _, ext = fname.partition(".")
            if dirpart:
                base = dirpart + "/" + base
            if key is not None and base != key:
                yield current
                current = {}
            key = base
            current["__key__"] = key
            current[ext.lower()] = tf.extractfile(member).read()
        if current:
            yield current
    except Exception as e:              # noqa: BLE001 - mid-shard corruption
        if not handler(e):
            raise
    finally:
        tf.close()
        stream.close()
        if proc is not None:
            proc.wait()   # reap: no zombie per pipe: shard


def warn_and_continue(e: Exception) -> bool:
    """The wds handler the reference uses: warn and skip the sample, except
    an ``UnsupportedImage``, which is raised (see the module)."""
    if isinstance(e, UnsupportedImage):
        return False
    print(f"[webdataset] skipping after error: {e!r}", file=sys.stderr)
    return True


def reraise(e: Exception) -> bool:
    return False


@span("data/decode")
def decode_sample(sample: Dict[str, bytes], image_size: Optional[int] = None
                  ) -> Dict[str, object]:
    """bytes → python values by extension: images → float32 [0,1] HWC numpy,
    txt → str, json → object, cls → int."""
    out: Dict[str, object] = {}
    for k, v in sample.items():
        if k == "__key__":
            out[k] = v
        elif k in IMAGE_EXTS:
            img = decode(v, f"{sample.get('__key__', '?')}.{k}")
            if image_size is not None:
                img = resize_bilinear(img, (image_size, image_size))
            out[k] = np.asarray(img, np.float32) / 255.0
        elif k in ("txt", "text", "caption"):
            out[k] = v.decode("utf-8")
        elif k == "json":
            out[k] = json.loads(v)
        elif k == "cls":
            out[k] = int(v)
        else:
            out[k] = v
    return out


class WebDataset:
    """Composable shard pipeline: shards → samples → decode → map/filter →
    shuffle buffer → batches, with per-process shard splitting and a
    prefetch thread."""

    def __init__(self, urls, *, handler: Callable = warn_and_continue,
                 shuffle_shards: bool = False, split_by_host: bool = True,
                 seed: int = 0, repeat=False):
        """``repeat``: False = one pass, True = loop forever, an int = that
        many epochs over the shard list."""
        self.shards = expand_shards(urls)
        if split_by_host:
            self.shards = split_shards_per_host(self.shards)
        self.handler = handler
        self.shuffle_shards = shuffle_shards
        self.seed = seed
        self.repeat = repeat
        self._ops: List = []

    # -- chainable stages (each returns self) ------------------------------
    def decode(self, image_size: Optional[int] = None, workers: int = 0):
        """``workers > 0`` decodes on a thread pool (the codec's ``ctypes``
        calls and torch's resize release the GIL)."""
        return self.map(lambda s: decode_sample(s, image_size),
                        workers=workers)

    def map(self, fn: Callable, workers: int = 0):
        if workers > 0:
            self._ops.append(("pmap", (fn, workers)))
        else:
            self._ops.append(("map", fn))
        return self

    def select(self, pred: Callable):
        self._ops.append(("filter", pred))
        return self

    def map_dict(self, **fns):
        def apply(s):
            for k, fn in fns.items():
                if k in s:
                    s[k] = fn(s[k])
            return s
        return self.map(apply)

    def to_tuple(self, *keys):
        self._ops.append(("map", lambda s: tuple(s[k] for k in keys)))
        return self

    def shuffle(self, buffer_size: int):
        self._ops.append(("shuffle", buffer_size))
        return self

    def batched(self, batch_size: int, partial: bool = False):
        self._ops.append(("batch", (batch_size, partial)))
        return self

    # -- iteration ---------------------------------------------------------
    def _raw(self) -> Iterator:
        if not self.shards:
            raise ValueError("shard list is empty — check the url/glob "
                             "(and per-host splitting with few shards)")
        epoch = 0
        while True:
            shards = list(self.shards)
            if self.shuffle_shards:
                random.Random(self.seed + epoch).shuffle(shards)
            for url in shards:
                yield from iter_tar_samples(url, self.handler)
            epoch += 1
            if self.repeat is True:
                continue
            if not self.repeat or epoch >= int(self.repeat):
                return

    def __iter__(self) -> Iterator:
        it: Iterator = self._raw()
        rng = random.Random(self.seed)
        for kind, arg in self._ops:
            if kind == "map":
                it = _safe_map(it, arg, self.handler)
            elif kind == "pmap":
                it = _parallel_map(it, arg[0], arg[1], self.handler)
            elif kind == "filter":
                it = filter(arg, it)   # not a genexp: binds arg now, not lazily
            elif kind == "shuffle":
                it = _buffer_shuffle(it, arg, rng)
            elif kind == "batch":
                it = _batch(it, *arg)
        return it

    def prefetch(self, max_queue: int = 8) -> Iterator:
        """Run the pipeline on a daemon thread; consumer pulls from a bounded
        queue — decode/IO overlaps device step time."""
        return _Prefetcher(self, max_queue)


def _parallel_map(it, fn, workers: int, handler):
    """Order-preserving thread-pool map with a bounded in-flight window: a
    sliding queue of futures so decode overlaps both IO and the consumer."""
    import collections
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=workers) as pool:
        window: collections.deque = collections.deque()
        for s in it:
            window.append(pool.submit(fn, s))
            if len(window) >= workers * 2:
                yield from _drain_one(window, handler)
        while window:
            yield from _drain_one(window, handler)


def _drain_one(window, handler):
    try:
        yield window.popleft().result()
    except Exception as e:              # noqa: BLE001 - sample-level skip
        if not handler(e):
            raise


def _safe_map(it, fn, handler):
    for s in it:
        try:
            yield fn(s)
        except Exception as e:          # noqa: BLE001 - sample-level skip
            if not handler(e):
                raise


def _buffer_shuffle(it, size: int, rng: random.Random):
    buf: List = []
    for s in it:
        buf.append(s)
        if len(buf) >= size:
            i = rng.randrange(len(buf))
            buf[i], buf[-1] = buf[-1], buf[i]
            yield buf.pop()
    rng.shuffle(buf)
    yield from buf


def _collate(batch: List):
    if isinstance(batch[0], tuple):
        return tuple(_collate([b[i] for b in batch])
                     for i in range(len(batch[0])))
    if isinstance(batch[0], np.ndarray):
        return np.stack(batch)
    if isinstance(batch[0], (int, float)):
        return np.asarray(batch)
    return batch


def _batch(it, batch_size: int, partial: bool):
    buf: List = []
    for s in it:
        buf.append(s)
        if len(buf) == batch_size:
            yield _collate(buf)
            buf = []
    if buf and partial:
        yield _collate(buf)


class _Prefetcher:
    _DONE = object()

    def __init__(self, ds: Iterable, max_queue: int):
        self.q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self.error: Optional[BaseException] = None
        self._stop = False

        def run():
            try:
                for item in ds:
                    while not self._stop:  # bounded put so close() can unblock
                        try:
                            self.q.put(item, timeout=0.5)
                            break
                        except queue.Full:
                            continue
                    if self._stop:
                        return
            except BaseException as e:  # noqa: BLE001 - surfaced to consumer
                self.error = e
            finally:
                # bounded: a close()d consumer will never drain the queue, so
                # an unconditional put could block this thread forever
                while not self._stop:
                    try:
                        self.q.put(self._DONE, timeout=0.5)
                        break
                    except queue.Full:
                        continue

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def close(self):
        """Release the producer thread (and its open shard/pipe handles) when
        the consumer stops early, e.g. fit(steps=N) mid-stream."""
        self._stop = True
        try:
            while True:
                self.q.get_nowait()
        except Exception:   # noqa: BLE001 - queue.Empty, but broad because
            pass            # __del__ may run at interpreter shutdown when
                            # the queue module is already torn down

    def __del__(self):
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        # a long span here = the prefetch thread can't keep up (decode/IO
        # bound); near-zero = the queue is full and the consumer is the
        # bottleneck — the per-thread trace rows make the overlap visible
        with span("data/prefetch_wait"):
            item = self.q.get()
        if item is self._DONE:
            if self.error is not None:
                raise self.error
            raise StopIteration
        return item


def write_shards(samples: Iterable[Dict[str, bytes]], pattern: str,
                 samples_per_shard: int = 1000) -> List[str]:
    """Pack ``{"__key__", ext: bytes}`` samples into tar shards, the
    writer's counterpart of the reader."""
    paths: List[str] = []
    it = iter(samples)
    for shard_idx in itertools.count():
        chunk = list(itertools.islice(it, samples_per_shard))
        if not chunk:
            break
        path = pattern.format(shard_idx)
        with tarfile.open(path, "w") as tf:
            for s in chunk:
                key = s["__key__"]
                for ext, data in s.items():
                    if ext == "__key__":
                        continue
                    if isinstance(data, str):
                        data = data.encode("utf-8")
                    info = tarfile.TarInfo(f"{key}.{ext}")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
        paths.append(path)
    return paths
