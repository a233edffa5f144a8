"""Device prefetch: the next batches already on the card while a step runs.

Port of ``dalle_tpu/data/device_prefetch.py``. ``DevicePrefetcher`` keeps
``depth`` items ahead of the consumer with ``put`` applied (a trainer's
``_put_batch``: host arrays through pinned memory, without blocking). On a
card the puts run on a side stream, so their copies overlap the kernels of
the step in flight; ``__next__`` makes the consumer's stream wait for the
item's copies (an event recorded after its put) and records that stream on
each of its tensors, so the caching allocator does not hand their memory
out again while the step still reads it. An item that already holds a CUDA
tensor (a batch the source built on the card) is put on the consumer's
stream: it has nothing to upload, and the side stream would read it before
the kernels that write it.

Semantics (the JAX package's, held in ``tests/test_torch_train_loop.py``):
batches come out in the source's order; buffered batches drain before
``StopIteration``; an error from the source or from ``put`` is raised only
after the good batches ahead of it. On the CPU ``put`` is the plain
conversion. The source is pulled on the consumer's thread: a slow source
still blocks ``__next__`` during the refill. Each put is a ``data/h2d``
span, and ``last_put_s`` is the host seconds the consumed item's put took
(the step breakdown's ``t_h2d_s``).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Iterable, Iterator, List, Optional

import torch

from ..obs.trace import span


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


class DevicePrefetcher:
    """An iterator over ``put(item)`` for each item of ``source``, ``depth``
    puts ahead. ``device`` is where the puts land (a side stream is used
    there when it is a card)."""

    def __init__(self, source: Iterable, put: Callable, depth: int = 2, device=None):
        self._it = iter(source)
        self._put = put
        self.depth = max(int(depth), 1)
        device = torch.device(device) if device is not None else torch.device("cpu")
        self._stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._buf: deque = deque()   # (put(item), its copies' event or None, put seconds)
        self._err: Optional[Exception] = None
        self._done = False
        self.last_put_s = 0.0

    def _put_one(self, item):
        t0 = time.perf_counter()
        with span("data/h2d"):
            if self._stream is None or any(t.is_cuda for t in _tensors(item)):
                placed, event = self._put(item), None
            else:
                with torch.cuda.stream(self._stream):
                    placed = self._put(item)
                    event = torch.cuda.Event()
                    event.record(self._stream)
        return placed, event, time.perf_counter() - t0

    def _fill(self):
        while not self._done and self._err is None and len(self._buf) < self.depth:
            try:
                item = next(self._it)
            except StopIteration:
                self._done = True
                return
            except Exception as e:  # noqa: BLE001 - held, raised in order
                self._err = e
                return
            try:
                self._buf.append(self._put_one(item))
            except Exception as e:  # noqa: BLE001 - held, raised in order
                self._err = e
                return

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        self._fill()
        if not self._buf:
            if self._err is not None:
                err, self._err = self._err, None
                self._done = True
                raise err
            raise StopIteration
        item, event, self.last_put_s = self._buf.popleft()
        if event is not None:
            consumer = torch.cuda.current_stream(self._stream.device)
            consumer.wait_event(event)
            for t in _tensors(item):
                if t.is_cuda:
                    t.record_stream(consumer)
        return item
