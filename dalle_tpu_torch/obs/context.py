"""The trace context: one identity per request, across every hop.

A copy of ``dalle_tpu/obs/context.py`` (it imports no JAX). A ``trace_id``
is minted once at the system's edge (``RequestQueue.submit`` for in-process
producers) and carried by value on the ``Request`` through queue →
scheduler → engine slot, and by a thread-local ambient context
(``trace_context``) on the threads that handle it, so every span recorded
for the request carries the same id.
"""

from __future__ import annotations

import contextlib
import threading
import uuid
from typing import Iterator, Optional

_LOCAL = threading.local()


def new_trace_id() -> str:
    """A fresh trace id: 16 hex characters, unique per request, short
    enough to grep and to echo in an HTTP header."""
    return uuid.uuid4().hex[:16]


def current_trace_id() -> Optional[str]:
    """The trace id bound to this thread (None outside any
    ``trace_context``). Spans recorded while one is bound carry it."""
    return getattr(_LOCAL, "trace_id", None)


@contextlib.contextmanager
def trace_context(trace_id: Optional[str]) -> Iterator[Optional[str]]:
    """Bind ``trace_id`` as this thread's trace context for the block
    (nestable; the previous binding comes back on exit, exceptions
    included). Binding None clears it."""
    prev = getattr(_LOCAL, "trace_id", None)
    _LOCAL.trace_id = trace_id
    try:
        yield trace_id
    finally:
        _LOCAL.trace_id = prev
