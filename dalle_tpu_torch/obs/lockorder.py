"""Observed lock-acquisition-order tracking.

Port of ``dalle_tpu/obs/lockorder.py``: records the lock-acquisition graph
one real process exhibits, so a smoke or test can assert it has no cycle.
The JAX package also holds its graph to the golden of
``contracts/sync.json``, whose lock sites are the JAX package's lines; the
port checks acyclicity only (``ROADMAP.md`` Queue 3).

Opt-in and process-wide: :func:`install` patches the
``threading.Lock``/``threading.RLock`` constructors so that locks created
afterwards from ``dalle_tpu_torch`` code are wrapped in a tracking proxy;
stdlib internals, third-party code and locks created before install get
the real primitive. A tracked lock is identified by its creation site
``(repo-relative path, line)``. ``threading.Condition(self._lock)`` needs
no special handling (the condition acquires the wrapped lock through the
normal protocol); a bare ``Condition()``'s internal ``RLock`` is
attributed to the ``dalle_tpu_torch`` line that built the condition.
:func:`uninstall` restores the real constructors, so later code (another
test file in the same worker) gets untouched primitives.

Overhead when installed is one dict insert per (src, dst) pair per lock
acquisition; when not installed, zero.
"""

from __future__ import annotations

import atexit
import dataclasses
import os
import sys
import threading
import _thread
from typing import Dict, List, Optional, Set, Tuple

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

Site = Tuple[str, int]          # (repo-relative path, creation line)


@dataclasses.dataclass(frozen=True)
class ObservedEdge:
    """dst acquired while src held, seen ``count`` times."""
    src: Site
    dst: Site
    count: int
    threads: Tuple[str, ...]    # thread names that exhibited the edge


class _State:
    def __init__(self):
        self.orig_lock = None
        self.orig_rlock = None
        self.root = REPO_ROOT
        self.assert_at_exit = False
        # (src_site, dst_site) -> [count, set(thread names)] — guarded by
        # a RAW lock (never tracked, tiny critical sections only)
        self.mu = _thread.allocate_lock()
        self.edges: Dict[Tuple[Site, Site], list] = {}
        self.sites: Dict[Site, str] = {}      # site -> kind (Lock | RLock)
        self.tls = threading.local()


_S: Optional[_State] = None


def _held_stack() -> list:
    stack = getattr(_S.tls, "held", None)
    if stack is None:
        stack = _S.tls.held = []
    return stack


class _TrackedLock:
    """Duck-typed Lock/RLock proxy recording acquisition order. Supports
    the full protocol Condition relies on (acquire/release/locked and, for
    RLock, ``_is_owned``/``_acquire_restore``/``_release_save``)."""

    __slots__ = ("_lock", "site")

    def __init__(self, real, site: Site):
        self._lock = real
        self.site = site

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._record_acquire()
        return got

    def _record_acquire(self) -> None:
        stack = _held_stack()
        if any(t is self for t in stack):
            stack.append(self)          # RLock re-entry: no ordering fact
            return
        if stack:
            tname = threading.current_thread().name
            with _S.mu:
                for held in stack:
                    if held.site == self.site:
                        continue
                    ent = _S.edges.setdefault((held.site, self.site),
                                              [0, set()])
                    ent[0] += 1
                    ent[1].add(tname)
        stack.append(self)

    def release(self) -> None:
        self._lock.release()
        stack = _held_stack()
        for i in range(len(stack) - 1, -1, -1):   # out-of-order safe
            if stack[i] is self:
                del stack[i]
                break

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # Condition's RLock protocol
    def _is_owned(self):
        if hasattr(self._lock, "_is_owned"):
            return self._lock._is_owned()
        # plain Lock fallback mirroring threading.Condition's own trick
        if self._lock.acquire(False):
            self._lock.release()
            return False
        return True

    def _acquire_restore(self, state):
        if hasattr(self._lock, "_acquire_restore"):
            self._lock._acquire_restore(state)
        else:
            self._lock.acquire()
        self._record_acquire()

    def _release_save(self):
        stack = _held_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break
        if hasattr(self._lock, "_release_save"):
            return self._lock._release_save()
        self._lock.release()
        return None

    def __repr__(self):
        return f"<TrackedLock {self.site[0]}:{self.site[1]} {self._lock!r}>"


def _creation_site() -> Optional[Site]:
    """(relpath, line) of the first non-stdlib caller frame when it is
    dalle_tpu_torch code, else None. Skipping only ``threading.py`` means a
    ``Condition()``'s internal RLock lands on the dalle_tpu_torch line that
    built the condition, while e.g. ``queue.Queue``'s internal lock (first
    non-threading frame: ``queue.py``) stays untracked — the static model
    has a node for the former and not the latter."""
    frame = sys._getframe(2)
    skipped = 0
    while frame is not None \
            and frame.f_code.co_filename == threading.__file__:
        # allow exactly ONE threading __init__ frame: a bare Condition()'s
        # internal RLock belongs to the dalle_tpu_torch line that built the
        # condition (one frame: Condition.__init__). Deeper chains are
        # Thread/Event machinery (Thread.__init__ -> Event.__init__ ->
        # Condition.__init__) whose locks the static model has no node
        # for — leave those untracked.
        if skipped >= 1 or frame.f_code.co_name != "__init__":
            return None
        skipped += 1
        frame = frame.f_back
    if frame is None:
        return None
    fn = os.path.abspath(frame.f_code.co_filename)
    try:
        rel = os.path.relpath(fn, _S.root).replace(os.sep, "/")
    except ValueError:            # different drive (windows)
        return None
    if not rel.startswith("dalle_tpu_torch/"):
        return None
    return (rel, frame.f_lineno)


def _make_factory(kind: str):
    def factory():
        real = (_S.orig_lock if kind == "Lock" else _S.orig_rlock)()
        site = _creation_site()
        if site is None:
            return real
        with _S.mu:
            _S.sites.setdefault(site, kind)
        return _TrackedLock(real, site)
    factory.__name__ = kind
    return factory


def install(repo_root: str = REPO_ROOT, assert_at_exit: bool = False) -> None:
    """Start tracking. Locks created from dalle_tpu_torch code AFTER this call
    are instrumented; with ``assert_at_exit`` an atexit hook raises if the
    observed graph ended up cyclic (belt-and-braces — callers that care
    about exit codes should call :func:`cycles` explicitly)."""
    global _S
    if _S is not None:
        return
    _S = _State()
    _S.root = repo_root
    _S.orig_lock = threading.Lock
    _S.orig_rlock = threading.RLock
    threading.Lock = _make_factory("Lock")
    threading.RLock = _make_factory("RLock")
    if assert_at_exit:
        _S.assert_at_exit = True
        atexit.register(_exit_check)


def uninstall() -> None:
    """Restore the real constructors. Already-tracked locks keep working
    (they hold real primitives); they just stop creating new ones."""
    global _S
    if _S is None:
        return
    threading.Lock = _S.orig_lock
    threading.RLock = _S.orig_rlock
    _S = None


def installed() -> bool:
    return _S is not None


def reset() -> None:
    """Drop recorded edges/sites (the instrumentation stays installed)."""
    if _S is not None:
        with _S.mu:
            _S.edges.clear()
            _S.sites.clear()


def observed_edges() -> List[ObservedEdge]:
    if _S is None:
        return []
    with _S.mu:
        items = [(k, (v[0], tuple(sorted(v[1])))) for k, v in
                 _S.edges.items()]
    return sorted((ObservedEdge(src, dst, n, names)
                   for (src, dst), (n, names) in items),
                  key=lambda e: (e.src, e.dst))


def observed_sites() -> Dict[Site, str]:
    if _S is None:
        return {}
    with _S.mu:
        return dict(_S.sites)


def cycles() -> List[List[ObservedEdge]]:
    """Elementary cycles in the observed graph (empty == acyclic)."""
    edges = observed_edges()
    adj: Dict[Site, List[ObservedEdge]] = {}
    for e in edges:
        adj.setdefault(e.src, []).append(e)
    out: List[List[ObservedEdge]] = []
    seen: Set[frozenset] = set()

    def dfs(start: Site, node: Site, path: List[ObservedEdge],
            on_path: Set[Site]) -> None:
        for e in adj.get(node, []):
            if e.dst == start:
                key = frozenset(x.src for x in path + [e])
                if key not in seen:
                    seen.add(key)
                    out.append(path + [e])
            elif e.dst not in on_path and e.dst > start:
                on_path.add(e.dst)
                dfs(start, e.dst, path + [e], on_path)
                on_path.discard(e.dst)

    for start in sorted(adj):
        dfs(start, start, [], {start})
    return out


def format_edge(e: ObservedEdge) -> str:
    return (f"{e.src[0]}:{e.src[1]} -> {e.dst[0]}:{e.dst[1]} "
            f"(x{e.count}, threads: {', '.join(e.threads)})")


def _exit_check() -> None:
    cyc = cycles()
    if cyc:
        lines = ["lockorder: observed acquisition graph is CYCLIC:"]
        for c in cyc:
            lines.extend("  " + format_edge(e) for e in c)
        raise RuntimeError("\n".join(lines))
