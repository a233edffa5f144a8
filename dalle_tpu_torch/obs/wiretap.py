"""Observed wire-frame recording, checked against the protocol contract.

Port of ``dalle_tpu/obs/wiretap.py``. :func:`install` sets the frame tap
of ``fleet/transport.py`` (:func:`~..fleet.transport.set_frame_tap`);
every validated frame this process sends or receives is then folded into a
set of observed shapes ``(verb, direction, kind, frozenset(fields))``. A
frame carrying ``"verb"`` is a request of that verb, one carrying
``"kind"`` a stream event of that kind, anything else a reply.
:func:`conformance` checks every observed shape against a golden contract,
the repo's ``contracts/wire.json`` (:func:`golden`): the port speaks the
JAX package's protocol, so it meets the same golden. Replies and stream
events are matched to any golden channel of their direction (the tap sees
one frame, not the connection's verb). Overhead when installed is one
set-insert per frame under a lock; when not, one module-global check. For
smokes and tests.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Dict, FrozenSet, List, Optional, Tuple

from ..fleet import transport

CONTRACT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "contracts", "wire.json")

Shape = Tuple[Optional[str], str, Optional[str], FrozenSet[str]]

_lock = threading.Lock()
_observed: "set[Shape]" = set()
_installed = False


def _classify(direction: str, obj: dict) -> Shape:
    fields = frozenset(k for k in obj if isinstance(k, str))
    verb = obj.get("verb")
    if isinstance(verb, str):
        return (verb, "request", None, fields)
    kind = obj.get("kind")
    if isinstance(kind, str):
        return (None, "stream", kind, fields)
    return (None, "reply", None, fields)


def _tap(direction: str, obj: dict) -> None:
    shape = _classify(direction, obj)
    with _lock:
        _observed.add(shape)


def golden(path: str = CONTRACT) -> dict:
    """The protocol contract (``contracts/wire.json``), read as data."""
    with open(path) as fh:
        return json.load(fh)


def install() -> None:
    """Start recording."""
    global _installed
    if _installed:
        return
    transport.set_frame_tap(_tap)
    _installed = True


def uninstall() -> None:
    global _installed
    if not _installed:
        return
    transport.set_frame_tap(None)
    _installed = False


def installed() -> bool:
    return _installed


def reset() -> None:
    """Drop recorded shapes (the tap stays installed)."""
    with _lock:
        _observed.clear()


def observed() -> List[Shape]:
    with _lock:
        return sorted(_observed, key=lambda s: (str(s[0]), s[1],
                                                str(s[2]), sorted(s[3])))


@dataclasses.dataclass(frozen=True)
class Violation:
    shape: Shape
    why: str

    def __str__(self) -> str:
        verb, direction, kind, fields = self.shape
        name = verb or "?"
        chan = f"{name}.{direction}" + (f".{kind}" if kind else "")
        return f"{chan} {{{', '.join(sorted(fields))}}}: {self.why}"


def _golden_channels(golden: dict):
    """(verb, direction, kind) -> sender entry of the golden contract.
    The sse pseudo-verb is excluded: SSE bytes go over HTTP, never through
    the transport tap, and its dynamic ``*`` sender would otherwise
    wildcard-cover any unaccounted stream frame."""
    out: Dict[Tuple[str, str, Optional[str]], dict] = {}
    for verb, dirs in golden.get("verbs", {}).items():
        if verb == "sse":
            continue
        for direction, entry in dirs.items():
            if direction == "stream":
                for kind, sub in entry.items():
                    out[(verb, "stream", kind)] = sub["sender"]
            else:
                out[(verb, direction, None)] = entry["sender"]
    return out


def _covers(sender: dict, fields: FrozenSet[str]) -> bool:
    return sender.get("dynamic") or fields <= set(sender.get("fields", ()))


def conformance(golden: dict) -> List[Violation]:
    """Every observed frame shape must be ⊆ some golden sender schema
    (dynamic golden senders cover any field set). Empty == conformant."""
    chans = _golden_channels(golden)
    out: List[Violation] = []
    for shape in observed():
        verb, direction, kind, fields = shape
        if direction == "request":
            sender = chans.get((verb, "request", None))
            if sender is None:
                out.append(Violation(shape,
                                     "verb not in the golden contract"))
            elif not _covers(sender, fields):
                extra = fields - set(sender.get("fields", ()))
                out.append(Violation(
                    shape, "request fields not in the golden sender "
                    f"schema: {', '.join(sorted(extra))}"))
        elif direction == "stream":
            matches = [s for (v, d, k), s in chans.items()
                       if d == "stream" and k in (kind, "*")]
            if not matches:
                out.append(Violation(
                    shape, f"stream kind '{kind}' not in the golden "
                    "contract"))
            elif not any(_covers(s, fields) for s in matches):
                out.append(Violation(
                    shape, "stream fields not covered by any golden "
                    f"'{kind}' sender schema"))
        else:
            matches = [s for (v, d, k), s in chans.items() if d == "reply"]
            if not any(_covers(s, fields) for s in matches):
                out.append(Violation(
                    shape, "reply fields not covered by any golden reply "
                    "schema"))
    return out
