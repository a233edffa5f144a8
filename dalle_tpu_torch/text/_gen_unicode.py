"""Generate ``_unicode_tables.py``: the character classes of the word pattern
of ``text/bpe.py`` as the ``regex`` package defines them.

The JAX package splits text with ``regex`` (``\\p{L}``, ``\\p{N}``, ``\\s``,
case-insensitive). Python's ``unicodedata`` carries an older Unicode
database than ``regex`` does, and ``str.isspace`` counts U+001C–U+001F
where ``\\s`` does not, so the port cannot derive the classes at run time
without ``regex``. This script asks ``regex`` itself, on every code point,
and writes the answers as sorted half-open range tables:

    python -m dalle_tpu_torch.text._gen_unicode

Run it where ``regex`` is installed; the port itself never imports it.
"""

from __future__ import annotations

import importlib
import sys
from pathlib import Path
from typing import Dict, List

OUT = Path(__file__).with_name("_unicode_tables.py")

# each class exactly as WORD_PAT (IGNORECASE) spells it
CLASSES = {
    "LETTER": r"[\p{L}]+",
    "NUMBER": r"[\p{N}]+",
    "SPACE": r"\s+",
    "OTHER": r"[^\s\p{L}\p{N}]+",
}


def class_ranges(regex, pattern: str) -> List[int]:
    """Flat half-open ranges [a0, z0, a1, z1, ...] of the code points that
    ``pattern`` matches, case-insensitively, over all 0x110000 of them."""
    everything = "".join(map(chr, range(0x110000)))
    flat: List[int] = []
    for m in regex.compile(pattern, regex.IGNORECASE).finditer(everything):
        flat += [m.start(), m.end()]
    return flat


def ascii_folds(regex) -> Dict[int, str]:
    """Every code point other than a lower-case ASCII letter that matches
    one case-insensitively, mapped to that letter."""
    everything = "".join(map(chr, range(0x110000)))
    out = {}
    for letter in "abcdefghijklmnopqrstuvwxyz":
        pat = regex.compile(letter, regex.IGNORECASE)
        out.update({m.start(): letter for m in pat.finditer(everything)
                    if m.group() != letter})
    return dict(sorted(out.items()))


def _table(name: str, flat: List[int]) -> str:
    body = ",\n".join("    " + ", ".join(f"0x{v:X}" for v in flat[i:i + 8])
                      for i in range(0, len(flat), 8))
    return f"{name} = (\n{body},\n)\n"


def render(regex) -> str:
    lines = [
        '"""Generated by ``python -m dalle_tpu_torch.text._gen_unicode`` from',
        f"``regex`` {regex.__version__}; do not edit.",
        "",
        "Each class is a flat tuple of half-open code-point ranges",
        "(a0, z0, a1, z1, ...), sorted; c is in the class when",
        "``bisect_right(table, c)`` is odd. ``FOLD`` maps every code point that",
        "matches a lower-case ASCII letter case-insensitively to that letter.",
        '"""',
        "",
        f"REGEX_VERSION = {regex.__version__!r}",
        "",
    ]
    for name, pattern in CLASSES.items():
        lines.append(f"# {pattern}")
        lines.append(_table(name, class_ranges(regex, pattern)))
    folds = ", ".join(f"0x{cp:X}: {c!r}" for cp, c in ascii_folds(regex).items())
    lines.append(f"FOLD = {{{folds}}}\n")
    return "\n".join(lines)


def main() -> int:
    # the one module that reads ``regex``, at generation time only: nothing
    # of the package imports this file
    regex = importlib.import_module("regex")
    OUT.write_text(render(regex), encoding="utf-8")
    print(f"wrote {OUT} from regex {regex.__version__}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
