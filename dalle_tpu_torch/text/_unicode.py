"""The word splitter of the BPE tokenizer, without the ``regex`` package.

The JAX package splits cleaned text with ``regex`` (``dalle_tpu/text/bpe.py``
``WORD_PAT``)::

    <\\|startoftext\\|>|<\\|endoftext\\|>|'s|'t|'re|'ve|'m|'ll|'d
    |[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+          (IGNORECASE)

``findall`` gives ``WORD_PAT.findall``'s answer with a hand-written scanner:
at each position it tries the alternatives in that order (a special token,
a contraction, a run of letters, one digit, a run of anything that is not
whitespace, letter or digit) and otherwise skips the character. The classes
are range tables that ``_gen_unicode.py`` generated from ``regex`` itself
(``_unicode_tables.py``), looked up by bisection; ``unicodedata`` would
disagree with ``regex`` on thousands of code points. Case-insensitive
literals compare through the table's ``FOLD`` (``'ſ`` matches ``'s``).
"""

from __future__ import annotations

from bisect import bisect_right
from typing import List, Sequence

from ._unicode_tables import FOLD, LETTER, NUMBER, OTHER, SPACE

SPECIALS = ("<|startoftext|>", "<|endoftext|>")
CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _member(table: Sequence[int], ch: str) -> bool:
    return bisect_right(table, ord(ch)) & 1 == 1


def _literal_at(text: str, i: int, lit: str) -> bool:
    """``lit`` (lower-case ASCII letters and punctuation) at ``text[i:]``,
    case-insensitively as ``regex`` compares."""
    if i + len(lit) > len(text):
        return False
    return all(ch == want or FOLD.get(ord(ch)) == want
               for ch, want in zip(text[i:i + len(lit)], lit))


def _run(text: str, i: int, table: Sequence[int]) -> int:
    """The end of the run of ``table``'s characters that starts at ``i``."""
    n = len(text)
    while i < n and _member(table, text[i]):
        i += 1
    return i


def findall(text: str) -> List[str]:
    """``WORD_PAT.findall(text)``."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        lits = SPECIALS if ch == "<" else CONTRACTIONS if ch == "'" else ()
        lit = next((s for s in lits if _literal_at(text, i, s)), None)
        if lit is not None:
            out.append(text[i:i + len(lit)])
            i += len(lit)
            continue
        if _member(LETTER, ch):
            j = _run(text, i, LETTER)
        elif _member(NUMBER, ch):
            j = i + 1
        elif _member(OTHER, ch):
            j = _run(text, i, OTHER)
        else:   # whitespace, or a code point no alternative takes (U+0345)
            i += 1
            continue
        out.append(text[i:j])
        i = j
    return out


def collapse_space(text: str) -> str:
    """``regex.sub(r"\\s+", " ", text)``."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        if _member(SPACE, text[i]):
            i = _run(text, i, SPACE)
            out.append(" ")
        else:
            out.append(text[i])
            i += 1
    return "".join(out)
