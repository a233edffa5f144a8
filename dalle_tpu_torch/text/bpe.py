"""Byte-level BPE: vocabulary, encoding, and merge training.

A copy of ``dalle_tpu/text/bpe.py`` (OpenAI-CLIP-style byte BPE with a
merges file, a '</w>' word suffix, the GPT-2 reversible byte table) that
needs no ``regex`` package: words are split by the scanner of
``_unicode.py``, whose range tables were generated from ``regex``, so the
ids equal the JAX package's.

The merge loop of a word runs in the native C++ core (``native/``) by
default. ``core="python"`` runs the plain Python loop instead; it is the
native core's oracle in the tests. Unlike the JAX package, a core that
fails to build or load raises: nothing falls back quietly.
"""

from __future__ import annotations

import functools
import gzip
import html
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from . import _unicode

SOT, EOT = "<|startoftext|>", "<|endoftext|>"
CORES = ("native", "python")


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte → printable unicode char map (GPT-2's public scheme:
    keep printable latin ranges, remap the rest above U+0100)."""
    bs = (list(range(ord("!"), ord("~") + 1)) +
          list(range(ord("¡"), ord("¬") + 1)) +
          list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def clean_text(text: str) -> str:
    """Whitespace collapse + html unescape + lowercase (no ftfy repair, as
    in the JAX package)."""
    text = html.unescape(html.unescape(text))
    return _unicode.collapse_space(text.strip()).lower()


def split_words(text: str) -> List[str]:
    """The JAX package's ``WORD_PAT.findall(text)``."""
    return _unicode.findall(text)


def _pairs(word: Sequence[str]):
    return set(zip(word[:-1], word[1:]))


class BPE:
    """Vocabulary + encode/decode over a merge list; ``core`` is where the
    merge loop runs ("native" or "python")."""

    def __init__(self, merges: List[Tuple[str, str]], core: str = "native"):
        if core not in CORES:
            raise ValueError(f"unknown BPE core {core!r}; expected one of {CORES}")
        byte_chars = list(bytes_to_unicode().values())
        vocab = byte_chars + [c + "</w>" for c in byte_chars]
        vocab += ["".join(m) for m in merges]
        vocab += [SOT, EOT]
        self.merges = merges
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.byte_enc = bytes_to_unicode()
        self.byte_dec = {v: k for k, v in self.byte_enc.items()}
        self._cache: Dict[str, List[str]] = {SOT: [SOT], EOT: [EOT]}
        self.core = core
        self._native = None
        if core == "native":
            from .native import NativeBPE
            self._native = NativeBPE(merges)

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    # -- merge loop --------------------------------------------------------
    def _merge_python(self, symbols: List[str]) -> List[str]:
        word = symbols
        while len(word) > 1:
            best = min(_pairs(word),
                       key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            first, second = best
            out, i = [], 0
            while i < len(word):
                if i + 1 < len(word) and word[i] == first and word[i + 1] == second:
                    out.append(first + second)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = out
        return word

    def _bpe_word(self, token: str) -> List[str]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        symbols = [self.byte_enc[b] for b in token.encode("utf-8")]
        if not symbols:
            return []
        symbols = symbols[:-1] + [symbols[-1] + "</w>"]
        if self._native is not None:
            word = self._native.encode_word(symbols)
        else:
            word = self._merge_python(symbols)
        self._cache[token] = word
        return word

    # -- public API --------------------------------------------------------
    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in split_words(clean_text(text)):
            ids.extend(self.encoder[s] for s in self._bpe_word(token))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[i] for i in ids
                       if i in self.decoder and self.decoder[i] not in (SOT, EOT))
        # byte-decode first, then turn '</w>' markers into spaces (the marker's
        # own chars are printable ASCII and pass through the byte table)
        data = bytes(self.byte_dec[c] for c in text if c in self.byte_dec)
        return (data.decode("utf-8", errors="replace")
                .replace("</w>", " ").strip())


# ---------------------------------------------------------------------------
# merges file io (CLIP-compatible) + training
# ---------------------------------------------------------------------------

DEFAULT_VOCAB_PATH = Path(__file__).parent / "data" / "bpe_simple_vocab_16e6.txt.gz"


def load_merges(path: str | Path, limit: Optional[int] = None) -> List[Tuple[str, str]]:
    """Read a CLIP-format merges file ('first second' per line; tolerate a
    version header and blank lines), plain or gzipped. ``limit`` reproduces
    the reference's slice (merges[1:49152-256-2+1])."""
    path = Path(path)
    if path.suffix == ".gz":
        text = gzip.decompress(path.read_bytes()).decode("utf-8")
    else:
        text = path.read_text(encoding="utf-8")
    lines = text.split("\n")
    # the version header may itself split into two tokens, so detect it by
    # the '#version' marker or a non-pair shape (a bare '#' test would eat a
    # legitimate first merge containing the byte char '#')
    if lines and ("#version" in lines[0] or len(lines[0].split()) != 2):
        lines = lines[1:]
    merges = []
    for ln in lines:
        parts = ln.split()
        if len(parts) == 2:
            merges.append((parts[0], parts[1]))
        if limit and len(merges) >= limit:
            break
    return merges


def save_merges(path: str | Path, merges: Sequence[Tuple[str, str]]):
    Path(path).write_text(
        "#version: dalle_tpu bpe\n" +
        "\n".join(f"{a} {b}" for a, b in merges) + "\n", encoding="utf-8")


def train_bpe(texts: Iterable[str], num_merges: int) -> List[Tuple[str, str]]:
    """Learn a merge list from a corpus (classic BPE training: repeatedly fuse
    the most frequent adjacent symbol pair over the word-frequency table)."""
    enc = bytes_to_unicode()
    word_freq: Counter = Counter()
    for text in texts:
        for token in split_words(clean_text(text)):
            symbols = [enc[b] for b in token.encode("utf-8")]
            if not symbols:
                continue
            symbols = symbols[:-1] + [symbols[-1] + "</w>"]
            word_freq[tuple(symbols)] += 1

    merges: List[Tuple[str, str]] = []
    words = {w: f for w, f in word_freq.items()}
    for _ in range(num_merges):
        pair_freq: Counter = Counter()
        for w, f in words.items():
            for p in zip(w[:-1], w[1:]):
                pair_freq[p] += f
        if not pair_freq:
            break
        best, freq = pair_freq.most_common(1)[0]
        if freq < 2:
            break
        merges.append(best)
        first, second = best
        new_words = {}
        for w, f in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and w[i] == first and w[i + 1] == second:
                    out.append(first + second)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            new_words[tuple(out)] = new_words.get(tuple(out), 0) + f
        words = new_words
    return merges
