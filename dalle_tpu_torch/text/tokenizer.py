"""Text tokenizers, a copy of ``dalle_tpu/text/tokenizer.py``.

Shared contract: ``tokenize(texts, context_length=256, truncate_text=False)``
→ (b, context_length) ids with 0 as pad, as a CPU ``torch.long`` tensor
(the JAX package returns the same values as an int32 array), plus
``encode``/``decode`` and ``vocab_size``. Host-side only: token ids are
the device boundary.

* ``SimpleTokenizer``: byte-level BPE (``bpe.py``) over the shipped CLIP
  merges by default (vocab 49,408), its merge loop in the native core
  (``core="native"``, the default) or in Python (``core="python"``).
* ``YttmTokenizer``: the same BPE loaded from a merges file.
* ``HugTokenizer``: a HuggingFace ``tokenizers`` JSON vocabulary.
* ``ChineseTokenizer``: a ``transformers`` ``BertTokenizer`` from a local
  ``vocab.txt`` or the local model cache; it never downloads.

The last two raise ``ImportError`` when their package is missing, as in the
JAX package.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Iterable, List, Optional

import numpy as np
import torch

from .bpe import BPE, DEFAULT_VOCAB_PATH, load_merges, save_merges, train_bpe

_DEFAULT = object()  # sentinel: "use the shipped CLIP vocab"


def _nonzero_ids(ids) -> List[int]:
    if isinstance(ids, torch.Tensor):
        ids = ids.cpu().numpy()
    return [int(i) for i in np.asarray(list(ids)).reshape(-1) if int(i) != 0]


def pad_ids(encode: Callable[[str], List[int]], texts, context_length: int,
            truncate_text: bool) -> torch.Tensor:
    """(b, context_length) long ids of ``texts``, pad 0; a text longer than
    the context raises unless ``truncate_text``."""
    if isinstance(texts, str):
        texts = [texts]
    out = torch.zeros((len(texts), context_length), dtype=torch.long)
    for i, text in enumerate(texts):
        ids = encode(text)
        if len(ids) > context_length:
            if not truncate_text:
                raise RuntimeError(f"Input {text!r} is too long for context length "
                                   f"{context_length}")
            ids = ids[:context_length]
        out[i, :len(ids)] = torch.tensor(ids, dtype=torch.long)
    return out


class SimpleTokenizer:
    """Byte-level BPE with the reference contract. ``bpe_path`` accepts a
    CLIP-format merges file (plain or .gz); ``merges`` an in-memory merge
    list. With no arguments the shipped CLIP merges load, reproducing the
    reference's 49,408-token vocab; ``bpe_path=None, merges=[]`` gives a
    bare byte-level tokenizer (vocab 514). ``clip_compat`` truncates merges
    at the CLIP limit; by default only for the shipped vocab. ``core`` is
    where the merge loop runs (``bpe.BPE``)."""

    CLIP_MERGE_LIMIT = 49152 - 256 - 2  # reference tokenizer.py:58

    def __init__(self, bpe_path: Optional[str] = _DEFAULT, merges=None,
                 clip_compat: Optional[bool] = None, core: str = "native"):
        if bpe_path is _DEFAULT:
            bpe_path = (str(DEFAULT_VOCAB_PATH)
                        if merges is None and DEFAULT_VOCAB_PATH.exists()
                        else None)
            if clip_compat is None and bpe_path is not None:
                clip_compat = True
        if bpe_path is not None:
            limit = self.CLIP_MERGE_LIMIT if clip_compat else None
            merges = load_merges(bpe_path, limit=limit)
        self.bpe = BPE(list(merges if merges is not None else []), core=core)

    @property
    def vocab_size(self) -> int:
        return self.bpe.vocab_size

    @property
    def core(self) -> str:
        return self.bpe.core

    def encode(self, text: str) -> List[int]:
        return self.bpe.encode(text)

    def decode(self, ids: Iterable[int]) -> str:
        return self.bpe.decode(_nonzero_ids(ids))

    def tokenize(self, texts, context_length: int = 256,
                 truncate_text: bool = False) -> torch.Tensor:
        return pad_ids(self.encode, texts, context_length, truncate_text)

    @classmethod
    def train(cls, texts: Iterable[str], num_merges: int,
              save_path: Optional[str] = None, core: str = "native") -> "SimpleTokenizer":
        merges = train_bpe(texts, num_merges)
        if save_path:
            save_merges(save_path, merges)
        return cls(merges=merges, core=core)


class YttmTokenizer(SimpleTokenizer):
    """Name-compatible stand-in for the reference's YouTokenToMe wrapper:
    the same contract, the BPE model loaded from a merges file."""

    def __init__(self, bpe_path: str, core: str = "native"):
        if not Path(bpe_path).exists():
            raise ValueError(f"BPE json path {bpe_path!r} does not exist")
        super().__init__(bpe_path=str(bpe_path), clip_compat=False, core=core)


class HugTokenizer:
    """HuggingFace ``tokenizers`` JSON vocab wrapper."""

    def __init__(self, bpe_path: str):
        try:
            from tokenizers import Tokenizer
        except ImportError as e:
            raise ImportError("HugTokenizer needs the `tokenizers` package") from e
        path = Path(bpe_path)
        if not path.exists():
            raise ValueError(f"BPE json path {bpe_path!r} does not exist")
        self.tokenizer = Tokenizer.from_file(str(path))
        self.vocab_size = self.tokenizer.get_vocab_size()

    def encode(self, text: str) -> List[int]:
        return self.tokenizer.encode(text).ids

    def decode(self, ids) -> str:
        return self.tokenizer.decode(_nonzero_ids(ids))

    def tokenize(self, texts, context_length: int = 256,
                 truncate_text: bool = False) -> torch.Tensor:
        return pad_ids(self.encode, texts, context_length, truncate_text)


class ChineseTokenizer:
    """``transformers`` ``BertTokenizer``: ``model_name`` is a local WordPiece
    ``vocab.txt`` or a model in the local cache. Unlike the JAX package it
    never tries the hub, and has no vendored fallback vocabulary."""

    def __init__(self, model_name: str = "bert-base-chinese"):
        try:
            from transformers import BertTokenizer
        except ImportError as e:
            raise ImportError("ChineseTokenizer needs the `transformers` package") from e
        if Path(model_name).is_file():
            self.tokenizer = BertTokenizer(vocab_file=str(model_name))
        else:
            self.tokenizer = BertTokenizer.from_pretrained(model_name,
                                                           local_files_only=True)
        self.vocab_size = self.tokenizer.vocab_size

    def encode(self, text: str) -> List[int]:
        return self.tokenizer.encode(text, add_special_tokens=False)

    def decode(self, ids) -> str:
        return self.tokenizer.decode(_nonzero_ids(ids))

    def tokenize(self, texts, context_length: int = 256,
                 truncate_text: bool = False) -> torch.Tensor:
        return pad_ids(self.encode, texts, context_length, truncate_text)


def get_tokenizer(kind: str = "simple", **kw):
    """The tokenizer a CLI's ``--tokenizer`` names."""
    kinds = {"simple": SimpleTokenizer, "yttm": YttmTokenizer,
             "hug": HugTokenizer, "chinese": ChineseTokenizer}
    if kind not in kinds:
        raise ValueError(f"unknown tokenizer {kind!r}; options: {sorted(kinds)}")
    return kinds[kind](**kw)
