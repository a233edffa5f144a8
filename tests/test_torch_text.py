"""The port's tokenizer ≡ the JAX package's, with no ``regex`` in the port.

The port splits words with a scanner over range tables that
``dalle_tpu_torch/text/_gen_unicode.py`` generated from ``regex``
(``_unicode_tables.py``). Here the tables are held to ``regex`` itself on
every one of the 0x110000 code points, the scanner to the JAX package's
``WORD_PAT.findall`` on hypothesis text from every plane, and the port's
``SimpleTokenizer`` to the JAX one on the shipped CLIP vocabulary. The
native merge core is held to the Python merge loop. All exact.
"""

import gzip
import hashlib
import sys

import numpy as np
import pytest
import regex
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dalle_tpu.text import bpe as jbpe
from dalle_tpu.text.tokenizer import SimpleTokenizer as JSimpleTokenizer
from dalle_tpu_torch.text import _gen_unicode, _unicode, _unicode_tables
from dalle_tpu_torch.text import bpe, native
from dalle_tpu_torch.text.tokenizer import (ChineseTokenizer, HugTokenizer,
                                            SimpleTokenizer, get_tokenizer)

GOLDEN = [   # tests/test_tokenizer.py: the reference tokenizer's ids
    ("a cloudy sky at sunset", [320, 13106, 2390, 536, 3424]),
    ("Hello, World! 123", [3306, 267, 1002, 256, 272, 273, 274]),
    ("the quick brown fox jumps over the lazy dog.",
     [518, 3712, 2866, 3240, 18911, 962, 518, 10753, 1929, 269]),
    ("an oil painting of a fox's tail - impressionism",
     [550, 2870, 3086, 539, 320, 3240, 568, 4132, 268, 36114]),
    ("unicode text with emoji \U0001F308 mixed in",
     [7648, 19639, 4160, 593, 16327, 13042, 6780, 530]),
    ("supercalifragilisticexpialidocious antidisestablishmentarianism",
     [1642, 2857, 13093, 2076, 5868, 26850, 835, 639, 38466, 3120, 4262,
      7726, 12658, 1585, 44351]),
    ("A RAINBOW-colored umbrella;   with    weird whitespace",
     [320, 6286, 268, 11775, 17143, 282, 593, 5613, 4699, 2138]),
]

# scripts, digits, contractions in every case, SOT/EOT, punctuation runs,
# the ASCII separators U+001C-U+001F that str.isspace counts and \s does not,
# and code points where unicodedata and regex disagree
FIXED = [
    "Ünïcödé ελληνικά кириллица 中文字 العربية हिन्दी ไทย 한국어",
    "1234 ٣٤٥ ४५६ ⅫⅬ ½ ² 𐵀𐵄",
    "it's IT'S It'S we'LL they'Re you'VE i'M he'D don'T 'ſ 'İ",
    "<|startoftext|>a cat<|endoftext|> <|ENDOFTEXT|> <|ſtartoftext|> <|startof",
    "!!! ... ?!?! --- ((x)) @#$% '' ''s 'x 'l",
    "a\x1cb\x1dc\x1ed\x1fe \x85   　 tab\tnl\n",
    "࢏౜Ᲊ aͅb xͅ ͅ",
    "",
]


@pytest.fixture(scope="module")
def everything():
    return "".join(map(chr, range(0x110000)))


@pytest.fixture(scope="module")
def tok():
    return SimpleTokenizer()


@pytest.fixture(scope="module")
def jtok():
    return JSimpleTokenizer()


# ---------------------------------------------------------------------------
# the range tables against regex, every code point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(_gen_unicode.CLASSES))
def test_unicode_table_equals_regex_on_every_code_point(everything, name):
    """The committed table is the half-open range list of exactly the code
    points regex's class matches (IGNORECASE, as WORD_PAT), and the
    bisection lookup agrees with regex on all 0x110000 of them."""
    table = getattr(_unicode_tables, name)
    pattern = regex.compile(_gen_unicode.CLASSES[name], regex.IGNORECASE)
    want = np.zeros(0x110000, bool)
    for m in pattern.finditer(everything):
        want[m.start():m.end()] = True
    got = np.searchsorted(np.asarray(table), np.arange(0x110000), side="right") & 1
    assert np.array_equal(got.astype(bool), want)
    # strictly increasing: no empty or abutting ranges, so the table is the
    # one list of ranges that gives this mask
    assert all(a < b for a, b in zip(table, table[1:]))


def test_fold_table_equals_regex(everything):
    """FOLD maps exactly the code points other than a-z that an ASCII
    letter matches case-insensitively to that letter."""
    folds = {}
    for m in regex.finditer("[a-z]", everything, regex.IGNORECASE):
        ch = m.group()
        if ch not in "abcdefghijklmnopqrstuvwxyz":
            [letter] = [c for c in "abcdefghijklmnopqrstuvwxyz"
                        if regex.fullmatch(c, ch, regex.IGNORECASE)]
            folds[m.start()] = letter
    assert _unicode_tables.FOLD == folds
    assert _unicode_tables.REGEX_VERSION == regex.__version__


@pytest.mark.parametrize("cp, letter, number, space", [
    (0x1C, False, False, False), (0x1D, False, False, False),
    (0x1E, False, False, False), (0x1F, False, False, False),
    (0x088F, True, False, False), (0x10D40, False, True, False),
    (0x20, False, False, True), (0x3000, False, False, True)])
def test_named_code_points(cp, letter, number, space):
    """U+001C-U+001F are not \\s (str.isspace says they are); U+088F is a
    letter and U+10D40 a digit in regex's Unicode (not in Python 3.12's)."""
    ch = chr(cp)
    tables = (_unicode_tables.LETTER, _unicode_tables.NUMBER, _unicode_tables.SPACE)
    assert tuple(_unicode._member(t, ch) for t in tables) == (letter, number, space)
    assert bool(regex.fullmatch(r"\p{L}", ch)) == letter
    assert bool(regex.fullmatch(r"\p{N}", ch)) == number
    assert bool(regex.fullmatch(r"\s", ch)) == space


# ---------------------------------------------------------------------------
# the scanner against WORD_PAT.findall
# ---------------------------------------------------------------------------

_PIECES = ["'s", "'S", "'t", "'RE", "'ve", "'M", "'ll", "'LL", "'d", "'ſ", "'",
           "<|startoftext|>", "<|endoftext|>", "<|EndOfText|>", "<|", "|>",
           " ", "  ", "\x1c", "\x1f", "ͅ", "1", "٣", "a", "Ä", "࢏",
           "\U00010d40", "!!", "-", "\t\n"]
TEXT = st.lists(st.one_of(st.characters(), st.sampled_from(_PIECES)),
                max_size=24).map("".join)


@settings(max_examples=400, deadline=None, derandomize=True)
@given(TEXT)
def test_scanner_equals_word_pat_on_hypothesis_text(text):
    assert _unicode.findall(text) == jbpe.WORD_PAT.findall(text)
    assert _unicode.collapse_space(text) == regex.sub(r"\s+", " ", text)
    assert bpe.clean_text(text) == jbpe.clean_text(text)


@pytest.mark.parametrize("text", FIXED)
def test_scanner_equals_word_pat_on_fixed_cases(text):
    assert _unicode.findall(text) == jbpe.WORD_PAT.findall(text)
    assert bpe.clean_text(text) == jbpe.clean_text(text)


# ---------------------------------------------------------------------------
# the tokenizer against the JAX one on the shipped vocabulary
# ---------------------------------------------------------------------------

def test_vocabulary_copy_is_byte_for_byte():
    ours = hashlib.sha256(bpe.DEFAULT_VOCAB_PATH.read_bytes()).hexdigest()
    theirs = hashlib.sha256(jbpe.DEFAULT_VOCAB_PATH.read_bytes()).hexdigest()
    assert ours == theirs


def test_default_vocab_is_clip_and_native(tok, jtok):
    assert tok.vocab_size == jtok.vocab_size == 49408
    assert tok.core == "native"


@pytest.mark.parametrize("text,ids", GOLDEN, ids=[t[:20] for t, _ in GOLDEN])
def test_golden_ids(tok, jtok, text, ids):
    assert tok.encode(text) == ids == jtok.encode(text)
    assert tok.decode(ids) == jtok.decode(ids)


@pytest.mark.parametrize("text", FIXED)
def test_encode_decode_equal_jax(tok, jtok, text):
    ids = tok.encode(text)
    assert ids == jtok.encode(text)
    assert tok.decode(ids) == jtok.decode(ids)


@settings(max_examples=150, deadline=None, derandomize=True)
@given(TEXT)
def test_encode_equals_jax_on_hypothesis_text(tok, jtok, text):
    assert tok.encode(text) == jtok.encode(text)


def test_tokenize_contract_and_truncation(tok, jtok):
    texts = [t for t, _ in GOLDEN]
    got = tok.tokenize(texts, context_length=12, truncate_text=True)
    want = jtok.tokenize(texts, context_length=12, truncate_text=True)
    assert got.dtype == torch.long and got.device.type == "cpu"
    assert tuple(got.shape) == (len(texts), 12)
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert np.array_equal(tok.tokenize("hello", 4).numpy(), jtok.tokenize("hello", 4))
    with pytest.raises(RuntimeError, match="too long"):
        tok.tokenize(texts, context_length=12)
    with pytest.raises(RuntimeError, match="too long"):
        jtok.tokenize(texts, context_length=12)
    assert tok.decode(got[1]) == jtok.decode(want[1])


def test_train_bpe_equals_jax(tmp_path):
    corpus = [t for t, _ in GOLDEN] * 3 + FIXED
    merges = bpe.train_bpe(corpus, 40)
    assert merges == jbpe.train_bpe(corpus, 40)
    path = tmp_path / "merges.txt"
    port = SimpleTokenizer.train(corpus, 40, save_path=str(path))
    assert bpe.load_merges(path) == merges
    theirs = JSimpleTokenizer(merges=merges)
    for text in corpus:
        assert port.encode(text) == theirs.encode(text)
    assert get_tokenizer("yttm", bpe_path=str(path)).encode(corpus[0]) == port.encode(corpus[0])


# ---------------------------------------------------------------------------
# the two merge loops, and no quiet fallback
# ---------------------------------------------------------------------------

def test_native_and_python_merge_loops_agree(tok):
    py = bpe.BPE(tok.bpe.merges, core="python")
    words = set()
    for text in [t for t, _ in GOLDEN] + FIXED:
        words.update(bpe.split_words(bpe.clean_text(text)))
    rng = np.random.RandomState(0)
    alphabet = list("abcdefghijklmnopqrstuvwxyz0123456789'.-") + ["é", "中", "🌈"]
    words.update("".join(rng.choice(alphabet, rng.randint(1, 30))) for _ in range(300))
    for word in sorted(words):
        assert tok.bpe._bpe_word(word) == py._bpe_word(word), word


def test_native_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "bpe_core.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="error"):
        native.build()
    with pytest.raises(ValueError):
        bpe.BPE([], core="regex")


def test_native_library_is_named_by_its_source(tmp_path, monkeypatch):
    src = tmp_path / "bpe_core.cpp"
    src.write_bytes(native.SRC.read_bytes())
    monkeypatch.setattr(native, "SRC", src)
    first = native._target()
    src.write_bytes(native.SRC.read_bytes() + b"// edited\n")
    assert native._target() != first and first.parent.name == "native"


@pytest.mark.parametrize("cls, module", [(HugTokenizer, "tokenizers"),
                                         (ChineseTokenizer, "transformers")])
def test_optional_tokenizers_raise_import_error_without_their_package(
        monkeypatch, cls, module):
    monkeypatch.setitem(sys.modules, module, None)
    with pytest.raises(ImportError, match=module):
        cls("vocab.txt")


def test_gzip_and_plain_merges_load_the_same(tmp_path):
    plain = tmp_path / "merges.txt"
    plain.write_bytes(gzip.decompress(bpe.DEFAULT_VOCAB_PATH.read_bytes()))
    limit = SimpleTokenizer.CLIP_MERGE_LIMIT
    assert bpe.load_merges(plain, limit) == bpe.load_merges(bpe.DEFAULT_VOCAB_PATH, limit) \
        == jbpe.load_merges(plain, limit)
