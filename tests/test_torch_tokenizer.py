"""The port's pure-Python BPE against the JAX package's tiktoken one.

Same ids from ``encode`` and the same text from ``decode`` on the checked-in
mini ranks file, for hypothesis-drawn text: letters of several scripts,
non-ASCII numerics, contractions, punctuation and runs of spaces, tabs and
newlines (and the Unicode White_Space characters that Python's
``str.isspace`` disagrees on)."""

import base64
import json
import pathlib

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from robustsq_whisper_tpu.tokenizer import whisper_tokenizer as jtok
from robustsq_whisper_torch.tokenizer import whisper_tokenizer as ptok

RANKS = str(pathlib.Path(__file__).resolve().parent / "assets" / "mini_ranks.tiktoken")

ALPHABET = (
    list("abcdehlnorstuwXYZ") + list("éßøÆñ") + list("αβγΩλ") + list("абвЖя")
    + list("中文字語") + list("مرحبا") + list("नमस्ते") + list("ひらカナ")
    + list("0123456789") + list("²½Ⅻ٣३")  # non-ASCII numerics
    + list("'sStTrRvVmMlLdD") + list(".,!?-\"()…—😀#")
    + [" ", "\t", "\n", "\r", "\u00a0", "\u2003", "\u3000", "\x1c", "\x85"]
)
TEXT = st.lists(
    st.one_of(
        st.sampled_from(ALPHABET),
        st.sampled_from(["'s", "'t", "'re", "'ve", "'m", "'ll", "'d", "  ", "\n\n", " \t "]),
    ),
    max_size=40,
).map("".join)


@pytest.fixture(scope="module")
def toks():
    return ptok.BPETokenizer.from_tiktoken_file(RANKS), jtok.BPETokenizer.from_tiktoken_file(RANKS)


@settings(max_examples=400, deadline=None)
@given(text=TEXT)
def test_encode_decode_equal_tiktoken(toks, text):
    p, j = toks
    ids = p.encode(text)
    assert ids == j.encode(text)
    assert p.decode(ids) == j.decode(ids) == text


@settings(max_examples=200, deadline=None)
@given(ids=st.lists(st.integers(0, 60000), max_size=24))
def test_decode_of_any_ids_equals_tiktoken(toks, ids):
    """Ids past the ranks table or at/after eot are dropped; broken UTF-8
    becomes U+FFFD, as in the JAX package."""
    p, j = toks
    assert p.decode(ids) == j.decode(ids)


def test_pre_tokenizer_pieces():
    assert ptok.pre_tokenize("he's  12½ ok!?\n\n  x") == [
        "he", "'s", " ", " 12½", " ok", "!?", "\n\n ", " x",
    ]


def test_special_text_is_disallowed(toks):
    for tok in toks:
        with pytest.raises(ValueError):
            tok.encode("a <|endoftext|> b")


def _write_hf(tmp_path):
    """vocab.json / merges.txt of the mini ranks, GPT-2's byte-to-unicode map."""
    enc = {b: c for c, b in ptok._hf_byte_decoder().items()}
    ranks = {}
    with open(RANKS, "rb") as f:
        for line in f:
            t, r = line.split()
            ranks[base64.b64decode(t)] = int(r)
    vocab = {"".join(enc[b] for b in tok): r for tok, r in ranks.items()}
    vocab["<|endoftext|>"] = len(vocab)
    d = tmp_path / "hf"
    d.mkdir()
    (d / "vocab.json").write_text(json.dumps(vocab))
    merges = [tok for tok in sorted(ranks, key=ranks.get) if len(tok) > 1]
    (d / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(
            " ".join("".join(enc[b] for b in part) for part in _split(m, ranks)) + "\n"
            for m in merges
        )
    )
    return d


def _split(tok, ranks):
    for i in range(1, len(tok)):
        if tok[:i] in ranks and tok[i:] in ranks:
            return tok[:i], tok[i:]
    raise AssertionError(tok)


def test_from_hf_files_equals_ranks_file(tmp_path, toks):
    d = _write_hf(tmp_path)
    hf = ptok.BPETokenizer.from_hf_files(str(d / "vocab.json"), str(d / "merges.txt"))
    jhf = jtok.BPETokenizer.from_hf_files(str(d / "vocab.json"), str(d / "merges.txt"))
    text = "the theatre on the hill; he's 42, and ½ of it's ok.\n\tthen  tion!"
    assert hf.encode(text) == toks[0].encode(text) == jhf.encode(text)
    assert hf.decode(hf.encode(text)) == text


def test_load_tokenizer_choice(tmp_path):
    d = _write_hf(tmp_path)
    tk = tmp_path / "tk"
    tk.mkdir()
    (tk / "multilingual.tiktoken").write_bytes(open(RANKS, "rb").read())
    for arg, want in (
        (str(tk), "BPETokenizer"),
        (RANKS, "BPETokenizer"),
        (str(d / "vocab.json"), "BPETokenizer"),
        (str(d), "BPETokenizer"),
        (None, "ByteTokenizer"),
        (str(tmp_path / "missing.tiktoken"), "ByteTokenizer"),
    ):
        assert type(ptok.load_tokenizer(arg)).__name__ == want, arg
        assert type(jtok.load_tokenizer(arg)).__name__ == want, arg
    text = "the hat"
    assert ptok.load_tokenizer(str(d)).encode(text) == jtok.load_tokenizer(str(d)).encode(text)
