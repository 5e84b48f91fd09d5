"""The port's pure-Python BPE against the JAX package's tiktoken one.

Same ids from ``encode`` and the same text from ``decode`` on the checked-in
mini ranks file, for hypothesis-drawn text: letters of several scripts,
non-ASCII numerics, contractions, punctuation and runs of spaces, tabs and
newlines (and the Unicode White_Space characters that Python's
``str.isspace`` disagrees on). The special-token layout each Whisper vocab
size implies, and the benchmark's large-v3-turbo token ids, against the
JAX package's."""

import base64
import dataclasses
import json
import pathlib

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from robustsq_whisper_tpu.tokenizer import whisper_tokenizer as jtok
from robustsq_whisper_torch.tokenizer import whisper_tokenizer as ptok

ROOT = pathlib.Path(__file__).resolve().parent.parent
RANKS = str(ROOT / "tests" / "assets" / "mini_ranks.tiktoken")

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


@pytest.mark.parametrize("n_vocab", [51864, 51865, 51866])
def test_special_tokens_for_vocab_equal_jax(n_vocab):
    """English-only, multilingual and large-v3's layout (51866: <|yue|>
    moves every id after the language block up by one), field by field and
    for every language the layout holds."""
    got, want = ptok.special_tokens_for_vocab(n_vocab), jtok.special_tokens_for_vocab(n_vocab)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    n_langs = want.translate - want.lang_offset
    assert got.lang("en") == want.lang("en")
    for code in jtok.LANGUAGES[:n_langs]:
        assert got.lang(code) == want.lang(code), code


def test_turbo_benchmark_token_ids_equal_jax():
    """The large-v3-turbo benchmark configuration's ids are the JAX
    package's v3 layout: sot, en, transcribe, notimestamps to start, eot to
    stop, and startofprev before the speaker prompt."""
    cfg = json.loads((ROOT / "portbench" / "configs" / "qformer_large_v3_turbo.json").read_text())
    sp = jtok.special_tokens_for_vocab(cfg["whisper"]["n_vocab"])
    assert cfg["model"]["vocab_size"] == sp.n_vocab == 51866
    assert cfg["serving"]["init_tokens"] == [sp.sot, sp.lang("en"), sp.transcribe, sp.notimestamps]
    assert cfg["serving"]["eot"] == cfg["model"]["eos"] == sp.eot
    assert (cfg["model"]["sos"], cfg["model"]["startofprev"]) == (sp.sot, sp.startofprev)
