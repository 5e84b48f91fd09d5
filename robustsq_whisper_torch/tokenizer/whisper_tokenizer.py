r"""Whisper special-token layout, the byte-level BPE and the byte fallback.

The port's copy of the JAX package's ``tokenizer/whisper_tokenizer.py``:
the special-token map, ``ByteTokenizer``, ``BPETokenizer`` over a local
``.tiktoken`` ranks file or a HF ``vocab.json``, and ``load_tokenizer``.
The JAX ``BPETokenizer`` is built on ``tiktoken``; this one is pure Python
(no ``tiktoken``, no ``regex``) and gives the same ids: the pre-tokenizer
is a scanner over ``unicodedata`` categories that matches tiktoken's
pattern (contractions, `` ?\p{L}+``, `` ?\p{N}+``, `` ?[^\s\p{L}\p{N}]+``,
``\s+(?!\S)``, ``\s+``) alternative by alternative, with ``\s`` the
Unicode White_Space set as in Rust's regex; each piece is merged pair by
pair in rank order, the lowest-ranked adjacent pair first and the leftmost on
a tie, as tiktoken's ``byte_pair_merge`` does.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

# 99 languages of multilingual Whisper, in official order.
LANGUAGES = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms "
    "cs ro da hu ta no th ur hr bg lt la mi ml cy sk te fa lv bn sr az sl kn "
    "et mk br eu is hy ne mn bs kk sq sw gl mr pa si km sn yo so af oc ka be "
    "tg sd gu am yi lo uz fo ht ps tk nn mt sa lb my bo tl mg as tt haw ln ha "
    "ba jw su yue"  # yue is the 100th language (large-v3 family only)
).split()

GPT2_VOCAB = 50257  # byte-pair vocab incl. <|endoftext|>


@dataclasses.dataclass(frozen=True)
class SpecialTokens:
    eot: int
    sot: int
    translate: int
    transcribe: int
    lang_offset: int  # id of <|en|>
    startoflm: int
    startofprev: int
    nospeech: int
    notimestamps: int
    timestamp_begin: int
    n_vocab: int

    def lang(self, code: str) -> int:
        idx = LANGUAGES.index(code)
        n_langs = self.translate - self.lang_offset
        if idx >= n_langs:
            raise ValueError(
                f"language {code!r} needs a {idx + 1}-language layout "
                f"(this one has {n_langs}; large-v3 layouts have 100)"
            )
        return self.lang_offset + idx

    def sot_sequence(
        self, language: Optional[str] = "en", task: str = "transcribe",
        notimestamps: bool = True, multilingual: bool = True,
    ) -> Tuple[int, ...]:
        seq = [self.sot]
        if multilingual and language is not None:
            seq.append(self.lang(language))
            seq.append(self.transcribe if task == "transcribe" else self.translate)
        if notimestamps:
            seq.append(self.notimestamps)
        return tuple(seq)


def special_tokens(
    multilingual: bool = True, num_languages: int = 99
) -> SpecialTokens:
    """Token layout of openai/whisper: specials appended after the base vocab.

    multilingual (n_vocab 51865): base 50257 + <|endoftext|>=50257,
    <|startoftranscript|>=50258, 99 languages 50259..50357, translate=50358,
    transcribe=50359, startoflm=50360, startofprev=50361, nospeech=50362,
    notimestamps=50363, timestamps from 50364.
    English-only (51864): one fewer language slot shifts everything by -1.
    large-v3 family: ``num_languages=100`` (adds <|yue|>), which shifts
    every special after the language block by +1 and gives n_vocab 51866.
    """
    if multilingual:
        eot = 50257
        n_langs = num_languages
    else:
        eot = 50256  # gpt2 <|endoftext|>
        n_langs = num_languages  # layout keeps slots; ids shift by -1
    sot = eot + 1
    lang_offset = sot + 1
    translate = lang_offset + n_langs
    transcribe = translate + 1
    startoflm = transcribe + 1
    startofprev = startoflm + 1
    nospeech = startofprev + 1
    notimestamps = nospeech + 1
    timestamp_begin = notimestamps + 1
    n_vocab = timestamp_begin + 1501
    return SpecialTokens(
        eot=eot, sot=sot, translate=translate, transcribe=transcribe,
        lang_offset=lang_offset, startoflm=startoflm, startofprev=startofprev,
        nospeech=nospeech, notimestamps=notimestamps,
        timestamp_begin=timestamp_begin, n_vocab=n_vocab,
    )


def special_tokens_for_vocab(n_vocab: int) -> SpecialTokens:
    """The token layout a model's vocab size implies: 51864 = English-only,
    51865 = multilingual (99 languages), 51866 = large-v3 multilingual
    (100 languages, <|yue|>). Expanded vocabs (> 51866) keep the v2 layout
    the expansion started from."""
    if n_vocab == 51864:
        return special_tokens(multilingual=False)
    if n_vocab == 51866:
        return special_tokens(multilingual=True, num_languages=100)
    return special_tokens(multilingual=True)


class ByteTokenizer:
    """Hermetic fallback: UTF-8 bytes 0..255 as the text vocab, Whisper
    special-token ids preserved. Round-trips any text; useful for tests and
    pipeline smoke runs without BPE assets."""

    def __init__(self, multilingual: bool = True):
        self.special = special_tokens(multilingual)
        self.n_vocab = self.special.n_vocab

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")


# Unicode White_Space (what ``\s`` matches in tiktoken's regex engine);
# Python's str.isspace() also takes U+001C..U+001F
_WHITE_SPACE = frozenset(
    chr(c) for c in (
        *range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
        0x2028, 0x2029, 0x202F, 0x205F, 0x3000,
    )
)
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")  # in the pattern's order
_EOT_TEXT = "<|endoftext|>"


def _is_letter(c: str) -> bool:
    return unicodedata.category(c)[0] == "L"


def _is_number(c: str) -> bool:
    return unicodedata.category(c)[0] == "N"


def _is_other(c: str) -> bool:
    return c not in _WHITE_SPACE and unicodedata.category(c)[0] not in "LN"


def _piece_end(text: str, i: int) -> int:
    """End of the pre-tokenizer match that starts at ``i``."""
    n = len(text)
    c = text[i]
    if c == "'":
        for s in _CONTRACTIONS:
            if text.startswith(s, i + 1):
                return i + 1 + len(s)
    for cls in (_is_letter, _is_number, _is_other):  # ` ?<cls>+`
        k = i + 1 if c == " " and i + 1 < n and cls(text[i + 1]) else i
        if cls(text[k]):
            while k < n and cls(text[k]):
                k += 1
            return k
    # whitespace: `\s+(?!\S)`, else `\s+`
    k = i
    while k < n and text[k] in _WHITE_SPACE:
        k += 1
    if k == n or k - 1 == i:
        return k
    return k - 1


def pre_tokenize(text: str) -> List[str]:
    """The pieces tiktoken's pattern splits ``text`` into."""
    out, i = [], 0
    while i < len(text):
        j = _piece_end(text, i)
        out.append(text[i:j])
        i = j
    return out


class BPETokenizer:
    """GPT-2-style byte-level BPE from local assets (a tiktoken ranks file
    or HF vocab.json), in pure Python."""

    def __init__(self, ranks: Dict[bytes, int], multilingual: bool = True):
        self.special = special_tokens(multilingual)
        self.n_vocab = self.special.n_vocab
        self._ranks = dict(ranks)
        self._bytes = {r: b for b, r in self._ranks.items()}
        # ids past the ranks table (a reduced-vocab model decoded with a
        # small ranks file) are dropped in decode, as in the JAX package
        self._n_text = len(self._ranks)

    @classmethod
    def from_tiktoken_file(cls, path: str, multilingual: bool = True) -> "BPETokenizer":
        ranks = {}
        with open(path, "rb") as f:
            for line in f:
                if not line.strip():
                    continue
                token, rank = line.split()
                ranks[base64.b64decode(token)] = int(rank)
        return cls(ranks, multilingual)

    @classmethod
    def from_hf_files(
        cls, vocab_json: str, merges_txt: str, multilingual: bool = True
    ) -> "BPETokenizer":
        """HF byte-level BPE (unicode-remapped) back to byte ranks: the
        vocabulary ids are the ranks, so ``merges_txt`` is not read."""
        with open(vocab_json) as f:
            vocab = json.load(f)
        byte_decoder = _hf_byte_decoder()
        ranks = {}
        for tok, idx in vocab.items():
            if tok == _EOT_TEXT:
                continue
            ranks[bytes(byte_decoder[c] for c in tok)] = idx
        return cls(ranks, multilingual)

    def _merge(self, piece: bytes) -> List[int]:
        ranks = self._ranks
        rank = ranks.get(piece)
        if rank is not None:
            return [rank]
        parts = [piece[i : i + 1] for i in range(len(piece))]
        while len(parts) > 1:
            best, at = None, -1
            for k in range(len(parts) - 1):
                r = ranks.get(parts[k] + parts[k + 1])
                if r is not None and (best is None or r < best):
                    best, at = r, k
            if best is None:
                break
            parts[at : at + 2] = [parts[at] + parts[at + 1]]
        return [ranks[p] for p in parts]

    def encode(self, text: str) -> List[int]:
        if _EOT_TEXT in text:  # tiktoken's default: special text is disallowed
            raise ValueError(
                f"Encountered text corresponding to disallowed special token {_EOT_TEXT!r}"
            )
        out: List[int] = []
        for piece in pre_tokenize(text):
            out.extend(self._merge(piece.encode("utf-8")))
        return out

    def decode(self, ids: Sequence[int]) -> str:
        limit = min(self.special.eot, self._n_text)
        data = b"".join(self._bytes[i] for i in ids if i < limit)
        return data.decode("utf-8", errors="replace")


def _hf_byte_decoder() -> Dict[str, int]:
    """Inverse of the GPT-2 bytes->unicode table."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


def load_tokenizer(asset_path: Optional[str] = None, multilingual: bool = True):
    """Best tokenizer available: BPE from local assets, else byte fallback.

    ``asset_path`` may be a ``.tiktoken`` file, a ``vocab.json`` (with
    ``merges.txt`` next to it), or a directory containing either.
    """
    if asset_path:
        p = asset_path
        if os.path.isdir(p):
            for name in ("multilingual.tiktoken", "gpt2.tiktoken", "vocab.json"):
                cand = os.path.join(p, name)
                if os.path.exists(cand):
                    p = cand
                    break
        if p.endswith(".tiktoken") and os.path.exists(p):
            return BPETokenizer.from_tiktoken_file(p, multilingual)
        if p.endswith("vocab.json") and os.path.exists(p):
            merges = os.path.join(os.path.dirname(p), "merges.txt")
            return BPETokenizer.from_hf_files(p, merges, multilingual)
    return ByteTokenizer(multilingual)
