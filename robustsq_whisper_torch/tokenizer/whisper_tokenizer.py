"""Whisper special-token layout and the hermetic byte tokenizer.

A copy of the special-token map and ``ByteTokenizer`` of the JAX package's
``tokenizer/whisper_tokenizer.py``: the torch port keeps its own so it never
imports the JAX package. The BPE backend needs ``tiktoken``, which the
serving machine does not have; it comes with a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

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
