from .whisper_tokenizer import (
    ByteTokenizer,
    SpecialTokens,
    special_tokens,
    special_tokens_for_vocab,
)
