from .whisper_tokenizer import (
    BPETokenizer,
    ByteTokenizer,
    SpecialTokens,
    load_tokenizer,
    special_tokens,
    special_tokens_for_vocab,
)
