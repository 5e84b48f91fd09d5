from .search import (
    DecodeConfig,
    build_beam_decoder,
    build_greedy_decoder,
    strip_eot,
)
