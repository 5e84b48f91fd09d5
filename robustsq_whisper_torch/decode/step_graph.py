"""The greedy token step as one CUDA graph replay.

``StepGraph`` holds the static operands of ``TSDecoder.step`` for one
batch shape (the token ids, the position, the self cache and the cross
K/V) and, from its first step on, that step captured over them as one CUDA
graph: the embedding, the positional row, every block's ``step_packed``
(the hand-written self-cache and cross kernels, the W8A8 matmuls when the
decoder has step weights) and the logits. The graph launches the same
kernels in the same order on the same operands as the eager step; it is
only the way they are launched. ``TSDecoder.step(..., graph=g)`` replays it
and returns the graph's logits buffer, so a caller that wraps ``step``
still sees every token's logits, once a call.

The first step of a new ``StepGraph`` runs eagerly on a side stream (the
warm-up a capture needs; a real step whose logits are returned), then the
step is captured on that stream, by ``CUDAGraph.capture_begin`` and
``capture_end`` and not by ``torch.cuda.graph``, which would synchronize
the device and empty both caching allocators (the device's and the pinned
host memory's) at every capture, so that the job's next batch allocates
them anew. The kernels' launch counters
(``decode_cross_attention.launches`` and the others of ``KERNEL_COUNTERS``)
are bumped in Python, which a capture runs once and a replay not at all:
the capture's counts are taken back and added again on every replay, so the
counters read as they do eagerly. Each replay opens the span
``rsq:decode.graph_replay``.

``graph_step_applies`` says where the graph engages: on CUDA in inference
mode, one token a row at one scalar position, the flat or time-minor self
cache, no beam grouping or row map, no tensor parallelism, no timestamp
rules. Every other step runs eagerly.

``StepGraphs`` keeps at most one ``StepGraph`` for a built decoder: a batch
of another shape (batch, cache length, memory length) drops the old one
before it makes its own, so memory does not grow with the shapes a job
meets.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..ops import decode_attention, quant, self_attention
from ..utils.profiling import annotate

# the launch counters a graphed step bumps: (wrapper, attributes)
KERNEL_COUNTERS = (
    (decode_attention.decode_cross_attention, ("launches", "state_launches")),
    (self_attention.decode_self_attention, ("launches", "int8_launches")),
    (quant.qmatmul, ("launches",)),
)


def graph_step_applies(
    dec, device, layout: str, q_len: int = 1, ragged: bool = False,
    beam_group: int = 1, row_map=None, with_timestamps: bool = False,
) -> bool:
    """Whether a step of ``dec`` (a ``TSDecoder``) on ``device`` over a self
    cache of ``layout`` (``TextDecoder._cache_layout``) replays as a graph:
    CUDA, inference mode, ``q_len`` 1 at a scalar position (not
    ``ragged``), the flat or time-minor cache, ``beam_group`` 1 with no
    ``row_map``, no vocabulary or tensor-parallel split, no timestamp
    rules."""
    td = dec.decoder
    return (
        torch.device(device).type == "cuda" and torch.is_inference_mode_enabled()
        and q_len == 1 and not ragged and layout in ("flat", "tmin")
        and beam_group == 1 and row_map is None
        and td.vocab_tp is None and td.tp_group is None
        and not with_timestamps
    )


class StepGraph:
    """The static operands of one batch shape's token step and, after its
    first step, the step's CUDA graph (the module docstring)."""

    def __init__(self, key: Tuple[int, ...]):
        self.key = key
        self.token: Optional[torch.Tensor] = None  # (batch, 1) int64
        self.pos: Optional[torch.Tensor] = None  # int32 scalar
        self.cache: Optional[tuple] = None
        self.cross: Optional[tuple] = None
        self.logits: Optional[torch.Tensor] = None  # the graph's output
        self.graph = None
        self.counts: Dict[tuple, int] = {}

    def start(self, dec, batch: int, max_len: int, base: int):
        """The zeroed self cache and the position ``base`` for a batch:
        allocated at the first, reused after. Returns (pos, cache)."""
        if self.cache is None:
            self.cache = dec.init_cache(batch, max_len)
            dev = self.cache[0].device
            self.pos = torch.zeros((), dtype=torch.int32, device=dev)
            self.token = torch.zeros((batch, 1), dtype=torch.int64, device=dev)
        else:
            for buf in self.cache:
                buf.zero_()
        self.pos.fill_(base)
        return self.pos, self.cache

    def keep_cross(self, cross: tuple) -> tuple:
        """The static cross K/V holding ``cross``: the first batch's tensors
        themselves, later ones copied in unless written there already."""
        if self.cross is None:
            self.cross = tuple(cross)
        elif any(a is not b for a, b in zip(cross, self.cross)):
            for buf, x in zip(self.cross, cross):
                buf.copy_(x)
        return self.cross

    def _owns(self, pos, cache, cross) -> bool:
        same = lambda xs, ys: len(xs) == len(ys) and all(a is b for a, b in zip(xs, ys))
        return pos is self.pos and same(tuple(cache), self.cache) and same(tuple(cross), self.cross)

    def step(self, dec, token: torch.Tensor, pos, cache, cross, qw=None):
        """``TSDecoder.step`` of ``token`` over this graph's own operands:
        the first call runs the step and captures it, every later one
        replays it. Returns (logits, cache)."""
        if not self._owns(pos, cache, cross):
            raise ValueError("a step graph runs over its own position, self cache and cross K/V")
        self.token.copy_(token)
        if self.graph is None:
            return self._capture(dec, qw)
        with annotate("rsq:decode.graph_replay"):
            self.graph.replay()
        for (fn, attr), n in self.counts.items():
            setattr(fn, attr, getattr(fn, attr) + n)
        return self.logits, self.cache

    def _capture(self, dec, qw):
        td = dec.decoder

        def run():
            return td.step(td.embed(self.token), self.pos, self.cache, self.cross, qw=qw)[0]

        cur = torch.cuda.current_stream(self.token.device)
        side = torch.cuda.Stream(self.token.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            logits = run()  # the warm-up, a real step
        before = {(fn, a): getattr(fn, a) for fn, attrs in KERNEL_COUNTERS for a in attrs}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.logits = run()
            finally:
                graph.capture_end()
        self.counts = {c: getattr(*c) - n for c, n in before.items() if getattr(*c) != n}
        for (fn, attr), n in before.items():  # the capture launched nothing
            setattr(fn, attr, n)
        cur.wait_stream(side)
        logits.record_stream(cur)
        self.graph = graph
        return logits, self.cache


class StepGraphs:
    """At most one live ``StepGraph`` for a built decoder."""

    def __init__(self):
        self.live: Optional[StepGraph] = None

    def get(self, key: Tuple[int, ...]) -> StepGraph:
        """The live graph of shape ``key``, or a new one in its place."""
        if self.live is None or self.live.key != key:
            self.live = None  # released before the new one allocates
            self.live = StepGraph(key)
        return self.live
