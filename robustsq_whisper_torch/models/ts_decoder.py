"""Speaker-prompted Whisper text decoder.

Mirrors ``TSDecoder`` of the JAX package's ``models/ts_decoder.py``. The
training ``forward`` runs [<|startofprev|>; speaker prompt; targets]
teacher-forced and causally masked, and returns the logits of the target
positions only. For decoding, the prefill runs [<|startofprev|>; speaker
prompt; init tokens] once over the KV cache, then ``step`` extends one token
at a time (or M tokens at per-row positions, the speculative verify, on the
5-D cache), with the W8A8 step weights of ``quantize_step_weights`` when
given them, eagerly or as the replay of the greedy loop's CUDA graph
(``decode/step_graph.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .whisper.config import WhisperDims
from .whisper.modules import TextDecoder
from .whisper.modules import quantize_step_weights as _quantize_step_weights

STARTOFPREV = 50361  # <|startofprev|>


class TSDecoder(nn.Module):
    def __init__(
        self,
        dims: WhisperDims,
        startofprev_token: int = STARTOFPREV,
        use_spk_prompt: bool = True,
        cross_kv_bits: int = 8,
        self_kv_bits: int = 16,
        flat_self_cache: bool = True,
        tmin_self_cache: bool = False,
        remat: bool = False,
        sequence_parallel: bool = False,
    ):
        super().__init__()
        self.dims = dims
        self.startofprev_token = startofprev_token
        self.use_spk_prompt = use_spk_prompt
        self.decoder = TextDecoder(
            dims, cross_kv_bits=cross_kv_bits, self_kv_bits=self_kv_bits,
            flat_self_cache=flat_self_cache, tmin_self_cache=tmin_self_cache,
            remat=remat, sequence_parallel=sequence_parallel,
        )

    def _prefixed(self, tokens: torch.Tensor, spk_prompt: Optional[torch.Tensor]):
        """Embeddings of [startofprev; spk_prompt; tokens] (the prompt
        broadcast over the batch) and the prefix length."""
        b = tokens.shape[0]
        tok_emb = self.decoder.embed(tokens)
        if not (self.use_spk_prompt and spk_prompt is not None):
            return tok_emb, 0
        if spk_prompt.shape[0] != b:
            spk_prompt = spk_prompt.expand(b, *spk_prompt.shape[1:])
        sop = torch.full(
            (b, 1), self.startofprev_token, dtype=tokens.dtype, device=tokens.device
        )
        x_emb = torch.cat(
            [self.decoder.embed(sop), spk_prompt.to(tok_emb.dtype), tok_emb], dim=1
        )
        return x_emb, 1 + spk_prompt.shape[1]

    def forward(
        self,
        memory: torch.Tensor,  # (batch, src, n_state) encoder output
        ys_in: torch.Tensor,  # (batch, tgt_len) sos-prefixed targets
        spk_prompt: Optional[torch.Tensor],  # (batch, n_q, n_state)
    ) -> torch.Tensor:
        """Training forward: f32 logits (batch, tgt_len, vocab) of the
        target positions (the prefix sliced off)."""
        x_emb, prefix = self._prefixed(ys_in, spk_prompt)
        hidden = self.decoder.forward_embedded(x_emb, memory)
        return self.decoder.logits(hidden)[:, prefix:]

    def cross_kv(self, memory: torch.Tensor, quantize: bool = False, out=None):
        return self.decoder.cross_kv(memory, quantize=quantize, out=out)

    def quantize_cross(self, cross):
        return self.decoder.quantize_cross(cross)

    def init_cache(self, batch: int, max_len: int, layout: Optional[str] = None):
        return self.decoder.init_cache(batch, max_len, layout=layout)

    def prefill(
        self,
        init_tokens: torch.Tensor,  # (batch, n_init)
        spk_prompt: Optional[torch.Tensor],  # (batch, n_q, n_state)
        cache,
        cross,
    ):
        """Run [startofprev; spk_prompt; init_tokens] once, filling the
        cache. The next ``step`` uses ``pos = prompt_len + n_init``."""
        return self.decoder.prefill(self._prefixed(init_tokens, spk_prompt)[0], cache, cross)

    def check_self_cache(self) -> None:
        """Raise for a self cache width the decoder has no layout for."""
        self.decoder.check_self_cache()

    def step(
        self,
        token: torch.Tensor,
        pos: torch.Tensor,
        cache,
        cross,
        beam_group: int = 1,  # beams per utterance sharing quantized cross
        row_map=None,  # deferred beam reorder: physical row per logical row
        settled=None,  # deferred beam reorder: settled-prefix length
        defer_window: int = 8,
        qw=None,  # int8 step weights (quantize_step_weights)
        graph=None,  # decode.step_graph.StepGraph: replay it instead
    ):
        """token: (batch, M) ids; pos: device int32 scalar position, or a
        (batch,) vector of per-row positions of the first token. With
        ``graph`` (the greedy loop's, over its own ``pos``, cache and
        cross K/V) the step is that graph's replay, and the logits its
        output buffer."""
        if graph is not None:
            return graph.step(self, token, pos, cache, cross, qw=qw)
        return self.decoder.step(
            self.decoder.embed(token), pos, cache, cross,
            beam_group=beam_group, row_map=row_map, settled=settled,
            defer_window=defer_window, qw=qw,
        )


def quantize_step_weights(dec: TSDecoder) -> dict:
    """Int8 decode-step weights of a TSDecoder
    (``whisper.modules.quantize_step_weights``), computed once when a
    decoder is built; prefill and training keep the dense weights."""
    return _quantize_step_weights(dec.decoder)
