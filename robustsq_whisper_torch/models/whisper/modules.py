"""Whisper encoder and decoder as PyTorch modules, for serving and
training.

Mirrors the JAX package's ``models/whisper/modules.py``: pre-LN residual
attention blocks, GELU MLPs, sinusoidal audio positions, learned text
positions and tied-embedding logits. Parameters live in the model dtype
(bf16 on the card); matmuls run in it, layer norms and softmax in f32.

The decode path keeps the JAX package's tensor contracts so the same
tensors can be fed to both:

- cross K/V: dense (layers, b, T, heads, hd), or the quantized 6-tuple
  (k_q, k_s, v_q, v_s, v_zp, kv_len) with K/V transposed to
  (layers, b, heads, hd[/2], T_pad);
- self K/V, four layouts (``TextDecoder._cache_layout``): the flat
  (layers, b, T_pad, n_state) cache, dense or int8 (int8 K/V and one bf16
  (layers, b, T_pad, 128) scale leaf, ``quantize_flat_kv``); the
  time-minor (layers, b, heads, hd, T_pad) cache; and the 5-D (layers, b,
  T, heads, hd) cache, dense or int8 (k8, k_scales, v8, v_scales) with f32
  per-(row, position, head) scales. Only the 5-D cache takes ragged
  per-row positions and multi-token (speculative verify) steps;
- beam search: the decode rows are (batch, beam) flattened, row ``i * k +
  j`` for utterance ``i`` and beam ``j``; the quantized cross K/V stays at
  batch rows and ``beam_group=k`` lets each utterance's beams share it;
  the deferred beam reorder reads the settled prefix through ``row_map``.

Training: the encoder self-attention takes the row-major flash route
(``use_flash`` without ``flash_tmaj``, no mask, T >= 256: the differentiable
``flash_attention``); ``TextDecoder.forward_embedded`` is the teacher-forced
forward; ``remat`` recomputes each block in the backward
(``torch.utils.checkpoint``, non-reentrant) when gradients are on. A
``Linear`` may carry LoRA factors (``train/lora.py``), which its forward adds
to the weight.

The 5-D cache's attention is plain PyTorch, as it is plain XLA in JAX; its
int8 dots run in f32 on the int8 values, exact because every sum stays
below 2^24 (127 * 127 * 64 for a score, 127 * 127 * the live positions for
a V sum: the masked weights quantize to 0).

W8A8 serving: ``quantize_step_weights`` and ``quantize_encoder_weights``
quantize every dense matmul of the decode step (and the tied logits) or of
the encoder blocks to int8 once; ``qw`` then routes those matmuls through
``ops.quant.qmatmul`` (the ``w8a8_matmul`` kernel on the card): every
decode step layout, the multi-token verify, and the encoder blocks, whose
self-attention then takes ``attend`` (the row-major flash route) rather
than the transposed one, as the JAX package's does. Cross-attention K/V,
prefill and training stay dense.

Multi-GPU (``parallel/shard.py``): a ``Linear`` with ``tp`` set is
column-parallel (``tp.dim`` 0: its input enters the tensor-parallel region
through ``copy_to``) or row-parallel (``tp.dim`` 1: its partial output is
all-reduced, then the bias added); attention keeps ``n_head`` local heads;
a ``TextDecoder`` with ``vocab_tp`` looks tokens up in its vocabulary rows
(the others masked, then all-reduced) and all-gathers its logits. With
``sequence_parallel`` and a model group whose size divides the length, the
blocks of ``AudioEncoder.run_blocks`` and ``TextDecoder.forward_embedded``
hold the residual stream as (b, T / n_model, C) on each rank: a block
all-gathers its layer norms' outputs along the sequence before the column
Linears, its row Linears reduce-scatter instead of all-reducing, and its
layer norms and row biases reduce their gradients over the group.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.attention import causal_mask, dot_product_attention
from ...ops.decode_attention import (
    decode_cross_attention,
    pack_int4,
    unpack_int4,
)
from ...ops.flash_attention import flash_attention, flash_attention_tmaj_rows
from ...ops.quant import qmatmul, quantize_activation, quantize_weight
from ...ops.self_attention import (
    BLOCK_POS,
    decode_self_attention,
    decode_self_attention_tmin,
    deferred_self_attention,
    quantize_flat_kv,
)
from ...parallel import collectives
from ...parallel.mesh import gather_seq, sequence_parallel, shard_seq, sp_applies, sp_group
from .config import WhisperDims, sinusoids

Cache = Tuple[torch.Tensor, ...]
CrossKV = Tuple[torch.Tensor, ...]


class LayerNorm(nn.Module):
    """LayerNorm computed in f32 whatever the parameter dtype; f32 out."""

    def __init__(self, n: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight, self.bias
        sp = sp_group()
        if sp is not None:  # over this rank's positions: a partial gradient
            w, b = collectives.copy_to(w, sp), collectives.copy_to(b, sp)
        return F.layer_norm(x.float(), w.shape, w.float(), b.float(), self.eps)


class Linear(nn.Linear):
    """``nn.Linear`` that casts its input to the weight dtype (the compute
    dtype), like a flax Dense with ``dtype`` set.

    ``lora``: None, or LoRA factors ``(a (in, r), b (r, out), scale)``
    attached by ``train.lora.attach_lora``; the layer then computes with
    ``weight + scale * (a @ b)^T``, the JAX package's ``merge_lora`` on a
    (in, out) kernel. They are not parameters of the module.

    ``tp``: None, or the ``parallel.shard.Split`` of a tensor-parallel
    weight (the module docstring); the LoRA delta is then sliced like the
    weight."""

    lora = None
    tp = None

    def effective_weight(self) -> torch.Tensor:
        if self.lora is None:
            return self.weight
        a, b, scale = self.lora
        delta = (a @ b).t() * scale
        if self.tp is not None:
            delta = self.tp.take(delta)
        return (self.weight.float() + delta).to(self.weight.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.weight.dtype)
        tp = self.tp
        if tp is None:
            return F.linear(x, self.effective_weight(), self.bias)
        if tp.dim == 0:  # column-parallel
            return F.linear(collectives.copy_to(x, tp.group), self.effective_weight(), self.bias)
        y = F.linear(x, self.effective_weight())  # row-parallel: a partial sum
        sp = sp_group()
        if sp is None:
            y = collectives.reduce_from(y, tp.group)
            return y if self.bias is None else y + self.bias
        y = collectives.reduce_scatter(y, 1, sp)
        return y if self.bias is None else y + collectives.copy_to(self.bias, sp)


def gelu(x: torch.Tensor, approx: bool) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if approx else "none")


def _proj(lin: Linear, x: torch.Tensor, w=None) -> torch.Tensor:
    """``lin(x)``, or with ``w`` = (int8 weight, scales, f32 bias or None)
    the W8A8 product of ``x`` cast to ``lin``'s dtype, in that dtype."""
    x = x.to(lin.weight.dtype)
    return lin(x) if w is None else qmatmul(x, *w, out_dtype=x.dtype)


def _quant_dense(lin: Linear):
    """Per-output-channel int8 (weight, f32 scales, f32 bias or None) of one
    Linear, its LoRA factors merged."""
    w_q, scale = quantize_weight(lin.effective_weight())
    bias = None if lin.bias is None else lin.bias.detach().to(torch.float32, copy=True)
    return w_q, scale, bias


def _quant_attn(attn: "MultiHeadAttention", names) -> dict:
    return {n: _quant_dense(getattr(attn, n)) for n in names}


@torch.no_grad()
def quantize_step_weights(decoder: "TextDecoder") -> dict:
    """Int8 weights of every dense matmul the decode ``step`` runs:
    ``{"layers": [per block {"attn": q/k/v/out, "cross": q/out, "fc1",
    "fc2"}], "emb": (int8 (n_vocab, n_state), f32 (n_vocab,))}``, each
    matmul's entry (int8 (out, in), f32 (out,) scales, f32 bias or None for
    the key). The cross K/V projections run on the encoder memory once a
    decode (and are quantized by ``quantize_cross``); the tied embedding is
    quantized per row for the logits. Computed once when a decoder is
    built; prefill and training keep the dense weights."""
    layers = [
        {
            "attn": _quant_attn(b.attn, ("query", "key", "value", "out")),
            "cross": _quant_attn(b.cross_attn, ("query", "out")),
            "fc1": _quant_dense(b.mlp_fc1),
            "fc2": _quant_dense(b.mlp_fc2),
        }
        for b in decoder.blocks
    ]
    return {"layers": layers, "emb": quantize_weight(decoder.token_embedding.weight)}


@torch.no_grad()
def quantize_encoder_weights(encoder: "AudioEncoder") -> dict:
    """Int8 weights of the encoder blocks' self q/k/v/out and MLP, in
    ``quantize_step_weights``' form (``{"layers": [...]}``); the conv stem,
    positions and layer norms stay dense. Inference only."""
    return {"layers": [
        {
            "attn": _quant_attn(b.attn, ("query", "key", "value", "out")),
            "fc1": _quant_dense(b.mlp_fc1),
            "fc2": _quant_dense(b.mlp_fc2),
        }
        for b in encoder.blocks
    ]}


def _qw(qw, name: str):
    return None if qw is None else qw[name]


def quantize_kv_tensors(
    k: torch.Tensor,  # (..., T, heads, head_dim), leading axes preserved
    v: torch.Tensor,
    bits: int = 8,
    pad_to: int = 512,
):
    """Quantize projected K/V to the transposed decode layout: (k_q, k_s,
    v_q, v_s, v_zp, kv_len), k_q/v_q of shape (..., heads, head_dim[/2],
    T_padded). Asymmetric per channel: K's zero-point is softmax-invariant
    and dropped; V's folds outside the attention (``out * v_s + v_zp``)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    kv_len = k.shape[-3]
    pad = (-kv_len) % pad_to
    qmax = 127.0 if bits == 8 else 7.0

    def quant(t):
        tt = t.movedim(-3, -1).float()  # (..., h, d, T)
        hi = tt.amax(dim=-1)
        lo = tt.amin(dim=-1)
        zp = (hi + lo) * 0.5
        scale = torch.clamp((hi - lo) * (0.5 / qmax), min=1e-8)
        q8 = torch.round((tt - zp[..., None]) / scale[..., None]).to(torch.int8)
        if bits == 4:
            q8 = pack_int4(q8)
        if pad:
            q8 = F.pad(q8, (0, pad))
        return q8.contiguous(), scale, zp

    k_q, k_s, _ = quant(k)
    v_q, v_s, v_zp = quant(v)
    kv = torch.tensor(kv_len, dtype=torch.int32, device=k.device)
    return k_q, k_s, v_q, v_s, v_zp, kv


class MultiHeadAttention(nn.Module):
    """Whisper attention: q/v/out with bias, k without."""

    def __init__(
        self, n_state: int, n_head: int, use_flash: bool = False,
        flash_tmaj: bool = False, kv_bits: int = 8,
    ):
        super().__init__()
        self.n_state, self.n_head = n_state, n_head
        self.head_dim = n_state // n_head
        self.use_flash, self.flash_tmaj, self.kv_bits = use_flash, flash_tmaj, kv_bits
        self.query = Linear(n_state, n_state)
        self.key = Linear(n_state, n_state, bias=False)
        self.value = Linear(n_state, n_state)
        self.out = Linear(n_state, n_state)

    @property
    def dtype(self) -> torch.dtype:
        return self.query.weight.dtype

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        return x.reshape(b, t, -1, self.head_dim)

    def _merge(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(x.shape[0], x.shape[1], -1)

    def kv(self, src: torch.Tensor):
        """Keys and values of ``src``: 2x (batch, len, heads, head_dim)."""
        return self._split(self.key(src)), self._split(self.value(src))

    def kv_quant(self, src: torch.Tensor, pad_to: int = 512):
        """Quantized transposed K/V of ``src`` (see quantize_kv_tensors)."""
        return quantize_kv_tensors(
            *self.kv(src), bits=self.kv_bits, pad_to=pad_to
        )

    def attend_quant(
        self,
        x: torch.Tensor,  # (batch, q_len, n_state)
        k_q: torch.Tensor,  # ([layers,] batch, heads, hd[/2], T_pad)
        k_s: torch.Tensor,  # (batch, heads, hd)
        v_q: torch.Tensor,
        v_s: torch.Tensor,
        v_zp: torch.Tensor,
        kv_len: torch.Tensor,  # int32 scalar
        layer_idx=None,
        beam_group: int = 1,  # beams per utterance sharing this K/V
        qw: Optional[dict] = None,  # int8 q/out weights
    ) -> torch.Tensor:
        """Cross attention over the quantized K/V: the decode kernel at
        q_len 1, a plain einsum over unpacked K/V for a prefill or a
        speculative verify chunk. ``qw`` runs the q and out projections
        W8A8.

        ``layer_idx``: the layer of stacked K/V, a device int32 scalar for
        the kernel, a Python int (a view of the slab) for a multi-token
        query.

        ``beam_group=k``: x has batch*k beam-flattened rows while the K/V
        keep batch rows, and each utterance's k beams attend one shared
        K/V read (the kernel's grouped mode)."""
        q = self._split(_proj(self.query, x, _qw(qw, "query")))  # (b, q, h, hd)
        dt = self.dtype
        out = lambda o: _proj(self.out, self._merge(o.to(dt)), _qw(qw, "out"))
        if x.shape[1] == 1:
            g = beam_group
            q1 = q[:, 0]  # (b*g, h, hd)
            if g > 1:
                bk, h, hd = q1.shape
                q1 = q1.reshape(bk // g, g, h, hd).transpose(1, 2)
            o = decode_cross_attention(
                q1, k_q, v_q, k_s, kv_len=kv_len, layer_idx=layer_idx,
                packed_int4=self.kv_bits == 4, group=g,
            )  # (b, h, hd) or (b, h, g, hd); v_s / v_zp applied here
            if g > 1:
                o = o.transpose(1, 2).float() * v_s[:, None] + v_zp[:, None]
                return out(o.reshape(-1, 1, *o.shape[2:]))  # (b*g, 1, h, hd)
            return out((o.float() * v_s + v_zp)[:, None])
        if beam_group != 1:
            raise ValueError("beam grouping is for the one-token decode step")
        if layer_idx is not None:
            k_q, v_q = k_q[layer_idx], v_q[layer_idx]
        if self.kv_bits == 4:
            k_q, v_q = unpack_int4(k_q), unpack_int4(v_q)
        qf = q.float() * (k_s[:, None].float() * q.shape[-1] ** -0.5)
        # operands rounded to the compute dtype, products summed in f32
        scores = torch.einsum(
            "bqhd,bhdk->bhqk", qf.to(dt).float(), k_q.to(dt).float()
        )
        valid = torch.arange(k_q.shape[-1], device=x.device) < kv_len
        scores = scores.masked_fill(~valid, -1e30)
        w = torch.softmax(scores, dim=-1)
        o = torch.einsum(
            "bhqk,bhdk->bqhd", w.to(dt).float(), v_q.to(dt).float()
        )
        return out(o * v_s[:, None].float() + v_zp[:, None].float())

    def attend(
        self,
        x: torch.Tensor,
        k: torch.Tensor,
        v: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        qw: Optional[dict] = None,  # int8 q/out weights
    ) -> torch.Tensor:
        q = self._split(_proj(self.query, x, _qw(qw, "query")))
        if self.use_flash and mask is None and q.shape[1] >= 256:
            o = flash_attention(q, k, v)
        else:
            o = dot_product_attention(q, k, v, mask=mask)
        return _proj(self.out, self._merge(o), _qw(qw, "out"))

    def self_attend_tmaj(self, x: torch.Tensor) -> torch.Tensor:
        """Self-attention through the transposed-layout kernel: each
        projection is one 2-D GEMM ``w @ x.t()`` whose channel-major
        (n_state, b*T) output the kernel reads per head through strides,
        adding the query and value biases itself, and the kernel's
        row-major (b, T, n_state) output feeds the out-projection: no copy
        or bias add between the GEMMs and the kernel."""
        b, t, c = x.shape
        h, d = self.n_head, self.n_state // self.n_head
        x2 = x.to(self.dtype).reshape(b * t, c)

        def proj(lin: Linear) -> torch.Tensor:
            y = torch.mm(lin.effective_weight(), x2.t())  # (n_state, b*T)
            return y.view(h, d, b, t).permute(2, 0, 1, 3)  # (b, h, d, T) view

        o = flash_attention_tmaj_rows(
            proj(self.query), proj(self.key), proj(self.value),
            self.query.bias, self.value.bias,
        )
        return F.linear(o, self.out.effective_weight(), self.out.bias)

    def forward(
        self,
        x: torch.Tensor,
        xa: Optional[torch.Tensor] = None,
        mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        if (
            self.flash_tmaj and self.use_flash and xa is None
            and mask is None and x.shape[1] >= 256 and self.query.tp is None
        ):
            return self.self_attend_tmaj(x)
        k, v = self.kv(x if xa is None else xa)
        return self.attend(x, k, v, mask=mask)


class ResidualAttentionBlock(nn.Module):
    def __init__(
        self, n_state: int, n_head: int, cross_attention: bool = False,
        use_flash: bool = False, flash_tmaj: bool = False,
        cross_kv_bits: int = 8, gelu_approx: bool = False,
    ):
        super().__init__()
        self.n_head = n_head
        self.gelu_approx = gelu_approx
        self.attn_ln = LayerNorm(n_state)
        self.attn = MultiHeadAttention(
            n_state, n_head, use_flash, flash_tmaj=flash_tmaj
        )
        self.cross_attention = cross_attention
        if cross_attention:
            self.cross_attn_ln = LayerNorm(n_state)
            self.cross_attn = MultiHeadAttention(
                n_state, n_head, kv_bits=cross_kv_bits
            )
        self.mlp_ln = LayerNorm(n_state)
        self.mlp_fc1 = Linear(n_state, 4 * n_state)
        self.mlp_fc2 = Linear(4 * n_state, n_state)

    def _cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.mlp_fc1.weight.dtype)

    def _mlp(self, x: torch.Tensor, qw: Optional[dict] = None) -> torch.Tensor:
        hid = gelu(_proj(self.mlp_fc1, x, _qw(qw, "fc1")), self.gelu_approx)
        return _proj(self.mlp_fc2, hid, _qw(qw, "fc2"))

    def forward(
        self,
        x: torch.Tensor,
        xa: Optional[torch.Tensor] = None,
        mask: Optional[torch.Tensor] = None,
        qw: Optional[dict] = None,
        sp=None,
    ) -> torch.Tensor:
        """Full-sequence block. ``qw`` (one layer of
        ``quantize_encoder_weights``) runs the self-attention projections
        and the MLP W8A8, the attention itself through ``attend``;
        cross-attention stays dense. ``sp``: the model group of a
        sequence-parallel block, whose ``x`` is this rank's chunk of the
        sequence (the module docstring)."""
        with sequence_parallel(sp):
            full = (lambda t: gather_seq(t, sp)) if sp is not None else (lambda t: t)
            h = full(self._cast(self.attn_ln(x)))
            if qw is None:
                x = x + self.attn(h, mask=mask)
            else:
                a = qw["attn"]
                k = self.attn._split(_proj(self.attn.key, h, a["key"]))
                v = self.attn._split(_proj(self.attn.value, h, a["value"]))
                x = x + self.attn.attend(h, k, v, mask=mask, qw=a)
            if self.cross_attention:
                x = x + self.cross_attn(full(self._cast(self.cross_attn_ln(x))), xa=xa)
            return x + self._mlp(full(self._cast(self.mlp_ln(x))), qw)

    def _cross(
        self, x: torch.Tensor, cross: CrossKV,
        layer_idx: Optional[torch.Tensor] = None, beam_group: int = 1,
        qw: Optional[dict] = None,
    ) -> torch.Tensor:
        h = self._cast(self.cross_attn_ln(x))
        if len(cross) == 6:  # quantized transposed cross K/V
            return x + self.cross_attn.attend_quant(
                h, *cross, layer_idx=layer_idx, beam_group=beam_group, qw=qw
            )
        return x + self.cross_attn.attend(h, *cross, qw=qw)

    def prefill_news(
        self, x: torch.Tensor, mask: torch.Tensor, cross: CrossKV
    ):
        """Multi-token prefix through the block; returns the new x and the
        prefix's (k, v), each (batch, len, heads, hd), for the cache."""
        h = self._cast(self.attn_ln(x))
        k_new, v_new = self.attn.kv(h)
        x = x + self.attn.attend(h, k_new, v_new, mask=mask)
        x = self._cross(x, cross)
        x = x + self._mlp(self._cast(self.mlp_ln(x)))
        return x, (k_new, v_new)

    def _finish(
        self, x: torch.Tensor, o: torch.Tensor, cross: CrossKV,
        layer_idx, beam_group: int, qw: Optional[dict] = None,
    ) -> torch.Tensor:
        """The rest of a decode step after the self attention's merged
        (batch, M, n_state) output: out projection, cross attention, MLP.
        ``layer_idx`` picks the slab of stacked quantized cross K/V; ``qw``
        (one layer of ``quantize_step_weights``) runs every matmul W8A8."""
        x = x + _proj(self.attn.out, o, None if qw is None else qw["attn"]["out"])
        x = self._cross(
            x, cross, layer_idx=layer_idx if len(cross) == 6 else None,
            beam_group=beam_group, qw=_qw(qw, "cross"),
        )
        return x + self._mlp(self._cast(self.mlp_ln(x)), qw)

    def _self_proj(self, h: torch.Tensor, qw: Optional[dict]):
        """The self-attention's q, k and v of ``h``, each (b, M, n_state)."""
        a = _qw(qw, "attn")
        return tuple(
            _proj(getattr(self.attn, n), h, _qw(a, n)) for n in ("query", "key", "value")
        )

    def step_packed(
        self,
        x: torch.Tensor,  # (batch, 1, n_state)
        cache: Cache,  # every layer's flat or time-minor leaves
        layout: str,  # "flat" or "tmin"
        layer: int,
        layer_idx: torch.Tensor,  # device int32 scalar == layer
        pos: torch.Tensor,  # device int32 scalar
        pos_index: torch.Tensor,  # (1,) int64 copy of pos, for the write
        cross: CrossKV,
        beam_group: int = 1,
        row_map: Optional[torch.Tensor] = None,
        settled: Optional[torch.Tensor] = None,
        defer_window: int = 8,
        qw: Optional[dict] = None,
    ) -> torch.Tensor:
        """One decode token through the block over the flat cache (dense
        or int8, through the kernel) or the time-minor one (through the
        cross kernel's state), with ``row_map`` the deferred-beam-reorder
        read of the dense flat cache (settled prefix through the row
        indirection, the window and the new token merged)."""
        h = self._cast(self.attn_ln(x))
        qf, kf, vf = (p[:, 0] for p in self._self_proj(h, qw))
        b = qf.shape[0]
        if row_map is not None:
            o = deferred_self_attention(
                qf, kf, vf, cache, pos, settled, row_map, layer_idx,
                heads=self.n_head, window=defer_window,
            )
        elif layout == "tmin":
            as3 = lambda t: t.reshape(b, self.n_head, -1)
            o = decode_self_attention_tmin(
                as3(qf), as3(kf), as3(vf), cache, pos, layer_idx
            ).reshape(b, -1)
        else:
            o = decode_self_attention(
                qf, kf, vf, cache, pos, layer_idx, heads=self.n_head
            )
        # The new entries go into the cache in place, right after this
        # layer's read: the read covers only [0, pos) and merges the new
        # token from its own operands, so this equals the JAX package's one
        # write of every layer's entries after the layer scan (the int8
        # form's scales are per row and head, so quantizing one layer's row
        # gives the same values as quantizing all layers at once).
        if layout == "tmin":
            for buf, new in zip(cache, (kf, vf)):
                buf[layer].index_copy_(3, pos_index, as3(new)[..., None])
        else:
            news = (kf, vf) if len(cache) == 2 else quantize_flat_kv(kf, vf, self.n_head)
            for buf, new in zip(cache, news):
                buf[layer].index_copy_(1, pos_index, new[:, None])
        return self._finish(x, o[:, None], cross, layer_idx, beam_group, qw)

    @staticmethod
    def _new_v(w_new: torch.Tensor, v_new: torch.Tensor) -> torch.Tensor:
        """The new tokens' V contribution: (b, h, q, m) weights x (b, m, h,
        d) values, elementwise at q = m = 1 as the JAX package does."""
        if w_new.shape[-1] == 1:
            return w_new.transpose(1, 2) * v_new.float()
        return torch.einsum("bhqm,bmhd->bqhd", w_new, v_new.float())

    @staticmethod
    def _quantize_cache_entry(t: torch.Tensor):
        """(b, M, h, d) -> (int8 values, per-(b, position, h) f32 scales)."""
        t8, sc = quantize_activation(t)
        return t8, sc[..., 0]

    def step_5d(
        self,
        x: torch.Tensor,  # (batch, M, n_state)
        cache: Cache,  # this layer's (k, v) or (k8, k_s, v8, v_s)
        pos: torch.Tensor,  # device int32 scalar, or (batch,) per-row
        cross: CrossKV,
        layer_idx,  # stacked quantized cross K/V: device scalar or int
        beam_group: int = 1,
        qw: Optional[dict] = None,
    ):
        """M decode tokens through the block over this layer's slice of
        the 5-D cache, which is only read: returns the new x and the new
        entries, (b, M, h, hd) each (and (b, M, h) f32 scales in the int8
        form), for the caller to write. The M new tokens attend the live
        prefix [0, pos) of their row and each other causally."""
        q_len = x.shape[1]
        h = self._cast(self.attn_ln(x))
        q, k_new, v_new = (self.attn._split(p) for p in self._self_proj(h, qw))
        scale = q.shape[-1] ** -0.5
        quant = len(cache) == 4
        if quant:
            ck8, cks, cv8, cvs = cache  # (b, T, h, hd) int8, (b, T, h) f32
            max_len = ck8.shape[1]
            q8, q_sc = quantize_activation(q)  # q_sc (b, M, h, 1)
            s32 = torch.einsum("bqhd,bkhd->bhqk", q8.float(), ck8.float())
            k_sc = cks.transpose(1, 2)[:, :, None, :]  # (b, h, 1, k)
            s_pref = s32 * q_sc.transpose(1, 2) * k_sc * scale
        else:
            ck, cv = cache
            max_len = ck.shape[1]
            s_pref = torch.einsum("bqhd,bkhd->bhqk", q.float(), ck.float()) * scale
        # live prefix: a scalar pos gives one (1, k) mask, a vector a per-row one
        t_idx = torch.arange(max_len, device=x.device)
        live = t_idx < (pos[:, None] if pos.dim() else pos)
        s_pref = torch.where(live.reshape(-1, 1, 1, max_len), s_pref, -1e30)
        s_new = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_new.float()) * scale
        if q_len > 1:  # the M new tokens attend each other causally
            tri = torch.ones(q_len, q_len, dtype=torch.bool, device=x.device).tril()
            s_new = torch.where(tri, s_new, -1e30)
        w = torch.softmax(torch.cat([s_pref, s_new], dim=-1), dim=-1)
        if quant:
            # the V scales fold into the weights, which are quantized so
            # that the V sum is an int8 dot
            wp = w[..., :max_len] * cvs.transpose(1, 2)[:, :, None, :]
            w8, w_sc = quantize_activation(wp)  # w_sc (b, h, q, 1)
            o32 = torch.einsum("bhqk,bkhd->bqhd", w8.float(), cv8.float())
            o = o32 * w_sc.transpose(1, 2) + self._new_v(w[..., max_len:], v_new)
        else:
            o = torch.einsum(
                "bhqk,bkhd->bqhd", w[..., :max_len].to(cv.dtype).float(), cv.float()
            ) + self._new_v(w[..., max_len:], v_new)
        x = self._finish(x, self.attn._merge(o), cross, layer_idx, beam_group, qw)
        if quant:
            news = self._quantize_cache_entry(k_new) + self._quantize_cache_entry(v_new)
        else:
            news = (k_new, v_new)
        return x, news


def _run_block(block: nn.Module, remat: bool, *args) -> torch.Tensor:
    """``block(*args)``, recomputed in the backward (non-reentrant
    checkpoint) when ``remat`` is set and gradients are on."""
    if remat and torch.is_grad_enabled():
        return checkpoint(block, *args, use_reentrant=False)
    return block(*args)


class AudioEncoder(nn.Module):
    """Whisper audio encoder with the conv stem and the block stack exposed
    separately, so the target-speaker encoder can insert its prompt."""

    def __init__(
        self, dims: WhisperDims, use_flash: bool = False,
        flash_tmaj: bool = False, gelu_approx: bool = False,
        remat: bool = False, sequence_parallel: bool = False,
    ):
        super().__init__()
        self.dims = dims
        self.gelu_approx = gelu_approx
        self.remat = remat
        self.sequence_parallel = sequence_parallel
        self.tp_group = None  # the model group under tensor parallelism
        d = dims.n_audio_state
        self.conv1 = nn.Conv1d(dims.n_mels, d, 3, padding=1)
        self.conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1)
        self.register_buffer(
            "positional_embedding",
            torch.from_numpy(sinusoids(dims.n_audio_ctx, d)),
        )
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(
                d, dims.n_audio_head, use_flash=use_flash,
                flash_tmaj=flash_tmaj, gelu_approx=gelu_approx,
            )
            for _ in range(dims.n_audio_layer)
        )
        self.ln_post = LayerNorm(d)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv1.weight.dtype

    def conv_stem(
        self, mel: torch.Tensor, add_positions: bool = True
    ) -> torch.Tensor:
        """(batch, n_mels, frames) -> (batch, frames // 2, n_state).
        ``add_positions=False`` is the enrollment path."""
        x = gelu(self.conv1(mel.to(self.dtype)), self.gelu_approx)
        x = gelu(self.conv2(x), self.gelu_approx).transpose(1, 2)
        if add_positions:
            x = x + self.positional_embedding[: x.shape[1]].to(x.dtype)
        return x

    def run_blocks(self, x: torch.Tensor, qw: Optional[dict] = None) -> torch.Tensor:
        """The blocks and ``ln_post``; ``qw`` (``quantize_encoder_weights``)
        runs them W8A8 (inference only)."""
        x = x.to(self.dtype)
        sp = self._sp_group(x.shape[1])
        x = shard_seq(x, sp) if sp is not None else x
        for i, block in enumerate(self.blocks):
            if qw is None:
                x = _run_block(block, self.remat, x, None, None, None, sp)
            else:
                x = block(x, qw=qw["layers"][i])
        x = gather_seq(x, sp) if sp is not None else x
        return self.ln_post(x).to(self.dtype)

    def _sp_group(self, length: int):
        """The model group when the blocks run sequence-parallel."""
        ok = self.sequence_parallel and sp_applies(self.tp_group, length)
        return self.tp_group if ok else None

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return self.run_blocks(self.conv_stem(mel))

    @staticmethod
    def output_lengths(ilens: torch.Tensor, max_ctx: int) -> torch.Tensor:
        """Conv2 length formula, clamped to the position budget."""
        return torch.clamp(1 + (ilens - 3 + 2) // 2, max=max_ctx)


class TextDecoder(nn.Module):
    """Whisper text decoder with tied-embedding logits and the KV-cache
    decode path over every self-cache layout."""

    def __init__(
        self, dims: WhisperDims, cross_kv_bits: int = 8,
        self_kv_bits: int = 16, flat_self_cache: bool = True,
        tmin_self_cache: bool = False, remat: bool = False,
        sequence_parallel: bool = False,
    ):
        super().__init__()
        self.dims = dims
        self.remat = remat
        self.sequence_parallel = sequence_parallel
        self.tp_group = None  # the model group under tensor parallelism
        self.vocab_tp = None  # the Split of a vocabulary-parallel embedding
        self.cross_kv_bits = cross_kv_bits
        self.self_kv_bits = self_kv_bits
        self.flat_self_cache = flat_self_cache
        self.tmin_self_cache = tmin_self_cache
        d = dims.n_text_state
        self.token_embedding = nn.Embedding(dims.n_vocab, d)
        self.positional_embedding = nn.Parameter(torch.zeros(dims.n_text_ctx, d))
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(
                d, dims.n_text_head, cross_attention=True,
                cross_kv_bits=cross_kv_bits,
            )
            for _ in range(dims.n_text_layer)
        )
        self.ln = LayerNorm(d)
        # device copies of the layer indices: the kernels read the layer
        # from device memory, so the decode loop never syncs on it
        self.register_buffer(
            "layer_ids",
            torch.arange(dims.n_text_layer, dtype=torch.int32),
            persistent=False,
        )

    @property
    def dtype(self) -> torch.dtype:
        return self.token_embedding.weight.dtype

    def check_self_cache(self) -> None:
        """Raise for a self cache width the decoder has no layout for."""
        if self.self_kv_bits not in (8, 16):
            raise ValueError(
                f"self_kv_bits must be 16 (dense) or 8 (int8), got {self.self_kv_bits}"
            )

    @property
    def _tmin_self(self) -> bool:
        """The time-minor cache is eligible (greedy's default when asked)."""
        d = self.dims
        return (
            self.tmin_self_cache and self.flat_self_cache
            and self.self_kv_bits == 16
            and (d.n_text_state // d.n_text_head) % 8 == 0
        )

    @property
    def _flat_self(self) -> bool:
        """The flat cache is eligible: n_state tiles 128 lanes and, for
        int8, two scales a head fit in one 128-lane row."""
        d = self.dims
        hd = d.n_text_state // d.n_text_head
        return (
            self.flat_self_cache and self.self_kv_bits in (8, 16)
            and d.n_text_state % 128 == 0 and 128 % hd == 0
            and (self.self_kv_bits == 16 or 2 * d.n_text_head <= 128)
        )

    @property
    def default_layout(self) -> str:
        """The layout ``init_cache(layout=None)`` gives: ``tmin``, ``flat``
        or ``5d``."""
        if self._tmin_self:
            return "tmin"
        return "flat" if self._flat_self else "5d"

    @property
    def _flat_quant(self) -> bool:
        """The int8 flat cache: int8 K/V and one bf16 scale leaf."""
        return self._flat_self and self.self_kv_bits == 8

    def _cache_layout(self, cache: Cache) -> str:
        """``flat`` (L, b, T, n_state: 2 dense leaves or 3 int8 + scales),
        ``tmin`` (L, b, heads, hd, T) or ``5d`` (L, b, T, heads, hd)."""
        leaf = cache[0]
        if len(cache) == 3 or leaf.dim() == 4:
            return "flat"
        d = self.dims
        hd = d.n_text_state // d.n_text_head
        if leaf.dim() == 5 and leaf.shape[2] == d.n_text_head and leaf.shape[3] == hd:
            return "tmin"
        return "5d"

    # ---- embedding / logits ----

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        tp = self.vocab_tp
        if tp is None:
            return self.token_embedding(tokens)
        w = self.token_embedding.weight  # this rank's rows of the vocabulary
        local = tokens - tp.rank * w.shape[0]
        inside = (local >= 0) & (local < w.shape[0])
        x = F.embedding(torch.where(inside, local, 0), w)
        x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
        return collectives.reduce_from(x, tp.group)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Tied-embedding output projection, returned in f32. On the card a
        bf16 product is summed and returned in f32 without a bf16 rounding,
        as the JAX einsum's ``preferred_element_type``; PyTorch's CPU
        matmul has no such mode and rounds to the operand dtype. With
        gradients on, the operands are rounded to the compute dtype and
        multiplied in f32 (the same sums, through autograd)."""
        x, w = x.to(self.dtype), self.token_embedding.weight
        tp = self.vocab_tp
        if tp is not None:  # this rank's vocabulary columns, then all of them
            x = collectives.copy_to(x, tp.group)
            return collectives.gather_from(self._logits(x, w), -1, tp.group)
        return self._logits(x, w)

    @staticmethod
    def _logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            return F.linear(x.float(), w.float())
        if x.is_cuda and w.dtype != torch.float32:
            flat = torch.mm(x.reshape(-1, x.shape[-1]), w.t(), out_dtype=torch.float32)
            return flat.reshape(*x.shape[:-1], w.shape[0])
        return F.linear(x, w).float()

    @staticmethod
    def logits_quant(
        x: torch.Tensor, emb_q: torch.Tensor, emb_s: torch.Tensor
    ) -> torch.Tensor:
        """W8A8 tied-embedding logits of the decode step: the per-row int8
        embedding (``quantize_step_weights``) times the dynamically
        quantized hidden states, f32, no bias."""
        return qmatmul(x, emb_q, emb_s)

    # ---- full-sequence forward (training) ----

    def forward_embedded(
        self, x_emb: torch.Tensor, memory: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """The blocks over already-embedded input (positions added here),
        causally masked unless ``mask`` is given; ``ln``-normed hidden
        states in the compute dtype."""
        length = x_emb.shape[1]
        x = (x_emb + self.positional_embedding[:length]).to(self.dtype)
        if mask is None:
            mask = causal_mask(length, device=x.device)
        memory = memory.to(self.dtype)
        sp = None
        if self.sequence_parallel and sp_applies(self.tp_group, length):
            sp = self.tp_group
            x = shard_seq(x, sp)
        for block in self.blocks:
            x = _run_block(block, self.remat, x, memory, mask, None, sp)
        x = gather_seq(x, sp) if sp is not None else x
        return self.ln(x).to(self.dtype)

    def forward(self, tokens: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        """(batch, len) tokens and (batch, src, n_state) memory -> f32 logits."""
        return self.logits(self.forward_embedded(self.embed(tokens), memory))

    # ---- KV-cache decode path ----

    def cross_kv(self, memory: torch.Tensor, quantize: bool = False, out=None):
        """Per-layer K/V of the encoder memory stacked on a leading layer
        axis; ``quantize=True`` gives the quantized 6-tuple. ``out``: the
        tensors of an earlier call of these shapes to stack into (the
        greedy step graph's static cross K/V)."""
        memory = memory.to(self.dtype)
        per_layer = [
            b.cross_attn.kv_quant(memory) if quantize else b.cross_attn.kv(memory)
            for b in self.blocks
        ]
        if out is None:
            return tuple(torch.stack(parts) for parts in zip(*per_layer))
        return tuple(torch.stack(parts, out=o) for parts, o in zip(zip(*per_layer), out))

    def quantize_cross(self, cross: CrossKV):
        """Dense stacked cross K/V -> the quantized decode layout, with
        ``kv_len`` stacked per layer."""
        k, v = cross
        out = quantize_kv_tensors(k, v, bits=self.cross_kv_bits)
        return out[:-1] + (out[-1].expand(k.shape[0]).contiguous(),)

    def init_cache(
        self, batch: int, max_len: int, layout: Optional[str] = None
    ) -> Cache:
        """The self cache, zeros, stacked per layer. ``layout=None`` takes
        the time-minor (L, b, heads, hd, T_pad) cache (T_pad a multiple of
        128) when ``_tmin_self`` holds; else, and with ``"flat"`` (the beam
        decoder), the flat one (L, b, T_pad, n_state) with T_pad a multiple
        of BLOCK_POS (int8: two int8 leaves and the bf16 (L, b, T_pad, 128)
        scale leaf) when the dims allow it, else the 5-D (L, b, max_len,
        heads, hd) one (int8: (k8, k_scales, v8, v_scales), f32 scales per
        (row, position, head))."""
        self.check_self_cache()
        d = self.dims
        hd = d.n_text_state // d.n_text_head
        heads = self.blocks[0].attn.n_head  # this rank's under tensor parallelism
        dev = self.token_embedding.weight.device
        zeros = lambda shape, dtype=self.dtype: torch.zeros(shape, dtype=dtype, device=dev)
        if layout is None and self._tmin_self:
            layout = "tmin"
        if layout not in (None, "tmin", "flat"):
            raise ValueError(f"unknown cache layout {layout!r}")
        if layout == "tmin":
            if not self._tmin_self:
                raise ValueError(
                    "the time-minor cache needs tmin_self_cache, "
                    "flat_self_cache, self_kv_bits 16 and head_dim % 8 == 0"
                )
            t_pad = -(-max_len // 128) * 128
            shape = (d.n_text_layer, batch, d.n_text_head, hd, t_pad)
            return zeros(shape), zeros(shape)
        if self._flat_self:
            pad_len = -(-max_len // BLOCK_POS) * BLOCK_POS
            shape = (d.n_text_layer, batch, pad_len, d.n_text_state)
            if self._flat_quant:
                return (
                    zeros(shape, torch.int8), zeros(shape, torch.int8),
                    zeros(shape[:3] + (128,), torch.bfloat16),
                )
            return zeros(shape), zeros(shape)
        shape = (d.n_text_layer, batch, max_len, heads, hd)
        if self.self_kv_bits == 8:
            return (
                zeros(shape, torch.int8), zeros(shape[:-1], torch.float32),
                zeros(shape, torch.int8), zeros(shape[:-1], torch.float32),
            )
        return zeros(shape), zeros(shape)

    @staticmethod
    def _layer_cross(cross: CrossKV, i: int) -> CrossKV:
        return tuple(c[i] for c in cross)

    def prefill(self, x_emb: torch.Tensor, cache: Cache, cross: CrossKV):
        """Run a multi-token prefix, filling positions [0, len) of the cache
        in place. Returns the f32 logits of the last position and the
        cache."""
        self.check_self_cache()
        b, length, _ = x_emb.shape
        x = (x_emb + self.positional_embedding[:length]).to(self.dtype)
        mask = causal_mask(length, device=x.device)
        cache = tuple(cache)
        layout = self._cache_layout(cache)
        for i, block in enumerate(self.blocks):
            x, (k, v) = block.prefill_news(x, mask, self._layer_cross(cross, i))
            if layout == "tmin":  # (b, len, h, hd) -> time-minor (b, h, hd, len)
                news = (k.permute(0, 2, 3, 1), v.permute(0, 2, 3, 1))
                for buf, new in zip(cache, news):
                    buf[i, ..., :length] = new
                continue
            if layout == "flat":
                news = (k.reshape(b, length, -1), v.reshape(b, length, -1))
                if len(cache) == 3:
                    news = quantize_flat_kv(*news, self.dims.n_text_head)
            elif len(cache) == 4:
                news = (block._quantize_cache_entry(k) + block._quantize_cache_entry(v))
            else:
                news = (k, v)
            for buf, new in zip(cache, news):
                buf[i, :, :length] = new
        x = self.ln(x[:, -1:]).to(self.dtype)
        return self.logits(x)[:, 0], cache

    def step(
        self,
        token_emb: torch.Tensor,  # (batch, M, n_state)
        pos: torch.Tensor,  # device int32 scalar, or (batch,) per row
        cache: Cache,
        cross: CrossKV,
        beam_group: int = 1,
        row_map: Optional[torch.Tensor] = None,
        settled: Optional[torch.Tensor] = None,
        defer_window: int = 8,
        qw: Optional[dict] = None,
    ):
        """One decode step, the cache updated in place. ``pos`` is a scalar
        (every row at one position) or a (batch,) vector of per-row
        positions of the first of the M tokens (speculative decode: draft
        steps and the multi-token verify, 5-D cache only). Returns the f32
        logits, (batch, n_vocab) at M = 1 and (batch, M, n_vocab) else, and
        the cache.

        ``beam_group=k``: token_emb and the cache carry batch*k
        beam-flattened rows while the quantized ``cross`` keeps batch rows
        (``attend_quant``). ``row_map``, ``settled`` and ``defer_window``
        select the deferred-beam-reorder read of the dense flat cache
        (``deferred_self_attention``). ``qw`` (``quantize_step_weights``)
        runs every dense matmul of the step W8A8, the logits included."""
        self.check_self_cache()
        q_len = token_emb.shape[1]
        ragged = pos.dim() > 0
        # t: the positions of the M new tokens, (batch, M) per row or (M,)
        # for every row
        if ragged:
            t = pos.long()[:, None] + torch.arange(q_len, device=pos.device)
            pos_emb = self.positional_embedding[t]
        else:
            t = pos.reshape(1).long()
            if q_len > 1:
                t = t + torch.arange(q_len, device=pos.device)
            pos_emb = self.positional_embedding.index_select(0, t)  # broadcast over rows
        x = (token_emb + pos_emb).to(self.dtype)
        cache = tuple(cache)
        layout = self._cache_layout(cache)
        if (ragged or q_len > 1) and layout != "5d":
            raise ValueError(
                "ragged or multi-token steps (speculative decode) need the 5-D "
                "cache: build the decoder with flat_self_cache=False"
            )
        if row_map is not None and not (layout == "flat" and len(cache) == 2):
            raise ValueError("the deferred beam reorder needs the dense flat cache")
        if beam_group != 1 and len(cross) != 6:
            raise ValueError(
                "beam grouping needs the quantized cross-KV layout; expand "
                "the dense cross K/V across beams instead"
            )
        quantized = len(cross) == 6
        news = []
        for i, block in enumerate(self.blocks):
            if quantized:
                k_q, k_s, v_q, v_s, v_zp, kv_len = cross
                cross_i = (k_q, k_s[i], v_q, v_s[i], v_zp[i], kv_len[i])
            else:
                cross_i = self._layer_cross(cross, i)
            li = self.layer_ids[i]
            qw_i = None if qw is None else qw["layers"][i]
            if layout == "5d":
                x, new = block.step_5d(
                    x, tuple(c[i] for c in cache), pos, cross_i,
                    li if q_len == 1 else i, beam_group=beam_group, qw=qw_i,
                )
                news.append(new)
            else:
                x = block.step_packed(
                    x, cache, layout, i, li, pos, t, cross_i,
                    beam_group=beam_group, row_map=row_map, settled=settled,
                    defer_window=defer_window, qw=qw_i,
                )
        if news:
            # one write a leaf of every layer's (b, M, ...) entries after
            # the layers, as the JAX package does
            rows = torch.arange(pos.shape[0], device=pos.device)[:, None] if ragged else None
            for buf, parts in zip(cache, zip(*news)):
                new = torch.stack(parts).to(buf.dtype)  # (L, b, M, ...)
                if ragged:
                    buf[:, rows, t] = new
                else:
                    buf.index_copy_(2, t, new)
        x = self.ln(x).to(self.dtype)
        logits = self.logits(x) if qw is None else self.logits_quant(x, *qw["emb"])
        return (logits[:, 0] if q_len == 1 else logits), cache
