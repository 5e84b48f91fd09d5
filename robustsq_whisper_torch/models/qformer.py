"""BLIP-2-style Qformer speaker-prompt adapter.

Mirrors the JAX package's ``models/qformer.py``: a Linear "word embedding"
over continuous enrollment features plus sinusoid positions, learned query
tokens prepended before a joint LayerNorm, then post-LN BERT layers (eps
1e-12, exact GELU) where self-attention runs over [queries; enrollment],
cross-attention to the speech memory runs on the query slice only, and the
two halves have separate FFNs. Masks are additive ``(1 - m) * -10000``.
Plain PyTorch, no kernel.

Training (``train=True``) applies BERT's inverted dropout where the JAX
package does: ``hidden_dropout_prob`` on the embedding after its LayerNorm,
on each attention output dense and on each FFN fc2 before the residual add,
and ``attention_probs_dropout_prob`` on the softmax weights. The masks are
drawn from the ``generator`` passed in; with ``train=False`` or a rate of 0
the Qformer is deterministic.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention, dropout
from .whisper.config import sinusoids
from .whisper.modules import LayerNorm, Linear


@dataclasses.dataclass(frozen=True)
class QformerConfig:
    """The knobs of the JAX package's QformerConfig (same names, same
    defaults); the dropout rates apply in training only."""

    encoder_width: int = 1024
    hidden_size: int = 768
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    num_hidden_layers: int = 2
    num_query_tokens: int = 1
    max_position_embeddings: int = 1500
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    cross_attention_freq: int = 1
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1


class BertSelfAttentionBlock(nn.Module):
    """Post-LN attention sub-block: attention -> dense -> LN(+residual)."""

    def __init__(self, cfg: QformerConfig, kv_width: int):
        super().__init__()
        self.cfg = cfg
        # local heads under tensor parallelism (parallel/shard.py)
        self.n_head = cfg.num_attention_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.query = Linear(cfg.hidden_size, cfg.hidden_size)
        self.key = Linear(kv_width, cfg.hidden_size)
        self.value = Linear(kv_width, cfg.hidden_size)
        self.out = Linear(cfg.hidden_size, cfg.hidden_size)
        self.ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, x, kv_src, mask: Optional[torch.Tensor], train=False, generator=None):
        cfg = self.cfg
        split = lambda t: t.reshape(t.shape[0], t.shape[1], -1, self.head_dim)
        o = dot_product_attention(
            split(self.query(x)), split(self.key(kv_src)),
            split(self.value(kv_src)), mask=mask,
            dropout_rate=cfg.attention_probs_dropout_prob if train else 0.0,
            generator=generator,
            heads_group=None if self.query.tp is None else self.query.tp.group,
        )
        o = self.out(o.reshape(x.shape[0], x.shape[1], -1))
        o = dropout(o, cfg.hidden_dropout_prob if train else 0.0, generator)
        return self.ln(o + x).to(o.dtype)


class BertFFN(nn.Module):
    """Post-LN FFN sub-block: dense-gelu-dense -> LN(+residual)."""

    def __init__(self, cfg: QformerConfig):
        super().__init__()
        self.rate = cfg.hidden_dropout_prob
        self.fc1 = Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = Linear(cfg.intermediate_size, cfg.hidden_size)
        self.ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, x, train=False, generator=None):
        h = self.fc2(F.gelu(self.fc1(x), approximate="none"))
        h = dropout(h, self.rate if train else 0.0, generator)
        return self.ln(h + x).to(h.dtype)


class QformerLayer(nn.Module):
    def __init__(self, cfg: QformerConfig, has_cross_attention: bool):
        super().__init__()
        self.nq = cfg.num_query_tokens
        self.attention = BertSelfAttentionBlock(cfg, cfg.hidden_size)
        self.has_cross_attention = has_cross_attention
        if has_cross_attention:
            self.crossattention = BertSelfAttentionBlock(cfg, cfg.encoder_width)
        self.ffn_query = BertFFN(cfg)
        self.ffn = BertFFN(cfg)

    def forward(self, x, self_mask, memory, memory_mask, train=False, generator=None):
        x = self.attention(x, x, self_mask, train, generator)
        q_part, e_part = x[:, : self.nq], x[:, self.nq :]
        if self.has_cross_attention:
            q_part = self.crossattention(
                q_part, memory.to(q_part.dtype), memory_mask, train, generator
            )
        return torch.cat(
            [self.ffn_query(q_part, train, generator), self.ffn(e_part, train, generator)],
            dim=1,
        )


def _key_mask(valid: torch.Tensor) -> torch.Tensor:
    """(batch, n) bool -> additive (batch, 1, 1, n) mask, -10000 on pads."""
    return torch.where(valid, 0.0, -10000.0).float()[:, None, None, :]


class QFormerAdapter(nn.Module):
    """Speaker-prompt Qformer: ``forward(memory, memory_lens, enroll,
    enroll_lens, train=False, generator=None) -> (query_embeddings,
    enroll_embeddings)``."""

    def __init__(self, cfg: QformerConfig):
        super().__init__()
        self.cfg = cfg
        self.query_tokens = nn.Parameter(
            torch.zeros(1, cfg.num_query_tokens, cfg.hidden_size)
        )
        self.word_embeddings = Linear(cfg.encoder_width, cfg.hidden_size)
        self.emb_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.register_buffer(
            "position_embeddings",
            torch.from_numpy(
                sinusoids(cfg.max_position_embeddings, cfg.hidden_size)
            ),
        )
        self.layers = nn.ModuleList(
            QformerLayer(cfg, has_cross_attention=i % cfg.cross_attention_freq == 0)
            for i in range(cfg.num_hidden_layers)
        )

    def forward(
        self,
        memory: torch.Tensor,  # (batch, src, encoder_width)
        memory_lens: Optional[torch.Tensor],  # (batch,) valid frames
        enroll: torch.Tensor,  # (batch, enr, encoder_width)
        enroll_lens: Optional[torch.Tensor],
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        cfg = self.cfg
        b, n_enroll = enroll.shape[:2]
        nq = cfg.num_query_tokens
        e = self.word_embeddings(enroll)
        e = e + self.position_embeddings[:n_enroll].to(e.dtype)
        q = self.query_tokens.to(e.dtype).expand(b, nq, cfg.hidden_size)
        x = self.emb_ln(torch.cat([q, e], dim=1)).to(e.dtype)
        x = dropout(x, cfg.hidden_dropout_prob if train else 0.0, generator)

        dev = enroll.device
        self_mask = None
        if enroll_lens is not None:
            valid = torch.cat(
                [
                    torch.ones((b, nq), dtype=torch.bool, device=dev),
                    torch.arange(n_enroll, device=dev)[None] < enroll_lens[:, None],
                ],
                dim=1,
            )
            self_mask = _key_mask(valid)
        memory_mask = None
        if memory_lens is not None:
            m_valid = (
                torch.arange(memory.shape[1], device=dev)[None]
                < memory_lens[:, None]
            )
            memory_mask = _key_mask(m_valid)
        for layer in self.layers:
            x = layer(x, self_mask, memory, memory_mask, train, generator)
        return x[:, :nq], x[:, nq:]
