"""Draft distillation for speculative decode.

Mirrors the JAX package's ``train/distill.py``. Speculative decode pays
only when the draft's proposals are accepted, and a self-draft (the
target's own first layers) rarely agrees with the full decoder. Here a
``d``-layer draft is trained against the full decoder (the teacher): it
keeps the teacher's token and positional embeddings and the tied head
(frozen: acceptance compares argmax ids, so the output space must be the
teacher's) and trains its blocks and final LayerNorm, initialised from the
teacher's first ``d`` blocks, to reproduce the teacher's argmax choices
under teacher forcing. The loss is cross-entropy against the teacher's
argmax token, since the verify step accepts a draft token exactly when it
equals that argmax.

The optimizer is optax's ``adam`` over ``warmup_cosine_decay_schedule(0,
lr, min(50, steps // 4), steps)``: ``train/optim.py``'s Adam without
clipping or decay, over f32 masters of the serving-dtype weights, with its
``warmup_cosine`` schedule.
Batches are drawn with ``numpy.random.default_rng(seed).choice`` as the
JAX package draws them, so both see the same batches.

A draft is saved as a directory holding ``draft.pt`` (the draft
``TSDecoder``'s state dict, ``torch.save``) and ``meta.json`` (the JAX
package's meta keys). The JAX package's drafts are Orbax directories and
are not read here; one comes over through the JAX package's
``load_draft``, ``convert.flax_to_state_dict`` and ``save_draft``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.ts_decoder import TSDecoder
from .optim import AdamW, OptimConfig

DRAFT_FILE = "draft.pt"
META_FILE = "meta.json"


def save_draft(out_dir: str, draft: Any, meta: Dict[str, Any]) -> str:
    """Write a draft (a ``TSDecoder`` or its state dict) and its meta (at
    least ``draft_layers`` and the teacher's step) to ``out_dir``; read back
    by ``load_draft`` for ``cli.decode --draft_path``."""
    out_dir = os.path.abspath(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    sd = draft.state_dict() if isinstance(draft, torch.nn.Module) else draft
    torch.save({k: v.detach().to("cpu", copy=True) for k, v in sd.items()},
               os.path.join(out_dir, DRAFT_FILE))
    with open(os.path.join(out_dir, META_FILE), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
    return out_dir


def load_draft(draft_dir: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """``(state_dict, meta)`` on the host; ``build_draft`` makes the
    module, in the compute dtype."""
    path = os.path.join(os.path.abspath(draft_dir), DRAFT_FILE)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no draft checkpoint in {draft_dir}")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    with open(os.path.join(os.path.abspath(draft_dir), META_FILE)) as f:
        meta = json.load(f)
    return sd, meta


def _draft_like(dec: TSDecoder, draft_layers: int, device) -> TSDecoder:
    """An uninitialised ``draft_layers``-block TSDecoder over the 5-D cache
    with the target's prompt and cache widths, on ``device``."""
    td = dec.decoder
    with torch.device(device):
        return TSDecoder(
            dec.dims.replace(n_text_layer=draft_layers),
            startofprev_token=dec.startofprev_token, use_spk_prompt=dec.use_spk_prompt,
            cross_kv_bits=td.cross_kv_bits, self_kv_bits=td.self_kv_bits,
            flat_self_cache=False,
        )


def build_draft(
    dec: TSDecoder, state_dict: Dict[str, torch.Tensor], dtype: torch.dtype
) -> TSDecoder:
    """The draft TSDecoder of a saved state dict, built like the target
    ``dec`` (its cross K/V width, so the speculative decoder accepts it),
    f32 tensors cast to ``dtype``, on ``dec``'s device."""
    n_blocks = len({k.split(".")[2] for k in state_dict if k.startswith("decoder.blocks.")})
    device = dec.decoder.token_embedding.weight.device
    draft = _draft_like(dec, n_blocks, device)
    draft.load_state_dict(
        {k: (v.to(dtype) if v.dtype == torch.float32 else v).to(device)
         for k, v in state_dict.items()},
        strict=True, assign=True,
    )
    return draft.eval()


def teacher_forcing_inputs(
    text: np.ndarray, text_lens: np.ndarray, sot: int, eot: int
) -> Tuple[np.ndarray, np.ndarray]:
    """``(ys_in, mask)`` from corpus token rows ``text`` (n, L), -1 padded,
    each row the decode conditioning prefix minus the leading sot followed
    by the teacher's tokens. ``ys_in`` (n, L+1) is [sot] + row with the
    padding made eot; ``mask`` (n, L+1) covers the logit positions up to
    and including ``text_lens`` (position t predicts ys_in[t+1]; the last
    predicts the row's eot, so the draft learns where the teacher stops)."""
    n, length = text.shape
    ys = np.full((n, length + 1), eot, np.int32)
    ys[:, 0] = sot
    ys[:, 1:] = np.where(text >= 0, text, eot)
    mask = (
        np.arange(length + 1)[None, :] <= np.asarray(text_lens)[:, None]
    ).astype(np.float32)
    return ys, mask


def _masked_agreement(logits: torch.Tensor, tgt: torch.Tensor, msk: torch.Tensor, denom):
    return ((logits.argmax(-1) == tgt).float() * msk).sum() / denom


def distill_draft(
    dec: TSDecoder,
    draft_layers: int,
    memory: torch.Tensor,  # (n, src, n_state) encoder output
    spk_prompt: torch.Tensor,  # (n, n_q, n_state)
    ys_in: np.ndarray,  # (n, L) teacher-forcing inputs (sot-prefixed)
    mask: np.ndarray,  # (n, L) float mask over the logit positions
    *,
    steps: int = 600,
    lr: float = 3e-4,
    batch_size: int = 8,
    seed: int = 0,
    log: Optional[Callable[[str], None]] = None,
    on_step: Optional[Callable[[int, float, float], None]] = None,
) -> Tuple[TSDecoder, Dict[str, float]]:
    """Distill a ``draft_layers``-block draft from the full decoder ``dec``
    on ``memory``'s device.

    Returns ``(draft, stats)``: the draft TSDecoder in ``dec``'s dtypes
    (5-D cache, the target's cross K/V width), ready for
    ``build_speculative_decoder(..., draft=draft)``, and ``{final_loss,
    final_agreement, steps}``, ``final_agreement`` the masked argmax
    agreement with the teacher over the whole corpus (the teacher-forced
    estimate of acceptance). ``on_step(step, loss, agreement)`` sees every
    step's batch loss and agreement."""
    d = int(draft_layers)
    dev = memory.device
    memory = memory.detach().clone()  # a normal tensor: autograd saves it
    spk_prompt = spk_prompt.detach().clone()
    n = memory.shape[0]
    ys_np = np.asarray(ys_in, np.int64)
    mask_np = np.asarray(mask, np.float32)
    at = lambda idx: torch.from_numpy(np.asarray(idx)).to(dev)

    # the teacher's argmax targets, one teacher-forced pass; the ragged tail
    # is tile-padded to one shape, as the JAX package pads it
    tb = min(batch_size, n)
    chunks = []
    dec.eval()
    with torch.inference_mode():
        for i in range(0, n, tb):
            idx = at(np.arange(i, i + tb) % n)
            lg = dec(memory[idx], at(ys_np)[idx], spk_prompt[idx])
            chunks.append(lg.argmax(-1)[: min(tb, n - i)])
    targets = torch.cat(chunks).clone()

    # the draft: the teacher's first d blocks, its embeddings and final ln
    sd = {
        k: v.detach().clone() for k, v in dec.state_dict().items()
        if not (k.startswith("decoder.blocks.") and int(k.split(".")[2]) >= d)
    }
    draft = _draft_like(dec, d, dev)
    draft.load_state_dict(sd, strict=True, assign=True)
    draft.train()
    train_p = []
    for name, p in draft.named_parameters():
        trained = name.startswith(("decoder.blocks.", "decoder.ln."))
        p.requires_grad_(trained)
        if trained:
            train_p.append(p)
    opt = AdamW(train_p, OptimConfig(
        lr=lr, betas=(0.9, 0.999), eps=1e-8, clip_norm=float("inf"), weight_decay=0.0,
        schedule="warmup_cosine", warmup_steps=min(50, steps // 4), total_steps=steps,
    ))

    ys_dev, mask_dev = at(ys_np), at(mask_np)
    rng = np.random.default_rng(seed)
    b = min(batch_size, n)
    loss = agree = torch.zeros(())
    for s in range(steps):
        idx = at(rng.choice(n, size=b, replace=n < b))
        tgt, msk = targets[idx], mask_dev[idx]
        lg = draft(memory[idx], ys_dev[idx], spk_prompt[idx])  # f32 (b, L, V)
        ce = -torch.log_softmax(lg, dim=-1).gather(-1, tgt[..., None])[..., 0]
        denom = torch.clamp(msk.sum(), min=1.0)
        loss = (ce * msk).sum() / denom
        grads = torch.autograd.grad(loss, train_p)
        loss = loss.detach()
        opt.update(grads)
        with torch.no_grad():
            agree = _masked_agreement(lg, tgt, msk, denom)
        if on_step is not None:
            on_step(s, float(loss), float(agree))
        if log is not None and (s % 100 == 0 or s == steps - 1):
            log(f"[distill] step {s}: loss={float(loss):.4f} agree={float(agree):.4f}")
    draft.requires_grad_(False)
    draft.eval()

    # whole-corpus teacher-forced agreement with the final weights
    num = den = 0.0
    with torch.inference_mode():
        for i in range(0, n, tb):
            idx = at(np.arange(i, i + tb) % n)
            msk_np = mask_np[idx.cpu().numpy()].copy()
            msk_np[min(tb, n - i):] = 0.0  # tile-padded rows do not count
            msk = at(msk_np)
            lg = draft(memory[idx], ys_dev[idx], spk_prompt[idx])
            a = float(_masked_agreement(lg, targets[idx], msk, torch.clamp(msk.sum(), min=1.0)))
            w = max(float(np.sum(msk_np)), 1.0)
            num, den = num + a * w, den + w
    stats = {
        "final_loss": round(float(loss), 5),
        "final_agreement": round(num / max(den, 1.0), 5),
        "steps": steps,
    }
    return draft, stats
