"""Plain float32 reference of target-speaker Whisper: the yardstick that
decides ``correct``.

Written from the published model and the recipe's configuration, in plain
PyTorch over a dict of named tensors, with no kernel, cache or batching
trick. It imports nothing of the program under test and takes nothing the
program made: the benchmark hands both sides the same weights, inputs and
random-draw seed.

What it computes:

- the Whisper log-mel frontend (``frontend.py``);
- the Qformer target-speaker encoder (conv stems, BLIP-2 Qformer speaker
  prompt with its dropout, prompt ahead of the 24 pre-LN blocks) and the
  embedding-enrollment encoder (the ``cat`` adapter ahead of block 0);
- the speaker-prompted and the prompt-free decoders, teacher forced;
- the serving path's int4 cross K/V, recomputed here from the float K/V
  (asymmetric per channel over time, as the configuration states) and
  dequantized before a float32 attention;
- the four training losses (CTC, attention cross entropy, Arc-InfoNCE,
  AAM-softmax) and LoRA factors beside the weights;
- clip + AdamW written out in float32.

The random draws of training (SpecAugment, Qformer dropout, the
Arc-InfoNCE negatives) are made from a ``torch.Generator`` in the order
the model defines them, so a generator seeded as the program's makes the
same masks on the same device.

``lowp="fp8"`` is the control: every Linear's operands rounded to
float8 e4m3 with a per-tensor scale, the next precision below the bf16 the
configuration states.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .frontend import log_mel

Params = Dict[str, torch.Tensor]
ACOS_EPS = 1e-7
FP8_MAX = 448.0


def sinusoids(length: int, channels: int) -> torch.Tensor:
    """Whisper's sinusoidal table (length, channels), float32."""
    log_inc = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_inc * np.arange(channels // 2, dtype=np.float64))
    scaled = np.arange(length, dtype=np.float64)[:, None] * inv[None, :]
    return torch.from_numpy(
        np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32))


# ---------------------------------------------------------------- parameters

def param_specs(cfg: dict, heads: bool) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter, sorted by name, in the naming of
    the configuration's ``TSASRModel``; ``heads`` adds the training heads
    (CTC, and ASP and AAM with audio enrollment)."""
    w, e = cfg["whisper"], cfg["encoder"]
    d, dt, V = w["n_audio_state"], w["n_text_state"], w["n_vocab"]
    out: Dict[str, Tuple[int, ...]] = {}

    def lin(name, n_in, n_out, bias=True):
        out[f"{name}.weight"] = (n_out, n_in)
        if bias:
            out[f"{name}.bias"] = (n_out,)

    def ln(name, n):
        out[f"{name}.weight"] = (n,)
        out[f"{name}.bias"] = (n,)

    def block(pre, n, cross):
        ln(f"{pre}.attn_ln", n)
        for p in ("query", "key", "value", "out"):
            lin(f"{pre}.attn.{p}", n, n, bias=p != "key")
        if cross:
            ln(f"{pre}.cross_attn_ln", n)
            for p in ("query", "key", "value", "out"):
                lin(f"{pre}.cross_attn.{p}", n, n, bias=p != "key")
        ln(f"{pre}.mlp_ln", n)
        lin(f"{pre}.mlp_fc1", n, 4 * n)
        lin(f"{pre}.mlp_fc2", 4 * n, n)

    enc = "encoder.encoder"
    out[f"{enc}.conv1.weight"] = (d, w["n_mels"], 3)
    out[f"{enc}.conv1.bias"] = (d,)
    out[f"{enc}.conv2.weight"] = (d, d, 3)
    out[f"{enc}.conv2.bias"] = (d,)
    for i in range(w["n_audio_layer"]):
        block(f"{enc}.blocks.{i}", d, False)
    ln(f"{enc}.ln_post", d)
    if e["enroll_type"] == "audio":
        H, I = e["qformer_hidden_size"], e["qformer_intermediate_size"]
        q = "encoder.qformer"
        out[f"{q}.query_tokens"] = (1, e["num_query_tokens"], H)
        lin(f"{q}.word_embeddings", d, H)
        ln(f"{q}.emb_ln", H)
        for j in range(e["num_hidden_layers"]):
            lay = f"{q}.layers.{j}"
            for part, kv in (("attention", H), ("crossattention", d)):
                lin(f"{lay}.{part}.query", H, H)
                lin(f"{lay}.{part}.key", kv, H)
                lin(f"{lay}.{part}.value", kv, H)
                lin(f"{lay}.{part}.out", H, H)
                ln(f"{lay}.{part}.ln", H)
            for part in ("ffn_query", "ffn"):
                lin(f"{lay}.{part}.fc1", H, I)
                lin(f"{lay}.{part}.fc2", I, H)
                ln(f"{lay}.{part}.ln", H)
        if H != d:
            lin("encoder.prompt_proj", H, d)
    else:
        lin("encoder.adapter.proj", d + e["enroll_size"], d)
        if e.get("adapter_normalize", True):
            ln("encoder.adapter.adapter_norm", d)
    dec = "decoder.decoder"
    out[f"{dec}.token_embedding.weight"] = (V, dt)
    out[f"{dec}.positional_embedding"] = (w["n_text_ctx"], dt)
    for i in range(w["n_text_layer"]):
        block(f"{dec}.blocks.{i}", dt, True)
    ln(f"{dec}.ln", dt)
    if heads:
        lin("ctc.ctc_lo", d, V)
        if e["enroll_type"] == "audio":
            lin("asp.projection", 2 * d, d)
            out["aam.classifier"] = (cfg["model"]["num_speakers"], d)
    return sorted(out.items())


def lora_targets(names: Sequence[str], pattern: str) -> List[str]:
    rx = re.compile(pattern)
    return sorted(n for n in names if rx.match(n))


# ---------------------------------------------------------------- primitives

def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one per-tensor scale."""
    amax = t.detach().abs().amax().clamp(min=1e-12)
    s = amax / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


class Ref:
    """The reference over parameters ``P`` (float32) for configuration
    ``cfg``; ``lora``: {weight name: (a (in, r), b (r, out))};
    ``lowp``: None, or ``"fp8"`` for the control."""

    def __init__(self, P: Params, cfg: dict, lora: Optional[Dict] = None,
                 lowp: Optional[str] = None):
        self.P, self.cfg, self.lora, self.lowp = P, cfg, lora or {}, lowp
        lc = cfg.get("training", {}).get("lora", {})
        self.lora_scale = lc.get("alpha", 32.0) / lc.get("rank", 16)

    # -- layers
    def weight(self, name: str) -> torch.Tensor:
        w = self.P[name + ".weight"]
        ab = self.lora.get(name + ".weight")
        if ab is not None:
            w = w + self.lora_scale * (ab[0] @ ab[1]).t()
        return w

    def linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        w = self.weight(name)
        if self.lowp == "fp8":
            x, w = _fp8(x), _fp8(w)
        y = x @ w.t()
        b = self.P.get(name + ".bias")
        return y if b is None else y + b

    def ln(self, name: str, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.P[name + ".weight"], self.P[name + ".bias"], eps)

    @staticmethod
    def attention(q, k, v, mask=None, drop=None):
        """(b, n, h, d) heads; float32 scores and softmax."""
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
        if mask is not None:
            s = s + mask
        p = torch.softmax(s, dim=-1)
        if drop is not None:
            p = drop(p)
        return torch.einsum("bhqk,bkhd->bqhd", p, v)

    def mha(self, pre, x, src, heads, mask=None, drop=None):
        split = lambda t: t.reshape(t.shape[0], t.shape[1], heads, -1)
        o = self.attention(split(self.linear(pre + ".query", x)), split(self.linear(pre + ".key", src)),
                           split(self.linear(pre + ".value", src)), mask, drop)
        return self.linear(pre + ".out", o.reshape(x.shape[0], x.shape[1], -1))

    def block(self, pre, x, heads, approx, mask=None, memory=None, cross=None):
        """Pre-LN Whisper block; ``memory`` (dense cross attention) or
        ``cross`` (dequantized per-layer (k, v) heads) for the decoder."""
        h = self.ln(pre + ".attn_ln", x)
        x = x + self.mha(pre + ".attn", h, h, heads, mask)
        if memory is not None:
            x = x + self.mha(pre + ".cross_attn", self.ln(pre + ".cross_attn_ln", x), memory, heads)
        elif cross is not None:
            h = self.ln(pre + ".cross_attn_ln", x)
            q = self.linear(pre + ".cross_attn.query", h)
            q = q.reshape(q.shape[0], q.shape[1], heads, -1)
            o = self.attention(q, *cross)
            x = x + self.linear(pre + ".cross_attn.out", o.reshape(x.shape[0], x.shape[1], -1))
        h = self.ln(pre + ".mlp_ln", x)
        return x + self.linear(pre + ".mlp_fc2", gelu(self.linear(pre + ".mlp_fc1", h), approx))

    # -- encoders
    def conv_stem(self, mel, approx, positions):
        pre = "encoder.encoder"
        P = self.P
        x = gelu(F.conv1d(mel, P[pre + ".conv1.weight"], P[pre + ".conv1.bias"], padding=1), approx)
        x = gelu(F.conv1d(x, P[pre + ".conv2.weight"], P[pre + ".conv2.bias"], stride=2,
                          padding=1), approx).transpose(1, 2)
        if positions:
            w = self.cfg["whisper"]
            x = x + sinusoids(w["n_audio_ctx"], w["n_audio_state"])[: x.shape[1]].to(x.device)
        return x

    def run_blocks(self, x, approx, remat):
        w = self.cfg["whisper"]
        for i in range(w["n_audio_layer"]):
            fn = lambda t, i=i: self.block(f"encoder.encoder.blocks.{i}", t, w["n_audio_head"], approx)
            x = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
        return self.ln("encoder.encoder.ln_post", x)

    def qformer(self, memory, memory_lens, enroll, enroll_lens, gen=None, train=False):
        e = self.cfg["encoder"]
        H, nq, heads = e["qformer_hidden_size"], e["num_query_tokens"], e["qformer_heads"]
        hid = e["qformer_hidden_dropout"] if train else 0.0
        att = e["qformer_attention_dropout"] if train else 0.0
        drop = lambda rate: (None if rate == 0.0 else (lambda t: dropout(t, rate, gen)))
        q = "encoder.qformer"
        b, n_enr = enroll.shape[:2]
        emb = self.linear(q + ".word_embeddings", enroll) + sinusoids(1500, H)[:n_enr].to(enroll.device)
        toks = self.P[q + ".query_tokens"].expand(b, nq, H)
        x = self.ln(q + ".emb_ln", torch.cat([toks, emb], 1), 1e-12)
        if hid:
            x = dropout(x, hid, gen)
        dev = enroll.device
        valid = torch.cat([torch.ones(b, nq, dtype=torch.bool, device=dev),
                           torch.arange(n_enr, device=dev)[None] < enroll_lens[:, None]], 1)
        self_mask = torch.where(valid, 0.0, -10000.0)[:, None, None, :]
        m_valid = torch.arange(memory.shape[1], device=dev)[None] < memory_lens[:, None]
        mem_mask = torch.where(m_valid, 0.0, -10000.0)[:, None, None, :]

        def attn_block(pre, x, src, mask):
            o = self.mha(pre, x, src, heads, mask, drop(att))
            if hid:
                o = dropout(o, hid, gen)
            return self.ln(pre + ".ln", o + x, 1e-12)

        def ffn(pre, x):
            h = self.linear(pre + ".fc2", gelu(self.linear(pre + ".fc1", x), False))
            if hid:
                h = dropout(h, hid, gen)
            return self.ln(pre + ".ln", h + x, 1e-12)

        for j in range(e["num_hidden_layers"]):
            lay = f"{q}.layers.{j}"
            x = attn_block(lay + ".attention", x, x, self_mask)
            qp, ep = x[:, :nq], x[:, nq:]
            qp = attn_block(lay + ".crossattention", qp, memory, mem_mask)
            x = torch.cat([ffn(lay + ".ffn_query", qp), ffn(lay + ".ffn", ep)], 1)
        prompt, enr = x[:, :nq], x[:, nq:]
        if "encoder.prompt_proj.weight" in self.P:
            prompt, enr = self.linear("encoder.prompt_proj", prompt), self.linear("encoder.prompt_proj", enr)
        return prompt, enr

    def encode(self, mel, mel_lens, enroll, enroll_lens=None, approx=False, remat=False,
               gen=None, train=False):
        """(memory, memory_lens, prompt, enroll_embedding); ``enroll`` is
        the enrollment log-mel, or the speaker embedding (b, E) with
        embedding enrollment (then the last two are None)."""
        w, e = self.cfg["whisper"], self.cfg["encoder"]
        x = self.conv_stem(mel, approx, True)
        x_lens = torch.clamp(1 + (mel_lens - 1) // 2, max=w["n_audio_ctx"])
        if e["enroll_type"] == "embedding":
            emb = enroll[:, None, :].expand(-1, x.shape[1], -1)
            x = x + self.linear("encoder.adapter.proj", torch.cat([x, emb], -1))
            if "encoder.adapter.adapter_norm.weight" in self.P:
                x = self.ln("encoder.adapter.adapter_norm", x)
            return self.run_blocks(x, approx, remat), x_lens, None, None
        er = self.conv_stem(enroll, approx, False)
        er_lens = torch.clamp(1 + (enroll_lens - 1) // 2, max=w["n_audio_ctx"])
        prompt, enr = self.qformer(x, x_lens, er, er_lens, gen, train)
        nq = e["num_query_tokens"]
        x = torch.cat([prompt, x], 1)
        return self.run_blocks(x, approx, remat), x_lens + nq, prompt, enr

    # -- decoder
    def embed_prefixed(self, tokens, prompt):
        E = self.P["decoder.decoder.token_embedding.weight"]
        x = E[tokens]
        if prompt is None:
            return x, 0
        sop = E[self.cfg["model"]["startofprev"]].expand(x.shape[0], 1, -1)
        return torch.cat([sop, prompt, x], 1), 1 + prompt.shape[1]

    def decode(self, x_emb, memory=None, cross=None, remat=False):
        """Teacher-forced decoder over embedded input; float32 logits."""
        w = self.cfg["whisper"]
        L = x_emb.shape[1]
        x = x_emb + self.P["decoder.decoder.positional_embedding"][:L]
        ids = torch.arange(L, device=x.device)
        mask = torch.where(ids[None, :] <= ids[:, None], 0.0, float("-inf"))
        for i in range(w["n_text_layer"]):
            layer_cross = None if cross is None else cross[i]
            fn = lambda t, i=i, c=layer_cross: self.block(
                f"decoder.decoder.blocks.{i}", t, w["n_text_head"], False, mask, memory, c)
            x = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
        x = self.ln("decoder.decoder.ln", x)
        E = self.P["decoder.decoder.token_embedding.weight"]
        if self.lowp == "fp8":
            return _fp8(x) @ _fp8(E).t()
        return x @ E.t()

    def quantized_cross(self, memory, bits):
        """Per layer the dequantized cross (k, v) heads of ``memory``,
        quantized asymmetric per channel over time to ``bits``."""
        w = self.cfg["whisper"]
        h = w["n_text_head"]
        out = []
        for i in range(w["n_text_layer"]):
            pre = f"decoder.decoder.blocks.{i}.cross_attn"
            k = self.linear(pre + ".key", memory)
            v = self.linear(pre + ".value", memory)
            out.append(tuple(quant_dequant(t, bits).reshape(t.shape[0], t.shape[1], h, -1)
                             for t in (k, v)))
        return out

    # -- training loss
    def loss(self, batch, gen, epoch: float = 0.0):
        """(loss, {name: float32 scalar}) of one training batch, as the
        configuration's model defines it, the draws made from ``gen``."""
        cfg, mc, tc = self.cfg, self.cfg["model"], self.cfg["training"]
        emb_enroll = cfg["encoder"]["enroll_type"] == "embedding"
        mel, mel_lens = log_mel(batch["speech"], batch["speech_lens"], cfg["whisper"]["n_mels"])
        if mc["use_specaug"]:
            mel = specaug(mel, mel_lens, mc["specaug"], gen)
        if emb_enroll:
            memory, mem_lens, prompt, enr = self.encode(
                mel, mel_lens, batch["enroll_embed"], None, tc["gelu_approx"], tc["remat"], gen, True)
        else:
            emel, emel_lens = log_mel(batch["enroll"], batch["enroll_lens"], cfg["whisper"]["n_mels"])
            memory, mem_lens, prompt, enr = self.encode(
                mel, mel_lens, emel, emel_lens, tc["gelu_approx"], tc["remat"], gen, True)
        stats = {}
        loss = memory.new_zeros(())
        if not emb_enroll and mc["contrastive_weight"] > 0:
            gamma = mc["asp_gamma_initial"] + min(epoch / mc["asp_gamma_warmup_epochs"], 1.0) * (
                mc["asp_gamma"] - mc["asp_gamma_initial"])
            margin = 0.0 if epoch < mc["warm_up_epochs"] else mc["aam_margin"]
            pooled = self.asp(enr, gamma)
            stats["loss_con"] = arc_infonce(prompt, pooled, batch["neg_logits"], gen,
                                            mc["num_negatives"], mc["contrastive_temp"],
                                            mc["contrastive_margin"])
            loss = loss + mc["contrastive_weight"] * stats["loss_con"]
            if mc["aam_softmax_weight"] > 0:
                stats["loss_aam"] = self.aam(pooled, batch["spk_labels"], margin)
                loss = loss + mc["aam_softmax_weight"] * mc["contrastive_weight"] * stats["loss_aam"]
        nq = 0 if prompt is None else prompt.shape[1]
        text, text_lens = batch["text"], batch["text_lens"]
        logits = self.linear("ctc.ctc_lo", memory[:, nq:])
        logp = torch.log_softmax(logits, -1)
        stats["loss_ctc"] = F.ctc_loss(logp.transpose(0, 1), torch.where(text < 0, 0, text),
                                       mem_lens - nq, text_lens, blank=0, reduction="none").mean()
        b, L = text.shape
        idx = torch.arange(L + 1, device=text.device)[None]
        lens = text_lens[:, None]
        tok = torch.where(text < 0, mc["eos"], text)
        ys_in = torch.where(idx <= lens, torch.cat([torch.full_like(tok[:, :1], mc["sos"]), tok], 1),
                            mc["eos"])
        ys_out = torch.cat([tok, torch.full_like(tok[:, :1], -1)], 1)
        ys_out = torch.where(idx == lens, mc["eos"], ys_out)
        ys_out = torch.where(idx > lens, -1, ys_out)
        x_emb, prefix = self.embed_prefixed(ys_in, prompt)
        dlogits = self.decode(x_emb, memory=memory, remat=tc["remat"])[:, prefix:]
        dlogp = torch.log_softmax(dlogits, -1)
        valid = ys_out >= 0
        picked = dlogp.gather(-1, torch.where(valid, ys_out, 0)[..., None])[..., 0]
        stats["loss_att"] = -(picked * valid).sum() / b
        cw = mc["ctc_weight"]
        loss = loss + cw * stats["loss_ctc"] + (1 - cw) * stats["loss_att"]
        stats["loss"] = loss
        return loss, {k: v.detach() for k, v in stats.items()}

    def asp(self, x, gamma):
        p = x.mean(1)
        scores = torch.einsum("bd,bsd->bs", l2n(p), x) * gamma
        alpha = torch.softmax(scores, -1)
        mu = torch.einsum("bs,bsd->bd", alpha, x)
        m2 = torch.einsum("bs,bsd->bd", alpha, x * x)
        sigma = torch.sqrt(torch.clamp(m2 - mu * mu, min=0.0) + 1e-8)
        return l2n(self.linear("asp.projection", torch.cat([mu, sigma], -1)))

    def aam(self, pooled, labels, margin):
        cos = l2n(pooled) @ l2n(self.P["aam.classifier"]).t()
        cos = torch.clamp(cos, -1 + ACOS_EPS, 1 - ACOS_EPS)
        one_hot = F.one_hot(labels.long(), cos.shape[-1]).float()
        logits = torch.cos(torch.arccos(cos) + one_hot * margin) / self.cfg["model"]["aam_temp"]
        return -(one_hot * torch.log_softmax(logits, -1)).sum(-1).mean()


def gelu(x, approx: bool):
    return F.gelu(x, approximate="tanh" if approx else "none")


def dropout(x, rate, gen):
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def l2n(x, eps=1e-12):
    return x / torch.clamp(torch.sqrt((x * x).sum(-1, keepdim=True)), min=eps)


def quant_dequant(t: torch.Tensor, bits: int) -> torch.Tensor:
    """(b, T, c) float32 -> the same values after asymmetric per-channel
    quantization over T to ``bits`` and back."""
    qmax = 127.0 if bits == 8 else 7.0
    hi, lo = t.amax(1, keepdim=True), t.amin(1, keepdim=True)
    zp = (hi + lo) * 0.5
    scale = torch.clamp((hi - lo) * (0.5 / qmax), min=1e-8)
    return torch.round((t - zp) / scale) * scale + zp


def specaug(mel, mel_lens, sc: dict, gen):
    """Frequency then time masks, widths and starts drawn from ``gen``."""
    b, n_mels, frames = mel.shape
    dev = mel.device

    def axis(n, num, max_width):
        u = torch.rand((b, num, 1), generator=gen, device=dev)
        width = torch.minimum((u * (max_width.max() + 1).float()).long(), max_width.view(-1, 1, 1))
        start = torch.randint(0, max(n - 1, 1), (b, num, 1), generator=gen, device=dev)
        i = torch.arange(n, device=dev)[None, None]
        return ~((i >= start) & (i < start + width)).any(1)

    keep_f = axis(n_mels, sc["num_freq_masks"], torch.full((b,), sc["freq_mask_width"], device=dev))
    cap = torch.clamp((mel_lens * sc["time_mask_width_ratio"]).long(), min=1, max=sc["time_mask_width"])
    keep_t = axis(frames, sc["num_time_masks"], cap)
    keep = keep_f[:, :, None] & keep_t[:, None, :]
    return torch.where(keep, mel, torch.full_like(mel, sc["mask_value"]))


def arc_infonce(prompt, pooled, neg_logits, gen, k, temp, margin):
    pp = l2n(prompt.mean(1))
    idx = torch.multinomial(torch.softmax(neg_logits.float(), -1), k, replacement=True,
                            generator=gen).t()
    targets = torch.cat([pooled[None], pooled[idx]], 0)
    cos = torch.einsum("bd,kbd->kb", pp, l2n(targets))
    theta = torch.arccos(torch.clamp(cos, -1 + ACOS_EPS, 1 - ACOS_EPS))
    theta = torch.cat([theta[:1] + margin, theta[1:]], 0)
    logits = (torch.cos(theta) / temp).t()
    return -torch.log_softmax(logits, -1)[:, 0].mean()


# ---------------------------------------------------------------- optimizer

class AdamW:
    """Global-norm clip, then AdamW, float32 throughout, over named
    leaves; ``lr(n)`` is the configuration's schedule at update count n."""

    def __init__(self, leaves: Dict[str, torch.Tensor], oc: dict):
        self.leaves, self.oc = leaves, oc
        self.mu = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.count = 0

    def lr(self, n: int) -> float:
        oc = self.oc
        if oc["schedule"] == "warmuplr":
            w, s = float(oc["warmup_steps"]), float(max(n, 1))
            return oc["lr"] * w ** 0.5 * min(s ** -0.5, s * w ** -1.5)
        if oc["schedule"] == "constant":
            return oc["lr"]
        raise ValueError(f"no reference for schedule {oc['schedule']}")

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Applies one update; returns the clipped gradients it used."""
        oc = self.oc
        b1, b2 = oc["betas"]
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        c = (oc["clip_norm"] / norm) if norm >= oc["clip_norm"] else 1.0
        clipped = {k: g * c for k, g in grads.items()}
        t = self.count + 1
        lr = self.lr(self.count)
        for k, p in self.leaves.items():
            g = clipped[k]
            self.mu[k].mul_(b1).add_(g, alpha=1 - b1)
            self.nu[k].mul_(b2).add_(g * g, alpha=1 - b2)
            u = (self.mu[k] / (1 - b1 ** t)) / ((self.nu[k] / (1 - b2 ** t)).sqrt() + oc["eps"])
            if oc["weight_decay"]:
                u = u + oc["weight_decay"] * p
            p.sub_(lr * u)
        self.count = t
        return clipped
