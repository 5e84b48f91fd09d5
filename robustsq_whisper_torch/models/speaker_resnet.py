"""Speaker-embedding ResNet34 (wespeaker's voxceleb model) and the recipe's
stage 103, embedding extraction over a Kaldi dir.

The JAX package's ``models/speaker_resnet.py`` as an ``nn.Module`` in NCHW:
a 3x3 conv stem (32 channels), stages (3, 4, 6, 3) of basic blocks with
channels 32 / 64 / 128 / 256 over the (time, freq) fbank map, time and
frequency halved at the first block of stages 2 to 4; temporal statistics
pooling (mean and std over time of the flattened freq x channel map) and a
linear head to a 256-d embedding. Convs are padded (1, 1) and carry no
bias; the 1x1 downsample conv has no padding; batch norms run in eval mode
with eps 1e-5. The pooled map is flattened frequency-major (``f * C + c``),
as the JAX model flattens its (b, T', F', C) map, so the flax head's kernel
loads as it is; statistics are masked by ``frame_lens // 8`` (three
stride-2 stages). wespeaker's ONNX export pools channel-major over a
(freq, time) map: ``map_onnx_to_torch`` transposes the conv kernels' two
spatial axes and permutes the head's input columns.

``extract_embeddings_for_dir`` pads every batch to (batch_size,
``MAX_SECONDS``) as the JAX extractor does, so the convs' edge frames see
the same zeros and a row's embedding does not depend on its batch.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..audio.fbank import N_MELS

EMBED_DIM = 256
MAX_SECONDS = 30.0  # stage 103 pads every batch to this length
SEED = 0  # the seeded weights when no ONNX file is given

logger = logging.getLogger("robustsq_whisper_torch.speaker")


def _bn(c: int) -> nn.BatchNorm2d:
    # flax's momentum 0.9 is torch's 0.1 (it matters in training only)
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, channels: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, channels, 3, stride, 1, bias=False)
        self.bn1 = _bn(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, 1, 1, bias=False)
        self.bn2 = _bn(channels)
        self.downsample_conv = self.downsample_bn = None
        if stride != 1 or in_ch != channels:
            self.downsample_conv = nn.Conv2d(in_ch, channels, 1, stride, 0, bias=False)
            self.downsample_bn = _bn(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        if self.downsample_conv is not None:
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(h + x)


class SpeakerResNet34(nn.Module):
    """fbank (batch, frames, N_MELS) -> speaker embedding (batch,
    embed_dim). The defaults are ResNet34's; tests build smaller models of
    the same structure."""

    def __init__(
        self, embed_dim: int = EMBED_DIM, base_channels: int = 32,
        stages: tuple = (3, 4, 6, 3),
    ):
        super().__init__()
        self.stages = tuple(stages)
        self.stem_conv = nn.Conv2d(1, base_channels, 3, 1, 1, bias=False)
        self.stem_bn = _bn(base_channels)
        ch, in_ch, f = base_channels, base_channels, N_MELS
        for si, blocks in enumerate(self.stages):
            for bi in range(blocks):
                stride = 2 if (si > 0 and bi == 0) else 1
                setattr(self, f"layer{si + 1}_{bi}", BasicBlock(in_ch, ch, stride))
                in_ch = ch
            if si > 0:
                f = (f - 1) // 2 + 1
            ch *= 2
        self.embed = nn.Linear(2 * f * in_ch, embed_dim)

    def blocks(self):
        for si, n in enumerate(self.stages):
            for bi in range(n):
                yield getattr(self, f"layer{si + 1}_{bi}")

    def forward(self, feats: torch.Tensor, frame_lens: torch.Tensor) -> torch.Tensor:
        x = feats.to(self.stem_conv.weight.dtype)[:, None]  # (b, 1, T, F)
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        for block in self.blocks():
            x = block(x)
        b, c, t, f = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, t, f * c).float()  # frequency-major
        tl = torch.clamp(frame_lens // 8, min=1)
        mask = (torch.arange(t, device=x.device)[None, :] < tl[:, None])[..., None]
        denom = tl[:, None].float()
        mean = torch.sum(torch.where(mask, x, 0.0), dim=1) / denom
        sq = torch.sum(torch.where(mask, x * x, 0.0), dim=1) / denom
        std = torch.sqrt(torch.clamp(sq - mean * mean, min=1e-7))
        return self.embed(torch.cat([mean, std], dim=-1))


def load_onnx_weights(onnx_path: Optional[str]) -> Optional[Dict[str, np.ndarray]]:
    """The initializers of an ONNX file ({name: array}) through the port's
    protobuf reader; None when no file is given or none is there."""
    if not onnx_path or not os.path.exists(onnx_path):
        return None
    from ..utils.onnx_pb import read_onnx_initializers

    return read_onnx_initializers(onnx_path)


# wrapper prefixes seen in torch -> ONNX speaker-model exports
_NAME_PREFIXES = ("", "module.", "front.", "speaker_encoder.", "model.")
_BN = (("weight", "weight"), ("bias", "bias"), ("running_mean", "running_mean"),
       ("running_var", "running_var"))


def map_onnx_to_torch(
    inits: Dict[str, np.ndarray], model: SpeakerResNet34, strict: bool = True
) -> Dict[str, torch.Tensor]:
    """wespeaker ResNet ONNX initializers (torch state-dict names:
    ``conv1.weight``, ``layer3.2.bn1.running_mean``, ``seg_1.weight``, ...)
    -> ``model``'s state dict. A conv kernel (O, I, kF, kT) over wespeaker's
    (freq, time) map becomes (O, I, kT, kF) over this model's (time, freq)
    map (exact: every stride and padding is the same on both axes); the
    head ``seg_1`` pools channel-major (``c * F + f``) and this model
    frequency-major (``f * C + c``), so its input columns are permuted, for
    the mean and the std halves alike. ``strict``: a KeyError lists any
    initializer expected and missing, or left over."""
    names = list(inits)
    for pref in _NAME_PREFIXES[1:]:
        if names and all(n.startswith(pref) for n in names):
            inits = {n[len(pref):]: v for n, v in inits.items()}
            break
    own = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    used, missing = set(), []

    def take(src: str, dst: str, fn=lambda a: a) -> None:
        if src not in inits:
            missing.append(src)
            return
        used.add(src)
        out[dst] = torch.from_numpy(np.array(fn(np.asarray(inits[src])), order="C"))

    def conv(src: str, dst: str) -> None:
        take(f"{src}.weight", f"{dst}.weight", lambda w: np.transpose(w, (0, 1, 3, 2)))

    def bn(src: str, dst: str) -> None:
        for s, d in _BN:
            take(f"{src}.{s}", f"{dst}.{d}")
        n = f"{src}.num_batches_tracked"
        used.add(n)
        out[f"{dst}.num_batches_tracked"] = torch.tensor(
            int(np.asarray(inits.get(n, 0)).reshape(())), dtype=torch.long)

    conv("conv1", "stem_conv")
    bn("bn1", "stem_bn")
    for si, nb in enumerate(model.stages):
        for bi in range(nb):
            t, p = f"layer{si + 1}.{bi}", f"layer{si + 1}_{bi}"
            conv(f"{t}.conv1", f"{p}.conv1")
            bn(f"{t}.bn1", f"{p}.bn1")
            conv(f"{t}.conv2", f"{p}.conv2")
            bn(f"{t}.bn2", f"{p}.bn2")
            if f"{p}.downsample_conv.weight" in own:
                conv(f"{t}.downsample.0", f"{p}.downsample_conv")
                bn(f"{t}.downsample.1", f"{p}.downsample_bn")

    c_dim = own[f"layer{len(model.stages)}_0.conv2.weight"].shape[0]

    def head(w: np.ndarray) -> np.ndarray:
        half = w.shape[1] // 2
        f_dim = half // c_dim
        if f_dim * c_dim != half:
            raise ValueError(f"seg_1.weight in-dim {w.shape[1]} does not factor into "
                             f"2 * F * C with C={c_dim}")
        f_idx, c_idx = np.divmod(np.arange(half), c_dim)  # our column f*C + c
        perm = c_idx * f_dim + f_idx  # wespeaker's column c*F + f
        return w[:, np.concatenate([perm, perm + half])]

    take("seg_1.weight", "embed.weight", head)
    take("seg_1.bias", "embed.bias")
    extra = sorted(set(inits) - used)
    if strict and (missing or extra):
        raise KeyError(f"ONNX -> torch mapping mismatch: missing={missing[:8]} "
                       f"extra={extra[:8]} (of {len(missing)}/{len(extra)})")
    for k, v in out.items():
        if k in own and tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: the ONNX file gives {tuple(v.shape)}, the model "
                             f"{tuple(own[k].shape)}")
    return out


def embedding_sources(data_dir: str) -> Dict[str, str]:
    """{embedding key: wav path} of stage 103, in the JAX extractor's order
    of sources: a ``spk2enroll.json`` in the dir means train mode, one
    embedding per enrollment utterance of the pool (lazy ``*utt spk`` rows
    resolve against these ids at load time); else the concrete rows of
    ``enroll.scp`` (eval mode, keyed by the mixture utt); else every row of
    ``wav.scp``."""
    from ..data import kaldi_io

    s2e_path = os.path.join(data_dir, "spk2enroll.json")
    enroll_path = os.path.join(data_dir, "enroll.scp")
    if os.path.exists(s2e_path):
        s2e = kaldi_io.read_spk2enroll(s2e_path)
        return {u: p for pairs in s2e.values() for u, p in pairs}
    if os.path.exists(enroll_path):
        rows = kaldi_io.read_scp(enroll_path)
        wav = {u: p for u, p in rows.items() if not kaldi_io.is_lazy_enrollment(p)}
        if not wav:
            raise ValueError(
                f"{enroll_path}: only lazy rows but no spk2enroll.json to "
                "resolve them — run the stage-102 enrollment json builder"
            )
        return wav
    return kaldi_io.read_scp(os.path.join(data_dir, "wav.scp"))


def speaker_model(onnx_model: Optional[str] = None, device="cuda") -> SpeakerResNet34:
    """The extractor's ResNet34 in eval mode on ``device``: the ONNX file's
    weights, or random ones seeded with ``SEED`` (``init.init_params``)
    when none is given. A path given and absent raises FileNotFoundError."""
    from ..init import init_params

    model = init_params(SpeakerResNet34(), SEED)
    inits = load_onnx_weights(onnx_model)
    if inits is not None:
        model.load_state_dict(map_onnx_to_torch(inits, model), strict=True)
    elif onnx_model:
        raise FileNotFoundError(onnx_model)
    return model.to(resolve_device(device)).eval()


@torch.no_grad()
def embed_batch(model: SpeakerResNet34, audio: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """L2-normalised embeddings of a padded waveform batch, in f32 (no TF32
    in the convs)."""
    from ..audio.fbank import kaldi_fbank

    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        feats, flens = kaldi_fbank(audio, lens)
        e = model(feats, flens)
    return e / torch.linalg.norm(e, dim=-1, keepdim=True)


def extract_embeddings_for_dir(
    data_dir: str,
    out_dir: str,
    onnx_model: Optional[str] = None,
    batch_size: int = 16,
    device="cuda",
) -> Dict[str, int]:
    """Stage 103: one embedding a source utterance (``embedding_sources``)
    as ``{out_dir}/{utt}.npy`` (float32, (EMBED_DIM,)), and
    ``{data_dir}/resnet.scp`` naming them. Batches are padded to
    (batch_size, MAX_SECONDS) and the valid lengths (at least 400 samples)
    mask the statistics."""
    from ..data import kaldi_io

    dev = resolve_device(device)
    wav = embedding_sources(data_dir)
    os.makedirs(out_dir, exist_ok=True)
    model = speaker_model(onnx_model, dev)
    max_samples = int(MAX_SECONDS * 16000)
    scp: Dict[str, str] = {}
    utts = sorted(wav)
    t_io = t_dev = 0.0
    for i in range(0, len(utts), batch_size):
        chunk = utts[i : i + batch_size]
        batch = np.zeros((batch_size, max_samples), np.float32)
        lens = np.full((batch_size,), 400, np.int64)
        t0 = time.perf_counter()
        for j, u in enumerate(chunk):
            a, _ = kaldi_io.read_wav(wav[u].split()[0])
            a = a[:max_samples]
            batch[j, : len(a)] = a
            lens[j] = max(len(a), 400)
        t1 = time.perf_counter()
        embs = embed_batch(model, torch.from_numpy(batch).to(dev),
                           torch.from_numpy(lens).to(dev)).cpu().numpy()
        t2 = time.perf_counter()
        for j, u in enumerate(chunk):
            p = os.path.join(out_dir, f"{u}.npy")
            np.save(p, embs[j])
            scp[u] = p
        t_io += (t1 - t0) + (time.perf_counter() - t2)
        t_dev += t2 - t1
    kaldi_io.write_scp(os.path.join(data_dir, "resnet.scp"), scp)
    logger.info("extract_embeddings: %d utts in batches of %d on %s: model %.2f s, io %.2f s",
                len(scp), batch_size, dev, t_dev, t_io)
    return {"num_utts": len(scp), "embed_dim": EMBED_DIM}
