"""Model operations counted from shapes: the work that ``mfu.*`` divides by
the chip's peak.

A matrix product of (m, k) by (k, n) is 2 m k n operations; element-wise
work, norms and softmax are not counted. Training counts the forward, the
gradients of activations that need one (everything above the first layer
that holds a trainable weight) and the gradients of trainable weights
only; recomputation (remat) is not counted.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# (operations, the weight group of the product or "" for a product of two
# activations)
Op = Tuple[float, str]


def _attn(lq: int, lk: int, width: int) -> float:
    """Scores and weighted sum of one row's attention: 4 lq lk width."""
    return 4.0 * lq * lk * width


def encoder_ops(cfg: dict, rows: int, enroll_frames: int) -> List[Op]:
    """The target-speaker encoder's products for ``rows`` 30 s rows with
    enrollments of ``enroll_frames`` mel frames."""
    w, e = cfg["whisper"], cfg["encoder"]
    d, layers = w["n_audio_state"], w["n_audio_layer"]
    frames = 2 * w["n_audio_ctx"]
    T = w["n_audio_ctx"]
    ops: List[Op] = [
        (2.0 * rows * frames * d * w["n_mels"] * 3, "conv1"),
        (2.0 * rows * T * d * d * 3, "conv2"),
    ]
    if e["enroll_type"] == "audio":
        enr = enroll_frames // 2
        H, I, nq = e["qformer_hidden_size"], e["qformer_intermediate_size"], e["num_query_tokens"]
        ops += [(2.0 * rows * enroll_frames * d * w["n_mels"] * 3, "conv1"),
                (2.0 * rows * enr * d * d * 3, "conv2"),
                (2.0 * rows * enr * d * H, "qformer")]
        n = nq + enr
        for _ in range(e["num_hidden_layers"]):
            ops += [(2.0 * rows * n * H * H * 4, "qformer"), (rows * _attn(n, n, H), ""),
                    (2.0 * rows * nq * H * H * 2, "qformer"),
                    (2.0 * rows * T * d * H * 2, "qformer"), (rows * _attn(nq, T, H), ""),
                    (2.0 * rows * nq * H * I * 2, "qformer"),
                    (2.0 * rows * enr * H * I * 2, "qformer")]
        ops.append((2.0 * rows * n * H * d, "prompt_proj"))
        T = T + nq
    else:
        ops.append((2.0 * rows * T * (d + e["enroll_size"]) * d, "adapter"))
    for _ in range(layers):
        ops += [(2.0 * rows * T * d * d * 4, "encoder_attn"), (rows * _attn(T, T, d), ""),
                (2.0 * rows * T * d * 4 * d * 2, "encoder_mlp")]
    return ops


def memory_len(cfg: dict) -> int:
    e = cfg["encoder"]
    nq = e["num_query_tokens"] if e["enroll_type"] == "audio" else 0
    return cfg["whisper"]["n_audio_ctx"] + nq


def decoder_ops(cfg: dict, rows: int, length: int, logits_rows: int) -> List[Op]:
    """The teacher-forced decoder over ``length`` tokens (dense cross
    attention), logits at ``logits_rows`` positions a row."""
    w = cfg["whisper"]
    d, V, Tm = w["n_text_state"], w["n_vocab"], memory_len(cfg)
    ops: List[Op] = []
    for _ in range(w["n_text_layer"]):
        ops += [(2.0 * rows * length * d * d * 4, "decoder_attn"),
                (rows * _attn(length, length, d) / 2, ""),
                (2.0 * rows * length * d * d * 2 + 2.0 * rows * Tm * d * d * 2, "decoder_cross"),
                (rows * _attn(length, Tm, d), ""),
                (2.0 * rows * length * d * 4 * d * 2, "decoder_mlp")]
    ops.append((2.0 * rows * logits_rows * d * V, "token_embedding"))
    return ops


def serve_ops(cfg: dict, rows: int, prefix: int, steps: int) -> float:
    """One greedy decode batch after the encoder: cross K/V, the prefill
    of ``prefix`` tokens (logits at its last) and ``steps`` token steps,
    the i-th attending ``prefix + i`` cached positions."""
    w = cfg["whisper"]
    d, V, Tm, L = w["n_text_state"], w["n_vocab"], memory_len(cfg), w["n_text_layer"]
    total = L * 2.0 * rows * Tm * d * d * 2
    total += sum(op for op, name in decoder_ops(cfg, rows, prefix, 1) if name != "decoder_cross")
    total += L * 2.0 * rows * prefix * d * d * 2
    for i in range(steps):
        per_layer = 2.0 * rows * d * d * (4 + 2 + 8) + 4.0 * rows * (prefix + i + 1) * d + 4.0 * rows * Tm * d
        total += L * per_layer + 2.0 * rows * d * V
    return total


def forward(ops: List[Op]) -> float:
    return sum(o for o, _ in ops)


def train_step_ops(cfg: dict, rows: int, text_len: int, enroll_frames: int,
                   trainable: Dict[str, bool]) -> float:
    """One training step's operations for ``rows`` rows with transcripts
    padded to ``text_len``; ``trainable[group]`` says whether a weight
    group's gradient is computed (groups as named in ``encoder_ops`` /
    ``decoder_ops``, plus ``ctc``; a LoRA target's merged weight takes its
    gradient, so its group counts as trained)."""
    e = cfg["encoder"]
    nq = e["num_query_tokens"] if e["enroll_type"] == "audio" else 0
    prefix = 1 + nq if e["enroll_type"] == "audio" else 0
    T, d, V = cfg["whisper"]["n_audio_ctx"], cfg["whisper"]["n_audio_state"], cfg["whisper"]["n_vocab"]
    ops = encoder_ops(cfg, rows, enroll_frames) + decoder_ops(cfg, rows, prefix + text_len + 1, text_len + 1)
    ops.append((2.0 * rows * T * d * V, "ctc"))
    total = 0.0
    for o, name in ops:
        total += o
        # the input's gradient: none below the first conv, and below the
        # second only where the first trains; both operands of attention
        if name == "conv2" and trainable.get("conv1", False) or name not in ("conv1", "conv2"):
            total += o if name else 2 * o
        if name and trainable.get(name, False):
            total += o  # the weight's gradient
    return total
