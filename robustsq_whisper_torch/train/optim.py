"""AdamW with global-norm clipping and the LR schedules, as plain tensor
functions.

Same update as the JAX package's ``train/optim.py`` (optax
``chain(clip_by_global_norm, adamw)``), step for step:

- clipping: ``g * max / ||g||`` (as ``(g / ||g||) * max``) when
  ``||g|| >= max``, else ``g`` (optax's rule, without the ``+1e-6`` of
  ``clip_grad_norm_``); the norm is over every trainable tensor;
- Adam: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, bias
  corrections at the new count, ``u = mu_hat / (sqrt(nu_hat) + eps)``; the
  first moment is stored in ``moment_dtype`` after the update has used it
  unrounded (optax ``mu_dtype``), the second stays f32;
- weight decay ``u += wd * p``, then ``p -= lr(n) * u`` where ``n`` counts
  the updates applied before this one (optax evaluates the schedule at the
  previous count; ``warmuplr`` clamps the step to 1, so the first two
  updates share a rate);
- ``accum_grad = k`` (optax ``MultiSteps``): the running mean of k
  micro-batch gradients, one update on every k-th call.

``torch.optim.AdamW`` cannot keep a bf16 first moment over f32 parameters,
nor an f32 master over bf16 ones, so this is written out. Parameters that
are not f32 (the bf16 compute copies) get an f32 master here: the update
runs on the master and the parameter receives its rounded copy.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence

import numpy as np
import torch

_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 5e-5
    warmup_steps: int = 1500
    schedule: str = "warmuplr"  # warmuplr | linear | constant | warmup_cosine
    total_steps: int = 100_000
    weight_decay: float = 0.0
    betas: tuple = (0.9, 0.98)
    eps: float = 1e-8
    clip_norm: float = 1.0
    moment_dtype: str = "float32"  # float32 | bfloat16


def make_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """Learning rate at update count ``n`` (f32 arithmetic, as in JAX)."""
    f32 = np.float32
    if cfg.schedule == "warmuplr":
        # ESPnet WarmupLR: lr * w^0.5 * min(step^-0.5, step * w^-1.5)
        w = float(cfg.warmup_steps)

        def sched(n: int) -> float:
            s = f32(max(n, 1))
            return float(f32(cfg.lr * w**0.5) * np.minimum(s ** f32(-0.5), s * f32(w**-1.5)))

        return sched
    if cfg.schedule == "linear":  # optax.linear_schedule(0, lr, warmup)
        def sched(n: int) -> float:
            frac = f32(1) - f32(min(max(n, 0), cfg.warmup_steps)) / f32(cfg.warmup_steps)
            return float(f32(0.0 - cfg.lr) * frac + f32(cfg.lr))

        return sched
    if cfg.schedule == "constant":
        return lambda n: float(f32(cfg.lr))
    if cfg.schedule == "warmup_cosine":
        # optax.warmup_cosine_decay_schedule(0, lr, warmup, total)
        warmup, decay = cfg.warmup_steps, cfg.total_steps - cfg.warmup_steps
        if decay <= 0:
            raise ValueError(f"the cosine decay needs total_steps > warmup_steps, got "
                             f"{cfg.total_steps} and {warmup}")

        def sched(n: int) -> float:
            if n < warmup:  # linear from 0 to lr
                frac = f32(1) - f32(min(max(n, 0), warmup)) / f32(warmup)
                return float(f32(0.0 - cfg.lr) * frac + f32(cfg.lr))
            count = f32(min(n - warmup, decay))
            cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * count / f32(decay)))
            return float(f32(cfg.lr) * cosine)

        return sched
    raise ValueError(
        f"schedule must be warmuplr|linear|constant|warmup_cosine, got {cfg.schedule}"
    )


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over every element of ``tensors``, f32."""
    return torch.stack([(t.float() * t.float()).sum() for t in tensors]).sum().sqrt()


class AdamW:
    """Clip + AdamW over ``params`` (the trainable tensors, updated in
    place). ``update(grads)`` takes one gradient per parameter. ``norm``
    computes the clipping norm of a list of gradients: ``global_norm``, or
    over a mesh the norm of the whole tensors from each rank's shards
    (``train.step``); the update itself runs on whatever part of each
    tensor this rank holds, its masters and moments of the same shape."""

    def __init__(self, params: Sequence[torch.Tensor], cfg: OptimConfig, accum_grad: int = 1,
                 norm: Callable[[Sequence[torch.Tensor]], torch.Tensor] = global_norm):
        if cfg.moment_dtype not in _MOMENT_DTYPES:
            raise ValueError(f"moment_dtype must be float32|bfloat16, got {cfg.moment_dtype}")
        self.cfg, self.accum_grad, self.norm = cfg, accum_grad, norm
        self.params = list(params)
        self.schedule = make_schedule(cfg)
        # f32 masters of the non-f32 parameters; f32 ones are their own
        self.masters = [
            p if p.dtype == torch.float32 else p.detach().float() for p in self.params
        ]
        mu_dtype = _MOMENT_DTYPES[cfg.moment_dtype]
        self.mu = [torch.zeros_like(m, dtype=mu_dtype) for m in self.masters]
        self.nu = [torch.zeros_like(m) for m in self.masters]
        self.count = 0  # updates applied
        self.mini_step = 0  # micro-batches accumulated since the last update
        self.acc: List[torch.Tensor] = (
            [torch.zeros_like(m) for m in self.masters] if accum_grad > 1 else []
        )

    def lr(self) -> float:
        """The rate the next update uses."""
        return self.schedule(self.count)

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> bool:
        """One micro-batch's gradients; returns whether the parameters
        changed (every ``accum_grad``-th call)."""
        grads = [g.float() for g in grads]
        if self.accum_grad > 1:
            n = self.mini_step
            for a, g in zip(self.acc, grads):  # running mean (Welford)
                a.add_((g - a) / (n + 1))
            self.mini_step = (n + 1) % self.accum_grad
            if self.mini_step:
                return False
            grads = [a.clone() for a in self.acc]
            for a in self.acc:
                a.zero_()
        self._apply(grads)
        return True

    def _apply(self, grads: List[torch.Tensor]) -> None:
        cfg = self.cfg
        b1, b2 = cfg.betas
        # clip: (g / norm) * max where norm >= max; dividing by 1 and
        # multiplying by 1 leave g exact otherwise
        norm = self.norm(grads)
        clip = norm >= cfg.clip_norm
        one = torch.ones((), device=norm.device)
        torch._foreach_div_(grads, torch.where(clip, norm, one))
        torch._foreach_mul_(grads, torch.where(clip, one * cfg.clip_norm, one))

        mu = torch._foreach_mul(grads, 1 - b1)
        # b1 * mu in the stored dtype, b1 rounded to it first (a bf16
        # product of bf16(b1), as optax's weakly typed scalar gives), then f32
        b1_m = torch.tensor(b1, dtype=self.mu[0].dtype).item()
        torch._foreach_add_(mu, [m.float() for m in torch._foreach_mul(self.mu, b1_m)])
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1 - b2)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, sq)
        del sq
        f32 = np.float32
        t = self.count + 1
        bc1 = float(f32(1) - f32(b1) ** f32(t))
        bc2 = float(f32(1) - f32(b2) ** f32(t))
        den = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, den)
        del den
        if cfg.weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(self.masters, cfg.weight_decay))
        torch._foreach_mul_(upd, -self.lr())
        torch._foreach_add_(self.masters, upd)
        self.mu = [m.to(self.mu[0].dtype) for m in mu]
        self.count = t
        for p, m in zip(self.params, self.masters):
            if p is not m:
                p.copy_(m)
