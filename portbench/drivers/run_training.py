"""Driver of the training job: ``train.loop.run_training`` over a
benchmark-owned in-memory dataset, one epoch whose batches stop at the
deadline, no checkpoint directory and no validation, on one GPU or on a
``(ranks, 1)`` data-parallel mesh (every rank handed the whole batch).

Set-up makes the weights, the LoRA factors and the pool of batches from the
seed, then drives the same model through its first three steps with the
window's own call (``run_training``), loop settings, feed and generator, on
three distinct batches: that warms every shape the window uses. The window
then calls ``run_training`` again on that model and generator. The set-up
steps are read without wrapping the program: each step's loss from the
model's forward output (a forward hook), each trainable leaf's first
gradient as its backward leaves it (post-accumulate-grad hooks; before the
exchange between ranks and the clipping: on a mesh the ranks' copies are
averaged here, as the exchange does), and the parameters' change from the
f32 masters of the state that ``run_training`` returns (the bf16 parameters
hardly move under the warm-up's first rates), against the weights made
again from the seed and the LoRA factors handed in.

After the window the plain reference follows those three steps from the
same weights, batches and draw seed: ``loss_gap`` is the worst of the three
steps' relative loss gaps, ``grad_gap`` the worst leaf's gap between the
norms of the first gradient as the optimizer gets it (before clipping), and
``change_gap`` the worst leaf's gap between the norms of the parameters'
change over the three steps, each leaf's gap over the larger of the
reference leaf's norm and the median leaf's. Leaves whose first reference
gradient is under a thousandth of the median leaf's are left out of both
(they move by round-off alone). The window's own steps, which the loop
reports only as means over ``log_every`` steps, are checked for finite
losses.
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from portbench import flops, traffic as traffic_mod
from portbench.harness import Marks, SubWindow
from portbench.reference.model import AdamW as RefAdamW, Ref, lora_targets, param_specs
from portbench.weights import generator, make_lora, make_weights

SETUP_STEPS = 3
SMALL_LEAF = 1e-3


class BatchDataset:
    """Batches from the pool, in order: ``n`` of them, or cycling until a
    stop that every rank agrees on (``stop()``), checked at each request."""

    def __init__(self, pool: List[dict], n: int = 0, stop=None, on_request=None):
        self.pool, self.n, self.stop, self.on_request = pool, n, stop, on_request
        self.requests: List[float] = []
        self.audio_s = 0.0

    def batches(self, batch_size: int, shuffle: bool = True, drop_last: bool = True):
        k = 0
        while True:
            self.requests.append(time.perf_counter())
            if self.on_request is not None:
                self.on_request(k)
            if (self.n and k >= self.n) or (self.stop is not None and self.stop(k)):
                return
            batch = self.pool[k % len(self.pool)]
            if len(batch["speech_lens"]) != batch_size:
                raise ValueError(f"pool batches hold {len(batch['speech_lens'])} rows, "
                                 f"the loop asks for {batch_size}")
            self.audio_s += float(batch["speech_lens"].sum()) / traffic_mod.SR
            yield batch
            k += 1


def graph_leaves(t: torch.Tensor) -> List[torch.Tensor]:
    """The leaf tensors whose gradient ``t``'s backward accumulates."""
    seen, stack, out = set(), [t.grad_fn], []
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        leaf = getattr(fn, "variable", None)
        if leaf is not None:
            out.append(leaf)
        stack.extend(f for f, _ in fn.next_functions)
    return out


class SetupProbe:
    """Public hooks on the model for the set-up steps: every step's loss
    (the ``loss`` of the forward's stats) and, in the first step, each leaf's
    gradient once its backward has accumulated it: its norm, or on a mesh a
    copy, averaged over the ranks by ``first_grads``."""

    def __init__(self, model, world: int):
        self.model, self.world = model, world
        self.losses: List[torch.Tensor] = []
        self.grads: Dict[int, torch.Tensor] = {}
        self.handles: list = []

    def __enter__(self):
        self.handles.append(self.model.register_forward_hook(self.forward_done))
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        self.handles = []

    def forward_done(self, module, args, out):
        loss, stats = out
        self.losses.append(stats["loss"].detach().float().clone())
        if len(self.losses) == 1:
            for leaf in graph_leaves(loss):
                self.handles.append(leaf.register_post_accumulate_grad_hook(self.grad_done))

    def grad_done(self, leaf: torch.Tensor) -> None:
        if id(leaf) in self.grads:
            return
        g = leaf.grad.detach().float()
        self.grads[id(leaf)] = g.norm() if self.world == 1 else g.clone()

    def first_grads(self, names: Dict[int, str]) -> Dict[str, float]:
        """{leaf name: norm of its first gradient} (the ranks' mean)."""
        out = {}
        for i, g in self.grads.items():
            if self.world > 1:
                torch.distributed.all_reduce(g)
                g = (g / self.world).norm()
            out[names[i]] = float(g.double())
        return out

    def step_losses(self, ctx) -> List[float]:
        mine = [float(x) for x in self.losses]
        return [sum(r) / len(r) for r in zip(*ctx.gather(mine))]


def leaf_names(model, state) -> Dict[int, str]:
    """{id: name} of the returned state's trainable leaves: the model's
    parameters by name, the LoRA factors as ``<weight>.lora_a`` / ``_b``."""
    names = {id(p): n for n, p in model.named_parameters()}
    for n, (a, b) in state.lora.items():
        names[id(a)], names[id(b)] = f"{n}.lora_a", f"{n}.lora_b"
    return names


def master_change(ctx, state, names: Dict[int, str], lora) -> Dict[str, float]:
    """{leaf name: norm of (f32 master after the set-up steps - its start:
    the weight made again from the seed, or the LoRA factor handed in)}."""
    start = make_weights(param_specs(ctx.config, heads=True), ctx.seed, ctx.device)
    for n, (a, b) in (lora or {}).items():
        start[f"{n}.lora_a"], start[f"{n}.lora_b"] = a, b
    out = {}
    for t, m in zip(state.trainables, state.opt.masters):
        n = names[id(t)]
        out[n] = float((m.detach().double() - start[n].double()).norm())
    return out


def trainable_groups(mode: str) -> Dict[str, bool]:
    """Weight groups (``flops``) whose gradients a step computes."""
    ts_modules = {"qformer": True, "prompt_proj": True, "adapter": True, "ctc": True}
    if mode == "full":
        return {g: True for g in ("conv1", "conv2", "encoder_attn", "encoder_mlp", "decoder_attn",
                                  "decoder_cross", "decoder_mlp", "token_embedding", *ts_modules)}
    if mode == "lora":  # the targets' merged weights take their gradient
        return {**ts_modules, "encoder_attn": True, "decoder_attn": True, "decoder_cross": True}
    return ts_modules


def run(ctx) -> SimpleNamespace:
    from robustsq_whisper_torch.train.loop import LoopConfig, run_training

    cfg, tr, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    B = tr["batch_size"]
    mesh = ctx.mesh()
    pool = traffic_mod.train_pool(tr, cfg, seed, dev)
    weights = make_weights(param_specs(cfg, heads=True), seed, dev)
    model = ctx.program.training_model(cfg, weights, dev)
    del weights
    tcfg = ctx.program.train_config(cfg, tr)
    lora = None
    if tr["mode"] == "lora":
        shapes = dict(param_specs(cfg, heads=True))
        targets = lora_targets(shapes, cfg["training"]["lora"]["targets"])
        lora = make_lora([(n, shapes[n]) for n in targets], cfg["training"]["lora"]["rank"], seed, dev)

    loop = LoopConfig(num_epochs=1, batch_size=B)
    gen = generator(seed, "draws", dev)
    with SetupProbe(model, ctx.world) as probe:
        state = run_training(model, BatchDataset(pool[:SETUP_STEPS], n=SETUP_STEPS), tcfg, loop,
                             generator=gen, device=dev, lora=lora, mesh=mesh)
    names = leaf_names(model, state)
    setup = {"losses": probe.step_losses(ctx), "grad": probe.first_grads(names),
             "change": master_change(ctx, state, names, lora)}
    del state, probe
    gc.collect()
    ctx.empty_cache()
    ctx.sync()

    # the window
    marks, sub = Marks(torch), (SubWindow(torch) if ctx.trace else None)
    prof = tr["profile_steps"]
    t_deadline = {}

    def stop(k: int) -> bool:
        if k == 0:
            t_deadline["t"] = time.perf_counter() + ctx.seconds
        return ctx.agree(time.perf_counter() >= t_deadline["t"])

    def on_request(k: int) -> None:
        if k == 0:
            ctx.window_started()
        marks.close("step")
        if sub is not None and k == prof[0]:
            sub.start()
        elif sub is not None and k == prof[1] and sub.t0 is not None:
            sub.stop()
        marks.open("step")

    window_log: List[dict] = []
    ds = BatchDataset(pool[SETUP_STEPS:] + pool[:SETUP_STEPS], stop=stop, on_request=on_request)
    state = run_training(model, ds, tcfg, loop, generator=gen,
                         metrics_hook=lambda s, v: window_log.append(v), device=dev, lora=lora, mesh=mesh)
    t_end = time.perf_counter()
    marks.close("step")
    if sub is not None and sub.t0 is not None and sub.t1 is None:
        sub.stop()
    steps = state.step
    wall = t_end - ds.requests[0]
    # the loop logs the mean of every log_every steps: a non-finite mean
    # fails its steps
    chunk = loop.log_every
    bad = chunk * sum(1 for v in window_log if "loss" in v and not np.isfinite(v["loss"]))
    sub_steps = None if sub is None or sub.t1 is None else min(prof[1], steps) - prof[0]
    obs = SimpleNamespace(
        kind="train", config=cfg, traffic=tr, sub=sub, sub_steps=sub_steps,
        rows=B // ctx.world, text_len=traffic_mod.text_pad(tr), world=ctx.world,
        enroll_frames=int(tr["enroll_seconds"] * traffic_mod.SR) // 160,
        trainable=trainable_groups(tr["mode"]),
        memory_len=flops.memory_len(cfg),
    )
    memory_peak = ctx.memory_peak()
    del state, model
    gc.collect()
    ctx.empty_cache()
    ctx.gather_subwindow(obs)
    checks = check(ctx, pool, setup) if ctx.rank == 0 else {}
    return SimpleNamespace(
        end_to_end={"train_audio_s_per_gpu_s": ds.audio_s / (wall * ctx.world)},
        attempted=steps, failed=bad, obs=obs, memory_peak=memory_peak,
        checks=checks, detail={"steps": steps, "audio_s": ds.audio_s, "window_wall_s": wall,
                               "setup_losses": setup["losses"],
                               "step_s_quartiles": [round(float(q), 4) for q in np.percentile(
                                   np.diff(ds.requests), [0, 25, 50, 75, 100])]},
    )


def reference_steps(ctx, pool, lowp=None):
    """The reference's three steps: (losses, {leaf: first gradient norm,
    before clipping}, {leaf: change norm after three updates})."""
    cfg, tr, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    specs = param_specs(cfg, heads=True)
    P = {k: v.float() for k, v in make_weights(specs, seed, dev).items()}
    lora = {}
    if tr["mode"] == "lora":
        shapes = dict(specs)
        names = lora_targets(shapes, cfg["training"]["lora"]["targets"])
        lora = make_lora([(n, shapes[n]) for n in names], cfg["training"]["lora"]["rank"], seed, dev)
    if tr["mode"] == "full":
        leaves = dict(P)
    else:
        rx = __import__("re").compile(cfg["training"]["trainable"])
        leaves = {n: t for n, t in P.items() if rx.match(n)}
        for n, (a, b) in lora.items():
            leaves[f"{n}.lora_a"], leaves[f"{n}.lora_b"] = a, b
    for t in leaves.values():
        t.requires_grad_(True)
    start = {n: t.detach().clone() for n, t in leaves.items()}
    ref = Ref(P, cfg, lora=lora, lowp=lowp)
    opt = RefAdamW(leaves, {**tr["optim"], "betas": tuple(tr["optim"]["betas"])})
    gen = generator(seed, "draws", dev)
    losses, first = [], {}
    for k in range(SETUP_STEPS):
        batch = {n: torch.from_numpy(v).to(dev) for n, v in pool[k].items()}
        loss, _ = ref.loss(batch, gen, epoch=0.0)
        loss.backward()
        grads = {n: (t.grad if t.grad is not None else torch.zeros_like(t)) for n, t in leaves.items()}
        if k == 0:
            first = {n: float(g.double().norm()) for n, g in grads.items()}
        opt.step(grads)
        for t in leaves.values():
            t.grad = None
        losses.append(float(loss.detach()))
        del loss, grads
    change = {n: float((t.detach().double() - start[n].double()).norm()) for n, t in leaves.items()}
    return losses, first, change


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], counted: List[str], median: float):
    """(worst gap, its leaf) of |prog - ref| / max(ref, median) over
    ``counted``; a leaf the program lacks counts as a gap of 1."""
    worst, leaf = 0.0, ""
    for n in counted:
        p = prog.get(n)
        g = 1.0 if p is None else abs(p - ref[n]) / max(ref[n], median)
        if g > worst:
            worst, leaf = g, n
    return worst, leaf


def numbers(losses_prog, grad_prog, change_prog, losses_ref, first_ref, change_ref):
    med_all = float(np.median(list(first_ref.values())))
    counted = [n for n, v in first_ref.items() if v >= SMALL_LEAF * med_all]
    med = float(np.median([first_ref[n] for n in counted]))
    med_change = float(np.median([change_ref[n] for n in counted]))
    loss_gap = max((abs(p - r) / abs(r) for p, r in zip(losses_prog, losses_ref)), default=float("nan"))
    if len(losses_prog) != len(losses_ref):
        loss_gap = float("nan")
    g, g_leaf = leaf_gap(grad_prog, first_ref, counted, med)
    c, c_leaf = leaf_gap(change_prog, change_ref, counted, med_change)
    return {"loss_gap": (loss_gap, f"steps 1-{len(losses_ref)}"),
            "grad_gap": (g, f"{len(counted)} of {len(first_ref)} leaves, worst {g_leaf}"),
            "change_gap": (c, f"{len(counted)} leaves, worst {c_leaf}")}


def check(ctx, pool, setup) -> Dict[str, dict]:
    ctx.reference_mode()
    losses_ref, first_ref, change_ref = reference_steps(ctx, pool)
    out = numbers(setup["losses"], setup["grad"], setup["change"], losses_ref, first_ref, change_ref)
    return {k: {"value": v, "limit": ctx.limits[k], "rule": "at most", "over": over}
            for k, (v, over) in out.items()}
