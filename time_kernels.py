#!/usr/bin/env python3
"""Time the port's kernels from one tree of the port, so that two trees can
be compared on one card.

    python3 time_kernels.py --root DIR [--out FILE]

``--root`` is a checkout holding ``chip_smoke.py`` and
``robustsq_whisper_torch/`` (this one by default). The script builds that
tree's kernels and runs that tree's own ``chip_smoke.check_kernels``,
``chip_smoke.check_flash_kernels`` and ``chip_smoke.check_w8a8_kernel``:
each kernel against its plain version at the Whisper-medium shapes, with
its median device time (CUDA-graph replay), its plain version's, its bound
and the library call's (the W8A8 row at every decode and encoder shape,
beside ``torch._int_mm`` and bf16 ``F.linear``). Then this script's own
``chip_smoke.cross_cold_times`` times that tree's packed int4 cross
kernel with every layer read cold (the main path's 24-layer
sweep and the JAX bench's batch 128 greedy and batch 64 x 5 beam shapes),
so two trees are timed there by the same code, and its own
``chip_smoke.self_main_times`` and ``chip_smoke.self_cold_times`` time
that tree's public self-cache reads the same way, at the main path's
shapes (20 calls a graph) and at the JAX bench's (layers in turns, so many
that every call reads cold). The last line is one JSON object: the tree,
the card's name and power limit, the kernel rows, the cold cross rows and
the self-cache rows. Run it once a tree, in turns (parent, change, change,
parent), in one call on one card. Needs one CUDA device; without one it
exits non-zero.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--out", default=None, help="also write the JSON record here")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)  # the tree's chip_smoke and package, not this one's

    import torch

    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from robustsq_whisper_torch.ops import _build

    for mod in (chip_smoke, _build):
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            raise RuntimeError(f"{mod.__name__} came from {mod.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    secs, _ = _build.build_all()
    chip_smoke.log(f"tree {root}; kernel build {secs:.1f} s")
    rows = chip_smoke.check_kernels(torch, dev, 4, 32, 5)
    rows += chip_smoke.check_flash_kernels(torch, dev)
    rows.append(chip_smoke.check_w8a8_kernel(torch, dev))
    spec = importlib.util.spec_from_file_location("chip_smoke_timer", os.path.join(HERE, "chip_smoke.py"))
    timer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timer)
    from robustsq_whisper_torch.ops import decode_attention as xa
    from robustsq_whisper_torch.ops import self_attention as sa

    cold = timer.cross_cold_times(torch, dev, xa)
    self_reads = timer.self_main_times(torch, dev, sa) + timer.self_cold_times(torch, dev, sa)
    for kind, rs in (("cold cross", cold), ("self-cache read", self_reads)):
        for r in rs:
            split = f"S {r['splits']}, " if "splits" in r else f"{r['layers']} layers, "
            chip_smoke.log(f"{kind}, {r['shape']}: {split}ms {r['ms']:.5f}, "
                           f"bound_ms {r['bound_ms']:.5f}, share {r['share']:.3f}")
    record = {"root": root, "gpu": chip_smoke.gpu_info(), "kernels": rows, "cross_cold": cold,
              "self_reads": self_reads}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
