"""One rank of the data-parallel training mix cut to a tiny size and run on the
CPU over gloo (``python -m torch.distributed.run --nproc_per_node N
dp_worker.py SEED FAULT``); rank 0 prints the result line. FAULT ``none``,
or ``no_exchange``: the gradients' exchange between ranks left out."""

import datetime
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from portbench import run  # noqa: E402
from portbench.tests.tiny import tiny_cell  # noqa: E402
from robustsq_whisper_torch.parallel.mesh import init_distributed  # noqa: E402


def main(seed: int, fault: str) -> None:
    torch.set_num_threads(1)
    if fault == "no_exchange":
        from robustsq_whisper_torch.train import step

        step.sync_grads = lambda state, grads: None
    world = init_distributed(device="cpu")
    cell = tiny_cell("qformer_medium.train_full_dp4")
    cell.traffic = {**cell.traffic, "batch_size": 2 * world}
    args = run.parse(["--workload", cell.name, "--seed", str(seed), "--seconds", "1", "--trace", "0"])
    rank = torch.distributed.get_rank()
    group = torch.distributed.new_group(backend="gloo", timeout=datetime.timedelta(minutes=10))
    ctx, res = run.run_here(cell, args, "cpu", world, rank, group)
    if rank == 0:
        print(json.dumps(run.result_line(cell, args, ctx, res, setup_s=1.0)), flush=True)
    torch.distributed.barrier(group=group)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), sys.argv[2])
