"""Multi-process runs of the port over gloo for the parallel tests.

``launch(scenario, world, workdir)`` starts ``world`` worker processes of
this file, each with one torch thread, the environment
``torch.distributed.run`` gives its ranks (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT`` on a free port), and a
time limit; a worker's process group times its collectives out after 60 s
(``inputs.pt``'s ``timeout_s``, if it has one).
The workers import torch and the port only: the JAX references are
computed in the test's own process and handed over as ``.pt`` files in
``workdir`` (``inputs.pt``), the workers write ``out-{rank}.pt`` there.
Not collected by pytest (the name does not start with ``test_``).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from typing import Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(scenario: str, world: int, workdir: str, timeout: float = 120.0,
           extra_env: Optional[Dict[str, str]] = None) -> List[str]:
    """Run ``scenario`` on ``world`` ranks; returns each rank's output and
    raises with them when a rank fails or runs out of time."""
    port = str(free_port())
    procs = []
    for r in range(world):
        env = dict(
            os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", RANK=str(r),
            LOCAL_RANK=str(r), WORLD_SIZE=str(world), MASTER_ADDR="localhost",
            MASTER_PORT=port, **(extra_env or {}),
        )
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), scenario, workdir],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    outs, failed = [], False
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            out += f"\n[timed out after {timeout} s]"
            failed = True
        failed |= p.returncode != 0
        outs.append(out)
    if failed:
        raise AssertionError("\n".join(f"--- rank {r}:\n{o[-3000:]}" for r, o in enumerate(outs)))
    return outs


# ---- the worker ----

def _worker(scenario: str, workdir: str) -> None:
    import torch

    torch.set_num_threads(1)
    from robustsq_whisper_torch.parallel import mesh

    mesh.FSDP_MIN_ELEMS = 0  # fully shard down to the smallest tensor

    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    world = mesh.init_distributed(device="cpu", timeout_s=inp.get("timeout_s", 60.0))
    assert world == int(os.environ["WORLD_SIZE"]), world
    rank = torch.distributed.get_rank()
    out = SCENARIOS[scenario](inp, workdir)
    torch.save(out, os.path.join(workdir, f"out-{rank}.pt"))
    torch.distributed.destroy_process_group()


def _decoders(inp, dec_kw):
    from robustsq_whisper_torch.models import TSDecoder, WhisperDims

    dec = TSDecoder(WhisperDims(**inp["dims"]), startofprev_token=inp["sop"],
                    cross_kv_bits=inp.get("cross_kv_bits", 8), **dec_kw)
    dec.load_state_dict(inp["decoder"])
    return dec.eval()


def _decode(inp, workdir):
    """Each case: (name, decoder kwargs, DecodeConfig kwargs, (n_data,
    n_model)); the whole batch's outputs through ``build_decode_fns``'s
    decoder (``decode/sharded.py``) on this rank's rows, on
    ``inp["device"]`` (default the CPU; the collectives are gloo's
    either way)."""
    import torch

    from robustsq_whisper_torch.decode.search import DecodeConfig
    from robustsq_whisper_torch.decode.sharded import build_sharded_decoder, build_tp_decoder
    from robustsq_whisper_torch.parallel.mesh import local_rows, make_mesh

    out = {}
    dev = torch.device(inp.get("device", "cpu"))
    memory, prompt = (torch.from_numpy(inp[k]).to(dev) for k in ("memory", "prompt"))
    for name, dec_kw, cfg_kw, (n_data, n_model) in inp["cases"]:
        mesh = make_mesh(n_data, n_model, device_type="cpu")
        cfg = DecodeConfig(**cfg_kw)
        dec = _decoders(inp, dec_kw)
        if n_model > 1:
            run = build_tp_decoder(dec, cfg, mesh, device=dev)
        else:
            run = build_sharded_decoder(dec, cfg, mesh, device=dev,
                                        return_stats=cfg.speculative_gamma > 0)
        res = run(local_rows(memory, mesh), local_rows(prompt, mesh))
        out[name] = [r if isinstance(r, dict) else r.cpu().numpy() for r in res]
        if len(res) == 3:
            out[name][2] = {k: v.cpu().numpy() for k, v in res[2].items()}
    if "embedding" in inp:
        out["embedding"] = _embedding_decode(inp["embedding"])
    return out


def _embedding_decode(e):
    """The embedding-enrollment encoder and its prompt-free decoder through
    ``build_decode_fns`` on a data mesh of every rank: the whole batch's
    tokens and scores."""
    import torch

    from robustsq_whisper_torch.decode.pipeline import build_decode_fns
    from robustsq_whisper_torch.decode.search import DecodeConfig
    from robustsq_whisper_torch.models import SpkAdapterTSEncoder, TSDecoder, TSEncoderConfig
    from robustsq_whisper_torch.models import WhisperDims
    from robustsq_whisper_torch.parallel.mesh import make_mesh

    dims = WhisperDims(**e["dims"])
    enc = SpkAdapterTSEncoder(dims, TSEncoderConfig(**e["ts"]))
    enc.load_state_dict(e["encoder"])
    dec = TSDecoder(dims, use_spk_prompt=False)
    dec.load_state_dict(e["decoder"])
    encode, run = build_decode_fns(enc.eval(), dec.eval(), DecodeConfig(**e["cfg"]),
                                   mesh=make_mesh(), device="cpu")
    tokens, scores = run(*encode(*map(torch.from_numpy, e["inputs"])))
    return tokens.numpy(), scores.numpy()


def _train_model(inp, ts, cfg):
    from robustsq_whisper_torch.models import TSASRModel, TSEncoderConfig, TSModelConfig
    from robustsq_whisper_torch.models import WhisperDims

    model = TSASRModel(WhisperDims(**inp["dims"]), TSEncoderConfig(**{**inp["ts"], **ts}),
                       TSModelConfig(**{**inp["cfg"], **cfg}))
    model.load_state_dict(inp["state_dict"])
    return model


def _whole(state):
    """Every parameter and LoRA factor of ``state``, whole (a gather)."""
    from robustsq_whisper_torch.parallel.shard import full_tensor

    params = {n: full_tensor(state.layout, n, p.detach()).cpu()
              for n, p in state.model.named_parameters()}
    lora = {n: (a.detach().cpu(), b.detach().cpu()) for n, (a, b) in state.lora.items()}
    return params, lora


def _train(inp, workdir):
    """Each case: (name, (n_data, n_model), TrainConfig kwargs, TS
    overrides, TSModelConfig overrides, steps); per step the stats, then
    the whole weights and what this rank stores of each fully sharded
    parameter and its moments. The steps draw from a generator seeded 0,
    on ``inp["device"]`` (default the CPU)."""
    import torch

    from robustsq_whisper_torch.parallel.mesh import make_mesh
    from robustsq_whisper_torch.train import lora as tlora
    from robustsq_whisper_torch.train import optim as toptim
    from robustsq_whisper_torch.train import step as tstep

    out = {}
    dev = torch.device(inp.get("device", "cpu"))
    torch.backends.cudnn.allow_tf32 = False  # the conv stems in f32 on a card
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    for name, shape, tkw, ts, cfg, steps in inp["cases"]:
        mesh = make_mesh(*shape, device_type="cpu")
        model = _train_model(inp, ts, cfg)
        tcfg = tstep.TrainConfig(optim=toptim.OptimConfig(**inp["optim"]),
                                 lora=tlora.LoraConfig(rank=2), **tkw)
        lora = inp["lora"] if tcfg.mode == "lora" else None
        state = tstep.create_train_state(model, tcfg, device=dev, lora=lora, mesh=mesh)
        fn = tstep.make_train_step(model, tcfg, device=dev, mesh=mesh)
        gen = torch.Generator(dev).manual_seed(0)
        stats = []
        for _ in range(steps):
            state, st = fn(state, batch, gen, 6)
            stats.append({k: float(v) for k, v in st.items()})
        names = {id(p): n for n, p in model.named_parameters()}
        stored = {  # name: (param, master, mu, nu) elements held here
            names[id(p)]: (p.numel(), m.numel(), mu.numel(), nu.numel())
            for p, m, mu, nu in zip(state.opt.params, state.opt.masters, state.opt.mu,
                                    state.opt.nu)
            if id(p) in names
        }
        params, lora_out = _whole(state)
        out[name] = dict(stats=stats, params=params, lora=lora_out, stored=stored,
                         fsdp=sorted(state.layout.fsdp), tp=sorted(state.layout.tp))
    return out


def _run_training(inp, workdir):
    """``run_training`` of the dev smoke model over a Kaldi dir on a data
    mesh of every rank, fully sharded down to the smallest tensor, saving
    its checkpoints to ``inp["ckpt_dir"]``."""
    import torch

    from robustsq_whisper_torch.parallel.mesh import make_mesh

    state = _dev_run(inp, mesh=make_mesh())
    return {"fsdp": sorted(state.layout.fsdp), "step": state.step}


def _dev_run(inp, mesh=None):
    """The dev smoke model trained by ``run_training`` (``inp``: config,
    train_dir, ranks, ckpt_dir, epochs); shared with the single-device
    reference of the test."""
    import dataclasses

    import torch

    from robustsq_whisper_torch.cli.train import build_model
    from robustsq_whisper_torch.data.dataset import KaldiTSDataset
    from robustsq_whisper_torch.tokenizer.whisper_tokenizer import load_tokenizer
    from robustsq_whisper_torch.train.loop import LoopConfig, run_training
    from robustsq_whisper_torch.utils.config import load_experiment

    exp = load_experiment(inp["config"])
    tok = load_tokenizer(inp["ranks"])
    ds = KaldiTSDataset(inp["train_dir"], tok, speech_seconds=exp.speech_seconds,
                        enroll_seconds=exp.enroll_seconds, utt_style=exp.utt_style,
                        num_speakers=exp.model.num_speakers, seed=0)
    return run_training(
        build_model(exp, 0, "cpu"), ds, dataclasses.replace(exp.train, fsdp=True),
        LoopConfig(num_epochs=inp["epochs"], batch_size=2, ckpt_dir=inp["ckpt_dir"],
                   log_every=1),
        generator=torch.Generator().manual_seed(0), device="cpu", mesh=mesh,
    )


def _cli(inp, workdir):
    """``cli.decode.main`` on each argv of ``inp["decode"]``, then, with
    ``inp["serve"]``, ``cli.serve``'s engine: rank 0 serves HTTP on a free
    port and posts ``inp["requests"]`` (speech, enrollment WAV bytes) to
    it, the other ranks follow; with ``inp["idle_s"]`` rank 0 waits that
    long before its last request. Returns rank 0's texts."""
    import base64
    import json
    import threading
    import time
    import urllib.request

    import torch

    from robustsq_whisper_torch.cli import decode as pdecode
    from robustsq_whisper_torch.cli import serve as pserve
    from robustsq_whisper_torch.serve.server import make_server

    for argv in inp.get("decode", ()):
        assert pdecode.main(argv) == 0
    if "serve" not in inp:
        return {}
    engine, info = pserve.build_engine(pserve.parse_args(inp["serve"]))
    if torch.distributed.get_rank() != 0:
        engine.follow()
        return {}
    server, batcher = make_server(engine, "127.0.0.1", 0, max_wait_ms=200.0, info=info)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/v1/transcribe"
    texts = []
    for i, (speech, enroll) in enumerate(inp["requests"]):
        if i and i == len(inp["requests"]) - 1:
            time.sleep(inp.get("idle_s", 0.0))
        body = json.dumps({"speech_wav": base64.b64encode(speech).decode(),
                           "enroll_wav": base64.b64encode(enroll).decode()}).encode()
        req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            texts.append(json.loads(resp.read())["text"])
    server.shutdown()
    batcher.close()
    server.server_close()
    engine.close()
    return {"texts": texts}


SCENARIOS = {"decode": _decode, "train": _train, "run_training": _run_training, "cli": _cli}


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2])
