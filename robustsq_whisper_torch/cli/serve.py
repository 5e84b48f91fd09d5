"""Online serving CLI: the micro-batching HTTP transcription daemon on the
port.

Usage::

    python -m robustsq_whisper_torch.cli.serve \
        --config conf/tswhisper/train_..._.yaml \
        --expdir exp/tswhisper --port 8080

    curl -s localhost:8080/v1/transcribe -d '{
      "speech_wav": "<base64 wav>", "enroll_wav": "<base64 wav>"}'

The flags are the JAX package's ``cli.serve`` flags plus ``--device``
(default ``cuda``); the weights come as in ``cli.decode``.
``--speculative_gamma G`` serves by speculative greedy decode, with a
self-draft or, with ``--draft_path``, a distilled draft (``cli.distill``);
``--int8_weights true`` serves the token steps with W8A8 step weights.
``build_engine(args)`` builds the ``TranscriptionEngine`` without serving,
so a caller can put ``serve.server.make_server`` over it in its own thread.

Several GPUs: ``python -m torch.distributed.run --nproc_per_node N -m
robustsq_whisper_torch.cli.serve ...`` with ``--data_parallel`` /
``--model_parallel`` as in ``cli.decode``: rank 0 serves HTTP, and every
batch it runs, the other ranks run with it (``TranscriptionEngine.follow``).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging

from .decode import distributed_setup, make_decode_mesh, str2bool

# flags of paths the port does not have: (flag, is it set?, why)
SERVE_UNSUPPORTED = (
    ("--compile_cache", lambda a: bool(a.compile_cache),
     "a persistent XLA compilation cache has no counterpart here (the "
     "kernels are built once into robustsq_whisper_torch/_build)"),
)


def check_supported(parser: argparse.ArgumentParser, args) -> None:
    for flag, is_set, why in SERVE_UNSUPPORTED:
        if is_set(args):
            parser.error(f"{flag}: {why}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", required=True)
    p.add_argument("--inference_config", default=None)
    p.add_argument("--expdir", default=None)
    p.add_argument("--tokenizer_assets", default=None)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--device", default="cuda",
                   help="cuda (the hand-written kernels) or cpu (their plain "
                   "PyTorch versions)")
    p.add_argument("--batch_size", type=int, default=8,
                   help="static device batch; the micro-batcher coalesces "
                   "concurrent requests up to this size")
    p.add_argument("--max_wait_ms", type=float, default=15.0,
                   help="micro-batching window after the first queued request")
    p.add_argument("--language", default="en")
    p.add_argument("--use_ave", type=str2bool, default=True)
    p.add_argument("--use_flash", type=str2bool, default=True)
    p.add_argument("--flash_tmaj", type=str2bool, default=True)
    p.add_argument("--gelu_approx", type=str2bool, default=False)
    p.add_argument("--int8_weights", type=str2bool, default=False)
    p.add_argument("--quantize_cross_kv", type=str2bool, default=True,
                   help="quantized cross-attention decode kernel (width from "
                   "--cross_kv_bits)")
    p.add_argument("--cross_kv_bits", type=int, default=8, choices=(4, 8))
    p.add_argument("--self_kv_bits", type=int, default=16, choices=(8, 16))
    p.add_argument("--prefill_quantized", type=str2bool, default=False)
    p.add_argument("--speculative_gamma", type=int, default=0,
                   help="speculative greedy serving (0 = off; beam_size 1 only)")
    p.add_argument("--draft_layers", type=int, default=4,
                   help="self-draft depth for --speculative_gamma")
    p.add_argument("--draft_path", default=None)
    p.add_argument("--enc_chunk", type=int, default=0)
    p.add_argument("--data_parallel", type=str2bool, default=True,
                   help="split each batch over the ranks of a multi-process launch "
                   "(a no-op on one device)")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="tensor-parallel group size (must divide the world size)")
    p.add_argument("--warmup", type=str2bool, default=True,
                   help="run one batch (building the kernels) before serving")
    p.add_argument("--compile_cache", default=None)
    p.add_argument("--max_queue", type=int, default=0,
                   help="admission-queue bound; beyond it requests shed with "
                   "503 (0 = 4 device batches)")
    p.add_argument("--max_body_mb", type=int, default=64,
                   help="reject request bodies over this size with 413")
    p.add_argument("--result_timeout_s", type=float, default=120.0,
                   help="504 when a request has no result in this time")
    p.add_argument("--seed", type=int, default=0)
    return p


def parse_args(argv=None) -> argparse.Namespace:
    """The flags, after joining the process group of a multi-process
    launch (``args.device`` becomes this rank's, ``args.world`` the world
    size)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    check_supported(parser, args)
    spec = max(0, args.speculative_gamma)
    if args.draft_path and not spec:
        parser.error("--draft_path requires --speculative_gamma > 0")
    if spec and args.model_parallel > 1:
        parser.error(
            "--speculative_gamma is incompatible with --model_parallel: "
            "the ragged verify path is single-chip/DP only"
        )
    device, args.world, _ = distributed_setup(parser, args)
    args.device = str(device)
    if args.draft_path and args.data_parallel and args.world > 1:
        logging.warning(
            "--draft_path serving is single-device; dropping --data_parallel"
        )
        args.data_parallel = False
    return args


def build_engine(args: argparse.Namespace):
    """The ``TranscriptionEngine`` the daemon serves, and the ``info`` its
    ``/healthz`` reports. Raises without CUDA unless ``--device cpu``."""
    from .._device import resolve_device
    from ..decode.pipeline import serving_modules
    from ..serve.engine import EngineConfig, TranscriptionEngine
    from ..tokenizer.whisper_tokenizer import load_tokenizer
    from .decode import decode_config, load_exp, read_draft, serving_weights
    from .train import compute_dtype

    device = resolve_device(args.device)
    exp = load_exp(args)
    draft_sd = read_draft(args) if args.draft_path else None
    tp = max(1, args.model_parallel)
    dcfg = decode_config(exp, args, quantize_cross_kv=args.quantize_cross_kv)
    if tp > 1:  # the dense path (cli.decode's distributed_setup)
        dcfg = dataclasses.replace(
            dcfg, quantize_cross_kv=False, quantize_weights=False, prefill_quantized=False,
        )
    if dcfg.speculative_gamma and dcfg.beam_size > 1:
        raise ValueError(
            "--speculative_gamma serves greedy only: the config's decode "
            f"beam_size is {dcfg.beam_size}"
        )
    dtype = compute_dtype(exp)
    encoder, decoder = serving_modules(
        exp.resolved_dims(), exp.ts, exp.model, serving_weights(exp, args, dtype), dtype,
        device,
        cross_kv_bits=args.cross_kv_bits, self_kv_bits=args.self_kv_bits,
        # speculative decode needs the 5-D cache's per-row writes, and
        # tensor parallelism the 5-D cache's local heads
        flat_self_cache=not dcfg.speculative_gamma and tp == 1,
    )
    draft = None
    if draft_sd is not None:  # built like the target, in the compute dtype
        from ..train.distill import build_draft

        draft = build_draft(decoder, draft_sd, dtype)
    mesh, batch_size = make_decode_mesh(args, getattr(args, "world", 1), tp)
    engine = TranscriptionEngine(
        encoder, decoder, load_tokenizer(args.tokenizer_assets), dcfg,
        EngineConfig(
            batch_size=batch_size, speech_seconds=exp.speech_seconds,
            enroll_seconds=exp.enroll_seconds, enc_chunk=args.enc_chunk,
        ),
        mesh=mesh, draft=draft, device=device,
    )
    return engine, {"config": args.config, "beam_size": dcfg.beam_size}


def main(argv=None) -> None:
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s: %(message)s",
    )
    from ..parallel.mesh import rank
    from ..serve.server import make_server

    args = parse_args(argv)
    engine, info = build_engine(args)
    if rank() != 0:  # runs rank 0's batches until it stops
        engine.follow()
        return
    if args.warmup:
        logging.info("warmup ...")
        logging.info("warmup done in %.1fs", engine.warmup())
    server, batcher = make_server(
        engine, args.host, args.port, args.max_wait_ms, info=info,
        max_queue=args.max_queue,
        max_body_bytes=args.max_body_mb * 1024 * 1024,
        result_timeout_s=args.result_timeout_s,
    )
    host, port = server.server_address[:2]
    logging.info("serving on http://%s:%d (batch %d, wait %.0f ms)",
                 host, port, args.batch_size, args.max_wait_ms)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        batcher.close()
        server.server_close()
        engine.close()


if __name__ == "__main__":
    main()
