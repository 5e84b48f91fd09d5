"""Decode / eval CLI: the recipe's stage 12 (decode a Kaldi data dir, score
WER and CER) on the port.

Usage::

    python -m robustsq_whisper_torch.cli.decode \
        --config conf/tswhisper/train_..._.yaml \
        --inference_config conf/tswhisper/decode_asr_whisper_beam1.yaml \
        --data_dir dump/raw/test_sglspk \
        --expdir exp/tswhisper --output_dir exp/tswhisper/decode_test

The flags are the JAX package's ``cli.decode`` flags plus ``--device``
(default ``cuda``; without CUDA the command raises unless ``--device
cpu``). Weights come from the latest checkpoint under
``{expdir}/checkpoints`` (or its averaged ``ave`` subdirectory) in the
port's format (``train/checkpoint.py``); with no checkpoint the model is
the config's seeded random init. Besides greedy and beam search:

- ``--speculative_gamma G`` decodes speculatively with a self-draft of
  ``--draft_layers`` blocks or, with ``--draft_path``, a distilled draft
  (``cli.distill``);
- ``--ctc_weight w`` runs joint CTC/attention beam search
  (``decode/joint.py``) with the checkpoint's CTC head;
- ``--timestamps true`` decodes Whisper timestamp tokens greedily and
  writes a ``segments`` file beside ``text``;
- ``--long_audio true`` decodes every utterance at full length in
  ``--chunk_seconds`` windows (``decode/long_audio.py``);
- ``--int8_weights true`` serves the token steps with W8A8 step weights
  (``ops/quant.py``; the ``w8a8_matmul`` kernel on the card), quantized
  once when the decoder is built; the prefill stays dense, and joint CTC
  decode resets it (with a warning), as the JAX CLI does;
- ``--enroll_type embedding`` decodes with the embedding-enrollment
  encoder and a prompt-free decoder from the stage-103
  ``{enroll_prefix}.scp`` of the data dir (greedy, beam, speculative and
  joint CTC; not ``--long_audio``).

Several GPUs: launch one process per GPU with ``python -m
torch.distributed.run --nproc_per_node N -m
robustsq_whisper_torch.cli.decode ...``. ``--data_parallel`` (default
true) splits each batch's rows over the ranks (``batch_size`` rounded up
to a multiple of them) and ``--model_parallel M`` (dividing the world)
splits the weights over groups of M ranks on the dense path (no flash, no
W8A8, no quantized cross K/V, the 5-D self cache), as the JAX CLI does;
rank 0 writes the files. ``--draft_path`` and ``--ctc_weight`` decode on
one device and drop ``--data_parallel`` with the JAX CLI's warnings. One
process on a host with several GPUs decodes on one of them.

The flag combinations the JAX CLI refuses stop with its messages.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
from typing import Any, Dict, Optional, Tuple

import torch

def str2bool(v: str) -> bool:
    """Strict boolean flag values: true/false/1/0/yes/no/on/off."""
    lv = v.lower()
    if lv in ("true", "1", "yes", "on"):
        return True
    if lv in ("false", "0", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", required=True)
    p.add_argument("--inference_config", default=None)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--expdir", default=None)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--tokenizer_assets", default=None)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--language", default="en")
    p.add_argument("--device", default="cuda",
                   help="cuda (the hand-written kernels) or cpu (their plain "
                   "PyTorch versions)")
    p.add_argument("--use_flash", type=str2bool, default=True,
                   help="flash kernel for the encoder self-attention")
    p.add_argument("--flash_tmaj", type=str2bool, default=True,
                   help="time-major flash self-attention (with --use_flash)")
    p.add_argument("--use_ave", type=str2bool, default=True,
                   help="decode from the averaged n-best checkpoint when present")
    p.add_argument("--cross_kv_bits", type=int, default=8, choices=(4, 8),
                   help="quantized cross K/V width when quantize_cross_kv is on")
    p.add_argument("--self_kv_bits", type=int, default=16, choices=(8, 16),
                   help="self-attention cache width: 16 (dense) or 8 (int8)")
    p.add_argument("--gelu_approx", type=str2bool, default=False,
                   help="tanh-approximate GELU in the encoder")
    p.add_argument("--int8_weights", type=str2bool, default=False)
    p.add_argument("--data_parallel", type=str2bool, default=True,
                   help="split each batch over the ranks of a multi-process launch "
                   "(a no-op on one device)")
    p.add_argument("--long_audio", type=str2bool, default=False)
    p.add_argument("--chunk_seconds", type=float, default=30.0)
    p.add_argument("--prefill_quantized", type=str2bool, default=False,
                   help="quantize the cross K/V before the prefill (implies "
                   "quantize_cross_kv)")
    p.add_argument("--enc_chunk", type=int, default=0,
                   help="encoder sub-batch size (0 = the whole batch)")
    p.add_argument("--speculative_gamma", type=int, default=0,
                   help="speculative greedy decode: tokens a draft round "
                   "proposes (0 = off)")
    p.add_argument("--draft_layers", type=int, default=4,
                   help="self-draft depth for --speculative_gamma")
    p.add_argument("--draft_path", default=None)
    p.add_argument("--ctc_weight", type=float, default=0.0)
    p.add_argument("--pre_beam", type=int, default=8)
    p.add_argument("--maxlenratio", type=float, default=0.0)
    p.add_argument("--minlenratio", type=float, default=0.0)
    p.add_argument("--min_new_tokens", type=int, default=0,
                   help="suppress eot until this many tokens were emitted")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="tensor-parallel group size (must divide the world size)")
    p.add_argument("--timestamps", type=str2bool, default=False)
    p.add_argument("--enroll_type", default=None, choices=["audio", "embedding"],
                   help="enrollment modality: audio (the Qformer on the enrollment "
                   "waveform) or embedding (stage-103 speaker embeddings at block 0); "
                   "overrides encoder_conf.enroll_type")
    p.add_argument("--enroll_prefix", default="resnet",
                   help="embedding scp basename in the data dir")
    p.add_argument("--seed", type=int, default=0)
    return p


def load_exp(args) -> Any:
    """The experiment config, the inference yaml applied, and the flags
    that override the encoder's serving knobs."""
    from ..utils.config import load_experiment, with_inference_config

    exp = with_inference_config(load_experiment(args.config), args.inference_config)
    return dataclasses.replace(
        exp, ts=dataclasses.replace(
            exp.ts,
            use_flash_attention=bool(args.use_flash),
            flash_tmaj=bool(args.use_flash) and bool(args.flash_tmaj),
            gelu_approx=bool(args.gelu_approx),
        ),
    )


def init_tokens(exp, language: str, timestamps: bool = False) -> Tuple[int, ...]:
    """The sequence a decode starts from: an explicit ``decode_conf.
    init_tokens`` wins (checkpoints trained by ``cli.train`` condition on
    [sos; text]) unless ``timestamps``; otherwise the full Whisper sot
    sequence when the vocabulary has it (without <|notimestamps|> for
    ``timestamps``), else the bare sos."""
    from ..tokenizer.whisper_tokenizer import special_tokens_for_vocab

    st = special_tokens_for_vocab(exp.model.vocab_size)
    if exp.decode_init_tokens_explicit and not timestamps:
        return tuple(exp.decode.init_tokens)
    if exp.model.vocab_size >= st.n_vocab:
        return tuple(st.sot_sequence(language, "transcribe", not timestamps))
    return (exp.model.sos,)


def open_dataset(exp, args, tokenizer, enroll_prefix: str = "resnet"):
    """The Kaldi dir ``args.data_dir``, read as the JAX CLIs read it (the
    embeddings of embedding enrollment from ``{enroll_prefix}.scp``). The
    JAX ``cli.decode`` and ``cli.distill`` draw one unshuffled batch of
    ``args.batch_size`` to initialise their model, which moves the dataset's
    enrollment picks and crops on; the same batch is drawn here, so that
    both packages pick the same enrollments for one ``--seed``."""
    from ..data.dataset import KaldiTSDataset

    dataset = KaldiTSDataset(
        args.data_dir, tokenizer,
        speech_seconds=exp.speech_seconds, enroll_seconds=exp.enroll_seconds,
        utt_style=exp.utt_style, seed=args.seed, enroll_type=exp.ts.enroll_type,
        enroll_prefix=enroll_prefix,
    )
    next(dataset.batches(args.batch_size, shuffle=False, drop_last=False))
    return dataset


def decode_config(exp, args, **extra):
    """The experiment's decode config with the flags' values, eot from the
    model config and ``init_tokens``' sequence."""
    from ..tokenizer.whisper_tokenizer import special_tokens_for_vocab

    st = special_tokens_for_vocab(exp.model.vocab_size)
    ts = bool(getattr(args, "timestamps", False))
    init = init_tokens(exp, args.language, ts)
    dcfg = dataclasses.replace(
        exp.decode,
        speculative_gamma=max(0, args.speculative_gamma),
        draft_layers=args.draft_layers,
        with_timestamps=ts,
        timestamp_begin=st.timestamp_begin,
        eot=exp.model.eos,
        init_tokens=init,
        quantize_weights=bool(args.int8_weights),
        **extra,
    )
    if args.prefill_quantized:  # prefill on the quantized cross K/V
        dcfg = dataclasses.replace(dcfg, quantize_cross_kv=True, prefill_quantized=True)
    return dcfg


def serving_weights(exp, args, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The ``TSASRModel`` state dict to serve, on the host: the latest
    checkpoint under ``{expdir}/checkpoints`` (its ``ave`` subdirectory with
    ``--use_ave`` when that holds one), else the seeded random init."""
    from ..train.checkpoint import latest_step, restore_serving_variables
    from ..train.eval import AVE_SUBDIR
    from .train import build_model

    if args.expdir:
        ckpt_dir = f"{args.expdir}/checkpoints"
        ave_dir = f"{ckpt_dir}/{AVE_SUBDIR}"
        if args.use_ave and latest_step(ave_dir) is not None:
            ckpt_dir = ave_dir
            logging.info("using averaged n-best checkpoint %s", ave_dir)
        if latest_step(ckpt_dir) is not None:
            sd, step, epoch = restore_serving_variables(ckpt_dir, dtype, exp.train)
            logging.info("restored step %d (epoch %d, mode %s) from %s",
                         step, epoch, exp.train.mode, ckpt_dir)
            return sd
        logging.warning("no checkpoint under %s: serving the seeded random init", ckpt_dir)
    return build_model(exp, args.seed, device="cpu").state_dict()


def read_draft(args) -> Dict[str, torch.Tensor]:
    """``--draft_path``'s state dict, on the host; ``args.draft_layers``
    takes the draft's own depth from its meta."""
    from ..train.distill import load_draft

    sd, meta = load_draft(args.draft_path)
    meta_d = int(meta.get("draft_layers", args.draft_layers))
    if meta_d != args.draft_layers:
        logging.info("--draft_layers %d -> %d (from the draft's meta)", args.draft_layers, meta_d)
        args.draft_layers = meta_d
    logging.info("distilled draft: %s (teacher step %s, agreement %s)",
                 args.draft_path, meta.get("teacher_step"), meta.get("final_agreement"))
    return sd


@dataclasses.dataclass
class Decoding:
    """What ``main`` decodes with, before any weights are read."""

    exp: Any
    args: Any
    dcfg: Any
    dataset: Any
    tokenizer: Any
    device: torch.device
    dtype: torch.dtype
    draft_sd: Optional[Dict[str, torch.Tensor]] = None  # --draft_path's weights
    mesh: Any = None  # the (data, model) mesh of a multi-process decode
    batch_size: int = 8  # the flag's, rounded up to a multiple of the data axis

    def modules(self, state_dict: Dict[str, torch.Tensor]):
        from ..decode.pipeline import serving_modules

        spec = self.dcfg.speculative_gamma > 0
        exp = self.exp
        return serving_modules(
            exp.resolved_dims(), exp.ts, exp.model, state_dict, self.dtype, self.device,
            cross_kv_bits=self.args.cross_kv_bits,
            self_kv_bits=self.args.self_kv_bits,
            # speculative decode needs the 5-D cache's per-row writes, and
            # tensor parallelism the 5-D cache's local heads
            flat_self_cache=not spec and self.args.model_parallel <= 1,
        )

    def draft(self, decoder):
        """The ``--draft_path`` draft built like ``decoder`` (its cross K/V
        width) in the compute dtype, or None."""
        if self.draft_sd is None:
            return None
        from ..train.distill import build_draft

        return build_draft(decoder, self.draft_sd, self.dtype)


def prepare(argv=None) -> Decoding:
    """Parse ``argv`` and set up the decode: config, decode config, data
    and tokenizer. Raises without CUDA unless ``--device cpu``."""
    from .._device import resolve_device
    from ..tokenizer.whisper_tokenizer import load_tokenizer, special_tokens_for_vocab
    from .train import compute_dtype

    parser = build_parser()
    args = parser.parse_args(argv)
    if args.enroll_type == "embedding" and args.model_parallel > 1:
        parser.error(
            "--model_parallel serving of the embedding-enrollment encoder is "
            "not wired up; decode with --model_parallel 1"
        )
    device, world, tp = distributed_setup(parser, args)
    exp = load_exp(args)
    if args.enroll_type is not None:
        exp = dataclasses.replace(
            exp, ts=dataclasses.replace(exp.ts, enroll_type=args.enroll_type))
    if args.long_audio and exp.ts.enroll_type == "embedding":
        parser.error(
            "--long_audio windows share one Qformer speaker prompt and is "
            "audio-enrollment only; the embedding path decodes fixed windows"
        )
    if args.long_audio and tp > 1:
        parser.error(
            "--long_audio decodes per-utterance window batches on one device "
            "and cannot shard the weights; it is incompatible with "
            "--model_parallel (use the fixed-window path for TP serving)"
        )
    spec = max(0, args.speculative_gamma)
    if spec and tp > 1:
        parser.error(
            "--speculative_gamma is incompatible with --model_parallel: "
            "the ragged verify path is single-chip/DP only"
        )
    draft_sd = None
    if args.draft_path:
        if not spec:
            parser.error("--draft_path requires --speculative_gamma > 0")
        if args.long_audio:
            parser.error("--draft_path is incompatible with --long_audio")
        draft_sd = read_draft(args)
        if args.data_parallel and world > 1:
            logging.warning(
                "--draft_path decoding is single-device; dropping "
                "--data_parallel"
            )
            args.data_parallel = False
    dcfg = decode_config(
        exp, args,
        min_new_tokens=max(0, args.min_new_tokens),
        ctc_decode_weight=max(0.0, args.ctc_weight),
        pre_beam=max(2, args.pre_beam),
        maxlenratio=max(0.0, args.maxlenratio),
        minlenratio=max(0.0, args.minlenratio),
    )
    st = special_tokens_for_vocab(exp.model.vocab_size)
    if dcfg.with_timestamps and exp.model.vocab_size < st.n_vocab:
        parser.error(
            "--timestamps needs the full Whisper vocabulary (the timestamp "
            f"tokens start at id {st.timestamp_begin}); this checkpoint has "
            f"vocab_size {exp.model.vocab_size}"
        )
    if dcfg.with_timestamps and (
        exp.decode.beam_size > 1 or spec or args.long_audio or dcfg.ctc_decode_weight > 0
    ):
        parser.error(
            "--timestamps is plain-greedy only: incompatible with beam "
            "sizes > 1, --speculative_gamma, --long_audio and --ctc_weight "
            "(the joint decoder applies no timestamp rules)"
        )
    if tp > 1:
        dcfg = dataclasses.replace(
            dcfg, quantize_cross_kv=False, quantize_weights=False, prefill_quantized=False,
        )
    if dcfg.ctc_decode_weight > 0:
        if spec or args.long_audio or tp > 1:
            parser.error(
                "--ctc_weight joint decoding is the single-device plain "
                "path: incompatible with --speculative_gamma, --long_audio "
                "and --model_parallel"
            )
        # the joint scorer is the dense path: it reads no quantized cross K/V
        if dcfg.quantize_cross_kv or dcfg.quantize_weights or dcfg.prefill_quantized:
            logging.warning(
                "--ctc_weight joint decoding runs fully dense; ignoring "
                "--int8_weights/--prefill_quantized/quantized cross-KV"
            )
        dcfg = dataclasses.replace(
            dcfg, quantize_cross_kv=False, quantize_weights=False, prefill_quantized=False,
        )
        # single-device joint path: no DP mesh
        if args.data_parallel and world > 1:
            logging.warning(
                "--ctc_weight joint decoding is single-device; dropping "
                "--data_parallel"
            )
        args.data_parallel = False
    mesh, batch_size = None, args.batch_size
    if not args.long_audio:
        mesh, batch_size = make_decode_mesh(args, world, tp)
    tokenizer = load_tokenizer(args.tokenizer_assets)
    dataset = open_dataset(exp, args, tokenizer, args.enroll_prefix)
    return Decoding(exp, args, dcfg, dataset, tokenizer, device, compute_dtype(exp), draft_sd,
                    mesh, batch_size)


def distributed_setup(parser: argparse.ArgumentParser, args):
    """Join the process group of a multi-process launch and check
    ``--model_parallel`` against it; on the dense path it forces, switch
    the flash and W8A8 flags off. Returns (this rank's device, world size,
    model-parallel size)."""
    from .._device import resolve_device
    from ..parallel.mesh import init_distributed, local_device

    device = resolve_device(args.device)
    world = init_distributed(device=device)
    device = local_device(device)
    tp = max(1, args.model_parallel)
    if tp > 1:
        if world % tp:
            parser.error(f"--model_parallel {tp} must divide {world} devices")
        # TP serving runs the dense path; the kernels of the quantized
        # serving knobs run on each data rank's rows
        if args.use_flash or args.int8_weights or args.cross_kv_bits == 4:
            logging.info(
                "--model_parallel: forcing the dense XLA path "
                "(flash/quantized-serving knobs are single-chip/DP only)"
            )
        args.use_flash = False
        args.int8_weights = False
    if world == 1 and device.type == "cuda" and torch.cuda.device_count() > 1:
        logging.info(
            "one process: serving on one of %d GPUs; launch with python -m "
            "torch.distributed.run --nproc_per_node %d to use all of them",
            torch.cuda.device_count(), torch.cuda.device_count(),
        )
    return device, world, tp


def make_decode_mesh(args, world: int, tp: int):
    """The ``(data, model)`` mesh of ``--data_parallel`` / ``--model_parallel``
    over the world, or None, and the batch size rounded up to a multiple of
    the data axis."""
    batch_size = args.batch_size
    if not (tp > 1 or (args.data_parallel and world > 1)):
        return None, batch_size
    from ..parallel.mesh import make_mesh

    n = world // tp if args.data_parallel else 1
    mesh = make_mesh(n, tp)
    if batch_size % n:
        batch_size = ((batch_size + n - 1) // n) * n
        logging.info("rounded batch_size %d -> %d (multiple of %d data shards)",
                     args.batch_size, batch_size, n)
    logging.info("sharded decode over %d devices (data=%d, model=%d)", n * tp, n, tp)
    return mesh, batch_size


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s: %(message)s",
    )
    from ..decode.pipeline import decode_dataset
    from ..parallel.mesh import rank

    d = prepare(argv)
    logging.info("decoding %d utterances on %s", len(d.dataset), d.device)
    sd = serving_weights(d.exp, d.args, d.dtype)
    encoder, decoder = d.modules(sd)
    ctc_lo = None
    if d.dcfg.ctc_decode_weight > 0:  # the checkpoint's CTC head
        ctc_lo = (sd["ctc.ctc_lo.weight"], sd["ctc.ctc_lo.bias"])
    del sd
    if d.args.long_audio:
        from ..decode.long_audio import decode_dataset_long

        result = decode_dataset_long(
            encoder, decoder, d.dataset, d.tokenizer, d.dcfg,
            chunk_seconds=d.args.chunk_seconds,
            output_dir=d.args.output_dir if rank() == 0 else None,
            window_batch=d.args.batch_size, device=d.device,
        )
    else:
        result = decode_dataset(
            encoder, decoder, d.dataset, d.tokenizer, d.dcfg,
            batch_size=d.batch_size, output_dir=d.args.output_dir,
            enc_chunk=d.args.enc_chunk, device=d.device, draft=d.draft(decoder),
            ctc_lo=ctc_lo, mesh=d.mesh,
        )
    logging.info(
        "decoded %d utts in %.1fs (RTF %.1fx): %s",
        len(result.hyps), result.wall_seconds, result.rtf,
        " ".join(f"{k}={v:.4f}" for k, v in sorted(result.metrics.items())),
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
