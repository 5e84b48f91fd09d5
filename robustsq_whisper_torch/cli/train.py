"""Training CLI: the recipe's stage 11 on the port.

Usage::

    python -m robustsq_whisper_torch.cli.train \
        --config conf/tswhisper/train_tsasr_whisper_medium_lora_qkvo_r16_.yaml \
        --train_dir dump/raw/train_100_sglspk --valid_dir dump/raw/dev_sglspk \
        --expdir exp/tswhisper [--pretrained medium.pt] [--device cuda]

The flags are the JAX package's ``cli.train`` flags plus ``--device``
(default ``cuda``; without CUDA the command raises unless ``--device
cpu``) and ``--log_every``. Checkpoints go to ``{expdir}/checkpoints`` in
the port's format (``train/checkpoint.py``), the n-best average to its
``ave`` subdirectory; the port's ``cli.decode`` and ``cli.serve`` read both. A run
resumes from the latest checkpoint there. ``--enroll_type embedding``
trains the embedding-enrollment model on the stage-103
``{enroll_prefix}.scp`` (``--enroll_prefix``, default ``resnet``) of each
data dir.

Several GPUs: ``python -m torch.distributed.run --nproc_per_node N -m
robustsq_whisper_torch.cli.train ...`` trains on a ``(--n_data, --n_model)``
mesh (default: every rank on the data axis), with ``--fsdp true`` (or
``train_conf.fsdp``) sharding the parameters' and optimizer's storage over
the data axis (``train/step.py``). As the JAX CLI builds a mesh only with
more than one device, one process ignores the three flags (it logs so).

``build_model`` is shared with ``cli.decode`` and ``cli.serve``: the
experiment's ``TSASRModel`` with seeded random weights and, with
``pretrained``, the Whisper encoder and decoder of an OpenAI checkpoint
(and, for the ``cln`` adapter, conditional layer norms that start as its
block-0 ``attn_ln`` and ``mlp_ln``).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys

import torch

from .._device import resolve_device
from ..init import init_params
from ..models import TSASRModel
from ..utils.config import ExperimentConfig

def compute_dtype(exp: ExperimentConfig) -> torch.dtype:
    return torch.bfloat16 if exp.compute_dtype == "bfloat16" else torch.float32


@torch.no_grad()
def load_pretrained(model: TSASRModel, path: str, vocab_size: int) -> None:
    """Copy an OpenAI Whisper checkpoint's encoder and decoder over the
    model's Whisper submodules (every parameter of both), the token table
    adapted to ``vocab_size`` (``load.adapt_vocab``). The embedding
    encoder's conditional layer norms (adapter ``cln``) start as the
    checkpoint's block-0 ``attn_ln`` and ``mlp_ln``; their delta heads keep
    their zeros."""
    from ..models.whisper import load

    _, enc_sd, dec_sd = load.load_openai_checkpoint(path)
    dec_sd = load.adapt_vocab(dec_sd, vocab_size)
    enc = model.encoder
    cln = getattr(enc, "attn_cln", None) is not None
    # with conditional layer norms block 0 has no attn_ln / mlp_ln of its own
    blocks_sd = {k: v for k, v in enc_sd.items()
                 if not (cln and k.startswith(("blocks.0.attn_ln.", "blocks.0.mlp_ln.")))}
    for module, sd in ((enc.encoder, blocks_sd), (model.decoder.decoder, dec_sd)):
        own = dict(module.named_parameters())
        if own.keys() != sd.keys():
            raise KeyError(f"{path}: the checkpoint's names differ from the model's: "
                           f"{sorted(own.keys() ^ sd.keys())[:4]}")
        for name, p in own.items():
            if p.shape != sd[name].shape:
                raise ValueError(f"{path}: {name} is {tuple(sd[name].shape)}, the model's "
                                 f"{tuple(p.shape)}")
            p.copy_(sd[name])
    if cln:
        for norm, ln in ((enc.attn_cln, "attn_ln"), (enc.mlp_cln, "mlp_ln")):
            norm.weight.copy_(enc_sd[f"blocks.0.{ln}.weight"])
            norm.bias.copy_(enc_sd[f"blocks.0.{ln}.bias"])


def build_model(
    exp: ExperimentConfig, seed: int = 0, device="cuda", pretrained=None
) -> TSASRModel:
    """The experiment's ``TSASRModel``, weights from ``init_params(seed)``
    and, with ``pretrained`` (an OpenAI whisper ``.pt``), its encoder and
    decoder from that file, in its training compute dtype
    (``set_compute_dtype``), on ``device``."""
    dev = resolve_device(device)
    model = init_params(TSASRModel(exp.resolved_dims(), exp.ts, exp.model), seed)
    if pretrained:
        load_pretrained(model, pretrained, exp.model.vocab_size)
    if compute_dtype(exp) != torch.float32:
        model.set_compute_dtype(compute_dtype(exp))
    return model.to(dev)


def build_parser() -> argparse.ArgumentParser:
    from .decode import str2bool

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", required=True)
    p.add_argument("--train_dir", required=True)
    p.add_argument("--valid_dir", default=None,
                   help="validation data dir; enables the per-epoch eval pass, n-best "
                   "tracking and the averaged 'ave' checkpoint")
    p.add_argument("--nbest", type=int, default=5,
                   help="checkpoints kept and averaged by valid acc")
    p.add_argument("--patience", type=int, default=0,
                   help="early-stop epochs without a new best (0 = off)")
    p.add_argument("--valid_wer_utts", type=int, default=0,
                   help="per-epoch greedy-decode WER on this many valid utterances "
                   "(valid.wer); 0 = off")
    p.add_argument("--expdir", required=True)
    p.add_argument("--pretrained", default=None,
                   help="OpenAI whisper .pt checkpoint to warm-start from")
    p.add_argument("--tokenizer_assets", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (the hand-written kernels) or cpu (their plain PyTorch "
                   "versions)")
    p.add_argument("--n_data", type=int, default=None,
                   help="data-parallel mesh size (default: every rank)")
    p.add_argument("--n_model", type=int, default=1, help="tensor-parallel mesh size")
    p.add_argument("--fsdp", type=str2bool, default=None,
                   help="shard parameter and optimizer storage over the data axis "
                   "(ZeRO-3); overrides the config's train_conf.fsdp")
    p.add_argument("--num_epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--enroll_type", default=None, choices=["audio", "embedding"],
                   help="enrollment modality: audio (the Qformer on the enrollment "
                   "waveform) or embedding (stage-103 speaker embeddings at block 0); "
                   "overrides encoder_conf.enroll_type")
    p.add_argument("--enroll_prefix", default=None,
                   help="embedding scp basename in the data dirs (default resnet)")
    p.add_argument("--ckpt_every_steps", type=int, default=1000,
                   help="mid-epoch checkpoint cadence in steps (0 = none)")
    p.add_argument("--ckpt_every_epochs", type=int, default=1,
                   help="epoch-end checkpoint cadence; the last epoch always saves, and "
                   "every epoch does with --valid_dir")
    p.add_argument("--log_every", type=int, default=50,
                   help="steps between logged means of the training stats")
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None, metrics_hook=None) -> int:
    """Train; ``metrics_hook(step, values)`` is ``run_training``'s."""
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s: %(message)s",
    )
    from ..data.dataset import KaldiTSDataset
    from ..parallel.mesh import init_distributed, local_device, make_mesh
    from ..tokenizer.whisper_tokenizer import load_tokenizer
    from ..train.loop import LoopConfig, run_training
    from ..utils.config import load_experiment

    parser = build_parser()
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    world = init_distributed(device=dev)
    dev = local_device(dev)
    exp = load_experiment(args.config)
    if args.num_epochs is not None:
        exp.num_epochs = args.num_epochs
    if args.batch_size is not None:
        exp.batch_size = args.batch_size
    if args.enroll_type is not None:
        exp.ts = dataclasses.replace(exp.ts, enroll_type=args.enroll_type)
    if args.fsdp is not None:
        exp.train = dataclasses.replace(exp.train, fsdp=bool(args.fsdp))
    mesh = None
    if world > 1:
        mesh = make_mesh(args.n_data, args.n_model)
        logging.info("mesh: data=%d, model=%d", mesh["data"].size(), mesh["model"].size())
    elif (args.n_data or 1) > 1 or args.n_model > 1 or exp.train.fsdp:
        logging.info("one device: --n_data, --n_model and fsdp make no mesh")
    if world == 1 and dev.type == "cuda" and torch.cuda.device_count() > 1:
        logging.info(
            "one process: training on one of %d GPUs; launch with python -m "
            "torch.distributed.run --nproc_per_node %d to use all of them",
            torch.cuda.device_count(), torch.cuda.device_count(),
        )

    tokenizer = load_tokenizer(args.tokenizer_assets)
    ds_kwargs = dict(
        speech_seconds=exp.speech_seconds, enroll_seconds=exp.enroll_seconds,
        utt_style=exp.utt_style, num_speakers=exp.model.num_speakers, seed=args.seed,
        enroll_type=exp.ts.enroll_type, enroll_prefix=args.enroll_prefix or "resnet",
    )
    dataset = KaldiTSDataset(args.train_dir, tokenizer, **ds_kwargs)
    logging.info("dataset: %d utterances", len(dataset))
    valid_dataset = None
    if args.valid_dir:
        valid_dataset = KaldiTSDataset(args.valid_dir, tokenizer, **ds_kwargs)
        logging.info("valid dataset: %d utterances", len(valid_dataset))
    # the JAX CLI reads one unshuffled batch to initialise its model; read
    # it too, so that both CLIs draw the same enrollments and crops after
    next(dataset.batches(exp.batch_size, shuffle=False))

    model = build_model(exp, args.seed, dev, args.pretrained)
    lcfg = LoopConfig(
        num_epochs=exp.num_epochs,
        batch_size=exp.batch_size,
        log_every=max(1, args.log_every),
        ckpt_dir=f"{args.expdir}/checkpoints",
        nbest=args.nbest,
        patience=args.patience,
        ckpt_every_epochs=max(1, args.ckpt_every_epochs),
        ckpt_every_steps=max(0, args.ckpt_every_steps),
        wer_utts=max(0, args.valid_wer_utts),
        # the eval-time WER decodes dense weights, greedy or beam, attention
        # only; a reduced vocabulary starts from the model's own sos
        wer_decode=dataclasses.replace(
            exp.decode, eot=exp.model.eos, quantize_weights=False, speculative_gamma=0,
            ctc_decode_weight=0.0,
            init_tokens=exp.decode.init_tokens
            if max(exp.decode.init_tokens) < exp.model.vocab_size
            else (exp.model.sos,),
        ) if args.valid_wer_utts > 0 else None,
    )
    state = run_training(
        model, dataset, exp.train, lcfg,
        generator=torch.Generator(dev).manual_seed(args.seed),
        metrics_hook=metrics_hook, valid_dataset=valid_dataset, device=dev, seed=args.seed,
        mesh=mesh,
    )
    logging.info("training done at step %d", state.step)
    return 0


if __name__ == "__main__":
    sys.exit(main())
