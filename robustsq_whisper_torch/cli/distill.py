"""Distill a speculative-decode draft from a trained checkpoint.

Usage::

    python -m robustsq_whisper_torch.cli.distill \\
        --config conf/tswhisper/train_...yaml --expdir exp/... \\
        --data_dir dump/train_sglspk --out exp/.../draft \\
        --draft_layers 4 --steps 400

The flags are the JAX package's ``cli.distill`` flags plus ``--device``
(default ``cuda``; without CUDA the command raises unless ``--device
cpu``). Steps: restore the teacher from the port's checkpoint under
``{expdir}/checkpoints`` (its ``ave`` subdirectory with ``--use_ave`` when
that holds one), encode up to ``--max_items`` utterances of the data dir,
greedy-decode them with the teacher (the targets are the teacher's own
argmax choices over its own greedy context, the distribution the verify
step samples; no transcripts are needed), train the
``--draft_layers``-block draft (``train/distill.py``) and save it with
``save_draft``. Decode with it through ``cli.decode --speculative_gamma G
--draft_path <out>``: the output stays the teacher's greedy transcript,
token for token, whatever the draft; the draft buys speed only.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np
import torch

from .decode import init_tokens, open_dataset, str2bool


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", required=True)
    p.add_argument("--expdir", required=True,
                   help="teacher experiment dir (checkpoints/ inside)")
    p.add_argument("--data_dir", required=True,
                   help="Kaldi dir providing the distillation audio")
    p.add_argument("--out", required=True,
                   help="output draft dir (for --draft_path)")
    p.add_argument("--tokenizer_assets", default=None)
    p.add_argument("--draft_layers", type=int, default=4)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_items", type=int, default=64,
                   help="utterances drawn from the data dir for the corpus")
    p.add_argument("--max_new_tokens", type=int, default=128)
    p.add_argument("--language", default="en")
    p.add_argument("--use_ave", type=str2bool, default=True)
    p.add_argument("--device", default="cuda",
                   help="cuda (the hand-written kernels) or cpu (their plain "
                   "PyTorch versions)")
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s: %(message)s",
    )
    from .._device import resolve_device
    from ..audio.frontend import log_mel_spectrogram
    from ..decode.pipeline import serving_modules
    from ..decode.search import DecodeConfig, build_beam_decoder, strip_eot
    from ..tokenizer.whisper_tokenizer import load_tokenizer
    from ..train.checkpoint import latest_step, restore_serving_variables
    from ..train.distill import distill_draft, save_draft, teacher_forcing_inputs
    from ..train.eval import AVE_SUBDIR
    from ..utils.config import load_experiment
    from .train import compute_dtype

    device = resolve_device(args.device)
    exp = load_experiment(args.config)
    if exp.ts.enroll_type == "embedding":
        parser.error(
            "draft distillation is wired for the audio-enrollment "
            "(Qformer) encoder; enroll_type=embedding is not supported"
        )
    dims = exp.resolved_dims()
    dtype = compute_dtype(exp)
    tokenizer = load_tokenizer(args.tokenizer_assets)
    dataset = open_dataset(exp, args, tokenizer)

    ckpt_dir = f"{args.expdir}/checkpoints"
    ave_dir = f"{ckpt_dir}/{AVE_SUBDIR}"
    if args.use_ave and latest_step(ave_dir) is not None:
        ckpt_dir = ave_dir
    if latest_step(ckpt_dir) is None:
        parser.error(f"no teacher checkpoint found in {ckpt_dir}")
    sd, step_i, epoch = restore_serving_variables(ckpt_dir, dtype, exp.train)
    logging.info("teacher: step %d (epoch %d, mode %s) from %s",
                 step_i, epoch, exp.train.mode, ckpt_dir)
    # the 5-D cache: the distilled draft serves the speculative path
    encoder, decoder = serving_modules(
        dims, exp.ts, exp.model, sd, dtype, device, flat_self_cache=False
    )
    del sd

    # the decode defaults, as JAX's distillation decodes, not the config's
    # decode_conf
    init = init_tokens(exp, args.language)
    dcfg = DecodeConfig(
        max_new_tokens=args.max_new_tokens, eot=exp.model.eos, init_tokens=init, beam_size=1,
    )
    greedy = build_beam_decoder(decoder, dcfg, device)

    # the teacher corpus: encoder memory and greedy transcripts
    mems, prompts, rows = [], [], []
    n = 0
    for batch in dataset.batches(args.batch_size, shuffle=False, drop_last=False):
        utts = batch.pop("utt_ids", None)
        with torch.inference_mode():
            mel, fl = log_mel_spectrogram(
                torch.from_numpy(batch["speech"]).to(device),
                torch.from_numpy(batch["speech_lens"]).to(device), n_mels=dims.n_mels)
            emel, el = log_mel_spectrogram(
                torch.from_numpy(batch["enroll"]).to(device),
                torch.from_numpy(batch["enroll_lens"]).to(device), n_mels=dims.n_mels)
            memory, _, spk_prompt, _ = encoder(mel, fl, emel, el)
        tokens, _ = greedy(memory, spk_prompt)
        take = min(len(utts) if utts else args.batch_size, args.max_items - n)
        mems.append(memory[:take])
        prompts.append(spk_prompt[:take])
        rows.extend(strip_eot(tokens[:take].cpu().numpy(), dcfg.eot))
        n += take
        if n >= args.max_items:
            break
    memory, spk_prompt = torch.cat(mems), torch.cat(prompts)
    del mems, prompts
    lmax = max(1, max(len(r) for r in rows))
    logging.info("distillation corpus: %d utts, teacher output len %.1f mean",
                 len(rows), float(np.mean([len(r) for r in rows])))
    # the greedy rows continue the init_tokens conditioning: the
    # teacher-forced context is [sot] + init_tokens[1:] + row
    prefix = np.asarray(init[1:], np.int32)
    full = np.full((len(rows), len(prefix) + lmax), -1, np.int32)
    full_lens = np.zeros((len(rows),), np.int32)
    for i, r in enumerate(rows):
        full[i, : len(prefix)] = prefix
        full[i, len(prefix) : len(prefix) + len(r)] = r
        full_lens[i] = len(prefix) + len(r)
    ys_in, mask = teacher_forcing_inputs(full, full_lens, sot=init[0], eot=dcfg.eot)

    draft, stats = distill_draft(
        decoder, args.draft_layers, memory, spk_prompt, ys_in, mask,
        steps=args.steps, lr=args.lr, batch_size=min(args.batch_size, len(rows)),
        seed=args.seed, log=lambda m: logging.info("%s", m),
    )
    logging.info("distill stats: %s", stats)
    meta = {
        "draft_layers": int(args.draft_layers),
        "teacher_step": int(step_i),
        "teacher_ckpt": ckpt_dir,
        "final_agreement": stats["final_agreement"],
        "final_loss": stats["final_loss"],
        "steps": int(args.steps),
        "corpus_items": int(len(rows)),
    }
    out = save_draft(args.out, draft, meta)
    logging.info("draft saved to %s (%s)", out, meta)
    return 0


if __name__ == "__main__":
    sys.exit(main())
