"""Data-preparation CLI: the recipe's stages 101-103 and the Kaldi
``utils/`` tools, as subcommands (the JAX package's ``cli.datapre``, with
its flags, defaults and JSON output line):

    overlap       SIR-mixed two-speaker data (stage 101)
    wham          WHAM!-style noise at an SNR or LUFS level (stage 101)
    enroll-json   spk2enroll.json from a LibriSpeech-style tree (stage 102)
    enroll-scp    lazy (train) or concrete (eval) enroll.scp rows (stage 102)
    format-sglspk mixture rows -> single-speaker rows
    validate      utils/validate_data_dir.sh (exit code 1 on problems)
    fix           utils/fix_data_dir.sh
    num-samples   utt2num_samples from the audio files
    extend-segments  utils/data/extend_segment_times.py
    synth-clean   a synthetic clean corpus, the recipe's input where there
                  is no dataset
    spk-embed     ResNet34 speaker embeddings and resnet.scp (stage 103),
                  on --device (default cuda)
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(prog="datapre", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("overlap", help="SIR-mixed overlap enrollment data")
    p.add_argument("--src_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--num_mixtures", type=int, default=100)
    p.add_argument("--sir_min", type=float, default=-5.0)
    p.add_argument("--sir_max", type=float, default=5.0)
    p.add_argument("--seed", type=int, default=42)

    p = sub.add_parser("wham", help="add WHAM!-style noise")
    p.add_argument("--clean_dir", required=True)
    p.add_argument("--noise_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--snr_min", type=float, default=10.0)
    p.add_argument("--snr_max", type=float, default=20.0)
    p.add_argument("--mode", choices=["snr", "lufs"], default="snr")
    p.add_argument("--lufs_min", type=float, default=-38.0)
    p.add_argument("--lufs_max", type=float, default=-30.0)
    p.add_argument("--seed", type=int, default=42)

    p = sub.add_parser("enroll-json", help="build spk2enroll.json")
    p.add_argument("--librispeech_root", required=True)
    p.add_argument("--out", required=True)

    p = sub.add_parser("enroll-scp", help="build enroll.scp")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--mode", choices=["train", "eval"], default="train")
    p.add_argument("--spk2enroll", default=None)
    p.add_argument("--seed", type=int, default=0)

    p = sub.add_parser("format-sglspk", help="mixture -> single-speaker rows")
    p.add_argument("--mix_dir", required=True)
    p.add_argument("--out_dir", required=True)

    p = sub.add_parser("validate", help="validate a Kaldi data dir")
    p.add_argument("data_dir")
    p.add_argument("--no-text", action="store_true")

    p = sub.add_parser("fix", help="fix/sort a Kaldi data dir")
    p.add_argument("data_dir")

    p = sub.add_parser("num-samples", help="write utt2num_samples")
    p.add_argument("data_dir")

    p = sub.add_parser(
        "extend-segments",
        help="pad segment times (utils/data/extend_segment_times.py)",
    )
    p.add_argument("data_dir")
    p.add_argument("--start_padding", type=float, default=0.1)
    p.add_argument("--end_padding", type=float, default=0.1)
    p.add_argument("--last_segment_end_padding", type=float, default=0.1)
    p.add_argument("--fix_overlapping_segments", type=lambda s: s.lower() != "false",
                   default=True)

    p = sub.add_parser(
        "synth-clean",
        help="synthetic LibriSpeech-style clean dir (hermetic recipe input)",
    )
    p.add_argument("--out_dir", required=True)
    p.add_argument("--n_speakers", type=int, default=8)
    p.add_argument("--utts_per_spk", type=int, default=8)
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--seed", type=int, default=0)

    p = sub.add_parser("spk-embed", help="extract speaker embeddings")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--onnx_model", default=None,
                   help="voxceleb ResNet34 ONNX weights (optional)")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--device", default="cuda",
                   help="cuda, or cpu for the speaker model on the host")

    args = parser.parse_args(argv)
    from ..data import kaldi_io, simulate

    if args.cmd == "overlap":
        stats = simulate.generate_overlap_enrollment(
            args.src_dir, args.out_dir,
            simulate.OverlapConfig(
                sir_min=args.sir_min, sir_max=args.sir_max,
                num_mixtures=args.num_mixtures, seed=args.seed,
            ),
        )
        print(json.dumps(stats))
    elif args.cmd == "wham":
        stats = simulate.add_wham_noise(
            args.clean_dir, args.noise_dir, args.out_dir,
            simulate.NoiseConfig(
                snr_min=args.snr_min, snr_max=args.snr_max, mode=args.mode,
                lufs_min=args.lufs_min, lufs_max=args.lufs_max,
                seed=args.seed,
            ),
        )
        print(json.dumps(stats))
    elif args.cmd == "enroll-json":
        n = simulate.build_spk2enroll_json(args.librispeech_root, args.out)
        print(json.dumps({"num_speakers": n}))
    elif args.cmd == "enroll-scp":
        n = simulate.build_enrollment_scp(
            args.data_dir, args.out, train=(args.mode == "train"),
            spk2enroll_path=args.spk2enroll, seed=args.seed,
        )
        print(json.dumps({"num_rows": n}))
    elif args.cmd == "format-sglspk":
        stats = simulate.format_sglspk_dataset(args.mix_dir, args.out_dir)
        print(json.dumps(stats))
    elif args.cmd == "validate":
        problems = kaldi_io.validate_data_dir(
            args.data_dir, require_text=not args.no_text
        )
        for prob in problems:
            print(f"PROBLEM: {prob}", file=sys.stderr)
        print(json.dumps({"valid": not problems, "problems": len(problems)}))
        return 1 if problems else 0
    elif args.cmd == "fix":
        kept = kaldi_io.fix_data_dir(args.data_dir)
        print(json.dumps({"kept": kept}))
    elif args.cmd == "num-samples":
        wav = kaldi_io.read_scp(os.path.join(args.data_dir, "wav.scp"))
        out = {
            u: str(kaldi_io.get_num_samples(p.split()[0]))
            for u, p in wav.items()
        }
        kaldi_io.write_scp(os.path.join(args.data_dir, "utt2num_samples"), out)
        print(json.dumps({"num_rows": len(out)}))
    elif args.cmd == "extend-segments":
        n_fixed = kaldi_io.extend_segment_times_file(
            args.data_dir,
            start_padding=args.start_padding,
            end_padding=args.end_padding,
            last_segment_end_padding=args.last_segment_end_padding,
            fix_overlapping_segments=args.fix_overlapping_segments,
        )
        print(json.dumps({"overlap_fixes": n_fixed}))
    elif args.cmd == "synth-clean":
        stats = simulate.generate_synth_clean_dir(
            args.out_dir, n_speakers=args.n_speakers,
            utts_per_spk=args.utts_per_spk, seconds=args.seconds,
            seed=args.seed,
        )
        print(json.dumps(stats))
    elif args.cmd == "spk-embed":
        from ..models.speaker_resnet import extract_embeddings_for_dir

        stats = extract_embeddings_for_dir(
            args.data_dir, args.out_dir,
            onnx_model=args.onnx_model, batch_size=args.batch_size,
            device=args.device,
        )
        print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
