"""Evaluation helpers of training: for now the name of the averaged n-best
checkpoint's subdirectory, which ``cli.decode --use_ave`` reads. The
per-epoch validation pass and the averaging come with the training loop
(ROADMAP A)."""

AVE_SUBDIR = "ave"
