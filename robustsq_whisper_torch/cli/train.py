"""Model building shared by the port's command-line entry points.

``build_model`` is the JAX package's ``cli/train.py::
build_model_and_variables`` for the port: the ``TSASRModel`` of an
experiment config with seeded random weights (``init.init_params``). The
training ``main`` (the recipe's stage 11) comes with the training loop
(ROADMAP A).
"""

from __future__ import annotations

import torch

from .._device import resolve_device
from ..init import init_params
from ..models import TSASRModel
from ..utils.config import ExperimentConfig


def compute_dtype(exp: ExperimentConfig) -> torch.dtype:
    return torch.bfloat16 if exp.compute_dtype == "bfloat16" else torch.float32


def build_model(
    exp: ExperimentConfig, seed: int = 0, device="cuda", pretrained=None
) -> TSASRModel:
    """The experiment's ``TSASRModel``, weights from ``init_params(seed)``,
    in its training compute dtype (``set_compute_dtype``), on ``device``."""
    if pretrained:
        raise NotImplementedError(
            "loading pretrained Whisper weights (models/whisper/load.py) is "
            "ROADMAP A item 6"
        )
    dev = resolve_device(device)
    model = init_params(TSASRModel(exp.resolved_dims(), exp.ts, exp.model), seed)
    if compute_dtype(exp) != torch.float32:
        model.set_compute_dtype(compute_dtype(exp))
    return model.to(dev)
