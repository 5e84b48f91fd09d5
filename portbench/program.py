"""The program under test, built from a configuration file: its serving
encoder and decoder, its training model, and the configs its entry points
take. The benchmark's drivers are the only importers of this module; the
reference never imports it."""

from __future__ import annotations

import dataclasses

import torch

from robustsq_whisper_torch.decode.search import DecodeConfig
from robustsq_whisper_torch.models import (
    QFormerTSEncoder, SpkAdapterTSEncoder, TSASRModel, TSDecoder, TSEncoderConfig, TSModelConfig,
)
from robustsq_whisper_torch.audio.specaug import SpecAugConfig
from robustsq_whisper_torch.models.whisper.config import WhisperDims
from robustsq_whisper_torch.train import OptimConfig, TrainConfig
from robustsq_whisper_torch.train.lora import LoraConfig

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dims(cfg: dict) -> WhisperDims:
    return WhisperDims(**cfg["whisper"])


def encoder_config(cfg: dict, part: str) -> TSEncoderConfig:
    """``part``: ``serving`` or ``training`` (their attention routes)."""
    fields = {f.name for f in dataclasses.fields(TSEncoderConfig)}
    kw = {k: v for k, v in {**cfg["encoder"], **cfg[part]}.items() if k in fields}
    return TSEncoderConfig(**kw)


def model_config(cfg: dict) -> TSModelConfig:
    mc = dict(cfg["model"])
    mc["specaug"] = SpecAugConfig(**mc["specaug"])
    return TSModelConfig(**mc)


def _load(module: torch.nn.Module, weights: dict, prefix: str) -> None:
    """Every parameter of ``module`` from ``weights[prefix + name]``."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(weights[prefix + name])


def serving_modules(cfg: dict, weights: dict, device):
    """(encoder, TSDecoder) in the serving dtype, as ``cli.decode`` builds
    them (``decode.pipeline.serving_modules``)."""
    sv, d, mc = cfg["serving"], dims(cfg), model_config(cfg)
    ts = encoder_config(cfg, "serving")
    emb = ts.enroll_type == "embedding"
    with torch.device(device):
        enc = (SpkAdapterTSEncoder if emb else QFormerTSEncoder)(d, ts)
        dec = TSDecoder(d.replace(n_vocab=mc.vocab_size), startofprev_token=mc.startofprev,
                        use_spk_prompt=not emb, cross_kv_bits=sv["cross_kv_bits"],
                        self_kv_bits=sv["self_kv_bits"], flat_self_cache=sv["flat_self_cache"])
    _load(enc, weights, "encoder.")
    _load(dec, weights, "decoder.")
    dt = DTYPES[sv["dtype"]]
    return enc.to(device, dt).eval(), dec.to(device, dt).eval()


def decode_config(cfg: dict, traffic: dict) -> DecodeConfig:
    sv = cfg["serving"]
    return DecodeConfig(
        max_new_tokens=traffic["max_new_tokens"], eot=sv["eot"], init_tokens=tuple(sv["init_tokens"]),
        beam_size=traffic["beam_size"], quantize_cross_kv=sv["cross_kv_bits"] in (4, 8),
        stop_early=sv["stop_early"], prefill_quantized=traffic["prefill_quantized"],
    )


def training_model(cfg: dict, weights: dict, device) -> TSASRModel:
    with torch.device(device):
        model = TSASRModel(dims(cfg), encoder_config(cfg, "training"), model_config(cfg))
    _load(model, weights, "")
    return model.set_compute_dtype(DTYPES[cfg["training"]["dtype"]])


def train_config(cfg: dict, traffic: dict) -> TrainConfig:
    lc = cfg["training"]["lora"]
    return TrainConfig(mode=traffic["mode"], optim=OptimConfig(**{
        k: tuple(v) if isinstance(v, list) else v for k, v in traffic["optim"].items()}),
        lora=LoraConfig(rank=lc["rank"], alpha=lc["alpha"], targets=lc["targets"]))
