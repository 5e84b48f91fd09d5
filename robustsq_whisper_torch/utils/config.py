"""YAML experiment configs mapped onto the port's dataclasses.

Mirrors the JAX package's ``utils/config.py``: the schema of
``conf/tswhisper/*.yaml`` (``whisper_model``, ``encoder_conf``,
``model_conf``, ``specaug_conf``, ``train_conf``, ``decode_conf``,
``data_conf``, ``compute_dtype``) becomes an ``ExperimentConfig`` over the
port's own config dataclasses, and unknown keys raise ``KeyError``.

``load_yaml`` is the port's own reader of the subset of YAML those files
use, so every machine parses a config with the same code whether or not
PyYAML is installed: block maps nested by indentation, flow lists of
scalars (``init_tokens: [50258]``), ``#`` comments, and the scalars of
PyYAML's ``safe_load`` (decimal ints, floats with a dot such as
``1.0e-3``, booleans, null, plain and simply quoted strings). Anything
else (block sequences, flow maps, anchors, tags, multi-line scalars,
several documents) raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple

from ..decode.search import DecodeConfig
from ..models.ts_encoder import TSEncoderConfig
from ..models.ts_model import TSModelConfig
from ..models.whisper.config import WhisperDims, whisper_dims
from ..train.step import TrainConfig


@dataclasses.dataclass
class ExperimentConfig:
    whisper_model: str = "medium"
    dims: Optional[WhisperDims] = None
    ts: TSEncoderConfig = TSEncoderConfig()
    model: TSModelConfig = TSModelConfig()
    train: TrainConfig = TrainConfig()
    decode: DecodeConfig = DecodeConfig()
    # data
    speech_seconds: float = 30.0
    enroll_seconds: float = 10.0
    batch_size: int = 8
    num_epochs: int = 10
    utt_style: str = "libri2mix"
    compute_dtype: str = "bfloat16"
    # True when decode_conf.init_tokens was set in the yaml: an explicit
    # init sequence (even the default bare [sos]) wins in cli.decode
    decode_init_tokens_explicit: bool = False

    def resolved_dims(self) -> WhisperDims:
        return self.dims or whisper_dims(self.whisper_model)


def _update_dataclass(dc: Any, updates: Dict[str, Any], path: str) -> Any:
    fields = {f.name for f in dataclasses.fields(dc)}
    kw = {}
    for k, v in updates.items():
        if k not in fields:
            raise KeyError(f"unknown config key {path}.{k}")
        cur = getattr(dc, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            kw[k] = _update_dataclass(cur, v, f"{path}.{k}")
        else:
            kw[k] = v
    return dataclasses.replace(dc, **kw)


# ---------------- the YAML subset ----------------

_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_.\-]*$")
_INT = re.compile(r"[-+]?(0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"([-+]?[0-9]+\.[0-9]*|\.[0-9]+)([eE][-+][0-9]+)?$")
# number forms outside the subset: octal, hex, binary, sexagesimal and
# underscores (which PyYAML resolves), and a signed ``.5`` or an exponent
# without a dot or a sign (``1e-3``: strings to PyYAML, floats to YAML 1.2)
_OTHER_NUMBER = re.compile(
    r"[-+]\.[0-9]+|[-+]?(0[0-7_]+|0[xob][0-9a-fA-F_]+|[0-9][0-9_]*(:[0-5]?[0-9])+(\.[0-9_]*)?"
    r"|[0-9_]*_[0-9_]*(\.[0-9_]*)?([eE][-+][0-9]+)?|[0-9]*\.?[0-9]*[eE][-+]?[0-9]+)$"
)
_BOOLS = {
    **{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")},
    **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")},
}
_NULLS = ("", "~", "null", "Null", "NULL")
_INDICATORS = tuple("[]{}&*!|>%@`,?")


def _strip_comment(line: str, where: str) -> str:
    """The line without a ``#`` comment (one at the start or after a space,
    outside quotes)."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[,:"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    if quote:
        raise ValueError(f"{where}: unterminated quoted string")
    return line.rstrip()


def _scalar(tok: str, where: str) -> Any:
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] == "'":
        body = tok[1:-1]
        if "'" in body.replace("''", ""):
            raise ValueError(f"{where}: bad single-quoted string {tok!r}")
        return body.replace("''", "'")
    if len(tok) >= 2 and tok[0] == tok[-1] == '"':
        body = tok[1:-1]
        if "\\" in body or '"' in body:
            raise ValueError(f"{where}: escapes in double quotes are outside the subset")
        return body
    if tok in _NULLS:
        return None
    if tok in _BOOLS:
        return _BOOLS[tok]
    if _INT.match(tok):
        return int(tok)
    if _FLOAT.match(tok):
        return float(tok)
    if tok in (".inf", ".Inf", ".INF", "+.inf", "+.Inf", "+.INF"):
        return float("inf")
    if tok in ("-.inf", "-.Inf", "-.INF"):
        return float("-inf")
    if tok in (".nan", ".NaN", ".NAN"):
        return float("nan")
    if _OTHER_NUMBER.match(tok):
        raise ValueError(f"{where}: number form {tok!r} is outside the subset")
    if (
        tok[0] in _INDICATORS or tok[0] in "'\"" or tok.startswith(("- ", "-\t"))
        or tok == "-" or ": " in tok or tok.endswith(":") or " #" in tok
    ):
        raise ValueError(f"{where}: {tok!r} is outside the YAML subset")
    return tok


def _value(text: str, where: str) -> Any:
    """An inline value: a flow list of scalars or one scalar."""
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"{where}: unterminated flow list")
        body = text[1:-1].strip()
        if not body:
            return []
        if any(c in body for c in "[]{}"):
            raise ValueError(f"{where}: nested flow collections are outside the subset")
        items, quote, start = [], None, 0
        for i, c in enumerate(body + ","):
            if quote:
                quote = None if c == quote else quote
            elif c in "'\"":
                quote = c
            elif c == ",":
                items.append(body[start:i].strip())
                start = i + 1
        if items[-1] == "":  # a trailing comma
            items.pop()
        if any(s == "" for s in items):
            raise ValueError(f"{where}: empty flow list entry")
        return [_scalar(s, where) for s in items]
    return _scalar(text, where)


def parse_yaml(text: str, name: str = "<yaml>") -> Dict[str, Any]:
    """The mapping of a document in the subset (``{}`` when it is empty)."""
    lines: List[Tuple[int, int, str]] = []  # (line number, indent, content)
    for no, raw in enumerate(text.splitlines(), 1):
        where = f"{name}:{no}"
        body = _strip_comment(raw, where)
        if not body.strip():
            continue
        stripped = body.lstrip(" ")
        if stripped.startswith("\t") or "\t" in body[: len(body) - len(stripped)]:
            raise ValueError(f"{where}: tab in indentation")
        if stripped.startswith(("---", "...")) or stripped.startswith("%"):
            raise ValueError(f"{where}: directives and document markers are outside the subset")
        lines.append((no, len(body) - len(stripped), stripped))
    if not lines:
        return {}

    pos = 0

    def block(indent: int) -> Dict[str, Any]:
        nonlocal pos
        out: Dict[str, Any] = {}
        while pos < len(lines):
            no, ind, content = lines[pos]
            where = f"{name}:{no}"
            if ind < indent:
                return out
            if ind > indent:
                raise ValueError(f"{where}: unexpected indentation")
            if content.startswith("- ") or content == "-":
                raise ValueError(f"{where}: block sequences are outside the subset")
            key, sep, rest = content.partition(":")
            if not sep or (rest and not rest[0] in " \t"):
                raise ValueError(f"{where}: expected 'key: value', got {content!r}")
            key = key.strip()
            if not _KEY.match(key):
                raise ValueError(f"{where}: key {key!r} is outside the subset")
            rest = rest.strip()
            pos += 1
            if rest:
                out[key] = _value(rest, where)
            elif pos < len(lines) and lines[pos][1] > indent:
                out[key] = block(lines[pos][1])
            else:
                out[key] = None
        return out

    top = block(lines[0][1])
    if pos < len(lines):
        raise ValueError(f"{name}:{lines[pos][0]}: indentation does not match any open map")
    return top


def load_yaml(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return parse_yaml(f.read(), path)


def experiment_from_dict(d: Dict[str, Any]) -> ExperimentConfig:
    """An ExperimentConfig from a nested dict (parsed YAML); the schema is
    the JAX package's (see the module docstring)."""
    d = dict(d)
    exp = ExperimentConfig()
    if "whisper_model" in d:
        exp = dataclasses.replace(exp, whisper_model=d.pop("whisper_model"))
    if "encoder_conf" in d:
        exp = dataclasses.replace(
            exp, ts=_update_dataclass(exp.ts, d.pop("encoder_conf"), "encoder_conf")
        )
    if "model_conf" in d:
        exp = dataclasses.replace(
            exp, model=_update_dataclass(exp.model, d.pop("model_conf"), "model_conf")
        )
    if "specaug_conf" in d:
        sa = _update_dataclass(exp.model.specaug, d.pop("specaug_conf"), "specaug_conf")
        exp = dataclasses.replace(exp, model=dataclasses.replace(exp.model, specaug=sa))
    if "train_conf" in d:
        exp = dataclasses.replace(
            exp, train=_update_dataclass(exp.train, d.pop("train_conf"), "train_conf")
        )
    if "decode_conf" in d:
        dd = dict(d.pop("decode_conf"))
        if "init_tokens" in dd:
            dd["init_tokens"] = tuple(dd["init_tokens"])
            exp = dataclasses.replace(exp, decode_init_tokens_explicit=True)
        exp = dataclasses.replace(
            exp, decode=_update_dataclass(exp.decode, dd, "decode_conf")
        )
    if "data_conf" in d:
        for k, v in d.pop("data_conf").items():
            if not hasattr(exp, k):
                raise KeyError(f"unknown config key data_conf.{k}")
            exp = dataclasses.replace(exp, **{k: v})
    if "compute_dtype" in d:
        exp = dataclasses.replace(exp, compute_dtype=d.pop("compute_dtype"))
    if d:
        raise KeyError(f"unknown top-level config keys: {sorted(d)}")
    return exp


def load_experiment(path: str) -> ExperimentConfig:
    return experiment_from_dict(load_yaml(path))


def with_inference_config(exp: ExperimentConfig, path: Optional[str]) -> ExperimentConfig:
    """``exp`` with the ``decode_conf`` of an inference yaml applied over
    its decode config (``cli.decode`` / ``cli.serve --inference_config``)."""
    if not path:
        return exp
    inf = load_yaml(path)
    if "decode_conf" not in inf:
        return exp
    conf = inf["decode_conf"]
    return dataclasses.replace(
        exp,
        decode=dataclasses.replace(
            exp.decode,
            **{k: (tuple(v) if k == "init_tokens" else v) for k, v in conf.items()},
        ),
        decode_init_tokens_explicit=exp.decode_init_tokens_explicit or "init_tokens" in conf,
    )
