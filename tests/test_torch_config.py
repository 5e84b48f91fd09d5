"""The port's config loader against the JAX package's.

``load_yaml`` is the port's own reader of a YAML subset: on every config
of ``conf/tswhisper`` it must give what PyYAML's ``safe_load`` gives, and
``load_experiment`` must build the JAX package's experiment field by
field. The LoRA target regex is the one field that differs by design: it
matches flax kernel paths in JAX and dotted weight names in the port.
"""

import dataclasses
import glob
import pathlib

import pytest
import yaml

from robustsq_whisper_tpu.utils import config as jconfig
from robustsq_whisper_torch.models import TSEncoderConfig
from robustsq_whisper_torch.utils import config as pconfig

REPO = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = sorted(glob.glob(str(REPO / "conf" / "tswhisper" / "*.yaml")))


def _asdict(exp):
    d = dataclasses.asdict(exp)
    d["train"]["lora"].pop("targets")
    return d


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: pathlib.Path(p).stem)
def test_load_yaml_equals_pyyaml(path):
    with open(path) as f:
        assert pconfig.load_yaml(path) == yaml.safe_load(f)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: pathlib.Path(p).stem)
def test_load_experiment_equals_jax(path):
    assert _asdict(pconfig.load_experiment(path)) == _asdict(jconfig.load_experiment(path))


def test_encoder_config_has_the_jax_fields():
    from robustsq_whisper_tpu.models.ts_encoder import TSEncoderConfig as JTS

    assert dataclasses.asdict(TSEncoderConfig()) == dataclasses.asdict(JTS())


@pytest.mark.parametrize(
    "text",
    [
        "a: 1\nb:\n  c: -2\n  d: [1, 2.5, x]\n",
        "lr: 1.0e-3  # a comment\nname: 'it''s'\nflag: off\nnone: ~\nempty:\n",
        "# only a comment\n\nx:\n    y:\n        z: true\n    w: .5\n",
        "q: \"a b\"\nr: []\ns: [a, 'b, c',]\nt: a:b\n",
    ],
    ids=["nested", "scalars", "deep", "strings"],
)
def test_subset_equals_pyyaml(text):
    assert pconfig.parse_yaml(text) == (yaml.safe_load(text) or {})


@pytest.mark.parametrize(
    "text",
    [
        "a:\n  - 1\n  - 2\n",  # block sequence
        "a: {b: 1}\n",  # flow map
        "a: [1, [2]]\n",  # nested flow list
        "a: &x 1\nb: *x\n",  # anchor and alias
        "a: !!str 1\n",  # tag
        "a: |\n  text\n",  # literal block scalar
        "---\na: 1\n",  # document marker
        "a: 1e-3\n",  # a string to PyYAML, a float to YAML 1.2
        "a: 0x1f\n",  # hex
        "a: 1:30\n",  # sexagesimal
        "a: 1_000\n",  # underscores
        "a: 1\n   b: 2\n",  # indentation matching no open map
        "a: 1\n\tb: 2\n",  # tab
        "a: \"x\\ny\"\n",  # escapes
    ],
)
def test_yaml_outside_the_subset_raises(text):
    with pytest.raises(ValueError):
        pconfig.parse_yaml(text)


def test_unknown_keys_raise():
    for d in (
        {"encoder_conf": {"num_query_tokenz": 4}},
        {"train_conf": {"optim": {"learning_rate": 1.0}}},
        {"data_conf": {"speech_secs": 3.0}},
        {"decode_conf": {"beam": 2}},
        {"no_such_section": {}},
    ):
        with pytest.raises(KeyError):
            pconfig.experiment_from_dict(d)
        with pytest.raises(KeyError):
            jconfig.experiment_from_dict(d)


def test_inference_config_applies_decode_conf(tmp_path):
    inf = tmp_path / "inf.yaml"
    inf.write_text("decode_conf:\n  beam_size: 5\n  init_tokens: [50258]\n")
    exp = pconfig.load_experiment(str(REPO / "conf/tswhisper/train_tsasr_whisper_dev_smoke.yaml"))
    out = pconfig.with_inference_config(exp, str(inf))
    assert out.decode.beam_size == 5 and out.decode.init_tokens == (50258,)
    assert out.decode_init_tokens_explicit and not exp.decode_init_tokens_explicit
    assert pconfig.with_inference_config(exp, None) is exp
