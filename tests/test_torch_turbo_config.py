"""The benchmark's Whisper large-v3-turbo configuration on the CPU.

Its ``whisper`` block is the port's ``large-v3-turbo`` preset and its token
ids are the v3 layout's (51866 tokens: ``<|yue|>`` moves every special token
after the language block up by one). A tiny cut of its decode cell, which
keeps 128 mel bins, the v3 vocabulary and a decoder shallower than the
encoder, runs through ``decode_dataset`` to ``correct`` true against the
plain reference, and to ``correct`` false with one served token altered.
"""

import dataclasses

from portbench.tests.test_portbench_run import _one_token, altered_tokens, few_threads  # noqa: F401
from portbench.tests.tiny import cell_by_name, run_cell, tiny_cell
from robustsq_whisper_torch.models.whisper.config import whisper_dims
from robustsq_whisper_torch.tokenizer.whisper_tokenizer import special_tokens_for_vocab

CELL = "qformer_large_v3_turbo.decode_greedy_b128"
SEED = 2**32 + 29


def test_config_is_the_preset_with_v3_tokens():
    cfg = cell_by_name(CELL).config
    assert cfg["whisper"] == dataclasses.asdict(whisper_dims("large-v3-turbo"))
    assert cfg["reduced"] == []
    st = special_tokens_for_vocab(cfg["whisper"]["n_vocab"])
    assert cfg["model"]["vocab_size"] == st.n_vocab == 51866
    assert cfg["serving"]["init_tokens"] == [st.sot, st.lang("en"), st.transcribe, st.notimestamps]
    assert (cfg["model"]["sos"], cfg["model"]["eos"], cfg["model"]["startofprev"]) == (
        st.sot, st.eot, st.startofprev)
    assert cfg["serving"]["eot"] == st.eot


def tiny_turbo():
    """The cell at width 64 with 3 encoder layers over 1 decoder layer; the
    mel bins, the vocabulary and the token ids stay the configuration's."""
    cell = tiny_cell(CELL)
    cell.config["whisper"].update(n_audio_layer=3, n_text_layer=1)
    assert cell.config["whisper"]["n_mels"] == 128 and cell.config["whisper"]["n_vocab"] == 51866
    return cell


def test_tiny_turbo_cell_is_correct():
    _, _, line = run_cell(tiny_turbo(), SEED, trace=1)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert {"stage_ms_per_batch.decode", "search_ms_per_step.decode", "mfu.decode"} <= set(line["metrics"])


def test_tiny_turbo_cell_with_a_token_altered_is_not_correct(monkeypatch):
    altered_tokens(monkeypatch, _one_token)
    _, _, line = run_cell(tiny_turbo(), SEED)
    assert not line["correct"], line["checks"]
