"""The work functions count what a hand count gives at tiny shapes: the
whole model's operations (``flops.py``) and each roofline metric's
operations or bytes."""

import pytest

from portbench import flops, harness


def cfg(enroll="embedding"):
    return {"whisper": {"n_mels": 2, "n_vocab": 10, "n_audio_ctx": 6, "n_audio_state": 4,
                        "n_audio_head": 2, "n_audio_layer": 1, "n_text_ctx": 8, "n_text_state": 4,
                        "n_text_head": 2, "n_text_layer": 1},
            "encoder": {"enroll_type": enroll, "enroll_size": 3, "num_query_tokens": 2,
                        "num_hidden_layers": 1, "qformer_hidden_size": 5, "qformer_intermediate_size": 7}}


def test_attention_is_four_lq_lk_width():
    assert flops._attn(2, 3, 4) == 96


def test_embedding_encoder_by_hand():
    # rows 2; conv1 over 12 frames: 2*2*12*4*(2*3); conv2 over 6: 2*2*6*4*(4*3);
    # adapter 2*2*6*(4+3)*4; block: qkvo 2*2*6*4*4*4, attention 2*4*6*6*4, mlp 2*2*6*4*16*2
    hand = (2 * 2 * 12 * 4 * 6 + 2 * 2 * 6 * 4 * 12 + 2 * 2 * 6 * 7 * 4
            + 2 * 2 * 6 * 4 * 4 * 4 + 2 * 4 * 6 * 6 * 4 + 2 * 2 * 6 * 4 * 16 * 2)
    assert flops.forward(flops.encoder_ops(cfg(), rows=2, enroll_frames=4)) == hand


def test_qformer_encoder_adds_its_parts():
    c = cfg("audio")
    extra = flops.forward(flops.encoder_ops(c, 1, 4)) - flops.forward(flops.encoder_ops(cfg(), 1, 4))
    n, enr, T = 2 + 2, 2, 6  # queries + enrollment frames (4 mel -> 2), speech frames
    hand = (2 * 4 * 4 * 2 * 3 + 2 * 2 * 4 * 4 * 3 + 2 * enr * 4 * 5       # enrollment stem, word emb
            + 2 * n * 5 * 5 * 4 + 4 * n * n * 5 + 2 * 2 * 5 * 5 * 2        # self attn, cross q/o
            + 2 * T * 4 * 5 * 2 + 4 * 2 * T * 5 + 2 * 2 * 5 * 7 * 2 + 2 * enr * 5 * 7 * 2
            + 2 * n * 5 * 4                                                 # prompt projection
            - 2 * 6 * 7 * 4                                                 # no adapter
            + 2 * 2 * 4 * 4 * 4 + (4 * 8 * 8 - 4 * 6 * 6) * 4 + 2 * 2 * 4 * 16 * 2)  # 2 more positions
    assert extra == hand


def test_serve_steps_by_hand():
    c = cfg()
    d, V, Tm = 4, 10, 6
    base = flops.serve_ops(c, rows=1, prefix=3, steps=0)
    one = flops.serve_ops(c, rows=1, prefix=3, steps=1)
    assert one - base == 2 * d * d * 14 + 4 * 4 * d + 4 * Tm * d + 2 * d * V
    prefill = (2 * 3 * d * d * 4 + 4 * 3 * 3 * d / 2 + 4 * 3 * Tm * d + 2 * 3 * d * 4 * d * 2
               + 2 * d * V + 2 * 3 * d * d * 2)
    assert base == 2 * Tm * d * d * 2 + prefill


def test_training_counts_backward_once_and_trainable_weights():
    c = cfg()
    none = flops.train_step_ops(c, 1, 2, 4, {})
    full = flops.train_step_ops(c, 1, 2, 4, {g: True for g in ("conv1", "conv2", "adapter", "encoder_attn",
                                                                 "encoder_mlp", "decoder_attn", "decoder_cross",
                                                                 "decoder_mlp", "token_embedding", "ctc")})
    ops = flops.encoder_ops(c, 1, 4) + flops.decoder_ops(c, 1, 2 + 1, 2 + 1) + [(2 * 6 * 4 * 10, "ctc")]
    named = sum(o for o, n in ops if n)
    conv1 = sum(o for o, n in ops if n == "conv1")
    conv2 = sum(o for o, n in ops if n == "conv2")
    attn = sum(o for o, n in ops if not n)
    assert none == flops.forward(ops) + (named - conv1 - conv2) + 2 * attn
    assert full == none + conv2 + named


@pytest.mark.parametrize("name,args,hand", [
    ("encoder_attention_roofline.decode", (2, 3), 1 * 4 * 2 * 9 * 4),
    ("cross_attention_roofline.decode", (2, 3), 2 * 3 * 4 + 2 * 4 * 4 + 2 * 2 * 4 * 2),
    ("encoder_attention_bwd_roofline.train", (2, 3), 10 * 2 * 9 * 4),
])
def test_roofline_work_functions(name, args, hand):
    assert harness.load_module("metrics", name).work(cfg(), *args) == hand


def test_busy_is_the_union_of_device_intervals():
    assert harness.union([("a", 0, 10), ("b", 5, 10), ("c", 20, 1)]) == [(0, 15), (20, 21)]
