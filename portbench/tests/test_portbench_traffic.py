"""The traffic and the weights come from the seed alone: the same seed
gives the same arrays, another seed the same sizes in another order."""

import numpy as np
import torch

from portbench import traffic, weights
from portbench.tests.tiny import tiny_cell

DEC = tiny_cell("qformer_medium.decode_greedy_b128")
TRAIN = tiny_cell("qformer_medium.train_full_b8")
EMB = tiny_cell("embed_medium.train_lora_b8")


def test_decode_pool_is_deterministic_and_every_seed_has_the_same_lengths():
    a = traffic.decode_pool(DEC.traffic, 2**33 + 5, "cpu")
    b = traffic.decode_pool(DEC.traffic, 2**33 + 5, "cpu")
    c = traffic.decode_pool(DEC.traffic, 7, "cpu")
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["speech"], c["speech"])
    B = DEC.traffic["batch_size"]
    for pool in (a, c):
        for s in range(0, len(pool["speech_lens"]), B):
            assert sorted(pool["speech_lens"][s:s + B]) == sorted(a["speech_lens"][:B])
    lens = a["speech_lens"]
    assert (lens >= 10 * 16000).all() and (lens <= 30 * 16000).all()
    tail = np.arange(a["speech"].shape[1])[None, :] >= lens[:, None]
    assert (a["speech"][tail] == 0).all()  # zero-padded to the window


def test_train_pool_is_deterministic_with_transcripts_of_the_stated_rate():
    a = traffic.train_pool(TRAIN.traffic, TRAIN.config, 11, "cpu")
    b = traffic.train_pool(TRAIN.traffic, TRAIN.config, 11, "cpu")
    for x, y in zip(a, b):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    for batch in a:
        want = np.round(3.5 * batch["speech_lens"] / 16000)
        np.testing.assert_array_equal(batch["text_lens"], want)
        assert ((batch["text"] >= 1) | (batch["text"] == -1)).all() and (batch["text"] < 50257).all()
        same = batch["spk_labels"][:, None] == batch["spk_labels"][None, :]
        np.testing.assert_array_equal(batch["neg_logits"] == -10000.0, same)


def test_embedding_rows_carry_unit_embeddings():
    batch = traffic.train_pool(EMB.traffic, EMB.config, 3, "cpu")[0]
    assert "enroll" not in batch
    np.testing.assert_allclose(np.linalg.norm(batch["enroll_embed"], axis=1), 1.0, rtol=1e-5)


def test_weights_follow_their_rules_and_the_seed():
    specs = [("a.attn_ln.weight", (4,)), ("a.query.bias", (4,)), ("a.query.weight", (64, 256)),
             ("d.token_embedding.weight", (300, 64)), ("d.positional_embedding", (8, 64))]
    w1, w2 = weights.make_weights(specs, 9, "cpu"), weights.make_weights(specs, 9, "cpu")
    w3 = weights.make_weights(specs, 10, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert not torch.equal(w1["a.query.weight"], w3["a.query.weight"])
    assert (w1["a.attn_ln.weight"] == 1).all() and (w1["a.query.bias"] == 0).all()
    assert all(t.dtype == torch.bfloat16 for t in w1.values())
    for name, std in (("a.query.weight", 256 ** -0.5), ("d.token_embedding.weight", 64 ** -0.5),
                      ("d.positional_embedding", 0.02)):
        assert abs(w1[name].float().std().item() / std - 1) < 0.15


def test_lora_factors_start_at_the_base_model():
    f = weights.make_lora([("x.query.weight", (8, 6))], 4, 1, "cpu")
    a, b = f["x.query.weight"]
    assert a.shape == (6, 4) and b.shape == (4, 8) and (b == 0).all() and a.abs().sum() > 0


def test_streams_are_distinct():
    assert len({weights.sub_seed(s, k) for s in (0, 1, 2**40) for k in ("weights", "lora", "speech")}) == 9
