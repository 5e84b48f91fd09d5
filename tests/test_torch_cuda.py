"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU (the
kernels have no CPU mode). The file imports no JAX, so it runs on the
machine with the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from robustsq_whisper_torch.ops import decode_attention as tdec
from robustsq_whisper_torch.ops import flash_attention as tflash
from robustsq_whisper_torch.ops import self_attention as tself


def _cross_inputs(seed, mode, layers=3, b=2, h=2, d=64, t_pad=1536):
    """Stacked K/V (layers, b, h, d[/2], t_pad) of random codes; K scales
    keep the scores O(1), as a quantizer's would."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d), np.float32)
    k_s = rng.uniform(0.05, 0.2, (b, h, d)).astype(np.float32)
    if mode == "int8":
        k_s /= 127.0 / 7.0
    if mode == "fp":
        shape = (layers, b, h, d, t_pad)
        kt, vt = (rng.standard_normal(shape, np.float32) for _ in range(2))
        return q, k_s, kt, vt
    dd = d // 2 if mode == "int4" else d  # any byte is a valid packed pair
    shape = (layers, b, h, dd, t_pad)
    kt, vt = (rng.integers(-128, 128, shape).astype(np.int8) for _ in range(2))
    if mode == "int8":
        kt, vt = (np.clip(x, -127, 127).astype(np.int8) for x in (kt, vt))
    return q, k_s, kt, vt


def _self_inputs(seed, layers=2, b=3, t_pad=16, heads=2, n_state=128):
    rng = np.random.default_rng(seed)
    q, kn, vn = (rng.standard_normal((b, n_state), np.float32) for _ in range(3))
    kc, vc = (
        rng.standard_normal((layers, b, t_pad, n_state), np.float32)
        for _ in range(2)
    )
    return q, kn, vn, kc, vc


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# bf16 operands, f32 accumulation: the output rounds to bf16 (2^-8 relative)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
F32_TOL = dict(rtol=1e-4, atol=1e-4)  # exp2f/__expf vs torch.exp


@pytest.mark.cuda
@pytest.mark.parametrize("t_len", [256, 301, 1516])  # 301: odd, ragged
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_tmaj_kernel_matches_plain(cuda, t_len, dtype):
    g = torch.Generator(device=cuda).manual_seed(t_len)
    q, k, v = (
        torch.randn(6, 64, t_len, generator=g, device=cuda).to(dtype)
        for _ in range(3)
    )
    n = tflash.flash_attention_tmaj.launches
    got = tflash.flash_attention_tmaj(q, k, v)
    torch.cuda.synchronize()
    assert tflash.flash_attention_tmaj.launches == n + 1
    ref = tflash.flash_attention_tmaj_plain(q, k, v)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), ref.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int4", "int8", "fp"])
def test_decode_cross_kernel_matches_plain(cuda, mode):
    q, k_s, kt, vt = _cross_inputs(3, mode)
    args = [torch.from_numpy(x).to(cuda) for x in (q, kt, vt, k_s)]
    kv_len = torch.tensor(1516, dtype=torch.int32, device=cuda)
    layer = torch.tensor(2, dtype=torch.int32, device=cuda)
    kw = dict(kv_len=kv_len, layer_idx=layer, packed_int4=mode == "int4")
    got = tdec.decode_cross_attention(*args, **kw)
    torch.cuda.synchronize()
    cpu = [a.cpu() for a in args]
    ref = tdec.decode_cross_attention(
        *cpu, kv_len=1516, layer_idx=2, packed_int4=mode == "int4"
    )
    torch.testing.assert_close(got.cpu(), ref, **F32_TOL)
    # host ints for kv_len / layer_idx are copied to the card
    again = tdec.decode_cross_attention(
        *args, kv_len=1516, layer_idx=2, packed_int4=mode == "int4"
    )
    assert torch.equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [0, 5, 15])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_self_kernel_matches_plain(cuda, pos, dtype):
    q, kn, vn, kc, vc = (
        torch.from_numpy(x).to(cuda, dtype) for x in _self_inputs(pos)
    )
    p = torch.tensor(pos, dtype=torch.int32, device=cuda)
    li = torch.tensor(1, dtype=torch.int32, device=cuda)
    got = tself.decode_self_attention(q, kn, vn, (kc, vc), p, li, heads=2)
    torch.cuda.synchronize()
    # host ints for pos / layer_idx are copied to the card
    again = tself.decode_self_attention(q, kn, vn, (kc, vc), pos, 1, heads=2)
    assert torch.equal(again, got)
    ref = tself.decode_self_attention_plain(q, kn, vn, (kc, vc), pos, 1, 2)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), ref.float(), **tol)
    if pos == 0:
        assert torch.equal(got, vn)


@pytest.mark.cuda
def test_bf16_logits_are_f32_sums(cuda):
    """The tied-embedding logits of a bf16 decoder are the f32 sum of the
    bf16 products, with no bf16 rounding of the result (the JAX einsum's
    preferred_element_type)."""
    from robustsq_whisper_torch.models import TSDecoder, WhisperDims

    dims = WhisperDims(n_text_state=128, n_text_head=2, n_text_layer=1, n_vocab=1000)
    dec = TSDecoder(dims).decoder.to(cuda, torch.bfloat16)
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(3, 1, 128, generator=g, device=cuda)
    got = dec.logits(x)
    ref = x.bfloat16().float() @ dec.token_embedding.weight.float().t()
    assert got.dtype == torch.float32 and got.shape == (3, 1, 1000)
    # f32 summation order only; a bf16 rounding would show at ~4e-3 relative
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
