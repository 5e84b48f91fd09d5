"""The port's row-major flash attention against the JAX package's, on the CPU.

JAX runs ``flash_attention`` (forward kernel, and the dQ and dK/dV kernels
under ``jax.grad``) in Pallas interpret mode; the port runs each kernel
wrapper's plain PyTorch version through the same ``torch.autograd.Function``
that launches the CUDA kernels on the card. Both compute in f32 from the
same numpy inputs: the tolerance is f32 summation-order noise (2e-5 on O(1)
values, as ``tests/test_flash_attention.py`` allows its kernel 2e-4).
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robustsq_whisper_tpu.ops import attention as jatt
from robustsq_whisper_tpu.ops import flash_attention as jflash
from robustsq_whisper_torch.ops import _build
from robustsq_whisper_torch.ops import flash_attention as tflash

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, b, q_len, kv_len, h, d=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, q_len, h, d), np.float32)
    k, v = (rng.standard_normal((b, kv_len, h, d), np.float32) for _ in range(2))
    w = rng.standard_normal((b, q_len, h, d), np.float32)  # cotangent
    return q, k, v, w


def _mask(kind, b, q_len, kv_len):
    if kind is None:
        return None
    if kind == "causal":  # the JAX kernel tests' finite form of -inf
        return np.maximum(np.asarray(jatt.causal_mask(q_len, kv_len)), -1e30)[None, None]
    lens = np.array([kv_len, kv_len * 2 // 3][:b])
    return np.asarray(jatt.padding_mask(jnp.asarray(lens), kv_len))


def _jax_grads(q, k, v, w, mask):
    def loss(q, k, v):
        o = jflash.flash_attention(
            q, k, v, mask=None if mask is None else jnp.asarray(mask),
            block_q=64, block_k=64, interpret=True,
        )
        return jnp.sum(o * w), o

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (q, k, v))
    )
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch_grads(fn, q, k, v, w, mask):
    qkv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    m = None if mask is None else torch.from_numpy(np.array(mask, np.float32))
    out = fn(*qkv, m)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in qkv]


@pytest.mark.parametrize(
    "b,q_len,kv_len,h,mask",
    [
        (2, 256, 256, 2, None), (1, 75, 130, 2, None), (2, 130, 130, 2, "causal"),
        (2, 160, 160, 2, "padding"),
    ],
)
def test_flash_attention_matches_jax(b, q_len, kv_len, h, mask):
    """Forward output and dq / dk / dv: unmasked (ragged tiles, q_len !=
    kv_len), causal and key-padding masks."""
    q, k, v, w = _qkv(q_len + kv_len, b, q_len, kv_len, h)
    m = _mask(mask, b, q_len, kv_len)
    if mask == "padding":  # padded query rows are don't-care: zero their cotangent
        w = w * (np.arange(q_len)[None, :, None, None] < np.array([q_len, q_len * 2 // 3])[:, None, None, None])
    ref_out, ref_g = _jax_grads(q, k, v, w, m)
    out, g = _torch_grads(tflash.flash_attention, q, k, v, w, m)
    np.testing.assert_allclose(out, ref_out, **TOL)
    for got, ref in zip(g, ref_g):
        np.testing.assert_allclose(got, ref, **TOL)
    # the plain whole function agrees with the route through the kernels
    out_p, g_p = _torch_grads(tflash.flash_attention_plain, q, k, v, w, m)
    np.testing.assert_allclose(out_p, out, **TOL)
    for got, ref in zip(g_p, g):
        np.testing.assert_allclose(got, ref, **TOL)


def test_flash_forward_lse_matches_jax():
    """The forward kernel's second output, the f32 log-sum-exp per row."""
    q, k, v, _ = _qkv(5, 2, 150, 150, 2)
    _, ref = jflash._fwd_impl(*map(jnp.asarray, (q, k, v)), None, 64, 64, True)
    _, lse = tflash.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)))
    assert lse.dtype == torch.float32 and lse.shape == (2, 2, 150)
    np.testing.assert_allclose(lse.numpy().reshape(4, 150, 1), np.asarray(ref), **TOL)


def test_mask_gets_a_zero_gradient():
    q, k, v, w = _qkv(6, 1, 40, 40, 2)
    m = torch.zeros(1, 1, 40, 40, requires_grad=True)
    out = tflash.flash_attention(*map(torch.from_numpy, (q, k, v)), m)
    (out * torch.from_numpy(w)).sum().backward()
    assert m.grad is not None and not m.grad.any()


def test_flash_tmaj_grads_match_rowmajor():
    """flash_attention_tmaj's backward (the row-major kernels on (bh, T, 1,
    d) views) against the row-major route and the JAX package's tmaj VJP."""
    b, h, t = 2, 2, 256
    q, k, v, _ = _qkv(9, b, t, t, h)
    tm = lambda z: z.transpose(0, 2, 3, 1).reshape(b * h, 64, t)

    def jloss(q, k, v):
        o = jflash.flash_attention_tmaj(tm(q), tm(k), tm(v), interpret=True)
        return jnp.sum(o * o)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    grads = []
    for route in ("tmaj", "rowmajor"):
        qkv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        if route == "tmaj":
            o = tflash.flash_attention_tmaj(*(x.permute(0, 2, 3, 1).reshape(b * h, 64, t) for x in qkv))
        else:
            o = tflash.flash_attention(*qkv).permute(0, 2, 3, 1).reshape(b * h, 64, t)
        (o * o).sum().backward()
        grads.append([x.grad.numpy() for x in qkv])
    for got_t, got_r, r in zip(*grads, ref):
        np.testing.assert_allclose(got_t, got_r, **TOL)
        np.testing.assert_allclose(got_t, np.asarray(r), rtol=1e-4, atol=1e-4)


def _biased_attention(seed, n_state, n_head):
    """A flash, transposed-route MultiHeadAttention in f32 whose q, v and
    out biases are O(1) and non-zero."""
    from robustsq_whisper_torch.models.whisper.modules import MultiHeadAttention

    torch.manual_seed(seed)
    mha = MultiHeadAttention(n_state, n_head, use_flash=True, flash_tmaj=True)
    with torch.no_grad():
        for lin in (mha.query, mha.value, mha.out):
            lin.bias.copy_(torch.randn(n_state))
    return mha.eval()


@pytest.mark.parametrize("t_len", [256, 301])
def test_self_attend_tmaj_matches_attend_and_the_composition(t_len):
    """The encoder's self-attention through the strided, biased,
    row-output form of the transposed kernel equals the row-major
    ``attend`` route and the composition it replaced: the projections with
    their bias adds, ``flash_attention_tmaj_plain`` on (b*h, 64, T), the
    transpose back and the out-projection."""
    import torch.nn.functional as F

    b, n_state, h = 2, 128, 2
    mha = _biased_attention(t_len, n_state, h)
    x = torch.randn(b, t_len, n_state)
    with torch.no_grad():
        got = mha(x)
        route = mha.attend(x, *mha.kv(x))
        proj = lambda lin: (lin(x).transpose(1, 2)).reshape(b * h, 64, t_len)
        o = tflash.flash_attention_tmaj_plain(proj(mha.query), proj(mha.key), proj(mha.value))
        composed = F.linear(o.reshape(b, n_state, t_len).transpose(1, 2), mha.out.weight,
                            mha.out.bias)
    assert got.shape == (b, t_len, n_state)
    torch.testing.assert_close(got, route, **TOL)
    torch.testing.assert_close(got, composed, **TOL)


@pytest.mark.parametrize("t_len", [1, 63, 256, 301])
def test_tmaj_rows_plain_equals_the_contiguous_plain(t_len):
    """On contiguous (b*h, 64, T) input without biases the strided form's
    plain version is the old one's, transposed to rows."""
    b, h = 2, 3
    q, k, v = (torch.randn(b * h, 64, t_len) for _ in range(3))
    four = lambda z: z.view(b, h, 64, t_len)
    rows = tflash.flash_attention_tmaj_rows_plain(four(q), four(k), four(v))
    old = tflash.flash_attention_tmaj_plain(q, k, v)
    assert rows.shape == (b, t_len, h * 64)
    torch.testing.assert_close(rows, old.view(b, h, 64, t_len).permute(0, 3, 1, 2)
                               .reshape(b, t_len, h * 64), **TOL)


def test_tmaj_rows_grads_match_plain_autograd():
    """The strided form's backward (the row-major kernels' plain versions
    after a recompute) against autograd through its plain version: q, k, v
    as strided views of one channel-major GEMM output, and both biases."""
    b, h, t = 2, 2, 130
    n = h * 64
    y0 = torch.randn(3 * n, b * t)
    b0 = torch.randn(2, n)
    cot = torch.randn(b, t, n)
    grads = []
    for fn in (tflash.flash_attention_tmaj_rows, tflash.flash_attention_tmaj_rows_plain):
        y, bias = y0.clone().requires_grad_(), b0.clone().requires_grad_()
        q, k, v = (z.view(h, 64, b, t).permute(2, 0, 1, 3) for z in y.split(n))
        (fn(q, k, v, bias[0], bias[1]) * cot).sum().backward()
        grads.append((y.grad, bias.grad))
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, **TOL)


def test_lib_path_hashes_the_shared_header(tmp_path, monkeypatch):
    """An edited csrc/*.cuh header changes the library path of a kernel
    that includes it, so a stale library is never loaded."""
    for f in ("flash_attention.cu", "flash_common.cuh"):
        (tmp_path / f).write_text((_build.CSRC / f).read_text())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.lib_path("flash_attention")
    (tmp_path / "flash_common.cuh").write_text("// edited\n")
    assert _build.lib_path("flash_attention") != before


@pytest.mark.parametrize("header", ["sm90.cuh", "flash_fwd_sm90.cuh"])
def test_lib_path_hashes_the_hopper_headers(tmp_path, monkeypatch, header):
    """The backward library includes sm90.cuh and the forward ones also
    flash_fwd_sm90.cuh: an edit to either changes every library's path."""
    for f in ("flash_attention_bwd.cu", "flash_attention.cu", header):
        (tmp_path / f).write_text((_build.CSRC / f).read_text())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = [_build.lib_path(n) for n in ("flash_attention_bwd", "flash_attention")]
    (tmp_path / header).write_text("// edited\n")
    after = [_build.lib_path(n) for n in ("flash_attention_bwd", "flash_attention")]
    assert all(a != b for a, b in zip(after, before))


def _w8a8_paths():
    """w8a8_matmul.cu split at its large-M section: (decode part, large-M
    part)."""
    text = (_build.CSRC / "w8a8_matmul.cu").read_text()
    decode, large = text.split("// ---- 2. large M", 1)
    return decode, large


def test_bf16_flash_kernels_are_wgmma_only():
    """No mma.sync is left in csrc/ but one: the W8A8 decode kernels' s8
    m16n8k32 helper (4 to 64 rows, where a 64-row wgmma tile would be
    mostly padding); the bf16 flash kernels run on wgmma, the backward
    library through its two Hopper kernels."""
    sources = {p.name: p.read_text() for p in _build.CSRC.glob("*.cu*")}
    assert "sm90.cuh" in sources
    assert not [n for n, text in sources.items()
                if "mma.sync" in text and n != "w8a8_matmul.cu"]
    decode, large = _w8a8_paths()
    assert sources["w8a8_matmul.cu"].count("mma.sync.aligned") == 1
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in decode
    assert "mma_s8(" not in large
    bwd = sources["flash_attention_bwd.cu"]
    assert '#include "sm90.cuh"' in bwd
    for kernel in ("flash_bwd_dq_sm90_kernel", "flash_bwd_dkv_sm90_kernel"):
        assert re.search(kernel + r"<[^>]*><<<", bwd), f"{kernel} is not launched"


def test_w8a8_large_m_path_launches_a_wgmma_s8_kernel():
    """Past the decode rows the entry launches the row quantizer and then
    w8a8_gemm_sm90_kernel, whose consumers run s8 wgmma (m64n128k32, both
    operands K-major from shared memory) on a ring that a TMA producer
    fills (full / empty mbarriers)."""
    sm90 = (_build.CSRC / "sm90.cuh").read_text()
    assert "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8" in sm90
    assert "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes" in sm90
    decode, large = _w8a8_paths()
    assert re.search(r"w8a8_gemm_sm90_kernel<OutT><<<", large)
    assert re.search(r"quantize_rows_kernel<XT><<<", large)
    kernel = large[large.index("w8a8_gemm_sm90_kernel("):large.index("cuTensorMapEncodeTiled through")]
    for piece in ("wgmma_s8_ss_n128(", "tma_load_2d(", "mbar_wait(full(", "mbar_arrive(empty(",
                  "mbar_arrive_expect_tx(", "wgmma_commit()", "wgmma_wait<1>()"):
        assert piece in kernel, piece
    assert int(re.search(r"STAGES = (\d+)", large).group(1)) >= 2
    # every M past DECODE_ROWS (and K past DECODE_MAX_K) takes this path
    entry = large[large.index('extern "C" int w8a8_matmul('):]
    assert "if (M <= DECODE_ROWS && K <= DECODE_MAX_K) {" in entry
    assert "launch_gemm<" in entry.split("if (M <= DECODE_ROWS && K <= DECODE_MAX_K) {")[1]


def test_load_declares_every_entry_of_a_library(tmp_path, monkeypatch):
    """A library with several C entry points (the two backward kernels)
    loads once, declares each entry's signature and returns its first entry
    by default (as a wrapper loads its library by name)."""
    class Fn:
        pass

    class Lib:
        def __init__(self, path):
            for e in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
                setattr(self, e, Fn())

    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "lib_path", lambda name: tmp_path)  # exists: no build
    monkeypatch.setattr(_build.ctypes, "CDLL", Lib)
    first = _build.load("flash_attention_bwd")
    dkv = _build.load("flash_attention_bwd", "flash_attention_bwd_dkv")
    lib = _build._loaded["flash_attention_bwd"]
    assert first is lib.flash_attention_bwd_dq and dkv is lib.flash_attention_bwd_dkv
    for e in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert getattr(lib, e).argtypes == _build.SIGNATURES[e]
