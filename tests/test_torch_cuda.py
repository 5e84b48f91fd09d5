"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU (the
kernels have no CPU mode). The file imports no JAX, so it runs on the
machine with the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from robustsq_whisper_torch.audio import frontend as tfront
from robustsq_whisper_torch.models.whisper.config import whisper_dims
from robustsq_whisper_torch.ops import beam_gather as tbg
from robustsq_whisper_torch.ops import decode_attention as tdec
from robustsq_whisper_torch.ops import flash_attention as tflash
from robustsq_whisper_torch.ops import quant as tquant
from robustsq_whisper_torch.ops import self_attention as tself

from ._waves import edge_wave


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
    if np.prod(shape) > 2**28:  # a whole model's stack: int8 draws, not 8 GB of int64 ones
        kt, vt = (rng.integers(-128, 128, shape, dtype=np.int8) for _ in range(2))
    else:
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
    torch.backends.cudnn.allow_tf32 = False  # f32 convolutions, as on the CPU
    return torch.device("cuda")


# bf16 operands, f32 accumulation: the output rounds to bf16 (2^-8 relative)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
F32_TOL = dict(rtol=1e-4, atol=1e-4)  # exp2f/__expf vs torch.exp


@pytest.mark.cuda
# 1, 63, 64, 65, 129, 301: odd or ragged tiles (2-byte loads for odd T);
# 1500, 1516: 8- and 16-byte words along T
@pytest.mark.parametrize("t_len", [1, 63, 64, 65, 129, 256, 301, 1500, 1516])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# 64: Whisper-medium's encoder at batch 4 x 16 heads; 640: an encoder chunk
# of 32 utterances x 20 heads (large-v3-turbo)
@pytest.mark.parametrize("bh", [6, 64, 640])
def test_flash_tmaj_kernel_matches_plain(cuda, t_len, dtype, bh):
    """Against the plain version in f32 on the same (bf16-valued) inputs:
    a bf16 output is off by its own rounding and that of P (2^-9 each)."""
    g = torch.Generator(device=cuda).manual_seed(t_len)
    q, k, v = (
        torch.randn(bh, 64, t_len, generator=g, device=cuda).to(dtype)
        for _ in range(3)
    )
    n = tflash.flash_attention_tmaj.launches
    got = tflash.flash_attention_tmaj(q, k, v)
    torch.cuda.synchronize()
    assert tflash.flash_attention_tmaj.launches == n + 1
    ref = tflash.flash_attention_tmaj_plain(q.float(), k.float(), v.float())
    tol = F32_TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=3e-3)
    torch.testing.assert_close(got.float(), ref, **tol)


def _tmaj_rows_inputs(cuda, seed, b, heads, t_len, dtype):
    """q, k, v as the encoder hands them to the strided form, per-head views
    of one channel-major (3 heads 64, b T) GEMM output, and O(1) query and
    value biases."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    n = heads * 64
    y = torch.randn(3 * n, b * t_len, generator=g, device=cuda).to(dtype)
    bias = torch.randn(2, n, generator=g, device=cuda).to(dtype)
    q, k, v = (z.view(heads, 64, b, t_len).permute(2, 0, 1, 3) for z in y.split(n))
    return q, k, v, bias[0], bias[1]


@pytest.mark.cuda
@pytest.mark.parametrize("t_len", [63, 301, 1500, 1516])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# Whisper-medium's 16 heads and large-v3-turbo's 20, at 2 utterances and at
# an encoder chunk of 32
@pytest.mark.parametrize("heads", [16, 20])
@pytest.mark.parametrize("b", [2, 32])
def test_flash_tmaj_rows_kernel_matches_plain(cuda, t_len, dtype, heads, b):
    """The strided, biased, row-output form against the plain version in
    f32 on the same (bf16-valued) inputs, the query bias rounded to the
    input dtype as the kernel rounds it: a bf16 output is off by its own
    rounding and that of P (2^-9 each)."""
    q, k, v, bq, bv = _tmaj_rows_inputs(cuda, t_len + heads + b, b, heads, t_len, dtype)
    n = (tflash.flash_attention_tmaj.launches, tflash.flash_attention_tmaj.rows_launches)
    got = tflash.flash_attention_tmaj_rows(q, k, v, bq, bv)
    torch.cuda.synchronize()
    assert (tflash.flash_attention_tmaj.launches,
            tflash.flash_attention_tmaj.rows_launches) == (n[0] + 1, n[1] + 1)
    assert got.shape == (b, t_len, heads * 64) and got.dtype == dtype and got.is_contiguous()
    qb = (q.float() + bq.float().view(heads, 64, 1)).to(dtype).float()
    ref = tflash.flash_attention_tmaj_rows_plain(qb, k.float(), v.float(), None, bv.float())
    tol = F32_TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=3e-3)
    torch.testing.assert_close(got.float(), ref, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("t_len", [63, 301, 1516])
def test_flash_tmaj_strided_form_is_the_contiguous_form(cuda, t_len):
    """Without biases the strided form on channel-major views gives the
    same bits as the contiguous (b*h, 64, T) form on the same data: only
    the addressing differs."""
    b, heads = 3, 4
    q, k, v, _, _ = _tmaj_rows_inputs(cuda, t_len, b, heads, t_len, torch.bfloat16)
    rows = tflash.flash_attention_tmaj_rows(q, k, v)
    flat = lambda z: z.contiguous().view(b * heads, 64, t_len)
    old = tflash.flash_attention_tmaj(flat(q), flat(k), flat(v))
    torch.cuda.synchronize()
    assert torch.equal(rows, old.reshape(b, heads, 64, t_len).permute(0, 3, 1, 2)
                       .reshape(b, t_len, heads * 64))


# (layers, batch, heads, layer read): a small stack, and Whisper-medium's
# 24 layers at batch 4 x 16 heads read at layer 7
CROSS_STACKS = [(3, 2, 2, 2), (24, 4, 16, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("layers,b,h,layer", CROSS_STACKS)
@pytest.mark.parametrize("mode", ["int4", "int8", "fp"])
def test_decode_cross_kernel_matches_plain(cuda, mode, layers, b, h, layer):
    q, k_s, kt, vt = _cross_inputs(3, mode, layers, b, h)
    args = [torch.from_numpy(x).to(cuda) for x in (q, kt, vt, k_s)]
    kv_len = torch.tensor(1516, dtype=torch.int32, device=cuda)
    li = torch.tensor(layer, dtype=torch.int32, device=cuda)
    kw = dict(kv_len=kv_len, layer_idx=li, packed_int4=mode == "int4")
    got = tdec.decode_cross_attention(*args, **kw)
    torch.cuda.synchronize()
    cpu = [a.cpu() for a in args]
    ref = tdec.decode_cross_attention(
        *cpu, kv_len=1516, layer_idx=layer, packed_int4=mode == "int4"
    )
    torch.testing.assert_close(got.cpu(), ref, **F32_TOL)
    # host ints for kv_len / layer_idx are copied to the card
    again = tdec.decode_cross_attention(
        *args, kv_len=1516, layer_idx=layer, packed_int4=mode == "int4"
    )
    assert torch.equal(again, got)


def _split_inputs(cuda, mode, group, t_pad=1536, b=1, h=2):
    """Stacked two-layer K/V and unscaled queries at a shape where the
    kernel splits T across a cluster: packed int4 codes with f32 q and K
    scales, or bf16 K/V with bf16 q (the time-minor cache's form)."""
    g = torch.Generator(device=cuda).manual_seed(group * 7 + t_pad)
    shape = (2, b, h, 32 if mode == "int4" else 64, t_pad)
    if mode == "int4":
        kt, vt = (torch.randint(-128, 128, shape, generator=g, device=cuda,
                                dtype=torch.int8) for _ in range(2))
        q = torch.randn(b, h, group, 64, generator=g, device=cuda)
        k_s = torch.rand(b, h, 64, generator=g, device=cuda) * 0.15 + 0.05
        return q, k_s, kt, vt
    kt, vt = (torch.randn(shape, generator=g, device=cuda).bfloat16() for _ in range(2))
    return torch.randn(b, h, group, 64, generator=g, device=cuda).bfloat16(), None, kt, vt


@pytest.mark.cuda
@pytest.mark.parametrize("edge", ["0", "1", "tile-1", "tile", "tile+1", "1516"])
@pytest.mark.parametrize("group", [1, 5])
@pytest.mark.parametrize("mode", ["int4", "bf16"])
@pytest.mark.parametrize("b,h", [(1, 2), (128, 20)], ids=["b1h2", "b128h20"])
def test_decode_cross_split_kernel_matches_plain(cuda, mode, group, edge, b, h):
    """T split across a cluster (S > 1 at one utterance of two heads) at the
    kv_len edges of a tile: ranks whose chunk lies past kv_len add nothing,
    and kv_len 0 is the empty state (0, -1e30, 0); at large-v3-turbo's
    decode batch (128 utterances of 20 heads) the 2560 pairs fill the card
    and each takes one CTA (S = 1). The state against the plain version;
    the output with its scales against the plain version (f32 q), or
    bit-equal to the state's output rounded to bf16 (bf16 q)."""
    mode_id = tdec.PACKED_INT4_MODE if mode == "int4" else 2
    tile = tdec.TILE[mode_id]
    kv_len = {"tile-1": tile - 1, "tile": tile, "tile+1": tile + 1}.get(edge) or int(edge)
    q, k_s, kt, vt = _split_inputs(cuda, mode, group, b=b, h=h)
    splits = tdec.choose_splits(b * h, 1536, mode_id, tdec._sm_count(cuda.index or 0))
    assert splits > 1 if b == 1 else splits == 1
    kw = dict(kv_len=kv_len, layer_idx=1, packed_int4=mode == "int4", group=group)
    qq = q if group > 1 else q[:, :, 0]
    n = tdec.decode_cross_attention.state_launches
    state = tdec.decode_cross_attention(qq, kt, vt, return_state=True, **kw)
    torch.cuda.synchronize()
    assert tdec.decode_cross_attention.state_launches == n + 1
    ref = tdec.decode_cross_attention_plain(
        q.float() * 0.125, kt, vt, kv_len, 1, mode == "int4", True
    )
    for got, r in zip(state, ref):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, r.reshape(got.shape), **F32_TOL)
    if kv_len == 0:
        assert not state[0].any() and (state[1] == -1e30).all() and not state[2].any()
        return
    out = tdec.decode_cross_attention(qq, kt, vt, k_s, **kw)
    assert out.dtype == q.dtype and out.shape == qq.shape
    if mode == "int4":
        qs = q * 0.125 * k_s[:, :, None]
        ref = tdec.decode_cross_attention_plain(qs, kt, vt, kv_len, 1, True)
        torch.testing.assert_close(out, ref.reshape(out.shape), **F32_TOL)
    else:
        assert torch.equal(out, state[0].bfloat16())


@pytest.mark.cuda
def test_decode_cross_kernel_is_deterministic(cuda):
    """The cluster merge has a fixed order and no atomics: two calls give
    the same bits."""
    q, k_s, kt, vt = _split_inputs(cuda, "int4", 5)
    kw = dict(kv_len=1516, layer_idx=1, packed_int4=True, group=5)
    a = tdec.decode_cross_attention(q, kt, vt, k_s, **kw)
    b = tdec.decode_cross_attention(q, kt, vt, k_s, **kw)
    s1 = tdec.decode_cross_attention(q, kt, vt, return_state=True, **kw)
    s2 = tdec.decode_cross_attention(q, kt, vt, return_state=True, **kw)
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(s1, s2))


@pytest.mark.cuda
def test_decode_cross_reads_a_transposed_beam_view(cuda):
    """The beam step's query is a transposed view of (b * g, h, d) bf16
    rows; the kernel reads it through its strides, with the bits of its
    contiguous copy, in one launch."""
    b, g, h = 2, 5, 4
    gen = torch.Generator(device=cuda).manual_seed(11)
    rows = torch.randn(b * g, h, 64, generator=gen, device=cuda).bfloat16()
    view = rows.reshape(b, g, h, 64).transpose(1, 2)  # (b, h, g, d), not contiguous
    assert not view.is_contiguous()
    kt, vt = (torch.randint(-128, 128, (3, b, h, 32, 1536), generator=gen, device=cuda,
                            dtype=torch.int8) for _ in range(2))
    k_s = torch.rand(b, h, 64, generator=gen, device=cuda) * 0.1
    kw = dict(kv_len=1516, layer_idx=2, packed_int4=True, group=g)
    n = tdec.decode_cross_attention.grouped_launches
    got = tdec.decode_cross_attention(view, kt, vt, k_s, **kw)
    assert tdec.decode_cross_attention.grouped_launches == n + 1
    ref = tdec.decode_cross_attention(view.contiguous(), kt, vt, k_s, **kw)
    assert got.dtype == torch.bfloat16 and torch.equal(got, ref)


@pytest.mark.cuda
def test_decode_cross_group8_long_cache_is_one_launch(cuda):
    """Group 8 over 8192 positions (65536 scores, more than a CTA could hold
    as a score array in shared memory) is one launch and matches the plain
    version."""
    q, k_s, kt, vt = _split_inputs(cuda, "int4", 8, t_pad=8192)
    kw = dict(kv_len=8000, layer_idx=0, packed_int4=True, group=8)
    n = tdec.decode_cross_attention.grouped_launches
    got = tdec.decode_cross_attention(q, kt, vt, k_s, **kw)
    torch.cuda.synchronize()
    assert tdec.decode_cross_attention.grouped_launches == n + 1
    ref = tdec.decode_cross_attention_plain(q * 0.125 * k_s[:, :, None], kt, vt, 8000, 0, True)
    torch.testing.assert_close(got, ref, **F32_TOL)


@pytest.mark.cuda
def test_decode_cross_entry_refuses_more_than_eight_splits(cuda):
    """The C entry returns an error for a split past the portable cluster
    size (9 CTAs) and the wrapper's check raises: there is no retry."""
    from robustsq_whisper_torch.ops import _build

    q, _, kt, vt = _split_inputs(cuda, "int4", 1)
    out = torch.empty((1, 2, 1, 64), device=cuda)
    kv = torch.tensor(100, dtype=torch.int32, device=cuda)
    err = _build.load("decode_cross_attention")(
        q.data_ptr(), None, kt.data_ptr(), vt.data_ptr(), None, kv.data_ptr(),
        out.data_ptr(), None, None, 1, 2, 64, 1536, 1, 0, 0, *q.stride()[:3], 9,
        _build.stream_ptr(cuda),
    )
    assert err != 0
    with pytest.raises(RuntimeError, match="decode_cross_attention"):
        _build.check(err, "decode_cross_attention")


# (pos, rows, heads, t_pad): the small shape (pos == t_pad: every
# position live), an odd head count (the int8 read takes heads in pairs),
# then the main path's widths (16 heads, n_state 1024) at its 56-position
# cache (batch 4, beam 20 rows), the edges of a 64-position tile over
# Whisper's 448-position text context and its full cache, and the JAX
# bench's greedy batch 128
SELF_CASES = [
    (0, 3, 2, 16), (5, 3, 2, 16), (15, 3, 2, 16), (16, 3, 2, 16), (13, 3, 3, 16),
    (0, 4, 16, 56), (52, 4, 16, 56), (52, 20, 16, 56),
    (1, 4, 16, 448), (63, 4, 16, 448), (64, 20, 16, 448), (65, 4, 16, 448),
    (447, 4, 16, 448), (448, 4, 16, 448), (148, 128, 16, 152),
]


@pytest.mark.cuda
@pytest.mark.parametrize("pos,rows,heads,t_pad", SELF_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_self_kernel_matches_plain(cuda, pos, rows, heads, t_pad, dtype):
    q, kn, vn, kc, vc = (
        torch.from_numpy(x).to(cuda, dtype)
        for x in _self_inputs(pos, b=rows, t_pad=t_pad, heads=heads, n_state=heads * 64)
    )
    p = torch.tensor(pos, dtype=torch.int32, device=cuda)
    li = torch.tensor(1, dtype=torch.int32, device=cuda)
    n = tself.decode_self_attention.launches
    got = tself.decode_self_attention(q, kn, vn, (kc, vc), p, li, heads=heads)
    torch.cuda.synchronize()
    assert tself.decode_self_attention.launches == n + 1
    # host ints for pos / layer_idx are copied to the card
    again = tself.decode_self_attention(q, kn, vn, (kc, vc), pos, 1, heads=heads)
    assert torch.equal(again, got)
    ref = tself.decode_self_attention_plain(q, kn, vn, (kc, vc), pos, 1, heads)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), ref.float(), **tol)
    if pos == 0:
        assert torch.equal(got, vn)


# every mode and group (10: two launches of 8 and 2) over each stack, and
# the large-v3 beam-5 cell's read: int4, 32 layers, 64 utterances x 20
# heads, read at its last layer
GROUPED_CASES = [(mode, group, *stack) for mode in ("int4", "int8", "fp") for group in (3, 5, 10)
                 for stack in CROSS_STACKS] + [("int4", 5, 32, 64, 20, 31)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,group,layers,b,h,layer", GROUPED_CASES)
def test_grouped_decode_cross_kernel_matches_plain(cuda, mode, group, layers, b, h, layer):
    q, k_s, kt, vt = _cross_inputs(group, mode, layers, b, h)
    q = np.stack([q * (1.0 + 0.1 * j) for j in range(group)], axis=2)
    args = [torch.from_numpy(x).to(cuda) for x in (q, kt, vt, k_s)]
    kw = dict(packed_int4=mode == "int4", group=group)
    n = tdec.decode_cross_attention.grouped_launches
    got = tdec.decode_cross_attention(*args, kv_len=1516, layer_idx=layer, **kw)
    torch.cuda.synchronize()
    assert tdec.decode_cross_attention.grouped_launches == n + (2 if group > 8 else 1)
    ref = tdec.decode_cross_attention(
        *[a.cpu() for a in args], kv_len=1516, layer_idx=layer, **kw
    )
    assert got.shape == ref.shape == q.shape
    torch.testing.assert_close(got.cpu(), ref, **F32_TOL)


# (live, src, layers, T, width): a small cache over each source map, and
# the beam-5 main path's last step at Whisper-medium (batch 4 x 5 beams, 24
# layers, 51 of 56 positions live, n_state 1024)
REORDER_CASES = [
    (live, src, 3, 40, 256) for live in (0, 9, 40)
    for src in ([3, 0, 0, 5, 2, 1], [5, 4, 3, 2, 1, 0], list(range(319, -1, -1)))
] + [(51, [3, 3, 0, 19, 19, 7, 12, 12, 1, 5, 5, 18, 2, 2, 9, 14, 14, 4, 11, 6], 24, 56, 1024)] + [
    # the large-v3 beam-5 cell's last reorder: 64 utterances x 5 beams, 32
    # layers, 148 of 160 positions live, n_state 1280
    (148, [5 * (i // 5) + (i // 5 + (i % 5) ** 2) % 5 for i in range(320)], 32, 160, 1280)]


@pytest.mark.cuda
@pytest.mark.parametrize("live,src,layers,t_len,width", REORDER_CASES)
def test_beam_reorder_kernel_matches_plain(cuda, live, src, layers, t_len, width):
    """A bf16 K/V pair (one launch) and an int8 and an f32 leaf, every
    position non-zero: the live chunks are permuted exactly, the tail kept.
    320 rows tile the row payload into slices of several blocks."""
    rows = len(src)
    g = torch.Generator(device=cuda).manual_seed(live)
    shape = (layers, rows, t_len, width)
    leaves = [
        torch.randn(shape, generator=g, device=cuda).bfloat16(),
        torch.randn(shape, generator=g, device=cuda).bfloat16(),
        torch.randint(-128, 128, shape, generator=g, device=cuda).to(torch.int8),
        torch.randn(shape, generator=g, device=cuda),
    ]
    before = [x.cpu() for x in leaves]
    src_rows = torch.tensor(src, dtype=torch.int32)
    n = tbg.beam_reorder_cache.launches
    out = tbg.beam_reorder_cache(leaves, src_rows.to(cuda), live=live, time_len=t_len)
    torch.cuda.synchronize()
    assert tbg.beam_reorder_cache.launches == n + 3
    assert all(o is x for o, x in zip(out, leaves))  # in place
    ref = tbg.beam_reorder_cache(
        [x.clone() for x in before], src_rows, live=live, time_len=t_len
    )
    p = tbg.live_positions(live, t_len)
    for o, r, x in zip(out, ref, before):
        assert torch.equal(o.cpu(), r)
        assert torch.equal(r[:, :, p:], x[:, :, p:])  # the tail is kept


# (settled, rows, t_pad): the deferred beam path's 20 rows over its
# 64-position cache, the edges of a tile over 448 positions and the full
# cache, and the JAX bench's beam 64 x 5 rows at settled 144
SETTLED_CASES = [
    (0, 20, 56), (5, 20, 56), (48, 20, 56), (48, 20, 64),
    (1, 4, 448), (63, 4, 448), (64, 4, 448), (65, 20, 448), (447, 4, 448),
    (448, 4, 448), (144, 320, 152),
]


@pytest.mark.cuda
@pytest.mark.parametrize("settled,rows,t_pad", SETTLED_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_settled_kernel_matches_plain(cuda, settled, rows, t_pad, dtype):
    """Through a row map with repeats (every third row reads its
    neighbour's physical row); settled == 0 is exactly (-1e30, 0, 0)."""
    rng = np.random.default_rng(settled)
    layers, n_state = 2, 1024
    q = torch.from_numpy(rng.standard_normal((rows, n_state), np.float32))
    kc, vc = (
        torch.from_numpy(rng.standard_normal((layers, rows, t_pad, n_state), np.float32))
        for _ in range(2)
    )
    row_map = torch.from_numpy(rng.permutation(rows))
    row_map[1::3] = row_map[0::3][: row_map[1::3].numel()]
    args = [t.to(cuda, dtype) for t in (q, kc, vc)]
    n = tself.settled_self_attention.launches
    got = tself.settled_self_attention(
        args[0], tuple(args[1:]), settled, 1, row_map.to(cuda), heads=16
    )
    torch.cuda.synchronize()
    assert tself.settled_self_attention.launches == n + 1
    ref = tself.settled_self_attention_plain(
        *[a.cpu() for a in args[:1]], tuple(a.cpu() for a in args[1:]),
        settled, 1, row_map, 16,
    )
    for g_, r in zip(got, ref):  # f32 state from the same (rounded) inputs
        torch.testing.assert_close(g_.cpu(), r, rtol=1e-3, atol=1e-3)
    if settled == 0:
        assert (got[0] == -1e30).all() and not got[1].any() and not got[2].any()


@pytest.mark.cuda
@pytest.mark.parametrize("pos,rows,heads,t_pad", SELF_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_decode_self_kernel_matches_plain(cuda, pos, rows, heads, t_pad, dtype):
    """The int8 flat cache (int8 K/V, bf16 scale leaf); pos = 0 reads no
    position and returns exactly the new token's V."""
    q, kn, vn, kc, vc = (
        torch.from_numpy(x).to(cuda)
        for x in _self_inputs(pos, b=rows, t_pad=t_pad, heads=heads, n_state=heads * 64)
    )
    cache = tself.quantize_flat_kv(kc, vc, heads)
    q, kn, vn = (x.to(dtype) for x in (q, kn, vn))
    n = tself.decode_self_attention.int8_launches
    got = tself.decode_self_attention(q, kn, vn, cache, pos, 1, heads=heads)
    torch.cuda.synchronize()
    assert tself.decode_self_attention.int8_launches == n + 1
    ref = tself.decode_self_attention_plain(
        q.cpu(), kn.cpu(), vn.cpu(), tuple(c.cpu() for c in cache), pos, 1, heads
    )
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float().cpu(), ref.float(), **tol)
    if pos == 0:
        assert torch.equal(got, vn)


def _tmin_inputs(cuda, seed, layers=2, b=3, heads=4, t_pad=256, dtype=torch.bfloat16):
    g = torch.Generator(device=cuda).manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, device=cuda).to(dtype)
    q, kn, vn = (rnd(b, heads, 64) for _ in range(3))
    kc, vc = (rnd(layers, b, heads, 64, t_pad) for _ in range(2))
    return q, kn, vn, kc, vc


@pytest.mark.cuda
# (kv_len, layers, batch, heads, T_pad): a small cache at its edges, and the
# greedy path's last step at Whisper-medium (24 layers, batch 4 x 16 heads,
# 52 of 128 positions)
@pytest.mark.parametrize("kv_len,layers,b,heads,t_pad", [
    (0, 2, 3, 4, 256), (1, 2, 3, 4, 256), (130, 2, 3, 4, 256), (256, 2, 3, 4, 256),
    (52, 24, 4, 16, 128),
])
def test_decode_cross_state_kernel_matches_plain(cuda, kv_len, layers, b, heads, t_pad):
    """return_state over the stacked dense time-minor cache: the f32 output
    and (m, l); kv_len = 0 is the all-masked state (-1e30, 0, 0)."""
    q, _, _, kc, vc = _tmin_inputs(cuda, kv_len, layers, b, heads, t_pad)
    n = tdec.decode_cross_attention.state_launches
    got = tdec.decode_cross_attention(q, kc, vc, kv_len=kv_len, layer_idx=1,
                                      return_state=True)
    torch.cuda.synchronize()
    assert tdec.decode_cross_attention.state_launches == n + 1
    ref = tdec.decode_cross_attention(q.cpu(), kc.cpu(), vc.cpu(), kv_len=kv_len,
                                      layer_idx=1, return_state=True)
    for g_, r in zip(got, ref):
        assert g_.dtype == torch.float32 and g_.shape == r.shape
        torch.testing.assert_close(g_.cpu(), r, **F32_TOL)
    if kv_len == 0:
        assert (got[1] == -1e30).all() and not got[2].any() and not got[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [0, 7, 200])
def test_decode_self_tmin_matches_plain(cuda, pos):
    """The time-minor read (the state kernel plus the f32 merge) against
    the same composition on the CPU; pos = 0 gives the new token's V."""
    q, kn, vn, kc, vc = _tmin_inputs(cuda, pos + 3)
    got = tself.decode_self_attention_tmin(q, kn, vn, (kc, vc), pos, 1)
    ref = tself.decode_self_attention_tmin(
        q.cpu(), kn.cpu(), vn.cpu(), (kc.cpu(), vc.cpu()), pos, 1
    )
    torch.testing.assert_close(got.float().cpu(), ref.float(), **BF16_TOL)
    if pos == 0:
        assert torch.equal(got, vn)


# (live, src, layers, T, heads, int8 leaves): 18 rows of a small 5-D cache
# with its int8 leaf and scales, and the bf16 5-D cache of the beam-5 main
# path's last step at Whisper-medium (batch 4 x 5 beams, 24 layers, 51 of
# 56 positions, 16 heads)
FLAT_REORDER_CASES = [
    (live, [3, 0, 0, 5, 2, 1] * 3, 3, 128, 4, True) for live in (0, 1, 20, 31, 32, 33, 128)
] + [(51, [3, 3, 0, 19, 19, 7, 12, 12, 1, 5, 5, 18, 2, 2, 9, 14, 14, 4, 11, 6], 24, 56, 16,
      False)]


@pytest.mark.cuda
@pytest.mark.parametrize("live,src,layers,t_len,heads,int8", FLAT_REORDER_CASES)
def test_flattened_beam_reorder_kernel_matches_plain(cuda, live, src, layers, t_len, heads,
                                                     int8):
    """5-D bf16 K/V (one launch), a 5-D int8 and an f32 scale leaf, every
    position non-zero: the live chunks move, the tail is written as zeros,
    the inputs are untouched. live below one chunk (1, 20, 31) moves one."""
    g = torch.Generator(device=cuda).manual_seed(live)
    src = torch.tensor(src, device=cuda)
    rows = src.numel()
    five = (layers, rows, t_len, heads, 64)
    leaves = (
        torch.randn(five, generator=g, device=cuda).bfloat16(),
        torch.randn(five, generator=g, device=cuda).bfloat16(),
    ) + ((
        torch.randint(-127, 128, five, generator=g, device=cuda).to(torch.int8),
        torch.rand((layers, rows, t_len, 32), generator=g, device=cuda) + 0.5,
    ) if int8 else ())
    before = [x.clone() for x in leaves]
    n = tbg.beam_reorder_cache.flat_launches
    out = tbg.beam_reorder_cache(leaves, src, live=live, time_len=t_len)
    torch.cuda.synchronize()
    assert tbg.beam_reorder_cache.flat_launches == n + (3 if int8 else 1)
    ref = tbg.beam_reorder_cache(tuple(x.cpu() for x in before), src.cpu(),
                                 live=live, time_len=t_len)
    for o, r, x, b in zip(out, ref, leaves, before):
        assert o is not x and torch.equal(x, b)
        assert torch.equal(o.cpu(), r)
        e = tbg.live_rows(live, x.numel() // (layers * rows * 128), t_len) * 128
        assert not o.reshape(layers, rows, -1)[:, :, e:].any()


@pytest.mark.cuda
def test_cuda_tensors_never_reach_the_plain_versions(cuda, monkeypatch):
    """On CUDA tensors each wrapper launches its kernel: with every plain
    version made to raise, the calls still succeed."""
    def refuse(*a, **k):
        raise AssertionError("a plain version ran on CUDA tensors")

    for mod, name in (
        (tflash, "flash_attention_tmaj_plain"),
        (tflash, "flash_attention_tmaj_rows_plain"),
        (tflash, "flash_attention_fwd_plain"),
        (tflash, "flash_attention_bwd_dq_plain"),
        (tflash, "flash_attention_bwd_dkv_plain"),
        (tdec, "decode_cross_attention_plain"),
        (tself, "decode_self_attention_plain"),
        (tself, "settled_self_attention_plain"),
        (tbg, "beam_reorder_cache_plain"),
        (tbg, "beam_reorder_flat_plain"),
    ):
        monkeypatch.setattr(mod, name, refuse)
    g = torch.Generator(device=cuda).manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g, device=cuda)
    tflash.flash_attention_tmaj(rnd(2, 64, 256), rnd(2, 64, 256), rnd(2, 64, 256))
    tflash.flash_attention_tmaj_rows(*(rnd(2, 2, 64, 256) for _ in range(3)), rnd(128), rnd(128))
    for dtype in (torch.float32, torch.bfloat16):
        qkv = [rnd(1, 70, 2, 64).to(dtype).requires_grad_() for _ in range(3)]
        tflash.flash_attention(*qkv).sum().backward()
    kt = torch.zeros((2, 2, 32, 512), dtype=torch.int8, device=cuda)
    for group, q in ((1, rnd(2, 2, 64)), (3, rnd(2, 2, 3, 64))):
        tdec.decode_cross_attention(q, kt, kt, kv_len=300, packed_int4=True, group=group)
    q, kc = rnd(6, 128), rnd(2, 6, 16, 128)
    tself.decode_self_attention(q, q, q, (kc, kc), 5, 1, heads=2)
    rm = torch.arange(6, device=cuda)
    tself.settled_self_attention(q, (kc, kc), 8, 1, rm, heads=2)
    tself.deferred_self_attention(q, q, q, (kc, kc), 10, 8, rm, 1, heads=2, window=8)
    tbg.beam_reorder_cache((kc, kc), rm.flip(0), live=9, time_len=16)
    k8, v8, sc = tself.quantize_flat_kv(kc, kc, 2)
    tself.decode_self_attention(q, q, q, (k8, v8, sc), 5, 1, heads=2)
    kt5 = rnd(2, 6, 2, 64, 128)
    q3 = rnd(6, 2, 64)
    tself.decode_self_attention_tmin(q3, q3, q3, (kt5, kt5), 9, 1)
    x5 = rnd(2, 6, 32, 2, 64)
    tbg.beam_reorder_cache((x5, x5), rm.flip(0), live=9, time_len=32)
    torch.cuda.synchronize()


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


def _rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| over max |ref|: bf16 results are checked against the
    plain f32 math relative to their scale."""
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _flash_inputs(cuda, seed, b, q_len, kv_len, h, dtype, mask):
    g = torch.Generator(device=cuda).manual_seed(seed)
    rnd = lambda t: torch.randn(b, t, h, 64, generator=g, device=cuda).to(dtype)
    q, k, v, do = rnd(q_len), rnd(kv_len), rnd(kv_len), rnd(q_len)
    m = None
    if mask == "padding":  # key padding, as the Qformer's masks
        lens = torch.tensor([kv_len, kv_len // 2 + 1][:b], device=cuda)
        valid = torch.arange(kv_len, device=cuda)[None] < lens[:, None]
        m = torch.where(valid, 0.0, -1e9)[:, None, None, :]
    elif mask == "causal":  # (q, kv), -inf above the diagonal
        i = torch.arange(q_len, device=cuda)[:, None]
        j = torch.arange(kv_len, device=cuda)[None, :]
        m = torch.where(j <= i + (kv_len - q_len), 0.0, float("-inf"))
    return q, k, v, do, m


FLASH_CASES = [  # (b, q_len, kv_len, heads, mask)
    (2, 256, 256, 3, None), (2, 301, 301, 2, None), (1, 75, 130, 2, None),
    (2, 160, 160, 2, "padding"), (1, 192, 192, 2, "causal"), (8, 1516, 1516, 2, None),
    (2, 333, 270, 3, "padding"),  # masked, q_len != kv_len, three query blocks
    # Whisper-medium's training shape (batch 8 x 16 heads over 1500 frames
    # and 16 queries), and a masked one of 4 heads
    (8, 1516, 1516, 16, None), (2, 301, 301, 4, "padding"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_match_plain(cuda, case, dtype):
    """The forward (out and lse) and both backward kernels against their
    plain versions on the same inputs (ragged tiles, q_len != kv_len, both
    mask forms)."""
    b, q_len, kv_len, h, mask = case
    q, k, v, do, m = _flash_inputs(cuda, q_len, b, q_len, kv_len, h, dtype, mask)
    n = [w.launches for w in (tflash.flash_attention_fwd, tflash.flash_attention_bwd_dq,
                              tflash.flash_attention_bwd_dkv)]
    out, lse = tflash.flash_attention_fwd(q, k, v, m)
    ref_out, ref_lse = tflash.flash_attention_fwd_plain(q, k, v, m)
    delta = tflash.flash_delta(ref_out, do)
    dq = tflash.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta, m)
    dk, dv = tflash.flash_attention_bwd_dkv(q, k, v, do, ref_lse, delta, m)
    torch.cuda.synchronize()
    assert [w.launches for w in (tflash.flash_attention_fwd, tflash.flash_attention_bwd_dq,
                                 tflash.flash_attention_bwd_dkv)] == [x + 1 for x in n]
    refs = (ref_out, tflash.flash_attention_bwd_dq_plain(q, k, v, do, ref_lse, delta, m),
            *tflash.flash_attention_bwd_dkv_plain(q, k, v, do, ref_lse, delta, m))
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)  # f32 both ways
    # f32: summation order and exp2f; bf16: operands and P, dS rounded to
    # bf16 before their products, outputs rounded to bf16
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for got, ref in zip((out, dq, dk, dv), refs):
        assert got.dtype == dtype and got.shape == ref.shape
        assert _rel_err(got, ref) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("t_len", [301, 1516])
def test_flash_layouts_are_bit_identical(cuda, t_len):
    """One kernel with one summation order computes both layouts: on the
    same bf16 data the transposed route and the row-major one (unmasked,
    (bh, T, 1, 64) views) give the same bits, transposed."""
    g = torch.Generator(device=cuda).manual_seed(t_len)
    q, k, v = (
        torch.randn(6, 64, t_len, generator=g, device=cuda).bfloat16() for _ in range(3)
    )
    rm = lambda z: z.transpose(1, 2)[:, :, None, :].contiguous()  # (bh, T, 1, 64)
    n = (tflash.flash_attention_tmaj.launches, tflash.flash_attention_fwd.launches)
    tmaj = tflash.flash_attention_tmaj(q, k, v)
    rows, _ = tflash.flash_attention_fwd(rm(q), rm(k), rm(v))
    torch.cuda.synchronize()
    assert (tflash.flash_attention_tmaj.launches, tflash.flash_attention_fwd.launches) == (
        n[0] + 1, n[1] + 1)
    assert torch.equal(tmaj, rows[:, :, 0, :].transpose(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES[:5])
def test_flash_autograd_matches_plain(cuda, case):
    """flash_attention's gradients (the three kernels behind the autograd
    Function) against autograd through the plain f32 function."""
    b, q_len, kv_len, h, mask = case
    q, k, v, do, m = _flash_inputs(cuda, 7, b, q_len, kv_len, h, torch.float32, mask)
    grads = []
    for fn in (tflash.flash_attention, tflash.flash_attention_plain):
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        (fn(*qkv, m) * do).sum().backward()
        grads.append([t.grad for t in qkv])
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, **F32_TOL)


@pytest.mark.cuda
def test_flash_tmaj_grads_match_rowmajor(cuda):
    """The transposed kernel's backward (row-major kernels on (bh, T, 1, d)
    views) against the row-major route's gradients."""
    g = torch.Generator(device=cuda).manual_seed(3)
    b, h, t = 2, 2, 300
    q, k, v = (torch.randn(b, t, h, 64, generator=g, device=cuda) for _ in range(3))
    tm = lambda z: z.permute(0, 2, 3, 1).reshape(b * h, 64, t)
    grads = []
    for route in ("tmaj", "rowmajor"):
        qkv = [x.clone().requires_grad_() for x in (q, k, v)]
        if route == "tmaj":
            o = tflash.flash_attention_tmaj(*map(tm, qkv))
        else:
            o = tm(tflash.flash_attention(*qkv))
        (o * o).sum().backward()
        grads.append([x.grad for x in qkv])
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, **F32_TOL)


def _flash_bwd(q, k, v, do, m=None):
    """Both backward kernels on the plain forward's lse and delta, and their
    plain versions on the same inputs: ((dq, dk, dv), (plain dq, dk, dv))."""
    out, lse = tflash.flash_attention_fwd_plain(q, k, v, m)
    delta = tflash.flash_delta(out, do)
    got = (tflash.flash_attention_bwd_dq(q, k, v, do, lse, delta, m),
           *tflash.flash_attention_bwd_dkv(q, k, v, do, lse, delta, m))
    ref = (tflash.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, m),
           *tflash.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, m))
    return got, ref


@pytest.mark.cuda
# 63, 64, 65, 129: ragged and whole 64-row stages; 1, 129, 1516: ragged
# 192-query (dQ) and 128-key (dK/dV) blocks
@pytest.mark.parametrize("t_len", [1, 63, 64, 65, 129, 1516])
def test_flash_bwd_kernels_match_plain(cuda, t_len):
    """The bf16 backward kernels against their plain versions over lengths
    that cut the kernels' stages and blocks anywhere."""
    q, k, v, do, _ = _flash_inputs(cuda, t_len, 2, t_len, t_len, 3, torch.bfloat16, None)
    n = (tflash.flash_attention_bwd_dq.launches, tflash.flash_attention_bwd_dkv.launches)
    got, ref = _flash_bwd(q, k, v, do)
    torch.cuda.synchronize()
    assert (tflash.flash_attention_bwd_dq.launches,
            tflash.flash_attention_bwd_dkv.launches) == (n[0] + 1, n[1] + 1)
    for x, r in zip(got, ref):
        assert x.dtype == torch.bfloat16 and x.shape == r.shape
        torch.testing.assert_close(x.float(), r.float(), **BF16_TOL)
        # with one key dQ and dK are 0 but for f32 rounding (dP = delta), so
        # only longer rows have a scale to be relative to
        if t_len > 1:
            assert _rel_err(x, r) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("t_len", [301, 1516])
def test_flash_tmaj_bf16_grads_match_plain(cuda, t_len):
    """The transposed route's bf16 backward runs the backward kernels on
    (bh, T, 1, 64) rows, 64 elements apart: there they match their plain
    versions, and autograd through flash_attention_tmaj returns exactly
    their results."""
    g = torch.Generator(device=cuda).manual_seed(t_len)
    q, k, v, gt = (
        torch.randn(6, 64, t_len, generator=g, device=cuda).bfloat16() for _ in range(4)
    )
    rm = lambda z: z.transpose(1, 2)[:, :, None, :].contiguous()  # (bh, T, 1, 64)
    qr, kr, vr, dor = map(rm, (q, k, v, gt))
    got, ref = _flash_bwd(qr, kr, vr, dor)
    for x, r in zip(got, ref):
        assert _rel_err(x, r) <= 2e-2
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    tflash.flash_attention_tmaj(*qkv).backward(gt)
    out, lse = tflash.flash_attention_fwd(qr, kr, vr)
    direct = tflash._flash_backward(qr, kr, vr, None, out, lse, dor)
    for x, d in zip(qkv, direct):
        assert torch.equal(x.grad, d[:, :, 0, :].transpose(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("mask", [None, "padding"])
def test_flash_bwd_is_deterministic(cuda, mask):
    """No atomics: every output tile has one writer, so two backward calls
    on the same bf16 inputs give the same bits."""
    q, k, v, do, m = _flash_inputs(cuda, 11, 2, 1516, 1516, 4, torch.bfloat16, mask)
    out, lse = tflash.flash_attention_fwd(q, k, v, m)
    first = tflash._flash_backward(q, k, v, m, out, lse, do)
    second = tflash._flash_backward(q, k, v, m, out, lse, do)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# (M, K, N): the decode step's rows (greedy 4, beam 20, a verify chunk 44),
# the M, N and K tails (1, 17, 63, 65, 130 rows; 7 and 51865 columns; K
# 16, 80 and 1040, not multiples of the 64-wide chunk) and the large-M tiling;
# the edges of the two one-launch decode kernels and the wgmma path: 64 | 65
# rows, 128, 129, 300, 700 and 6064 rows, N off the 64-, 128- and 256-column
# tiles, K 16, 48, 1040 (a 16-byte chunk past a 128-byte segment), 4096 and
# 8192 (the largest the fused path takes at few rows; 8208 takes two
# launches); the cluster-free kernel's row groups (17 rows: a group of one;
# 44 x 4096 columns: groups and a ring of rounds) and the widest N it splits
# past (4100 columns at 33 rows and K 2048: too many codes, so the cluster)
W8A8_SHAPES = [
    (4, 1024, 1024), (20, 1024, 4096), (44, 4096, 1024), (4, 1024, 51865),
    (1, 16, 7), (17, 80, 33), (63, 1040, 129), (65, 1024, 1024),
    (130, 4096, 200), (600, 1024, 1024),
    (64, 1024, 1000), (64, 48, 200), (20, 4096, 1024), (44, 1024, 51865), (4, 4096, 136),
    (128, 1024, 256), (129, 16, 72), (700, 1040, 1000), (6064, 1024, 1024),
    (6064, 4096, 1024), (300, 1024, 4100), (64, 8192, 100), (4, 8208, 64),
    (44, 1024, 4096), (33, 2048, 4100),
    # the rest of the Whisper-medium step at 4, 20 and 44 rows and of its
    # encoder at 4 x 1516, and more edges: 64 | 65 rows at N 1000, K 4096 at
    # 129 rows, K 48 at 44, K 1040 at 17 and 6064 rows
    (4, 1024, 4096), (4, 4096, 1024), (20, 1024, 1024), (20, 1024, 51865),
    (44, 1024, 1024), (6064, 1024, 4096), (65, 1024, 1000), (129, 4096, 200),
    (700, 1024, 1000), (44, 48, 33), (17, 1040, 129), (6064, 1040, 136),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", W8A8_SHAPES, ids=[f"{m}x{k}x{n}" for m, k, n in W8A8_SHAPES])
@pytest.mark.parametrize("x_dtype,out_dtype,with_bias", [
    (torch.bfloat16, torch.bfloat16, True), (torch.bfloat16, torch.float32, False),
    (torch.float32, torch.float32, True), (torch.float32, torch.bfloat16, False),
])
def test_w8a8_kernel_equals_plain(cuda, shape, x_dtype, out_dtype, with_bias):
    """Bit for bit: the kernel's codes, scales and epilogue are the plain
    version's ops, and its int32 sums are exact. A call launches
    ``launches_per_call(M, K)`` kernels: one at M <= 64, two above."""
    m, k, n = shape
    g = torch.Generator(device=cuda).manual_seed(m * 7 + n)
    x = (torch.randn(m, k, generator=g, device=cuda) * 3).to(x_dtype)
    x[0, : k // 2] = 0  # ties and zeros in a row's codes
    w_q, w_s = tquant.quantize_weight(torch.randn(n, k, generator=g, device=cuda) * 0.05)
    bias = torch.randn(n, generator=g, device=cuda) if with_bias else None
    launches = tquant.qmatmul.launches
    got = tquant.qmatmul(x, w_q, w_s, bias, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert tquant.qmatmul.launches == launches + tquant.launches_per_call(m, k)
    assert tquant.launches_per_call(m, k) == (1 if m <= 64 and k <= 8192 else 2)
    ref = tquant.qmatmul_plain(x, w_q, w_s, bias, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (m, n)
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4, 1024, 1024), (44, 4096, 1024), (20, 1024, 51865),
                                   (6064, 1024, 4096)])
def test_w8a8_is_deterministic(cuda, m, k, n):
    """No atomics touch a sum: two calls on the same inputs give the same
    bits (the cluster path's partial sums meet in a fixed rank)."""
    g = torch.Generator(device=cuda).manual_seed(k + n)
    x = torch.randn(m, k, generator=g, device=cuda).bfloat16()
    w_q, w_s = tquant.quantize_weight(torch.randn(n, k, generator=g, device=cuda) * 0.05)
    bias = torch.randn(n, generator=g, device=cuda)
    first = tquant.qmatmul(x, w_q, w_s, bias, out_dtype=torch.bfloat16)
    second = tquant.qmatmul(x, w_q, w_s, bias, out_dtype=torch.bfloat16)
    assert torch.equal(first, second)


def _identity_codes(cuda, x):
    """(kernel, plain) outputs of x (M, 1024) through 127 I: the int8 weight
    127 with scale RN(1/127) on the diagonal, so y[m, n] = 127 code[m, n]
    a_s[m] w_s: equal outputs mean equal codes."""
    w_q, w_s = tquant.quantize_weight(torch.eye(x.shape[1], device=cuda))
    return (tquant.qmatmul(x, w_q, w_s, out_dtype=torch.float32),
            tquant.qmatmul_plain(x, w_q, w_s, out_dtype=torch.float32))


def _past_local_k(x):
    """x (M, 1024) with zero columns up to K = 4096: past the cluster-free
    kernel's K, so the decode rows take the cluster kernel."""
    return np.pad(x, ((0, 0), (0, 4096 - x.shape[1])))


@pytest.mark.cuda
def test_w8a8_codes_are_the_ieee_quotients(cuda):
    """The kernels compute round(x / s) from RN(1 / s) and one FMA
    correction, not by a division: their codes must be the plain version's
    (a true IEEE division, then round half to even). Large-M path: every f32
    in [s / 4, 127 s] for three row maxima (below s / 4 every code is 0).
    Decode paths (M <= 64, f32 and bf16; at K = 1024 the cluster-free
    kernel, 16 rows in one CTA or 64 in four row groups; padded with zeros
    to K = 4096, the cluster one): every value within two ulps of each
    rounding tie (n + 1/2) s, n = 0 .. 126, of 64 row maxima, and every
    bf16 in [s / 4, 127 s] for 32 row maxima."""
    for amax in (1.0, 3.7e-3, 212.34567):
        s = np.float32(amax) / np.float32(127)
        lo = np.float32(s / 4).view(np.int32)
        hi = np.float32(amax).view(np.int32)
        vals = np.arange(lo, hi, dtype=np.int64).astype(np.int32).view(np.float32)
        rows = -(-vals.size // 1023)
        x = np.zeros((rows, 1024), np.float32)
        x[:, 0] = amax
        x[:, 1:].flat[: vals.size] = vals
        x[1::2, 1:] *= -1  # negative values round half to even too
        for i in range(0, rows, 16384):
            got, ref = _identity_codes(cuda, torch.from_numpy(x[i:i + 16384]).to(cuda))
            assert torch.equal(got, ref), amax
    rng = np.random.default_rng(0)
    amax = rng.uniform(0.5, 2.0, 64).astype(np.float32) * np.float32(10.0) ** rng.integers(-8, 6, 64)
    x = np.zeros((64, 1024), np.float32)
    for r, a in enumerate(amax):
        s = a / np.float32(127)
        ties = np.float32(np.arange(127) + 0.5) * s
        up1 = np.nextafter(ties, np.float32(np.inf))
        dn1 = np.nextafter(ties, np.float32(0))
        near = np.concatenate([ties, up1, dn1, np.nextafter(up1, np.float32(np.inf)),
                               np.nextafter(dn1, np.float32(0))])
        x[r, 0] = a
        x[r, 1:1 + near.size] = near * np.where(np.arange(near.size) % 2, -1, 1)
    for rows in [x[i:i + 16] for i in range(0, 64, 16)] + [x, _past_local_k(x)]:
        got, ref = _identity_codes(cuda, torch.from_numpy(rows).to(cuda))
        assert torch.equal(got, ref)
    b16 = (np.arange(0, 1 << 15, dtype=np.int32) << 16).view(np.float32)  # every bf16 >= 0
    xb = np.zeros((64, 1024), np.float32)
    for j in range(32):  # two rows a row maximum 2^(j - 12)
        a = np.float32(2.0 ** (j - 12))
        s = a / np.float32(127)
        vals = b16[(b16 >= s / 4) & (b16 <= a)]
        assert vals.size <= 2 * 1023
        for h in range(2):
            part = vals[h * 1023:(h + 1) * 1023]
            xb[2 * j + h, 0] = a
            xb[2 * j + h, 1:1 + part.size] = part
    for rows in [xb[i:i + 16] for i in range(0, 64, 16)] + [xb, _past_local_k(xb)]:
        got, ref = _identity_codes(cuda, torch.from_numpy(rows).to(cuda).bfloat16())
        assert torch.equal(got, ref)


@pytest.mark.cuda
def test_w8a8_zero_rows_and_leading_dims(cuda):
    """An all-zero row takes the 1e-12 scale floor (output = bias); leading
    axes are flattened and restored."""
    w_q, w_s = tquant.quantize_weight(torch.randn(48, 64, device=cuda))
    bias = torch.randn(48, device=cuda)
    x = torch.randn(2, 3, 64, device=cuda)
    x[1, 2] = 0
    got = tquant.qmatmul(x, w_q, w_s, bias)
    assert got.shape == (2, 3, 48)
    assert torch.equal(got, tquant.qmatmul_plain(x, w_q, w_s, bias))
    assert torch.equal(got[1, 2], bias)


@pytest.mark.cuda
def test_w8a8_refuses_what_it_cannot_take(cuda):
    w_q, w_s = tquant.quantize_weight(torch.randn(8, 40, device=cuda))
    with pytest.raises(ValueError, match="multiple of 16"):
        tquant.qmatmul(torch.randn(4, 40, device=cuda), w_q, w_s)
    w_q, w_s = tquant.quantize_weight(torch.randn(8, 64, device=cuda))
    with pytest.raises(TypeError, match="f32 or bf16"):
        tquant.qmatmul(torch.randn(4, 64, device=cuda).half(), w_q, w_s)


@pytest.mark.cuda
def test_quantize_on_the_card_is_the_ieee_division(cuda):
    """The scales and codes of quantize_weight / quantize_activation on the
    card equal the CPU's (a true f32 division on both: PyTorch's CUDA
    division by a Python scalar would multiply by the reciprocal)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(512, 333, generator=g) * torch.rand(512, 1, generator=g) * 10
    for fn in (tquant.quantize_activation, tquant.quantize_weight):
        cpu = fn(x)
        card = fn(x.to(cuda))
        for a, b in zip(cpu, card):
            assert torch.equal(a, b.cpu())


@pytest.mark.cuda
def test_data_parallel_decode_on_one_card_over_gloo(cuda, tmp_path):
    """Two gloo ranks on the one card (NCCL cannot put two ranks of a
    communicator on one GPU): each decodes its rows of a batch of 4 through
    ``build_sharded_decoder`` with the kernels, and the all-gathers of the
    CUDA tokens, scores and counters go over gloo; greedy, beam 3 and
    speculative equal one process's decode of the whole batch, token for
    token, scores to 1e-4 (f32)."""
    from robustsq_whisper_torch.decode.search import DecodeConfig, build_beam_decoder
    from robustsq_whisper_torch.decode.speculative import build_speculative_decoder
    from robustsq_whisper_torch.init import init_params
    from robustsq_whisper_torch.models import TSDecoder, WhisperDims

    from ._torch_dist import launch

    dims = dict(n_mels=80, n_vocab=64, n_audio_ctx=16, n_audio_state=128, n_audio_head=2,
                n_audio_layer=1, n_text_ctx=64, n_text_state=128, n_text_head=2,
                n_text_layer=3)
    base = dict(max_new_tokens=12, eot=2, init_tokens=(1, 4), quantize_cross_kv=True)
    cases = {"greedy": ({}, base), "beam3": ({}, dict(base, beam_size=3)),
             "speculative": (dict(flat_self_cache=False),
                             dict(base, speculative_gamma=3, draft_layers=1))}
    rng = np.random.default_rng(5)
    memory = rng.standard_normal((4, 40, 128)).astype(np.float32) * 3
    prompt = rng.standard_normal((4, 5, 128)).astype(np.float32) * 3
    sd = init_params(TSDecoder(WhisperDims(**dims), startofprev_token=3, cross_kv_bits=4),
                     5).state_dict()
    torch.save({"dims": dims, "sop": 3, "cross_kv_bits": 4, "memory": memory, "prompt": prompt,
                "decoder": sd, "device": "cuda",
                "cases": [(n, kw, cfg, (2, 1)) for n, (kw, cfg) in cases.items()]},
               tmp_path / "inputs.pt")
    launch("decode", 2, str(tmp_path), timeout=300)
    outs = [torch.load(tmp_path / f"out-{r}.pt", weights_only=False) for r in range(2)]
    for name, (kw, cfg_kw) in cases.items():
        dec = TSDecoder(WhisperDims(**dims), startofprev_token=3, cross_kv_bits=4, **kw)
        dec.load_state_dict(sd)
        cfg = DecodeConfig(**cfg_kw)
        run = (build_speculative_decoder(dec, cfg, cuda, return_stats=True)
               if cfg.speculative_gamma else build_beam_decoder(dec, cfg, cuda))
        want = run(torch.from_numpy(memory).to(cuda), torch.from_numpy(prompt).to(cuda))
        for out in outs:
            got = out[name]
            np.testing.assert_array_equal(got[0], want[0].cpu().numpy(), err_msg=name)
            np.testing.assert_allclose(got[1], want[1].cpu().numpy(), rtol=1e-4, atol=1e-4)
            if len(want) == 3:
                for k, v in want[2].items():
                    np.testing.assert_array_equal(got[2][k], v.cpu().numpy(), err_msg=k)


@pytest.mark.cuda
def test_data_parallel_train_steps_on_one_card_over_gloo(cuda, tmp_path):
    """Two gloo ranks on the one card take two data-parallel steps, and two
    fully sharded ones, of a small f32 ``TSASRModel`` on the flash route
    (the three training kernels run on each rank's 2 rows; SpecAugment and
    the Qformer dropouts on, drawn for the whole batch) against one
    process's steps over the batch of 4: the stats to 1e-5 relative, the
    gradient norm to 1e-4 (the CTC posteriors' sensitivity, as on the CPU),
    the weights to 1e-5 absolute; each FSDP rank holds half of every
    sharded tensor and of its moments."""
    from robustsq_whisper_torch.init import init_params
    from robustsq_whisper_torch.models import TSASRModel, TSEncoderConfig, TSModelConfig
    from robustsq_whisper_torch.models import WhisperDims
    from robustsq_whisper_torch.train import OptimConfig, TrainConfig
    from robustsq_whisper_torch.train import create_train_state, make_train_step

    from ._torch_dist import launch

    torch.backends.cudnn.allow_tf32 = False
    dims = dict(n_mels=80, n_vocab=64, n_audio_ctx=256, n_audio_state=128, n_audio_head=2,
                n_audio_layer=2, n_text_ctx=32, n_text_state=128, n_text_head=2,
                n_text_layer=2)
    ts = dict(num_query_tokens=2, num_hidden_layers=1, qformer_hidden_size=64,
              qformer_heads=2, qformer_intermediate_size=128, use_flash_attention=True)
    cfg = dict(vocab_size=64, sos=1, eos=2, startofprev=3, num_speakers=8, num_negatives=2)
    optim = dict(lr=1e-4, schedule="constant", eps=1e-5)
    rng = np.random.default_rng(2)
    b, samples, e_samples = 4, 512 * 160, 200 * 160
    text = rng.integers(4, 60, (b, 6)).astype(np.int32)
    batch = {
        "speech": (rng.standard_normal((b, samples)) * 0.05).astype(np.float32),
        "speech_lens": np.array([samples, samples - 9000, samples - 30000, samples], np.int32),
        "enroll": (rng.standard_normal((b, e_samples)) * 0.05).astype(np.float32),
        "enroll_lens": np.array([e_samples, e_samples - 5000, e_samples, e_samples], np.int32),
        "text": text, "text_lens": np.full((b,), 6, np.int32),
        "neg_logits": np.where(np.eye(b, dtype=bool), -10000.0, 1.0).astype(np.float32),
        "spk_labels": rng.integers(0, 8, (b,)).astype(np.int32),
    }
    model = init_params(TSASRModel(WhisperDims(**dims), TSEncoderConfig(**ts),
                                   TSModelConfig(**cfg)), 3)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    torch.save({"dims": dims, "ts": ts, "cfg": cfg, "optim": optim, "batch": batch,
                "state_dict": sd, "device": "cuda",
                "cases": [("dp", (2, 1), {}, {}, {}, 2),
                          ("fsdp", (2, 1), dict(fsdp=True), {}, {}, 2)]},
               tmp_path / "inputs.pt")
    launch("train", 2, str(tmp_path), timeout=300)
    outs = [torch.load(tmp_path / f"out-{r}.pt", weights_only=False) for r in range(2)]

    tcfg = TrainConfig(optim=OptimConfig(**optim))
    state = create_train_state(model, tcfg, device=cuda)
    step = make_train_step(model, tcfg, device=cuda)
    gen, stats = torch.Generator(cuda).manual_seed(0), []
    for _ in range(2):
        state, st = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, gen, 6)
        stats.append({k: float(v) for k, v in st.items()})
    for out in outs:
        for case in ("dp", "fsdp"):
            for got, want in zip(out[case]["stats"], stats):
                for k, v in want.items():
                    rel = 1e-4 if k == "grad_norm" else 1e-5
                    assert got[k] == pytest.approx(v, rel=rel, abs=1e-6), (case, k)
            for name, p in model.named_parameters():
                np.testing.assert_allclose(out[case]["params"][name].numpy(),
                                           p.detach().cpu().numpy(), rtol=0, atol=1e-5,
                                           err_msg=f"{case} {name}")
        sharded = set(out["fsdp"]["fsdp"])
        assert len(sharded) > 10
        for name, sizes in out["fsdp"]["stored"].items():
            n = dict(model.named_parameters())[name].numel()
            want = n // 2 if name in sharded else n
            assert sizes == (want,) * 4, (name, sizes, n)


# dims, token ids (eot, init tokens, startofprev) and memory lengths
GRAPH_SMALL = (dict(n_mels=80, n_vocab=64, n_audio_ctx=16, n_audio_state=128, n_audio_head=2,
                    n_audio_layer=1, n_text_ctx=64, n_text_state=128, n_text_head=2,
                    n_text_layer=3), (2, (1, 4), 3), (40, 100))
GRAPH_TURBO = (dataclasses.asdict(whisper_dims("large-v3-turbo")),
               (50257, (50258, 50259, 50360, 50364), 50362), (1516, 1500))
GRAPH_CASES = {  # name: (TSDecoder keywords, dtype, DecodeConfig keywords, model)
    "bf16-flat": ({}, torch.bfloat16, {}, GRAPH_SMALL),
    "f32-flat": ({}, torch.float32, {}, GRAPH_SMALL),
    "bf16-flat-int8": (dict(self_kv_bits=8), torch.bfloat16, {}, GRAPH_SMALL),
    "bf16-tmin": (dict(tmin_self_cache=True), torch.bfloat16, {}, GRAPH_SMALL),
    "bf16-w8a8": ({}, torch.bfloat16, dict(quantize_weights=True), GRAPH_SMALL),
    "bf16-flat-dense-prefill": ({}, torch.bfloat16, dict(prefill_quantized=False), GRAPH_SMALL),
    "bf16-flat-turbo": ({}, torch.bfloat16, {}, GRAPH_TURBO),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_greedy_step_graph_equals_eager(cuda, case, monkeypatch):
    """Greedy on a small Qformer decoder, or large-v3-turbo's (4 layers,
    1280 wide, 20 heads, the v3 vocabulary) over a memory of its length,
    with the int4 cross K/V, its token step replayed as one CUDA graph
    against the same decoder stepping eagerly (``graph_step_applies`` patched off): over a batch, another of
    its shape (which replays the graph over the cross K/V written into it),
    one of other shapes and the first again (each of those captures its own
    graph, the old one released), tokens, scores and every ``dec.step`` call's logits bit-equal,
    and the kernels' launch counters equal; on a batch whose rows all emit
    eot at the first allowed step (the final layer norm's bias along eot's
    embedding), the same tokens and scores in at most ``RUN_AHEAD`` more
    ``dec.step`` calls."""
    import gc
    import weakref

    from robustsq_whisper_torch.decode import search
    from robustsq_whisper_torch.decode.step_graph import KERNEL_COUNTERS
    from robustsq_whisper_torch.init import init_params
    from robustsq_whisper_torch.models import TSDecoder, WhisperDims

    dec_kw, dtype, cfg_kw, (dims, (eot, init_tokens, sop), (t, t_other)) = GRAPH_CASES[case]
    width, layers = dims["n_text_state"], dims["n_text_layer"]
    cfg = search.DecodeConfig(**{**dict(
        max_new_tokens=16, eot=eot, init_tokens=init_tokens, min_new_tokens=3,
        quantize_cross_kv=True, prefill_quantized=True), **cfg_kw})

    def decoder(eot_bias):
        dec = init_params(TSDecoder(WhisperDims(**dims), startofprev_token=sop, cross_kv_bits=4,
                                    **dec_kw), 5)
        with torch.no_grad():
            w = dec.decoder.token_embedding.weight[eot]
            dec.decoder.ln.bias += eot_bias * w / w.norm()
        return dec.to(cuda, dtype)

    rng = np.random.default_rng(7)
    batch = lambda b, t: tuple(
        torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 3).to(cuda)
        for s in ((b, t, width), (b, 5, width)))
    batches = [batch(4, t), batch(4, t), batch(3, t_other)]
    batches.append(batches[0])
    early = [batch(4, t)]

    def runs(dec, inputs, graphs_on, stop_early=True):
        """(outputs, [(logits, graph ref) a dec.step call], launch counts,
        the calls after each batch, the decoder's ``run``)."""
        if not graphs_on:
            monkeypatch.setattr(search, "graph_step_applies", lambda *a, **kw: False)
        calls, step = [], dec.step

        def captured(*a, **kw):
            logits, cache = step(*a, **kw)
            g = kw["graph"]
            assert (g is not None) == graphs_on
            calls.append((logits.clone(), None if g is None else weakref.ref(g)))
            return logits, cache

        dec.step = captured
        for fn, attrs in KERNEL_COUNTERS:
            for a in attrs:
                setattr(fn, a, 0)
        run = search.build_greedy_decoder(dec, dataclasses.replace(cfg, stop_early=stop_early), cuda)
        outs, firsts = [], []
        for memory, prompt in inputs:
            outs.append(run(memory, prompt))
            torch.cuda.synchronize()
            firsts.append(len(calls))
        counts = {(fn.__name__, a): getattr(fn, a) for fn, attrs in KERNEL_COUNTERS for a in attrs}
        del dec.step
        monkeypatch.undo()
        return outs, calls, counts, firsts, run

    dec = decoder(0.0)  # every batch runs all 15 calls, so the counts compare
    e_outs, e_calls, e_counts, _, _ = runs(dec, batches, False, stop_early=False)
    g_outs, g_calls, g_counts, firsts, g_run = runs(dec, batches, True, stop_early=False)
    for (et, es), (gt, gs) in zip(e_outs, g_outs):
        assert torch.equal(et, gt) and torch.equal(es, gs)
    assert len(e_calls) == len(g_calls) == 4 * 15
    for k, ((el, _), (gl, _)) in enumerate(zip(e_calls, g_calls)):
        assert torch.equal(el, gl), f"logits of call {k}"
    assert e_counts == g_counts and e_counts[("decode_cross_attention", "launches")] == 4 * 15 * layers
    refs = [g_calls[n - 1][1] for n in firsts]  # each batch's graph
    assert refs[0] is refs[1] and refs[1] is not refs[2] and refs[2] is not refs[3]
    gc.collect()
    assert refs[0]() is None and refs[2]() is None and refs[3]() is not None  # one live
    del g_run
    gc.collect()
    assert refs[3]() is None  # and it goes with the decoder's run

    dec = decoder(20.0)
    (e_out,), e_calls, _, _, _ = runs(dec, early, False)
    (g_out,), g_calls, _, _, _ = runs(dec, early, True)
    assert (e_out[0][:, :3] != eot).all() and (e_out[0][:, 3:] == eot).all()
    assert torch.equal(e_out[0], g_out[0]) and torch.equal(e_out[1], g_out[1])
    assert len(e_calls) == 3 and 3 <= len(g_calls) <= 3 + search.RUN_AHEAD
    for (el, _), (gl, _) in zip(e_calls, g_calls):
        assert torch.equal(el, gl)



def _host_pcm16_mel(wave, lens, n_mels, dev):
    """The decode job's frontend before ``pcm16_log_mel``: int16 on the
    host, a pageable copy, the log-mel on the device."""
    x = tfront.pcm16_to_float(torch.from_numpy(tfront.to_pcm16(wave)).to(dev))
    return tfront.log_mel_spectrogram(x, torch.from_numpy(lens).to(dev), n_mels)


# rows, samples, n_mels: the decode cells' speech and enrollments, and a small batch
FRONTEND_SHAPES = [(128, 480000, 80), (128, 160000, 128), (3, 16000, 80)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,width,n_mels", FRONTEND_SHAPES)
@pytest.mark.parametrize("order", ["warm-no-sync", "back-to-back"])
def test_device_frontend_equals_host_path(cuda, rows, width, n_mels, order):
    """``pcm16_log_mel``'s features and frame counts equal the host int16
    path's bit for bit. ``warm-no-sync``: once warm, a batch makes no
    synchronizing call (``set_sync_debug_mode("error")``) and counts one
    staged batch. ``back-to-back``: once warm, two batches sent behind a
    device sleep, with no sync between, each get their own features (the
    caching host allocator does not hand out a pinned block whose copy
    still waits in the stream)."""
    waves = [edge_wave(rows, width, seed) for seed in (0, 1)]
    lens = np.array([width - 160 * (i % 7) for i in range(rows)], np.int32)
    lens[-1] = width // 2
    refs = [_host_pcm16_mel(w, lens, n_mels, cuda) for w in waves]
    with torch.inference_mode():
        if order == "warm-no-sync":
            outs = [tfront.pcm16_log_mel(waves[0], lens, n_mels, cuda)]
            torch.cuda.synchronize()
            staged = tfront.pcm16_log_mel.staged
            torch.cuda.set_sync_debug_mode("error")
            try:
                outs.append(tfront.pcm16_log_mel(waves[1], lens, n_mels, cuda))
            finally:
                torch.cuda.set_sync_debug_mode(0)
            assert tfront.pcm16_log_mel.staged == staged + 1
        else:
            tfront.pcm16_log_mel(waves[1], lens, n_mels, cuda)  # pinned blocks cached
            torch.cuda.synchronize()
            torch.cuda._sleep(2_000_000_000)  # ~1 s: the first copy waits in the stream
            outs = [tfront.pcm16_log_mel(w, lens, n_mels, cuda) for w in waves]
    for (got, got_l), (ref, ref_l) in zip(outs, refs):
        assert torch.equal(got, ref) and torch.equal(got_l, ref_l) and got_l.dtype == ref_l.dtype


@pytest.mark.cuda
def test_decode_dataset_stages_each_batch_once_a_width(cuda, monkeypatch):
    """A tiny Qformer model's ``decode_dataset`` over three batches on the
    card: the counter says two staged waveform batches a decode batch, and
    the encoder's inputs and the hypotheses equal those of the same job
    with the host int16 frontend in ``pcm16_log_mel``'s place. A second
    job allocates no pinned memory: the first job's blocks stay cached,
    since the step graph's capture does not empty the caches."""
    from robustsq_whisper_torch.decode import pipeline
    from robustsq_whisper_torch.decode.search import DecodeConfig
    from robustsq_whisper_torch.init import init_params
    from robustsq_whisper_torch.models import (TSASRModel, TSEncoderConfig, TSModelConfig,
                                               WhisperDims)

    dims = WhisperDims(n_mels=80, n_vocab=64, n_audio_ctx=256, n_audio_state=128,
                       n_audio_head=2, n_audio_layer=2, n_text_ctx=32, n_text_state=128,
                       n_text_head=2, n_text_layer=2)  # heads of 64, as the kernels take
    ts = TSEncoderConfig(num_query_tokens=2, num_hidden_layers=1, qformer_hidden_size=32,
                         qformer_heads=2, qformer_intermediate_size=64,
                         qformer_hidden_dropout=0.0, qformer_attention_dropout=0.0)
    mcfg = TSModelConfig(vocab_size=64, sos=1, eos=2, startofprev=3, num_speakers=8,
                         num_negatives=2, use_specaug=False)
    model = init_params(TSASRModel(dims, ts, mcfg), 0)
    enc, dec = pipeline.serving_modules(dims, ts, mcfg, model.state_dict(), torch.float32, cuda)
    dcfg = DecodeConfig(max_new_tokens=6, eot=2, init_tokens=(1, 4), quantize_cross_kv=True)
    b, n = 3, 512 * 160

    class Batches:
        sample_rate = 16000
        text = {}

        def batches(self, batch_size, shuffle=False, drop_last=False):
            for k in range(3):
                yield {"utt_ids": [f"u{k}-{i}" for i in range(b)],
                       "speech": edge_wave(b, n, k), "speech_lens": np.full(b, n - 4000 * k, np.int32),
                       "enroll": edge_wave(b, n // 2, 10 + k),
                       "enroll_lens": np.full(b, n // 2, np.int32)}

    class IdTokenizer:
        def decode(self, ids):
            return " ".join(str(int(t)) for t in ids)

    def job():
        inputs = []
        hook = enc.register_forward_pre_hook(
            lambda m, args: inputs.append([a.clone() for a in args]))
        try:
            res = pipeline.decode_dataset(enc, dec, Batches(), IdTokenizer(), dcfg, batch_size=b,
                                          device=cuda)
        finally:
            hook.remove()
        return res.hyps, inputs

    staged = tfront.pcm16_log_mel.staged
    hyps, inputs = job()
    assert tfront.pcm16_log_mel.staged == staged + 2 * 3
    allocs = torch.cuda.host_memory_stats()["num_host_alloc"]
    assert job()[0] == hyps
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == allocs
    monkeypatch.setattr(pipeline, "pcm16_log_mel", _host_pcm16_mel)
    ref_hyps, ref_inputs = job()
    assert hyps == ref_hyps and len(hyps) == 3 * b
    assert len(inputs) == len(ref_inputs) == 3
    for got, ref in zip(inputs, ref_inputs):
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
