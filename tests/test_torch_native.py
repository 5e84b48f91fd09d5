"""The port's native batched reader (``robustsq_whisper_torch/native``,
built with g++ at first use) against scipy's WAV reads and the JAX
package's native FLAC decoder.

The FLAC files are written here by a small encoder of our own: verbatim,
constant, fixed-predictor and LPC subframes with rice-coded residuals
(several partitions), wasted bits, and the four stereo channel
assignments, in frames of a few block sizes. CRC fields are zeros (the
decoder does not check them). Every comparison is exact."""

import os

import numpy as np
import pytest
from scipy.io import wavfile

from robustsq_whisper_tpu.data import native_loader as jnative
from robustsq_whisper_torch.data import dataset as pdataset
from robustsq_whisper_torch.data import kaldi_io as pkio
from robustsq_whisper_torch.data import native_loader as pnative


class Bits:
    """MSB-first bit writer."""

    def __init__(self):
        self.bits = []

    def put(self, value: int, n: int):
        for i in range(n - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def signed(self, value: int, n: int):
        self.put(value & ((1 << n) - 1), n)

    def unary(self, q: int):
        self.bits.extend([0] * q + [1])

    def align(self):
        self.bits.extend([0] * (-len(self.bits) % 8))

    def bytes(self) -> bytes:
        self.align()
        b = np.packbits(np.asarray(self.bits, np.uint8))
        return b.tobytes()


def _rice(bw: Bits, residual, part_order: int, block: int, order: int, k: int):
    bw.put(0, 2)  # 4-bit rice parameters
    bw.put(part_order, 4)
    idx = 0
    for p in range(1 << part_order):
        count = (block >> part_order) - (order if p == 0 else 0)
        bw.put(k, 4)
        for r in residual[idx: idx + count]:
            u = 2 * r if r >= 0 else -2 * r - 1
            bw.unary(u >> k)
            bw.put(u & ((1 << k) - 1), k)
        idx += count


FIXED = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _subframe(bw: Bits, x, bps: int, kind: str):
    """One subframe of the int samples ``x`` at ``bps`` bits."""
    x = [int(v) for v in x]
    n = len(x)
    wasted = 0
    if kind == "wasted":  # every sample even: one wasted bit, then verbatim
        assert all(v % 2 == 0 for v in x)
        wasted, x, bps, kind = 1, [v >> 1 for v in x], bps - 1, "verbatim"
    bw.put(0, 1)
    if kind == "constant":
        assert len(set(x)) == 1
        bw.put(0, 6)
        bw.put(0, 1)
        bw.signed(x[0], bps)
        return
    if kind == "verbatim":
        bw.put(1, 6)
        if wasted:
            bw.put(1, 1)
            bw.unary(wasted - 1)
        else:
            bw.put(0, 1)
        for v in x:
            bw.signed(v, bps)
        return
    if kind.startswith("fixed"):
        order = int(kind[-1])
        coef, shift, typ = FIXED[order], 0, 0x08 | order
    else:  # lpc: order 3, precision 12, shift 9
        order, shift = 3, 9
        coef = [int(round(c * (1 << shift))) for c in (1.6, -0.9, 0.2)]
        typ = 0x20 | (order - 1)
    bw.put(typ, 6)
    bw.put(0, 1)
    for v in x[:order]:
        bw.signed(v, bps)
    if typ & 0x20:
        bw.put(12 - 1, 4)
        bw.signed(shift, 5)
        for c in coef:
            bw.signed(c, 12)
    res = [x[i] - (sum(c * x[i - 1 - j] for j, c in enumerate(coef)) >> shift)
           for i in range(order, n)]
    _rice(bw, res, part_order=2 if n % 4 == 0 else 0, block=n, order=order, k=6)


def encode_flac(samples: np.ndarray, kinds, assign: int = None, rate=16000, block=1024) -> bytes:
    """``samples``: (channels, n) int16. ``kinds``: the subframe kind of
    each frame (cycled). ``assign``: a stereo channel assignment (8 left/
    side, 9 right/side, 10 mid/side; default independent)."""
    ch, n = samples.shape
    bw = Bits()
    bw.put(0x664C6143, 32)
    bw.put(1, 1)
    bw.put(0, 7)
    bw.put(34, 24)
    bw.put(block, 16)
    bw.put(block, 16)
    bw.put(0, 24)
    bw.put(0, 24)
    bw.put(rate, 20)
    bw.put(ch - 1, 3)
    bw.put(15, 5)
    bw.put(n, 36)
    bw.put(0, 128)  # MD5
    for f, start in enumerate(range(0, n, block)):
        bs = min(block, n - start)
        a = ch - 1 if assign is None else assign
        bw.put(0x3FFE, 14)
        bw.put(0, 2)
        bw.put(7, 4)  # block size: 16 bits at the header's end
        bw.put(0, 4)  # rate: STREAMINFO
        bw.put(a, 4)
        bw.put(4, 3)  # 16 bits a sample
        bw.put(0, 1)
        assert f < 128
        bw.put(f, 8)  # frame number, UTF-8 coded
        bw.put(bs - 1, 16)
        bw.put(0, 8)  # CRC-8
        chans = [samples[c, start: start + bs].astype(np.int64) for c in range(ch)]
        widths = [16] * ch
        if a == 8:
            chans, widths = [chans[0], chans[0] - chans[1]], [16, 17]
        elif a == 9:
            chans, widths = [chans[0] - chans[1], chans[1]], [17, 16]
        elif a == 10:
            chans, widths = [(chans[0] + chans[1]) >> 1, chans[0] - chans[1]], [16, 17]
        kind = kinds[f % len(kinds)]
        for x, w in zip(chans, widths):
            _subframe(bw, x, w, "verbatim" if (kind == "constant" and len(set(x)) > 1) else kind)
        bw.align()
        bw.put(0, 16)  # CRC-16
    return bw.bytes()


def _voice(n, seed, channels=1):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    out = []
    for c in range(channels):
        x = 6000 * np.sin(2 * np.pi * (0.01 + 0.003 * c) * t) + rng.normal(0, 300, n)
        out.append(np.clip(np.round(x), -32768, 32767))
    return np.asarray(out, np.int16)


FLAC_CASES = {
    "mono verbatim": (1, ["verbatim"], None, 2500),
    "mono constant": (1, ["constant", "verbatim"], None, 2048),
    "mono fixed orders": (1, ["fixed0", "fixed1", "fixed2", "fixed3", "fixed4"], None, 5 * 1024),
    "mono lpc": (1, ["lpc"], None, 3000),
    "mono wasted bits": (1, ["wasted"], None, 1500),
    "stereo independent": (2, ["fixed2", "verbatim"], None, 2100),
    "stereo left/side": (2, ["fixed2"], 8, 2048),
    "stereo right/side": (2, ["lpc"], 9, 2048),
    "stereo mid/side": (2, ["fixed1", "lpc"], 10, 3000),
}


@pytest.mark.parametrize("case", list(FLAC_CASES))
def test_flac_equals_jax_native_decoder(case, tmp_path):
    """Decoded samples: the port's reader, the JAX package's native decoder
    and the int16 source (mean of the channels / 32768) agree exactly."""
    channels, kinds, assign, n = FLAC_CASES[case]
    samples = _voice(n, seed=len(case), channels=channels)
    if "wasted" in case:
        samples = (samples // 2 * 2).astype(np.int16)
    if "constant" in case:
        samples[:, :1024] = -1234
    path = str(tmp_path / "a.flac")
    with open(path, "wb") as f:
        f.write(encode_flac(samples, kinds, assign))
    assert pnative.num_samples(path) == (n, 16000)
    got, sr = pkio.read_wav(path)
    assert sr == 16000 and got.dtype == np.float32 and got.shape == (n,)
    want, lens = jnative.load_batch([path], n, expect_rate=0)
    np.testing.assert_array_equal(got, want[0])
    norm = np.float32(1 / 32768)
    ref = sum(samples[c].astype(np.float32) * norm for c in range(channels))
    np.testing.assert_array_equal(got, ref * np.float32(1 / channels) if channels > 1 else ref)
    batch, blens = pnative.load_batch([path, path], n + 100, expect_rate=16000)
    assert blens.tolist() == [n, n] and not batch[:, n:].any()
    np.testing.assert_array_equal(batch[1, :n], got)


def _write(path, data, rate=16000):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    wavfile.write(path, rate, data)
    return path


def test_wav_batches_equal_scipy(tmp_path):
    """16-bit, 32-bit, 8-bit, float32 and stereo WAVs, truncated and
    zero-padded to the window, against scipy's reads."""
    rng = np.random.default_rng(0)
    paths = [
        _write(str(tmp_path / "i16.wav"), (rng.standard_normal(900) * 3000).astype(np.int16)),
        _write(str(tmp_path / "i32.wav"), (rng.standard_normal(1300) * 2**28).astype(np.int32)),
        _write(str(tmp_path / "u8.wav"), rng.integers(0, 256, 700).astype(np.uint8)),
        _write(str(tmp_path / "f32.wav"), (rng.standard_normal(1000) * 0.3).astype(np.float32)),
        _write(str(tmp_path / "st.wav"), (rng.standard_normal((1100, 2)) * 3000).astype(np.int16)),
    ]
    window = 1024
    batch, lens = pnative.load_batch(paths, window)
    for i, p in enumerate(paths):
        ref, sr = pkio.read_wav(p)
        n = min(len(ref), window)
        assert lens[i] == n and sr == 16000
        np.testing.assert_allclose(batch[i, :n], ref[:n], rtol=0,
                                   atol=0 if "st" not in p else 3e-8)  # stereo: two f32 sums
        assert not batch[i, n:].any()
    with pytest.raises(IOError, match="native decode failed"):
        pnative.load_batch(paths[:1], window, expect_rate=8000)


def test_dataset_reads_native_and_scipy_alike(tmp_path, monkeypatch):
    """A data dir of FLAC enrollments and WAV speech: the batches of the
    native reader equal those of the scipy fallback, and ``BATCH_READS``
    counts which reader served each batch."""
    rng = np.random.default_rng(1)
    d = tmp_path / "data"
    wav, text, enroll = {}, {}, {}
    for i in range(4):
        utt = f"{100 + i}-0-0000_{200 + i}-0-0000_spk1"
        wav[utt] = _write(str(d / f"{utt}.wav"), (rng.standard_normal(1200 + 300 * i) * 2000).astype(np.int16))
        fl = str(d / f"{utt}_e.flac")
        with open(fl, "wb") as f:
            f.write(encode_flac(_voice(900, seed=i), ["fixed2"]))
        enroll[utt] = fl
        text[utt] = "a b"
    for name, rows in (("wav.scp", wav), ("text", text), ("enroll.scp", enroll)):
        pkio.write_scp(str(d / name), rows)

    class Chars:
        def encode(self, s):
            return [ord(c) for c in s]

    def batches(reader):
        monkeypatch.setattr(pnative, "reader", lambda: reader)
        ds = pdataset.KaldiTSDataset(str(d), Chars(), speech_seconds=0.1, enroll_seconds=0.05,
                                     seed=3, num_speakers=3)
        assert ds.reader == reader
        return list(ds.batches(2, shuffle=True))

    pdataset.BATCH_READS.clear()
    native, scipy_ = batches("native"), batches("scipy")
    assert dict(pdataset.BATCH_READS) == {"native": 2, "scipy": 2}
    for a, b in zip(native, scipy_):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    assert native[0]["spk_labels"].max() < 3


def test_flac_raises_without_the_native_reader(tmp_path, monkeypatch):
    path = tmp_path / "a.flac"
    path.write_bytes(encode_flac(_voice(100, 0), ["verbatim"]))
    monkeypatch.setattr(pnative, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native reader"):
        pkio.read_wav(str(path))
