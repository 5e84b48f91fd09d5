// Minimal FLAC decoder (the subset LibriSpeech-style files use).
//
// LibriSpeech ships FLAC, and neither numpy nor scipy reads it, so the
// native loader decodes it directly: STREAMINFO parsing, frame headers with
// UTF-8 sample numbers, constant/verbatim/fixed/LPC subframes, rice-coded
// residual partitions (methods 0 and 1), wasted bits, and
// left-side/right-side/mid-side channel decorrelation. CRCs are not
// verified. Exposed through the same C ABI as the WAV loader (wavio.cpp).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace flac {

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t byte = 0;
  int bit = 0;  // bits consumed of current byte (0..7)
  bool error = false;

  bool eof() const { return byte >= size; }

  uint32_t read_bit() {
    if (byte >= size) {
      error = true;
      return 0;
    }
    uint32_t v = (data[byte] >> (7 - bit)) & 1u;
    if (++bit == 8) {
      bit = 0;
      ++byte;
    }
    return v;
  }

  uint64_t read_bits(int n) {  // n <= 64
    uint64_t v = 0;
    // fast path: aligned whole bytes
    while (n >= 8 && bit == 0 && byte < size) {
      v = (v << 8) | data[byte++];
      n -= 8;
    }
    for (int i = 0; i < n; ++i) v = (v << 1) | read_bit();
    return v;
  }

  int64_t read_signed(int n) {
    uint64_t v = read_bits(n);
    if (n == 0) return 0;
    if (v & (1ull << (n - 1))) v |= ~((1ull << n) - 1);  // sign extend
    return (int64_t)v;
  }

  uint32_t read_unary() {
    uint32_t q = 0;
    while (!error && read_bit() == 0) ++q;
    return q;
  }

  void align() {
    if (bit) {
      bit = 0;
      ++byte;
    }
  }
};

struct StreamInfo {
  uint32_t sample_rate = 0;
  uint32_t channels = 0;
  uint32_t bits = 0;
  uint64_t total_samples = 0;
};

// UTF-8-style coded number in frame headers (up to 36 bits / 7 bytes).
bool read_utf8_number(BitReader& br, uint64_t* out) {
  uint32_t b0 = (uint32_t)br.read_bits(8);
  if (br.error) return false;
  int extra;
  uint64_t v;
  if ((b0 & 0x80) == 0) {
    *out = b0;
    return true;
  } else if ((b0 & 0xE0) == 0xC0) {
    extra = 1;
    v = b0 & 0x1F;
  } else if ((b0 & 0xF0) == 0xE0) {
    extra = 2;
    v = b0 & 0x0F;
  } else if ((b0 & 0xF8) == 0xF0) {
    extra = 3;
    v = b0 & 0x07;
  } else if ((b0 & 0xFC) == 0xF8) {
    extra = 4;
    v = b0 & 0x03;
  } else if ((b0 & 0xFE) == 0xFC) {
    extra = 5;
    v = b0 & 0x01;
  } else if (b0 == 0xFE) {
    extra = 6;
    v = 0;
  } else {
    return false;
  }
  for (int i = 0; i < extra; ++i) {
    uint32_t b = (uint32_t)br.read_bits(8);
    if ((b & 0xC0) != 0x80) return false;
    v = (v << 6) | (b & 0x3F);
  }
  *out = v;
  return true;
}

bool decode_residual(BitReader& br, int order, int block_size,
                     int32_t* out /* residuals for block_size-order */) {
  uint32_t method = (uint32_t)br.read_bits(2);
  if (method > 1) return false;
  int plen = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 0xF : 0x1F;
  uint32_t part_order = (uint32_t)br.read_bits(4);
  uint32_t parts = 1u << part_order;
  int idx = 0;
  for (uint32_t p = 0; p < parts; ++p) {
    int count = block_size >> part_order;
    if (p == 0) count -= order;
    if (count < 0) return false;
    uint32_t param = (uint32_t)br.read_bits(plen);
    if (param == escape) {
      uint32_t raw = (uint32_t)br.read_bits(5);
      for (int i = 0; i < count; ++i)
        out[idx++] = (int32_t)br.read_signed((int)raw);
    } else {
      for (int i = 0; i < count; ++i) {
        uint32_t q = br.read_unary();
        uint64_t r = br.read_bits((int)param);
        uint64_t v = ((uint64_t)q << param) | r;
        out[idx++] = (int32_t)((v >> 1) ^ (~(v & 1) + 1));
        if (br.error) return false;
      }
    }
  }
  return !br.error;
}

bool decode_subframe(BitReader& br, int block_size, int bps,
                     std::vector<int64_t>& out) {
  out.resize(block_size);
  if (br.read_bit() != 0) return false;  // padding bit must be 0
  uint32_t type = (uint32_t)br.read_bits(6);
  int wasted = 0;
  if (br.read_bit()) {  // wasted bits flag
    wasted = 1 + (int)br.read_unary();
    bps -= wasted;
  }
  if (bps <= 0 || bps > 33) return false;

  std::vector<int32_t> res;
  if (type == 0) {  // constant
    int64_t v = br.read_signed(bps);
    for (int i = 0; i < block_size; ++i) out[i] = v;
  } else if (type == 1) {  // verbatim
    for (int i = 0; i < block_size; ++i) out[i] = br.read_signed(bps);
  } else if ((type & 0x38) == 0x08 && (type & 0x07) <= 4) {  // fixed
    int order = type & 0x07;
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
    res.resize(block_size - order);
    if (!decode_residual(br, order, block_size, res.data())) return false;
    for (int i = order; i < block_size; ++i) {
      int64_t e = res[i - order];
      switch (order) {
        case 0: out[i] = e; break;
        case 1: out[i] = e + out[i - 1]; break;
        case 2: out[i] = e + 2 * out[i - 1] - out[i - 2]; break;
        case 3:
          out[i] = e + 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3];
          break;
        case 4:
          out[i] = e + 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3] -
                   out[i - 4];
          break;
      }
    }
  } else if (type & 0x20) {  // LPC
    int order = (int)(type & 0x1F) + 1;
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
    uint32_t prec = (uint32_t)br.read_bits(4);
    if (prec == 0xF) return false;
    int precision = (int)prec + 1;
    int shift = (int)br.read_signed(5);
    if (shift < 0) return false;
    std::vector<int64_t> coef(order);
    for (int i = 0; i < order; ++i) coef[i] = br.read_signed(precision);
    res.resize(block_size - order);
    if (!decode_residual(br, order, block_size, res.data())) return false;
    for (int i = order; i < block_size; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += coef[j] * out[i - 1 - j];
      out[i] = (int64_t)res[i - order] + (pred >> shift);
    }
  } else {
    return false;
  }
  if (wasted)
    for (int i = 0; i < block_size; ++i) out[i] <<= wasted;
  return !br.error;
}

// Decode a whole FLAC byte buffer -> mono float32 (channels averaged).
// Returns valid sample count (after channel merge) or negative error.
int64_t decode(const uint8_t* data, size_t size, float* out, int64_t out_len,
               int32_t expect_rate, int32_t* rate_out, bool header_only,
               int64_t* total_out) {
  if (size < 42 || memcmp(data, "fLaC", 4) != 0) return -2;
  size_t pos = 4;
  StreamInfo si;
  bool have_si = false;
  // metadata blocks
  while (pos + 4 <= size) {
    uint8_t hdr = data[pos];
    bool last = hdr & 0x80;
    uint8_t btype = hdr & 0x7F;
    uint32_t blen = ((uint32_t)data[pos + 1] << 16) |
                    ((uint32_t)data[pos + 2] << 8) | data[pos + 3];
    pos += 4;
    if (btype == 0 && blen >= 34) {  // STREAMINFO
      const uint8_t* p = data + pos;
      si.sample_rate = ((uint32_t)p[10] << 12) | ((uint32_t)p[11] << 4) |
                       (p[12] >> 4);
      si.channels = ((p[12] >> 1) & 0x7) + 1;
      si.bits = (((p[12] & 1) << 4) | (p[13] >> 4)) + 1;
      si.total_samples = ((uint64_t)(p[13] & 0x0F) << 32) |
                         ((uint64_t)p[14] << 24) | ((uint64_t)p[15] << 16) |
                         ((uint64_t)p[16] << 8) | p[17];
      have_si = true;
    }
    pos += blen;
    if (last) break;
  }
  if (!have_si || si.sample_rate == 0 || si.channels == 0) return -2;
  if (rate_out) *rate_out = (int32_t)si.sample_rate;
  if (total_out) *total_out = (int64_t)si.total_samples;
  if (header_only) return (int64_t)si.total_samples;
  if (expect_rate > 0 && (int32_t)si.sample_rate != expect_rate) return -3;

  BitReader br{data, size, pos, 0, false};
  int64_t written = 0;
  std::vector<std::vector<int64_t>> ch(si.channels);

  while (written < out_len && br.byte + 4 < br.size && !br.error) {
    // frame sync
    uint32_t sync = (uint32_t)br.read_bits(14);
    if (br.error) break;
    if (sync != 0x3FFE) return written > 0 ? written : -4;
    br.read_bit();  // reserved
    br.read_bit();  // blocking strategy
    uint32_t bs_code = (uint32_t)br.read_bits(4);
    uint32_t sr_code = (uint32_t)br.read_bits(4);
    uint32_t ch_code = (uint32_t)br.read_bits(4);
    uint32_t ss_code = (uint32_t)br.read_bits(3);
    br.read_bit();  // reserved
    uint64_t dummy;
    if (!read_utf8_number(br, &dummy)) return -5;

    int block_size;
    if (bs_code == 1) block_size = 192;
    else if (bs_code >= 2 && bs_code <= 5) block_size = 576 << (bs_code - 2);
    else if (bs_code == 6) block_size = (int)br.read_bits(8) + 1;
    else if (bs_code == 7) block_size = (int)br.read_bits(16) + 1;
    else if (bs_code >= 8) block_size = 256 << (bs_code - 8);
    else return -5;

    if (sr_code == 12) br.read_bits(8);
    else if (sr_code == 13 || sr_code == 14) br.read_bits(16);

    int bps;
    switch (ss_code) {
      case 0: bps = (int)si.bits; break;
      case 1: bps = 8; break;
      case 2: bps = 12; break;
      case 4: bps = 16; break;
      case 5: bps = 20; break;
      case 6: bps = 24; break;
      case 7: bps = 32; break;
      default: return -5;
    }
    br.read_bits(8);  // header CRC-8 (unverified)

    int n_ch;
    int assign = (int)ch_code;
    if (assign <= 7) n_ch = assign + 1;
    else if (assign <= 10) n_ch = 2;
    else return -5;
    if ((uint32_t)n_ch != si.channels && !(assign >= 8 && si.channels == 2))
      return -5;

    for (int c = 0; c < n_ch; ++c) {
      int sub_bps = bps;
      if ((assign == 8 && c == 1) || (assign == 9 && c == 0) ||
          (assign == 10 && c == 1))
        sub_bps += 1;  // side channel carries one extra bit
      if (!decode_subframe(br, block_size, sub_bps, ch[c])) return -6;
    }
    br.align();
    br.read_bits(16);  // frame CRC-16 (unverified)

    // channel decorrelation
    if (assign == 8) {  // left/side
      for (int i = 0; i < block_size; ++i) ch[1][i] = ch[0][i] - ch[1][i];
    } else if (assign == 9) {  // right/side: ch0=side, ch1=right
      for (int i = 0; i < block_size; ++i) ch[0][i] = ch[1][i] + ch[0][i];
    } else if (assign == 10) {  // mid/side
      for (int i = 0; i < block_size; ++i) {
        int64_t mid = ch[0][i], side = ch[1][i];
        mid = (mid << 1) | (side & 1);
        ch[0][i] = (mid + side) >> 1;
        ch[1][i] = (mid - side) >> 1;
      }
    }

    float norm = 1.0f / (float)(1ll << (bps - 1));
    float inv_ch = 1.0f / (float)n_ch;
    int take = (int)std::min<int64_t>(block_size, out_len - written);
    for (int i = 0; i < take; ++i) {
      float acc = 0.0f;
      for (int c = 0; c < n_ch; ++c) acc += (float)ch[c][i] * norm;
      out[written + i] = acc * inv_ch;
    }
    written += take;
  }
  return written;
}

}  // namespace flac

// Shared entry used by wavio.cpp's dispatcher.
int64_t flac_decode_file(const char* path, float* out, int64_t out_len,
                         int32_t expect_rate) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf((size_t)fsize);
  size_t got = fread(buf.data(), 1, buf.size(), f);
  fclose(f);
  int64_t n = flac::decode(buf.data(), got, out, out_len, expect_rate,
                           nullptr, false, nullptr);
  if (n >= 0 && n < out_len)
    memset(out + n, 0, (size_t)(out_len - n) * sizeof(float));
  return n;
}

int64_t flac_num_samples(const char* path, int32_t* rate) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint8_t buf[64];
  size_t got = fread(buf, 1, sizeof(buf), f);
  fclose(f);
  int64_t total = 0;
  int64_t r = flac::decode(buf, got, nullptr, 0, 0, rate, true, &total);
  return r < 0 ? r : total;
}
