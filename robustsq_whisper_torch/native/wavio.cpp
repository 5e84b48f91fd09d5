// Native batched WAV loader for the host-side input pipeline.
//
// Decodes 16/24/32-bit PCM and float32 WAV (and FLAC, through flac.cpp) into
// a caller-provided float32 batch buffer, fanning the files out over a
// thread pool, with per-file truncate/pad semantics matching
// data/collate.py. Exposed through a C ABI that data/native_loader.py binds
// with ctypes.
//
// Build (data/native_loader.py does it at first use):
//   g++ -O3 -std=c++17 -fPIC -shared -o libwavio.so wavio.cpp flac.cpp -lpthread

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct WavInfo {
  uint32_t sample_rate = 0;
  uint16_t channels = 0;
  uint16_t bits = 0;
  uint16_t format = 0;  // 1 = PCM, 3 = IEEE float
  long data_offset = 0;
  uint32_t data_bytes = 0;
};

bool parse_header(FILE* f, WavInfo* info) {
  char riff[4], wave[4];
  uint32_t riff_size;
  if (fread(riff, 1, 4, f) != 4 || memcmp(riff, "RIFF", 4) != 0) return false;
  if (fread(&riff_size, 4, 1, f) != 1) return false;
  if (fread(wave, 1, 4, f) != 4 || memcmp(wave, "WAVE", 4) != 0) return false;
  // chunk walk
  while (true) {
    char id[4];
    uint32_t size;
    if (fread(id, 1, 4, f) != 4 || fread(&size, 4, 1, f) != 1) return false;
    if (memcmp(id, "fmt ", 4) == 0) {
      uint16_t fmt, ch;
      uint32_t rate, byte_rate;
      uint16_t block, bits;
      if (size < 16) return false;
      if (fread(&fmt, 2, 1, f) != 1 || fread(&ch, 2, 1, f) != 1 ||
          fread(&rate, 4, 1, f) != 1 || fread(&byte_rate, 4, 1, f) != 1 ||
          fread(&block, 2, 1, f) != 1 || fread(&bits, 2, 1, f) != 1)
        return false;
      info->format = fmt;
      info->channels = ch;
      info->sample_rate = rate;
      info->bits = bits;
      if (size > 16) fseek(f, size - 16, SEEK_CUR);
    } else if (memcmp(id, "data", 4) == 0) {
      info->data_offset = ftell(f);
      info->data_bytes = size;
      return info->sample_rate != 0;
    } else {
      fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
}

// Decode one file into out[0:out_len], zero-padding the tail. Returns the
// number of valid samples written (after channel-averaging), or a negative
// error code.
int64_t decode_one(const char* path, float* out, int64_t out_len,
                   int32_t expect_rate) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  if (!parse_header(f, &info) || info.channels == 0) {
    fclose(f);
    return -2;
  }
  if (expect_rate > 0 && (int32_t)info.sample_rate != expect_rate) {
    fclose(f);
    return -3;
  }
  const int bytes_per = info.bits / 8;
  const int64_t total_frames =
      info.data_bytes / (int64_t)(bytes_per * info.channels);
  const int64_t frames = std::min<int64_t>(total_frames, out_len);
  fseek(f, info.data_offset, SEEK_SET);

  std::vector<uint8_t> raw((size_t)frames * bytes_per * info.channels);
  size_t got = fread(raw.data(), 1, raw.size(), f);
  fclose(f);
  const int64_t got_frames = (int64_t)(got / (bytes_per * info.channels));

  const float inv_ch = 1.0f / (float)info.channels;
  for (int64_t i = 0; i < got_frames; ++i) {
    float acc = 0.0f;
    for (int c = 0; c < info.channels; ++c) {
      const uint8_t* p = raw.data() + ((size_t)i * info.channels + c) * bytes_per;
      float v = 0.0f;
      if (info.format == 3 && info.bits == 32) {
        float fv;
        memcpy(&fv, p, 4);
        v = fv;
      } else if (info.bits == 16) {
        int16_t s;
        memcpy(&s, p, 2);
        v = (float)s / 32768.0f;
      } else if (info.bits == 32) {
        int32_t s;
        memcpy(&s, p, 4);
        v = (float)s / 2147483648.0f;
      } else if (info.bits == 24) {
        int32_t s = (p[0] << 8) | (p[1] << 16) | ((int32_t)(int8_t)p[2] << 24);
        v = (float)s / 2147483648.0f;
      } else if (info.bits == 8) {
        v = ((float)p[0] - 128.0f) / 128.0f;
      }
      acc += v;
    }
    out[i] = acc * inv_ch;
  }
  if (got_frames < out_len)
    memset(out + got_frames, 0, (size_t)(out_len - got_frames) * sizeof(float));
  return got_frames;
}

}  // namespace

// FLAC support (flac.cpp)
int64_t flac_decode_file(const char* path, float* out, int64_t out_len,
                         int32_t expect_rate);
int64_t flac_num_samples(const char* path, int32_t* rate);

namespace {

bool is_flac(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  char magic[4] = {0};
  size_t got = fread(magic, 1, 4, f);
  fclose(f);
  return got == 4 && memcmp(magic, "fLaC", 4) == 0;
}

}  // namespace

extern "C" {

// Decode a batch of wavs into out (shape [n, out_len], row-major float32).
// lens[i] receives the valid sample count (or negative error). n_threads=0
// uses hardware_concurrency. Returns number of failed files.
int wavio_load_batch(const char** paths, int64_t n, float* out,
                     int64_t out_len, int64_t* lens, int32_t expect_rate,
                     int32_t n_threads) {
  if (n_threads <= 0) {
    n_threads = (int32_t)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 4;
  }
  n_threads = (int32_t)std::min<int64_t>(n_threads, n > 0 ? n : 1);
  std::atomic<int64_t> next(0);
  std::atomic<int> failures(0);
  auto worker = [&]() {
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= n) break;
      int64_t r = is_flac(paths[i])
                      ? flac_decode_file(paths[i], out + i * out_len, out_len,
                                         expect_rate)
                      : decode_one(paths[i], out + i * out_len, out_len,
                                   expect_rate);
      lens[i] = r;
      if (r < 0) failures.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  for (int32_t t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

// Single-file probe: returns sample count (after channel-merge) or negative
// error; fills rate.
int64_t wavio_num_samples(const char* path, int32_t* rate) {
  if (is_flac(path)) return flac_num_samples(path, rate);
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  if (!parse_header(f, &info) || info.channels == 0) {
    fclose(f);
    return -2;
  }
  fclose(f);
  *rate = (int32_t)info.sample_rate;
  return info.data_bytes / (int64_t)((info.bits / 8) * info.channels);
}

}  // extern "C"
