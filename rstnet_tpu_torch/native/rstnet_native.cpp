// Native data-loader hot path: wav parsing, PCM conversion, resampling.
//
// The host-side data layer (codec segment loading, offline tokenization,
// serving PCM framing) is bandwidth-sensitive at production scale; this
// keeps it off the Python interpreter. Compiled on first use via g++ into a
// shared library and bound through ctypes (no pybind11 dependency); the
// numpy implementations in rstnet_tpu_torch/utils/audio.py remain as fallback.
//
// All functions are plain C ABI.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Parsed RIFF/WAVE header with the data-chunk location, for windowed reads.
struct WavInfo {
  uint16_t format = 0;   // 1 = PCM int, 3 = IEEE float
  uint16_t channels = 0;
  uint16_t bits = 0;
  uint32_t sample_rate = 0;
  long data_offset = 0;  // byte offset of the data payload
  long n_frames = 0;     // samples per channel
};

// Returns 0 on success; -1 open failed, -2 not a wav, -3 unsupported.
int parse_wav_header(FILE* f, WavInfo* info) {
  char riff[4], wave[4];
  uint32_t riff_size;
  if (fread(riff, 1, 4, f) != 4 || fread(&riff_size, 4, 1, f) != 1 ||
      fread(wave, 1, 4, f) != 4 || memcmp(riff, "RIFF", 4) != 0 ||
      memcmp(wave, "WAVE", 4) != 0)
    return -2;
  for (;;) {
    char id[4];
    uint32_t size;
    if (fread(id, 1, 4, f) != 4 || fread(&size, 4, 1, f) != 1) return -3;
    if (memcmp(id, "fmt ", 4) == 0) {
      uint8_t buf[40];
      uint32_t n = size < sizeof(buf) ? size : (uint32_t)sizeof(buf);
      if (fread(buf, 1, n, f) != n) return -3;
      if (size > n) fseek(f, size - n, SEEK_CUR);
      info->format = (uint16_t)(buf[0] | buf[1] << 8);
      info->channels = (uint16_t)(buf[2] | buf[3] << 8);
      info->sample_rate =
          (uint32_t)(buf[4] | buf[5] << 8 | buf[6] << 16 | (uint32_t)buf[7] << 24);
      info->bits = (uint16_t)(buf[14] | buf[15] << 8);
    } else if (memcmp(id, "data", 4) == 0) {
      if (info->channels == 0 || info->bits == 0) return -3;
      bool ok = (info->format == 1 && (info->bits == 16 || info->bits == 32 ||
                                       info->bits == 8)) ||
                (info->format == 3 && info->bits == 32);
      if (!ok) return -3;
      info->data_offset = ftell(f);
      info->n_frames = (long)size / (info->channels * (info->bits / 8));
      return 0;
    } else {
      fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
}

inline float decode_sample(const uint8_t* p, uint16_t format, uint16_t bits) {
  if (format == 1 && bits == 16) {
    int16_t v;
    memcpy(&v, p, 2);
    return v / 32768.0f;
  }
  if (format == 1 && bits == 32) {
    int32_t v;
    memcpy(&v, p, 4);
    return v / 2147483648.0f;
  }
  if (format == 3 && bits == 32) {
    float v;
    memcpy(&v, p, 4);
    return v;
  }
  return (p[0] - 128) / 128.0f;  // PCM u8
}

// One codec training item: channel-0 window read + two linear resamples.
// Mirrors WaveDataset.__getitem__ (data/codec_dataset.py) exactly.
long load_one_segment(const char* path, long start24, long seg24, long seg16,
                      long sr_main, long sr_side, float* out24, float* out16) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo w;
  int rc = parse_wav_header(f, &w);
  if (rc != 0) {
    fclose(f);
    return rc;
  }
  const long n = w.n_frames;
  if (n <= 1) {
    fclose(f);
    return -3;
  }
  // length after resampling the full file to sr_main (matches
  // utils/audio.py resample_linear: n_out = round(n * out/in))
  const long len24 =
      w.sample_rate == sr_main
          ? n
          : (long)llround((double)n * (double)sr_main / w.sample_rate);
  long s24 = start24 < 0 ? 0 : start24;
  if (s24 > len24) s24 = 0;
  long navail = len24 - s24;
  if (navail > seg24) navail = seg24;

  if (navail > 0) {
    // source window covering output positions [s24, s24+navail):
    // src_pos(j) = j * n / len24 (linspace endpoint=False grids)
    const double step = (double)n / (double)len24;
    long s0 = (long)(s24 * step);
    long s1 = (long)((s24 + navail - 1) * step) + 1;
    if (s0 < 0) s0 = 0;
    if (s1 > n - 1) s1 = n - 1;
    const long n_src = s1 - s0 + 1;
    const int bytes = w.bits / 8;
    const long frame_bytes = (long)w.channels * bytes;
    std::vector<uint8_t> raw((size_t)n_src * frame_bytes);
    if (fseek(f, w.data_offset + s0 * frame_bytes, SEEK_SET) != 0 ||
        fread(raw.data(), 1, raw.size(), f) != raw.size()) {
      fclose(f);
      return -4;
    }
    std::vector<float> src((size_t)n_src);
    for (long i = 0; i < n_src; ++i)
      src[i] = decode_sample(raw.data() + i * frame_bytes, w.format, w.bits);
    for (long j = 0; j < navail; ++j) {
      double pos = (s24 + j) * step - s0;
      long i0 = (long)pos;
      if (i0 >= n_src - 1) {
        out24[j] = src[n_src - 1];
      } else {
        double frac = pos - i0;
        out24[j] = (float)(src[i0] * (1.0 - frac) + src[i0 + 1] * frac);
      }
    }
  }
  for (long j = navail < 0 ? 0 : navail; j < seg24; ++j) out24[j] = 0.0f;
  fclose(f);

  // side view: resample the (padded) main segment, then clip/pad to seg16
  const long n16 = (long)llround((double)seg24 * (double)sr_side / (double)sr_main);
  const double step16 = (double)seg24 / (double)n16;
  const long lim = n16 < seg16 ? n16 : seg16;
  for (long j = 0; j < lim; ++j) {
    double pos = j * step16;
    long i0 = (long)pos;
    if (i0 >= seg24 - 1) {
      out16[j] = out24[seg24 - 1];
    } else {
      double frac = pos - i0;
      out16[j] = (float)(out24[i0] * (1.0 - frac) + out24[i0 + 1] * frac);
    }
  }
  for (long j = lim; j < seg16; ++j) out16[j] = 0.0f;
  return 0;
}

}  // namespace

extern "C" {

// File length (samples per channel) + format probe without reading data.
// Returns n_frames >= 0, or a negative error code.
long wav_info(const char* path, int* sample_rate, int* channels) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo w;
  int rc = parse_wav_header(f, &w);
  fclose(f);
  if (rc != 0) return rc;
  *sample_rate = (int)w.sample_rate;
  *channels = (int)w.channels;
  return w.n_frames;
}

// Parallel codec-batch loader: n_items segments, each seg24 samples at
// 24 kHz (out24, contiguous [n_items, seg24]) plus the 16 kHz teacher view
// (out16, [n_items, seg16]). starts[i] < 0 loads from 0 with zero padding
// (short file). status[i] = 0 ok / negative error (caller falls back).
// Threads split items; no Python involvement per item (GIL released for
// the whole batch by the ctypes call).
void load_codec_batch(const char** paths, long n_items, const long* starts,
                      long seg24, long seg16, long sr_main, long sr_side,
                      float* out24, float* out16, long* status,
                      int n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n_items) n_threads = (int)n_items;
  auto worker = [&](int t) {
    for (long i = t; i < n_items; i += n_threads)
      status[i] = load_one_segment(paths[i], starts[i], seg24, seg16,
                                   sr_main, sr_side, out24 + i * seg24,
                                   out16 + i * seg16);
  };
  if (n_threads == 1) {
    worker(0);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker, t);
  for (auto& th : pool) th.join();
}

// Parse a RIFF/WAVE file. Writes interleaved float32 samples in [-1, 1].
// Returns the number of frames written, or a negative error code.
//   -1 open failed, -2 not a wav, -3 unsupported encoding, -4 buffer small
long wav_read(const char* path, float* out, long max_samples, int* sample_rate,
              int* channels) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char riff[4], wave[4];
  uint32_t riff_size;
  if (fread(riff, 1, 4, f) != 4 || fread(&riff_size, 4, 1, f) != 1 ||
      fread(wave, 1, 4, f) != 4 || memcmp(riff, "RIFF", 4) != 0 ||
      memcmp(wave, "WAVE", 4) != 0) {
    fclose(f);
    return -2;
  }
  uint16_t audio_format = 0, num_channels = 0, bits = 0;
  uint32_t sr = 0;
  long produced = -3;
  // chunk walk
  for (;;) {
    char id[4];
    uint32_t size;
    if (fread(id, 1, 4, f) != 4 || fread(&size, 4, 1, f) != 1) break;
    if (memcmp(id, "fmt ", 4) == 0) {
      uint8_t buf[40];
      uint32_t n = size < sizeof(buf) ? size : (uint32_t)sizeof(buf);
      if (fread(buf, 1, n, f) != n) break;
      if (size > n) fseek(f, size - n, SEEK_CUR);
      audio_format = (uint16_t)(buf[0] | buf[1] << 8);
      num_channels = (uint16_t)(buf[2] | buf[3] << 8);
      sr = (uint32_t)(buf[4] | buf[5] << 8 | buf[6] << 16 | (uint32_t)buf[7] << 24);
      bits = (uint16_t)(buf[14] | buf[15] << 8);
    } else if (memcmp(id, "data", 4) == 0) {
      if (num_channels == 0 || bits == 0) break;
      long n_samples = size / (bits / 8);
      if (n_samples > max_samples) n_samples = max_samples;
      if (audio_format == 1 && bits == 16) {
        std::vector<int16_t> tmp(n_samples);
        long got = (long)fread(tmp.data(), 2, n_samples, f);
        for (long i = 0; i < got; ++i) out[i] = tmp[i] / 32768.0f;
        produced = got;
      } else if (audio_format == 1 && bits == 32) {
        std::vector<int32_t> tmp(n_samples);
        long got = (long)fread(tmp.data(), 4, n_samples, f);
        for (long i = 0; i < got; ++i) out[i] = tmp[i] / 2147483648.0f;
        produced = got;
      } else if (audio_format == 3 && bits == 32) {  // IEEE float
        produced = (long)fread(out, 4, n_samples, f);
      } else if (audio_format == 1 && bits == 8) {
        std::vector<uint8_t> tmp(n_samples);
        long got = (long)fread(tmp.data(), 1, n_samples, f);
        for (long i = 0; i < got; ++i) out[i] = (tmp[i] - 128) / 128.0f;
        produced = got;
      }
      break;
    } else {
      fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
  fclose(f);
  if (produced >= 0) {
    *sample_rate = (int)sr;
    *channels = (int)num_channels;
  }
  return produced;
}

// Linear-interpolation resampler over a mono float stream.
void resample_linear(const float* in, long n_in, float* out, long n_out) {
  if (n_in <= 1 || n_out <= 0) return;
  double step = (double)n_in / (double)n_out;
  for (long i = 0; i < n_out; ++i) {
    double pos = i * step;
    long i0 = (long)pos;
    if (i0 >= n_in - 1) {
      out[i] = in[n_in - 1];
      continue;
    }
    double frac = pos - i0;
    out[i] = (float)(in[i0] * (1.0 - frac) + in[i0 + 1] * frac);
  }
}

// float32 [-1,1] -> int16 PCM bytes (serving hot path).
void float_to_pcm16(const float* in, long n, int16_t* out) {
  for (long i = 0; i < n; ++i) {
    float v = in[i] * 32767.0f;
    if (v > 32767.0f) v = 32767.0f;
    if (v < -32768.0f) v = -32768.0f;
    out[i] = (int16_t)v;
  }
}

void pcm16_to_float(const int16_t* in, long n, float* out) {
  for (long i = 0; i < n; ++i) out[i] = in[i] / 32768.0f;
}

}  // extern "C"
