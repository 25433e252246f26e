// ariesaudio — native host-side audio runtime for whisper_aries_tpu_torch
// (the port's own copy of the JAX package's native/ariesaudio.cpp; the
// code below is that file's, unchanged).
//
// TPU-native replacement for the reference's audio-I/O dependency internals
// (libsndfile C decode + soxr C resampling, pinned at
// reference requirements.txt:54-55 and used via soundfile/librosa at
// final_optimized_transcriber.py:85-103): RIFF/WAVE parsing for every PCM
// flavour the pipeline meets (s16/s24/s32/f32/f64, any channel count /
// sample rate), stereo->mono downmix, and a polyphase Kaiser-windowed-sinc
// rational resampler to the 16 kHz mono float32 contract the mel front-end
// expects.
//
// Exposed as a plain C ABI consumed from Python via ctypes
// (whisper_aries_tpu_torch/audio/_native.py, which builds every source of
// this directory into one libariesaudio.so). Keep this file
// dependency-free.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <cstdlib>
#include <algorithm>
#include <vector>
#include <numeric>

namespace {

// ---------------------------------------------------------------------------
// Error codes shared with the Python wrapper.
// ---------------------------------------------------------------------------
enum AriesStatus : int32_t {
  ARIES_OK = 0,
  ARIES_ERR_BAD_RIFF = 1,
  ARIES_ERR_NO_FMT = 2,
  ARIES_ERR_NO_DATA = 3,
  ARIES_ERR_UNSUPPORTED_FORMAT = 4,
  ARIES_ERR_ALLOC = 5,
  ARIES_ERR_BAD_ARGS = 6,
};

inline uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
inline uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)((uint16_t)p[0] | ((uint16_t)p[1] << 8));
}

// Modified Bessel function of the first kind, order 0 (for Kaiser windows).
double bessel_i0(double x) {
  double sum = 1.0, term = 1.0;
  const double x2 = x * x * 0.25;
  for (int k = 1; k < 64; ++k) {
    term *= x2 / (double)(k * k);
    sum += term;
    if (term < 1e-18 * sum) break;
  }
  return sum;
}

}  // namespace

extern "C" {

// Free a buffer returned by any ariesaudio function.
void aries_free(void* p) { std::free(p); }

// ---------------------------------------------------------------------------
// WAV decode: bytes -> mono float32 in [-1, 1].
//
// On success fills *out (malloc'd, caller frees with aries_free), *out_len
// (samples per channel after downmix) and *sample_rate.
// ---------------------------------------------------------------------------
int32_t aries_decode_wav(const uint8_t* data, int64_t len, float** out,
                         int64_t* out_len, int32_t* sample_rate) {
  if (!data || len < 12 || !out || !out_len || !sample_rate)
    return ARIES_ERR_BAD_ARGS;
  if (std::memcmp(data, "RIFF", 4) != 0 || std::memcmp(data + 8, "WAVE", 4) != 0)
    return ARIES_ERR_BAD_RIFF;

  int64_t pos = 12;
  bool have_fmt = false;
  uint16_t fmt_tag = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  const uint8_t* pcm = nullptr;
  int64_t pcm_bytes = 0;

  while (pos + 8 <= len) {
    const uint8_t* hdr = data + pos;
    uint32_t chunk_size = rd_u32(hdr + 4);
    const uint8_t* body = hdr + 8;
    int64_t avail = len - (pos + 8);
    int64_t size = std::min<int64_t>((int64_t)chunk_size, avail);
    if (std::memcmp(hdr, "fmt ", 4) == 0 && size >= 16) {
      fmt_tag = rd_u16(body);
      channels = rd_u16(body + 2);
      rate = rd_u32(body + 4);
      bits = rd_u16(body + 14);
      if (fmt_tag == 0xFFFE && size >= 40) {  // WAVE_FORMAT_EXTENSIBLE
        fmt_tag = rd_u16(body + 24);          // sub-format GUID leading u16
      }
      have_fmt = true;
    } else if (std::memcmp(hdr, "data", 4) == 0) {
      pcm = body;
      pcm_bytes = size;
    }
    pos += 8 + (int64_t)chunk_size + ((int64_t)chunk_size & 1);  // word align
  }

  if (!have_fmt || channels == 0 || rate == 0) return ARIES_ERR_NO_FMT;
  if (!pcm || pcm_bytes <= 0) return ARIES_ERR_NO_DATA;

  const int64_t bytes_per_sample = bits / 8;
  if (bytes_per_sample == 0) return ARIES_ERR_UNSUPPORTED_FORMAT;
  const int64_t frames = pcm_bytes / (bytes_per_sample * channels);
  if (frames <= 0) return ARIES_ERR_NO_DATA;

  float* mono = (float*)std::malloc(sizeof(float) * (size_t)frames);
  if (!mono) return ARIES_ERR_ALLOC;

  const double inv_ch = 1.0 / (double)channels;
  if (fmt_tag == 1 && bits == 16) {
    for (int64_t i = 0; i < frames; ++i) {
      double acc = 0.0;
      const uint8_t* f = pcm + i * channels * 2;
      for (int c = 0; c < channels; ++c) {
        int16_t v = (int16_t)rd_u16(f + c * 2);
        acc += (double)v * (1.0 / 32768.0);
      }
      mono[i] = (float)(acc * inv_ch);
    }
  } else if (fmt_tag == 1 && bits == 24) {
    for (int64_t i = 0; i < frames; ++i) {
      double acc = 0.0;
      const uint8_t* f = pcm + i * channels * 3;
      for (int c = 0; c < channels; ++c) {
        const uint8_t* s = f + c * 3;
        int32_t v = (int32_t)((uint32_t)s[0] << 8 | (uint32_t)s[1] << 16 |
                              (uint32_t)s[2] << 24) >> 8;
        acc += (double)v * (1.0 / 8388608.0);
      }
      mono[i] = (float)(acc * inv_ch);
    }
  } else if (fmt_tag == 1 && bits == 32) {
    for (int64_t i = 0; i < frames; ++i) {
      double acc = 0.0;
      const uint8_t* f = pcm + i * channels * 4;
      for (int c = 0; c < channels; ++c) {
        int32_t v = (int32_t)rd_u32(f + c * 4);
        acc += (double)v * (1.0 / 2147483648.0);
      }
      mono[i] = (float)(acc * inv_ch);
    }
  } else if (fmt_tag == 3 && bits == 32) {  // IEEE float
    for (int64_t i = 0; i < frames; ++i) {
      double acc = 0.0;
      const uint8_t* f = pcm + i * channels * 4;
      for (int c = 0; c < channels; ++c) {
        float v;
        std::memcpy(&v, f + c * 4, 4);
        acc += (double)v;
      }
      mono[i] = (float)(acc * inv_ch);
    }
  } else if (fmt_tag == 3 && bits == 64) {  // IEEE double
    for (int64_t i = 0; i < frames; ++i) {
      double acc = 0.0;
      const uint8_t* f = pcm + i * channels * 8;
      for (int c = 0; c < channels; ++c) {
        double v;
        std::memcpy(&v, f + c * 8, 8);
        acc += v;
      }
      mono[i] = (float)(acc * inv_ch);
    }
  } else if (fmt_tag == 1 && bits == 8) {  // unsigned 8-bit PCM
    for (int64_t i = 0; i < frames; ++i) {
      double acc = 0.0;
      const uint8_t* f = pcm + i * channels;
      for (int c = 0; c < channels; ++c)
        acc += ((double)f[c] - 128.0) * (1.0 / 128.0);
      mono[i] = (float)(acc * inv_ch);
    }
  } else {
    std::free(mono);
    return ARIES_ERR_UNSUPPORTED_FORMAT;
  }

  *out = mono;
  *out_len = frames;
  *sample_rate = (int32_t)rate;
  return ARIES_OK;
}

// ---------------------------------------------------------------------------
// Polyphase rational resampler (Kaiser-windowed sinc), soxr-quality tier.
//
// Resamples in one pass: conceptual upsample by L, FIR low-pass at
// min(pi/L, pi/M), downsample by M, with the filter bank laid out per phase
// so each output sample is one `taps`-length dot product.
// ---------------------------------------------------------------------------
int32_t aries_resample(const float* in, int64_t n_in, int32_t sr_in,
                       int32_t sr_out, float** out, int64_t* n_out_p) {
  if (!in || n_in < 0 || sr_in <= 0 || sr_out <= 0 || !out || !n_out_p)
    return ARIES_ERR_BAD_ARGS;
  if (sr_in == sr_out) {
    float* copy = (float*)std::malloc(sizeof(float) * (size_t)std::max<int64_t>(n_in, 1));
    if (!copy) return ARIES_ERR_ALLOC;
    std::memcpy(copy, in, sizeof(float) * (size_t)n_in);
    *out = copy;
    *n_out_p = n_in;
    return ARIES_OK;
  }

  const int64_t g = std::gcd((int64_t)sr_in, (int64_t)sr_out);
  const int64_t L = sr_out / g;  // upsample factor
  const int64_t M = sr_in / g;   // downsample factor

  // Filter design: Kaiser beta ~ 12.98 -> ~130 dB stopband; 32 taps/phase.
  // The filter length is odd (L*taps + 1) so the group delay L*taps/2 lands
  // exactly on the upsampled grid — an even-length filter would introduce a
  // half-sample phase shift.
  const int64_t taps = 32;  // must stay even so L*taps/2 is integral
  const int64_t h_len = L * taps + 1;
  const double cutoff = 0.945 / (double)std::max(L, M);  // normalized (1=Nyquist of fs*L)
  const double beta = 12.984;
  const double i0_beta = bessel_i0(beta);
  const int64_t H = (h_len - 1) / 2;  // = L*taps/2, exact center

  // Pad per-phase banks to taps+1 entries (index p + k*L for k in [0, taps]).
  std::vector<float> h((size_t)(L * (taps + 1)), 0.0f);
  for (int64_t i = 0; i < h_len; ++i) {
    const double t = (double)(i - H);
    const double x = t * cutoff;
    const double sinc = (t == 0.0) ? 1.0 : std::sin(M_PI * x) / (M_PI * x);
    const double w_arg = 2.0 * (double)i / (double)(h_len - 1) - 1.0;
    const double kais = bessel_i0(beta * std::sqrt(std::max(0.0, 1.0 - w_arg * w_arg))) / i0_beta;
    h[(size_t)i] = (float)((double)L * cutoff * sinc * kais);
  }

  const int64_t n_out = (n_in * L + M - 1) / M;
  float* y = (float*)std::malloc(sizeof(float) * (size_t)std::max<int64_t>(n_out, 1));
  if (!y) return ARIES_ERR_ALLOC;

  // Center the group delay so y[n] aligns with x at time n*M/L.
  for (int64_t n = 0; n < n_out; ++n) {
    const int64_t u = n * M + H;       // position on the upsampled grid
    const int64_t p = u % L;           // polyphase index
    const int64_t m = u / L;           // newest input sample touched
    double acc = 0.0;
    // y[n] = sum_k h[p + k*L] * x[m - k]
    int64_t k_lo = std::max<int64_t>(0, m - (n_in - 1));
    int64_t k_hi = std::min<int64_t>(taps, m);
    const float* hp = h.data() + p;
    for (int64_t k = k_lo; k <= k_hi; ++k) acc += (double)hp[k * L] * (double)in[m - k];
    y[n] = (float)acc;
  }

  *out = y;
  *n_out_p = n_out;
  return ARIES_OK;
}

// Library version / availability probe.
int32_t aries_audio_abi_version(void) { return 1; }

}  // extern "C"
