// ariesmp3 — native MP3 (MPEG-1/2/2.5 layer I-III) decode for
// whisper_aries_tpu_torch (the port's own copy of the JAX package's
// native/ariesmp3.cpp), via the system libmpg123 loaded with dlopen at
// runtime (no build-time header/link dependency).
//
// Replaces the reference's mp3 ingestion, which routed through
// libsndfile/librosa's system decoders (reference utils.py:96-130,
// final_optimized_transcriber.py:85-112) — same architecture: a thin
// native shim over the battle-tested system codec, so .mp3 works with no
// ffmpeg binary on PATH.
//
// C API (mirrors aries_decode_flac in ariesflac.cpp):
//   aries_decode_mp3(data, len, &out, &out_len, &sample_rate) -> status
//     0 ok; negative = error (-1 bad args, -2 libmpg123 unavailable,
//     -3 decoder error). Output is mono float32 (channel-averaged),
//     caller frees with aries_free (ariesaudio.cpp).
//
// The feed API is used end to end: the whole byte buffer is fed, frames
// are drained with mpg123_read until NEED_MORE/DONE. The output format is
// pinned to signed 16-bit at every MPEG rate so the sample layout is
// unambiguous across libmpg123 builds.

#include <dlfcn.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// libmpg123 ABI constants (mpg123.h, stable across the 1.x series)
constexpr int MPG123_OK = 0;
constexpr int MPG123_NEED_MORE = -10;
constexpr int MPG123_NEW_FORMAT = -11;
constexpr int MPG123_DONE = -12;
constexpr int MPG123_MONO = 1;
constexpr int MPG123_STEREO = 2;
constexpr int MPG123_ENC_SIGNED_16 = 0xD0;  // ENC_16|ENC_SIGNED|0x10

struct Mpg123Api {
  void* lib = nullptr;
  int (*init)() = nullptr;
  void* (*new_)(const char*, int*) = nullptr;
  void (*delete_)(void*) = nullptr;
  int (*open_feed)(void*) = nullptr;
  int (*feed)(void*, const unsigned char*, size_t) = nullptr;
  int (*read)(void*, unsigned char*, size_t, size_t*) = nullptr;
  int (*getformat)(void*, long*, int*, int*) = nullptr;
  int (*format_none)(void*) = nullptr;
  int (*format)(void*, long, int, int) = nullptr;
  int (*close)(void*) = nullptr;

  bool ok() const {
    return lib && init && new_ && delete_ && open_feed && feed && read &&
           getformat && format_none && format;
  }
};

const Mpg123Api& api() {
  static Mpg123Api a = [] {
    Mpg123Api r;
    for (const char* name :
         {"libmpg123.so.0", "libmpg123.so", "libmpg123.0.dylib"}) {
      r.lib = dlopen(name, RTLD_NOW | RTLD_LOCAL);
      if (r.lib) break;
    }
    if (!r.lib) return r;
    auto sym = [&](const char* s) { return dlsym(r.lib, s); };
    r.init = reinterpret_cast<int (*)()>(sym("mpg123_init"));
    r.new_ = reinterpret_cast<void* (*)(const char*, int*)>(sym("mpg123_new"));
    r.delete_ = reinterpret_cast<void (*)(void*)>(sym("mpg123_delete"));
    r.open_feed = reinterpret_cast<int (*)(void*)>(sym("mpg123_open_feed"));
    r.feed = reinterpret_cast<int (*)(void*, const unsigned char*, size_t)>(
        sym("mpg123_feed"));
    r.read = reinterpret_cast<int (*)(void*, unsigned char*, size_t, size_t*)>(
        sym("mpg123_read"));
    r.getformat = reinterpret_cast<int (*)(void*, long*, int*, int*)>(
        sym("mpg123_getformat"));
    r.format_none = reinterpret_cast<int (*)(void*)>(sym("mpg123_format_none"));
    r.format = reinterpret_cast<int (*)(void*, long, int, int)>(
        sym("mpg123_format"));
    r.close = reinterpret_cast<int (*)(void*)>(sym("mpg123_close"));
    if (r.init) r.init();
    return r;
  }();
  return a;
}

constexpr long kRates[] = {8000,  11025, 12000, 16000, 22050,
                           24000, 32000, 44100, 48000};

}  // namespace

extern "C" {

int32_t aries_mp3_available() { return api().ok() ? 1 : 0; }

int32_t aries_decode_mp3(const uint8_t* data, int64_t len, float** out,
                         int64_t* out_len, int32_t* sample_rate) {
  if (!data || len <= 0 || !out || !out_len || !sample_rate) return -1;
  const Mpg123Api& m = api();
  if (!m.ok()) return -2;

  int err = 0;
  void* h = m.new_(nullptr, &err);
  if (!h) return -3;
  // pin output to s16 at any MPEG rate, mono or stereo
  m.format_none(h);
  for (long r : kRates) m.format(h, r, MPG123_MONO | MPG123_STEREO,
                                 MPG123_ENC_SIGNED_16);
  if (m.open_feed(h) != MPG123_OK) {
    m.delete_(h);
    return -3;
  }
  if (m.feed(h, data, static_cast<size_t>(len)) != MPG123_OK) {
    if (m.close) m.close(h);
    m.delete_(h);
    return -3;
  }

  long rate = 0;
  int channels = 0, enc = 0;
  // mixed down to mono INCREMENTALLY with the channel count in force when
  // each chunk was decoded — a mid-stream mono<->stereo switch (stitched
  // files) must not de-interleave earlier frames with the later layout
  std::vector<float> mono_acc;
  std::vector<unsigned char> buf(65536);
  bool have_format = false;

  auto mixdown = [&](size_t bytes) {
    if (!bytes || channels <= 0) return;
    const int16_t* s = reinterpret_cast<const int16_t*>(buf.data());
    const size_t frames = bytes / 2 / static_cast<size_t>(channels);
    const float norm = 1.0f / 32768.0f / static_cast<float>(channels);
    for (size_t i = 0; i < frames; ++i) {
      int32_t acc = 0;
      for (int c = 0; c < channels; ++c) acc += s[i * channels + c];
      mono_acc.push_back(static_cast<float>(acc) * norm);
    }
  };

  for (;;) {
    size_t done = 0;
    int rc = m.read(h, buf.data(), buf.size(), &done);
    mixdown(done);
    if (rc == MPG123_NEW_FORMAT) {
      long new_rate = 0;
      int new_ch = 0;
      m.getformat(h, &new_rate, &new_ch, &enc);
      if (have_format && new_rate != rate) break;  // keep the first-rate part
      rate = new_rate;
      channels = new_ch;
      have_format = true;
      continue;
    }
    if (rc == MPG123_OK) continue;
    if (rc == MPG123_NEED_MORE || rc == MPG123_DONE) break;  // drained
    // decoder error
    if (m.close) m.close(h);
    m.delete_(h);
    return -3;
  }
  if (m.close) m.close(h);
  m.delete_(h);
  if (!have_format || channels <= 0 || rate <= 0 || mono_acc.empty())
    return -3;

  const int64_t frames = static_cast<int64_t>(mono_acc.size());
  float* mono = static_cast<float*>(std::malloc(sizeof(float) * frames));
  if (!mono) return -3;
  std::memcpy(mono, mono_acc.data(), sizeof(float) * frames);
  *out = mono;
  *out_len = frames;
  *sample_rate = static_cast<int32_t>(rate);
  return 0;
}

}  // extern "C"
