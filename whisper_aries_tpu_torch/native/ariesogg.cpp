// ariesogg — native Ogg/Vorbis decode (and a test-only encoder) for
// whisper_aries_tpu_torch (the port's own copy of the JAX package's
// native/ariesogg.cpp), via the system libvorbisfile / libvorbis /
// libvorbisenc / libogg loaded with dlopen at runtime.
//
// Covers the reference's .ogg ingestion (utils.py:101 supported
// extensions, decoded there through libsndfile) with no ffmpeg binary and
// no build-time dependency. Opaque library structs (OggVorbis_File,
// ogg_stream_state, vorbis_dsp_state, ...) are caller-allocated per the
// vorbis API; we over-allocate fixed buffers well beyond their ABI sizes.
//
// C API:
//   aries_decode_ogg(data, len, &out, &out_len, &sample_rate) -> status
//     0 ok; -1 bad args, -2 libs unavailable, -3 decoder error. Mono
//     float32 (channel-averaged) out; free with aries_free.
//   aries_encode_ogg_vorbis(pcm, n, sr, quality, &out, &out_len)
//     test-vector encoder (mono float32 in, Ogg/Vorbis bytes out; free
//     with aries_free). Exercised only by the test suite.

#include <dlfcn.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// generous upper bounds on the libraries' struct sizes (ABI: OggVorbis_File
// ~944B, ogg_stream_state ~408B, vorbis_dsp_state/block ~200B each)
constexpr size_t BIGBUF = 8192;

struct MemSource {
  const uint8_t* data;
  int64_t len;
  int64_t pos;
};

extern "C" {
size_t mem_read(void* ptr, size_t size, size_t nmemb, void* src_) {
  MemSource* src = static_cast<MemSource*>(src_);
  int64_t want = static_cast<int64_t>(size) * static_cast<int64_t>(nmemb);
  int64_t avail = src->len - src->pos;
  int64_t take = want < avail ? want : avail;
  if (take <= 0) return 0;
  std::memcpy(ptr, src->data + src->pos, static_cast<size_t>(take));
  src->pos += take;
  return static_cast<size_t>(take) / size;
}

int mem_seek(void* src_, int64_t offset, int whence) {
  MemSource* src = static_cast<MemSource*>(src_);
  int64_t target = offset;
  if (whence == SEEK_CUR) target = src->pos + offset;
  if (whence == SEEK_END) target = src->len + offset;
  if (target < 0 || target > src->len) return -1;
  src->pos = target;
  return 0;
}

long mem_tell(void* src_) {
  return static_cast<long>(static_cast<MemSource*>(src_)->pos);
}
}  // extern "C" (callbacks)

struct OvCallbacks {  // layout mirror of ov_callbacks
  size_t (*read_func)(void*, size_t, size_t, void*);
  int (*seek_func)(void*, int64_t, int);
  int (*close_func)(void*);
  long (*tell_func)(void*);
};

struct OggPage {  // layout mirror of ogg_page
  unsigned char* header;
  long header_len;
  unsigned char* body;
  long body_len;
};

struct VorbisApi {
  void* vf = nullptr;   // libvorbisfile
  void* vb = nullptr;   // libvorbis
  void* ve = nullptr;   // libvorbisenc
  void* og = nullptr;   // libogg

  int (*ov_open_callbacks)(void*, void*, const char*, long, OvCallbacks) =
      nullptr;
  void* (*ov_info)(void*, int) = nullptr;
  long (*ov_read)(void*, char*, int, int, int, int, int*) = nullptr;
  int (*ov_clear)(void*) = nullptr;

  // encoder side
  void (*vorbis_info_init)(void*) = nullptr;
  int (*vorbis_encode_init_vbr)(void*, long, long, float) = nullptr;
  void (*vorbis_comment_init)(void*) = nullptr;
  int (*vorbis_analysis_init)(void*, void*) = nullptr;
  int (*vorbis_block_init)(void*, void*) = nullptr;
  int (*vorbis_analysis_headerout)(void*, void*, void*, void*, void*) =
      nullptr;
  float** (*vorbis_analysis_buffer)(void*, int) = nullptr;
  int (*vorbis_analysis_wrote)(void*, int) = nullptr;
  int (*vorbis_analysis_blockout)(void*, void*) = nullptr;
  int (*vorbis_analysis)(void*, void*) = nullptr;
  int (*vorbis_bitrate_addblock)(void*) = nullptr;
  int (*vorbis_bitrate_flushpacket)(void*, void*) = nullptr;
  void (*vorbis_info_clear)(void*) = nullptr;
  void (*vorbis_comment_clear)(void*) = nullptr;
  int (*vorbis_block_clear)(void*) = nullptr;
  void (*vorbis_dsp_clear)(void*) = nullptr;

  int (*ogg_stream_init)(void*, int) = nullptr;
  int (*ogg_stream_packetin)(void*, void*) = nullptr;
  int (*ogg_stream_flush)(void*, OggPage*) = nullptr;
  int (*ogg_stream_pageout)(void*, OggPage*) = nullptr;
  int (*ogg_stream_clear)(void*) = nullptr;

  bool decode_ok() const {
    return vf && ov_open_callbacks && ov_info && ov_read && ov_clear;
  }
  bool encode_ok() const {
    return vb && ve && og && vorbis_info_init && vorbis_encode_init_vbr &&
           vorbis_comment_init && vorbis_analysis_init && vorbis_block_init &&
           vorbis_analysis_headerout && vorbis_analysis_buffer &&
           vorbis_analysis_wrote && vorbis_analysis_blockout &&
           vorbis_analysis && vorbis_bitrate_addblock &&
           vorbis_bitrate_flushpacket && ogg_stream_init &&
           ogg_stream_packetin && ogg_stream_flush && ogg_stream_pageout;
  }
};

const VorbisApi& api() {
  static VorbisApi a = [] {
    VorbisApi r;
    r.vf = dlopen("libvorbisfile.so.3", RTLD_NOW | RTLD_GLOBAL);
    if (!r.vf) r.vf = dlopen("libvorbisfile.so", RTLD_NOW | RTLD_GLOBAL);
    r.vb = dlopen("libvorbis.so.0", RTLD_NOW | RTLD_GLOBAL);
    r.ve = dlopen("libvorbisenc.so.2", RTLD_NOW | RTLD_GLOBAL);
    r.og = dlopen("libogg.so.0", RTLD_NOW | RTLD_GLOBAL);
    if (r.vf) {
      r.ov_open_callbacks = reinterpret_cast<int (*)(
          void*, void*, const char*, long, OvCallbacks)>(
          dlsym(r.vf, "ov_open_callbacks"));
      r.ov_info = reinterpret_cast<void* (*)(void*, int)>(
          dlsym(r.vf, "ov_info"));
      r.ov_read = reinterpret_cast<long (*)(void*, char*, int, int, int, int,
                                            int*)>(dlsym(r.vf, "ov_read"));
      r.ov_clear = reinterpret_cast<int (*)(void*)>(dlsym(r.vf, "ov_clear"));
    }
    auto vbs = [&](const char* s) { return r.vb ? dlsym(r.vb, s) : nullptr; };
    auto ogs = [&](const char* s) { return r.og ? dlsym(r.og, s) : nullptr; };
    r.vorbis_info_init =
        reinterpret_cast<void (*)(void*)>(vbs("vorbis_info_init"));
    r.vorbis_encode_init_vbr = reinterpret_cast<int (*)(void*, long, long,
                                                        float)>(
        r.ve ? dlsym(r.ve, "vorbis_encode_init_vbr") : nullptr);
    r.vorbis_comment_init =
        reinterpret_cast<void (*)(void*)>(vbs("vorbis_comment_init"));
    r.vorbis_analysis_init =
        reinterpret_cast<int (*)(void*, void*)>(vbs("vorbis_analysis_init"));
    r.vorbis_block_init =
        reinterpret_cast<int (*)(void*, void*)>(vbs("vorbis_block_init"));
    r.vorbis_analysis_headerout =
        reinterpret_cast<int (*)(void*, void*, void*, void*, void*)>(
            vbs("vorbis_analysis_headerout"));
    r.vorbis_analysis_buffer = reinterpret_cast<float** (*)(void*, int)>(
        vbs("vorbis_analysis_buffer"));
    r.vorbis_analysis_wrote =
        reinterpret_cast<int (*)(void*, int)>(vbs("vorbis_analysis_wrote"));
    r.vorbis_analysis_blockout = reinterpret_cast<int (*)(void*, void*)>(
        vbs("vorbis_analysis_blockout"));
    r.vorbis_analysis =
        reinterpret_cast<int (*)(void*, void*)>(vbs("vorbis_analysis"));
    r.vorbis_bitrate_addblock =
        reinterpret_cast<int (*)(void*)>(vbs("vorbis_bitrate_addblock"));
    r.vorbis_bitrate_flushpacket = reinterpret_cast<int (*)(void*, void*)>(
        vbs("vorbis_bitrate_flushpacket"));
    r.vorbis_info_clear =
        reinterpret_cast<void (*)(void*)>(vbs("vorbis_info_clear"));
    r.vorbis_comment_clear =
        reinterpret_cast<void (*)(void*)>(vbs("vorbis_comment_clear"));
    r.vorbis_block_clear =
        reinterpret_cast<int (*)(void*)>(vbs("vorbis_block_clear"));
    r.vorbis_dsp_clear =
        reinterpret_cast<void (*)(void*)>(vbs("vorbis_dsp_clear"));
    r.ogg_stream_init =
        reinterpret_cast<int (*)(void*, int)>(ogs("ogg_stream_init"));
    r.ogg_stream_packetin =
        reinterpret_cast<int (*)(void*, void*)>(ogs("ogg_stream_packetin"));
    r.ogg_stream_flush =
        reinterpret_cast<int (*)(void*, OggPage*)>(ogs("ogg_stream_flush"));
    r.ogg_stream_pageout =
        reinterpret_cast<int (*)(void*, OggPage*)>(ogs("ogg_stream_pageout"));
    r.ogg_stream_clear =
        reinterpret_cast<int (*)(void*)>(ogs("ogg_stream_clear"));
    return r;
  }();
  return a;
}

struct VorbisInfoHead {  // leading fields of vorbis_info (stable ABI)
  int version;
  int channels;
  long rate;
};

}  // namespace

extern "C" {

int32_t aries_ogg_available() { return api().decode_ok() ? 1 : 0; }

int32_t aries_decode_ogg(const uint8_t* data, int64_t len, float** out,
                         int64_t* out_len, int32_t* sample_rate) {
  if (!data || len <= 0 || !out || !out_len || !sample_rate) return -1;
  const VorbisApi& v = api();
  if (!v.decode_ok()) return -2;

  MemSource src{data, len, 0};
  std::vector<uint8_t> vfbuf(BIGBUF, 0);
  OvCallbacks cb{mem_read, mem_seek, nullptr, mem_tell};
  if (v.ov_open_callbacks(&src, vfbuf.data(), nullptr, 0, cb) < 0) return -3;

  VorbisInfoHead* info =
      static_cast<VorbisInfoHead*>(v.ov_info(vfbuf.data(), -1));
  if (!info || info->channels <= 0 || info->rate <= 0) {
    v.ov_clear(vfbuf.data());
    return -3;
  }
  const int channels = info->channels;
  const long rate = info->rate;

  constexpr long OV_HOLE_RC = -3;  // libvorbis OV_HOLE: recoverable gap
  std::vector<int16_t> pcm;
  std::vector<char> buf(65536);
  int bitstream = 0;
  for (;;) {
    long n = v.ov_read(vfbuf.data(), buf.data(),
                       static_cast<int>(buf.size()), 0, 2, 1, &bitstream);
    if (n == 0) break;             // EOF
    if (n == OV_HOLE_RC) continue;  // skip the gap, keep decoding
    if (n < 0) break;  // persistent error (OV_EBADLINK/OV_EINVAL do not
                       // advance the stream — continuing would spin forever);
                       // keep whatever decoded cleanly before it
    const int16_t* s = reinterpret_cast<const int16_t*>(buf.data());
    pcm.insert(pcm.end(), s, s + n / 2);
  }
  v.ov_clear(vfbuf.data());
  if (pcm.empty()) return -3;

  const int64_t frames = static_cast<int64_t>(pcm.size()) / channels;
  float* mono = static_cast<float*>(std::malloc(sizeof(float) * frames));
  if (!mono) return -3;
  const float norm = 1.0f / 32768.0f / static_cast<float>(channels);
  for (int64_t i = 0; i < frames; ++i) {
    int32_t acc = 0;
    for (int c = 0; c < channels; ++c) acc += pcm[i * channels + c];
    mono[i] = static_cast<float>(acc) * norm;
  }
  *out = mono;
  *out_len = frames;
  *sample_rate = static_cast<int32_t>(rate);
  return 0;
}

// --- test-vector encoder ----------------------------------------------------

int32_t aries_encode_ogg_vorbis(const float* pcm, int64_t n, int32_t sr,
                                float quality, uint8_t** out,
                                int64_t* out_len) {
  if (!pcm || n <= 0 || !out || !out_len) return -1;
  const VorbisApi& v = api();
  if (!v.encode_ok()) return -2;

  std::vector<uint8_t> vi(1024, 0), vc(1024, 0), vd(BIGBUF, 0), vb(BIGBUF, 0);
  std::vector<uint8_t> os(BIGBUF, 0);
  std::vector<uint8_t> op(256, 0), h1(256, 0), h2(256, 0), h3(256, 0);
  std::vector<uint8_t> bytes;
  OggPage page;

  auto emit_pages = [&](bool flush) {
    for (;;) {
      int got = flush ? v.ogg_stream_flush(os.data(), &page)
                      : v.ogg_stream_pageout(os.data(), &page);
      if (got == 0) break;
      bytes.insert(bytes.end(), page.header, page.header + page.header_len);
      bytes.insert(bytes.end(), page.body, page.body + page.body_len);
    }
  };

  v.vorbis_info_init(vi.data());
  if (v.vorbis_encode_init_vbr(vi.data(), 1, sr, quality) != 0) {
    v.vorbis_info_clear(vi.data());
    return -3;
  }
  v.vorbis_comment_init(vc.data());
  v.vorbis_analysis_init(vd.data(), vi.data());
  v.vorbis_block_init(vd.data(), vb.data());
  v.ogg_stream_init(os.data(), 1);

  v.vorbis_analysis_headerout(vd.data(), vc.data(), h1.data(), h2.data(),
                              h3.data());
  v.ogg_stream_packetin(os.data(), h1.data());
  v.ogg_stream_packetin(os.data(), h2.data());
  v.ogg_stream_packetin(os.data(), h3.data());
  emit_pages(true);  // headers must end on their own page

  const int CHUNK = 4096;
  int64_t done = 0;
  bool ended = false;
  while (!ended) {
    if (done < n) {
      int take = static_cast<int>(n - done < CHUNK ? n - done : CHUNK);
      float** bufp = v.vorbis_analysis_buffer(vd.data(), take);
      std::memcpy(bufp[0], pcm + done, sizeof(float) * take);
      v.vorbis_analysis_wrote(vd.data(), take);
      done += take;
    } else {
      v.vorbis_analysis_wrote(vd.data(), 0);  // end of stream
      ended = true;
    }
    while (v.vorbis_analysis_blockout(vd.data(), vb.data()) == 1) {
      v.vorbis_analysis(vb.data(), nullptr);
      v.vorbis_bitrate_addblock(vb.data());
      while (v.vorbis_bitrate_flushpacket(vd.data(), op.data()) == 1) {
        v.ogg_stream_packetin(os.data(), op.data());
        emit_pages(false);
      }
    }
  }
  emit_pages(true);

  if (v.ogg_stream_clear) v.ogg_stream_clear(os.data());
  if (v.vorbis_block_clear) v.vorbis_block_clear(vb.data());
  if (v.vorbis_dsp_clear) v.vorbis_dsp_clear(vd.data());
  if (v.vorbis_comment_clear) v.vorbis_comment_clear(vc.data());
  v.vorbis_info_clear(vi.data());

  if (bytes.empty()) return -3;
  uint8_t* mem = static_cast<uint8_t*>(std::malloc(bytes.size()));
  if (!mem) return -3;
  std::memcpy(mem, bytes.data(), bytes.size());
  *out = mem;
  *out_len = static_cast<int64_t>(bytes.size());
  return 0;
}

}  // extern "C"
