// ariesav — native decode of every remaining container/codec the reference
// supports (m4a/aac, wma, and audio tracks of mp4/mkv/webm/avi/mov video)
// via the system libavformat/libavcodec, loaded with dlopen at runtime
// (the port's own copy of the JAX package's native/ariesav.cpp;
// whisper_aries_tpu_torch/audio/_native.py compiles it in only where
// <libavformat/avformat.h> preprocesses).
//
// The reference ingests these through the ffmpeg *binary* subprocess
// (reference utils.py:96-130) or librosa/audioread (reference
// final_optimized_transcriber.py:105-112). This shim removes the binary
// dependency the same way ariesmp3/ariesogg did for mp3/ogg: a thin native
// layer over the battle-tested system codec libraries, so ingestion works
// in ffmpeg-less deployments. Headers are used for struct layouts only;
// symbols are resolved with dlopen/dlsym so libariesaudio.so loads (and the
// WAV/FLAC paths keep working) on hosts without the ffmpeg libraries.
//
// C API (same conventions as aries_decode_mp3 / aries_decode_ogg):
//   aries_av_available() -> 1 when libavformat+libavcodec+libavutil resolve
//   aries_decode_av(data, len, &out, &out_len, &sample_rate) -> status
//     0 ok; -1 bad args, -2 libraries unavailable, -3 demux/decode error.
//     Decodes the best audio stream to mono float32 (channel-averaged) at
//     the stream's native rate; caller frees with aries_free.
//   aries_encode_m4a(audio, n, rate, &out, &out_len) -> status
//     test-vector encoder: mono float32 -> in-memory .m4a (mp4 container,
//     native AAC encoder); used by the closed-loop ingestion tests only.

#include <dlfcn.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/channel_layout.h>
#include <libavutil/frame.h>
#include <libavutil/mem.h>
#include <libavutil/samplefmt.h>
}

namespace {

struct AvApi {
  void* fmt = nullptr;  // libavformat
  void* cod = nullptr;  // libavcodec
  void* utl = nullptr;  // libavutil

  // avformat
  AVFormatContext* (*alloc_ctx)() = nullptr;
  int (*open_input)(AVFormatContext**, const char*, const AVInputFormat*,
                    AVDictionary**) = nullptr;
  void (*close_input)(AVFormatContext**) = nullptr;
  int (*find_stream_info)(AVFormatContext*, AVDictionary**) = nullptr;
  int (*read_frame)(AVFormatContext*, AVPacket*) = nullptr;
  int (*find_best_stream)(AVFormatContext*, enum AVMediaType, int, int,
                          const AVCodec**, int) = nullptr;
  AVIOContext* (*avio_alloc)(unsigned char*, int, int, void*,
                             int (*)(void*, uint8_t*, int),
                             int (*)(void*, uint8_t*, int),
                             int64_t (*)(void*, int64_t, int)) = nullptr;
  void (*avio_ctx_free)(AVIOContext**) = nullptr;
  // mux side (test encoder)
  int (*alloc_output_ctx)(AVFormatContext**, const AVOutputFormat*,
                          const char*, const char*) = nullptr;
  AVStream* (*new_stream)(AVFormatContext*, const AVCodec*) = nullptr;
  int (*write_header)(AVFormatContext*, AVDictionary**) = nullptr;
  int (*write_frame_i)(AVFormatContext*, AVPacket*) = nullptr;
  int (*write_trailer)(AVFormatContext*) = nullptr;
  void (*free_ctx)(AVFormatContext*) = nullptr;
  int (*open_dyn_buf)(AVIOContext**) = nullptr;
  int (*close_dyn_buf)(AVIOContext*, uint8_t**) = nullptr;

  // avcodec
  const AVCodec* (*find_decoder)(enum AVCodecID) = nullptr;
  const AVCodec* (*find_encoder)(enum AVCodecID) = nullptr;
  AVCodecContext* (*alloc_codec_ctx)(const AVCodec*) = nullptr;
  void (*free_codec_ctx)(AVCodecContext**) = nullptr;
  int (*params_to_ctx)(AVCodecContext*, const AVCodecParameters*) = nullptr;
  int (*params_from_ctx)(AVCodecParameters*, const AVCodecContext*) = nullptr;
  int (*codec_open2)(AVCodecContext*, const AVCodec*,
                     AVDictionary**) = nullptr;
  int (*send_packet)(AVCodecContext*, const AVPacket*) = nullptr;
  int (*receive_frame)(AVCodecContext*, AVFrame*) = nullptr;
  int (*send_frame)(AVCodecContext*, const AVFrame*) = nullptr;
  int (*receive_packet)(AVCodecContext*, AVPacket*) = nullptr;
  AVPacket* (*packet_alloc)() = nullptr;
  void (*packet_free)(AVPacket**) = nullptr;
  void (*packet_unref)(AVPacket*) = nullptr;
  void (*packet_rescale_ts)(AVPacket*, AVRational, AVRational) = nullptr;

  // avutil
  AVFrame* (*frame_alloc)() = nullptr;
  void (*frame_free)(AVFrame**) = nullptr;
  void (*frame_unref)(AVFrame*) = nullptr;
  int (*frame_get_buffer)(AVFrame*, int) = nullptr;
  void* (*malloc_)(size_t) = nullptr;
  void (*free_)(void*) = nullptr;
  int (*bytes_per_sample)(enum AVSampleFormat) = nullptr;
  void (*ch_layout_default)(AVChannelLayout*, int) = nullptr;
  void (*log_set_level)(int) = nullptr;

  bool ok_decode() const {
    return fmt && cod && utl && alloc_ctx && open_input && close_input &&
           find_stream_info && read_frame && find_best_stream && avio_alloc &&
           avio_ctx_free && find_decoder && alloc_codec_ctx &&
           free_codec_ctx && params_to_ctx && codec_open2 && send_packet &&
           receive_frame && packet_alloc && packet_free && packet_unref &&
           frame_alloc && frame_free && frame_unref && malloc_ && free_ &&
           bytes_per_sample;
  }
  bool ok_encode() const {
    return ok_decode() && alloc_output_ctx && new_stream && write_header &&
           write_frame_i && write_trailer && free_ctx && open_dyn_buf &&
           close_dyn_buf && find_encoder && params_from_ctx && send_frame &&
           receive_packet && packet_rescale_ts && frame_get_buffer &&
           ch_layout_default;
  }
};

void* dl_first(std::initializer_list<const char*> names) {
  for (const char* n : names) {
    if (void* h = dlopen(n, RTLD_NOW | RTLD_LOCAL)) return h;
  }
  return nullptr;
}

const AvApi& api() {
  static AvApi a = [] {
    AvApi r;
    // avutil first (the others depend on it)
    r.utl = dl_first({"libavutil.so.57", "libavutil.so.58", "libavutil.so"});
    r.cod =
        dl_first({"libavcodec.so.59", "libavcodec.so.60", "libavcodec.so"});
    r.fmt = dl_first(
        {"libavformat.so.59", "libavformat.so.60", "libavformat.so"});
    if (!r.utl || !r.cod || !r.fmt) return r;

    auto F = [&](const char* s) { return dlsym(r.fmt, s); };
    auto C = [&](const char* s) { return dlsym(r.cod, s); };
    auto U = [&](const char* s) { return dlsym(r.utl, s); };

    r.alloc_ctx =
        reinterpret_cast<decltype(r.alloc_ctx)>(F("avformat_alloc_context"));
    r.open_input =
        reinterpret_cast<decltype(r.open_input)>(F("avformat_open_input"));
    r.close_input =
        reinterpret_cast<decltype(r.close_input)>(F("avformat_close_input"));
    r.find_stream_info = reinterpret_cast<decltype(r.find_stream_info)>(
        F("avformat_find_stream_info"));
    r.read_frame =
        reinterpret_cast<decltype(r.read_frame)>(F("av_read_frame"));
    r.find_best_stream = reinterpret_cast<decltype(r.find_best_stream)>(
        F("av_find_best_stream"));
    r.avio_alloc =
        reinterpret_cast<decltype(r.avio_alloc)>(F("avio_alloc_context"));
    r.avio_ctx_free =
        reinterpret_cast<decltype(r.avio_ctx_free)>(F("avio_context_free"));
    r.alloc_output_ctx = reinterpret_cast<decltype(r.alloc_output_ctx)>(
        F("avformat_alloc_output_context2"));
    r.new_stream =
        reinterpret_cast<decltype(r.new_stream)>(F("avformat_new_stream"));
    r.write_header =
        reinterpret_cast<decltype(r.write_header)>(F("avformat_write_header"));
    r.write_frame_i = reinterpret_cast<decltype(r.write_frame_i)>(
        F("av_interleaved_write_frame"));
    r.write_trailer =
        reinterpret_cast<decltype(r.write_trailer)>(F("av_write_trailer"));
    r.free_ctx =
        reinterpret_cast<decltype(r.free_ctx)>(F("avformat_free_context"));
    r.open_dyn_buf =
        reinterpret_cast<decltype(r.open_dyn_buf)>(F("avio_open_dyn_buf"));
    r.close_dyn_buf =
        reinterpret_cast<decltype(r.close_dyn_buf)>(F("avio_close_dyn_buf"));

    r.find_decoder =
        reinterpret_cast<decltype(r.find_decoder)>(C("avcodec_find_decoder"));
    r.find_encoder =
        reinterpret_cast<decltype(r.find_encoder)>(C("avcodec_find_encoder"));
    r.alloc_codec_ctx = reinterpret_cast<decltype(r.alloc_codec_ctx)>(
        C("avcodec_alloc_context3"));
    r.free_codec_ctx = reinterpret_cast<decltype(r.free_codec_ctx)>(
        C("avcodec_free_context"));
    r.params_to_ctx = reinterpret_cast<decltype(r.params_to_ctx)>(
        C("avcodec_parameters_to_context"));
    r.params_from_ctx = reinterpret_cast<decltype(r.params_from_ctx)>(
        C("avcodec_parameters_from_context"));
    r.codec_open2 =
        reinterpret_cast<decltype(r.codec_open2)>(C("avcodec_open2"));
    r.send_packet =
        reinterpret_cast<decltype(r.send_packet)>(C("avcodec_send_packet"));
    r.receive_frame = reinterpret_cast<decltype(r.receive_frame)>(
        C("avcodec_receive_frame"));
    r.send_frame =
        reinterpret_cast<decltype(r.send_frame)>(C("avcodec_send_frame"));
    r.receive_packet = reinterpret_cast<decltype(r.receive_packet)>(
        C("avcodec_receive_packet"));
    r.packet_alloc =
        reinterpret_cast<decltype(r.packet_alloc)>(C("av_packet_alloc"));
    r.packet_free =
        reinterpret_cast<decltype(r.packet_free)>(C("av_packet_free"));
    r.packet_unref =
        reinterpret_cast<decltype(r.packet_unref)>(C("av_packet_unref"));
    r.packet_rescale_ts = reinterpret_cast<decltype(r.packet_rescale_ts)>(
        C("av_packet_rescale_ts"));

    r.frame_alloc =
        reinterpret_cast<decltype(r.frame_alloc)>(U("av_frame_alloc"));
    r.frame_free =
        reinterpret_cast<decltype(r.frame_free)>(U("av_frame_free"));
    r.frame_unref =
        reinterpret_cast<decltype(r.frame_unref)>(U("av_frame_unref"));
    r.frame_get_buffer = reinterpret_cast<decltype(r.frame_get_buffer)>(
        U("av_frame_get_buffer"));
    r.malloc_ = reinterpret_cast<decltype(r.malloc_)>(U("av_malloc"));
    r.free_ = reinterpret_cast<decltype(r.free_)>(U("av_free"));
    r.bytes_per_sample = reinterpret_cast<decltype(r.bytes_per_sample)>(
        U("av_get_bytes_per_sample"));
    r.ch_layout_default = reinterpret_cast<decltype(r.ch_layout_default)>(
        U("av_channel_layout_default"));
    r.log_set_level =
        reinterpret_cast<decltype(r.log_set_level)>(U("av_log_set_level"));
    if (r.log_set_level) r.log_set_level(AV_LOG_ERROR);
    return r;
  }();
  return a;
}

// ---- in-memory read/seek callbacks for the demuxer --------------------------

struct MemReader {
  const uint8_t* data;
  int64_t len;
  int64_t pos;
};

int mem_read(void* opaque, uint8_t* buf, int buf_size) {
  MemReader* m = static_cast<MemReader*>(opaque);
  int64_t left = m->len - m->pos;
  if (left <= 0) return AVERROR_EOF;
  int n = static_cast<int>(left < buf_size ? left : buf_size);
  std::memcpy(buf, m->data + m->pos, static_cast<size_t>(n));
  m->pos += n;
  return n;
}

int64_t mem_seek(void* opaque, int64_t offset, int whence) {
  MemReader* m = static_cast<MemReader*>(opaque);
  if (whence & AVSEEK_SIZE) return m->len;
  whence &= ~AVSEEK_FORCE;
  int64_t base = whence == SEEK_SET ? 0 : whence == SEEK_CUR ? m->pos : m->len;
  int64_t np = base + offset;
  if (np < 0 || np > m->len) return AVERROR(EINVAL);
  m->pos = np;
  return np;
}

// Append one decoded frame to the mono accumulator, converting from any
// common sample format (planar or interleaved).
bool accumulate_mono(const AvApi& m, const AVFrame* f,
                     std::vector<float>& acc) {
  const int ch = f->ch_layout.nb_channels;
  const int n = f->nb_samples;
  if (ch <= 0 || n <= 0) return false;
  const auto fmt = static_cast<AVSampleFormat>(f->format);
  const int bps = m.bytes_per_sample(fmt);
  if (bps <= 0) return false;
  const float inv_ch = 1.0f / static_cast<float>(ch);
  // Planarity comes from the sample format itself, and planes are read via
  // extended_data: AVFrame::data has only AV_NUM_DATA_POINTERS (8) slots,
  // so a planar frame with >8 channels (multichannel Opus/PCM in an
  // uploaded mkv/webm) only has valid plane pointers in extended_data —
  // indexing data[c] there reads past the array.
  const bool planar_fmt =
      fmt == AV_SAMPLE_FMT_FLTP || fmt == AV_SAMPLE_FMT_DBLP ||
      fmt == AV_SAMPLE_FMT_S16P || fmt == AV_SAMPLE_FMT_S32P ||
      fmt == AV_SAMPLE_FMT_U8P;
  if (f->extended_data == nullptr) return false;

  auto sample = [&](int c, int i) -> float {
    const uint8_t* base;
    size_t off;
    if (planar_fmt) {  // one plane per channel
      base = f->extended_data[c];
      off = static_cast<size_t>(i) * bps;
    } else {  // interleaved in plane 0
      base = f->extended_data[0];
      off = (static_cast<size_t>(i) * ch + c) * bps;
    }
    if (base == nullptr) return 0.0f;
    switch (fmt) {
      case AV_SAMPLE_FMT_FLT:
      case AV_SAMPLE_FMT_FLTP: {
        float v;
        std::memcpy(&v, base + off, 4);
        return v;
      }
      case AV_SAMPLE_FMT_DBL:
      case AV_SAMPLE_FMT_DBLP: {
        double v;
        std::memcpy(&v, base + off, 8);
        return static_cast<float>(v);
      }
      case AV_SAMPLE_FMT_S16:
      case AV_SAMPLE_FMT_S16P: {
        int16_t v;
        std::memcpy(&v, base + off, 2);
        return static_cast<float>(v) / 32768.0f;
      }
      case AV_SAMPLE_FMT_S32:
      case AV_SAMPLE_FMT_S32P: {
        int32_t v;
        std::memcpy(&v, base + off, 4);
        return static_cast<float>(v) / 2147483648.0f;
      }
      case AV_SAMPLE_FMT_U8:
      case AV_SAMPLE_FMT_U8P:
        return (static_cast<float>(base[off]) - 128.0f) / 128.0f;
      default:
        return 0.0f;
    }
  };

  // reject unknown formats up front (sample() would return silence)
  switch (fmt) {
    case AV_SAMPLE_FMT_FLT: case AV_SAMPLE_FMT_FLTP:
    case AV_SAMPLE_FMT_DBL: case AV_SAMPLE_FMT_DBLP:
    case AV_SAMPLE_FMT_S16: case AV_SAMPLE_FMT_S16P:
    case AV_SAMPLE_FMT_S32: case AV_SAMPLE_FMT_S32P:
    case AV_SAMPLE_FMT_U8:  case AV_SAMPLE_FMT_U8P:
      break;
    default:
      return false;
  }
  acc.reserve(acc.size() + static_cast<size_t>(n));
  for (int i = 0; i < n; ++i) {
    float s = 0.0f;
    for (int c = 0; c < ch; ++c) s += sample(c, i);
    acc.push_back(s * inv_ch);
  }
  return true;
}

}  // namespace

extern "C" {

int32_t aries_av_available() { return api().ok_decode() ? 1 : 0; }

int32_t aries_decode_av(const uint8_t* data, int64_t len, float** out,
                        int64_t* out_len, int32_t* sample_rate) {
  if (!data || len <= 0 || !out || !out_len || !sample_rate) return -1;
  const AvApi& m = api();
  if (!m.ok_decode()) return -2;

  MemReader reader{data, len, 0};
  constexpr int kIoBuf = 1 << 16;
  unsigned char* iobuf = static_cast<unsigned char*>(m.malloc_(kIoBuf));
  if (!iobuf) return -3;
  AVIOContext* avio =
      m.avio_alloc(iobuf, kIoBuf, 0, &reader, mem_read, nullptr, mem_seek);
  if (!avio) {
    m.free_(iobuf);
    return -3;
  }

  AVFormatContext* fc = m.alloc_ctx();
  int status = -3;
  AVCodecContext* cc = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* frame = nullptr;
  std::vector<float> acc;
  int rate = 0;
  int stream_idx = -1;

  do {
    if (!fc) break;
    fc->pb = avio;
    fc->flags |= AVFMT_FLAG_CUSTOM_IO;
    if (m.open_input(&fc, nullptr, nullptr, nullptr) < 0) {
      fc = nullptr;  // open_input frees fc on failure
      break;
    }
    if (m.find_stream_info(fc, nullptr) < 0) break;
    const AVCodec* dec = nullptr;
    stream_idx = m.find_best_stream(fc, AVMEDIA_TYPE_AUDIO, -1, -1, &dec, 0);
    if (stream_idx < 0 || !dec) break;
    AVStream* st = fc->streams[stream_idx];
    cc = m.alloc_codec_ctx(dec);
    if (!cc) break;
    if (m.params_to_ctx(cc, st->codecpar) < 0) break;
    if (m.codec_open2(cc, dec, nullptr) < 0) break;
    pkt = m.packet_alloc();
    frame = m.frame_alloc();
    if (!pkt || !frame) break;

    bool fail = false;
    auto drain = [&]() {
      for (;;) {
        int rc = m.receive_frame(cc, frame);
        if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) return true;
        if (rc < 0) return false;
        if (rate == 0) rate = frame->sample_rate;
        bool ok = accumulate_mono(m, frame, acc);
        m.frame_unref(frame);
        if (!ok) return false;
      }
    };

    for (;;) {
      int rc = m.read_frame(fc, pkt);
      if (rc == AVERROR_EOF) break;
      if (rc < 0) {
        fail = true;
        break;
      }
      if (pkt->stream_index == stream_idx) {
        if (m.send_packet(cc, pkt) == 0) {
          if (!drain()) {
            fail = true;
            m.packet_unref(pkt);
            break;
          }
        }
        // a failed send on one packet is tolerated (corrupt mid-stream
        // packet); the demuxer keeps going
      }
      m.packet_unref(pkt);
      if (fail) break;
    }
    if (!fail) {
      m.send_packet(cc, nullptr);  // flush
      if (!drain()) fail = true;
    }
    if (fail || rate <= 0 || acc.empty()) break;
    status = 0;
  } while (false);

  if (frame) m.frame_free(&frame);
  if (pkt) m.packet_free(&pkt);
  if (cc) m.free_codec_ctx(&cc);
  if (fc) m.close_input(&fc);
  if (avio) {
    // avio may have re-allocated its internal buffer; free the live one
    m.free_(avio->buffer);
    avio->buffer = nullptr;
    m.avio_ctx_free(&avio);
  }
  if (status != 0) return status;

  const int64_t frames = static_cast<int64_t>(acc.size());
  float* mono = static_cast<float*>(std::malloc(sizeof(float) * frames));
  if (!mono) return -3;
  std::memcpy(mono, acc.data(), sizeof(float) * frames);
  *out = mono;
  *out_len = frames;
  *sample_rate = rate;
  return 0;
}

// --- test-vector encoder: mono float32 -> .m4a bytes (mp4 + native AAC) -----

int32_t aries_encode_m4a(const float* audio, int64_t n, int32_t rate,
                         uint8_t** out, int64_t* out_len) {
  if (!audio || n <= 0 || !out || !out_len || rate <= 0) return -1;
  const AvApi& m = api();
  if (!m.ok_encode()) return -2;

  AVFormatContext* oc = nullptr;
  if (m.alloc_output_ctx(&oc, nullptr, "mp4", nullptr) < 0 || !oc) return -3;

  int status = -3;
  AVCodecContext* cc = nullptr;
  AVFrame* frame = nullptr;
  AVPacket* pkt = nullptr;
  AVIOContext* dyn = nullptr;
  uint8_t* dynbuf = nullptr;

  do {
    const AVCodec* enc = m.find_encoder(AV_CODEC_ID_AAC);
    if (!enc) break;
    AVStream* st = m.new_stream(oc, enc);
    if (!st) break;
    cc = m.alloc_codec_ctx(enc);
    if (!cc) break;
    cc->sample_fmt = AV_SAMPLE_FMT_FLTP;
    cc->sample_rate = rate;
    m.ch_layout_default(&cc->ch_layout, 1);
    cc->time_base = AVRational{1, rate};
    cc->bit_rate = 96000;
    if (oc->oformat->flags & AVFMT_GLOBALHEADER)
      cc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    if (m.codec_open2(cc, enc, nullptr) < 0) break;
    if (m.params_from_ctx(st->codecpar, cc) < 0) break;
    st->time_base = cc->time_base;

    if (m.open_dyn_buf(&dyn) < 0) break;
    oc->pb = dyn;
    oc->flags |= AVFMT_FLAG_CUSTOM_IO;
    if (m.write_header(oc, nullptr) < 0) break;

    pkt = m.packet_alloc();
    frame = m.frame_alloc();
    if (!pkt || !frame) break;
    const int fs = cc->frame_size > 0 ? cc->frame_size : 1024;

    bool fail = false;
    auto drain = [&]() {
      for (;;) {
        int rc = m.receive_packet(cc, pkt);
        if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) return true;
        if (rc < 0) return false;
        m.packet_rescale_ts(pkt, cc->time_base, st->time_base);
        pkt->stream_index = st->index;
        if (m.write_frame_i(oc, pkt) < 0) return false;
      }
    };

    int64_t pos = 0, pts = 0;
    while (pos < n && !fail) {
      const int this_n = static_cast<int>(n - pos < fs ? n - pos : fs);
      m.frame_unref(frame);
      frame->format = AV_SAMPLE_FMT_FLTP;
      m.ch_layout_default(&frame->ch_layout, 1);
      frame->sample_rate = rate;
      frame->nb_samples = fs;  // last frame zero-padded to full size
      if (m.frame_get_buffer(frame, 0) < 0) {
        fail = true;
        break;
      }
      float* dst = reinterpret_cast<float*>(frame->data[0]);
      std::memcpy(dst, audio + pos, sizeof(float) * this_n);
      if (this_n < fs)
        std::memset(dst + this_n, 0, sizeof(float) * (fs - this_n));
      frame->pts = pts;
      pts += fs;
      pos += this_n;
      if (m.send_frame(cc, frame) < 0 || !drain()) fail = true;
    }
    if (!fail && (m.send_frame(cc, nullptr) < 0 || !drain())) fail = true;
    if (fail) break;
    if (m.write_trailer(oc) < 0) break;
    status = 0;
  } while (false);

  if (dyn) {
    int dlen = m.close_dyn_buf(dyn, &dynbuf);
    oc->pb = nullptr;
    if (status == 0 && dynbuf && dlen > 0) {
      uint8_t* copy = static_cast<uint8_t*>(std::malloc(dlen));
      if (copy) {
        std::memcpy(copy, dynbuf, static_cast<size_t>(dlen));
        *out = copy;
        *out_len = dlen;
      } else {
        status = -3;
      }
    } else if (status == 0) {
      status = -3;
    }
    if (dynbuf) m.free_(dynbuf);
  }
  if (frame) m.frame_free(&frame);
  if (pkt) m.packet_free(&pkt);
  if (cc) m.free_codec_ctx(&cc);
  if (oc) m.free_ctx(oc);
  return status;
}

}  // extern "C"
