// ariesflac — native FLAC decoder for whisper_aries_tpu_torch (the port's
// own copy of the JAX package's native/ariesflac.cpp).
//
// The reference reads FLAC through libsndfile (requirements.txt:54, used
// via soundfile at final_optimized_transcriber.py:85); this container (and
// lean deployments) may lack both libsndfile and ffmpeg, so the framework
// carries its own decoder. Implements the FLAC format per the public spec
// (https://xiph.org/flac/format.html): STREAMINFO parsing, frame sync,
// CONSTANT/VERBATIM/FIXED/LPC subframes, partitioned Rice residuals,
// wasted bits, and left-side/right-side/mid-side stereo decorrelation.
// CRCs are parsed but not verified (decode is validated structurally).
//
// Exposed through the same C ABI as ariesaudio.cpp:
//   aries_decode_flac(data, len, &out, &out_len, &sample_rate) -> status
// returning mono float32 (channel-averaged) like aries_decode_wav.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>
#include <algorithm>

namespace {

enum Status : int32_t {
  OK = 0,
  ERR_MAGIC = 10,
  ERR_STREAMINFO = 11,
  ERR_TRUNCATED = 12,
  ERR_BAD_FRAME = 13,
  ERR_UNSUPPORTED = 14,
  ERR_ALLOC = 15,
};

class BitReader {
 public:
  BitReader(const uint8_t* data, size_t len) : data_(data), len_(len) {}

  bool read_bits(int n, uint64_t* out) {
    uint64_t v = 0;
    while (n > 0) {
      if (byte_ >= len_) return false;
      int avail = 8 - bit_;
      int take = n < avail ? n : avail;
      int shift = avail - take;
      uint32_t mask = (1u << take) - 1;
      v = (v << take) | ((data_[byte_] >> shift) & mask);
      bit_ += take;
      if (bit_ == 8) {
        bit_ = 0;
        ++byte_;
      }
      n -= take;
    }
    *out = v;
    return true;
  }

  bool read_signed(int n, int64_t* out) {
    uint64_t v;
    if (!read_bits(n, &v)) return false;
    // sign-extend
    if (n > 0 && (v >> (n - 1)) & 1) v |= ~((1ull << n) - 1);
    *out = (int64_t)v;
    return true;
  }

  bool read_unary(uint32_t* out) {
    uint32_t q = 0;
    for (;;) {
      uint64_t b;
      if (!read_bits(1, &b)) return false;
      if (b) break;
      if (++q > (1u << 24)) return false;  // corrupt stream guard
    }
    *out = q;
    return true;
  }

  void align_byte() {
    if (bit_) {
      bit_ = 0;
      ++byte_;
    }
  }

  size_t byte_pos() const { return byte_; }
  void seek_byte(size_t b) { byte_ = b; bit_ = 0; }
  bool eof() const { return byte_ >= len_; }

 private:
  const uint8_t* data_;
  size_t len_;
  size_t byte_ = 0;
  int bit_ = 0;
};

struct StreamInfo {
  uint32_t sample_rate = 0;
  uint32_t channels = 0;
  uint32_t bps = 0;
  uint64_t total_samples = 0;
};

// frame-header UTF-8-style coded number (up to 7 bytes)
bool read_utf8_number(BitReader& br, uint64_t* out) {
  uint64_t b0;
  if (!br.read_bits(8, &b0)) return false;
  int extra;
  uint64_t v;
  if ((b0 & 0x80) == 0) { v = b0; extra = 0; }
  else if ((b0 & 0xE0) == 0xC0) { v = b0 & 0x1F; extra = 1; }
  else if ((b0 & 0xF0) == 0xE0) { v = b0 & 0x0F; extra = 2; }
  else if ((b0 & 0xF8) == 0xF0) { v = b0 & 0x07; extra = 3; }
  else if ((b0 & 0xFC) == 0xF8) { v = b0 & 0x03; extra = 4; }
  else if ((b0 & 0xFE) == 0xFC) { v = b0 & 0x01; extra = 5; }
  else if (b0 == 0xFE) { v = 0; extra = 6; }
  else return false;
  for (int i = 0; i < extra; ++i) {
    uint64_t b;
    if (!br.read_bits(8, &b)) return false;
    if ((b & 0xC0) != 0x80) return false;
    v = (v << 6) | (b & 0x3F);
  }
  *out = v;
  return true;
}

bool decode_residual(BitReader& br, uint32_t block_size, uint32_t order,
                     std::vector<int64_t>& out /* size block_size */) {
  uint64_t method, part_order;
  if (!br.read_bits(2, &method)) return false;
  if (method > 1) return false;
  const int param_bits = method == 0 ? 4 : 5;
  const uint32_t escape = method == 0 ? 0xF : 0x1F;
  if (!br.read_bits(4, &part_order)) return false;
  uint32_t partitions = 1u << part_order;
  if (block_size % partitions != 0) return false;
  uint32_t part_samples = block_size >> part_order;
  size_t idx = order;
  for (uint32_t p = 0; p < partitions; ++p) {
    uint32_t count = part_samples - (p == 0 ? order : 0);
    uint64_t param;
    if (!br.read_bits(param_bits, &param)) return false;
    if (param == escape) {
      uint64_t raw_bits;
      if (!br.read_bits(5, &raw_bits)) return false;
      for (uint32_t i = 0; i < count; ++i) {
        int64_t v = 0;
        if (raw_bits > 0) {
          if (!br.read_signed((int)raw_bits, &v)) return false;
        }
        out[idx++] = v;
      }
    } else {
      for (uint32_t i = 0; i < count; ++i) {
        uint32_t q;
        if (!br.read_unary(&q)) return false;
        uint64_t r = 0;
        if (param > 0 && !br.read_bits((int)param, &r)) return false;
        uint64_t u = ((uint64_t)q << param) | r;
        // zigzag decode
        out[idx++] = (u & 1) ? -((int64_t)(u >> 1)) - 1 : (int64_t)(u >> 1);
      }
    }
  }
  return idx == block_size;
}

bool decode_subframe(BitReader& br, uint32_t block_size, uint32_t bps,
                     std::vector<int64_t>& samples) {
  uint64_t pad, type_code, wasted_flag;
  if (!br.read_bits(1, &pad) || pad != 0) return false;
  if (!br.read_bits(6, &type_code)) return false;
  if (!br.read_bits(1, &wasted_flag)) return false;
  uint32_t wasted = 0;
  if (wasted_flag) {
    uint32_t u;
    if (!br.read_unary(&u)) return false;
    wasted = u + 1;
    if (wasted >= bps) return false;
    bps -= wasted;
  }
  samples.assign(block_size, 0);

  if (type_code == 0) {  // CONSTANT
    int64_t v;
    if (!br.read_signed((int)bps, &v)) return false;
    std::fill(samples.begin(), samples.end(), v);
  } else if (type_code == 1) {  // VERBATIM
    for (uint32_t i = 0; i < block_size; ++i) {
      if (!br.read_signed((int)bps, &samples[i])) return false;
    }
  } else if ((type_code & 0x38) == 0x08 && (type_code & 0x07) <= 4) {  // FIXED
    uint32_t order = type_code & 0x07;
    if (order > block_size) return false;
    for (uint32_t i = 0; i < order; ++i) {
      if (!br.read_signed((int)bps, &samples[i])) return false;
    }
    std::vector<int64_t> resid(block_size, 0);
    if (!decode_residual(br, block_size, order, resid)) return false;
    for (uint32_t i = order; i < block_size; ++i) {
      int64_t e = resid[i];
      switch (order) {
        case 0: samples[i] = e; break;
        case 1: samples[i] = e + samples[i - 1]; break;
        case 2: samples[i] = e + 2 * samples[i - 1] - samples[i - 2]; break;
        case 3:
          samples[i] = e + 3 * samples[i - 1] - 3 * samples[i - 2]
                       + samples[i - 3];
          break;
        case 4:
          samples[i] = e + 4 * samples[i - 1] - 6 * samples[i - 2]
                       + 4 * samples[i - 3] - samples[i - 4];
          break;
      }
    }
  } else if (type_code & 0x20) {  // LPC
    uint32_t order = (type_code & 0x1F) + 1;
    if (order > block_size) return false;
    for (uint32_t i = 0; i < order; ++i) {
      if (!br.read_signed((int)bps, &samples[i])) return false;
    }
    uint64_t prec_m1;
    if (!br.read_bits(4, &prec_m1) || prec_m1 == 0xF) return false;
    int precision = (int)prec_m1 + 1;
    int64_t shift;
    if (!br.read_signed(5, &shift) || shift < 0) return false;
    std::vector<int64_t> coef(order);
    for (uint32_t i = 0; i < order; ++i) {
      if (!br.read_signed(precision, &coef[i])) return false;
    }
    std::vector<int64_t> resid(block_size, 0);
    if (!decode_residual(br, block_size, order, resid)) return false;
    for (uint32_t i = order; i < block_size; ++i) {
      __int128 acc = 0;
      for (uint32_t j = 0; j < order; ++j) {
        acc += (__int128)coef[j] * samples[i - 1 - j];
      }
      samples[i] = resid[i] + (int64_t)(acc >> shift);
    }
  } else {
    return false;
  }

  if (wasted) {
    for (auto& s : samples) s <<= wasted;
  }
  return true;
}

const uint32_t kSampleRates[16] = {
    0, 88200, 176400, 192000, 8000, 16000, 22050, 24000,
    32000, 44100, 48000, 96000, 0, 0, 0, 0,
};
const uint32_t kSampleSizes[8] = {0, 8, 12, 0, 16, 20, 24, 32};

}  // namespace

extern "C" {

int32_t aries_decode_flac(const uint8_t* data, int64_t len, float** out,
                          int64_t* out_len, int32_t* sample_rate) {
  if (!data || len < 42 || !out || !out_len || !sample_rate)
    return ERR_TRUNCATED;
  if (std::memcmp(data, "fLaC", 4) != 0) return ERR_MAGIC;

  // ---- metadata blocks ----
  size_t pos = 4;
  StreamInfo info;
  bool have_info = false;
  for (;;) {
    if (pos + 4 > (size_t)len) return ERR_TRUNCATED;
    uint8_t hdr = data[pos];
    bool last = hdr & 0x80;
    uint8_t type = hdr & 0x7F;
    uint32_t blen = ((uint32_t)data[pos + 1] << 16)
                    | ((uint32_t)data[pos + 2] << 8) | data[pos + 3];
    pos += 4;
    if (pos + blen > (size_t)len) return ERR_TRUNCATED;
    if (type == 0 && blen >= 34) {
      const uint8_t* b = data + pos;
      info.sample_rate = ((uint32_t)b[10] << 12) | ((uint32_t)b[11] << 4)
                         | (b[12] >> 4);
      info.channels = ((b[12] >> 1) & 0x7) + 1;
      info.bps = (((b[12] & 1) << 4) | (b[13] >> 4)) + 1;
      info.total_samples = ((uint64_t)(b[13] & 0x0F) << 32)
                           | ((uint64_t)b[14] << 24) | ((uint64_t)b[15] << 16)
                           | ((uint64_t)b[16] << 8) | b[17];
      have_info = true;
    }
    pos += blen;
    if (last) break;
  }
  if (!have_info || info.sample_rate == 0 || info.channels == 0
      || info.channels > 8 || info.bps == 0) {
    return ERR_STREAMINFO;
  }

  // ---- frames ----
  std::vector<double> mono;
  if (info.total_samples) mono.reserve((size_t)info.total_samples);
  const double norm = 1.0 / (double)(1ll << (info.bps - 1)) / info.channels;

  BitReader br(data, (size_t)len);
  br.seek_byte(pos);
  std::vector<std::vector<int64_t>> chan(info.channels);

  while (!br.eof()) {
    uint64_t sync;
    size_t frame_start = br.byte_pos();
    if (!br.read_bits(14, &sync)) break;  // clean EOF
    if (sync != 0x3FFE) return ERR_BAD_FRAME;
    uint64_t reserved, blocking;
    if (!br.read_bits(1, &reserved) || !br.read_bits(1, &blocking))
      return ERR_TRUNCATED;
    uint64_t bs_code, sr_code, ch_code, ss_code, reserved2;
    if (!br.read_bits(4, &bs_code) || !br.read_bits(4, &sr_code)
        || !br.read_bits(4, &ch_code) || !br.read_bits(3, &ss_code)
        || !br.read_bits(1, &reserved2)) {
      return ERR_TRUNCATED;
    }
    uint64_t frame_no;
    if (!read_utf8_number(br, &frame_no)) return ERR_BAD_FRAME;

    uint32_t block_size;
    if (bs_code == 1) block_size = 192;
    else if (bs_code >= 2 && bs_code <= 5) block_size = 576u << (bs_code - 2);
    else if (bs_code == 6) {
      uint64_t v;
      if (!br.read_bits(8, &v)) return ERR_TRUNCATED;
      block_size = (uint32_t)v + 1;
    } else if (bs_code == 7) {
      uint64_t v;
      if (!br.read_bits(16, &v)) return ERR_TRUNCATED;
      block_size = (uint32_t)v + 1;
    } else if (bs_code >= 8) block_size = 256u << (bs_code - 8);
    else return ERR_BAD_FRAME;

    if (sr_code == 12) { uint64_t v; if (!br.read_bits(8, &v)) return ERR_TRUNCATED; }
    else if (sr_code == 13 || sr_code == 14) { uint64_t v; if (!br.read_bits(16, &v)) return ERR_TRUNCATED; }
    else if (sr_code == 15) return ERR_BAD_FRAME;

    uint32_t bps = info.bps;
    if (ss_code != 0) {
      uint32_t s = kSampleSizes[ss_code];
      if (s == 0) return ERR_BAD_FRAME;
      bps = s;
    }

    uint64_t crc8;
    if (!br.read_bits(8, &crc8)) return ERR_TRUNCATED;
    (void)crc8;
    (void)frame_start;

    uint32_t n_ch;
    int stereo_mode = 0;  // 0 none, 1 left/side, 2 right/side, 3 mid/side
    if (ch_code < 8) {
      n_ch = (uint32_t)ch_code + 1;
    } else if (ch_code == 8) { n_ch = 2; stereo_mode = 1; }
    else if (ch_code == 9) { n_ch = 2; stereo_mode = 2; }
    else if (ch_code == 10) { n_ch = 2; stereo_mode = 3; }
    else return ERR_BAD_FRAME;
    if (n_ch != info.channels) return ERR_UNSUPPORTED;

    for (uint32_t c = 0; c < n_ch; ++c) {
      uint32_t sub_bps = bps;
      // the side channel carries one extra bit
      if ((stereo_mode == 1 && c == 1) || (stereo_mode == 2 && c == 0)
          || (stereo_mode == 3 && c == 1)) {
        sub_bps += 1;
      }
      if (!decode_subframe(br, block_size, sub_bps, chan[c]))
        return ERR_BAD_FRAME;
    }
    br.align_byte();
    uint64_t crc16;
    if (!br.read_bits(16, &crc16)) return ERR_TRUNCATED;
    (void)crc16;

    // stereo decorrelation
    if (stereo_mode == 1) {  // left/side: right = left - side
      for (uint32_t i = 0; i < block_size; ++i)
        chan[1][i] = chan[0][i] - chan[1][i];
    } else if (stereo_mode == 2) {  // right/side: left = right + side
      for (uint32_t i = 0; i < block_size; ++i) {
        int64_t side = chan[0][i];
        chan[0][i] = chan[1][i] + side;
      }
    } else if (stereo_mode == 3) {  // mid/side
      for (uint32_t i = 0; i < block_size; ++i) {
        int64_t mid = chan[0][i];
        int64_t side = chan[1][i];
        mid = (mid << 1) | (side & 1);
        chan[0][i] = (mid + side) >> 1;
        chan[1][i] = (mid - side) >> 1;
      }
    }

    for (uint32_t i = 0; i < block_size; ++i) {
      double acc = 0;
      for (uint32_t c = 0; c < n_ch; ++c) acc += (double)chan[c][i];
      mono.push_back(acc * norm);
    }
    if (info.total_samples && mono.size() >= info.total_samples) break;
  }

  if (info.total_samples && mono.size() > info.total_samples) {
    mono.resize((size_t)info.total_samples);
  }
  if (mono.empty()) return ERR_BAD_FRAME;
  float* buf = (float*)std::malloc(sizeof(float) * mono.size());
  if (!buf) return ERR_ALLOC;
  for (size_t i = 0; i < mono.size(); ++i) buf[i] = (float)mono[i];
  *out = buf;
  *out_len = (int64_t)mono.size();
  *sample_rate = (int32_t)info.sample_rate;
  return OK;
}

}  // extern "C"
