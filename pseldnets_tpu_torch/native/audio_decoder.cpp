// Native audio decoder: WAV (PCM 16/24/32, float32) and FLAC (full subset:
// constant / verbatim / fixed / LPC subframes, rice + rice2 residuals,
// left-side / right-side / mid-side decorrelation, wasted bits).
//
// Replaces the reference's soundfile/libsndfile dependency
// (reference src/data/data.py:7-15 load_audio) with a from-scratch C++
// implementation exposed through a minimal C ABI for ctypes.
//
// API (all return 0 on success, negative error codes otherwise):
//   audio_info(path, &frames, &channels, &samplerate)
//   audio_read_f32(path, out, start, stop, channels)
//     -> out is channel-major (C, stop-start) float32 in [-1, 1)
//
// Build: g++ -O3 -march=native -shared -fPIC audio_decoder.cpp -o libpseldaudio.so

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <vector>

namespace {

constexpr int ERR_OPEN = -1;
constexpr int ERR_FORMAT = -2;
constexpr int ERR_RANGE = -3;
constexpr int ERR_UNSUPPORTED = -4;
constexpr int ERR_CORRUPT = -5;

struct FileBuf {
  std::vector<uint8_t> data;
  bool load(const char* path) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    long n = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    data.resize((size_t)n);
    size_t got = std::fread(data.data(), 1, (size_t)n, f);
    std::fclose(f);
    return got == (size_t)n;
  }
};

// ---------------------------------------------------------------- WAV ------
struct WavInfo {
  int64_t frames = 0;
  int channels = 0, samplerate = 0, bits = 0, fmt = 0;  // fmt 1=pcm 3=float
  size_t data_off = 0;
  size_t data_len = 0;
};

bool parse_wav(const FileBuf& fb, WavInfo* wi) {
  const uint8_t* p = fb.data.data();
  size_t n = fb.data.size();
  if (n < 44 || std::memcmp(p, "RIFF", 4) || std::memcmp(p + 8, "WAVE", 4))
    return false;
  size_t off = 12;
  bool have_fmt = false;
  while (off + 8 <= n) {
    uint32_t clen;
    std::memcpy(&clen, p + off + 4, 4);
    const uint8_t* cid = p + off;
    size_t body = off + 8;
    if (!std::memcmp(cid, "fmt ", 4) && body + 16 <= n) {
      uint16_t fmt, ch, bits;
      uint32_t sr;
      std::memcpy(&fmt, p + body, 2);
      std::memcpy(&ch, p + body + 2, 2);
      std::memcpy(&sr, p + body + 4, 4);
      std::memcpy(&bits, p + body + 14, 2);
      if (fmt == 0xFFFE && clen >= 40) {  // WAVE_FORMAT_EXTENSIBLE
        uint16_t sub;
        std::memcpy(&sub, p + body + 24, 2);
        fmt = sub;
      }
      wi->fmt = fmt;
      wi->channels = ch;
      wi->samplerate = (int)sr;
      wi->bits = bits;
      have_fmt = true;
    } else if (!std::memcmp(cid, "data", 4)) {
      wi->data_off = body;
      wi->data_len = clen;
      if (wi->data_off + wi->data_len > n) wi->data_len = n - wi->data_off;
    }
    off = body + clen + (clen & 1);
  }
  if (!have_fmt || !wi->channels || !wi->bits || !wi->data_off) return false;
  wi->frames = (int64_t)(wi->data_len / (wi->channels * (wi->bits / 8)));
  return true;
}

int read_wav(const FileBuf& fb, const WavInfo& wi, float* out, int64_t start,
             int64_t stop) {
  if (start < 0 || stop > wi.frames || start > stop) return ERR_RANGE;
  const uint8_t* base =
      fb.data.data() + wi.data_off + (size_t)start * wi.channels * (wi.bits / 8);
  int64_t nf = stop - start;
  int C = wi.channels;
  if (wi.fmt == 3 && wi.bits == 32) {
    const float* s = reinterpret_cast<const float*>(base);
    for (int64_t t = 0; t < nf; ++t)
      for (int c = 0; c < C; ++c) out[(size_t)c * nf + t] = s[t * C + c];
  } else if (wi.fmt == 1 && wi.bits == 16) {
    const int16_t* s = reinterpret_cast<const int16_t*>(base);
    const float k = 1.0f / 32768.0f;
    for (int64_t t = 0; t < nf; ++t)
      for (int c = 0; c < C; ++c) out[(size_t)c * nf + t] = s[t * C + c] * k;
  } else if (wi.fmt == 1 && wi.bits == 24) {
    const float k = 1.0f / 8388608.0f;
    for (int64_t t = 0; t < nf; ++t)
      for (int c = 0; c < C; ++c) {
        const uint8_t* q = base + (t * C + c) * 3;
        int32_t v = (int32_t)((uint32_t)q[0] | ((uint32_t)q[1] << 8) |
                              ((uint32_t)q[2] << 16));
        v = (v << 8) >> 8;  // sign-extend 24 bit
        out[(size_t)c * nf + t] = v * k;
      }
  } else if (wi.fmt == 1 && wi.bits == 32) {
    const int32_t* s = reinterpret_cast<const int32_t*>(base);
    const float k = 1.0f / 2147483648.0f;
    for (int64_t t = 0; t < nf; ++t)
      for (int c = 0; c < C; ++c) out[(size_t)c * nf + t] = s[t * C + c] * k;
  } else {
    return ERR_UNSUPPORTED;
  }
  return 0;
}

// ---------------------------------------------------------------- FLAC -----
struct BitReader {
  const uint8_t* p;
  size_t n;       // total bytes
  size_t pos = 0; // byte position
  int bit = 0;    // bits consumed in current byte (0..7)

  bool eof() const { return pos >= n; }

  inline uint32_t read_bit() {
    uint32_t b = (p[pos] >> (7 - bit)) & 1u;
    if (++bit == 8) {
      bit = 0;
      ++pos;
    }
    return b;
  }

  inline uint64_t read_bits(int k) {  // k <= 57
    uint64_t v = 0;
    while (k > 0) {
      int avail = 8 - bit;
      int take = k < avail ? k : avail;
      uint32_t cur = p[pos] & (0xFFu >> bit);
      v = (v << take) | (cur >> (avail - take));
      bit += take;
      if (bit == 8) {
        bit = 0;
        ++pos;
      }
      k -= take;
    }
    return v;
  }

  inline int64_t read_signed(int k) {
    if (k == 0) return 0;
    uint64_t v = read_bits(k);
    uint64_t sign = 1ull << (k - 1);
    return (v & sign) ? (int64_t)(v | ~((sign << 1) - 1)) : (int64_t)v;
  }

  inline uint32_t read_unary() {
    uint32_t q = 0;
    // fast path: scan whole bytes
    for (;;) {
      if (pos >= n) return q;  // corrupt; caller checks eof
      uint32_t cur = p[pos] & (0xFFu >> bit);
      if (cur == 0) {
        q += 8 - bit;
        bit = 0;
        ++pos;
        continue;
      }
      // find highest set bit position
      int lead = __builtin_clz(cur) - 24;  // leading zeros within byte
      int ones_pos = lead;                 // bit index of first 1 from MSB of the masked byte
      q += ones_pos - bit;
      bit = ones_pos + 1;
      if (bit == 8) {
        bit = 0;
        ++pos;
      }
      return q;
    }
  }

  void align() {
    if (bit) {
      bit = 0;
      ++pos;
    }
  }
};

struct FlacInfo {
  int64_t total_samples = 0;
  int channels = 0, samplerate = 0, bits = 0;
  int min_bs = 0, max_bs = 0;  // STREAMINFO block sizes (min==max -> fixed)
  size_t frames_off = 0;  // first audio frame byte offset
};

bool parse_flac_header(const FileBuf& fb, FlacInfo* fi) {
  const uint8_t* p = fb.data.data();
  size_t n = fb.data.size();
  if (n < 42 || std::memcmp(p, "fLaC", 4)) return false;
  size_t off = 4;
  bool last = false;
  while (!last && off + 4 <= n) {
    uint8_t hdr = p[off];
    last = hdr & 0x80;
    int type = hdr & 0x7F;
    uint32_t len = ((uint32_t)p[off + 1] << 16) | ((uint32_t)p[off + 2] << 8) |
                   p[off + 3];
    size_t body = off + 4;
    if (type == 0 && len >= 34) {  // STREAMINFO
      const uint8_t* s = p + body;
      fi->min_bs = ((uint32_t)s[0] << 8) | s[1];
      fi->max_bs = ((uint32_t)s[2] << 8) | s[3];
      fi->samplerate = ((uint32_t)s[10] << 12) | ((uint32_t)s[11] << 4) |
                       (s[12] >> 4);
      fi->channels = ((s[12] >> 1) & 0x7) + 1;
      fi->bits = (((s[12] & 1) << 4) | (s[13] >> 4)) + 1;
      fi->total_samples = ((int64_t)(s[13] & 0x0F) << 32) |
                          ((int64_t)s[14] << 24) | ((int64_t)s[15] << 16) |
                          ((int64_t)s[16] << 8) | s[17];
    }
    off = body + len;
  }
  if (!fi->channels || !fi->samplerate) return false;
  fi->frames_off = off;
  return true;
}

// fixed predictor reconstruction
inline void fixed_predict(int order, int64_t* x, int nsamp) {
  switch (order) {
    case 0: break;
    case 1:
      for (int i = 1; i < nsamp; ++i) x[i] += x[i - 1];
      break;
    case 2:
      for (int i = 2; i < nsamp; ++i) x[i] += 2 * x[i - 1] - x[i - 2];
      break;
    case 3:
      for (int i = 3; i < nsamp; ++i)
        x[i] += 3 * x[i - 1] - 3 * x[i - 2] + x[i - 3];
      break;
    case 4:
      for (int i = 4; i < nsamp; ++i)
        x[i] += 4 * x[i - 1] - 6 * x[i - 2] + 4 * x[i - 3] - x[i - 4];
      break;
  }
}

// returns false on corrupt stream
bool read_residual(BitReader& br, int order, int blocksize, int64_t* x) {
  int method = (int)br.read_bits(2);
  if (method > 1) return false;
  int plen = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 0xF : 0x1F;
  int part_order = (int)br.read_bits(4);
  int nparts = 1 << part_order;
  int samples_per = blocksize >> part_order;
  int idx = order;
  for (int pi = 0; pi < nparts; ++pi) {
    int count = samples_per - (pi == 0 ? order : 0);
    if (count < 0) return false;
    uint32_t param = (uint32_t)br.read_bits(plen);
    if (param == escape) {
      int raw = (int)br.read_bits(5);
      for (int i = 0; i < count; ++i) x[idx++] = br.read_signed(raw);
    } else {
      for (int i = 0; i < count; ++i) {
        uint32_t q = br.read_unary();
        uint64_t r = param ? br.read_bits(param) : 0;
        uint64_t u = ((uint64_t)q << param) | r;
        x[idx++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);  // zigzag
      }
    }
    if (br.pos > br.n) return false;
  }
  return true;
}

bool read_subframe(BitReader& br, int bps, int blocksize, int64_t* x) {
  if (br.read_bit() != 0) return false;  // padding
  int type = (int)br.read_bits(6);
  int wasted = 0;
  if (br.read_bit()) {
    wasted = 1;
    while (br.read_bit() == 0) ++wasted;
  }
  bps -= wasted;
  if (type == 0) {  // constant
    int64_t v = br.read_signed(bps);
    for (int i = 0; i < blocksize; ++i) x[i] = v;
  } else if (type == 1) {  // verbatim
    for (int i = 0; i < blocksize; ++i) x[i] = br.read_signed(bps);
  } else if (type >= 8 && type <= 12) {  // fixed
    int order = type - 8;
    for (int i = 0; i < order; ++i) x[i] = br.read_signed(bps);
    if (!read_residual(br, order, blocksize, x)) return false;
    fixed_predict(order, x, blocksize);
  } else if (type >= 32) {  // LPC
    int order = type - 31;
    for (int i = 0; i < order; ++i) x[i] = br.read_signed(bps);
    int precision = (int)br.read_bits(4) + 1;
    if (precision == 16) return false;  // invalid
    int shift = (int)br.read_signed(5);
    if (shift < 0) return false;
    int64_t coef[32];
    for (int i = 0; i < order; ++i) coef[i] = br.read_signed(precision);
    if (!read_residual(br, order, blocksize, x)) return false;
    for (int i = order; i < blocksize; ++i) {
      int64_t acc = 0;
      for (int j = 0; j < order; ++j) acc += coef[j] * x[i - 1 - j];
      x[i] += acc >> shift;
    }
  } else {
    return false;
  }
  if (wasted)
    for (int i = 0; i < blocksize; ++i) x[i] <<= wasted;
  return true;
}

bool read_utf8_coded(BitReader& br, uint64_t* out) {
  uint32_t b0 = (uint32_t)br.read_bits(8);
  int extra = 0;
  uint64_t v = 0;
  if (b0 < 0x80) {
    *out = b0;
    return true;
  }
  for (int k = 6; k >= 1; --k)
    if ((b0 >> k) == (0xFFu >> k) - 1) {  // matches 1..10xxxx prefix patterns
      extra = 7 - k - 1;
      v = b0 & ((1u << k) - 1);
      break;
    }
  // simpler: count leading ones
  extra = 0;
  uint32_t t = b0;
  while (t & 0x80) {
    ++extra;
    t <<= 1;
  }
  if (extra < 2 || extra > 7) return false;
  v = b0 & (0xFFu >> (extra + 1));
  for (int i = 1; i < extra; ++i) {
    uint32_t b = (uint32_t)br.read_bits(8);
    if ((b & 0xC0) != 0x80) return false;
    v = (v << 6) | (b & 0x3F);
  }
  *out = v;
  return true;
}

static const int kBlockSizeTable[16] = {0,   192,  576,  1152, 2304, 4608, -1, -2,
                                        256, 512, 1024, 2048, 4096, 8192, 16384, 32768};

// FLAC header CRC-8 (poly 0x07, init 0) — headers are a handful of bytes, so
// the bitwise loop beats carrying a table around.
inline uint8_t crc8(const uint8_t* d, size_t n) {
  uint8_t c = 0;
  for (size_t i = 0; i < n; ++i) {
    c ^= d[i];
    for (int k = 0; k < 8; ++k)
      c = (c & 0x80) ? (uint8_t)((c << 1) ^ 0x07) : (uint8_t)(c << 1);
  }
  return c;
}

struct FrameHdr {
  int64_t first_sample = 0;
  int blocksize = 0;
  int ch_asgn = 0;
  size_t off = 0;  // byte offset of the sync byte
};

// Parse + CRC-8-verify a frame header at br.pos (must be byte-aligned). On
// success br is left at the first subframe bit. The fixed-blocksize
// frame-index -> sample conversion uses the STREAMINFO nominal (max)
// blocksize: the stream's LAST frame may be shorter, and its header codes
// the frame index, not a sample count of its own size.
bool parse_frame_header(BitReader& br, const FlacInfo& fi, FrameHdr* h) {
  size_t off = br.pos;
  if (br.bit != 0 || off + 5 > br.n) return false;
  if ((uint32_t)br.read_bits(14) != 0x3FFE) return false;
  if (br.read_bit()) return false;  // mandatory 0
  uint32_t blocking = br.read_bit();
  int bs_code = (int)br.read_bits(4);
  int sr_code = (int)br.read_bits(4);
  int ch_asgn = (int)br.read_bits(4);
  int ss_code = (int)br.read_bits(3);
  if (br.read_bit()) return false;  // mandatory 0
  if (bs_code == 0 || sr_code == 15 || ss_code == 3 || ch_asgn > 10)
    return false;
  if (ch_asgn <= 7 ? (ch_asgn + 1 != fi.channels) : (fi.channels != 2))
    return false;
  if (br.pos + 8 > br.n) return false;  // utf8 number: up to 7 bytes
  uint64_t frame_no;
  if (!read_utf8_coded(br, &frame_no)) return false;
  if (br.pos + 5 > br.n) return false;  // blocksize/sr extras + crc
  int blocksize;
  if (bs_code == 6)
    blocksize = (int)br.read_bits(8) + 1;
  else if (bs_code == 7)
    blocksize = (int)br.read_bits(16) + 1;
  else
    blocksize = kBlockSizeTable[bs_code];
  if (blocksize <= 0) return false;
  if (sr_code == 12) br.read_bits(8);
  else if (sr_code == 13 || sr_code == 14) br.read_bits(16);
  uint32_t crc = (uint32_t)br.read_bits(8);
  if (crc8(br.p + off, br.pos - 1 - off) != crc) return false;
  int64_t nominal = fi.max_bs > 0 ? fi.max_bs : blocksize;
  h->first_sample =
      blocking ? (int64_t)frame_no : (int64_t)frame_no * nominal;
  h->blocksize = blocksize;
  h->ch_asgn = ch_asgn;
  h->off = off;
  return true;
}

// Scan [from, limit) for the next byte offset holding a CRC-valid frame
// header. Frames are byte-aligned; sync is 0xFF 0b111110xb.
bool find_frame(const FileBuf& fb, const FlacInfo& fi, size_t from,
                size_t limit, FrameHdr* h) {
  const uint8_t* p = fb.data.data();
  size_t n = fb.data.size();
  if (limit > n) limit = n;
  for (size_t o = from; o + 2 <= limit; ++o) {
    if (p[o] != 0xFF || (p[o + 1] & 0xFC) != 0xF8) continue;
    BitReader br{p, n};
    br.pos = o;
    if (parse_frame_header(br, fi, h)) return true;
  }
  return false;
}

struct FlacDecoder {
  const FlacInfo& fi;
  BitReader br;
  std::vector<int64_t> chan[8];

  FlacDecoder(const FileBuf& fb, const FlacInfo& info) : fi(info) {
    br.p = fb.data.data();
    br.n = fb.data.size();
    br.pos = fi.frames_off;
  }

  // decode next frame; returns blocksize or <0
  int next_frame(int64_t* first_sample) {
    if (br.pos + 4 >= br.n) return 0;  // clean EOF
    br.align();
    FrameHdr h;
    if (!parse_frame_header(br, fi, &h)) return ERR_CORRUPT;
    int blocksize = h.blocksize;
    int ch_asgn = h.ch_asgn;
    int bps = fi.bits;
    int C = fi.channels;
    for (int c = 0; c < C; ++c)
      if ((int)chan[c].size() < blocksize) chan[c].resize(blocksize);

    if (ch_asgn <= 7) {
      if (ch_asgn + 1 != C) return ERR_CORRUPT;
      for (int c = 0; c < C; ++c)
        if (!read_subframe(br, bps, blocksize, chan[c].data())) return ERR_CORRUPT;
    } else if (ch_asgn == 8) {  // left-side
      if (C != 2) return ERR_CORRUPT;
      if (!read_subframe(br, bps, blocksize, chan[0].data())) return ERR_CORRUPT;
      if (!read_subframe(br, bps + 1, blocksize, chan[1].data())) return ERR_CORRUPT;
      for (int i = 0; i < blocksize; ++i) chan[1][i] = chan[0][i] - chan[1][i];
    } else if (ch_asgn == 9) {  // right-side
      if (C != 2) return ERR_CORRUPT;
      if (!read_subframe(br, bps + 1, blocksize, chan[0].data())) return ERR_CORRUPT;
      if (!read_subframe(br, bps, blocksize, chan[1].data())) return ERR_CORRUPT;
      for (int i = 0; i < blocksize; ++i) chan[0][i] = chan[0][i] + chan[1][i];
    } else if (ch_asgn == 10) {  // mid-side
      if (C != 2) return ERR_CORRUPT;
      if (!read_subframe(br, bps, blocksize, chan[0].data())) return ERR_CORRUPT;
      if (!read_subframe(br, bps + 1, blocksize, chan[1].data())) return ERR_CORRUPT;
      for (int i = 0; i < blocksize; ++i) {
        int64_t side = chan[1][i];
        int64_t mid = (chan[0][i] << 1) | (side & 1);
        chan[0][i] = (mid + side) >> 1;
        chan[1][i] = (mid - side) >> 1;
      }
    } else {
      return ERR_CORRUPT;
    }
    br.align();
    br.read_bits(16);  // CRC-16 (unverified)
    *first_sample = h.first_sample;
    return blocksize;
  }
};

int read_flac(const FileBuf& fb, const FlacInfo& fi, float* out, int64_t start,
              int64_t stop) {
  if (start < 0 || (fi.total_samples && stop > fi.total_samples) || start > stop)
    return ERR_RANGE;
  FlacDecoder dec(fb, fi);
  const float k = 1.0f / (float)(1ll << (fi.bits - 1));
  int64_t nf = stop - start;
  int C = fi.channels;
  int64_t pos = 0;  // running sample counter (from decoder stream order)

  // Seek (libFLAC's no-seektable strategy): frames are byte-aligned,
  // independently decodable, and their CRC-8-verified headers code a
  // monotonically increasing sample/frame number — so binary-search byte
  // offsets for the latest frame with first_sample <= start and decode
  // from there. A ranged read costs O(range), not O(start + range); the
  // training loader's random 10 s chunks out of 60 s clips skip an average
  // 25 s prefix decode.
  bool seeked = false;
  if (start > 0) {
    FrameHdr h;
    size_t lo = fi.frames_off, hi = fb.data.size();
    size_t best_off = fi.frames_off;
    int64_t best_sample = 0;
    int best_bs = 0;
    while (hi > lo + 2048) {
      size_t mid = lo + (hi - lo) / 2;
      if (find_frame(fb, fi, mid, hi, &h) && h.first_sample <= start) {
        best_off = h.off;
        best_sample = h.first_sample;
        best_bs = h.blocksize;
        lo = h.off + 1;
      } else {
        hi = mid;
      }
    }
    if (best_off != fi.frames_off) {
      // Consistency gate: the next header's number must continue this one
      // (catches non-conformant numbering, e.g. all-zero frame indices,
      // where a sequential decode is still correct but a seek is not).
      bool ok = true;
      if (find_frame(fb, fi, best_off + 1, fb.data.size(), &h))
        ok = (h.first_sample == best_sample + best_bs);
      if (ok) {
        dec.br.pos = best_off;
        dec.br.bit = 0;
        pos = best_sample;
        seeked = true;
      }
    }
  }
  for (;;) {
    int64_t first = 0;
    int bs = dec.next_frame(&first);
    if (bs == 0) break;
    if (bs < 0) {
      if (seeked) {  // bad landing (e.g. false sync): full decode fallback
        dec.br.pos = fi.frames_off;
        dec.br.bit = 0;
        pos = 0;
        seeked = false;
        continue;
      }
      return bs;
    }
    // frames decode sequentially; the coded frame/sample number is advisory
    int64_t fstart = pos;
    pos = fstart + bs;
    int64_t lo = fstart > start ? fstart : start;
    int64_t hi = pos < stop ? pos : stop;
    for (int64_t t = lo; t < hi; ++t)
      for (int c = 0; c < C; ++c)
        out[(size_t)c * nf + (t - start)] = dec.chan[c][t - fstart] * k;
    if (pos >= stop) return 0;
  }
  return pos >= stop ? 0 : ERR_CORRUPT;
}

bool is_flac(const FileBuf& fb) {
  return fb.data.size() >= 4 && !std::memcmp(fb.data.data(), "fLaC", 4);
}

}  // namespace

extern "C" {

int audio_info(const char* path, int64_t* frames, int32_t* channels,
               int32_t* samplerate) {
  FileBuf fb;
  if (!fb.load(path)) return ERR_OPEN;
  if (is_flac(fb)) {
    FlacInfo fi;
    if (!parse_flac_header(fb, &fi)) return ERR_FORMAT;
    *frames = fi.total_samples;
    *channels = fi.channels;
    *samplerate = fi.samplerate;
    return 0;
  }
  WavInfo wi;
  if (!parse_wav(fb, &wi)) return ERR_FORMAT;
  *frames = wi.frames;
  *channels = wi.channels;
  *samplerate = wi.samplerate;
  return 0;
}

int audio_read_f32(const char* path, float* out, int64_t start, int64_t stop) {
  FileBuf fb;
  if (!fb.load(path)) return ERR_OPEN;
  if (is_flac(fb)) {
    FlacInfo fi;
    if (!parse_flac_header(fb, &fi)) return ERR_FORMAT;
    return read_flac(fb, fi, out, start, stop);
  }
  WavInfo wi;
  if (!parse_wav(fb, &wi)) return ERR_FORMAT;
  return read_wav(fb, wi, out, start, stop);
}

}  // extern "C"
