// TIFF LZW strip decoder (compression 5), host C++ with a plain C interface,
// built by ecseg_torch/_build.py with the system C++ compiler and loaded
// with ctypes by ecseg_torch/core/imgio.py.
//
// The reference writes its TIFFs with LZW by default, and the JAX package
// reads them through OpenCV's libtiff; the port decodes them itself so that
// it runs where OpenCV is not installed.  A Python loop takes seconds for a
// 2048^2 uint16 file, so the decode is here.
//
// The format (TIFF 6.0, section 13): codes of 9 to 12 bits, most significant
// bit first; 256 clears the table, 257 ends the strip, 258 is the first
// entry; the code width grows one code early (at 511, 1023 and 2047
// entries), as libtiff writes and reads it.  Each table entry is kept as a
// (position, length) span of the strip's own output: an entry is the
// previous string plus the first byte of the current one, and the current
// string is written right after the previous, so the entry is one
// contiguous span of bytes already decoded.  Decoding a code is then one
// memcpy, with no prefix chains to walk.  The old-style (pre-6.0,
// least-significant-bit-first) LZW is not taken: a strip that does not
// start with a clear code is refused.

#include <cstdint>
#include <cstring>

namespace {

constexpr int kClear = 256;
constexpr int kEnd = 257;
constexpr int kFirst = 258;
constexpr int kMaxCodes = 4096;

// 0 when `cap` bytes were decoded; 1 for a short or malformed strip.
// Output past `cap` is dropped, as libtiff drops it.
int decode_strip(const uint8_t* src, int64_t n, uint8_t* out, int64_t cap) {
  static thread_local uint32_t pos[kMaxCodes];
  static thread_local uint32_t len[kMaxCodes];
  if (n < 2 || src[0] != 0x80 || (src[1] & 0x80)) return 1;  // not a clear code first
  int64_t i = 0, o = 0;
  uint64_t acc = 0;
  int nbits = 0, width = 9, next = kFirst;
  int64_t prev_pos = -1, prev_len = 0;
  while (o < cap) {
    while (nbits < width) {
      if (i == n) return 1;  // no end code and not enough output
      acc = (acc << 8) | src[i++];
      nbits += 8;
    }
    nbits -= width;
    const int code = static_cast<int>((acc >> nbits) & ((1u << width) - 1u));
    if (code == kEnd) break;
    if (code == kClear) {
      width = 9;
      next = kFirst;
      prev_pos = -1;
      continue;
    }
    const int64_t start = o;
    int64_t n_out;
    if (code < kClear) {
      out[o] = static_cast<uint8_t>(code);
      n_out = 1;
    } else if (prev_pos < 0 || code > next || (code == next && next == kMaxCodes)) {
      return 1;
    } else {
      const bool kwk = code == next;  // the entry being made: prev + its first byte
      const int64_t from = kwk ? prev_pos : pos[code];
      const int64_t want = kwk ? prev_len + 1 : len[code];
      n_out = want < cap - o ? want : cap - o;
      const int64_t body = kwk && n_out > prev_len ? prev_len : n_out;
      std::memcpy(out + o, out + from, static_cast<size_t>(body));
      if (body < n_out) out[o + body] = out[prev_pos];
    }
    o += n_out;
    if (prev_pos >= 0 && next < kMaxCodes) {
      pos[next] = static_cast<uint32_t>(prev_pos);
      len[next] = static_cast<uint32_t>(prev_len + 1);
      ++next;
      if (next >= (1 << width) - 1 && width < 12) ++width;
    }
    prev_pos = start;
    prev_len = n_out;
  }
  return o == cap ? 0 : 1;
}

}  // namespace

// Decode `n` strips of `buf`: strip k is buf[src_off[k] : src_off[k] +
// src_len[k]] and fills dst[dst_off[k] : dst_off[k] + dst_len[k]].  The
// caller checks every span.  Returns 0, or k + 1 for the first strip that
// is malformed or decodes to fewer bytes than dst_len[k].
extern "C" int ecseg_lzw_decode_strips(const uint8_t* buf, int n,
                                       const int64_t* src_off,
                                       const int64_t* src_len, uint8_t* dst,
                                       const int64_t* dst_off,
                                       const int64_t* dst_len) {
  for (int k = 0; k < n; ++k) {
    if (decode_strip(buf + src_off[k], src_len[k], dst + dst_off[k], dst_len[k])) return k + 1;
  }
  return 0;
}
