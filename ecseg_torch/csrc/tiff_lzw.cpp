// TIFF LZW strip decoder and encoder (compression 5), host C++ with a plain
// C interface, built by ecseg_torch/_build.py with the system C++ compiler
// and loaded with ctypes by ecseg_torch/core/imgio.py.
//
// The reference writes its TIFFs with LZW by default, and the JAX package
// reads them through OpenCV's libtiff; the port decodes them itself so that
// it runs where OpenCV is not installed.  A Python loop takes seconds for a
// 2048^2 uint16 file, so the decode is here; so is the encode that
// ECSEG_TIF_LZW=1 selects for the pipelines' TIFF outputs.
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
//
// The encoder emits the codes libtiff's LZWEncode/LZWPostEncode emit
// (tif_lzw.c), so a strip's bytes equal those OpenCV writes: a clear code
// first; a new table entry for every code emitted; the table cleared (a
// clear code at the current width) when it reaches 4094 entries, or at a
// check every 10000 input bytes or more where the compression ratio (input
// bytes * 256 / output bits since the last clear) did not rise since the
// previous check; the last string's code, then the end code.  The lookup
// is libtiff's open-addressed hash (9001 slots, xor hashing, secondary
// probe by 9001 - h); a string's code does not depend on how it is found,
// so only the table's size and speed follow libtiff.

#include <cstdint>
#include <cstring>

namespace {

constexpr int kClear = 256;
constexpr int kEnd = 257;
constexpr int kFirst = 258;
constexpr int kMaxCodes = 4096;
constexpr int kMaxCode = kMaxCodes - 1;  // libtiff's CODE_MAX
constexpr int kCheckGap = 10000;
constexpr int kHashSize = 9001;
constexpr int kHashShift = 5;  // libtiff's HSHIFT

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

// Most-significant-bit-first code writer, as libtiff's PutNextCode.
struct CodeWriter {
  uint8_t* out;
  int64_t o = 0;
  uint64_t data = 0;
  int bits = 0;
  int64_t outcount = 0;  // bits since the last clear (the ratio's divisor)
  void put(int code, int width) {
    data = (data << width) | static_cast<uint64_t>(code);
    bits += width;
    while (bits >= 8) {
      bits -= 8;
      out[o++] = static_cast<uint8_t>(data >> bits);
    }
    data &= (uint64_t{1} << bits) - 1;
    outcount += width;
  }
  void flush() {
    if (bits > 0) out[o++] = static_cast<uint8_t>(data << (8 - bits));
  }
};

// One strip of `n` > 0 bytes; returns the bytes written to `out`, which
// holds at least 2 * n + 64 (at most one 12-bit code an input byte, and a
// clear code at most every 3837 codes or 10000 input bytes).
int64_t encode_strip(const uint8_t* src, int64_t n, uint8_t* out) {
  static thread_local int32_t hash[kHashSize];
  static thread_local uint16_t code_of[kHashSize];
  auto clear_hash = [] {
    for (int i = 0; i < kHashSize; ++i) hash[i] = -1;
  };
  clear_hash();
  CodeWriter w{out};
  int width = 9, maxcode = 511, next = kFirst;
  int64_t incount = 0, checkpoint = kCheckGap, ratio = 0;
  w.put(kClear, width);
  int ent = src[0];
  incount = 1;
  for (int64_t i = 1; i < n; ++i) {
    const int c = src[i];
    ++incount;
    const int32_t fcode = (c << 12) + ent;
    int h = (c << kHashShift) ^ ent;
    if (hash[h] == fcode) {
      ent = code_of[h];
      continue;
    }
    if (hash[h] >= 0) {
      const int disp = h == 0 ? 1 : kHashSize - h;
      bool found = false;
      do {
        if ((h -= disp) < 0) h += kHashSize;
        if (hash[h] == fcode) {
          found = true;
          break;
        }
      } while (hash[h] >= 0);
      if (found) {
        ent = code_of[h];
        continue;
      }
    }
    w.put(ent, width);
    ent = c;
    code_of[h] = static_cast<uint16_t>(next++);
    hash[h] = fcode;
    bool reset = false;
    if (next == kMaxCode - 1) {
      reset = true;
    } else if (next > maxcode) {
      ++width;
      maxcode = (1 << width) - 1;
    } else if (incount >= checkpoint) {
      checkpoint = incount + kCheckGap;
      int64_t rat;
      if (incount > 0x007fffff) {
        rat = w.outcount >> 8;
        rat = rat == 0 ? 0x7fffffff : incount / rat;
      } else {
        rat = (incount << 8) / w.outcount;
      }
      if (rat <= ratio) {
        reset = true;
      } else {
        ratio = rat;
      }
    }
    if (reset) {
      clear_hash();
      ratio = 0;
      incount = 0;
      w.outcount = 0;
      next = kFirst;
      w.put(kClear, width);
      width = 9;
      maxcode = 511;
    }
  }
  w.put(ent, width);
  if (++next == kMaxCode - 1) {
    w.put(kClear, width);
    width = 9;
  } else if (next > maxcode) {
    ++width;
  }
  w.put(kEnd, width);
  w.flush();
  return w.o;
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

// Encode `n` strips: strip k is src[src_off[k] : src_off[k] + src_len[k]]
// (src_len[k] > 0) and is written to dst[dst_off[k] :], which holds
// 2 * src_len[k] + 64 bytes; its encoded length goes to dst_len[k].
extern "C" void ecseg_lzw_encode_strips(const uint8_t* src, int n,
                                        const int64_t* src_off,
                                        const int64_t* src_len, uint8_t* dst,
                                        const int64_t* dst_off,
                                        int64_t* dst_len) {
  for (int k = 0; k < n; ++k) {
    dst_len[k] = encode_strip(src + src_off[k], src_len[k], dst + dst_off[k]);
  }
}
