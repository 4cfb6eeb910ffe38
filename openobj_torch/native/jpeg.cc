// Baseline JPEG entropy decoding: one scan's Huffman-coded data into int16
// coefficient blocks per component (natural order, not yet dequantised).
//
// Called through ctypes by openobj_torch.utils.jpeg, which parses the
// markers, dequantises, runs the IDCT, upsamples and converts colour. The
// decoder follows ITU-T T.81 Annex F (sequential Huffman): DC prediction per
// component, AC run lengths with ZRL and EOB, 0xFF00 byte stuffing, 0xFF fill
// bytes before markers, and restart markers (after every restart interval
// of MCUs the bit reader is byte-aligned, the RSTn marker checked and the DC
// predictors reset). Unlike libjpeg it never pads corrupt data with zeros:
// any inconsistency returns a negative code.

#include <cstdint>
#include <cstring>

namespace {

enum : int {
  kOk = 0,
  kTruncated = -1,      // bits needed past a marker or the end of the data
  kBadCode = -2,        // no Huffman code of length <= 16 matches
  kBadCoefIndex = -3,   // an AC run past coefficient 63
  kBadRestart = -4,     // restart marker missing, out of order, or data before it
  kBadTable = -5,       // a Huffman table that is not a valid canonical code
  kBadArgs = -6,
  kExtraData = -7,      // whole bytes of entropy data left after the last MCU
};

// jpeg_natural_order: zigzag index -> natural (row-major) index
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kLookBits = 9;

struct Huff {
  int32_t maxcode[18];   // largest code of each length, -1 if none
  int32_t valoffset[17]; // symbol index of a code: code + valoffset[len]
  uint8_t vals[256];
  uint16_t look[1 << kLookBits];   // (len << 8) | symbol, 0 if longer
};

int build_huff(const uint8_t* bits, const uint8_t* vals, Huff* h) {
  int count = 0;
  for (int l = 0; l < 16; ++l) count += bits[l];
  if (count > 256) return kBadTable;
  std::memcpy(h->vals, vals, 256);
  std::memset(h->look, 0, sizeof(h->look));
  int32_t code = 0;
  int k = 0;
  for (int l = 1; l <= 16; ++l) {
    int n = bits[l - 1];
    h->valoffset[l] = k - code;
    if (n) {
      for (int i = 0; i < n; ++i, ++k, ++code) {
        if (l <= kLookBits) {
          int shift = kLookBits - l;
          for (int f = 0; f < (1 << shift); ++f)
            h->look[(code << shift) | f] = (uint16_t)((l << 8) | vals[k]);
        }
      }
      h->maxcode[l] = code - 1;
      if (code >= (1 << l)) return kBadTable;  // overflow, or an all-ones code
    } else {
      h->maxcode[l] = -1;
    }
    code <<= 1;
  }
  h->maxcode[17] = 0x7fffffff;
  return kOk;
}

struct Bits {
  const uint8_t* d;
  int64_t n;
  int64_t pos;       // next byte to read; at a marker's 0xFF once one is hit
  uint64_t acc;      // valid bits left-aligned
  int bits;
  bool marker;       // a marker (or the end of the data) stops the reader

  void fill() {
    while (bits <= 56 && !marker) {
      if (pos >= n) { marker = true; break; }
      uint8_t b = d[pos];
      if (b == 0xFF) {
        if (pos + 1 >= n || d[pos + 1] != 0x00) { marker = true; break; }
        pos += 2;                          // stuffed 0xFF
      } else {
        pos += 1;
      }
      acc |= (uint64_t)b << (56 - bits);
      bits += 8;
    }
  }

  // k in 0..16
  inline int get(int k, int* err) {
    if (k == 0) return 0;
    if (bits < k) {
      fill();
      if (bits < k) { *err = kTruncated; return 0; }
    }
    int v = (int)(acc >> (64 - k));
    acc <<= k;
    bits -= k;
    return v;
  }

  inline int decode(const Huff& h, int* err) {
    if (bits < 16) fill();
    int peek = (int)(acc >> (64 - kLookBits));
    uint16_t e = h.look[peek];
    if (e) {
      int l = e >> 8;
      if (l > bits) { *err = kTruncated; return 0; }
      acc <<= l;
      bits -= l;
      return e & 0xFF;
    }
    // longer than kLookBits: walk the lengths
    if (bits < kLookBits) { *err = kTruncated; return 0; }
    int code = (int)(acc >> (64 - kLookBits));
    int l = kLookBits;
    acc <<= kLookBits;
    bits -= kLookBits;
    while (code > h.maxcode[l]) {
      if (l >= 16) { *err = kBadCode; return 0; }
      if (bits < 1) { *err = kTruncated; return 0; }
      code = (code << 1) | (int)(acc >> 63);
      acc <<= 1;
      bits -= 1;
      ++l;
    }
    int idx = code + h.valoffset[l];
    if (idx < 0 || idx > 255) { *err = kBadCode; return 0; }
    return h.vals[idx];
  }

  // drop the rest of the current byte; true if no whole byte is left over
  bool align() {
    int r = bits & 7;
    acc <<= r;
    bits -= r;
    return bits == 0;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

}  // namespace

extern "C" {

// Decode the entropy-coded data of one scan that starts at data[start].
//   ncomp:        components in the scan (1..4)
//   params:       per component {mcu_h, mcu_v, blocks_w, dc_table, ac_table}:
//                 blocks per MCU across and down (1, 1 in a non-interleaved
//                 scan), the row length of its block buffer, table slots 0..3
//   huff_bits:    [8][16] BITS of DC tables 0..3 then AC tables 0..3
//   huff_vals:    [8][256] HUFFVAL likewise
//   mcus_x/y:     MCUs across and down the scan
//   restart:      restart interval in MCUs (0: none)
//   coefs:        per component, [rows][blocks_w][64] int16, zeroed
//   end:          out: offset of the marker that ends the scan
// Returns 0 or a negative error code.
int jpeg_decode_scan(const uint8_t* data, int64_t n, int64_t start, int ncomp,
                     const int32_t* params, const uint8_t* huff_bits,
                     const uint8_t* huff_vals, int64_t mcus_x, int64_t mcus_y,
                     int64_t restart, int16_t** coefs, int64_t* end) {
  if (ncomp < 1 || ncomp > 4 || start < 0 || start > n || mcus_x < 1 || mcus_y < 1)
    return kBadArgs;
  Huff tables[8];
  bool used[8] = {false};
  for (int c = 0; c < ncomp; ++c) {
    int dc = params[c * 5 + 3], ac = params[c * 5 + 4];
    if (dc < 0 || dc > 3 || ac < 0 || ac > 3) return kBadArgs;
    used[dc] = true;
    used[4 + ac] = true;
  }
  for (int t = 0; t < 8; ++t) {
    if (!used[t]) continue;
    int r = build_huff(huff_bits + 16 * t, huff_vals + 256 * t, &tables[t]);
    if (r) return r;
  }

  Bits br{data, n, start, 0, 0, false};
  int pred[4] = {0, 0, 0, 0};
  int err = 0;
  int64_t total = mcus_x * mcus_y;
  int rst_no = 0;
  for (int64_t m = 0; m < total; ++m) {
    if (restart > 0 && m > 0 && m % restart == 0) {
      if (!br.align()) return kBadRestart;
      // the reader stopped at a marker: 0xFF fill bytes, then RSTn
      int64_t p = br.pos;
      while (p < n && data[p] == 0xFF) ++p;
      if (p >= n || p == br.pos || data[p] != 0xD0 + rst_no) return kBadRestart;
      rst_no = (rst_no + 1) & 7;
      br.pos = p + 1;
      br.marker = false;
      br.acc = 0;
      br.bits = 0;
      pred[0] = pred[1] = pred[2] = pred[3] = 0;
    }
    int64_t my = m / mcus_x, mx = m % mcus_x;
    for (int c = 0; c < ncomp; ++c) {
      const int32_t* pc = params + c * 5;
      int mh = pc[0], mv = pc[1];
      int64_t bw = pc[2];
      const Huff& dct = tables[pc[3]];
      const Huff& act = tables[4 + pc[4]];
      for (int v = 0; v < mv; ++v) {
        for (int h = 0; h < mh; ++h) {
          int64_t by = my * mv + v, bx = mx * mh + h;
          int16_t* blk = coefs[c] + (by * bw + bx) * 64;
          int s = br.decode(dct, &err);
          if (err) return err;
          if (s > 16) return kBadCode;
          int diff = s ? extend(br.get(s, &err), s) : 0;
          if (err) return err;
          pred[c] += diff;
          blk[0] = (int16_t)pred[c];
          for (int k = 1; k < 64; ++k) {
            int rs = br.decode(act, &err);
            if (err) return err;
            int r = rs >> 4;
            s = rs & 15;
            if (s) {
              k += r;
              if (k > 63) return kBadCoefIndex;
              int v2 = br.get(s, &err);
              if (err) return err;
              blk[kNatural[k]] = (int16_t)extend(v2, s);
            } else {
              if (r != 15) break;   // EOB
              k += 15;              // ZRL
            }
          }
        }
      }
    }
  }
  if (!br.align()) return kExtraData;
  br.fill();                        // no-op unless nothing was read at all
  if (br.bits) return kExtraData;
  *end = br.pos;
  return kOk;
}

}  // extern "C"
