// JPEG entropy decoding: one scan's coded data into int16 coefficient
// blocks per component (natural order, not yet dequantised), for
// sequential (baseline, extended) and progressive files, Huffman- or
// arithmetic-coded; and one lossless scan into sample planes.
//
// Called through ctypes by openobj_torch.utils.jpeg, which parses the
// markers, dequantises, runs the IDCT, upsamples and converts colour. The
// decoder follows ITU-T T.81 Annex F (sequential Huffman): DC prediction per
// component, AC run lengths with ZRL and EOB, 0xFF00 byte stuffing, 0xFF fill
// bytes before markers, and restart markers (after every restart interval
// of MCUs the bit reader is byte-aligned, the RSTn marker checked and the DC
// predictors reset). Progressive scans (T.81 G.1.2, jpeg_decode_prog_scan)
// follow libjpeg-turbo's jdphuff.c: DC first and refinement scans, which
// may be interleaved, and AC first and refinement scans of one component,
// with spectral selection (Ss..Se), successive approximation (Ah/Al),
// end-of-band runs that carry across blocks until a restart marker, and
// the refinement scans' correction bits. Each scan adds into the blocks the
// earlier scans left. Arithmetic-coded scans (T.81 Annex D and F.1.4,
// G.1.3; jpeg_decode_arith_scan) follow libjpeg-turbo's jdarith.c: the
// QM-coder with its probability-estimation table, the DC and AC statistics
// bins, the DAC conditioning values, and the statistics and coder reset at
// every restart marker. Lossless scans (T.81 Annex H, jpeg_decode_lossless_scan)
// follow libjpeg-turbo 3's jdlhuff.c, jddiffct.c and jdlossls.c: Huffman-coded
// differences, predictors 1-7, the first row of a scan or restart interval
// predicted from its left neighbour (its first sample from 2^(P-Pt-1)), the
// first sample of a later row from the one above it. Unlike libjpeg the
// Huffman decoders never pad corrupt data with zeros: any inconsistency
// returns a negative code. An arithmetic-coded scan reads zeros past the
// marker that ends its data, as T.81 D.2.6 has it.

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
  kBadDc = -8,          // a DC value that overflows its accumulator
  kBadArith = -9,       // arithmetic-coded data libjpeg gives up on (JWRN_ARITH_BAD_CODE)
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

// After a restart interval: drop the rest of the byte, check the RSTn marker
// (after any 0xFF fill bytes) and restart the reader behind it.
int restart_marker(Bits& br, int* rst_no) {
  if (!br.align()) return kBadRestart;
  int64_t p = br.pos;
  while (p < br.n && br.d[p] == 0xFF) ++p;
  if (p >= br.n || p == br.pos || br.d[p] != 0xD0 + *rst_no) return kBadRestart;
  *rst_no = (*rst_no + 1) & 7;
  br.pos = p + 1;
  br.marker = false;
  br.acc = 0;
  br.bits = 0;
  return kOk;
}

// pred += diff, refused where libjpeg refuses it (JERR_BAD_DCT_COEF)
inline bool add_dc(int* pred, int diff) {
  if ((*pred >= 0 && diff > INT32_MAX - *pred) || (*pred < 0 && diff < INT32_MIN - *pred))
    return false;
  *pred += diff;
  return true;
}

// The end of a scan: no whole byte of entropy-coded data left over.
int scan_end(Bits& br, int64_t* end) {
  if (!br.align()) return kExtraData;
  br.fill();                        // no-op unless nothing was read at all
  if (br.bits) return kExtraData;
  *end = br.pos;
  return kOk;
}

// Build the tables of slots marked in used[8] (DC 0-3, then AC 0-3).
int build_tables(const bool* used, const uint8_t* huff_bits, const uint8_t* huff_vals,
                 Huff* tables) {
  for (int t = 0; t < 8; ++t) {
    if (!used[t]) continue;
    int r = build_huff(huff_bits + 16 * t, huff_vals + 256 * t, &tables[t]);
    if (r) return r;
  }
  return kOk;
}

// T.81 Table D.2 as libjpeg-turbo's jaricom.c packs it: Qe << 16 |
// Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS. The last entry is
// the fixed probability 0.5 (T.851) that signs and refinement bits use.
#define V(qe, lps, mps, sw) (((int64_t)(qe) << 16) | ((mps) << 8) | ((sw) << 7) | (lps))
const int64_t kAritab[114] = {
    V(0x5a1d, 1, 1, 1),     V(0x2586, 14, 2, 0),    V(0x1114, 16, 3, 0),
    V(0x080b, 18, 4, 0),    V(0x03d8, 20, 5, 0),    V(0x01da, 23, 6, 0),
    V(0x00e5, 25, 7, 0),    V(0x006f, 28, 8, 0),    V(0x0036, 30, 9, 0),
    V(0x001a, 33, 10, 0),   V(0x000d, 35, 11, 0),   V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0),   V(0x0001, 12, 13, 0),   V(0x5a7f, 15, 15, 1),
    V(0x3f25, 36, 16, 0),   V(0x2cf2, 38, 17, 0),   V(0x207c, 39, 18, 0),
    V(0x17b9, 40, 19, 0),   V(0x1182, 42, 20, 0),   V(0x0cef, 43, 21, 0),
    V(0x09a1, 45, 22, 0),   V(0x072f, 46, 23, 0),   V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0),   V(0x0303, 51, 26, 0),   V(0x0240, 52, 27, 0),
    V(0x01b1, 54, 28, 0),   V(0x0144, 56, 29, 0),   V(0x00f5, 57, 30, 0),
    V(0x00b7, 59, 31, 0),   V(0x008a, 60, 32, 0),   V(0x0068, 62, 33, 0),
    V(0x004e, 63, 34, 0),   V(0x003b, 32, 35, 0),   V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1),   V(0x484c, 64, 38, 0),   V(0x3a0d, 65, 39, 0),
    V(0x2ef1, 67, 40, 0),   V(0x261f, 68, 41, 0),   V(0x1f33, 69, 42, 0),
    V(0x19a8, 70, 43, 0),   V(0x1518, 72, 44, 0),   V(0x1177, 73, 45, 0),
    V(0x0e74, 74, 46, 0),   V(0x0bfb, 75, 47, 0),   V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0),   V(0x0706, 79, 50, 0),   V(0x05cd, 48, 51, 0),
    V(0x04de, 50, 52, 0),   V(0x040f, 50, 53, 0),   V(0x0363, 51, 54, 0),
    V(0x02d4, 52, 55, 0),   V(0x025c, 53, 56, 0),   V(0x01f8, 54, 57, 0),
    V(0x01a4, 55, 58, 0),   V(0x0160, 56, 59, 0),   V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0),   V(0x00cb, 59, 62, 0),   V(0x00ab, 61, 63, 0),
    V(0x008f, 61, 32, 0),   V(0x5b12, 65, 65, 1),   V(0x4d04, 80, 66, 0),
    V(0x412c, 81, 67, 0),   V(0x37d8, 82, 68, 0),   V(0x2fe8, 83, 69, 0),
    V(0x293c, 84, 70, 0),   V(0x2379, 86, 71, 0),   V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0),   V(0x174e, 72, 74, 0),   V(0x1424, 72, 75, 0),
    V(0x119c, 74, 76, 0),   V(0x0f6b, 74, 77, 0),   V(0x0d51, 75, 78, 0),
    V(0x0bb6, 77, 79, 0),   V(0x0a40, 77, 48, 0),   V(0x5832, 80, 81, 1),
    V(0x4d1c, 88, 82, 0),   V(0x438e, 89, 83, 0),   V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0),   V(0x2eae, 92, 86, 0),   V(0x299a, 93, 87, 0),
    V(0x2516, 86, 71, 0),   V(0x5570, 88, 89, 1),   V(0x4ca9, 95, 90, 0),
    V(0x44d9, 96, 91, 0),   V(0x3e22, 97, 92, 0),   V(0x3824, 99, 93, 0),
    V(0x32b4, 99, 94, 0),   V(0x2e17, 93, 86, 0),   V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0),  V(0x47e5, 102, 98, 0),  V(0x41cf, 103, 99, 0),
    V(0x3c3d, 104, 100, 0), V(0x375e, 99, 93, 0),   V(0x5231, 105, 102, 0),
    V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0), V(0x415e, 103, 99, 0),
    V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1),
    V(0x5522, 112, 109, 0), V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0)};
#undef V

constexpr int kDcBins = 64, kAcBins = 256, kArithTables = 16;

// jdarith.c's decoder state: C holds the base of the interval and the bits
// read ahead of it, CT counts those bits (-16 before the first two bytes).
struct Arith {
  const uint8_t* d;
  int64_t n;
  int64_t pos;          // next byte to read
  int64_t c = 0, a = 0;
  int ct = -16;
  int64_t marker_at = -1;   // offset of the marker the coder ran into, -1 if none
  int marker = 0;           // its code (-1: the end of the data)

  // The next byte of coded data: 0xFF00 is 0xFF, fill bytes are skipped, and
  // from a marker on the coder reads zeros (T.81 D.2.6).
  int byte() {
    if (marker_at >= 0) return 0;
    if (pos >= n) {
      marker_at = n;
      marker = -1;
      return 0;
    }
    int v = d[pos++];
    if (v != 0xFF) return v;
    int64_t at = pos - 1;
    do {
      if (pos >= n) {
        marker_at = at;
        marker = -1;
        return 0;
      }
      v = d[pos++];
    } while (v == 0xFF);
    if (v == 0) return 0xFF;
    marker_at = at;
    marker = v;
    return 0;
  }

  // One binary decision with the statistics bin *st (T.81 D.2.4-D.2.6).
  inline int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;   // two bytes in: A is 0x10000 below
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    int nl = (int)(qe & 0xFF);
    qe >>= 8;
    int nm = (int)(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {                     // conditional exchange: the MPS after all
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // After a restart interval: the RSTn marker, which the coder may have read
  // already; bytes the coder left before it are skipped, as libjpeg skips
  // them. The coder starts afresh behind it.
  int restart(int* rst_no) {
    if (marker_at < 0) {
      int64_t p = pos;
      for (;;) {
        while (p < n && d[p] != 0xFF) ++p;
        int64_t q = p;
        while (q < n && d[q] == 0xFF) ++q;
        if (q >= n) return kBadRestart;
        if (d[q] != 0) {
          marker = d[q];
          pos = q + 1;
          break;
        }
        p = q + 1;
      }
    }
    if (marker != 0xD0 + *rst_no) return kBadRestart;
    *rst_no = (*rst_no + 1) & 7;
    marker_at = -1;
    marker = 0;
    c = a = 0;
    ct = -16;
    return kOk;
  }
};

// A value of the DC difference or an AC coefficient once its nonzero
// decision is made (T.81 F.1.4.4.1.2-3, Figures F.21-F.24): the magnitude
// category from the bins at *st (SP/SN) then at x (X1, X2, ...), the bits
// below the top one from the bins 14 past the last X bin. Returns false on a
// magnitude past 2^15. *st_out is left at the bin after the category.
inline bool arith_magnitude(Arith& ar, uint8_t* st, uint8_t* x, int second, int* m_out,
                            uint8_t** st_out) {
  int m = ar.decode(st);
  if (m != 0 && (!second || ar.decode(st))) {
    if (second) m <<= 1;
    st = x;
    while (ar.decode(st)) {
      if ((m <<= 1) == 0x8000) return false;
      st += 1;
    }
  }
  *m_out = m;
  *st_out = st;
  return true;
}

inline int arith_bits(Arith& ar, uint8_t* st, int m) {
  int v = m;
  st += 14;
  while (m >>= 1)
    if (ar.decode(st)) v |= m;
  return v + 1;
}

// A DC difference (Figure F.19), the component's conditioning category
// updated from it (F.1.4.4.1.2, with the DAC bounds L and U).
inline int arith_dc(Arith& ar, uint8_t* stats, int* context, int L, int U, int* err) {
  uint8_t* st = stats + *context;
  if (ar.decode(st) == 0) {
    *context = 0;
    return 0;
  }
  int sign = ar.decode(st + 1);
  st += 2 + sign;
  int m;
  if (!arith_magnitude(ar, st, stats + 20, 0, &m, &st)) {
    *err = kBadArith;
    return 0;
  }
  if (m < ((1 << L) >> 1))
    *context = 0;
  else if (m > ((1 << U) >> 1))
    *context = 12 + sign * 4;
  else
    *context = 4 + sign * 4;
  int v = arith_bits(ar, st, m);
  return sign ? -v : v;
}

// The AC coefficients Ss..Se of a block, first scan (Figure F.20): EOB
// decisions, runs of zeros, each value scaled by 2^Al.
inline int arith_ac_first(Arith& ar, uint8_t* stats, uint8_t* fixed, int K, int ss, int se,
                          int al, int16_t* blk) {
  for (int k = ss; k <= se; k++) {
    uint8_t* st = stats + 3 * (k - 1);
    if (ar.decode(st)) break;                     // EOB
    while (ar.decode(st + 1) == 0) {
      st += 3;
      if (++k > se) return kBadArith;             // spectral overflow
    }
    int sign = ar.decode(fixed);
    st += 2;
    int m;
    if (!arith_magnitude(ar, st, stats + (k <= K ? 189 : 217), 1, &m, &st)) return kBadArith;
    int v = arith_bits(ar, st, m);
    if (sign) v = -v;
    blk[kNatural[k]] = (int16_t)((uint32_t)v << al);
  }
  return kOk;
}

// The AC refinement of a block (G.1.3.3): a correction bit for each
// coefficient already nonzero, new coefficients of +-2^Al, EOB decisions
// only past the last coefficient nonzero before this scan.
inline int arith_ac_refine(Arith& ar, uint8_t* stats, uint8_t* fixed, int ss, int se, int al,
                           int16_t* blk) {
  const int p1 = 1 << al, m1 = -(1 << al);
  int kex = se;
  for (; kex > 0; kex--)
    if (blk[kNatural[kex]]) break;
  for (int k = ss; k <= se; k++) {
    uint8_t* st = stats + 3 * (k - 1);
    if (k > kex && ar.decode(st)) break;          // EOB
    for (;;) {
      int16_t* t = blk + kNatural[k];
      if (*t) {
        if (ar.decode(st + 2)) *t = (int16_t)(*t + (*t < 0 ? m1 : p1));
        break;
      }
      if (ar.decode(st + 1)) {
        *t = (int16_t)(ar.decode(fixed) ? m1 : p1);
        break;
      }
      st += 3;
      if (++k > se) return kBadArith;             // spectral overflow
    }
  }
  return kOk;
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
  if (int r = build_tables(used, huff_bits, huff_vals, tables)) return r;

  Bits br{data, n, start, 0, 0, false};
  int pred[4] = {0, 0, 0, 0};
  int err = 0;
  int64_t total = mcus_x * mcus_y;
  int rst_no = 0;
  for (int64_t m = 0; m < total; ++m) {
    if (restart > 0 && m > 0 && m % restart == 0) {
      if (int r = restart_marker(br, &rst_no)) return r;
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
          if (!add_dc(&pred[c], diff)) return kBadDc;
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
  return scan_end(br, end);
}

// Decode one scan of a progressive file (T.81 G.1.2), as libjpeg-turbo's
// jdphuff.c decodes it, into the blocks the earlier scans left:
//   spectral:     {Ss, Se, Ah, Al}: Ss == 0 is a DC scan (Se == 0), which may
//                 be interleaved; otherwise an AC scan of one component
//                 (mcu_h = mcu_v = 1) over zigzag Ss..Se. Ah == 0 is a first
//                 scan, Ah == Al + 1 a refinement of bit Al.
// The other arguments are jpeg_decode_scan's; a DC refinement uses no
// table, an AC scan only its AC slot, a DC first scan only its DC slots.
int jpeg_decode_prog_scan(const uint8_t* data, int64_t n, int64_t start, int ncomp,
                          const int32_t* params, const uint8_t* huff_bits,
                          const uint8_t* huff_vals, int64_t mcus_x, int64_t mcus_y,
                          int64_t restart, const int32_t* spectral, int16_t** coefs,
                          int64_t* end) {
  const int ss = spectral[0], se = spectral[1], ah = spectral[2], al = spectral[3];
  const bool dc = ss == 0;
  if (ncomp < 1 || ncomp > 4 || start < 0 || start > n || mcus_x < 1 || mcus_y < 1)
    return kBadArgs;
  // jdphuff.c's start_pass_phuff_decoder (JERR_BAD_PROGRESSION)
  if (dc ? se != 0 : (ss > se || se > 63 || ncomp != 1)) return kBadArgs;
  if ((ah != 0 && al != ah - 1) || al < 0 || al > 13) return kBadArgs;
  Huff tables[8];
  bool used[8] = {false};
  for (int c = 0; c < ncomp; ++c) {
    int dct = params[c * 5 + 3], act = params[c * 5 + 4];
    if (dct < 0 || dct > 3 || act < 0 || act > 3) return kBadArgs;
    if (!dc && (params[c * 5] != 1 || params[c * 5 + 1] != 1)) return kBadArgs;
    if (dc && ah == 0) used[dct] = true;
    if (!dc) used[4 + act] = true;
  }
  if (int r = build_tables(used, huff_bits, huff_vals, tables)) return r;

  const int p1 = 1 << al;            // 1 in the bit being coded
  const int m1 = -(1 << al);         // -1 in the bit being coded
  Bits br{data, n, start, 0, 0, false};
  int pred[4] = {0, 0, 0, 0};
  int eobrun = 0;
  int err = 0;
  const int64_t total = mcus_x * mcus_y;
  int rst_no = 0;
  // a correction bit: |coefficient| grows by p1 unless that bit is set already
  auto correct = [&](int16_t* t) {
    if (br.get(1, &err) && (*t & p1) == 0) *t = (int16_t)(*t + (*t >= 0 ? p1 : m1));
  };
  for (int64_t m = 0; m < total; ++m) {
    if (restart > 0 && m > 0 && m % restart == 0) {
      if (int r = restart_marker(br, &rst_no)) return r;
      pred[0] = pred[1] = pred[2] = pred[3] = 0;
      eobrun = 0;
    }
    const int64_t my = m / mcus_x, mx = m % mcus_x;
    for (int c = 0; c < ncomp; ++c) {
      const int32_t* pc = params + c * 5;
      const int mh = pc[0], mv = pc[1];
      const int64_t bw = pc[2];
      for (int v = 0; v < mv; ++v) {
        for (int h = 0; h < mh; ++h) {
          int16_t* blk = coefs[c] + ((my * mv + v) * bw + mx * mh + h) * 64;
          if (dc && ah == 0) {                 // decode_mcu_DC_first
            int s = br.decode(tables[pc[3]], &err);
            if (err) return err;
            if (s > 15) return kBadCode;
            int diff = s ? extend(br.get(s, &err), s) : 0;
            if (err) return err;
            if (!add_dc(&pred[c], diff)) return kBadDc;
            blk[0] = (int16_t)((uint32_t)pred[c] << al);
          } else if (dc) {                     // decode_mcu_DC_refine
            if (br.get(1, &err)) blk[0] = (int16_t)(blk[0] | p1);
            if (err) return err;
          } else if (ah == 0) {                // decode_mcu_AC_first
            if (eobrun > 0) {
              --eobrun;
              continue;
            }
            const Huff& act = tables[4 + pc[4]];
            for (int k = ss; k <= se; ++k) {
              int rs = br.decode(act, &err);
              if (err) return err;
              int r = rs >> 4, s = rs & 15;
              if (s) {
                k += r;
                if (k > se) return kBadCoefIndex;
                int v2 = br.get(s, &err);
                if (err) return err;
                blk[kNatural[k]] = (int16_t)((uint32_t)extend(v2, s) << al);
              } else if (r == 15) {
                k += 15;                       // ZRL
              } else {                         // EOBr: 2^r + r more bits blocks
                eobrun = 1 << r;
                if (r) eobrun += br.get(r, &err);
                if (err) return err;
                --eobrun;                      // this block
                break;
              }
            }
          } else {                             // decode_mcu_AC_refine
            const Huff& act = tables[4 + pc[4]];
            int k = ss;
            if (eobrun == 0) {
              for (; k <= se; ++k) {
                int rs = br.decode(act, &err);
                if (err) return err;
                int r = rs >> 4, s = rs & 15;
                if (s) {
                  // the size of a new coefficient is always 1 (libjpeg warns
                  // otherwise and reads the one sign bit all the same)
                  s = br.get(1, &err) ? p1 : m1;
                  if (err) return err;
                } else if (r != 15) {
                  eobrun = 1 << r;
                  if (r) eobrun += br.get(r, &err);
                  if (err) return err;
                  break;                       // the rest is the EOB run's
                }
                // over the nonzero coefficients (a correction bit each) and
                // r zero ones, to the zero one that becomes nonzero
                do {
                  int16_t* t = blk + kNatural[k];
                  if (*t != 0) {
                    correct(t);
                    if (err) return err;
                  } else if (--r < 0) {
                    break;
                  }
                  ++k;
                } while (k <= se);
                if (s) {
                  if (k > se) return kBadCoefIndex;
                  blk[kNatural[k]] = (int16_t)s;
                }
              }
            }
            if (eobrun > 0) {                  // a block of the EOB run
              for (; k <= se; ++k) {
                int16_t* t = blk + kNatural[k];
                if (*t != 0) {
                  correct(t);
                  if (err) return err;
                }
              }
              --eobrun;
            }
          }
        }
      }
    }
  }
  return scan_end(br, end);
}

// Decode one arithmetic-coded scan (SOF9 sequential, SOF10 progressive) as
// libjpeg-turbo's jdarith.c decodes it:
//   params:       per component {mcu_h, mcu_v, blocks_w, dc_table, ac_table},
//                 as for jpeg_decode_scan, table slots 0..15
//   cond:         [3][16] the DAC conditioning values in force: L and U of
//                 each DC table, Kx of each AC table
//   spectral:     {Ss, Se, Ah, Al} of a progressive scan, or null for a
//                 sequential one (which fills zeroed blocks)
//   end:          out: offset where the coder stopped (the marker it ran
//                 into, else the byte after the last one it read)
int jpeg_decode_arith_scan(const uint8_t* data, int64_t n, int64_t start, int ncomp,
                           const int32_t* params, const int32_t* cond, int64_t mcus_x,
                           int64_t mcus_y, int64_t restart, const int32_t* spectral,
                           int16_t** coefs, int64_t* end) {
  if (ncomp < 1 || ncomp > 4 || start < 0 || start > n || mcus_x < 1 || mcus_y < 1)
    return kBadArgs;
  const bool prog = spectral != nullptr;
  const int ss = prog ? spectral[0] : 0, se = prog ? spectral[1] : 63;
  const int ah = prog ? spectral[2] : 0, al = prog ? spectral[3] : 0;
  if (prog) {
    if (ss == 0 ? se != 0 : (ss > se || se > 63 || ncomp != 1)) return kBadArgs;
    if ((ah != 0 && al != ah - 1) || al < 0 || al > 13) return kBadArgs;
  }
  const bool dc_first = ss == 0 && ah == 0, uses_ac = !prog || ss != 0;
  for (int c = 0; c < ncomp; ++c) {
    const int32_t* pc = params + c * 5;
    if (pc[3] < 0 || pc[3] >= kArithTables || pc[4] < 0 || pc[4] >= kArithTables) return kBadArgs;
    if (prog && ss != 0 && (pc[0] != 1 || pc[1] != 1)) return kBadArgs;
    if (dc_first && (cond[pc[3]] < 0 || cond[pc[3]] > cond[16 + pc[3]] || cond[16 + pc[3]] > 15))
      return kBadArgs;
  }
  uint8_t dc_stats[kArithTables][kDcBins], ac_stats[kArithTables][kAcBins];
  uint8_t fixed = 113;
  int context[4], pred[4];
  auto reset = [&]() {
    for (int c = 0; c < ncomp; ++c) {
      if (dc_first) std::memset(dc_stats[params[c * 5 + 3]], 0, kDcBins);
      if (uses_ac) std::memset(ac_stats[params[c * 5 + 4]], 0, kAcBins);
      context[c] = pred[c] = 0;
    }
  };
  reset();
  Arith ar{data, n, start};
  int err = 0, rst_no = 0;
  const int64_t total = mcus_x * mcus_y;
  for (int64_t m = 0; m < total; ++m) {
    if (restart > 0 && m > 0 && m % restart == 0) {
      if (int r = ar.restart(&rst_no)) return r;
      reset();
    }
    const int64_t my = m / mcus_x, mx = m % mcus_x;
    for (int c = 0; c < ncomp; ++c) {
      const int32_t* pc = params + c * 5;
      const int mh = pc[0], mv = pc[1], dct = pc[3], act = pc[4];
      const int64_t bw = pc[2];
      for (int v = 0; v < mv; ++v) {
        for (int h = 0; h < mh; ++h) {
          int16_t* blk = coefs[c] + ((my * mv + v) * bw + mx * mh + h) * 64;
          if (dc_first) {
            int diff = arith_dc(ar, dc_stats[dct], &context[c], cond[dct], cond[16 + dct], &err);
            if (err) return err;
            pred[c] = (pred[c] + diff) & 0xFFFF;
            blk[0] = (int16_t)((uint32_t)pred[c] << al);
          } else if (ss == 0) {                  // DC refinement: the next bit
            if (ar.decode(&fixed)) blk[0] = (int16_t)(blk[0] | (1 << al));
          }
          if (!uses_ac) continue;
          int r = ah == 0 ? arith_ac_first(ar, ac_stats[act], &fixed, cond[32 + act],
                                           prog ? ss : 1, se, al, blk)
                          : arith_ac_refine(ar, ac_stats[act], &fixed, ss, se, al, blk);
          if (r) return r;
        }
      }
    }
  }
  *end = ar.marker_at >= 0 ? ar.marker_at : ar.pos;
  return kOk;
}

// Decode one lossless scan (SOF3) into per-component sample planes, as
// libjpeg-turbo 3 decodes it:
//   params:       per component {mcu_h, mcu_v, width, height, dc_table, v}:
//                 samples per MCU across and down (1, 1 in a non-interleaved
//                 scan), the component's size in samples, its table slot and
//                 its vertical sampling factor
//   huff_bits/huff_vals: as for jpeg_decode_scan (DC rows 0-3 used)
//   mcus_x/y:     MCUs across and down the scan
//   restart:      restart interval in MCUs, a multiple of mcus_x (0: none)
//   psv, pt, precision: the predictor (Ss, 1..7), the point transform (Al)
//                 and the sample precision P
//   planes:       per component [mcus_y * mcu_v][mcus_x * mcu_h] uint16,
//                 filled with the samples before the point transform's
//                 shift, within its width and height
int jpeg_decode_lossless_scan(const uint8_t* data, int64_t n, int64_t start, int ncomp,
                              const int32_t* params, const uint8_t* huff_bits,
                              const uint8_t* huff_vals, int64_t mcus_x, int64_t mcus_y,
                              int64_t restart, int psv, int pt, int precision,
                              uint16_t** planes, int64_t* end) {
  if (ncomp < 1 || ncomp > 4 || start < 0 || start > n || mcus_x < 1 || mcus_y < 1)
    return kBadArgs;
  if (psv < 1 || psv > 7 || pt < 0 || pt >= precision || precision > 16) return kBadArgs;
  if (restart % mcus_x) return kBadRestart;      // jddiffct.c: whole MCU rows only
  Huff tables[8];
  bool used[8] = {false};
  for (int c = 0; c < ncomp; ++c) {
    const int32_t* pc = params + c * 6;
    if (pc[4] < 0 || pc[4] > 3 || pc[2] > mcus_x * pc[0] || pc[3] > mcus_y * pc[1] || pc[5] < 1)
      return kBadArgs;
    used[pc[4]] = true;
  }
  if (int r = build_tables(used, huff_bits, huff_vals, tables)) return r;
  // an iMCU row is one MCU row of an interleaved scan, v of a component alone
  const int rows_per_imcu = ncomp == 1 ? params[5] : 1;
  const int64_t restart_rows = restart / mcus_x;
  const int initial = 1 << (precision - pt - 1);
  Bits br{data, n, start, 0, 0, false};
  int err = 0, rst_no = 0;
  int64_t rows_to_go = restart_rows;
  bool first_row[4] = {true, true, true, true};
  int64_t next_row[4] = {0, 0, 0, 0};       // the next row to undifference
  for (int64_t my = 0; my < mcus_y;) {
    int64_t imcu_end = my + rows_per_imcu < mcus_y ? my + rows_per_imcu : mcus_y;
    for (; my < imcu_end; ++my) {
      if (restart_rows && rows_to_go == 0) {
        if (int r = restart_marker(br, &rst_no)) return r;
        for (int c = 0; c < ncomp; ++c) first_row[c] = true;
        rows_to_go = restart_rows;
      }
      for (int64_t mx = 0; mx < mcus_x; ++mx) {
        for (int c = 0; c < ncomp; ++c) {
          const int32_t* pc = params + c * 6;
          const int mh = pc[0], mv = pc[1];
          const int64_t stride = mcus_x * mh;
          for (int v = 0; v < mv; ++v) {
            for (int h = 0; h < mh; ++h) {
              int s = br.decode(tables[pc[4]], &err);
              if (err) return err;
              int diff;
              if (s == 16) {
                diff = 32768;
              } else if (s > 16) {
                return kBadCode;
              } else {
                diff = s ? extend(br.get(s, &err), s) : 0;
                if (err) return err;
              }
              // the difference waits in the plane until its row is undifferenced
              planes[c][(my * mv + v) * stride + mx * mh + h] = (uint16_t)diff;
            }
          }
        }
      }
      if (restart_rows) --rows_to_go;
    }
    // undifference the iMCU row's sample rows of each component
    for (int c = 0; c < ncomp; ++c) {
      const int32_t* pc = params + c * 6;
      const int64_t stride = mcus_x * pc[0], width = pc[2], height = pc[3];
      const int64_t last = my * pc[1];
      for (int64_t y = next_row[c]; y < last && y < height; ++y) {
        uint16_t* row = planes[c] + y * stride;
        const uint16_t* up = row - stride;
        if (first_row[c]) {
          int ra = (row[0] + initial) & 0xFFFF;
          row[0] = (uint16_t)ra;
          for (int64_t x = 1; x < width; ++x) row[x] = (uint16_t)(ra = (row[x] + ra) & 0xFFFF);
          first_row[c] = false;
          continue;
        }
        int rb = up[0];
        int ra = (row[0] + rb) & 0xFFFF;
        row[0] = (uint16_t)ra;
        for (int64_t x = 1; x < width; ++x) {
          int rc = rb, p;
          rb = up[x];
          switch (psv) {
            case 1: p = ra; break;
            case 2: p = rb; break;
            case 3: p = rc; break;
            case 4: p = ra + rb - rc; break;
            case 5: p = ra + ((rb - rc) >> 1); break;
            case 6: p = rb + ((ra - rc) >> 1); break;
            default: p = (ra + rb) >> 1; break;
          }
          row[x] = (uint16_t)(ra = (row[x] + p) & 0xFFFF);
        }
      }
      next_row[c] = last;
    }
  }
  return scan_end(br, end);
}

}  // extern "C"
