// JPEG Huffman entropy decoding: one scan's coded data into int16
// coefficient blocks per component (natural order, not yet dequantised),
// for sequential (baseline, extended) and progressive files.
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
// earlier scans left. Unlike libjpeg it never pads corrupt data with zeros:
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
  kBadDc = -8,          // a DC value that overflows its accumulator
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

}  // extern "C"
