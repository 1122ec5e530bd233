// Native Huffman decoder of one baseline JPEG scan: the entropy-decoding
// loop of utils/image.py's _decode_scan as C++ (the plain Python version the
// tests hold it to, coefficient for coefficient).
//
// The caller passes the scan's restart intervals back to back, each already
// unstuffed and followed by four zero bytes, the 16-bit lookahead tables of
// every scan component (entry (length << 8) | symbol, 0: no code), and one
// zeroed int32 coefficient plane per component ([blocks * 64], natural
// order). A plain C ABI for ctypes.

#include <cstdint>

namespace {

constexpr int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Bits {
  const uint8_t* d;
  int64_t len;  // bytes readable, the zero padding included
  int64_t pos;  // bit position

  // the 16 bits from pos on (zeros past the end)
  uint32_t peek16() const {
    const int64_t i = pos >> 3;
    uint32_t w = 0;
    for (int k = 0; k < 3; ++k)
      w = (w << 8) | (i + k < len ? d[i + k] : 0u);
    return (w >> (8 - (pos & 7))) & 0xFFFFu;
  }

  // a magnitude category's s extra bits as a signed value (JPEG's extend)
  int32_t extend(int s) {
    int32_t v = static_cast<int32_t>(peek16() >> (16 - s));
    pos += s;
    if (v < (1 << (s - 1))) v -= (1 << s) - 1;
    return v;
  }
};

}  // namespace

// 0: decoded; 1: a bad Huffman code; 2: the data of an interval ends early.
extern "C" int jpeg_decode_scan(const uint8_t* data, const int64_t* seg_start,
                                int n_segs, int per_seg, int mcus_x,
                                int mcus_y, int n_comps,
                                const uint16_t* dc_luts,
                                const uint16_t* ac_luts,
                                const int32_t* geom /* h, v, bw a comp */,
                                int32_t* const* coef) {
  const int64_t n_mcus = static_cast<int64_t>(mcus_x) * mcus_y;
  int64_t mcu = 0;
  for (int s = 0; s < n_segs; ++s) {
    Bits b{data + seg_start[s], seg_start[s + 1] - seg_start[s], 0};
    const int64_t nbits = (b.len - 4) * 8;
    int32_t preds[4] = {0, 0, 0, 0};
    const int64_t end = mcu + per_seg < n_mcus ? mcu + per_seg : n_mcus;
    for (; mcu < end; ++mcu) {
      const int64_t my = mcu / mcus_x, mx = mcu % mcus_x;
      for (int c = 0; c < n_comps; ++c) {
        const uint16_t* dc = dc_luts + static_cast<int64_t>(c) * 65536;
        const uint16_t* ac = ac_luts + static_cast<int64_t>(c) * 65536;
        const int h = geom[3 * c], v = geom[3 * c + 1], bw = geom[3 * c + 2];
        for (int by = 0; by < v; ++by) {
          for (int bx = 0; bx < h; ++bx) {
            int32_t* blk = coef[c] + ((my * v + by) * bw + mx * h + bx) * 64;
            uint32_t e = dc[b.peek16()];
            if (!e) return 1;
            b.pos += e >> 8;
            const int sz = e & 0xFF;
            if (sz) preds[c] += b.extend(sz);
            blk[0] = preds[c];
            for (int k = 1; k < 64;) {
              e = ac[b.peek16()];
              if (!e) return 1;
              b.pos += e >> 8;
              const int rs = e & 0xFF, r = rs & 15;
              if (r) {
                k += rs >> 4;
                const int32_t a = b.extend(r);
                if (k < 64) blk[kZigzag[k]] = a;
                ++k;
              } else if (rs == 0xF0) {
                k += 16;
              } else {
                break;
              }
            }
            if (b.pos > nbits + 32) return 2;
          }
        }
      }
    }
  }
  return 0;
}
