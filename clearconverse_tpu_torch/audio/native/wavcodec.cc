// Native host-side packer of the lossless delta audio wire
// (clearconverse_tpu_torch/audio/pack.py).
//
// C ABI only, loaded with ctypes (audio/native/__init__.py builds it with
// g++ at first use). Both functions return 0 on success, negative on error.
// Buffers are caller-allocated.

#include <cstdint>

extern "C" {

// ---- Lossless delta wire (audio/pack.py format) -------------------------
//
// The packed host->device wire needs an exact max-|delta| scan and a
// bit-packing pass over the whole int16 batch; numpy needs temporaries and
// strided slices for both, one pass of C needs neither.

// Max |first delta| (slots >= 2) and |second delta| per batch; deltas never
// cross row boundaries. Rows are contiguous [k][t].
int delta_scan(const int16_t* q, int64_t k, int64_t t,
               int32_t* max_d1, int32_t* max_d2) {
  if (t < 2) return -1;
  int32_t m1 = 0, m2 = 0;
  for (int64_t r = 0; r < k; ++r) {
    const int16_t* x = q + r * t;
    int32_t prev_d = (int32_t)x[1] - x[0];
    for (int64_t i = 2; i < t; ++i) {
      const int32_t d = (int32_t)x[i] - x[i - 1];
      const int32_t a1 = d < 0 ? -d : d;
      const int32_t d2 = d - prev_d;
      const int32_t a2 = d2 < 0 ? -d2 : d2;
      if (a1 > m1) m1 = a1;
      if (a2 > m2) m2 = a2;
      prev_d = d;
    }
  }
  *max_d1 = m1;
  *max_d2 = m2;
  return 0;
}

// Pack order-1/2 deltas (slots >= 2; slots 0/1 pack as zero) into a
// little-endian width-bit stream, one stream per row: out is
// [k][t*width/8] bytes; x0/e1 receive each row's sample 0 and slot-1
// delta. Byte layout matches audio/pack.pack_bits_np exactly.
int delta_pack(const int16_t* q, int64_t k, int64_t t, int order, int width,
               uint8_t* out, int32_t* x0, int32_t* e1) {
  if (t < 2 || t % 8 || width < 2 || width > 15) return -1;
  if (order != 1 && order != 2) return -1;
  const uint32_t half = 1u << (width - 1);
  const int64_t row_bytes = t * width / 8;
  for (int64_t r = 0; r < k; ++r) {
    const int16_t* x = q + r * t;
    uint8_t* o = out + r * row_bytes;
    x0[r] = x[0];
    e1[r] = (int32_t)x[1] - x[0];
    uint64_t acc = half | ((uint64_t)half << width);  // slots 0 and 1 = 0
    int nbits = 2 * width;
    int32_t prev_d = e1[r];
    for (int64_t i = 2; i < t; ++i) {
      const int32_t d = (int32_t)x[i] - x[i - 1];
      const uint32_t v = (uint32_t)((order == 1 ? d : d - prev_d) + (int32_t)half);
      prev_d = d;
      acc |= (uint64_t)v << nbits;
      nbits += width;
      while (nbits >= 8) {
        *o++ = (uint8_t)(acc & 0xff);
        acc >>= 8;
        nbits -= 8;
      }
    }
    while (nbits > 0) {
      *o++ = (uint8_t)(acc & 0xff);
      acc >>= 8;
      nbits -= 8;
    }
  }
  return 0;
}

}  // extern "C"
