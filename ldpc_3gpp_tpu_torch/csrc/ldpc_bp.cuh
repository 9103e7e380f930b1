// What the layered and the flooding BP decoder kernels share: the argument
// block, the graph's edge record, the sum-product phi and the layered kernels'
// check-node updates of one base row.
//
// Bit-exactness.  Every float operation is an explicitly rounded intrinsic
// (__fsub_rn, __fmul_rn, __fadd_rn, __fdiv_rn, __fmaf_rn), so a multiply-add
// is fused exactly where the reference fuses it and nowhere else.  Build with
// -fmad=false and without --use_fast_math or -ftz.
//
// The -0.0 invariant.  The min-sum family works on sign bits and integer
// magnitudes, and the syndrome is the XOR of the totals' sign bits; the plain
// version tests `x < 0`.  The two differ only at -0.0.  Messages may be -0.0
// (a zero magnitude under a negative sign product; phi where tanh saturates),
// but a value read from the totals or formed as total - message never is, as
// long as no channel LLR is -0.0: IEEE a - b and a + b give -0.0 only from
// (-0.0) - (+0.0) and (-0.0) + (-0.0).  The chain's LLRs are finite with +0.0
// at punctured positions.  The sum-product rule and the hard decision test
// `x < 0` themselves.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_DEG 20      // densest check row: 19 edges (BG1 rows 0 and 1)
#define MAX_THREADS 384 // largest lifting size of TS38.212

#define SIGN_BIT 0x80000000u
#define MAG_MASK 0x7fffffffu
#define MAG_INF 0x7f7fffffu // f32 max: above any finite magnitude
#define FILLER_LLR 1e20f

// Check rules.  The two of the min-sum family share one instantiation and
// differ by a run-time flag; sum-product is an instantiation of its own.
#define RULE_MIN_SUM 0
#define RULE_OFFSET_MIN_SUM 1
#define RULE_SUM_PRODUCT 2

struct DecodeArgs {
  int Z, nc, nr, E, out_cols;
  int d_input, fill_lo, fill_hi;
  int iterations, early_termination, offset_rule;
  float alpha, beta, alpha0;
  int n0;
};

// Edge record, in processing order: x = col*Z (offset of the column in the
// totals), y = shift, z = edge_id*Z (offset of the edge's message block in the
// codeword's scratch), w = 1 if no earlier edge touches this column.

__device__ __forceinline__ int rot(int z, int shift, int Z) {
  int idx = z + shift;
  return idx >= Z ? idx - Z : idx;
}

// Lane z of every column of the totals from the channel LLRs of one codeword
// (`src`), in variable coordinates.  'd' input: the 2Z punctured positions
// are +0.0 and the filler range of d is pinned.  The format is tested once,
// outside the column loops, so that the loads pipeline.
__device__ __forceinline__ void load_totals(float* totals, const float* src, int z,
                                            const DecodeArgs& a) {
  const int Z = a.Z, nc = a.nc;
  if (a.d_input) {
    totals[z] = 0.0f;
    totals[Z + z] = 0.0f;
    for (int c = 2; c < nc; ++c) {
      const int j = (c - 2) * Z + z;
      totals[c * Z + z] = (j >= a.fill_lo && j < a.fill_hi) ? FILLER_LLR : src[j];
    }
  } else {
    for (int c = 0; c < nc; ++c) totals[c * Z + z] = src[c * Z + z];
  }
}

// XOR of the sign bits seen by check z of every row, OR-ed over rows.
__device__ __forceinline__ unsigned syndrome_bits(
    const float* totals, const int4* edges, const int* row_start, int nr,
    int z, int Z) {
  unsigned bad = 0;
  for (int r = 0; r < nr; ++r) {
    unsigned par = 0;
    for (int e = row_start[r]; e < row_start[r + 1]; ++e) {
      const int4 ed = edges[e];
      par ^= __float_as_uint(totals[ed.x + rot(z, ed.y, Z)]);
    }
    bad |= par;
  }
  return bad;
}

// ---- sum-product phi(x) = -log(tanh(x/2)), clamped to [1e-9, 38] ----------
//
// The float32 tanh and log are not the CUDA library's: they are the explicit
// recipes that the plain version (ops/decoder.py::_phi) evaluates, operation
// for operation, so that kernel and plain version agree bit for bit.
// tanh: a 13/6-degree rational in x^2 by fused multiply-adds, identity below
// 4e-4, +-1 from 7.99881172180175781.  log: exponent/mantissa split, a
// mantissa polynomial in three interleaved parts, e*q1 carried as the addend
// of the last polynomial step, x - x^2/2 summed before the polynomial.

__device__ __forceinline__ float tanh_f32(float x) {
  const float ax = fabsf(x);
  if (ax < 0.0004f) return x;
  if (ax >= 7.99881172180175781f) return x > 0.0f ? 1.0f : -1.0f;
  const float x2 = __fmul_rn(x, x);
  float p = -2.76076847742355e-16f;
  p = __fmaf_rn(p, x2, 2.00018790482477e-13f);
  p = __fmaf_rn(p, x2, -8.60467152213735e-11f);
  p = __fmaf_rn(p, x2, 5.12229709037114e-08f);
  p = __fmaf_rn(p, x2, 1.48572235717979e-05f);
  p = __fmaf_rn(p, x2, 6.37261928875436e-04f);
  p = __fmaf_rn(p, x2, 4.89352455891786e-03f);
  p = __fmul_rn(p, x);
  float q = 1.19825839466702e-06f;
  q = __fmaf_rn(q, x2, 1.18534705686654e-04f);
  q = __fmaf_rn(q, x2, 2.26843463243900e-03f);
  q = __fmaf_rn(q, x2, 4.89352518554385e-03f);
  return __fdiv_rn(p, q);
}

__device__ __forceinline__ float log_f32(float xin) {
  const float sqrthf = 0.707106781186547524f;
  const float q1 = -2.12194440e-4f, q2 = 0.693359375f;
  const unsigned bits = __float_as_uint(xin);
  float e = (float)((int)(bits >> 23) - 126);
  float x = __uint_as_float((bits & 0x007fffffu) | 0x3f000000u); // [0.5, 1)
  const bool low = x < sqrthf;
  const float tmp = low ? x : 0.0f;
  e = __fsub_rn(e, low ? 1.0f : 0.0f);
  x = __fsub_rn(x, 1.0f);
  x = __fadd_rn(x, tmp);
  const float x2 = __fmul_rn(x, x), x3 = __fmul_rn(x2, x);
  float y = __fmaf_rn(7.0376836292e-2f, x, -1.1514610310e-1f);
  float y1 = __fmaf_rn(-1.2420140846e-1f, x, 1.4249322787e-1f);
  float y2 = __fmaf_rn(2.0000714765e-1f, x, -2.4999993993e-1f);
  y = __fmaf_rn(y, x, 1.1676998740e-1f);
  y1 = __fmaf_rn(y1, x, -1.6668057665e-1f);
  y2 = __fmaf_rn(y2, x, 3.3333331174e-1f);
  y = __fmaf_rn(y, x3, y1);
  y = __fmaf_rn(y, x3, y2);
  y = __fmaf_rn(y, x3, __fmul_rn(e, q1));
  x = __fsub_rn(x, __fmul_rn(x2, 0.5f));
  x = __fadd_rn(x, y);
  return __fmaf_rn(e, q2, x);
}

__device__ __forceinline__ float phi_f32(float x) {
  x = fminf(fmaxf(x, 1e-9f), 38.0f);
  return -log_f32(tanh_f32(__fmul_rn(x, 0.5f)));
}

// ---- the layered sum-product row, by the thread that owns check z --------
//
// Reads the row's totals (rotated by address) and, unless `first` (sweep 0:
// all messages are zero), its old messages; v_i = total - old message.
// T = sum of phi(|v_i|) in edge order; the extrinsic magnitude of an edge is
// phi(max(T - phi_i, 1e-9)); signs are `v < 0` tests multiplied up, here as
// the parity of a bit mask.  Stores each new message at c2v + the edge's
// offset and the total v_i + message in place.  Returns the XOR of the sign
// bits of the totals read (the row's parity).  The row is unrolled to SLOTS
// >= deg slots, predicated where SLOTS > deg.  v_i waits for the second half
// in the total's own place (thread z alone touches lane z of its row's
// columns until the row barrier), not in registers: so a row of ten slots
// stays within the 72 registers of four 224-thread blocks per SM.
template <int SLOTS>
__device__ __forceinline__ unsigned layered_sp_row_slots(
    float* totals, float* c2v, const int4* edges, int e0, int deg, int z, int Z,
    bool first) {
  float ph[SLOTS];
  unsigned par = 0, neg = 0;
  float T = 0.0f;
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    if (i < deg) {
      const int4 ed = edges[e0 + i];
      const int idx = ed.x + rot(z, ed.y, Z);
      const float t = totals[idx];
      par ^= __float_as_uint(t);
      const float ve = first ? t : __fsub_rn(t, c2v[ed.z]);
      totals[idx] = ve;
      neg |= (ve < 0.0f ? 1u : 0u) << i;
      const float p = phi_f32(fabsf(ve));
      ph[i] = p;
      T = i == 0 ? p : __fadd_rn(T, p);
    }
  }
  const unsigned sx = __popc(neg) & 1u;
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    if (i < deg) {
      const int4 ed = edges[e0 + i];
      const float mag = phi_f32(fmaxf(__fsub_rn(T, ph[i]), 1e-9f));
      // (+-1) * mag: an exact sign flip, also of a -0.0 magnitude
      const unsigned s = (sx ^ (neg >> i)) & 1u;
      const float msg = __uint_as_float(__float_as_uint(mag) ^ (s << 31));
      c2v[ed.z] = msg;
      const int idx = ed.x + rot(z, ed.y, Z);
      totals[idx] = __fadd_rn(totals[idx], msg);
    }
  }
  return par;
}

// layered_sp_row_slots unrolled to the row's own degree, 3 to 10 (a row's
// degree is the same for every thread of the block), so that no slot is
// predicated off; the four rows of 19 edges of BG1 (and any other degree)
// take MAX_DEG predicated slots.
__device__ __forceinline__ unsigned layered_sp_row(float* totals, float* c2v,
                                                   const int4* edges, int e0, int deg,
                                                   int z, int Z, bool first) {
#define SP_ROW_EXACT(D) \
  case D: return layered_sp_row_slots<D>(totals, c2v, edges, e0, D, z, Z, first);
  switch (deg) {
    SP_ROW_EXACT(3) SP_ROW_EXACT(4) SP_ROW_EXACT(5) SP_ROW_EXACT(6) SP_ROW_EXACT(7)
    SP_ROW_EXACT(8) SP_ROW_EXACT(9) SP_ROW_EXACT(10)
    default:
      return layered_sp_row_slots<MAX_DEG>(totals, c2v, edges, e0, deg, z, Z, first);
  }
#undef SP_ROW_EXACT
}

// ---- the layered min-sum family's messages in compressed form -------------
//
// The min-sum rule gives every edge of a row, at lane z, the message
// (|v_i| == m1 ? m2s : m1s) ^ sign(v_i), where m1s and m2s are the scaled (or
// offset) two smallest magnitudes with the row's sign product folded in.  So
// four words rebuild every message of the row bit for bit: m1s, m2s, and a
// meta word with the sign bit of each v_i (bit i) and the index of the first
// edge whose magnitude is m1 (bits MSG_IDX_SHIFT..31).  Where several edges
// share the smallest magnitude the tournament gives m2 == m1, so m2s == m1s
// and "the first such edge gets m2s" is exact.  bfloat16 messages: rounding
// to nearest even is symmetric in sign, so bf16(m ^ s) == bf16(m) ^ s, and the
// two magnitudes are stored as bfloat16 with no change of bits.  Per (row,
// lane): three 32-bit words (m1s, m2s, meta) with float32 messages, two
// (m1s | m2s << 16 as bfloat16 bits, meta) with bfloat16; each word type is a
// plane of its own, lane-contiguous, `L` words apart.

#define MSG_IDX_SHIFT 27  // MAX_DEG <= 27 sign bits below the 5-bit index
static_assert(MAX_DEG <= MSG_IDX_SHIFT, "sign bits overlap the min index");

template <typename MSG>
struct RowWords {
  static constexpr int N = sizeof(MSG) == 4 ? 3 : 2;  // 32-bit words per lane
};

// The words of one row at lane z, widened to float32 bit patterns.
struct RowMsgs {
  unsigned m1s, m2s, meta;
};

template <typename MSG>
__device__ __forceinline__ RowMsgs load_row_msgs(const unsigned* w, int L) {
  RowMsgs m;
  if constexpr (RowWords<MSG>::N == 3) {
    m.m1s = w[0];
    m.m2s = w[L];
    m.meta = w[2 * L];
  } else {
    const unsigned pair = w[0];  // bfloat16 bits widen by a shift
    m.m1s = pair << 16;
    m.m2s = pair & 0xffff0000u;
    m.meta = w[L];
  }
  return m;
}

template <typename MSG>
__device__ __forceinline__ void store_row_msgs(unsigned* w, int L, unsigned m1s,
                                               unsigned m2s, unsigned meta) {
  if constexpr (RowWords<MSG>::N == 3) {
    w[0] = m1s;
    w[L] = m2s;
    w[2 * L] = meta;
  } else {
    const unsigned lo = __bfloat16_as_ushort(__float2bfloat16_rn(__uint_as_float(m1s)));
    const unsigned hi = __bfloat16_as_ushort(__float2bfloat16_rn(__uint_as_float(m2s)));
    w[0] = lo | (hi << 16);
    w[L] = meta;
  }
}

// One base row's layered min-sum / offset-min-sum update by the thread that
// owns check z.  Magnitudes are compared as integers (bits & 0x7fffffff),
// the two smallest kept by a min/max tournament, signs are XORs of sign bits;
// the old messages are rebuilt from the row's words `old` (unless `first`)
// and the new words stored at `w`.  The totals take the unrounded message.
// Returns the XOR of the sign bits of the totals read (the row's parity).
// The row is unrolled to SLOTS >= deg slots, predicated where SLOTS > deg.
template <typename MSG, int SLOTS>
__device__ __forceinline__ unsigned layered_row_slots(
    float* totals, const RowMsgs& old, unsigned* w, int L, const int4* edges,
    int e0, int deg, int z, int Z, bool first, float alpha_t, int offset_rule,
    float beta) {
  float v[SLOTS];
  unsigned par = 0, sx = 0, m1 = MAG_INF, m2 = MAG_INF, idx = 0, signs = 0;
  const unsigned old_idx = old.meta >> MSG_IDX_SHIFT;
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    if (i < deg) {
      const int4 ed = edges[e0 + i];
      const float t = totals[ed.x + rot(z, ed.y, Z)];
      par ^= __float_as_uint(t);
      const unsigned old_msg = (i == old_idx ? old.m2s : old.m1s) ^
                               ((old.meta << (31 - i)) & SIGN_BIT);
      const float ve = first ? t : __fsub_rn(t, __uint_as_float(old_msg));
      v[i] = ve;
      const unsigned b = __float_as_uint(ve);
      const unsigned mg = b & MAG_MASK;
      sx ^= b;
      signs |= (b >> 31) << i;
      if (i == 0) {
        m1 = mg;
      } else {
        idx = mg < m1 ? i : idx;
        m2 = min(m2, max(m1, mg));
        m1 = min(m1, mg);
      }
    }
  }
  float m1f, m2f;
  if (offset_rule) {
    m1f = fmaxf(__fsub_rn(__uint_as_float(m1), beta), 0.0f);
    m2f = fmaxf(__fsub_rn(__uint_as_float(m2), beta), 0.0f);
  } else {
    m1f = __fmul_rn(alpha_t, __uint_as_float(m1));
    m2f = __fmul_rn(alpha_t, __uint_as_float(m2));
  }
  const unsigned ssign = sx & SIGN_BIT;
  const unsigned m1s = __float_as_uint(m1f) ^ ssign;
  const unsigned m2s = __float_as_uint(m2f) ^ ssign;
  store_row_msgs<MSG>(w, L, m1s, m2s, signs | (idx << MSG_IDX_SHIFT));
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    if (i < deg) {
      const int4 ed = edges[e0 + i];
      const unsigned b = __float_as_uint(v[i]);
      const float msg = __uint_as_float((i == idx ? m2s : m1s) ^ (b & SIGN_BIT));
      totals[ed.x + rot(z, ed.y, Z)] = __fadd_rn(v[i], msg);
    }
  }
  return par;
}

// layered_row_slots unrolled to the row's own degree, 3 to 10 (a row's
// degree is the same for every thread of the block), so that no slot is
// predicated off; the four rows of 19 edges of BG1 (and any other degree)
// take MAX_DEG predicated slots.
template <typename MSG>
__device__ __forceinline__ unsigned layered_row_compressed(
    float* totals, const RowMsgs& old, unsigned* w, int L, const int4* edges,
    int e0, int deg, int z, int Z, bool first, float alpha_t, int offset_rule,
    float beta) {
#define ROW_EXACT(D) \
  case D: return layered_row_slots<MSG, D>(totals, old, w, L, edges, e0, D, z, Z, \
                                           first, alpha_t, offset_rule, beta);
  switch (deg) {
    ROW_EXACT(3) ROW_EXACT(4) ROW_EXACT(5) ROW_EXACT(6) ROW_EXACT(7)
    ROW_EXACT(8) ROW_EXACT(9) ROW_EXACT(10)
    default:
      return layered_row_slots<MSG, MAX_DEG>(totals, old, w, L, edges, e0, deg, z,
                                             Z, first, alpha_t, offset_rule, beta);
  }
#undef ROW_EXACT
}

// Shared-memory layout after the float state: the edge table, 16-byte
// aligned, then the row offsets.
__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// The most dynamic shared memory a block of the current device may opt in to.
static inline int max_shared_bytes_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return bytes;
}
