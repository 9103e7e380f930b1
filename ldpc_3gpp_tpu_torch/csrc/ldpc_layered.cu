// Layered belief-propagation LDPC decoder for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel ldpc_3gpp_tpu/ops/decoder_pallas.py::_make_kernel in
// its layered min-sum / offset-min-sum configuration (f32 messages, early
// termination or run-to-budget, 'd' or 'cw' input, 'sys' or 'cw' output, any
// row order, optional alpha schedule).  The plain PyTorch version of the same
// arithmetic is ops/decoder_layered.py; results are bit-identical.
//
// What bounds it on this card.  Per codeword and sweep the algorithm touches
// every edge of the lifted graph once: 2*E*Z shared-memory accesses of the
// posterior totals (one rotated read, one write back) and 2*E*Z*4 bytes of
// check-to-variable message traffic (one read, one write).  The totals
// (nc*Z*4 B = 102 KiB at BG1 Z=384) fit a block's shared memory; the messages
// (E*Z*4 B = 474 KiB per codeword at BG1 Z=384) do not, so they live in a
// global scratch tensor and their traffic goes through L2 to device memory.
// That message traffic, times the mean number of sweeps, is the kernel's
// bound, well above the arithmetic (about a dozen integer/float operations
// per edge and lane).
//
// What the design does about it.  One block decodes one codeword; thread z
// owns check z of the current base row.  Totals stay in shared memory for the
// whole decode, in variable coordinates, so a circulant rotation is the
// address (z + shift) mod Z and costs nothing.  Thread z touches only lane z
// of each message block, so message accesses coalesce, and a row's loads are
// all issued before the first is used (the row is unrolled to MAX_DEG
// predicated slots held in registers).  Sweep 0 never reads the messages
// (they are known to be zero), which also spares zero-filling the scratch.  A
// block stops at the sweep in which its codeword's parity passed, so early
// termination saves its full share of traffic.  Two blocks fit one SM.
// Within a row every edge has its own column and within an edge every lane
// its own address, so a row needs no atomics: one barrier per row.
//
// Bit-exactness.  Magnitudes are compared as integers (bits & 0x7fffffff),
// the two smallest kept by a min/max tournament, signs are XORs of sign bits;
// every float operation is an explicitly rounded intrinsic (__fsub_rn,
// __fmul_rn, __fadd_rn), so no multiply-add is contracted.  Build with
// -fmad=false and without --use_fast_math or -ftz.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_DEG 20      // densest check row: 19 edges (BG1 rows 0 and 1)
#define MAX_THREADS 384 // largest lifting size of TS38.212

#define SIGN_BIT 0x80000000u
#define MAG_MASK 0x7fffffffu
#define MAG_INF 0x7f7fffffu // f32 max: above any finite magnitude
#define FILLER_LLR 1e20f

struct DecodeArgs {
  int Z, nc, nr, E, out_cols;
  int d_input, fill_lo, fill_hi;
  int iterations, early_termination, offset_rule;
  float alpha, beta, alpha0;
  int n0;
};

// Edge record, in processing order: x = col*Z (offset of the column in the
// totals), y = shift, z = edge_id*Z (offset of the edge's message block in the
// codeword's scratch), w unused.

__device__ __forceinline__ int rot(int z, int shift, int Z) {
  int idx = z + shift;
  return idx >= Z ? idx - Z : idx;
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

extern "C" __global__ void __launch_bounds__(MAX_THREADS, 2)
ldpc_layered_kernel(const float* __restrict__ llr, int8_t* __restrict__ bits,
                    int* __restrict__ ok_out, int* __restrict__ it_out,
                    float* __restrict__ c2v_all,
                    const int4* __restrict__ edges_g,
                    const int* __restrict__ row_start_g, DecodeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Z = a.Z, nc = a.nc, nr = a.nr, E = a.E;
  float* totals = reinterpret_cast<float*>(smem);
  int4* edges = reinterpret_cast<int4*>(smem + ((nc * Z * 4 + 15) / 16) * 16);
  int* row_start = reinterpret_cast<int*>(edges + E);

  const int z = threadIdx.x;
  const bool active = z < Z;
  const size_t cw = blockIdx.x;

  for (int i = z; i < E; i += blockDim.x) edges[i] = edges_g[i];
  for (int i = z; i <= nr; i += blockDim.x) row_start[i] = row_start_g[i];

  // Channel LLRs into the totals, in variable coordinates.  'd' input: the
  // 2Z punctured positions are +0.0 and the filler range of d is pinned.
  if (active) {
    if (a.d_input) {
      const float* src = llr + cw * (size_t)((nc - 2) * Z);
      totals[z] = 0.0f;
      totals[Z + z] = 0.0f;
      for (int c = 2; c < nc; ++c) {
        const int j = (c - 2) * Z + z;
        totals[c * Z + z] =
            (j >= a.fill_lo && j < a.fill_hi) ? FILLER_LLR : src[j];
      }
    } else {
      const float* src = llr + cw * (size_t)(nc * Z);
      for (int c = 0; c < nc; ++c) totals[c * Z + z] = src[c * Z + z];
    }
  }
  __syncthreads();

  float* c2v = c2v_all + cw * (size_t)(E * Z) + z; // this thread's lane
  int used = a.iterations;
  bool done = false;

  for (int it = 0; it < a.iterations; ++it) {
    const bool first = it == 0; // all messages are zero: skip their read
    const float alpha_t = it < a.n0 ? a.alpha0 : a.alpha;
    unsigned bad = 0;
    for (int r = 0; r < nr; ++r) {
      const int e0 = row_start[r];
      const int deg = row_start[r + 1] - e0;
      if (active) {
        float v[MAX_DEG];
        unsigned par = 0, sx = 0, m1 = MAG_INF, m2 = MAG_INF;
#pragma unroll
        for (int i = 0; i < MAX_DEG; ++i) {
          if (i < deg) {
            const int4 ed = edges[e0 + i];
            const float t = totals[ed.x + rot(z, ed.y, Z)];
            par ^= __float_as_uint(t);
            const float ve = first ? t : __fsub_rn(t, c2v[ed.z]);
            v[i] = ve;
            const unsigned b = __float_as_uint(ve);
            const unsigned mg = b & MAG_MASK;
            sx ^= b;
            if (i == 0) {
              m1 = mg;
            } else {
              m2 = min(m2, max(m1, mg));
              m1 = min(m1, mg);
            }
          }
        }
        bad |= par; // parity of the totals as read in this sweep
        float m1f, m2f;
        if (a.offset_rule) {
          m1f = fmaxf(__fsub_rn(__uint_as_float(m1), a.beta), 0.0f);
          m2f = fmaxf(__fsub_rn(__uint_as_float(m2), a.beta), 0.0f);
        } else {
          m1f = __fmul_rn(alpha_t, __uint_as_float(m1));
          m2f = __fmul_rn(alpha_t, __uint_as_float(m2));
        }
        const unsigned ssign = sx & SIGN_BIT;
        const unsigned m1s = __float_as_uint(m1f) ^ ssign;
        const unsigned m2s = __float_as_uint(m2f) ^ ssign;
#pragma unroll
        for (int i = 0; i < MAX_DEG; ++i) {
          if (i < deg) {
            const int4 ed = edges[e0 + i];
            const unsigned b = __float_as_uint(v[i]);
            const unsigned mag = (b & MAG_MASK) == m1 ? m2s : m1s;
            const float msg = __uint_as_float(mag ^ (b & SIGN_BIT));
            c2v[ed.z] = msg;
            totals[ed.x + rot(z, ed.y, Z)] = __fadd_rn(v[i], msg);
          }
        }
      }
      __syncthreads();
    }
    if (a.early_termination) {
      const int any_bad = __syncthreads_or(active && (bad & SIGN_BIT));
      if (!any_bad) { // uniform over the block
        done = true;
        used = it;
        break;
      }
    }
  }

  // A codeword that never passed (or a run to budget) gets one clean
  // syndrome pass over the settled totals.
  int ok = 1;
  if (!done) {
    unsigned bad = 0;
    if (active) bad = syndrome_bits(totals, edges, row_start, nr, z, Z);
    ok = !__syncthreads_or(active && (bad & SIGN_BIT));
  }

  if (active) {
    int8_t* dst = bits + cw * (size_t)(a.out_cols * Z);
    for (int c = 0; c < a.out_cols; ++c)
      dst[c * Z + z] = totals[c * Z + z] < 0.0f;
  }
  if (z == 0) {
    ok_out[cw] = ok;
    it_out[cw] = used;
  }
}

extern "C" int ldpc_layered_max_degree() { return MAX_DEG; }
extern "C" int ldpc_layered_max_z() { return MAX_THREADS; }

// Launches the decoder for `ncw` codewords on `stream`.  Does not
// synchronise and allocates nothing.  Returns cudaGetLastError().
extern "C" int ldpc_layered_decode(
    const void* llr, void* bits, void* ok, void* iters, void* c2v,
    const void* edges, const void* row_start, int ncw, int Z, int nc, int nr,
    int E, int out_cols, int d_input, int fill_lo, int fill_hi, int iterations,
    int early_termination, int offset_rule, float alpha, float beta,
    float alpha0, int n0, void* stream) {
  if (Z < 1 || Z > MAX_THREADS || ncw < 1) return (int)cudaErrorInvalidValue;
  DecodeArgs a;
  a.Z = Z; a.nc = nc; a.nr = nr; a.E = E; a.out_cols = out_cols;
  a.d_input = d_input; a.fill_lo = fill_lo; a.fill_hi = fill_hi;
  a.iterations = iterations; a.early_termination = early_termination;
  a.offset_rule = offset_rule;
  a.alpha = alpha; a.beta = beta; a.alpha0 = alpha0; a.n0 = n0;

  const int threads = ((Z + 31) / 32) * 32;
  const size_t smem_bytes =
      ((size_t)(nc * Z * 4 + 15) / 16) * 16 + (size_t)E * 16 + (size_t)(nr + 1) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      ldpc_layered_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  ldpc_layered_kernel<<<ncw, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)llr, (int8_t*)bits, (int*)ok, (int*)iters, (float*)c2v,
      (const int4*)edges, (const int*)row_start, a);
  return (int)cudaGetLastError();
}
