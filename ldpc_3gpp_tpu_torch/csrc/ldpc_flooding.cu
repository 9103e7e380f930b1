// Flooding belief-propagation LDPC decoder for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel ldpc_3gpp_tpu/ops/decoder_pallas.py::_make_kernel in
// its flooding configurations: sum-product / min-sum / offset-min-sum, early
// termination or run-to-budget, f32 messages or (min-sum family) bfloat16
// messages, 'd' or 'cw' input, 'sys' or 'cw' output, optional alpha schedule.
// This is the schedule of the MATLAB reference (comm.LDPCDecoder): every check
// row of a sweep reads the same pre-sweep totals, and the totals change only
// after the whole sweep.  The plain PyTorch version of the same arithmetic is
// ops/decoder_fast.py; results are bit-identical.
//
// What bounds it on this card.  With sum-product, the arithmetic: phi twice
// per edge, lane and sweep (about 60 operations each, one of them a
// division).  With the min-sum family, as in the layered kernel, the message
// traffic: one write per sweep and one read per sweep after the first of
// E*Z*4 bytes per codeword (160 KiB at BG2 Z=208, 474 KiB at BG1 Z=384; half
// with bfloat16 messages).
//
// What the design does about it.  One block decodes one codeword; thread z
// owns check z of the current base row.  Shared memory holds the totals and
// the deferred column sums (2*nc*Z*4 B: 84.5 KiB at BG2 Z=208, 204 KiB at
// BG1 Z=384, the largest code, which with its edge table takes 214,140 of the
// 232,448 bytes a block may have); the messages live in a global scratch.
// Taken instead of the alternative (no column sums in shared memory, a
// second phase per sweep that reads the messages back column by column):
// that doubles the message traffic, which is the min-sum bound, to gain a
// second resident block per SM only at the largest lifting sizes; up to
// Z=208 two blocks fit as it is.
//   - Order of the column sums.  acc[c] is assigned by the first row that
//     touches column c and added to by the later ones in ascending row order,
//     then totals = llr + acc.  Within a base row every edge has its own
//     column and every lane its own address, and rows are one barrier apart,
//     so that order holds without atomics.
//   - The channel LLRs are needed every sweep; they are re-read from the
//     input (with the 'd' synthesis) instead of kept as a third copy.
//   - Stop instead of freeze.  A block takes the syndrome of its totals
//     first and runs the message pass only if it failed: the pass whose
//     syndrome is zero ends the block with iterations = its index and the
//     totals as checked, and its message pass is never run.  The pass at
//     it == iterations only checks.
//   - Sweep 0 reads no messages (they are zero), so the scratch is never
//     zero-filled.
// The check-node update, phi and the notes on bit-exactness are in
// ldpc_bp.cuh, shared with the layered kernel.

#include "ldpc_bp.cuh"

template <bool SUM_PRODUCT, typename MSG>
__global__ void __launch_bounds__(MAX_THREADS, 1)
ldpc_flooding_kernel(const float* __restrict__ llr, int8_t* __restrict__ bits,
                     int* __restrict__ ok_out, int* __restrict__ it_out,
                     MSG* __restrict__ c2v_all,
                     const int4* __restrict__ edges_g,
                     const int* __restrict__ row_start_g, DecodeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Z = a.Z, nc = a.nc, nr = a.nr, E = a.E;
  float* totals = reinterpret_cast<float*>(smem);
  float* acc = totals + nc * Z;
  int4* edges = reinterpret_cast<int4*>(smem + align16((size_t)2 * nc * Z * 4));
  int* row_start = reinterpret_cast<int*>(edges + E);

  const int z = threadIdx.x;
  const bool active = z < Z;
  const size_t cw = blockIdx.x;

  for (int i = z; i < E; i += blockDim.x) edges[i] = edges_g[i];
  for (int i = z; i <= nr; i += blockDim.x) row_start[i] = row_start_g[i];

  const float* src = llr + cw * (size_t)((a.d_input ? nc - 2 : nc) * Z);
  if (active) load_totals<false>(totals, nullptr, src, z, a);
  __syncthreads();

  MSG* c2v = c2v_all + cw * (size_t)(E * Z) + z; // this thread's lane
  int ok = 0;
  int used = a.iterations;

  for (int it = 0;; ++it) {
    // Early termination checks before every update and once after the last;
    // a run to budget checks only the final state.
    if (a.early_termination || it == a.iterations) {
      unsigned bad = 0;
      if (active) bad = syndrome_bits(totals, edges, row_start, nr, z, Z);
      if (!__syncthreads_or(active && (bad & SIGN_BIT))) { // uniform
        ok = 1;
        if (a.early_termination) used = it;
        break;
      }
    }
    if (it == a.iterations) break;

    const bool first = it == 0; // all messages are zero: skip their read
    const float alpha_t = it < a.n0 ? a.alpha0 : a.alpha;
    for (int r = 0; r < nr; ++r) {
      const int e0 = row_start[r];
      if (active)
        check_row<SUM_PRODUCT, true, MSG>(totals, acc, c2v, edges, e0,
                                          row_start[r + 1] - e0, z, Z, first,
                                          alpha_t, a.offset_rule, a.beta);
      __syncthreads();
    }
    if (active) load_totals<true>(totals, acc, src, z, a);
    __syncthreads();
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

extern "C" int ldpc_flooding_max_degree() { return MAX_DEG; }
extern "C" int ldpc_flooding_max_z() { return MAX_THREADS; }
extern "C" int ldpc_flooding_max_shared_bytes() { return max_shared_bytes_optin(); }

// Dynamic shared memory of one block: totals, column sums, edge table, row
// offsets.
extern "C" int ldpc_flooding_shared_bytes(int Z, int nc, int nr, int E) {
  return (int)(align16((size_t)2 * nc * Z * 4) + (size_t)E * 16 +
               (size_t)(nr + 1) * 4);
}

template <bool SUM_PRODUCT, typename MSG>
static int launch(const void* llr, void* bits, void* ok, void* iters, void* c2v,
                  const void* edges, const void* row_start, int ncw,
                  const DecodeArgs& a, cudaStream_t stream) {
  const int threads = ((a.Z + 31) / 32) * 32;
  const int smem_bytes = ldpc_flooding_shared_bytes(a.Z, a.nc, a.nr, a.E);
  cudaError_t err = cudaFuncSetAttribute(
      ldpc_flooding_kernel<SUM_PRODUCT, MSG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  ldpc_flooding_kernel<SUM_PRODUCT, MSG><<<ncw, threads, smem_bytes, stream>>>(
      (const float*)llr, (int8_t*)bits, (int*)ok, (int*)iters, (MSG*)c2v,
      (const int4*)edges, (const int*)row_start, a);
  return (int)cudaGetLastError();
}

// Launches the decoder for `ncw` codewords on `stream`; the edge table must
// be in ascending row order.  `rule` is 0 (min-sum), 1 (offset-min-sum) or 2
// (sum-product); `bf16_messages` selects the scratch's element type (min-sum
// family only).  Does not synchronise and allocates nothing.  Returns
// cudaGetLastError().
extern "C" int ldpc_flooding_decode(
    const void* llr, void* bits, void* ok, void* iters, void* c2v,
    const void* edges, const void* row_start, int ncw, int Z, int nc, int nr,
    int E, int out_cols, int d_input, int fill_lo, int fill_hi, int iterations,
    int early_termination, int rule, int bf16_messages, float alpha,
    float beta, float alpha0, int n0, void* stream) {
  if (Z < 1 || Z > MAX_THREADS || ncw < 1) return (int)cudaErrorInvalidValue;
  if (rule < RULE_MIN_SUM || rule > RULE_SUM_PRODUCT) return (int)cudaErrorInvalidValue;
  if (rule == RULE_SUM_PRODUCT && bf16_messages) return (int)cudaErrorInvalidValue;
  DecodeArgs a;
  a.Z = Z; a.nc = nc; a.nr = nr; a.E = E; a.out_cols = out_cols;
  a.d_input = d_input; a.fill_lo = fill_lo; a.fill_hi = fill_hi;
  a.iterations = iterations; a.early_termination = early_termination;
  a.offset_rule = rule == RULE_OFFSET_MIN_SUM;
  a.alpha = alpha; a.beta = beta; a.alpha0 = alpha0; a.n0 = n0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (rule == RULE_SUM_PRODUCT)
    return launch<true, float>(llr, bits, ok, iters, c2v, edges, row_start, ncw, a, s);
  if (bf16_messages)
    return launch<false, __nv_bfloat16>(llr, bits, ok, iters, c2v, edges, row_start, ncw, a, s);
  return launch<false, float>(llr, bits, ok, iters, c2v, edges, row_start, ncw, a, s);
}

// phi on `n` values, one thread each: a test entry that holds the device
// function against the plain version.
__global__ void phi_kernel(const float* __restrict__ x, float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = phi_f32(x[i]);
}

extern "C" int ldpc_phi(const void* x, void* y, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  phi_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, n);
  return (int)cudaGetLastError();
}
