// Layered belief-propagation LDPC decoder for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel ldpc_3gpp_tpu/ops/decoder_pallas.py::_make_kernel in
// its layered configurations: min-sum / offset-min-sum / sum-product, f32
// messages or (min-sum family) bfloat16 messages, early termination or
// run-to-budget, 'd' or 'cw' input, 'sys' or 'cw' output, any row order,
// optional alpha schedule.  The plain PyTorch version of the same arithmetic
// is ops/decoder_layered.py; results are bit-identical.
//
// What bounds it on this card.  Per codeword and sweep the algorithm touches
// every edge of the lifted graph once: 2*E*Z shared-memory accesses of the
// posterior totals (one rotated read, one write back) and 2*E*Z*4 bytes of
// check-to-variable message traffic (one read, one write).  The totals
// (nc*Z*4 B = 102 KiB at BG1 Z=384) fit a block's shared memory; the messages
// (E*Z*4 B = 474 KiB per codeword at BG1 Z=384) do not, so they live in a
// global scratch tensor and their traffic goes through L2 to device memory.
// That message traffic, times the mean number of sweeps, is the kernel's
// bound with the min-sum family, well above the arithmetic (about a dozen
// integer/float operations per edge and lane); bfloat16 messages halve it.
// Sum-product evaluates phi twice per edge and lane (about 60 operations
// each, one of them a division) and is bound by that arithmetic.
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
// The check rule and the message type are compile-time instantiations of one
// kernel template (min-sum family or sum-product, float or __nv_bfloat16
// messages), so the min-sum f32 instantiation carries no branch or register
// of the others.  The check-node update, phi and the notes on bit-exactness
// are in ldpc_bp.cuh, shared with the flooding kernel.

#include "ldpc_bp.cuh"

// Two blocks per SM for the min-sum family; sum-product keeps a row's inputs
// and their phi in registers and is not held to that register budget.
template <bool SUM_PRODUCT, typename MSG>
__global__ void __launch_bounds__(MAX_THREADS, SUM_PRODUCT ? 1 : 2)
ldpc_layered_kernel(const float* __restrict__ llr, int8_t* __restrict__ bits,
                    int* __restrict__ ok_out, int* __restrict__ it_out,
                    MSG* __restrict__ c2v_all,
                    const int4* __restrict__ edges_g,
                    const int* __restrict__ row_start_g, DecodeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Z = a.Z, nc = a.nc, nr = a.nr, E = a.E;
  float* totals = reinterpret_cast<float*>(smem);
  int4* edges = reinterpret_cast<int4*>(smem + align16((size_t)nc * Z * 4));
  int* row_start = reinterpret_cast<int*>(edges + E);

  const int z = threadIdx.x;
  const bool active = z < Z;
  const size_t cw = blockIdx.x;

  for (int i = z; i < E; i += blockDim.x) edges[i] = edges_g[i];
  for (int i = z; i <= nr; i += blockDim.x) row_start[i] = row_start_g[i];

  // Channel LLRs into the totals, in variable coordinates.
  if (active)
    load_totals<false>(
        totals, nullptr, llr + cw * (size_t)((a.d_input ? nc - 2 : nc) * Z), z, a);
  __syncthreads();

  MSG* c2v = c2v_all + cw * (size_t)(E * Z) + z; // this thread's lane
  int used = a.iterations;
  bool done = false;

  for (int it = 0; it < a.iterations; ++it) {
    const bool first = it == 0; // all messages are zero: skip their read
    const float alpha_t = it < a.n0 ? a.alpha0 : a.alpha;
    unsigned bad = 0;
    for (int r = 0; r < nr; ++r) {
      const int e0 = row_start[r];
      const int deg = row_start[r + 1] - e0;
      // parity of the totals as read in this sweep
      if (active)
        bad |= check_row<SUM_PRODUCT, false, MSG>(
            totals, nullptr, c2v, edges, e0, deg, z, Z, first, alpha_t,
            a.offset_rule, a.beta);
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
extern "C" int ldpc_layered_max_shared_bytes() { return max_shared_bytes_optin(); }

// Dynamic shared memory of one block: totals, edge table, row offsets.
extern "C" int ldpc_layered_shared_bytes(int Z, int nc, int nr, int E) {
  return (int)(align16((size_t)nc * Z * 4) + (size_t)E * 16 + (size_t)(nr + 1) * 4);
}

template <bool SUM_PRODUCT, typename MSG>
static int launch(const void* llr, void* bits, void* ok, void* iters, void* c2v,
                  const void* edges, const void* row_start, int ncw,
                  const DecodeArgs& a, cudaStream_t stream) {
  const int threads = ((a.Z + 31) / 32) * 32;
  const int smem_bytes = ldpc_layered_shared_bytes(a.Z, a.nc, a.nr, a.E);
  cudaError_t err = cudaFuncSetAttribute(
      ldpc_layered_kernel<SUM_PRODUCT, MSG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  ldpc_layered_kernel<SUM_PRODUCT, MSG><<<ncw, threads, smem_bytes, stream>>>(
      (const float*)llr, (int8_t*)bits, (int*)ok, (int*)iters, (MSG*)c2v,
      (const int4*)edges, (const int*)row_start, a);
  return (int)cudaGetLastError();
}

// Launches the decoder for `ncw` codewords on `stream`.  `rule` is 0
// (min-sum), 1 (offset-min-sum) or 2 (sum-product); `bf16_messages` selects
// the scratch's element type (min-sum family only).  Does not synchronise and
// allocates nothing.  Returns cudaGetLastError().
extern "C" int ldpc_layered_decode(
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
