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
//
// Several small-Z codewords per block (ldpc_layered_packed_kernel below)
// replaces the TPU kernel's packed tiles (decoder_pallas.py::_auto_pack,
// the segment-local parity vote and the pack/unpack transposes of its
// wrapper).  What bounds a small-Z block on this card: one block per codeword
// is one warp with Z live lanes (20 of 32 at Z=20), a block-wide barrier per
// row for that one warp, a private copy of the edge table per block, and at
// most 32 resident blocks per SM, half of its 64 warps.  The packed kernel
// gives a block P codewords: thread t owns lane t % Z of codeword t / Z, one
// edge table serves all P, and the block's message scratch is laid out
// (E, P*Z) so that a row's messages are one contiguous run across the P
// codewords.  Votes and stops are per codeword (a flag word each in shared
// memory, set between two barriers); a codeword that passed stops at the
// sweep the one-codeword kernel stops at and writes nothing afterwards, its
// lanes still reach every barrier, and the block leaves when all P are done.
// It is a kernel of its own, so the one-codeword kernel keeps its registers.

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

// P codewords per block (P >= 2; see the note at the top of the file).  The
// arithmetic per codeword is the one-codeword kernel's, so the results are
// bit-identical.  Shared memory: P sets of totals, the edge table (message
// offsets scaled by P: the block's scratch is (E, P*Z)), the row offsets and
// one flag word per codeword.
template <bool SUM_PRODUCT, typename MSG>
__global__ void __launch_bounds__(MAX_THREADS, SUM_PRODUCT ? 1 : 2)
ldpc_layered_packed_kernel(const float* __restrict__ llr,
                           int8_t* __restrict__ bits, int* __restrict__ ok_out,
                           int* __restrict__ it_out, MSG* __restrict__ c2v_all,
                           const int4* __restrict__ edges_g,
                           const int* __restrict__ row_start_g, DecodeArgs a,
                           int P, int ncw) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Z = a.Z, nc = a.nc, nr = a.nr, E = a.E;
  int4* edges = reinterpret_cast<int4*>(smem + align16((size_t)P * nc * Z * 4));
  int* row_start = reinterpret_cast<int*>(edges + E);
  int* flags = row_start + nr + 1;

  const int t = threadIdx.x;
  const int k = t / Z;       // codeword of this thread within the block
  const int z = t - k * Z;   // its lane
  const size_t cw = (size_t)blockIdx.x * P + k;
  const bool active = k < P && cw < (size_t)ncw;
  float* totals = reinterpret_cast<float*>(smem) + (size_t)(active ? k : 0) * nc * Z;

  for (int i = t; i < E; i += blockDim.x) {
    int4 ed = edges_g[i];
    ed.z *= P;
    edges[i] = ed;
  }
  for (int i = t; i <= nr; i += blockDim.x) row_start[i] = row_start_g[i];

  if (active)
    load_totals<false>(
        totals, nullptr, llr + cw * (size_t)((a.d_input ? nc - 2 : nc) * Z), z, a);
  __syncthreads();

  MSG* c2v = c2v_all + (size_t)blockIdx.x * ((size_t)E * P * Z) + t;
  int used = a.iterations;
  bool passed = false;   // this thread's codeword passed its parity vote
  bool done = !active;   // nothing (more) to do for this thread

  for (int it = 0; it < a.iterations; ++it) {
    const bool first = it == 0;
    const float alpha_t = it < a.n0 ? a.alpha0 : a.alpha;
    unsigned bad = 0;
    if (t < P) flags[t] = 0;  // read last before the previous sweep's last barrier
    for (int r = 0; r < nr; ++r) {
      const int e0 = row_start[r];
      const int deg = row_start[r + 1] - e0;
      if (!done)
        bad |= check_row<SUM_PRODUCT, false, MSG>(
            totals, nullptr, c2v, edges, e0, deg, z, Z, first, alpha_t,
            a.offset_rule, a.beta);
      __syncthreads();
    }
    if (a.early_termination) {  // uniform over the block
      if (!done && (bad & SIGN_BIT)) flags[k] = 1;
      __syncthreads();
      if (!done && !flags[k]) {
        passed = done = true;
        used = it;
      }
      if (__syncthreads_and(done)) break;
    }
  }

  // Codewords that never passed (or a run to budget) get one clean syndrome
  // pass over their settled totals.  (Every earlier read of the flags lies
  // before a barrier: the vote's own, or a row's.)
  if (t < P) flags[t] = 0;
  __syncthreads();
  if (active && !passed) {
    const unsigned bad = syndrome_bits(totals, edges, row_start, nr, z, Z);
    if (bad & SIGN_BIT) flags[k] = 1;
  }
  __syncthreads();

  if (active) {
    int8_t* dst = bits + cw * (size_t)(a.out_cols * Z);
    for (int c = 0; c < a.out_cols; ++c)
      dst[c * Z + z] = totals[c * Z + z] < 0.0f;
    if (z == 0) {
      ok_out[cw] = passed || !flags[k];
      it_out[cw] = used;
    }
  }
}

extern "C" int ldpc_layered_max_degree() { return MAX_DEG; }
extern "C" int ldpc_layered_max_z() { return MAX_THREADS; }
extern "C" int ldpc_layered_max_shared_bytes() { return max_shared_bytes_optin(); }

// Dynamic shared memory of one block of P codewords: P sets of totals, edge
// table, row offsets and, for P > 1, a flag word per codeword.
extern "C" int ldpc_layered_shared_bytes(int Z, int nc, int nr, int E, int P) {
  return (int)(align16((size_t)P * nc * Z * 4) + (size_t)E * 16 +
               (size_t)(nr + 1) * 4 + (P > 1 ? (size_t)P * 4 : 0));
}

template <bool SUM_PRODUCT, typename MSG>
static int launch(const void* llr, void* bits, void* ok, void* iters, void* c2v,
                  const void* edges, const void* row_start, int ncw, int P,
                  const DecodeArgs& a, cudaStream_t stream) {
  const int threads = ((P * a.Z + 31) / 32) * 32;
  const int smem_bytes = ldpc_layered_shared_bytes(a.Z, a.nc, a.nr, a.E, P);
  if (P > 1) {
    cudaError_t err = cudaFuncSetAttribute(
        ldpc_layered_packed_kernel<SUM_PRODUCT, MSG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    ldpc_layered_packed_kernel<SUM_PRODUCT, MSG>
        <<<(ncw + P - 1) / P, threads, smem_bytes, stream>>>(
            (const float*)llr, (int8_t*)bits, (int*)ok, (int*)iters, (MSG*)c2v,
            (const int4*)edges, (const int*)row_start, a, P, ncw);
    return (int)cudaGetLastError();
  }
  cudaError_t err = cudaFuncSetAttribute(
      ldpc_layered_kernel<SUM_PRODUCT, MSG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  ldpc_layered_kernel<SUM_PRODUCT, MSG><<<ncw, threads, smem_bytes, stream>>>(
      (const float*)llr, (int8_t*)bits, (int*)ok, (int*)iters, (MSG*)c2v,
      (const int4*)edges, (const int*)row_start, a);
  return (int)cudaGetLastError();
}

template <bool SUM_PRODUCT, typename MSG>
static int occupancy(int P, int threads, int smem_bytes) {
  int n = 0;
  const void* kernel =
      P > 1 ? (const void*)ldpc_layered_packed_kernel<SUM_PRODUCT, MSG>
            : (const void*)ldpc_layered_kernel<SUM_PRODUCT, MSG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem_bytes);
  return err == cudaSuccess ? n : -(int)err;
}

// Blocks of the instantiation that `ldpc_layered_decode` would launch for these
// arguments that one SM of the current device holds at a time (registers,
// threads and shared memory considered); negative: a CUDA error code.
extern "C" int ldpc_layered_blocks_per_sm(int rule, int bf16_messages,
                                          int codewords_per_block, int Z, int nc,
                                          int nr, int E) {
  const int P = codewords_per_block;
  if (Z < 1 || P < 1 || P * Z > MAX_THREADS) return -(int)cudaErrorInvalidValue;
  const int threads = ((P * Z + 31) / 32) * 32;
  const int smem_bytes = ldpc_layered_shared_bytes(Z, nc, nr, E, P);
  if (rule == RULE_SUM_PRODUCT) return occupancy<true, float>(P, threads, smem_bytes);
  if (bf16_messages) return occupancy<false, __nv_bfloat16>(P, threads, smem_bytes);
  return occupancy<false, float>(P, threads, smem_bytes);
}

// Launches the decoder for `ncw` codewords on `stream`.  `rule` is 0
// (min-sum), 1 (offset-min-sum) or 2 (sum-product); `bf16_messages` selects
// the scratch's element type (min-sum family only).  `codewords_per_block`
// P = 1 runs one block per codeword with the scratch laid out (ncw, E, Z);
// P > 1 runs ceil(ncw / P) blocks of the packed kernel, whose scratch must
// hold ceil(ncw / P) * P * E * Z elements (a block's share is (E, P*Z)).  Does
// not synchronise and allocates nothing.  Returns cudaGetLastError().
extern "C" int ldpc_layered_decode(
    const void* llr, void* bits, void* ok, void* iters, void* c2v,
    const void* edges, const void* row_start, int ncw, int Z, int nc, int nr,
    int E, int out_cols, int d_input, int fill_lo, int fill_hi, int iterations,
    int early_termination, int rule, int bf16_messages,
    int codewords_per_block, float alpha, float beta, float alpha0, int n0,
    void* stream) {
  const int P = codewords_per_block;
  if (Z < 1 || Z > MAX_THREADS || ncw < 1) return (int)cudaErrorInvalidValue;
  if (P < 1 || P * Z > MAX_THREADS) return (int)cudaErrorInvalidValue;
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
    return launch<true, float>(llr, bits, ok, iters, c2v, edges, row_start, ncw, P, a, s);
  if (bf16_messages)
    return launch<false, __nv_bfloat16>(llr, bits, ok, iters, c2v, edges, row_start, ncw, P, a, s);
  return launch<false, float>(llr, bits, ok, iters, c2v, edges, row_start, ncw, P, a, s);
}
