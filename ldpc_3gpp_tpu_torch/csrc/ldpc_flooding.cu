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
// per edge, lane and sweep (about 65 operations each, one of them a
// division).  With the min-sum family, about a dozen operations per edge and
// lane, so what bounds it is where the messages live (E*Z*4 bytes per
// codeword: 160 KiB at BG2 Z=208, 474 KiB at BG1 Z=384) and how much of the
// sweep is latency: loads that wait on a barrier, a block too small to hide
// them, work that is not the update.
//
// What the design does about it.  One block decodes one codeword with up to
// FLOODING_MAX_THREADS threads (the wrapper picks the count from the shape and
// the batch) and two phases per sweep, one barrier after each:
//   - Message phase.  Every (base row, lane) item of the sweep is independent
//     (all read the pre-sweep totals), so the items are dealt out over the
//     block's threads, item t + k*blockDim.x to thread t, with no barrier
//     between rows: the loads of different rows overlap across the warps of
//     the SM (up to 32).  Within a thread the items run one after another,
//     and an item's loads are interleaved with its arithmetic (its degree is
//     a loop bound, not predicated slots).  Running a thread one item ahead
//     (its next item's loads issued before the current item's arithmetic)
//     was 17-21 % slower on an H100: at the 64 registers of a 1,024-thread
//     block the second item's inputs went to the stack (PERF.md §6).  The
//     check rule is the one of ldpc_bp.cuh::check_row, operation for
//     operation.  Each item stores its new messages in place, unrounded.
//   - Fused syndrome.  The same phase ORs each item's row parity (the XOR of
//     the sign bits of the totals it read), and one block vote after the
//     phase decides whether the codeword stops.  The totals are untouched
//     until the column phase, so a codeword that stops keeps exactly the
//     totals that were checked and reports iterations = the pass index; the
//     messages that pass computed are thrown away (one discarded message
//     phase per codeword, against one syndrome pass per sweep before).  The
//     pass at it == iterations, and the single check of a run to budget, only
//     reads the parity.
//   - Column phase.  One (column, lane) item per thread at a time adds up its
//     column's messages in ascending row order from the column plan (the
//     column's first edge assigned, the later ones added with __fadd_rn) and
//     writes totals = llr + sum as the channel LLRs are read ('d' synthesis,
//     filler pinning): the same operations in the same order as the
//     reference's column sums, with no atomics and no barrier per row.
//   - Messages on chip.  Totals, all E*Z messages and the two plans fit one
//     block's 232,448 bytes up to BG2 Z=224 and BG1 Z=144 (P2's BG2 Z=208
//     takes 210,704 B): then one block holds the codeword.  Above that a
//     thread block cluster of 2 or 3 blocks on neighbouring SMs holds it
//     (ldpc_flooding_cluster_kernel below; 3 at BG1 Z=384), each block with
//     its share of the rows' messages and of the columns' totals, the other
//     shares reached through distributed shared memory.  Either way the
//     messages never touch device memory and no scratch exists.  The other
//     candidate, a global scratch written by the message phase and read back
//     by the column phase (two blocks per SM at BG1 Z=384), was slower on an
//     H100 at snr_vs_a's A=8000 launch (256 codewords, 50 iterations;
//     PERF.md §6): a launch of a sweep lasts as long as its slowest
//     codewords, and a cluster gives each of them three SMs.
//     The wrapper chooses the layout by shape
//     (ops/decoder_cuda.py::flooding_layout); no result depends on it.
//   - bfloat16 messages.  The column sums take the unrounded message and the
//     next sweep subtracts the rounded one (the reference's semantics), so
//     both must be at hand between the two phases: messages are kept in
//     float32 and rounded to bfloat16 (round to nearest even) where they are
//     read back.  That gives the same bits as storing them rounded, and the
//     same on-chip limits as float32.
//   - Sweep 0 reads no messages (they are zero), so they are never
//     zero-filled.  The channel LLRs are re-read from the input in every
//     column phase (coalesced, from L2) instead of kept as a third copy.
// The check rule's arithmetic, phi and the notes on bit-exactness are in
// ldpc_bp.cuh, shared with the layered kernel.
//
// Several small-Z codewords per block (ldpc_flooding_packed_kernel below)
// replaces the TPU kernel's packed tiles (decoder_pallas.py::_auto_pack and
// its segment-local parity vote); ldpc_layered.cu says what bounds a small-Z
// block on this card and what the packed layout does about it.  Here a block
// holds P sets of totals and column sums, and a codeword whose syndrome
// passed stops as the one-codeword kernel does while its lanes go on to
// every barrier until all P codewords of the block are done.  It runs one
// barrier per base row and a separate syndrome pass, as the first form of the
// one-codeword kernel did.

#include <cooperative_groups.h>

#include "ldpc_bp.cuh"

namespace cg = cooperative_groups;

// Threads of a one-codeword block at most, and what its registers are held
// to: one such block fills an SM's 64K registers.
#define FLOODING_MAX_THREADS 1024

// Dynamic shared memory of a one-codeword block: the totals and the E*Z
// messages, in float32; the row plan (E int2) and the column plan (E int2);
// the row and column offsets.  The wrapper's flooding_shared_bytes repeats
// this formula and the cluster's below (a CPU test holds them equal).
#define FLOODING_SHARED_BYTES(Z, nc, nr, E)                             \
  (align16((size_t)(nc + E) * Z * 4) + (size_t)E * 16 + \
   (size_t)(nr + nc + 2) * 4)

// Shared memory of one block of a cluster (layout (a)): its columns' totals
// (cols_max columns), its rows' messages (edges_max edges), the full row and
// column plans, their offsets, the split and the vote words (64 bytes).
#define FLOODING_CLUSTER_SHARED_BYTES(Z, nc, nr, E, cols_max, edges_max)          \
  (align16((size_t)cols_max * Z * 4) + align16((size_t)edges_max * Z * 4) + \
   (size_t)E * 16 + (size_t)(nr + nc + 2) * 4 + 64)
#define MAX_CLUSTER 3  // the largest cluster: three blocks hold BG1 Z=384
// A cluster plan entry: the owning block's rank above OWNER_SHIFT, the offset
// in its shared memory below.
#define OWNER_SHIFT 24
#define OFFSET_MASK 0xffffff

// Where the message phase reads the totals: this block's shared memory, or
// (layout (a)) the shared memory of the cluster's block that owns the column.
struct LocalTotals {
  const float* t;
  __device__ __forceinline__ float operator()(int x, int idx) const { return t[x + idx]; }
};
struct ClusterTotals {
  float* t;
  __device__ __forceinline__ float operator()(int x, int idx) const {
    return *cg::this_cluster().map_shared_rank(t + ((x & OFFSET_MASK) + idx),
                                               (unsigned)(x >> OWNER_SHIFT));
  }
};

// A message as the next sweep subtracts it: float32, or rounded to bfloat16.
template <bool BF16>
__device__ __forceinline__ float stored(float m) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(m));
  return m;
}

// One (row, lane) item of the message phase: check z of a base row whose
// edges are red[0..deg) (column offset, shift), its messages at msg[i*Z].
// The check rule of ldpc_bp.cuh::check_row (flooding), operation for
// operation; the new messages are stored unrounded in place.  Returns the
// XOR of the sign bits of the totals read (the row's parity at check z).
// The slots are unrolled to MAX_DEG and left at the row's degree (a branch
// out, not predicated slots: a block's rows have degrees 3 to 19).
template <bool SUM_PRODUCT, bool BF16, typename Totals>
__device__ __forceinline__ unsigned message_item(
    Totals totals, float* msg, const int2* red, int deg,
    int z, int Z, bool first, float alpha_t, int offset_rule, float beta) {
  unsigned par = 0;
  if constexpr (!SUM_PRODUCT) {
    float v[MAX_DEG];
    unsigned sx = 0, m1 = MAG_INF, m2 = MAG_INF;
#pragma unroll
    for (int i = 0; i < MAX_DEG; ++i) {
      if (i >= deg) break;
      {
        const int2 ed = red[i];
        const float t = totals(ed.x, rot(z, ed.y, Z));
        par ^= __float_as_uint(t);
        const float ve = first ? t : __fsub_rn(t, stored<BF16>(msg[i * Z]));
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
#pragma unroll
    for (int i = 0; i < MAX_DEG; ++i) {
      if (i >= deg) break;
      {
        const unsigned b = __float_as_uint(v[i]);
        const unsigned mag = (b & MAG_MASK) == m1 ? m2s : m1s;
        msg[i * Z] = __uint_as_float(mag ^ (b & SIGN_BIT));
      }
    }
  } else {
    float ph[MAX_DEG];
    unsigned neg = 0;
    float T = 0.0f;
#pragma unroll
    for (int i = 0; i < MAX_DEG; ++i) {
      if (i >= deg) break;
      {
        const int2 ed = red[i];
        const float t = totals(ed.x, rot(z, ed.y, Z));
        par ^= __float_as_uint(t);
        const float ve = first ? t : __fsub_rn(t, msg[i * Z]);
        neg |= (ve < 0.0f ? 1u : 0u) << i;
        const float p = phi_f32(fabsf(ve));
        ph[i] = p;
        T = i == 0 ? p : __fadd_rn(T, p);
      }
    }
    const unsigned sx = __popc(neg) & 1u;
#pragma unroll
    for (int i = 0; i < MAX_DEG; ++i) {
      if (i >= deg) break;
      {
        const float mag = phi_f32(fmaxf(__fsub_rn(T, ph[i]), 1e-9f));
        // (+-1) * mag: an exact sign flip, also of a -0.0 magnitude
        const unsigned s = (sx ^ (neg >> i)) & 1u;
        msg[i * Z] = __uint_as_float(__float_as_uint(mag) ^ (s << 31));
      }
    }
  }
  return par;
}

// The row parity at check z alone (the pass that only checks).
template <typename Totals>
__device__ __forceinline__ unsigned parity_item(Totals totals, const int2* red,
                                                int deg, int z, int Z) {
  unsigned par = 0;
  for (int i = 0; i < deg; ++i) {
    const int2 ed = red[i];
    par ^= __float_as_uint(totals(ed.x, rot(z, ed.y, Z)));
  }
  return par;
}

// Channel LLR of lane z of column c in variable coordinates: 'd' input has
// the 2Z punctured positions at +0.0 and its filler range pinned.
__device__ __forceinline__ float channel_llr(const float* src, int c, int z,
                                             const DecodeArgs& a) {
  if (!a.d_input) return src[c * a.Z + z];
  if (c < 2) return 0.0f;
  const int j = (c - 2) * a.Z + z;
  return (j >= a.fill_lo && j < a.fill_hi) ? FILLER_LLR : src[j];
}

// The check lane whose message reaches variable lane z of an edge of shift
// `shift`: (z - shift) mod Z, the inverse of rot.
__device__ __forceinline__ int unrot(int z, int shift, int Z) {
  const int idx = z - shift;
  return idx < 0 ? idx + Z : idx;
}

// Walks the items t, t + T, t + 2T, ... of a (major, lane) range with Z lanes
// per major index, without a division per step.
struct ItemWalk {
  int major, lane, d_major, d_lane, Z;
  __device__ ItemWalk(int t, int T, int Z_) : Z(Z_) {
    major = t / Z;
    lane = t - major * Z;
    d_major = T / Z;
    d_lane = T - d_major * Z;
  }
  __device__ void next() {
    major += d_major;
    lane += d_lane;
    if (lane >= Z) {
      lane -= Z;
      ++major;
    }
  }
};

// One codeword per block.  Shared memory: totals (nc*Z), the messages (E*Z,
// slot e = the edge's position in row order), the row plan, the column plan,
// the row offsets and the column offsets (FLOODING_SHARED_BYTES).
template <bool SUM_PRODUCT, bool BF16>
__global__ void __launch_bounds__(FLOODING_MAX_THREADS, 1)
ldpc_flooding_kernel(const float* __restrict__ llr, int8_t* __restrict__ bits,
                     int* __restrict__ ok_out, int* __restrict__ it_out,
                     const int4* __restrict__ edges_g,
                     const int* __restrict__ row_start_g,
                     const int2* __restrict__ col_edges_g,
                     const int* __restrict__ col_start_g, DecodeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Z = a.Z, nc = a.nc, nr = a.nr, E = a.E;
  float* totals = reinterpret_cast<float*>(smem);
  float* msgs = totals + nc * Z;
  int2* red = reinterpret_cast<int2*>(smem + align16((size_t)(nc + E) * Z * 4));
  int2* ced = red + E;
  int* row_start = reinterpret_cast<int*>(ced + E);
  int* col_start = row_start + nr + 1;

  const int t = threadIdx.x, T = blockDim.x;
  const size_t cw = blockIdx.x;

  for (int i = t; i < E; i += T) {
    const int4 ed = edges_g[i];
    red[i] = make_int2(ed.x, ed.y);
    ced[i] = col_edges_g[i];
  }
  for (int i = t; i <= nr; i += T) row_start[i] = row_start_g[i];
  for (int i = t; i <= nc; i += T) col_start[i] = col_start_g[i];

  const float* src = llr + cw * (size_t)((a.d_input ? nc - 2 : nc) * Z);
  {
    ItemWalk w(t, T, Z);
    for (int i = t; i < nc * Z; i += T, w.next())
      totals[i] = channel_llr(src, w.major, w.lane, a);
  }
  __syncthreads();

  int ok = 0;
  int used = a.iterations;
  for (int it = 0;; ++it) {
    // Message phase with the fused syndrome; the pass at it == iterations
    // only checks.  Early termination acts on every vote, a run to budget on
    // the last one only.
    const bool update = it < a.iterations;
    unsigned bad = 0;
    {
      ItemWalk w(t, T, Z);
      if (update) {
        const bool first = it == 0; // all messages are zero: skip their read
        const float alpha_t = it < a.n0 ? a.alpha0 : a.alpha;
        for (int i = t; i < nr * Z; i += T, w.next()) {
          const int e0 = row_start[w.major];
          bad |= message_item<SUM_PRODUCT, BF16>(
              LocalTotals{totals}, msgs + (size_t)e0 * Z + w.lane, red + e0,
              row_start[w.major + 1] - e0, w.lane, Z, first, alpha_t,
              a.offset_rule, a.beta);
        }
      } else {
        for (int i = t; i < nr * Z; i += T, w.next()) {
          const int e0 = row_start[w.major];
          bad |= parity_item(LocalTotals{totals}, red + e0,
                             row_start[w.major + 1] - e0, w.lane, Z);
        }
      }
    }
    if (!__syncthreads_or(bad & SIGN_BIT) && (a.early_termination || !update)) {
      ok = 1; // uniform over the block
      if (a.early_termination) used = it;
      break;
    }
    if (!update) break;

    // Column phase: totals = llr + the column's messages in row order.
    {
      ItemWalk w(t, T, Z);
      for (int i = t; i < nc * Z; i += T, w.next()) {
        const float v = channel_llr(src, w.major, w.lane, a);
        const int k1 = col_start[w.major + 1];
        int k = col_start[w.major];
        int2 ce = ced[k];
        float sum = msgs[ce.x + unrot(w.lane, ce.y, Z)];
#pragma unroll 4
        for (++k; k < k1; ++k) {
          ce = ced[k];
          sum = __fadd_rn(sum, msgs[ce.x + unrot(w.lane, ce.y, Z)]);
        }
        totals[i] = __fadd_rn(v, sum);
      }
    }
    __syncthreads();
  }

  int8_t* dst = bits + cw * (size_t)(a.out_cols * Z);
  for (int i = t; i < a.out_cols * Z; i += T) dst[i] = totals[i] < 0.0f;
  if (t == 0) {
    ok_out[cw] = ok;
    it_out[cw] = used;
  }
}


// Layout (a): a thread block cluster of CS blocks decodes one codeword on
// neighbouring SMs.  Block b owns the base rows [row_lo[b], row_lo[b+1])
// (about E/CS edges: their messages stay in its shared memory) and the
// columns [col_lo[b], col_lo[b+1]) (their totals).  The message phase reads
// the totals of other blocks' columns, and the column phase the messages of
// other blocks' rows, through distributed shared memory; the phases are
// separated by cluster barriers, and the vote is one word per block written
// into every block of the cluster.  `splits` holds row_lo[0..CS] and
// col_lo[0..CS].  The arithmetic and its order are the one-block kernel's.
template <bool SUM_PRODUCT, bool BF16>
__global__ void __launch_bounds__(FLOODING_MAX_THREADS, 1)
ldpc_flooding_cluster_kernel(const float* __restrict__ llr, int8_t* __restrict__ bits,
                             int* __restrict__ ok_out, int* __restrict__ it_out,
                             const int4* __restrict__ edges_g,
                             const int* __restrict__ row_start_g,
                             const int2* __restrict__ col_edges_g,
                             const int* __restrict__ col_start_g,
                             const int* __restrict__ splits_g, DecodeArgs a,
                             int cols_max, int edges_max) {
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks();
  const int b = (int)cluster.block_rank();
  extern __shared__ __align__(16) unsigned char smem[];
  const int Z = a.Z, nc = a.nc, nr = a.nr, E = a.E;
  float* totals = reinterpret_cast<float*>(smem);
  float* msgs = reinterpret_cast<float*>(smem + align16((size_t)cols_max * Z * 4));
  int2* red = reinterpret_cast<int2*>(reinterpret_cast<unsigned char*>(msgs) +
                                      align16((size_t)edges_max * Z * 4));
  int2* ced = red + E;
  int* row_start = reinterpret_cast<int*>(ced + E);
  int* col_start = row_start + nr + 1;
  int* row_lo = col_start + nc + 1;
  int* col_lo = row_lo + MAX_CLUSTER + 1;
  int* votes = col_lo + MAX_CLUSTER + 1;

  const int t = threadIdx.x, T = blockDim.x;
  const size_t cw = blockIdx.x / CS;

  for (int i = t; i <= nr; i += T) row_start[i] = row_start_g[i];
  for (int i = t; i <= nc; i += T) col_start[i] = col_start_g[i];
  for (int i = t; i <= CS; i += T) {
    row_lo[i] = splits_g[i];
    col_lo[i] = splits_g[CS + 1 + i];
  }
  __syncthreads();
  // the plans in cluster form: (owner << OWNER_SHIFT | offset in its block)
  for (int i = t; i < E; i += T) {
    const int4 ed = edges_g[i];
    const int c = ed.x / Z;
    int o = 0;
    while (o + 1 < CS && c >= col_lo[o + 1]) ++o;
    red[i] = make_int2((o << OWNER_SHIFT) | ((c - col_lo[o]) * Z), ed.y);
    const int2 ce = col_edges_g[i];
    const int slot = ce.x / Z;
    int q = 0;
    while (q + 1 < CS && slot >= row_start[row_lo[q + 1]]) ++q;
    ced[i] = make_int2((q << OWNER_SHIFT) | ((slot - row_start[row_lo[q]]) * Z), ce.y);
  }
  const int c0 = col_lo[b], ncols = col_lo[b + 1] - c0;
  const int r0 = row_lo[b], nrows = row_lo[b + 1] - r0;
  const int e_lo = row_start[r0];

  const float* src = llr + cw * (size_t)((a.d_input ? nc - 2 : nc) * Z);
  {
    ItemWalk w(t, T, Z);
    for (int i = t; i < ncols * Z; i += T, w.next())
      totals[i] = channel_llr(src, c0 + w.major, w.lane, a);
  }
  cluster.sync();

  int ok = 0;
  int used = a.iterations;
  for (int it = 0;; ++it) {
    const bool update = it < a.iterations;
    unsigned bad = 0;
    {
      ItemWalk w(t, T, Z);
      if (update) {
        const bool first = it == 0;
        const float alpha_t = it < a.n0 ? a.alpha0 : a.alpha;
        for (int i = t; i < nrows * Z; i += T, w.next()) {
          const int e0 = row_start[r0 + w.major];
          bad |= message_item<SUM_PRODUCT, BF16>(
              ClusterTotals{totals}, msgs + (size_t)(e0 - e_lo) * Z + w.lane,
              red + e0, row_start[r0 + w.major + 1] - e0, w.lane, Z, first,
              alpha_t, a.offset_rule, a.beta);
        }
      } else {
        for (int i = t; i < nrows * Z; i += T, w.next()) {
          const int e0 = row_start[r0 + w.major];
          bad |= parity_item(ClusterTotals{totals}, red + e0,
                             row_start[r0 + w.major + 1] - e0, w.lane, Z);
        }
      }
    }
    // this block's vote into every block of the cluster, then one barrier
    const int vote = __syncthreads_or(bad & SIGN_BIT) ? 1 : 0;
    if (t < CS) *cluster.map_shared_rank(votes + b, (unsigned)t) = vote;
    cluster.sync();
    int any_bad = 0;
    for (int q = 0; q < CS; ++q) any_bad |= votes[q];
    if (!any_bad && (a.early_termination || !update)) {
      ok = 1; // uniform over the cluster
      if (a.early_termination) used = it;
      break;
    }
    if (!update) break;

    {
      ItemWalk w(t, T, Z);
      for (int i = t; i < ncols * Z; i += T, w.next()) {
        const int c = c0 + w.major;
        const float v = channel_llr(src, c, w.lane, a);
        const int k1 = col_start[c + 1];
        int k = col_start[c];
        int2 ce = ced[k];
        float sum = *cluster.map_shared_rank(
            msgs + ((ce.x & OFFSET_MASK) + unrot(w.lane, ce.y, Z)),
            (unsigned)(ce.x >> OWNER_SHIFT));
#pragma unroll 4
        for (++k; k < k1; ++k) {
          ce = ced[k];
          sum = __fadd_rn(sum, *cluster.map_shared_rank(
                                   msgs + ((ce.x & OFFSET_MASK) + unrot(w.lane, ce.y, Z)),
                                   (unsigned)(ce.x >> OWNER_SHIFT)));
        }
        totals[i] = __fadd_rn(v, sum);
      }
    }
    cluster.sync();
  }

  const int out_cols = min(ncols, max(a.out_cols - c0, 0));
  int8_t* dst = bits + cw * (size_t)(a.out_cols * Z) + (size_t)c0 * Z;
  for (int i = t; i < out_cols * Z; i += T) dst[i] = totals[i] < 0.0f;
  if (b == 0 && t == 0) {
    ok_out[cw] = ok;
    it_out[cw] = used;
  }
}

// P codewords per block (P >= 2): thread t owns lane t % Z of codeword t / Z.
// Per codeword the arithmetic and the stopping rule are the one-codeword
// kernel's, so the results are bit-identical.  Shared memory: P sets of
// totals, P sets of column sums, the edge table (message offsets scaled by P:
// the block's scratch is (E, P*Z)), the row offsets, a flag word per codeword.
template <bool SUM_PRODUCT, typename MSG>
__global__ void __launch_bounds__(MAX_THREADS, 1)
ldpc_flooding_packed_kernel(const float* __restrict__ llr,
                            int8_t* __restrict__ bits, int* __restrict__ ok_out,
                            int* __restrict__ it_out, MSG* __restrict__ c2v_all,
                            const int4* __restrict__ edges_g,
                            const int* __restrict__ row_start_g, DecodeArgs a,
                            int P, int ncw) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Z = a.Z, nc = a.nc, nr = a.nr, E = a.E;
  int4* edges = reinterpret_cast<int4*>(smem + align16((size_t)2 * P * nc * Z * 4));
  int* row_start = reinterpret_cast<int*>(edges + E);
  int* flags = row_start + nr + 1;

  const int t = threadIdx.x;
  const int k = t / Z;       // codeword of this thread within the block
  const int z = t - k * Z;   // its lane
  const size_t cw = (size_t)blockIdx.x * P + k;
  const bool active = k < P && cw < (size_t)ncw;
  float* totals = reinterpret_cast<float*>(smem) + (size_t)(active ? k : 0) * nc * Z;
  float* acc = totals + (size_t)P * nc * Z;

  for (int i = t; i < E; i += blockDim.x) {
    int4 ed = edges_g[i];
    ed.z *= P;
    edges[i] = ed;
  }
  for (int i = t; i <= nr; i += blockDim.x) row_start[i] = row_start_g[i];

  const float* src = llr + (active ? cw : 0) * (size_t)((a.d_input ? nc - 2 : nc) * Z);
  if (active) load_totals<false>(totals, nullptr, src, z, a);
  __syncthreads();

  MSG* c2v = c2v_all + (size_t)blockIdx.x * ((size_t)E * P * Z) + t;
  int ok = 0;
  int used = a.iterations;
  bool done = !active;  // nothing (more) to do for this thread

  for (int it = 0;; ++it) {
    // Early termination checks before every update and once after the last;
    // a run to budget checks only the final state.  Uniform over the block.
    if (a.early_termination || it == a.iterations) {
      if (t < P) flags[t] = 0;
      __syncthreads();
      if (!done) {
        const unsigned bad = syndrome_bits(totals, edges, row_start, nr, z, Z);
        if (bad & SIGN_BIT) flags[k] = 1;
      }
      __syncthreads();
      if (!done && !flags[k]) {
        ok = 1;
        if (a.early_termination) used = it;
        done = true;
      }
      if (it == a.iterations) break;
      if (__syncthreads_and(done)) break;
    }

    const bool first = it == 0;
    const float alpha_t = it < a.n0 ? a.alpha0 : a.alpha;
    for (int r = 0; r < nr; ++r) {
      const int e0 = row_start[r];
      if (!done)
        check_row<SUM_PRODUCT, true, MSG>(totals, acc, c2v, edges, e0,
                                          row_start[r + 1] - e0, z, Z, first,
                                          alpha_t, a.offset_rule, a.beta);
      __syncthreads();
    }
    if (!done) load_totals<true>(totals, acc, src, z, a);
    __syncthreads();
  }

  if (active) {
    int8_t* dst = bits + cw * (size_t)(a.out_cols * Z);
    for (int c = 0; c < a.out_cols; ++c)
      dst[c * Z + z] = totals[c * Z + z] < 0.0f;
    if (z == 0) {
      ok_out[cw] = ok;
      it_out[cw] = used;
    }
  }
}

extern "C" int ldpc_flooding_max_degree() { return MAX_DEG; }
extern "C" int ldpc_flooding_max_z() { return MAX_THREADS; }
extern "C" int ldpc_flooding_max_shared_bytes() { return max_shared_bytes_optin(); }

// Dynamic shared memory of one block, by `layout`: for P = 1
// FLOODING_SHARED_BYTES (1: one block per codeword) or
// FLOODING_CLUSTER_SHARED_BYTES for a cluster of `layout` blocks per
// codeword (2 to MAX_CLUSTER; `cols_max`, `edges_max`: the most columns and
// edges a block of it owns); for P > 1 the packed kernel's P sets of totals
// and of column sums, edge table, row offsets and a flag word per codeword.
extern "C" int ldpc_flooding_shared_bytes(int Z, int nc, int nr, int E, int P,
                                          int layout, int cols_max, int edges_max) {
  if (P > 1)
    return (int)(align16((size_t)2 * P * nc * Z * 4) + (size_t)E * 16 +
                 (size_t)(nr + 1) * 4 + (size_t)P * 4);
  if (layout >= 2)
    return (int)FLOODING_CLUSTER_SHARED_BYTES(Z, nc, nr, E, cols_max, edges_max);
  return (int)FLOODING_SHARED_BYTES(Z, nc, nr, E);
}

// The instantiation that serves (rule, message type, P, layout), and its
// launch.
template <bool SUM_PRODUCT, bool BF16, typename MSG>
static const void* kernel_for(int P, int layout) {
  if (P > 1) return (const void*)ldpc_flooding_packed_kernel<SUM_PRODUCT, MSG>;
  if (layout >= 2) return (const void*)ldpc_flooding_cluster_kernel<SUM_PRODUCT, BF16>;
  return (const void*)ldpc_flooding_kernel<SUM_PRODUCT, BF16>;
}

static const void* select_kernel(int rule, int bf16_messages, int P, int layout) {
  if (rule == RULE_SUM_PRODUCT) return kernel_for<true, false, float>(P, layout);
  if (bf16_messages) return kernel_for<false, true, __nv_bfloat16>(P, layout);
  return kernel_for<false, false, float>(P, layout);
}

struct Plans {
  const int4* edges;
  const int* row_start;
  const int2* col_edges;
  const int* col_start;
  const int* splits;
};

template <bool SUM_PRODUCT, bool BF16, typename MSG>
static cudaError_t launch(const void* llr, void* bits, void* ok, void* iters,
                          void* c2v, const Plans& g, int ncw, int P, int layout,
                          int threads, int smem_bytes, int cols_max,
                          int edges_max, const DecodeArgs& a, cudaStream_t s) {
  const float* x = (const float*)llr;
  int8_t* y = (int8_t*)bits;
  if (P > 1) {
    ldpc_flooding_packed_kernel<SUM_PRODUCT, MSG>
        <<<(ncw + P - 1) / P, threads, smem_bytes, s>>>(
            x, y, (int*)ok, (int*)iters, (MSG*)c2v, g.edges, g.row_start, a, P, ncw);
  } else if (layout >= 2) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)ncw * (unsigned)layout);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = (size_t)smem_bytes;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)layout;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, ldpc_flooding_cluster_kernel<SUM_PRODUCT, BF16>,
                              x, y, (int*)ok, (int*)iters, g.edges, g.row_start,
                              g.col_edges, g.col_start, g.splits, a, cols_max,
                              edges_max);
  } else {
    ldpc_flooding_kernel<SUM_PRODUCT, BF16><<<ncw, threads, smem_bytes, s>>>(
        x, y, (int*)ok, (int*)iters, g.edges, g.row_start, g.col_edges,
        g.col_start, a);
  }
  return cudaSuccess;
}

// Block size: the packed kernel's P*Z lanes in whole warps, or the wrapper's
// `threads` for one codeword per block or cluster.
static int block_threads(int P, int Z, int threads) {
  return P > 1 ? ((P * Z + 31) / 32) * 32 : threads;
}

static bool valid_shape(int Z, int P, int layout, int threads) {
  if (Z < 1 || Z > MAX_THREADS || P < 1) return false;
  if (P > 1) return P * Z <= MAX_THREADS;
  if (layout < 1 || layout > MAX_CLUSTER) return false;
  return threads >= 32 && threads <= FLOODING_MAX_THREADS && threads % 32 == 0;
}

// Blocks of the instantiation that `ldpc_flooding_decode` would launch for
// these arguments that one SM of the current device holds at a time
// (registers, threads and shared memory considered); negative: a CUDA error
// code.
extern "C" int ldpc_flooding_blocks_per_sm(int rule, int bf16_messages,
                                          int codewords_per_block, int Z, int nc,
                                          int nr, int E, int layout, int threads,
                                          int cols_max, int edges_max) {
  const int P = codewords_per_block;
  if (!valid_shape(Z, P, layout, threads)) return -(int)cudaErrorInvalidValue;
  const int smem_bytes =
      ldpc_flooding_shared_bytes(Z, nc, nr, E, P, layout, cols_max, edges_max);
  const void* kernel = select_kernel(rule, bf16_messages, P, layout);
  int n = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kernel, block_threads(P, Z, threads), smem_bytes);
  return err == cudaSuccess ? n : -(int)err;
}

// Launches the decoder for `ncw` codewords on `stream`.  `edges` / `row_start`
// is the row plan in ascending row order, `col_edges` / `col_start` the
// column plan (per column, (message slot * Z, shift) of its edges in
// ascending row order; slot = the edge's position in the row plan).  `rule`
// is 0 (min-sum), 1 (offset-min-sum) or 2 (sum-product); `bf16_messages`
// rounds the messages to bfloat16 where they are read back (min-sum family
// only).  `codewords_per_block` P = 1 runs one codeword per block (`layout`
// 1) or per cluster of `layout` blocks (2 to MAX_CLUSTER, split by `splits`:
// row_lo[0..layout], col_lo[0..layout]; `cols_max`, `edges_max` the most
// columns and edges of a block), `threads` threads per block, messages in
// shared memory, `c2v` null.  P > 1 runs ceil(ncw / P) blocks of the packed
// kernel, whose scratch `c2v` (float32 or bfloat16) must hold
// ceil(ncw / P) * P * E * Z elements.  Does not synchronise and allocates
// nothing.  Returns cudaGetLastError().
extern "C" int ldpc_flooding_decode(
    const void* llr, void* bits, void* ok, void* iters, void* c2v,
    const void* edges, const void* row_start, const void* col_edges,
    const void* col_start, const void* splits, int ncw, int Z, int nc, int nr,
    int E, int out_cols, int d_input, int fill_lo, int fill_hi, int iterations,
    int early_termination, int rule, int bf16_messages,
    int codewords_per_block, int layout, int threads, int cols_max,
    int edges_max, float alpha, float beta, float alpha0, int n0, void* stream) {
  const int P = codewords_per_block;
  if (ncw < 1 || !valid_shape(Z, P, layout, threads)) return (int)cudaErrorInvalidValue;
  if (rule < RULE_MIN_SUM || rule > RULE_SUM_PRODUCT) return (int)cudaErrorInvalidValue;
  if (rule == RULE_SUM_PRODUCT && bf16_messages) return (int)cudaErrorInvalidValue;
  if ((P > 1) != (c2v != nullptr)) return (int)cudaErrorInvalidValue;
  DecodeArgs a;
  a.Z = Z; a.nc = nc; a.nr = nr; a.E = E; a.out_cols = out_cols;
  a.d_input = d_input; a.fill_lo = fill_lo; a.fill_hi = fill_hi;
  a.iterations = iterations; a.early_termination = early_termination;
  a.offset_rule = rule == RULE_OFFSET_MIN_SUM;
  a.alpha = alpha; a.beta = beta; a.alpha0 = alpha0; a.n0 = n0;
  const void* kernel = select_kernel(rule, bf16_messages, P, layout);
  const int smem_bytes =
      ldpc_flooding_shared_bytes(Z, nc, nr, E, P, layout, cols_max, edges_max);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const Plans g = {(const int4*)edges, (const int*)row_start,
                   (const int2*)col_edges, (const int*)col_start,
                   (const int*)splits};
  const cudaStream_t st = (cudaStream_t)stream;
  const int T = block_threads(P, Z, threads);
  if (rule == RULE_SUM_PRODUCT)
    err = launch<true, false, float>(llr, bits, ok, iters, c2v, g, ncw, P, layout, T,
                                     smem_bytes, cols_max, edges_max, a, st);
  else if (bf16_messages)
    err = launch<false, true, __nv_bfloat16>(llr, bits, ok, iters, c2v, g, ncw, P,
                                             layout, T, smem_bytes, cols_max,
                                             edges_max, a, st);
  else
    err = launch<false, false, float>(llr, bits, ok, iters, c2v, g, ncw, P, layout, T,
                                      smem_bytes, cols_max, edges_max, a, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
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
