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
//     check rule is the reference's (ops/decoder_fast.py), operation for
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
// its segment-local parity vote).  What bounds it on this card: a block of P
// codewords lasts as long as its slowest one, and a small-Z codeword is
// little work for the threads it holds (config #1, Z=20: 840 message and
// 1,040 column items per sweep).  Its first form, a thread per (codeword,
// lane) with a barrier per base row, a separate syndrome pass and the
// messages in a global scratch, took 6.2-6.3 ms on an H100 at config #1's
// launch with 4 codewords per block (2,048 codewords, 50 iterations) against
// 0.87-0.90 ms for one codeword per block.  It now runs the one-codeword
// kernel's two phases over the items of the block's codewords still running,
// so that a block's last codeword gets all of its threads, with the messages
// on chip where P codewords' fit: 1.14-1.19 ms at that launch.  It stays
// above the one-codeword kernel there: its larger blocks give an SM two
// barrier domains instead of eight, and each item looks up its codeword
// first (tools/flooding_shapes.py times both, also run to the budget);
// handing a finished codeword's slot the launch's next codeword was no
// faster (PERF.md section 6).

#include <cooperative_groups.h>

#include <type_traits>

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
// edges are red[0..deg) (column offset, shift), its messages at msg[i*Z]
// (`msg` a float* or a GlobalMessages).  The reference's check rule
// (ops/decoder_fast.py), operation for operation; the new messages are
// stored unrounded in place.  Returns the
// XOR of the sign bits of the totals read (the row's parity at check z).
// The slots are unrolled to MAX_DEG and left at the row's degree (a branch
// out, not predicated slots: a block's rows have degrees 3 to 19).
template <bool SUM_PRODUCT, bool BF16, typename Totals, typename Msgs>
__device__ __forceinline__ unsigned message_item(
    Totals totals, Msgs msg, const int2* red, int deg,
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
    // With the messages in the packed kernel's global scratch, phi_i waits
    // in its edge's message slot (read, then overwritten, by this item
    // alone), not in registers: at 64 registers the MAX_DEG of them spilled.
    constexpr bool PHI_IN_SLOT = !std::is_pointer<Msgs>::value;
    float ph[PHI_IN_SLOT ? 1 : MAX_DEG];
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
        if constexpr (PHI_IN_SLOT)
          msg[i * Z] = p;
        else
          ph[i] = p;
        T = i == 0 ? p : __fadd_rn(T, p);
      }
    }
    const unsigned sx = __popc(neg) & 1u;
#pragma unroll
    for (int i = 0; i < MAX_DEG; ++i) {
      if (i >= deg) break;
      {
        float p;
        if constexpr (PHI_IN_SLOT)
          p = msg[i * Z];
        else
          p = ph[i];
        const float mag = phi_f32(fmaxf(__fsub_rn(T, p), 1e-9f));
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

// An item's messages in the packed kernel's global scratch: a 32-bit offset
// from the block's share, so that an item's up to MAX_DEG message addresses
// are not 64-bit values held from the load to the store (at 64 registers
// they spilled).
struct GlobalMessages {
  float* base;
  int off;
  __device__ __forceinline__ float& operator[](int i) const { return base[off + i]; }
};

// Walks the items t, t + T, t + 2T, ... of a (major, row, lane) range with
// Z lanes per row and R rows per major index, without a division per step.
struct ItemWalk3 {
  int major, row, lane, d_major, d_row, d_lane, Z, R;
  __device__ ItemWalk3(int t, int T, int Z_, int R_) : Z(Z_), R(R_) {
    int m = t / Z;
    lane = t - m * Z;
    major = m / R;
    row = m - major * R;
    m = T / Z;
    d_lane = T - m * Z;
    d_major = m / R;
    d_row = m - d_major * R;
  }
  __device__ void next() {
    lane += d_lane;
    row += d_row;
    major += d_major;
    if (lane >= Z) {
      lane -= Z;
      ++row;
    }
    if (row >= R) {
      row -= R;
      ++major;
    }
  }
};

// P codewords per block (P >= 2), in the one-codeword kernel's two phases.
// The block's items are those of its live codewords: item i of the message
// phase is (live[i / (nr*Z)], row, lane), of the column phase (live[i /
// (nc*Z)], column, lane), dealt over all of the block's threads, so a
// block's last running codeword gets all of them.  The arithmetic per item
// and the stopping rule are the one-codeword kernel's: bit-identical results.
// Per sweep: message phase (each item ORs its row parity into its
// codeword's flag word), one barrier (its OR says whether any codeword
// goes on), the vote, column phase, one barrier.  The vote: warp 0 writes
// the results of the codewords that stop and the next sweep's live list
// while the column phase runs, skipping items of codewords that just
// stopped; the flag words and live lists are double-buffered by sweep, so
// each is written one barrier after its last read.  A codeword that stops
// keeps the totals that were checked and writes nothing more; its bits are
// written from them after the loop.  ON_CHIP: the messages, P*E*Z floats,
// are in shared memory; else in the block's share of a global scratch, (P,
// E, Z) per block.  Shared memory: FLOODING_PACKED_SHARED_BYTES.
#define FLOODING_PACKED_SHARED_BYTES(Z, nc, nr, E, P, on_chip)                    \
  (align16((size_t)(P) * ((nc) + ((on_chip) ? (E) : 0)) * (Z) * 4) + (size_t)(E) * 16 + \
   (size_t)((nr) + (nc) + 2) * 4 + (size_t)(P) * 16 + 8)

template <bool SUM_PRODUCT, bool BF16, bool ON_CHIP>
__global__ void __launch_bounds__(FLOODING_MAX_THREADS, 1)
ldpc_flooding_packed_kernel(const float* __restrict__ llr, int8_t* __restrict__ bits,
                            int* __restrict__ ok_out, int* __restrict__ it_out,
                            float* __restrict__ scratch, const int4* __restrict__ edges_g,
                            const int* __restrict__ row_start_g,
                            const int2* __restrict__ col_edges_g,
                            const int* __restrict__ col_start_g, DecodeArgs a, int P,
                            int ncw) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Z = a.Z, nc = a.nc, nr = a.nr, E = a.E;
  float* totals = reinterpret_cast<float*>(smem);  // P sets of nc*Z
  float* msgs = ON_CHIP ? totals + (size_t)P * nc * Z
                        : scratch + (size_t)blockIdx.x * P * E * Z;  // P sets of E*Z
  int2* red = reinterpret_cast<int2*>(
      smem + align16((size_t)P * (nc + (ON_CHIP ? E : 0)) * Z * 4));
  int2* ced = red + E;
  int* row_start = reinterpret_cast<int*>(ced + E);
  int* col_start = row_start + nr + 1;
  int* flags = col_start + nc + 1;  // [2][P]: a codeword's row parity failed
  int* live = flags + 2 * P;        // [2][P]: the codewords still running
  int* n_live = live + 2 * P;       // [2]

  const int t = threadIdx.x, T = blockDim.x;
  const size_t cw0 = (size_t)blockIdx.x * P;
  const int here = min(P, ncw - (int)cw0);
  const size_t in_len = (size_t)(a.d_input ? nc - 2 : nc) * Z;
  const float* src = llr + cw0 * in_len;

  for (int i = t; i < E; i += T) {
    const int4 ed = edges_g[i];
    red[i] = make_int2(ed.x, ed.y);
    ced[i] = col_edges_g[i];
  }
  for (int i = t; i <= nr; i += T) row_start[i] = row_start_g[i];
  for (int i = t; i <= nc; i += T) col_start[i] = col_start_g[i];
  for (int i = t; i < P; i += T) {
    live[i] = i;
    flags[i] = 0;
  }
  if (t == 0) n_live[0] = here;
  {
    ItemWalk3 w(t, T, Z, nc);
    for (; w.major < here; w.next())
      totals[(w.major * nc + w.row) * Z + w.lane] =
          channel_llr(src + w.major * in_len, w.row, w.lane, a);
  }
  __syncthreads();

  for (int it = 0;; ++it) {
    const int cur = it & 1, nxt = cur ^ 1;
    const int nl = n_live[cur];
    const int* lv = live + cur * P;
    int* fl = flags + cur * P;
    const bool update = it < a.iterations;
    // Message phase with the fused syndrome; the pass at it == iterations
    // only checks.
    unsigned bad = 0;
    {
      ItemWalk3 w(t, T, Z, nr);
      if (update) {
        const bool first = it == 0;  // all messages are zero: skip their read
        const float alpha_t = it < a.n0 ? a.alpha0 : a.alpha;
        for (; w.major < nl; w.next()) {
          const int k = lv[w.major];
          const int e0 = row_start[w.row];
          const int off = (k * E + e0) * Z + w.lane;
          const LocalTotals tk{totals + k * nc * Z};
          unsigned par;
          if constexpr (ON_CHIP)
            par = message_item<SUM_PRODUCT, BF16>(tk, msgs + off, red + e0,
                                                  row_start[w.row + 1] - e0, w.lane, Z,
                                                  first, alpha_t, a.offset_rule, a.beta);
          else
            par = message_item<SUM_PRODUCT, BF16>(tk, GlobalMessages{msgs, off}, red + e0,
                                                  row_start[w.row + 1] - e0, w.lane, Z,
                                                  first, alpha_t, a.offset_rule, a.beta);
          if (par & SIGN_BIT) fl[k] = 1;
          bad |= par;
        }
      } else {
        for (; w.major < nl; w.next()) {
          const int k = lv[w.major];
          const int e0 = row_start[w.row];
          const unsigned par = parity_item(LocalTotals{totals + k * nc * Z}, red + e0,
                                           row_start[w.row + 1] - e0, w.lane, Z);
          if (par & SIGN_BIT) fl[k] = 1;
          bad |= par;
        }
      }
    }
    // Early termination stops a codeword at every vote, a run to budget at
    // the last one only; the block leaves when none goes on.
    const int any_bad = __syncthreads_or(bad & SIGN_BIT);
    const bool stop_passed = a.early_termination || !update;
    if (t < 32) {  // the vote: results of the codewords that stop, next list
      int n = 0;
      for (int j0 = 0; j0 < nl; j0 += 32) {
        const int j = j0 + t;
        const int k = j < nl ? lv[j] : 0;
        const bool failed = j < nl && fl[k];
        const bool keep = j < nl && update && (failed || !stop_passed);
        if (j < nl && !keep) {
          ok_out[cw0 + k] = !failed;
          it_out[cw0 + k] = a.early_termination && !failed ? it : a.iterations;
        }
        const unsigned m = __ballot_sync(0xffffffffu, keep);
        if (keep) live[nxt * P + n + __popc(m & ((1u << t) - 1u))] = k;
        n += __popc(m);
      }
      if (t == 0) n_live[nxt] = n;
      for (int i = t; i < P; i += 32) flags[nxt * P + i] = 0;
    }
    if (!update || (a.early_termination && !any_bad)) break;  // uniform

    // Column phase: totals = llr + the column's messages in row order, for
    // the codewords that go on.
    {
      ItemWalk3 w(t, T, Z, nc);
      for (; w.major < nl; w.next()) {
        const int k = lv[w.major];
        if (a.early_termination && !fl[k]) continue;  // stopped at this vote
        const int mk = k * E * Z;  // the codeword's messages, an offset as above
        const float v = channel_llr(src + k * in_len, w.row, w.lane, a);
        const int k1 = col_start[w.row + 1];
        int q = col_start[w.row];
        int2 ce = ced[q];
        float sum = msgs[mk + ce.x + unrot(w.lane, ce.y, Z)];
#pragma unroll 4
        for (++q; q < k1; ++q) {
          ce = ced[q];
          sum = __fadd_rn(sum, msgs[mk + ce.x + unrot(w.lane, ce.y, Z)]);
        }
        totals[(k * nc + w.row) * Z + w.lane] = __fadd_rn(v, sum);
      }
    }
    __syncthreads();
  }

  // every codeword's bits from its totals (a stopped codeword's are those
  // that were checked)
  {
    ItemWalk3 w(t, T, Z, a.out_cols);
    int8_t* dst = bits + cw0 * (size_t)(a.out_cols * Z);
    for (; w.major < here; w.next())
      dst[(w.major * a.out_cols + w.row) * Z + w.lane] =
          totals[(w.major * nc + w.row) * Z + w.lane] < 0.0f;
  }
}

extern "C" int ldpc_flooding_max_degree() { return MAX_DEG; }
extern "C" int ldpc_flooding_max_z() { return MAX_THREADS; }
extern "C" int ldpc_flooding_max_shared_bytes() { return max_shared_bytes_optin(); }

// Dynamic shared memory of one block, by `layout`: for P = 1
// FLOODING_SHARED_BYTES (1: one block per codeword) or
// FLOODING_CLUSTER_SHARED_BYTES for a cluster of `layout` blocks per
// codeword (2 to MAX_CLUSTER; `cols_max`, `edges_max`: the most columns and
// edges a block of it owns); for P > 1 FLOODING_PACKED_SHARED_BYTES with the
// messages on chip (layout 1) or in a global scratch (layout 0).
extern "C" int ldpc_flooding_shared_bytes(int Z, int nc, int nr, int E, int P,
                                          int layout, int cols_max, int edges_max) {
  if (P > 1) return (int)FLOODING_PACKED_SHARED_BYTES(Z, nc, nr, E, P, layout == 1);
  if (layout >= 2)
    return (int)FLOODING_CLUSTER_SHARED_BYTES(Z, nc, nr, E, cols_max, edges_max);
  return (int)FLOODING_SHARED_BYTES(Z, nc, nr, E);
}

// The instantiation that serves (rule, message type, P, layout), and its
// launch.
template <bool SUM_PRODUCT, bool BF16>
static const void* kernel_for(int P, int layout) {
  if (P > 1)
    return layout == 1 ? (const void*)ldpc_flooding_packed_kernel<SUM_PRODUCT, BF16, true>
                       : (const void*)ldpc_flooding_packed_kernel<SUM_PRODUCT, BF16, false>;
  if (layout >= 2) return (const void*)ldpc_flooding_cluster_kernel<SUM_PRODUCT, BF16>;
  return (const void*)ldpc_flooding_kernel<SUM_PRODUCT, BF16>;
}

static const void* select_kernel(int rule, int bf16_messages, int P, int layout) {
  if (rule == RULE_SUM_PRODUCT) return kernel_for<true, false>(P, layout);
  if (bf16_messages) return kernel_for<false, true>(P, layout);
  return kernel_for<false, false>(P, layout);
}

struct Plans {
  const int4* edges;
  const int* row_start;
  const int2* col_edges;
  const int* col_start;
  const int* splits;
};

template <bool SUM_PRODUCT, bool BF16>
static cudaError_t launch(const void* llr, void* bits, void* ok, void* iters,
                          void* c2v, const Plans& g, int ncw, int P, int layout,
                          int threads, int smem_bytes, int cols_max,
                          int edges_max, const DecodeArgs& a, cudaStream_t s) {
  const float* x = (const float*)llr;
  int8_t* y = (int8_t*)bits;
  if (P > 1) {
    const unsigned blocks = (unsigned)((ncw + P - 1) / P);
    if (layout == 1)
      ldpc_flooding_packed_kernel<SUM_PRODUCT, BF16, true><<<blocks, threads, smem_bytes, s>>>(
          x, y, (int*)ok, (int*)iters, nullptr, g.edges, g.row_start, g.col_edges,
          g.col_start, a, P, ncw);
    else
      ldpc_flooding_packed_kernel<SUM_PRODUCT, BF16, false><<<blocks, threads, smem_bytes, s>>>(
          x, y, (int*)ok, (int*)iters, (float*)c2v, g.edges, g.row_start, g.col_edges,
          g.col_start, a, P, ncw);
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

// One codeword per block or cluster (`layout` 1 to MAX_CLUSTER), or P > 1
// codewords per block with the messages in a global scratch (`layout` 0) or
// on chip (1); `threads` a whole number of warps up to FLOODING_MAX_THREADS.
static bool valid_shape(int Z, int P, int layout, int threads) {
  if (Z < 1 || Z > MAX_THREADS || P < 1) return false;
  if (P > 1 ? (P * Z > MAX_THREADS || layout < 0 || layout > 1)
            : (layout < 1 || layout > MAX_CLUSTER))
    return false;
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
        &n, kernel, threads, smem_bytes);
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
// columns and edges of a block), messages in shared memory, `c2v` null.
// P > 1 runs ceil(ncw / P) blocks of the packed kernel, messages in shared
// memory (`layout` 1, `c2v` null) or in the scratch `c2v` (`layout` 0: P*E*Z
// floats per block).  `threads` threads per block.  Does not synchronise and
// allocates nothing.  Returns cudaGetLastError().
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
  if ((P > 1 && layout == 0) != (c2v != nullptr)) return (int)cudaErrorInvalidValue;
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
  if (rule == RULE_SUM_PRODUCT)
    err = launch<true, false>(llr, bits, ok, iters, c2v, g, ncw, P, layout, threads,
                              smem_bytes, cols_max, edges_max, a, st);
  else if (bf16_messages)
    err = launch<false, true>(llr, bits, ok, iters, c2v, g, ncw, P, layout, threads,
                              smem_bytes, cols_max, edges_max, a, st);
  else
    err = launch<false, false>(llr, bits, ok, iters, c2v, g, ncw, P, layout, threads,
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
