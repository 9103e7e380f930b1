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
//     the SM (up to 32).  Within a thread the items run one after another.
//     The rows are dealt in descending degree (the wrapper's plan), and the
//     min-sum family runs each row unrolled to its own degree (3 to 10;
//     other degrees at MAX_DEG slots left at the row's degree), so a warp's
//     items mostly share one degree, all of an item's loads issue before its
//     arithmetic, and no edge waits on a branch.  Running a thread one item
//     ahead (its next item's loads issued before the current item's
//     arithmetic) was 17-21 % slower on an H100: at the 64 registers of a
//     1,024-thread SM the second item's inputs went to the stack (PERF.md
//     §6).  The check rule is the reference's (ops/decoder_fast.py),
//     operation for operation.  Each item stores its new messages in place,
//     unrounded.
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
//     column's messages in ascending row order (the first assigned, the later
//     ones added with __fadd_rn) and writes totals = llr + sum: the same
//     operations in the same order as the reference's column sums, with no
//     atomics and no barrier per row.
//   - Where the messages are.  Taken apart at config #1's launch (BG2 Z=20,
//     tools/flooding_probe.py, PERF.md §6), the form that kept each row's
//     messages by check lane lost a third of its time to the column phase (a
//     plan entry, a rotation and a read of another row's window per edge)
//     and a third to the message phase's stores.  So the messages are kept
//     by variable lane in column planes (plane k: the k-th edge, in ascending
//     row order, of every column of more than k edges, columns in descending
//     degree), the totals by column in the same order: the column phase
//     reads 32 consecutive words of one plane per edge, with no plan entry
//     and no rotation, and the message phase reaches an edge's total and
//     message at the one variable lane it computes.  The other way round,
//     the messages by check lane in row planes (the message phase's loads
//     and stores consecutive, the column phase's reads rotated), was 20 %
//     slower at that launch: its column phase does more per edge, and its
//     stores cost as much as before.  The channel LLRs are kept in shared
//     memory where the block still fits (up to BG2 Z=176 and BG1 Z=120), so
//     the column phase does not re-read the input (8-11 % slower when it
//     does).
//   - Messages on chip.  Totals, all E*Z messages and the plan fit one
//     block's 232,448 bytes up to BG2 Z=224 and BG1 Z=144 (P2's BG2 Z=208
//     takes 211,036 B): then one block holds the codeword.  Above that a
//     thread block cluster of 2 or 3 blocks on neighbouring SMs holds it
//     (ldpc_flooding_cluster_kernel below; 3 at BG1 Z=384), each block with
//     its share of the rows to update and of the columns, a column's total
//     and all of its edges' messages in the same block, the other blocks'
//     reached through distributed shared memory.  Either way the
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
//     zero-filled.
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

#include "ldpc_bp.cuh"

namespace cg = cooperative_groups;

// Threads of a one-codeword block at most, and what its registers are held
// to: one such block fills an SM's 64K registers.
#define FLOODING_MAX_THREADS 1024

// Shared memory of one block of a cluster (layout (a)): its columns' totals
// and their edges' messages (slots_max Z-lane slots), the edge table and the
// column table (16 bytes an entry), the row offsets, the plan's header and
// the vote words (64 bytes).
#define FLOODING_CLUSTER_SHARED_BYTES(Z, nc, nr, E, slots_max)                     \
  (align16((size_t)slots_max * Z * 4) + (size_t)E * 16 + (size_t)nc * 16 + \
   (size_t)(nr + 1) * 4 + 64)
#define MAX_CLUSTER 3  // the largest cluster: three blocks hold BG1 Z=384

// Where an item's edges are: g.total(i, z) is the total that edge i of the
// item's row reads at check lane z, g.message(i, z) the edge's message, read
// and then written by this item alone.
//   - LocalEdges: the totals and the row's messages in this block's shared
//     memory (the one-codeword kernel; the packed one with its messages on
//     chip).  `msg` is the item's first message, the i-th at msg[i*Z].
//   - ScratchEdges: the same with the messages in the packed kernel's global
//     scratch, at a 32-bit offset from the block's share, so that an item's
//     up to MAX_DEG message addresses are not 64-bit values held from the
//     load to the store (at 64 registers they spilled); phi_i waits in its
//     edge's message slot, not in registers (kPhiInSlot).
//   - ClusterEdges (layout (a)): the cluster kernel's edge table; the total
//     and the message live in the shared memory of the block that owns the
//     edge's column, reached through distributed shared memory.
struct LocalEdges {
  static constexpr bool kPhiInSlot = false;
  const float* totals;
  float* msg;
  const int2* red;
  int Z;
  __device__ __forceinline__ float total(int i, int z) const {
    const int2 ed = red[i];
    return totals[ed.x + rot(z, ed.y, Z)];
  }
  __device__ __forceinline__ float& message(int i, int) const { return msg[i * Z]; }
};
struct ScratchEdges {
  static constexpr bool kPhiInSlot = true;
  const float* totals;
  float* base;
  int off;
  const int2* red;
  int Z;
  __device__ __forceinline__ float total(int i, int z) const {
    const int2 ed = red[i];
    return totals[ed.x + rot(z, ed.y, Z)];
  }
  __device__ __forceinline__ float& message(int i, int) const { return base[off + i * Z]; }
};
// A cluster plan entry: the owning block's rank above OWNER_SHIFT, the offset
// in its shared memory below.
#define OWNER_SHIFT 24
#define OFFSET_MASK 0xffffff
struct ClusterEdges {
  static constexpr bool kPhiInSlot = false;
  float* slots;      // this block's shared memory: totals, then messages
  const int4* red;   // (owner << OWNER_SHIFT | total's offset, shift, message's offset, 0)
  int Z;
  __device__ __forceinline__ float* owner(const int4& ed) const {
    return cg::this_cluster().map_shared_rank(slots, (unsigned)(ed.x >> OWNER_SHIFT));
  }
  __device__ __forceinline__ float total(int i, int z) const {
    const int4 ed = red[i];
    return owner(ed)[(ed.x & OFFSET_MASK) + rot(z, ed.y, Z)];
  }
  __device__ __forceinline__ float& message(int i, int z) const {
    const int4 ed = red[i];
    return owner(ed)[ed.z + rot(z, ed.y, Z)];
  }
};

// A message as the next sweep subtracts it: float32, or rounded to bfloat16.
template <bool BF16>
__device__ __forceinline__ float stored(float m) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(m));
  return m;
}

// One (row, lane) item of the message phase: check z of a base row of `deg`
// edges, reached through `g` (LocalEdges, ScratchEdges, ClusterEdges).  The
// reference's check rule (ops/decoder_fast.py), operation for operation; the
// new messages are stored unrounded in place.  Returns the XOR of the sign
// bits of the totals read (the row's parity at check z).  The slots are
// unrolled to MAX_DEG and left at the row's degree (a branch out, not
// predicated slots: a block's rows have degrees 3 to 19).
template <bool SUM_PRODUCT, bool BF16, typename Edges>
__device__ __forceinline__ unsigned message_item(
    const Edges& g, int deg, int z, bool first, float alpha_t, int offset_rule, float beta) {
  unsigned par = 0;
  if constexpr (!SUM_PRODUCT) {
    float v[MAX_DEG];
    unsigned sx = 0, m1 = MAG_INF, m2 = MAG_INF;
#pragma unroll
    for (int i = 0; i < MAX_DEG; ++i) {
      if (i >= deg) break;
      {
        const float t = g.total(i, z);
        par ^= __float_as_uint(t);
        const float ve = first ? t : __fsub_rn(t, stored<BF16>(g.message(i, z)));
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
        g.message(i, z) = __uint_as_float(mag ^ (b & SIGN_BIT));
      }
    }
  } else {
    float ph[Edges::kPhiInSlot ? 1 : MAX_DEG];
    unsigned neg = 0;
    float T = 0.0f;
#pragma unroll
    for (int i = 0; i < MAX_DEG; ++i) {
      if (i >= deg) break;
      {
        const float t = g.total(i, z);
        par ^= __float_as_uint(t);
        const float ve = first ? t : __fsub_rn(t, g.message(i, z));
        neg |= (ve < 0.0f ? 1u : 0u) << i;
        const float p = phi_f32(fabsf(ve));
        if constexpr (Edges::kPhiInSlot)
          g.message(i, z) = p;
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
        if constexpr (Edges::kPhiInSlot)
          p = g.message(i, z);
        else
          p = ph[i];
        const float mag = phi_f32(fmaxf(__fsub_rn(T, p), 1e-9f));
        // (+-1) * mag: an exact sign flip, also of a -0.0 magnitude
        const unsigned s = (sx ^ (neg >> i)) & 1u;
        g.message(i, z) = __uint_as_float(__float_as_uint(mag) ^ (s << 31));
      }
    }
  }
  return par;
}

// The row parity at check z alone (the pass that only checks).
template <typename Edges>
__device__ __forceinline__ unsigned parity_item(const Edges& g, int deg, int z) {
  unsigned par = 0;
  for (int i = 0; i < deg; ++i) par ^= __float_as_uint(g.total(i, z));
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

// The one-codeword form's shared memory (FLOODING_SHARED_BYTES): `slots`
// Z-lane float slots (the totals, the E*Z messages and, where they fit, the
// channel LLRs), then the plan (ops/decoder_cuda.py::_one_block_plan): the
// edge table (E int4), the column table (nc int2), the row offsets and the
// planes' offsets (MAX_COLUMN_DEGREE + 1 ints).  The wrapper's
// flooding_shared_bytes repeats this formula and the cluster's below (a CPU
// test holds them equal).
#define MAX_COLUMN_DEGREE 31  // densest column: 30 edges (BG1 column 0)
#define FLOODING_SHARED_BYTES(Z, nc, nr, E, slots)                      \
  (align16((size_t)(slots) * (Z) * 4) + (size_t)(E) * 16 + (size_t)(nc) * 8 + \
   (size_t)((nr) + 1) * 4 + (MAX_COLUMN_DEGREE + 1) * 4)

// Where the one-codeword form's edges are.  The totals are kept by column in
// the plan's column order (descending degree), lane-contiguous; the messages
// by variable lane in planes: plane k holds the k-th edge (in ascending row
// order) of every column of more than k edges, the columns in the same
// order, so that the column phase reads consecutive lanes of one plane per
// edge.  red[i] = (the column's total + shift, the edge's message + shift,
// Z - shift, 0): the edge's variable lane for check z is z + shift, less Z
// from check Z - shift on.
struct ColumnEdges {
  static constexpr bool kPhiInSlot = false;
  const float* totals;
  float* msgs;
  const int4* red;
  int Z;
  __device__ __forceinline__ int lane(const int4& ed, int z) const {
    return z >= ed.z ? z - Z : z;
  }
  __device__ __forceinline__ float total(int i, int z) const {
    const int4 ed = red[i];
    return totals[ed.x + lane(ed, z)];
  }
  __device__ __forceinline__ float& message(int i, int z) const {
    const int4 ed = red[i];
    return msgs[ed.y + lane(ed, z)];
  }
};

// One (row, lane) item of the min-sum family on ColumnEdges: message_item's
// rule, operation for operation, unrolled to the row's degree D (no branch
// per edge), or for D = 0 to MAX_DEG slots left at the row's degree (BG1's
// rows of 19).  A row of up to kKeptOffsets edges keeps each edge's message
// offset in a register from its load to its store; a denser one looks it up
// again (beside its v_i, at 64 registers, they went to the stack).
constexpr int kKeptOffsets = 6;

template <bool BF16, int D>
__device__ __forceinline__ unsigned min_sum_row(const ColumnEdges& g, int deg, int z,
                                                bool first, float alpha_t, int offset_rule,
                                                float beta) {
  constexpr int S = D > 0 ? D : MAX_DEG;
  constexpr bool kKeep = D > 0 && D <= kKeptOffsets;
  float v[S];
  int at[kKeep ? D : 1];
  unsigned par = 0, sx = 0, m1 = MAG_INF, m2 = MAG_INF;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    if (D == 0 && i >= deg) break;
    const int4 ed = g.red[i];
    const int zl = g.lane(ed, z);
    const float t = g.totals[ed.x + zl];
    const int m = ed.y + zl;
    if constexpr (kKeep) at[i] = m;
    par ^= __float_as_uint(t);
    const float ve = first ? t : __fsub_rn(t, stored<BF16>(g.msgs[m]));
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
  for (int i = 0; i < S; ++i) {
    if (D == 0 && i >= deg) break;
    const unsigned b = __float_as_uint(v[i]);
    const float m = __uint_as_float(((b & MAG_MASK) == m1 ? m2s : m1s) ^ (b & SIGN_BIT));
    if constexpr (kKeep)
      g.msgs[at[i]] = m;
    else
      g.message(i, z) = m;
  }
  return par;
}

// min_sum_row at the row's own degree, 3 to 10 (the plan deals the rows in
// descending degree, so a warp's items mostly share one), other degrees at
// MAX_DEG slots.
template <bool BF16>
__device__ __forceinline__ unsigned min_sum_row_at_degree(const ColumnEdges& g, int deg,
                                                          int z, bool first, float alpha_t,
                                                          int offset_rule, float beta) {
#define FLOODING_ROW_EXACT(D) \
  case D: return min_sum_row<BF16, D>(g, D, z, first, alpha_t, offset_rule, beta);
  switch (deg) {
    FLOODING_ROW_EXACT(3) FLOODING_ROW_EXACT(4) FLOODING_ROW_EXACT(5) FLOODING_ROW_EXACT(6)
    FLOODING_ROW_EXACT(7) FLOODING_ROW_EXACT(8) FLOODING_ROW_EXACT(9) FLOODING_ROW_EXACT(10)
    default:
      return min_sum_row<BF16, 0>(g, deg, z, first, alpha_t, offset_rule, beta);
  }
#undef FLOODING_ROW_EXACT
}

// One codeword per block (layout 1).  The plan, from the wrapper: the edge
// table in the order of the rows it deals (descending degree; each row's
// edges in the reference's order), the column table (column, degree) in
// descending degree, the row offsets, and each plane's first slot.  Message
// phase: items (dealt row, check lane) as ColumnEdges; the min-sum family
// by min_sum_row_at_degree, sum-product by message_item.  Column phase:
// item (dealt column j, variable lane z) = flat index i = j*Z + z sums the
// column's messages msgs[plane k + i] in ascending row order and stores
// totals[i] = llr + sum; the channel LLR is read from shared memory where
// `slots` holds it (2*nc + E), else from the input.  Shared memory:
// FLOODING_SHARED_BYTES.
template <bool SUM_PRODUCT, bool BF16>
__global__ void __launch_bounds__(FLOODING_MAX_THREADS, 1)
ldpc_flooding_kernel(const float* __restrict__ llr, int8_t* __restrict__ bits,
                     int* __restrict__ ok_out, int* __restrict__ it_out,
                     const int* __restrict__ plan_g, DecodeArgs a, int slots) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Z = a.Z, nc = a.nc, nr = a.nr, E = a.E;
  float* totals = reinterpret_cast<float*>(smem);
  float* msgs = totals + nc * Z;
  float* chan = slots > nc + E ? msgs + E * Z : nullptr;  // the channel LLRs on chip
  int4* red = reinterpret_cast<int4*>(smem + align16((size_t)slots * Z * 4));
  int2* cols = reinterpret_cast<int2*>(red + E);
  int* row_start = reinterpret_cast<int*>(cols + nc);
  int* planes = row_start + nr + 1;

  const int t = threadIdx.x, T = blockDim.x;
  const size_t cw = blockIdx.x;
  const int4* plan_edges = reinterpret_cast<const int4*>(plan_g);
  const int2* plan_cols = reinterpret_cast<const int2*>(plan_edges + E);
  const int* plan_rows = reinterpret_cast<const int*>(plan_cols + nc);
  for (int i = t; i < E; i += T) red[i] = plan_edges[i];
  for (int i = t; i < nc; i += T) cols[i] = plan_cols[i];
  for (int i = t; i < nr + 1 + MAX_COLUMN_DEGREE + 1; i += T) row_start[i] = plan_rows[i];

  const float* src = llr + cw * (size_t)((a.d_input ? nc - 2 : nc) * Z);
  {
    ItemWalk w(t, T, Z);
    for (int i = t; i < nc * Z; i += T, w.next()) {
      const float v = channel_llr(src, plan_cols[w.major].x, w.lane, a);
      totals[i] = v;
      if (chan) chan[i] = v;
    }
  }
  __syncthreads();

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
          const ColumnEdges g{totals, msgs, red + e0, Z};
          const int deg = row_start[w.major + 1] - e0;
          if constexpr (SUM_PRODUCT)
            bad |= message_item<true, false>(g, deg, w.lane, first, alpha_t, a.offset_rule,
                                             a.beta);
          else
            bad |= min_sum_row_at_degree<BF16>(g, deg, w.lane, first, alpha_t, a.offset_rule,
                                               a.beta);
        }
      } else {
        for (int i = t; i < nr * Z; i += T, w.next()) {
          const int e0 = row_start[w.major];
          bad |= parity_item(ColumnEdges{totals, msgs, red + e0, Z},
                             row_start[w.major + 1] - e0, w.lane);
        }
      }
    }
    // uniform over the block; the results are written here, so that nothing
    // is held across the sweeps for them
    const bool pass = !__syncthreads_or(bad & SIGN_BIT);
    if ((pass && a.early_termination) || !update) {
      if (t == 0) {
        ok_out[cw] = pass;
        it_out[cw] = pass && a.early_termination ? it : a.iterations;
      }
      break;
    }

    // Column phase: totals = llr + the column's messages, plane by plane
    // (ascending row order).
    {
      ItemWalk w(t, T, Z);
      for (int i = t; i < nc * Z; i += T, w.next()) {
        const int2 col = cols[w.major];  // (column, degree)
        const float v = chan ? chan[i] : channel_llr(src, col.x, w.lane, a);
        const float* m = msgs + i;
        float sum = m[0];
#pragma unroll 4
        for (int k = 1; k < col.y; ++k) sum = __fadd_rn(sum, m[planes[k]]);
        totals[i] = __fadd_rn(v, sum);
      }
    }
    __syncthreads();
  }

  int8_t* dst = bits + cw * (size_t)(a.out_cols * Z);
  {
    ItemWalk w(t, T, Z);
    for (int i = t; i < nc * Z; i += T, w.next()) {
      const int c = cols[w.major].x;
      if (c < a.out_cols) dst[c * Z + w.lane] = totals[i] < 0.0f;
    }
  }
}


// Layout (a): a thread block cluster of CS blocks decodes one codeword on
// neighbouring SMs.  Block b runs the message phase of the base rows
// [rows_lo[b], rows_lo[b+1]) (about E/CS edges) and owns the columns of its
// range of the column table: their totals and every message of their edges,
// kept by variable lane in ascending row order, so that the column phase
// reads only the block's own shared memory, contiguous lanes, with no
// rotation.  The message phase reaches an edge's total and message in the
// column's owner through distributed shared memory (ClusterEdges; its own
// block's too), and stores the new message there.  On an H100 the message
// phase's arithmetic hides most of that traffic, while the column phase's
// reads of other blocks' messages, in the form that kept each row's messages
// with its rows, cost 8.4 % of the kernel's time and left the block with the
// dense columns summing 257 of BG1's 316 edges; this form is 12-13 % faster
// at snr_vs_a's A=8000 launch (tools/flooding_probe.py, PERF.md §6).
// Reaching the own block through a plain pointer instead of the cluster
// mapping was slower in both forms.  The plan (ops/decoder_cuda.py::
// _cluster_plan) gives each column to the block that holds most of its
// edges within the shared memory cap.  The phases are separated by cluster
// barriers (the message phase's stores into other blocks are complete
// before any column phase reads them, and no block's totals change while
// another reads them); the vote is one word per block written into every
// block of the cluster.  No block reads or writes another's shared memory
// after the last cluster barrier.  The arithmetic and its order are the
// one-block kernel's.  Shared memory: FLOODING_CLUSTER_SHARED_BYTES.
template <bool SUM_PRODUCT, bool BF16>
__global__ void __launch_bounds__(FLOODING_MAX_THREADS, 1)
ldpc_flooding_cluster_kernel(const float* __restrict__ llr, int8_t* __restrict__ bits,
                             int* __restrict__ ok_out, int* __restrict__ it_out,
                             const int* __restrict__ row_start_g,
                             const int* __restrict__ plan_g, DecodeArgs a, int slots_max) {
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks();
  const int b = (int)cluster.block_rank();
  extern __shared__ __align__(16) unsigned char smem[];
  const int Z = a.Z, nc = a.nc, nr = a.nr, E = a.E;
  float* slots = reinterpret_cast<float*>(smem);  // totals, then messages
  int4* red = reinterpret_cast<int4*>(smem + align16((size_t)slots_max * Z * 4));
  int4* cols = red + E;  // (column, message offset, degree, 0)
  int* row_start = reinterpret_cast<int*>(cols + nc);
  int* head = row_start + nr + 1;  // rows_lo[MAX_CLUSTER + 1], cols_lo[...]
  int* votes = head + 2 * (MAX_CLUSTER + 1);

  const int t = threadIdx.x, T = blockDim.x;
  const size_t cw = blockIdx.x / CS;

  {
    const int4* plan_cols = reinterpret_cast<const int4*>(plan_g + 2 * (MAX_CLUSTER + 1));
    const int4* plan_edges = plan_cols + nc;
    for (int i = t; i < E; i += T) red[i] = plan_edges[i];
    for (int i = t; i < nc; i += T) cols[i] = plan_cols[i];
    for (int i = t; i <= nr; i += T) row_start[i] = row_start_g[i];
    for (int i = t; i < 2 * (MAX_CLUSTER + 1); i += T) head[i] = plan_g[i];
  }
  __syncthreads();
  const int r0 = head[b], nrows = head[b + 1] - r0;
  const int c0 = head[MAX_CLUSTER + 1 + b], ncols = head[MAX_CLUSTER + 2 + b] - c0;

  const float* src = llr + cw * (size_t)((a.d_input ? nc - 2 : nc) * Z);
  {
    ItemWalk w(t, T, Z);
    for (int i = t; i < ncols * Z; i += T, w.next())
      slots[i] = channel_llr(src, cols[c0 + w.major].x, w.lane, a);
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
              ClusterEdges{slots, red + e0, Z}, row_start[r0 + w.major + 1] - e0, w.lane,
              first, alpha_t, a.offset_rule, a.beta);
        }
      } else {
        for (int i = t; i < nrows * Z; i += T, w.next()) {
          const int e0 = row_start[r0 + w.major];
          bad |= parity_item(ClusterEdges{slots, red + e0, Z},
                             row_start[r0 + w.major + 1] - e0, w.lane);
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

    // Column phase: totals = llr + the column's messages in row order, all
    // in this block's shared memory.
    {
      ItemWalk w(t, T, Z);
      for (int i = t; i < ncols * Z; i += T, w.next()) {
        const int4 col = cols[c0 + w.major];
        const float v = channel_llr(src, col.x, w.lane, a);
        const float* m = slots + col.y + w.lane;
        float sum = m[0];
#pragma unroll 4
        for (int k = 1; k < col.z; ++k) sum = __fadd_rn(sum, m[k * Z]);
        slots[i] = __fadd_rn(v, sum);
      }
    }
    cluster.sync();
  }

  int8_t* dst = bits + cw * (size_t)(a.out_cols * Z);
  {
    ItemWalk w(t, T, Z);
    for (int i = t; i < ncols * Z; i += T, w.next()) {
      const int c = cols[c0 + w.major].x;
      if (c < a.out_cols) dst[c * Z + w.lane] = slots[i] < 0.0f;
    }
  }
  if (b == 0 && t == 0) {
    ok_out[cw] = ok;
    it_out[cw] = used;
  }
}

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
          const float* tk = totals + k * nc * Z;
          const int deg = row_start[w.row + 1] - e0;
          unsigned par;
          if constexpr (ON_CHIP)
            par = message_item<SUM_PRODUCT, BF16>(LocalEdges{tk, msgs + off, red + e0, Z},
                                                  deg, w.lane, first, alpha_t,
                                                  a.offset_rule, a.beta);
          else
            par = message_item<SUM_PRODUCT, BF16>(ScratchEdges{tk, msgs, off, red + e0, Z},
                                                  deg, w.lane, first, alpha_t,
                                                  a.offset_rule, a.beta);
          if (par & SIGN_BIT) fl[k] = 1;
          bad |= par;
        }
      } else {
        for (; w.major < nl; w.next()) {
          const int k = lv[w.major];
          const int e0 = row_start[w.row];
          const unsigned par = parity_item(LocalEdges{totals + k * nc * Z, msgs, red + e0, Z},
                                           row_start[w.row + 1] - e0, w.lane);
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
// FLOODING_SHARED_BYTES (1: one block per codeword; `slots_max`: its Z-lane
// float slots, 2*nc + E with the channel LLRs on chip, else nc + E) or
// FLOODING_CLUSTER_SHARED_BYTES for a cluster of `layout` blocks per
// codeword (2 to MAX_CLUSTER; `slots_max`: the most Z-lane slots, totals
// and messages, a block of it holds); for P > 1 FLOODING_PACKED_SHARED_BYTES
// with the messages on chip (layout 1) or in a global scratch (layout 0).
extern "C" int ldpc_flooding_shared_bytes(int Z, int nc, int nr, int E, int P,
                                          int layout, int slots_max) {
  if (P > 1) return (int)FLOODING_PACKED_SHARED_BYTES(Z, nc, nr, E, P, layout == 1);
  if (layout >= 2) return (int)FLOODING_CLUSTER_SHARED_BYTES(Z, nc, nr, E, slots_max);
  return (int)FLOODING_SHARED_BYTES(Z, nc, nr, E, slots_max);
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
  const int* plan;  // the one-codeword kernel's or the cluster's
};

template <bool SUM_PRODUCT, bool BF16>
static cudaError_t launch(const void* llr, void* bits, void* ok, void* iters,
                          void* c2v, const Plans& g, int ncw, int P, int layout,
                          int threads, int smem_bytes, int slots_max,
                          const DecodeArgs& a, cudaStream_t s) {
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
                              x, y, (int*)ok, (int*)iters, g.row_start, g.plan,
                              a, slots_max);
  } else {
    ldpc_flooding_kernel<SUM_PRODUCT, BF16><<<ncw, threads, smem_bytes, s>>>(
        x, y, (int*)ok, (int*)iters, g.plan, a, slots_max);
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
                                          int slots_max) {
  const int P = codewords_per_block;
  if (!valid_shape(Z, P, layout, threads)) return -(int)cudaErrorInvalidValue;
  const int smem_bytes = ldpc_flooding_shared_bytes(Z, nc, nr, E, P, layout, slots_max);
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
// ascending row order; slot = the edge's position in the row plan): the
// packed kernel's plans (the cluster kernel reads `row_start` too).  `rule`
// is 0 (min-sum), 1 (offset-min-sum) or 2 (sum-product); `bf16_messages`
// rounds the messages to bfloat16 where they are read back (min-sum family
// only).  `codewords_per_block` P = 1 runs one codeword per block (`layout`
// 1, `plan` ops/decoder_cuda.py::_one_block_plan, `slots_max` its float
// slots) or per cluster of `layout` blocks (2 to MAX_CLUSTER, `plan`
// ops/decoder_cuda.py::_cluster_plan; `slots_max` the most slots a block
// holds), messages in shared memory, `c2v` null.
// P > 1 runs ceil(ncw / P) blocks of the packed kernel, messages in shared
// memory (`layout` 1, `c2v` null) or in the scratch `c2v` (`layout` 0: P*E*Z
// floats per block).  `threads` threads per block.  Does not synchronise and
// allocates nothing.  Returns cudaGetLastError().
extern "C" int ldpc_flooding_decode(
    const void* llr, void* bits, void* ok, void* iters, void* c2v,
    const void* edges, const void* row_start, const void* col_edges,
    const void* col_start, const void* plan, int ncw, int Z, int nc, int nr,
    int E, int out_cols, int d_input, int fill_lo, int fill_hi, int iterations,
    int early_termination, int rule, int bf16_messages,
    int codewords_per_block, int layout, int threads, int slots_max,
    float alpha, float beta, float alpha0, int n0, void* stream) {
  const int P = codewords_per_block;
  if (ncw < 1 || !valid_shape(Z, P, layout, threads)) return (int)cudaErrorInvalidValue;
  if (rule < RULE_MIN_SUM || rule > RULE_SUM_PRODUCT) return (int)cudaErrorInvalidValue;
  if (rule == RULE_SUM_PRODUCT && bf16_messages) return (int)cudaErrorInvalidValue;
  if ((P > 1 && layout == 0) != (c2v != nullptr)) return (int)cudaErrorInvalidValue;
  if (P == 1 && layout == 1 && slots_max != nc + E && slots_max != 2 * nc + E)
    return (int)cudaErrorInvalidValue;
  DecodeArgs a;
  a.Z = Z; a.nc = nc; a.nr = nr; a.E = E; a.out_cols = out_cols;
  a.d_input = d_input; a.fill_lo = fill_lo; a.fill_hi = fill_hi;
  a.iterations = iterations; a.early_termination = early_termination;
  a.offset_rule = rule == RULE_OFFSET_MIN_SUM;
  a.alpha = alpha; a.beta = beta; a.alpha0 = alpha0; a.n0 = n0;
  const void* kernel = select_kernel(rule, bf16_messages, P, layout);
  const int smem_bytes = ldpc_flooding_shared_bytes(Z, nc, nr, E, P, layout, slots_max);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const Plans g = {(const int4*)edges, (const int*)row_start,
                   (const int2*)col_edges, (const int*)col_start,
                   (const int*)plan};
  const cudaStream_t st = (cudaStream_t)stream;
  if (rule == RULE_SUM_PRODUCT)
    err = launch<true, false>(llr, bits, ok, iters, c2v, g, ncw, P, layout, threads,
                              smem_bytes, slots_max, a, st);
  else if (bf16_messages)
    err = launch<false, true>(llr, bits, ok, iters, c2v, g, ncw, P, layout, threads,
                              smem_bytes, slots_max, a, st);
  else
    err = launch<false, false>(llr, bits, ok, iters, c2v, g, ncw, P, layout, threads,
                               smem_bytes, slots_max, a, st);
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
