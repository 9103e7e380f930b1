// Op-rate microbenchmark for the BP decoder kernels on NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tools/vpu_ceiling.py::_bench, which measured what a
// kernel sustains on a decoder-shaped resident tile for five operation
// classes (multiply/add, min/max, compare-select, integer bit operations on
// the float's bits, lane rotation): 16 independent dependency chains of 64
// operations, looped, the chains summed into one output tile.
//
// What bounds it on this card, and what the design does about it.  The
// benchmark is its own bound: each class is a loop of one kind of instruction
// that the decoder executes, in the decoder's block shape (threads per block,
// blocks per SM, set by the caller through the dynamic shared memory it asks
// for), built with the decoder's flags (-fmad=false, explicitly rounded
// intrinsics), so that the rate it reports is the rate the decoder can get.
//   - The four arithmetic classes keep their 16 chains in registers; the loop
//     count is a run-time argument and the chains' sum is stored, so nothing
//     is optimised away.  The bit-operation class takes its operands from a
//     run-time array, and the min/max class its bounds from a run-time 3.0:
//     with literal constants the compiler may fold such a chain into two
//     operations.  ptxas fuses an adjacent and/xor pair into
//     one LOP3, as it does in the decoder.
//   - On this card a rotation is an address, not an instruction.  The
//     rotation class is the decoder's own: every thread reads shared memory
//     at (z + s) mod Z, s changing per step, writes at z, and the block meets
//     at one barrier per step, as the decoder does once per base row.  Two
//     buffers alternate, so one barrier is enough.
//   - A sixth class the TPU had no need of, the scratch stream: lane-wise
//     coalesced global writes and reads of E*Z floats per block at the
//     decoder's stride (edge e of codeword cw at (cw*E + e)*Z + z), eight
//     edges in flight per thread and a barrier after each group, the first
//     sweep writing only.  It gives the message-traffic rate that a block
//     shape sustains.
// Each class has a plain PyTorch version (tools/op_rates.py) that the kernel
// equals bit for bit at any loop count.

#include <cuda_runtime.h>
#include <stdint.h>

#define CHAINS 16
#define INNER 64
#define MAX_THREADS 384
#define SCRATCH_GROUP 8

#define OP_ADDMUL 0
#define OP_MINMAX 1
#define OP_SELECT 2
#define OP_BITOPS 3
#define OP_ROTATE 4
#define OP_SCRATCH 5

// One step of a chain.  `c` is the chain's index, `k` the step within the
// loop body, both compile-time after unrolling.
template <int OP>
__device__ __forceinline__ float step(float v, int c, int k, const unsigned* xq,
                                      const unsigned* aq, float three) {
  if (OP == OP_ADDMUL) {
    return (k & 1) ? __fadd_rn(__fmul_rn(v, 1.000001f), 0.5f)
                   : __fmul_rn(v, 0.999999f);
  } else if (OP == OP_MINMAX) {
    return (k & 1) ? fminf(v, __fadd_rn(three, (float)c))
                   : fmaxf(v, __fsub_rn(-three, (float)c));
  } else if (OP == OP_SELECT) {
    return v > (float)c ? __fsub_rn(v, 1e-7f) : __fadd_rn(v, 1e-7f);
  } else {
    const unsigned b = __float_as_uint(v);
    return __uint_as_float((k & 1) ? (b ^ xq[(k >> 1) & 3]) : (b & aq[(k >> 1) & 3]));
  }
}

// x, y: one float per thread.  masks: four xor operands, then four and masks.
template <int OP>
__global__ void __launch_bounds__(MAX_THREADS)
alu_kernel(const float* __restrict__ x, float* __restrict__ y,
           const unsigned* __restrict__ masks, int loops, float three) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned xq[4], aq[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    xq[j] = masks[j];
    aq[j] = masks[4 + j];
  }
  float v[CHAINS];
  const float x0 = x[i];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) v[c] = __fadd_rn(x0, (float)c);
  for (int l = 0; l < loops; ++l) {
#pragma unroll
    for (int k = 0; k < INNER; ++k) {
#pragma unroll
      for (int c = 0; c < CHAINS; ++c) v[c] = step<OP>(v[c], c, k, xq, aq, three);
    }
  }
  if (OP == OP_BITOPS) {
    unsigned t = __float_as_uint(v[0]);
#pragma unroll
    for (int c = 1; c < CHAINS; ++c) t ^= __float_as_uint(v[c]);
    y[i] = __uint_as_float(t);
  } else {
    float t = v[0];
#pragma unroll
    for (int c = 1; c < CHAINS; ++c) t = __fadd_rn(t, v[c]);
    y[i] = t;
  }
}

// x, y: (blocks, CHAINS, Z).  Step k rotates every chain by 1 + k % 5 (mod Z).
// Held to the registers that let two full blocks share an SM, as the
// decoder's min-sum kernels are.
__global__ void __launch_bounds__(MAX_THREADS, 2)
rotate_kernel(const float* __restrict__ x, float* __restrict__ y, int Z, int loops) {
  extern __shared__ __align__(16) float sh[];
  float* a = sh;
  float* b = sh + CHAINS * Z;
  const int z = threadIdx.x;
  const bool active = z < Z;
  const size_t base = (size_t)blockIdx.x * CHAINS * Z;
  int shift[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) shift[j] = (1 + j) % Z;
  if (active) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) a[c * Z + z] = x[base + c * Z + z];
  }
  __syncthreads();
  for (int l = 0; l < loops; ++l) {
#pragma unroll
    for (int k = 0; k < INNER; ++k) {
      if (active) {
        int idx = z + shift[k % 5];
        if (idx >= Z) idx -= Z;
        float r[CHAINS];
#pragma unroll
        for (int c = 0; c < CHAINS; ++c) r[c] = a[c * Z + idx];
#pragma unroll
        for (int c = 0; c < CHAINS; ++c) b[c * Z + z] = r[c];
      }
      __syncthreads();
      float* t = a;
      a = b;
      b = t;
    }
  }
  if (active) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) y[base + c * Z + z] = a[c * Z + z];
  }
}

// x: (blocks, Z).  scratch: (blocks, E, Z), E a multiple of SCRATCH_GROUP.
// Sweep 0 writes x + e; every later sweep reads a value and writes it + 1.
__global__ void __launch_bounds__(MAX_THREADS)
scratch_kernel(const float* __restrict__ x, float* __restrict__ scratch, int Z,
               int E, int sweeps) {
  const int z = threadIdx.x;
  const bool active = z < Z;
  float* m = scratch + (size_t)blockIdx.x * E * Z + z;
  const float x0 = active ? x[(size_t)blockIdx.x * Z + z] : 0.0f;
  for (int it = 0; it < sweeps; ++it) {
    const bool first = it == 0;
    for (int e0 = 0; e0 < E; e0 += SCRATCH_GROUP) {
      if (active) {
        float v[SCRATCH_GROUP];
#pragma unroll
        for (int i = 0; i < SCRATCH_GROUP; ++i)
          v[i] = first ? __fadd_rn(x0, (float)(e0 + i))
                       : __fadd_rn(m[(size_t)(e0 + i) * Z], 1.0f);
#pragma unroll
        for (int i = 0; i < SCRATCH_GROUP; ++i) m[(size_t)(e0 + i) * Z] = v[i];
      }
      __syncthreads();
    }
  }
}

extern "C" int op_rates_chains() { return CHAINS; }
extern "C" int op_rates_inner() { return INNER; }
extern "C" int op_rates_scratch_group() { return SCRATCH_GROUP; }

template <int OP>
static int launch_alu(const void* x, void* y, const void* masks, int blocks,
                      int threads, int loops, int smem_bytes, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      alu_kernel<OP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  alu_kernel<OP><<<blocks, threads, smem_bytes, s>>>(
      (const float*)x, (float*)y, (const unsigned*)masks, loops, 3.0f);
  return (int)cudaGetLastError();
}

// Launches class `op` on `stream`: `blocks` blocks of `threads` threads, each
// asking for `smem_bytes` of dynamic shared memory (which sets how many
// blocks share an SM).  Arithmetic classes: x and y hold blocks*threads
// floats, `masks` eight words.  Rotation: x and y are (blocks, CHAINS, Z) and
// smem_bytes must hold two such tiles.  Scratch stream: x is (blocks, Z), y
// the (blocks, E, Z) scratch, `loops` the number of sweeps.  Does not
// synchronise and allocates nothing.  Returns cudaGetLastError().
extern "C" int op_rates_run(int op, const void* x, void* y, const void* masks,
                            int blocks, int threads, int Z, int E, int loops,
                            int smem_bytes, void* stream) {
  if (blocks < 1 || threads < 1 || threads > MAX_THREADS || loops < 0 ||
      smem_bytes < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case OP_ADDMUL:
      return launch_alu<OP_ADDMUL>(x, y, masks, blocks, threads, loops, smem_bytes, s);
    case OP_MINMAX:
      return launch_alu<OP_MINMAX>(x, y, masks, blocks, threads, loops, smem_bytes, s);
    case OP_SELECT:
      return launch_alu<OP_SELECT>(x, y, masks, blocks, threads, loops, smem_bytes, s);
    case OP_BITOPS:
      return launch_alu<OP_BITOPS>(x, y, masks, blocks, threads, loops, smem_bytes, s);
    case OP_ROTATE: {
      if (Z < 1 || Z > threads || smem_bytes < 2 * CHAINS * Z * 4)
        return (int)cudaErrorInvalidValue;
      cudaError_t err = cudaFuncSetAttribute(
          rotate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
      if (err != cudaSuccess) return (int)err;
      rotate_kernel<<<blocks, threads, smem_bytes, s>>>(
          (const float*)x, (float*)y, Z, loops);
      return (int)cudaGetLastError();
    }
    case OP_SCRATCH: {
      if (Z < 1 || Z > threads || E < SCRATCH_GROUP || E % SCRATCH_GROUP)
        return (int)cudaErrorInvalidValue;
      cudaError_t err = cudaFuncSetAttribute(
          scratch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
      if (err != cudaSuccess) return (int)err;
      scratch_kernel<<<blocks, threads, smem_bytes, s>>>(
          (const float*)x, (float*)y, Z, E, loops);
      return (int)cudaGetLastError();
    }
  }
  return (int)cudaErrorInvalidValue;
}
