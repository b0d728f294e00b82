// A chain of serial passes along the bins of every row, in one launch:
// kernels C (csrc/scan.cu) and E (csrc/decay.cu).  Each pass runs
//   y_b = step(y_{b-1}, x_b)
// forward or backward over a row, starting from the previous pass's last
// value and reading the previous pass's output (the first pass: the input
// and the row's initial value).
//
// Bound on this card: the chain.  Bit equality with the reference's serial
// order makes each row one dependent chain of B steps a pass (three float32
// operations a step, ~12 cycles), so a pass costs ~B x 12 cycles however
// many rows run beside it; reading the plane once and writing it once
// would take a fraction of that.  Design:
// - A CTA owns 32 rows; lane r of warp 0 (the computing warp) runs row r
//   in the reference's order.  At 2680 rows that is 84 CTAs, one wave.
// - The rows stream through shared memory in tiles of 32 rows x CHAIN_TILE
//   bins held in a ring of slots.  Four copying warps bring tiles in with
//   cp.async (16-byte copies along bins when the rows allow it) and send
//   finished tiles out with coalesced stores; the computing warp never
//   touches device memory on the chain.
// - A tile row takes CHAIN_PITCH = CHAIN_TILE + 4 floats, so the 32 lanes'
//   16-byte reads of one bin column fall in 8 distinct bank quads per phase
//   of 8 lanes (no bank conflicts), as do the copies along a row.
// - The computing lane reads its whole tile row into registers before the
//   chain (the loads do not depend on it), runs the steps, and writes the
//   outputs back in place; only the step itself is on the dependent path.
// - Between passes the intermediate goes through the output (mostly in
//   L2), except the last CHAIN_KEEP tiles of a pass, which stay in their
//   slots when the next pass runs the other way.
// - The order of computes, copies and stores is a table of steps computed
//   on the host (ops/scan_ops.chain_walk, whose CPU model checks every
//   slot and copy); one barrier ends each step.
// Built with --fmad=false: each step rounds as the plain PyTorch version.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define CHAIN_TILE 128            // ops/scan_ops.CHAIN_TILE
#define CHAIN_LEAD 3              // ops/scan_ops.CHAIN_LEAD
#define CHAIN_ROWS 32             // ops/scan_ops.CHAIN_ROWS
#define CHAIN_PITCH (CHAIN_TILE + 4)
#define CHAIN_SLOT (CHAIN_ROWS * CHAIN_PITCH)   // floats a slot
#define CHAIN_COPIERS 128         // threads of the copying warps
#define CHAIN_THREADS (32 + CHAIN_COPIERS)

namespace chain {

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one row's steps over one tile in shared memory (w bins), in place;
// returns the last value
template <bool BACK, class Step>
__device__ __forceinline__ float run_tile(float* row, int w, float v,
                                          const Step& step) {
  if (w == CHAIN_TILE) {
    float4* r4 = reinterpret_cast<float4*>(row);
    float4 a[CHAIN_TILE / 4];
#pragma unroll
    for (int q = 0; q < CHAIN_TILE / 4; ++q) a[q] = r4[q];
#pragma unroll
    for (int i = 0; i < CHAIN_TILE / 4; ++i) {
      const int q = BACK ? CHAIN_TILE / 4 - 1 - i : i;
      if (BACK) {
        v = a[q].w = step(v, a[q].w);
        v = a[q].z = step(v, a[q].z);
        v = a[q].y = step(v, a[q].y);
        v = a[q].x = step(v, a[q].x);
      } else {
        v = a[q].x = step(v, a[q].x);
        v = a[q].y = step(v, a[q].y);
        v = a[q].z = step(v, a[q].z);
        v = a[q].w = step(v, a[q].w);
      }
      r4[q] = a[q];
    }
  } else {   // the ragged last tile of a row
    for (int i = 0; i < w; ++i) {
      const int b = BACK ? w - 1 - i : i;
      v = step(v, row[b]);
      row[b] = v;
    }
  }
  return v;
}

// the copying threads' share of one tile: c = thread + k*CHAIN_COPIERS runs
// over (row, 16-byte chunk) or (row, bin), along bins first
template <bool VEC4>
__device__ __forceinline__ void store_tile(const float* slot, float* y,
                                           long long row0, int rows, int B,
                                           int tile, int t) {
  const int b0 = tile * CHAIN_TILE, w = min(CHAIN_TILE, B - b0);
  if (VEC4) {
    for (int c = t; c < rows * (CHAIN_TILE / 4); c += CHAIN_COPIERS) {
      const int r = c / (CHAIN_TILE / 4), q = 4 * (c % (CHAIN_TILE / 4));
      if (q < w)
        *reinterpret_cast<float4*>(y + (row0 + r) * B + b0 + q) =
            *reinterpret_cast<const float4*>(slot + r * CHAIN_PITCH + q);
    }
  } else {
    for (int c = t; c < rows * CHAIN_TILE; c += CHAIN_COPIERS) {
      const int r = c / CHAIN_TILE, b = c % CHAIN_TILE;
      if (b < w) y[(row0 + r) * B + b0 + b] = slot[r * CHAIN_PITCH + b];
    }
  }
}

template <bool VEC4>
__device__ __forceinline__ void load_tile(float* slot, const float* src,
                                          long long row0, int rows, int B,
                                          int tile, int t) {
  const int b0 = tile * CHAIN_TILE, w = min(CHAIN_TILE, B - b0);
  if (VEC4) {
    for (int c = t; c < rows * (CHAIN_TILE / 4); c += CHAIN_COPIERS) {
      const int r = c / (CHAIN_TILE / 4), q = 4 * (c % (CHAIN_TILE / 4));
      if (q < w)
        cp_async16(slot + r * CHAIN_PITCH + q, src + (row0 + r) * B + b0 + q);
    }
  } else {
    for (int c = t; c < rows * CHAIN_TILE; c += CHAIN_COPIERS) {
      const int r = c / CHAIN_TILE, b = c % CHAIN_TILE;
      if (b < w)
        cp_async4(slot + r * CHAIN_PITCH + b, src + (row0 + r) * B + b0 + b);
    }
  }
}

// walk: [nsteps][8] int32 (ops/scan_ops.chain_walk), read as two int4 a
// step: (comp_slot, comp_tile, comp_flags, store_slot) and (store_tile,
// load_slot, load_tile, load_src), -1 for a part the step does not have.
// Op: load(row) reads the row's own parameters; run(row, w, v, flags) runs
// one tile of the pass with those flags.
template <class Op, bool VEC4>
__global__ void __launch_bounds__(CHAIN_THREADS)
chain_kernel(const float* x, float* y, const float* __restrict__ init,
             float* __restrict__ fin, int R, int B,
             const int4* __restrict__ walk, int nsteps, Op op) {
  extern __shared__ __align__(16) float smem[];
  const long long row0 = (long long)blockIdx.x * CHAIN_ROWS;
  const int rows = (int)min((long long)CHAIN_ROWS, R - row0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool chain = warp == 0 && lane < rows;
  float v = 0.f;
  if (chain) {
    v = init[row0 + lane];
    op.load(row0 + lane);
  }
  int4 n0 = __ldg(walk), n1 = __ldg(walk + 1);
  for (int j = 0; j < nsteps; ++j) {
    const int4 e0 = n0, e1 = n1;
    if (j + 1 < nsteps) {
      n0 = __ldg(walk + 2 * j + 2);
      n1 = __ldg(walk + 2 * j + 3);
    }
    if (warp == 0) {
      if (chain && e0.x >= 0)
        v = op.run(smem + e0.x * CHAIN_SLOT + lane * CHAIN_PITCH,
                   min(CHAIN_TILE, B - e0.y * CHAIN_TILE), v, e0.z);
    } else {
      const int t = threadIdx.x - 32;
      if (e0.w >= 0)
        store_tile<VEC4>(smem + e0.w * CHAIN_SLOT, y, row0, rows, B, e1.x, t);
      if (e1.y >= 0)
        load_tile<VEC4>(smem + e1.y * CHAIN_SLOT, e1.w ? y : x, row0, rows,
                        B, e1.z, t);
      cp_async_commit();
      cp_async_wait<CHAIN_LEAD - 1>();   // the copies of step j+1-LEAD landed
    }
    __syncthreads();
  }
  if (chain) fin[row0 + lane] = v;
}

// Launch one chain over x [R, B] into y [R, B] (distinct buffers), init and
// fin [R]; `tile` and `lead` must be the ones the walk was made for.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for a walk
// the kernel cannot run).
template <class Op>
int launch(const float* x, const float* init, float* y, float* fin, int R,
           int B, const int* walk, int nsteps, int slots, int tile, int lead,
           const Op& op, cudaStream_t stream) {
  if (R <= 0 || B <= 0) return 0;
  if (tile != CHAIN_TILE || lead != CHAIN_LEAD || nsteps < 1 || slots < 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)slots * CHAIN_SLOT * sizeof(float);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  // 16-byte copies need every row start 16-byte aligned
  const bool vec4 = B % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                    (uintptr_t)y % 16 == 0;
  const auto kernel = vec4 ? chain_kernel<Op, true> : chain_kernel<Op, false>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(R + CHAIN_ROWS - 1) / CHAIN_ROWS, CHAIN_THREADS, smem, stream>>>(
      x, y, init, fin, R, B, reinterpret_cast<const int4*>(walk), nsteps, op);
  return (int)cudaGetLastError();
}

}  // namespace chain
