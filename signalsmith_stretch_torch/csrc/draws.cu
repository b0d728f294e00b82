// Seeded uniform draws of the randomised binTimeFactors (kernel I).
//
// Replaces jax.random.uniform where the JAX package draws the per-bin time
// factors above 2x (signalsmith-stretch.h:747-757), which XLA compiles into
// one fused computation (not a Pallas kernel):
//   offline, signalsmith_stretch_tpu/planner.py:481-490: (2, nB, B) a clip
//     from PRNGKey(seed), then the per-block select against tf;
//   per stream block, signalsmith_stretch_tpu/spectral.py:455-467: (2, B)
//     under the block's split key (:608).
//
// Contract (bit-equal to prng.uniform and the selects, ops/draws.py):
//   element b of row (clip, blk) of btf1 hashes the count blk*B + b, of
//   btf2 the count nB*B + blk*B + b: JAX's row-major iota over (2, nB, B).
//   The bits are x0 ^ x1 of Threefry-2x32 (20 rounds) of the count's two
//   32-bit halves (hi, lo) under the clip's key (jax_threefry_partitionable);
//   the float is (bits >> 9 | 0x3F800000) - 1, exact; the draw is
//   fma(f, hi - lo, lo) rounded once (XLA contracts it on the CPU), then
//   max(lo, .).  A block that does not draw writes tf and hashes nothing;
//   the counts it skips stay skipped.
//
// Bound on this card: int32 issue.  Each draw is one hash of ~72 integer
// instructions (20 rounds of an add, a funnel-shift rotate and an xor, and
// the key injections) for 4 bytes written: at 3x (batch 8, 1001 blocks,
// B = 4096) ~5.9 G instructions against 262 MB, so ~0.3 ms of integer
// issue at 64 a clock an SM against 0.08 ms of bytes.  Design: a grid-stride
// loop in which each thread takes 4 consecutive bins of one row in both
// halves, 8 independent hashes in registers for the issue slots to
// interleave, rotates with __funnelshift_l, and stores the 16-byte float4s
// of btf1 and btf2 directly (scalar stores when B % 4 != 0); nothing goes
// through shared memory.  A stream block (2 x 4096) is 4 CTAs: its time is
// the launch.  Built with --fmad=false: only the draw's own __fmaf_rn fuses.
#include <cuda_runtime.h>
#include <stdint.h>

#define DRAWS_THREADS 256
#define DRAWS_CTAS_PER_SM 8

// where a row's key and bounds come from
struct Rows {
  const uint32_t* keys;       // [batch, 2] a clip's key, or null: (k0, k1)
  const float* tf;            // [nB] upper bounds, or null: hi1 (one block)
  const float* lo;            // [nB] lower bounds
  const unsigned char* draw;  // [nB] nonzero where the block draws
  uint32_t k0, k1;
  float lo1, hi1;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// x0 ^ x1 of Threefry-2x32 of (hi, lo) under the key words ks[0..2]
__device__ __forceinline__ uint32_t threefry_bits(const uint32_t (&ks)[3],
                                                  unsigned long long count) {
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = (uint32_t)(count >> 32) + ks[0];
  uint32_t x1 = (uint32_t)count + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return x0 ^ x1;
}

__device__ __forceinline__ float uniform(uint32_t bits, float lo, float span) {
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  const float v = __fmaf_rn(f, span, lo);
  return lo < v ? v : lo;               // torch.maximum(lo, v)
}

template <int W>
__global__ void __launch_bounds__(DRAWS_THREADS)
    draws_kernel(Rows r, float* __restrict__ out1, float* __restrict__ out2,
                 int nB, int B, unsigned items) {
  const unsigned quads = (unsigned)(B + 3) / 4;
  for (unsigned i = blockIdx.x * DRAWS_THREADS + threadIdx.x; i < items;
       i += gridDim.x * DRAWS_THREADS) {
    const unsigned row = i / quads;                 // clip * nB + block
    const int b0 = (int)(i - row * quads) * 4;
    const int blk = (int)(row % (unsigned)nB);
    const int clip = (int)(row / (unsigned)nB);
    const float hi = r.tf ? r.tf[blk] : r.hi1;
    float v1[4], v2[4];
    if (r.tf && !r.draw[blk]) {
#pragma unroll
      for (int j = 0; j < 4; ++j) v1[j] = v2[j] = hi;
    } else {
      const float lo = r.tf ? r.lo[blk] : r.lo1;
      const float span = hi - lo;
      const uint32_t k0 = r.keys ? r.keys[2 * clip] : r.k0;
      const uint32_t k1 = r.keys ? r.keys[2 * clip + 1] : r.k1;
      const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
      const unsigned long long c1 = (unsigned long long)blk * B + b0;
      const unsigned long long c2 = c1 + (unsigned long long)nB * B;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v1[j] = uniform(threefry_bits(ks, c1 + j), lo, span);
        v2[j] = uniform(threefry_bits(ks, c2 + j), lo, span);
      }
    }
    const size_t o = (size_t)row * B + b0;
    if (W == 4) {
      *reinterpret_cast<float4*>(out1 + o) =
          make_float4(v1[0], v1[1], v1[2], v1[3]);
      *reinterpret_cast<float4*>(out2 + o) =
          make_float4(v2[0], v2[1], v2[2], v2[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (b0 + j < B) {
          out1[o + j] = v1[j];
          out2[o + j] = v2[j];
        }
    }
  }
}

static int launch(const Rows& r, float* out1, float* out2, int batch, int nB,
                  int B, cudaStream_t stream) {
  if (batch <= 0 || nB <= 0 || B <= 0) return 0;
  const unsigned long long items =
      (unsigned long long)batch * nB * ((B + 3) / 4);
  if (items > 0x7FFFFFFFull) return (int)cudaErrorInvalidValue;
  static int sms[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!sms[dev])
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  unsigned long long ctas = (items + DRAWS_THREADS - 1) / DRAWS_THREADS;
  if (ctas > (unsigned long long)sms[dev] * DRAWS_CTAS_PER_SM)
    ctas = (unsigned long long)sms[dev] * DRAWS_CTAS_PER_SM;
  const bool vec = B % 4 == 0 && (reinterpret_cast<size_t>(out1) & 15) == 0 &&
                   (reinterpret_cast<size_t>(out2) & 15) == 0;
  if (vec)
    draws_kernel<4><<<(unsigned)ctas, DRAWS_THREADS, 0, stream>>>(
        r, out1, out2, nB, B, (unsigned)items);
  else
    draws_kernel<1><<<(unsigned)ctas, DRAWS_THREADS, 0, stream>>>(
        r, out1, out2, nB, B, (unsigned)items);
  return (int)cudaGetLastError();
}

// The offline planner's factors: btf1, btf2 [batch, nB, B] f32 for the
// clips' keys [batch, 2] and the blocks' tf, lo and draw flags [nB].
extern "C" int sst_draws_factors(const uint32_t* keys, const float* tf,
                                 const float* lo, const unsigned char* draw,
                                 float* btf1, float* btf2, int batch, int nB,
                                 int B, void* stream) {
  Rows r = {keys, tf, lo, draw, 0u, 0u, 0.f, 0.f};
  return launch(r, btf1, btf2, batch, nB, B, (cudaStream_t)stream);
}

// One stream block's draws [2, B] f32 under the split key (k0, k1), in
// [lo, hi): the key and bounds are kernel arguments, nothing is copied.
extern "C" int sst_draws_block(uint32_t k0, uint32_t k1, float lo, float hi,
                               float* out, int B, void* stream) {
  Rows r = {nullptr, nullptr, nullptr, nullptr, k0, k1, lo, hi};
  return launch(r, out, out + B, 1, 1, B, (cudaStream_t)stream);
}
