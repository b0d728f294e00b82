// The mixed-radix Stockham FFT of half length M = N/2 that the analysis DFT
// (kernel D, csrc/dft.cu) and the synthesis's inverse modified DFT (kernel K,
// csrc/idft.cu) share: the plan of radices for each FFT size, the
// in-register DFTs of 2 to 16 points, the passes p >= 1 in shared memory
// (padded by one float2 every 16), the complex multiply and the
// asynchronous copies into shared memory.  Pass p with radix R after
// NS = R_0...R_{p-1}: butterfly j reads X[j + r M/R], multiplies by
// W_{NS R}^{r (j mod NS)}, runs a DFT of R points and writes
// Y[(j / NS) NS R + j mod NS + r NS]; the last pass leaves the forward
// transform in natural order.  Each kernel runs pass 0 itself, from what
// it staged.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

// radix of pass p of the plan for N = 2^LOG2N (0 past the last pass);
// ops/dft.py RADICES holds the same plan and builds the twiddle tables
__host__ __device__ constexpr int radix(int log2n, int p) {
  return log2n == 10 ? (p < 3 ? 8 : 0)
       : log2n == 11 ? (p == 0 ? 16 : p < 3 ? 8 : 0)
       : log2n == 12 ? (p < 2 ? 16 : p == 2 ? 8 : 0)
       : log2n == 13 ? (p < 3 ? 16 : 0)
       : log2n == 14 ? (p < 3 ? 16 : p == 3 ? 2 : 0) : 0;
}
// NS of pass p: the product of the radices before it
__host__ __device__ constexpr int span(int log2n, int p) {
  return p == 0 ? 1 : span(log2n, p - 1) * radix(log2n, p - 1);
}
// offset of pass p's twiddles in the table: (R-1)*NS entries per pass >= 1
__host__ __device__ constexpr int tw_offset(int log2n, int p) {
  return p <= 1 ? 0
                : tw_offset(log2n, p - 1) +
                      (radix(log2n, p - 1) - 1) * span(log2n, p - 1);
}
__host__ __device__ constexpr int passes(int log2n) {
  return radix(log2n, 3) ? 4 : 3;
}
__host__ __device__ constexpr int max_radix(int log2n) {
  return log2n == 10 ? 8 : 16;
}
__host__ __device__ constexpr int dft_threads(int log2n) {
  return (1 << (log2n - 1)) / max_radix(log2n);
}
// CTAs an SM should hold: 768 threads at <= 85 registers each
__host__ __device__ constexpr int min_blocks(int log2n) {
  return 768 / dft_threads(log2n);
}
__host__ __device__ constexpr int tw_count(int log2n) {
  return tw_offset(log2n, passes(log2n));
}
__host__ __device__ constexpr int padded(int i) { return i + (i >> 4); }

// asynchronous copies device memory -> shared memory (sm_80+)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

// W_16^e = e^{-2 pi i e / 16} for 0 < e < 8, e != 4, as float literals
__device__ __forceinline__ float2 w16(int e) {
  constexpr float c1 = 0.923879532511286756f, s1 = 0.382683432365089772f;
  constexpr float h = 0.707106781186547524f;
  const float c = e == 1 ? c1 : e == 2 ? h : e == 3 ? s1
                : e == 5 ? -s1 : e == 6 ? -h : -c1;
  const float s = e == 1 ? s1 : e == 2 ? h : e == 3 ? c1
                : e == 5 ? c1 : e == 6 ? h : s1;
  return make_float2(c, -s);
}

// b * W_R^e for e < R/2, with the trivial factors 1 and -i taken exactly
template <int R>
__device__ __forceinline__ float2 twiddle(int e, float2 b) {
  if (e == 0) return b;
  if (4 * e == R) return make_float2(b.y, -b.x);
  return cmul(b, w16(e * (16 / R)));
}

// i < 2^bits with its low `bits` bits reversed, bits <= 4
__host__ __device__ constexpr int bitrev(int i, int bits) {
  return (((i & 1) << 3) | ((i & 2) << 1) | ((i & 4) >> 1) | ((i & 8) >> 3)) >>
         (4 - bits);
}
__host__ __device__ constexpr int ilog2(int r) {
  return r <= 1 ? 0 : 1 + ilog2(r / 2);
}

// one radix-2 stage of length LEN, then the next: butterfly i pairs
// s + k and s + k + LEN/2 (k = i mod LEN/2, s = LEN*(i div LEN/2)), with a
// constant trip count so that every register index is a constant
template <int R, int LEN>
__device__ __forceinline__ void radix2_stages(float2 (&u)[R]) {
#pragma unroll
  for (int i = 0; i < R / 2; ++i) {
    const int k = i % (LEN / 2), s = LEN * (i / (LEN / 2));
    const float2 a = u[s + k];
    const float2 b = twiddle<R>(k * (R / LEN), u[s + k + LEN / 2]);
    u[s + k] = make_float2(a.x + b.x, a.y + b.y);
    u[s + k + LEN / 2] = make_float2(a.x - b.x, a.y - b.y);
  }
  if constexpr (LEN < R) radix2_stages<R, 2 * LEN>(u);
}

// in-register DFT of R <= 16 points, natural order in and out: radix-2
// decimation in time after a bit-reversal permutation
template <int R>
__device__ __forceinline__ void dft_regs(float2 (&v)[R]) {
  float2 u[R];
#pragma unroll
  for (int i = 0; i < R; ++i) u[i] = v[bitrev(i, ilog2(R))];
  radix2_stages<R, 2>(u);
#pragma unroll
  for (int i = 0; i < R; ++i) v[i] = u[i];
}

// pass P >= 1: shared memory -> registers -> shared memory, in place
template <int LOG2N, int P>
__device__ __forceinline__ void fft_pass(float2* buf,
                                         const float2* __restrict__ tws,
                                         int t) {
  constexpr int M = 1 << (LOG2N - 1), R = radix(LOG2N, P);
  constexpr int NS = span(LOG2N, P), T = dft_threads(LOG2N);
  constexpr int Q = M / R / T;                 // butterflies per thread
  const float2* tw = tws + tw_offset(LOG2N, P);
  float2 v[Q][R];
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int r = 0; r < R; ++r) v[q][r] = buf[padded(t + q * T + r * (M / R))];
  __syncthreads();
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int j = t + q * T, k = j % NS;
#pragma unroll
    for (int r = 1; r < R; ++r)
      v[q][r] = cmul(v[q][r], __ldg(tw + (r - 1) * NS + k));
    dft_regs<R>(v[q]);
    const int base = (j / NS) * NS * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) buf[padded(base + r * NS)] = v[q][r];
  }
  __syncthreads();
}

template <int LOG2N, int P>
__device__ __forceinline__ void fft_passes(float2* buf,
                                           const float2* __restrict__ tws,
                                           int t) {
  if constexpr (P < passes(LOG2N)) {
    fft_pass<LOG2N, P>(buf, tws, t);
    fft_passes<LOG2N, P + 1>(buf, tws, t);
  }
}
