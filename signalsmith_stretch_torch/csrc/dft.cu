// The analysis DFT: the modified real DFT of windowed frames
//   S_b = sum_n w[n] x[n] e^{-2 pi i n (b + 0.5) / N},   b < M = N/2,
// with the window multiply and the zero pad past `block` fused in, computed
// as ONE complex FFT of half length M per frame.  y = w*x is real, so
// S_{N-1-b} = conj(S_b) and
//   z_m = (y_{2m} + i y_{2m+1}) e^{-i pi m / M}            (pack, pre-twist)
//   Z   = FFT_M(z)
//   E_b = (Z_b + conj Z_{M-1-b}) / 2,  O_b = (Z_b - conj Z_{M-1-b}) / 2i
//   S_b = E_b + e^{-2 pi i (b + 0.5) / N} O_b                (post-combine)
// and S_{M-1-b} = conj(E_b - e^{-2 pi i (b + 0.5) / N} O_b), so one thread
// finishes the pair (b, M-1-b) from Z_b and Z_{M-1-b}.  Spectra come out
// complex64 (float2) in band order.
//
// Replaces the Pallas kernel `fwd` of tools/exp_pallas_dft.py:pallas_fwd
// (pallas_call at :81), the fused form of the JAX package's two-stage matmul
// DFT (signalsmith_stretch_tpu/stft.py:_matmul_dft), which kept stage 1, the
// twiddle and stage 2 in VMEM per tile of frames.
//
// Bound on this card: bytes.  At bench shapes (N 8192, block 5760) a frame
// reads 23 KB and writes 32 KB (0.22 ms for the 1.25x render's 13,376
// frames at 3.35 TB/s); the FFT's ~0.3 MFLOP per frame take a quarter of
// that at the float32 rate.  Design: a persistent CTA walks over frames,
// three CTAs an SM so that one frame's loads overlap another's passes.  The
// FFT is Stockham autosort, mixed radix (csrc/fft.cuh, shared with K:
// radix 16 and 8 passes, one radix 2 pass at M 8192): each thread holds
// one radix-R butterfly (or several) in registers, and the frame sits in
// shared memory between passes, padded by one float2 every 16 so that the
// strided writes of the first pass and the reads of every pass are free of
// bank conflicts.
// Pass p with radix R after NS = R_0...R_{p-1}: butterfly j reads
// X[j + r M/R], multiplies by W_{NS R}^{r (j mod NS)}, runs a DFT of R
// points and writes Y[(j / NS) NS R + j mod NS + r NS]; the last pass leaves
// Z in natural order.  A CTA stages its next frame into shared memory with
// cp.async (16-byte copies where the frame is aligned) while it runs the
// current frame's passes; the first pass reads the staged sample pairs,
// zeros at or past `block` (the pad never materialises).  A CTA holds
// 57.8 KB of shared memory at N 8192 (the padded frame and the staged
// samples) and its threads stay within 85 registers, so an SM holds three
// CTAs (the pass twiddles in shared memory as well allowed two).  Twiddles
// come from host tables rounded from float64 (no __sinf/__cosf), read
// through the read-only cache, which keeps them for every CTA of the SM:
// the pass twiddles, laid out [r-1][j mod NS] per pass so that a warp reads
// consecutive entries, the pre-twist, the post-twiddle and the window.  The
// sums use explicit fmaf: the kernel is held to 3e-6 of the spectrum's peak
// against cuFFT, not to a bit pattern.
#include "fft.cuh"

// stage frame f ([block] f32) into shared memory: 16-byte copies when the
// frame is 16-byte aligned, else 4-byte ones
template <int T>
__device__ __forceinline__ void stage_frame(float* xs, const float* x, int f,
                                            int block, int vec4, int t) {
  const float* xf = x + (long long)f * block;
  if (vec4) {
    for (int i = t; i < block / 4; i += T) cp_async16(xs + 4 * i, xf + 4 * i);
  } else {
    for (int i = t; i < block; i += T) cp_async4(xs + i, xf + i);
  }
}

template <int LOG2N>
__global__ void __launch_bounds__(dft_threads(LOG2N), min_blocks(LOG2N))
dft_kernel(const float* __restrict__ x, const float2* __restrict__ w2,
           const float2* __restrict__ pre, const float2* __restrict__ post,
           const float2* __restrict__ tw, float2* __restrict__ out, int F,
           int block, int vec4) {
  constexpr int M = 1 << (LOG2N - 1), T = dft_threads(LOG2N);
  constexpr int R0 = radix(LOG2N, 0), Q0 = M / R0 / T;
  extern __shared__ float2 smem[];
  float2* buf = smem;                                   // [padded(M)]
  float* xs = reinterpret_cast<float*>(smem + padded(M));  // [block]
  const int t = threadIdx.x;
  if (blockIdx.x < F) stage_frame<T>(xs, x, blockIdx.x, block, vec4, t);

  for (int f = blockIdx.x; f < F; f += gridDim.x) {
    cp_async_wait_all();
    __syncthreads();   // frame f staged; the previous post-combine is done
    // first pass: z_m for m = j + r M/R0 from the staged frame
    float2 v[Q0][R0];
#pragma unroll
    for (int q = 0; q < Q0; ++q)
#pragma unroll
      for (int r = 0; r < R0; ++r) {
        const int m = t + q * T + r * (M / R0), n = 2 * m;
        float2 xv = make_float2(0.f, 0.f);
        if (n + 1 < block) {
          xv = *reinterpret_cast<const float2*>(xs + n);
        } else if (n < block) {
          xv.x = xs[n];
        }
        const float2 wv = __ldg(w2 + m), p = __ldg(pre + m);
        const float ye = xv.x * wv.x, yo = xv.y * wv.y;
        v[q][r] =
            make_float2(fmaf(ye, p.x, -yo * p.y), fmaf(ye, p.y, yo * p.x));
      }
#pragma unroll
    for (int q = 0; q < Q0; ++q) {
      dft_regs<R0>(v[q]);
      const int j = t + q * T;
#pragma unroll
      for (int r = 0; r < R0; ++r) buf[padded(j * R0 + r)] = v[q][r];
    }
    __syncthreads();   // the staged frame is read: stage the next one
    if (f + gridDim.x < F)
      stage_frame<T>(xs, x, f + gridDim.x, block, vec4, t);
    fft_passes<LOG2N, 1>(buf, tw, t);

    // post-combine: thread pairs band b with band M-1-b
    float2* of = out + (long long)f * M;
#pragma unroll
    for (int q = 0; q < M / 2 / T; ++q) {
      const int b = t + q * T;
      const float2 zb = buf[padded(b)], zm = buf[padded(M - 1 - b)];
      const float er = 0.5f * (zb.x + zm.x), ei = 0.5f * (zb.y - zm.y);
      const float2 o = make_float2(0.5f * (zb.y + zm.y), -0.5f * (zb.x - zm.x));
      const float2 po = cmul(__ldg(post + b), o);
      of[b] = make_float2(er + po.x, ei + po.y);
      of[M - 1 - b] = make_float2(er - po.x, -(ei - po.y));
    }
  }
}

template <int LOG2N>
static int launch(const float* x, const float2* w2, const float2* pre,
                  const float2* post, const float2* tw, float2* out, int F,
                  int block, int vec4, cudaStream_t stream) {
  constexpr int M = 1 << (LOG2N - 1), T = dft_threads(LOG2N);
  const size_t smem =
      sizeof(float2) * padded(M) + sizeof(float) * ((block + 3) & ~3);
  cudaError_t err = cudaFuncSetAttribute(
      dft_kernel<LOG2N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                      dft_kernel<LOG2N>, T,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = F < sms * per_sm ? F : sms * per_sm;
  dft_kernel<LOG2N><<<grid, T, smem, stream>>>(x, w2, pre, post, tw, out, F,
                                                block, vec4);
  return (int)cudaGetLastError();
}

// x [F, block] f32 frames; w2 [N] f32 window, zero past block; pre [N/2]
// and post [N/4] complex64; tw [n_tw] complex64 pass twiddles (ops/dft.py
// tables); out [F, N/2] complex64.  N = 2^log2n with 10 <= log2n <= 14 and
// block <= N.  Returns a cudaError_t (cudaErrorInvalidValue for another N,
// or a twiddle table that does not match this plan).
extern "C" int sst_dft(const float* x, const float* w2, const void* pre,
                       const void* post, const void* tw, void* out, int F,
                       int block, int log2n, int n_tw, void* stream) {
  if (F <= 0) return (int)cudaSuccess;
  if (log2n < 10 || log2n > 14 || block < 1 || block > (1 << log2n) ||
      n_tw != tw_count(log2n))
    return (int)cudaErrorInvalidValue;
  const int vec4 = block % 4 == 0 && ((uintptr_t)x & 15) == 0;
  const float2 *w = (const float2*)w2, *p = (const float2*)pre,
               *q = (const float2*)post, *t = (const float2*)tw;
  float2* o = (float2*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (log2n) {
    case 10: return launch<10>(x, w, p, q, t, o, F, block, vec4, s);
    case 11: return launch<11>(x, w, p, q, t, o, F, block, vec4, s);
    case 12: return launch<12>(x, w, p, q, t, o, F, block, vec4, s);
    case 13: return launch<13>(x, w, p, q, t, o, F, block, vec4, s);
    default: return launch<14>(x, w, p, q, t, o, F, block, vec4, s);
  }
}
