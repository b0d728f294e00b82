// The analysis DFT: the modified real DFT of windowed frames
//   S_b = sum_n w[n] x[n] e^{-2 pi i n (b + 0.5) / N},   b < N/2,
// with the window multiply and the zero pad past `block` fused in, computed
// as the two-stage Cooley-Tukey factorisation of stft._dft_mats:
//   n = n1*N2 + n2,  b = k1 + N1*k2,
//   A[k1, n2] = sum_{n1 < n1u} dft1[k1, n1] y[n1*N2 + n2]   (stage 1, real y)
//   B[k1, n2] = A[k1, n2] * tw[k1, n2]                       (twiddle)
//   S[k1 + N1*k2] = sum_{n2} B[k1, n2] dft2[n2, k2]          (stage 2)
// where n1u = ceil(block / N2) rows are read and samples at n >= block are
// zero (the fft pad never materialises).  Spectra come out complex64
// (float2) in natural band order.
//
// Replaces the Pallas kernel `fwd` of tools/exp_pallas_dft.py:pallas_fwd
// (pallas_call at :81), the fused form of the JAX package's two-stage matmul
// DFT (signalsmith_stretch_tpu/stft.py:_matmul_dft), which kept stage 1, the
// twiddle and stage 2 in VMEM per tile of frames.
//
// Bound on this card: at bench shapes (N 8192, block 5760) the bytes take
// ~0.22 ms and the ~5.7 MFLOP per frame ~1.1 ms at the float32 rate, so the
// operations bound it; in practice the loads of the constants from shared
// memory and L1 do.  Design: a persistent CTA per SM walks over frames.
// dft2 ([N2, N2/2] complex, 64 KB at N 8192) is staged in shared memory once
// per CTA, so the constant traffic per frame is the L1-resident dft1 and the
// twiddles, not the 2 MiB fused T1/T2 tensors of the TPU kernel.  Stage 1:
// thread (n2, group) reads its column of y once (coalesced) and keeps N/T
// complex accumulators in registers; it applies the twiddle and stores B
// transposed ([n2][k1], row stride N1+1, so neither the stores nor the
// stage-2 loads conflict on banks).  Stage 2: thread (k1, q) keeps N/(2T)
// outputs k2 = q + j*T/N1 for one k1; within a warp k2 is uniform, so the
// dft2 loads broadcast, and the outputs are written coalesced in band order.
// The sums use explicit fmaf: the kernel is held to 3e-6 of the spectrum's
// peak against cuFFT, not to a bit pattern, so it takes the single rounding.
#include <cuda_runtime.h>

__host__ __device__ constexpr int dft_threads(int log2n) {
  return (1 << log2n) / 32 > 128 ? (1 << log2n) / 32 : 128;
}

template <int LOG2N>
struct Geom {
  static constexpr int N = 1 << LOG2N;
  static constexpr int N1 = 1 << (LOG2N / 2);
  static constexpr int N2 = N / N1;
  static constexpr int K2 = N2 / 2;
  static constexpr int T = dft_threads(LOG2N);
  static constexpr int KPT = N / T;          // stage 1: k1 values per thread
  static constexpr int OPT = N / 2 / T;      // stage 2: outputs per thread
  static constexpr int Q = T / N1;           // stage 2: k2 stride
  static constexpr int S = N1 + 1;           // row stride of transposed B
  static constexpr size_t SMEM = sizeof(float2) * N2 * K2
                                 + 2 * sizeof(float) * N2 * S;
  static_assert(N2 >= 32 && N1 >= 32, "warp-uniform groups need N1, N2 >= 32");
  static_assert(T % N2 == 0 && T % N1 == 0, "thread layout");
};

template <int LOG2N>
__global__ void __launch_bounds__(Geom<LOG2N>::T)
dft_kernel(const float* __restrict__ x, const float* __restrict__ w,
           const float2* __restrict__ dft1, const float2* __restrict__ tw,
           const float2* __restrict__ dft2, float2* __restrict__ out, int F,
           int block, int n1u) {
  using G = Geom<LOG2N>;
  extern __shared__ float2 smem[];
  float2* d2s = smem;                              // [N2][K2]
  float* btr = reinterpret_cast<float*>(smem + G::N2 * G::K2);
  float* bti = btr + G::N2 * G::S;                 // [N2][S]
  const int t = threadIdx.x;
  for (int i = t; i < G::N2 * G::K2; i += G::T) d2s[i] = dft2[i];
  __syncthreads();

  const int n2 = t % G::N2, k1a = (t / G::N2) * G::KPT;   // stage 1
  const int k1 = t % G::N1, q = t / G::N1;                 // stage 2
  const float2* d1 = dft1 + (long long)k1a * n1u;
  for (int f = blockIdx.x; f < F; f += gridDim.x) {
    const float* xf = x + (long long)f * block;
    float ar[G::KPT], ai[G::KPT];
#pragma unroll
    for (int i = 0; i < G::KPT; ++i) ar[i] = ai[i] = 0.f;
    float yv = n2 < block ? xf[n2] * w[n2] : 0.f;
    for (int n1 = 0; n1 < n1u; ++n1) {
      const int nn = (n1 + 1) * G::N2 + n2;     // prefetch the next row
      const float yn = (n1 + 1 < n1u && nn < block) ? xf[nn] * w[nn] : 0.f;
#pragma unroll
      for (int i = 0; i < G::KPT; ++i) {
        const float2 d = __ldg(d1 + i * n1u + n1);
        ar[i] = fmaf(d.x, yv, ar[i]);
        ai[i] = fmaf(d.y, yv, ai[i]);
      }
      yv = yn;
    }
#pragma unroll
    for (int i = 0; i < G::KPT; ++i) {
      const float2 c = __ldg(tw + (k1a + i) * G::N2 + n2);
      btr[n2 * G::S + k1a + i] = fmaf(ar[i], c.x, -ai[i] * c.y);
      bti[n2 * G::S + k1a + i] = fmaf(ar[i], c.y, ai[i] * c.x);
    }
    __syncthreads();

    float xr[G::OPT], xi[G::OPT];
#pragma unroll
    for (int j = 0; j < G::OPT; ++j) xr[j] = xi[j] = 0.f;
    for (int m = 0; m < G::N2; ++m) {
      const float br = btr[m * G::S + k1], bi = bti[m * G::S + k1];
      const float2* d2 = d2s + m * G::K2 + q;
#pragma unroll
      for (int j = 0; j < G::OPT; ++j) {
        const float2 d = d2[j * G::Q];
        xr[j] = fmaf(br, d.x, fmaf(-bi, d.y, xr[j]));
        xi[j] = fmaf(br, d.y, fmaf(bi, d.x, xi[j]));
      }
    }
    float2* of = out + (long long)f * (G::N / 2);
#pragma unroll
    for (int j = 0; j < G::OPT; ++j)
      of[k1 + G::N1 * (q + j * G::Q)] = make_float2(xr[j], xi[j]);
    __syncthreads();            // B is overwritten by the next frame
  }
}

template <int LOG2N>
static int launch(const float* x, const float* w, const float2* dft1,
                  const float2* tw, const float2* dft2, float2* out, int F,
                  int block, int n1u, cudaStream_t stream) {
  using G = Geom<LOG2N>;
  cudaError_t err = cudaFuncSetAttribute(
      dft_kernel<LOG2N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)G::SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, dft_kernel<LOG2N>, G::T, G::SMEM);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = F < sms * per_sm ? F : sms * per_sm;
  dft_kernel<LOG2N><<<grid, G::T, G::SMEM, stream>>>(x, w, dft1, tw, dft2,
                                                     out, F, block, n1u);
  return (int)cudaGetLastError();
}

// x [F, block] f32 frames; w [block] f32 window; dft1 [N1, n1u], tw [N1, N2]
// and dft2 [N2, N2/2] complex64 (stft._dft_mats, dft1 cut to n1u columns);
// out [F, N/2] complex64.  N = 2^log2n with 10 <= log2n <= 14.  Returns a
// cudaError_t (cudaErrorInvalidValue for another N).
extern "C" int sst_dft(const float* x, const float* w, const void* dft1,
                       const void* tw, const void* dft2, void* out, int F,
                       int block, int log2n, int n1u, void* stream) {
  if (F <= 0) return (int)cudaSuccess;
  const float2 *d1 = (const float2*)dft1, *t2 = (const float2*)tw,
               *d2 = (const float2*)dft2;
  float2* o = (float2*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (log2n) {
    case 10: return launch<10>(x, w, d1, t2, d2, o, F, block, n1u, s);
    case 11: return launch<11>(x, w, d1, t2, d2, o, F, block, n1u, s);
    case 12: return launch<12>(x, w, d1, t2, d2, o, F, block, n1u, s);
    case 13: return launch<13>(x, w, d1, t2, d2, o, F, block, n1u, s);
    case 14: return launch<14>(x, w, d1, t2, d2, o, F, block, n1u, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
