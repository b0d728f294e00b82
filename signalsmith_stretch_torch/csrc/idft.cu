// The synthesis's inverse modified DFT (kernel K): for every block of
// spectra S_b, b < M = N/2, the windowed samples
//   y[n] = 2/N Re[ sum_b S_b e^{+2 pi i n (b + 0.5) / N} ] w[n],   n < block,
// which is 2 Re(ifft(pad(S, N))[n] conj(twist[n])) w[n], the plain
// `stft.synthesize`.  y (before the window) is the real frame whose analysis
// (kernel D, csrc/dft.cu) is S, so K runs D's factorisation backwards, as
// ONE complex FFT of half length M per block:
//   A = S_b, B = S_{M-1-b}, e = conj A + B, g = i post_b (conj A - B)
//   W_b = e - g,   W_{M-1-b} = conj(e + g)                    (pre-combine)
//   X   = FFT_M(W)                     (D's passes, D's twiddles, csrc/fft.cuh)
//   y_2m + i y_2m+1 = conj(X_m pre_m) / N                      (epilogue)
// with D's tables: post_b = e^{-2 pi i (b + 0.5) / N} (b < M/2) and
// pre_m = e^{-i pi m / M}.  W is conj of 2 Z, Z the half-length spectrum D
// post-combines, so FFT_M(W) is the conjugate of Z's inverse FFT times 2M:
// the inverse passes are D's forward passes between two conjugations, which
// cost nothing (the pre-combine forms conj Z directly, the epilogue takes
// the conjugate while it unpacks).  The window table holds w[n] / N, exact
// (N is a power of two).
//
// Replaces no Pallas kernel: the JAX package synthesises with XLA's FFT in
// plain jnp (signalsmith_stretch_tpu/stft.py:synthesize, and its engine's
// _overlap_add); the plain PyTorch version, `stft.synthesize`, pads every
// spectrum to N bands (a copy of 4.2 GB at 3x for 32 x 10 s stereo), runs
// cuFFT's ifft on it (another 4.2 GB), then three elementwise passes.
//
// Bound on this card: bytes.  A block reads its spectrum once (8 M bytes)
// and writes its `block` windowed samples once (4 block bytes): at 3x,
// 64,064 blocks of 4096 bands and 5760 samples, 2.10 GB read and 1.48 GB
// written, 1.07 ms at 3.35 TB/s; the FFT's ~0.3 MFLOP a block take a
// quarter of that at the float32 rate.  Design, D's: a persistent CTA walks
// over blocks, three CTAs an SM at N 8192; it stages its next spectrum into
// shared memory with cp.async (16-byte copies where the spectra are
// aligned) while it runs the current one's passes; pass 0 reads the staged
// spectrum and forms the pre-combine in registers (each thread both bands of
// its pairs, so no exchange); the epilogue writes the samples below `block`
// only, 8 bytes a thread where the rows allow, in natural block order
// [batch, ch, nB, block], the layout the assembly (kernel L, csrc/ola.cu)
// reads each block's samples from contiguously.  No padded copy, no FFT
// workspace, no complex time-domain intermediate in device memory.  Float32
// throughout with explicit fmaf: held to the plain version at 3e-6 of the
// block's peak, not to a bit pattern (cuFFT rounds otherwise).
#include "fft.cuh"

// stage spectrum f ([M] complex64) into shared memory: 16-byte copies when
// the spectra are 16-byte aligned, else 8-byte ones
template <int T, int M>
__device__ __forceinline__ void stage_spectrum(float2* ss,
                                               const float2* spec, int f,
                                               int vec4, int t) {
  const float2* sf = spec + (long long)f * M;
  if (vec4) {
    for (int i = t; i < M / 2; i += T) cp_async16(ss + 2 * i, sf + 2 * i);
  } else {
    for (int i = t; i < M; i += T) cp_async8(ss + i, sf + i);
  }
}

template <int LOG2N>
__global__ void __launch_bounds__(dft_threads(LOG2N), min_blocks(LOG2N))
idft_kernel(const float2* __restrict__ spec, const float* __restrict__ wn,
            const float2* __restrict__ pre, const float2* __restrict__ post,
            const float2* __restrict__ tw, float* __restrict__ out, int F,
            int block, int vec4, int vec2) {
  constexpr int M = 1 << (LOG2N - 1), T = dft_threads(LOG2N);
  constexpr int R0 = radix(LOG2N, 0), Q0 = M / R0 / T;
  extern __shared__ float2 smem[];
  float2* buf = smem;                  // [padded(M)]
  float2* ss = smem + padded(M);       // [M] the staged spectrum
  const int t = threadIdx.x;
  if (blockIdx.x < F) stage_spectrum<T, M>(ss, spec, blockIdx.x, vec4, t);

  for (int f = blockIdx.x; f < F; f += gridDim.x) {
    cp_async_wait_all();
    __syncthreads();   // spectrum f staged; the previous epilogue is done
    // pass 0 on W_m for m = j + r M/R0: m < M/2 exactly when r < R0/2, so
    // whether m is the pair's lower band is known at compile time
    float2 v[Q0][R0];
#pragma unroll
    for (int q = 0; q < Q0; ++q)
#pragma unroll
      for (int r = 0; r < R0; ++r) {
        const int m = t + q * T + r * (M / R0);
        const bool low = r < R0 / 2;
        const int b = low ? m : M - 1 - m;
        const float2 a = ss[b], c = ss[M - 1 - b], p = __ldg(post + b);
        const float2 e = make_float2(a.x + c.x, c.y - a.y);
        const float2 d = make_float2(a.x - c.x, -a.y - c.y);
        const float2 pd = cmul(p, d);               // g = i pd
        v[q][r] = low ? make_float2(e.x + pd.y, e.y - pd.x)
                      : make_float2(e.x - pd.y, -(e.y + pd.x));
      }
#pragma unroll
    for (int q = 0; q < Q0; ++q) {
      dft_regs<R0>(v[q]);
      const int j = t + q * T;
#pragma unroll
      for (int r = 0; r < R0; ++r) buf[padded(j * R0 + r)] = v[q][r];
    }
    __syncthreads();   // the staged spectrum is read: stage the next one
    if (f + gridDim.x < F)
      stage_spectrum<T, M>(ss, spec, f + gridDim.x, vec4, t);
    fft_passes<LOG2N, 1>(buf, tw, t);

    // epilogue: samples 2m and 2m+1 from X_m, below `block` only
    float* of = out + (long long)f * block;
#pragma unroll
    for (int q = 0; q < M / T; ++q) {
      const int m = t + q * T, n = 2 * m;
      if (n < block) {
        const float2 c = cmul(buf[padded(m)], __ldg(pre + m));
        const float y0 = c.x * __ldg(wn + n);
        if (n + 1 < block) {
          const float y1 = -c.y * __ldg(wn + n + 1);
          if (vec2) {
            *reinterpret_cast<float2*>(of + n) = make_float2(y0, y1);
          } else {
            of[n] = y0;
            of[n + 1] = y1;
          }
        } else {
          of[n] = y0;
        }
      }
    }
  }
}

template <int LOG2N>
static int launch(const float2* spec, const float* wn, const float2* pre,
                  const float2* post, const float2* tw, float* out, int F,
                  int block, int vec4, int vec2, cudaStream_t stream) {
  constexpr int M = 1 << (LOG2N - 1), T = dft_threads(LOG2N);
  const size_t smem = sizeof(float2) * (padded(M) + M);
  cudaError_t err = cudaFuncSetAttribute(
      idft_kernel<LOG2N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, idft_kernel<LOG2N>, T, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // a persistent grid: every resident CTA while the blocks outnumber them,
  // a CTA a block below that (a batch-1 render still fills the card)
  const int grid = F < sms * per_sm ? F : sms * per_sm;
  idft_kernel<LOG2N><<<grid, T, smem, stream>>>(spec, wn, pre, post, tw,
                                                 out, F, block, vec4, vec2);
  return (int)cudaGetLastError();
}

// spec [F, N/2] complex64 spectra; wn [N] f32 window over N, zero past
// block; pre [N/2] and post [N/4] complex64, tw [n_tw] complex64 pass
// twiddles (ops/dft.py tables, D's); out [F, block] f32.  N = 2^log2n with
// 10 <= log2n <= 14 and block <= N.  Returns a cudaError_t
// (cudaErrorInvalidValue for another N, or a twiddle table that does not
// match this plan).
extern "C" int sst_idft(const void* spec, const float* wn, const void* pre,
                        const void* post, const void* tw, float* out, int F,
                        int block, int log2n, int n_tw, void* stream) {
  if (F <= 0) return (int)cudaSuccess;
  if (log2n < 10 || log2n > 14 || block < 1 || block > (1 << log2n) ||
      n_tw != tw_count(log2n))
    return (int)cudaErrorInvalidValue;
  const int vec4 = ((uintptr_t)spec & 15) == 0;
  const int vec2 = block % 2 == 0 && ((uintptr_t)out & 7) == 0;
  const float2 *s = (const float2*)spec, *p = (const float2*)pre,
               *q = (const float2*)post, *t = (const float2*)tw;
  cudaStream_t st = (cudaStream_t)stream;
  switch (log2n) {
    case 10: return launch<10>(s, wn, p, q, t, out, F, block, vec4, vec2, st);
    case 11: return launch<11>(s, wn, p, q, t, out, F, block, vec4, vec2, st);
    case 12: return launch<12>(s, wn, p, q, t, out, F, block, vec4, vec2, st);
    case 13: return launch<13>(s, wn, p, q, t, out, F, block, vec4, vec2, st);
    default: return launch<14>(s, wn, p, q, t, out, F, block, vec4, vec2, st);
  }
}
