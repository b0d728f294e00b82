// The diagonal phase sweep (Band.output recursion of the main prediction).
//
// Replaces signalsmith_stretch_tpu/wavefront.py:_sweep_unskew_fn, which on
// the TPU is an XLA lax.scan over skewed diagonals (cell semantics
// `cell`, wavefront.py:438-461; a Pallas version was removed in 33da23d).
//
// For every clip, row (block) k and bin b, with m = mc[k, b]:
//   phase    = d1*out_m[k,b-1] + d2*out_m[k,b-LV]
//            + a1*out_m[k-1,b+1] + a2*out_m[k-1,b+LV]      (summed in order)
//   out_m    = makeOutput(pe_m, pi_m, phase)
//   out_c    = makeOutput(pe_c, pi_c, out_m * (pi_c * conj(pi_m)))   (c != m)
// with values outside the grid read as zero.  On the diagonal
// t = b + k*(LV+1), out[k,b-1] and out[k-1,b+LV] lie on diagonal t-1 and
// out[k,b-LV] and out[k-1,b+1] on t-LV, so every cell of a diagonal depends
// only on the LV diagonals before it.
//
// Bound on this card: dependent steps, not bytes.  A clip needs
// D = B + (nB-1)*(LV+1) diagonals in sequence (7015 at 48 kHz, 1.25x, 10 s),
// each a chain of a few loads, ~60 flops, an IEEE division and a square root
// per cell; its bytes (~76 per cell) would stream in well under a
// millisecond.  Design: one CTA per clip; thread k owns row k (looping when
// nB exceeds the block).  The last LV+1 diagonals' outputs of every row sit
// in a shared-memory ring, so the two own-row reads and the two reads of the
// row above are shared-memory loads, and one __syncthreads() per diagonal
// publishes a diagonal to the row below.  Outputs are written unskewed
// straight into [ch, nB, B], so no skewed copy of the inputs or outputs is
// materialised.  When the ring does not fit in shared memory (very long
// clips), the same reads go to the output array itself, which holds the same
// values.  Built with --fmad=false so every product and sum rounds as in the
// plain version.
#include <cuda_runtime.h>

#define NOISE_FLOOR 1e-15f

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// makeOutput (signalsmith-stretch.h:722-803): scale the phase to the
// prediction energy, falling back to the input phase when it is too weak
__device__ __forceinline__ float2 make_output(float pe, float2 pi, float2 ph) {
  const float pn = ph.x * ph.x + ph.y * ph.y;
  const bool weak = pn <= NOISE_FLOOR;
  const float fn = pi.x * pi.x + pi.y * pi.y;
  const float2 p2 = weak ? pi : ph;
  const float pn2 = weak ? fn + NOISE_FLOOR : pn;
  const float s = sqrtf(pe / pn2);
  return make_float2(p2.x * s, p2.y * s);
}

struct Grid {
  int nB, B, ch, LV, S;   // S = LV + 1 ring slots
  long long plane;        // nB * B
  float2* ring;           // [S][ch][nB] in shared memory, or null
  float2* out;            // this clip's [ch, nB, B]
  // channel c of row k on the diagonal held in ring slot `slot`; `idx` is
  // the same cell's flat index k*B + bin in the output planes
  __device__ __forceinline__ float2 at(int c, int k, int slot,
                                       long long idx) const {
    return ring ? ring[(slot * ch + c) * nB + k] : out[c * plane + idx];
  }
};

// coef [batch, 4, nB, B] complex (a1, a2, d1, d2), mc [batch, nB, B] int32,
// pe [batch, ch, nB, B] f32, pi [batch, ch, nB, B] complex,
// out [batch, ch, nB, B] complex.
__global__ void sweep_kernel(const float2* __restrict__ coef,
                             const int* __restrict__ mcs,
                             const float* __restrict__ pe,
                             const float2* __restrict__ pi, float2* out,
                             int nB, int B, int ch, int LV, int use_ring) {
  extern __shared__ float2 smem[];
  const long long plane = (long long)nB * B;
  const long long clip = blockIdx.x;
  coef += clip * 4 * plane;
  mcs += clip * plane;
  pe += clip * ch * plane;
  pi += clip * ch * plane;
  const Grid g{nB, B, ch, LV, LV + 1, plane, use_ring ? smem : nullptr,
               out + clip * ch * plane};
  const int step = LV + 1;
  const long long D = B + (long long)(nB - 1) * step;
  const float2 zero = make_float2(0.f, 0.f);
  for (long long t = 0; t < D; ++t) {
    // ring slots of diagonals t, t-1 and t-LV (t-LV = t+1 mod LV+1)
    const int slot = (int)(t % g.S);
    const int slot1 = slot == 0 ? LV : slot - 1;
    const int slotl = slot == LV ? 0 : slot + 1;
    for (int k = threadIdx.x; k < nB; k += blockDim.x) {
      const long long b = t - (long long)k * step;
      if (b < 0 || b >= B) continue;
      const long long i = (long long)k * B + b;
      const int m = mcs[i];
      const float2 down1 = b >= 1 ? g.at(m, k, slot1, i - 1) : zero;
      const float2 downl = b >= LV ? g.at(m, k, slotl, i - LV) : zero;
      const float2 up1 =
          (k >= 1 && b + 1 < B) ? g.at(m, k - 1, slotl, i - B + 1) : zero;
      const float2 upl =
          (k >= 1 && b + LV < B) ? g.at(m, k - 1, slot1, i - B + LV) : zero;
      const float2 v1 = cmul(coef[2 * plane + i], down1);
      const float2 v2 = cmul(coef[3 * plane + i], downl);
      const float2 v3 = cmul(coef[i], up1);
      const float2 v4 = cmul(coef[plane + i], upl);
      const float2 phase = make_float2(((v1.x + v2.x) + v3.x) + v4.x,
                                       ((v1.y + v2.y) + v3.y) + v4.y);
      const float2 pim = pi[m * plane + i];
      const float2 lead = make_output(pe[m * plane + i], pim, phase);
      for (int c = 0; c < ch; ++c) {
        float2 v = lead;
        if (c != m) {
          const float2 pic = pi[c * plane + i];
          // pi_c * conj(pi_m)
          const float2 ct = make_float2(pic.x * pim.x + pic.y * pim.y,
                                        pic.y * pim.x - pic.x * pim.y);
          v = make_output(pe[c * plane + i], pic, cmul(lead, ct));
        }
        g.out[c * plane + i] = v;
        if (g.ring) g.ring[(slot * ch + c) * nB + k] = v;
      }
    }
    __syncthreads();
  }
}

// Launch one CTA per clip.  Returns the cudaError_t of the launch.
extern "C" int sst_sweep(const void* coef, const int* mc, const float* pe,
                         const void* pi, void* out, int batch, int nB, int B,
                         int ch, int LV, void* stream) {
  if (batch <= 0 || nB <= 0 || B <= 0) return 0;
  int threads = ((nB + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t ring = (size_t)(LV + 1) * ch * nB * sizeof(float2);
  const int use_ring = ring <= (size_t)optin;
  const size_t smem = use_ring ? ring : 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sweep_kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(
      (const float2*)coef, mc, pe, (const float2*)pi, (float2*)out, nB, B, ch,
      LV, use_ring);
  return (int)cudaGetLastError();
}
