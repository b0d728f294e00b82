// The prediction coefficients of the offline planner (kernel J).
//
// Replaces no Pallas kernel: the JAX package forms these in plain jnp at the
// end of its planner (signalsmith_stretch_tpu/planner.py:562-690), which XLA
// fuses into a few loops; the plain PyTorch version
// (ops/coefficients.coefficients_plain) takes ~117 operations, each a pass
// over [batch, nB, B] planes.  Reference: signalsmith-stretch.h:722-803.
//
// Contract, for every bin b of row r = (clip, k), with m the first channel
// of largest pe[., r, b] and x[c, j] channel c's plane at (r, j):
//   c1(c, j) = (rot(j) * (pi[c, j] * conj(prev[c, j])))
//              / (max(pe of block k-1 [c, j], pe[c, j]) + 1e-15)
//     (block k-1 of the same clip; 0 at a clip's first block; rot(j) the
//     rotor where block k is new, else 1; the division component-wise)
//   d1 = pi[m, b] * conj(sd[m, b])                     (0 at b = 0)
//   d2 = pi[m, b] * conj(ld[m, b])                     (0 at b < LV)
//   a1 = c1(m, b+1) * conj(pi[m, b+1] * conj(us))      (0 at b >= B-1)
//   a2 = c1(m, b+LV) * conj(pi[m, b+LV] * conj(ul))    (0 at b >= B-LV)
// where us = sd[m, b+1] and ul = ld[m, b+LV] (the up votes are the down
// votes shifted), or us = us[m, b] and ul = ul[m, b] where the votes were
// drawn above 2x (four vote sets given).  Every complex product is two
// float32 products and a sum, each rounded (--fmad=false), in the plain
// version's order, so the outputs are bit-equal to it.
//
// Bound on this card: bytes.  Per bin, for ch channels: pi, prev and the
// two (or four) vote planes read (8 B each), pe read (4 B), a1, a2, d1, d2
// written (8 B each) and mc (4 B), against ~70 flops: 108 B a bin for two
// channels and two vote sets, 1.42 ms for a pitch+12 request of 32 x 10 s
// (43.9 M bins) at 3.35 TB/s.  Design: one CTA a row; its threads first turn
// the plane table (pointer, clip and block strides) into this row's
// pointers in shared memory (and block k-1's for pe), then walk the row's
// bins, each bin one thread, neighbours on neighbouring addresses.  The
// reads at b+1 and b+LV are the same lines the warp reads at b (L1 hits),
// so c1 is formed only where a1 and a2 need it, for channel m: nothing is
// written but the five outputs, and every input is read through its own
// strides (no contiguous copies).
#include <cuda_runtime.h>

#define THREADS 256
#define NOISE_FLOOR 1e-15f
// the table's kinds, each ch planes; the row pointers add PE_PREV
enum { PI, PREV, PE, SD, LD, US, UL, PE_PREV = 7, SLOTS };

// one plane of the table: base pointer, clip and block strides in bytes
struct Plane {
  long long ptr, clip, block;
};

struct Args {
  const Plane* table;            // [(5 or 7) * ch], kind-major
  const float2* rotor;           // [B]
  const unsigned char* fresh;    // [nB] nonzero where block k is new, or
                                 // null: every block new
  float2 *a1, *a2, *d1, *d2;     // [rows, B]
  int* mc;                       // [rows, B]
  int ch, nB, B, LV;
};

__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {  // a * conj(b)
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float tmax(float a, float b) {  // torch.maximum
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

template <bool DRAWN>
__global__ void __launch_bounds__(THREADS) coefficients_kernel(Args a) {
  extern __shared__ const char* row_ptr[];    // [SLOTS * ch]
  const int ch = a.ch, B = a.B, LV = a.LV;
  const int r = blockIdx.x, clip = r / a.nB, k = r - clip * a.nB;
  const int kinds = DRAWN ? UL + 1 : LD + 1;
  for (int i = threadIdx.x; i < (kinds + 1) * ch; i += THREADS) {
    const int kind = i / ch;
    const Plane p = a.table[kind == kinds ? PE * ch + i % ch : i];
    const long long off = (long long)clip * p.clip + (long long)k * p.block;
    if (kind < kinds)
      row_ptr[i] = (const char*)p.ptr + off;
    else    // the previous block's pe, none at a clip's first block
      row_ptr[PE_PREV * ch + i % ch] =
          k > 0 ? (const char*)p.ptr + off - p.block : nullptr;
  }
  __syncthreads();
  auto z = [&](int kind, int c) {
    return reinterpret_cast<const float2*>(row_ptr[kind * ch + c]);
  };
  auto e = [&](int kind, int c) {
    return reinterpret_cast<const float*>(row_ptr[kind * ch + c]);
  };
  const bool fresh = a.fresh == nullptr || a.fresh[k];
  // c1 of channel c at bin j
  auto c1 = [&](int c, int j) {
    const float2 t = cmulc(z(PI, c)[j], z(PREV, c)[j]);
    const float2 u = cmul(fresh ? a.rotor[j] : make_float2(1.f, 0.f), t);
    const float* pp = e(PE_PREV, c);
    const float den = tmax(pp ? pp[j] : 0.f, e(PE, c)[j]) + NOISE_FLOOR;
    return make_float2(u.x / den, u.y / den);
  };
  const float2 zero = make_float2(0.f, 0.f);
  const long long o = (long long)r * B;
  for (int b = threadIdx.x; b < B; b += THREADS) {
    float best = e(PE, 0)[b];
    int m = 0;
    for (int c = 1; c < ch; ++c) {      // torch.argmax: first max, NaN max
      const float v = e(PE, c)[b];
      if (v > best || (v != v && best == best)) {
        best = v;
        m = c;
      }
    }
    const float2 p = z(PI, m)[b];
    float2 d1 = zero, d2 = zero, a1 = zero, a2 = zero;
    if (b > 0) d1 = cmulc(p, z(SD, m)[b]);
    if (b >= LV) d2 = cmulc(p, z(LD, m)[b]);
    if (b + 1 < B) {
      const float2 up = DRAWN ? z(US, m)[b] : z(SD, m)[b + 1];
      a1 = cmulc(c1(m, b + 1), cmulc(z(PI, m)[b + 1], up));
    }
    if (b + LV < B) {
      const float2 up = DRAWN ? z(UL, m)[b] : z(LD, m)[b + LV];
      a2 = cmulc(c1(m, b + LV), cmulc(z(PI, m)[b + LV], up));
    }
    a.a1[o + b] = a1;
    a.a2[o + b] = a2;
    a.d1[o + b] = d1;
    a.d2[o + b] = d2;
    a.mc[o + b] = m;
  }
}

template <bool DRAWN>
static int launch(const Args& a, int rows, cudaStream_t stream) {
  const size_t smem = sizeof(const char*) * SLOTS * a.ch;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        coefficients_kernel<DRAWN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  coefficients_kernel<DRAWN><<<rows, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// table: (5 + 2 * drawn) * ch planes (pi, prev, pe, sd, ld[, us, ul]) in
// device memory, kind-major, each (pointer, clip stride, block stride) in
// bytes with unit bin stride; rotor [B] complex64; fresh [nB] bytes or null;
// outputs [batch * nB, B] complex64 and int32.  Returns the cudaError_t of
// the launch.
extern "C" int sst_coefficients(const void* table, const void* rotor,
                                const void* fresh, void* a1, void* a2,
                                void* d1, void* d2, void* mc, int batch,
                                int nB, int B, int ch, int LV, int drawn,
                                void* stream) {
  if (ch < 1 || LV < 1) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || nB <= 0 || B <= 0) return 0;
  const long long rows = (long long)batch * nB;
  if (rows > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  Args a = {(const Plane*)table, (const float2*)rotor,
            (const unsigned char*)fresh, (float2*)a1, (float2*)a2,
            (float2*)d1, (float2*)d2, (int*)mc, ch, nB, B, LV};
  cudaStream_t s = (cudaStream_t)stream;
  return drawn ? launch<true>(a, (int)rows, s)
               : launch<false>(a, (int)rows, s);
}
