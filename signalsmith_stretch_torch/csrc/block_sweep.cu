// One block's bin sweep (kernel H): the streaming engine's main-prediction
// recursion over the B bins of one block (signalsmith-stretch.h:722-803).
//
// Replaces signalsmith_stretch_tpu/spectral.py:_sweep_scan, a lax.scan over
// bins on the TPU (not a Pallas kernel; PyTorch has no counterpart).
//
// For each bin b in order, with m = mc[b] the bin's loudest channel:
//   phase    = pu + [b > 0] out[m, b-1]*st + [b >= LV] out[m, b-LV]*lt
//   out_main = makeOutput(pe_max, pi_max, phase)
//   out[c]   = out_main (c == m), else makeOutput(pe[c], pi[c], out_main*ct[c])
// summed left to right, with the roundings of the compiled JAX scan on the
// CPU: each complex product x*y as re = fma(xr, yr, -(xi*yi)), im =
// fma(xi, yr, xr*yi), each squared magnitude r*r + i*i as fma(r, r, i*i)
// (__fmaf_rn), every other operation one IEEE float32 op (built with
// --fmad=false; IEEE division and square root).  The plain version is
// ops/block_sweep.block_sweep_plain.
//
// Bound on this card: the dependent chain, not bytes.  Bin b reads the
// output of bin b-1 in *its* loudest channel, which is a locked output
// when the lead changes, so every channel of bin b-1 is on the chain: B
// steps of two complex products, a makeOutput, a complex product and a
// second makeOutput (an IEEE division and square root each) in sequence.
// The ~0.4 MB of inputs (two channels) would stream in ~0.1 us.
//
// Design: one warp for the stream.  Lane L owns channels L, L+32, ...; every
// lane computes the lead's output itself (the same operations on the same
// values: the same bits), so no shuffle is on the chain; each lane then
// locks its own channels and writes them to a shared-memory ring of the
// last LV+1 bins, from which the next bins read their lead's votes, and to
// the output.  One __syncwarp() a bin publishes the ring.  The inputs are
// staged a tile of bins at a time into shared memory, coalesced, by the
// whole warp (the tile's bins then read nothing from device memory).
#include <cuda_runtime.h>

#define NOISE_FLOOR 1e-15f

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// x * y as XLA's compiled scan rounds it
__device__ __forceinline__ float2 cmul(float2 x, float2 y) {
  return make_float2(__fmaf_rn(x.x, y.x, -(x.y * y.y)),
                     __fmaf_rn(x.y, y.x, x.x * y.y));
}

// makeOutput: the phase scaled to the energy, the input phase when weak
__device__ __forceinline__ float2 make_output(float pe, float2 f, float2 ph) {
  const float pn = __fmaf_rn(ph.x, ph.x, ph.y * ph.y);
  const float fn = __fmaf_rn(f.x, f.x, f.y * f.y);
  const bool weak = pn <= NOISE_FLOOR;
  const float2 p2 = weak ? f : ph;
  const float pn2 = weak ? fn + NOISE_FLOOR : pn;
  const float s = sqrtf(pe / pn2);
  return cmul(p2, make_float2(s, 0.f));
}

// the dynamic shared memory: the ring of outputs [LV+1][ch], then a tile
// of each input (per-bin planes [tile], per-channel planes [ch][tile])
struct Smem {
  float2 *ring, *st, *lt, *pu, *pim, *ct, *pi;
  float *pem, *pe;
  int* mc;
  __device__ Smem(char* base, int ch, int LV, int tile) {
    float2* f2 = reinterpret_cast<float2*>(base);
    ring = f2;  f2 += (LV + 1) * ch;
    st = f2;    f2 += tile;
    lt = f2;    f2 += tile;
    pu = f2;    f2 += tile;
    pim = f2;   f2 += tile;
    ct = f2;    f2 += ch * tile;
    pi = f2;    f2 += ch * tile;
    float* f = reinterpret_cast<float*>(f2);
    pem = f;    f += tile;
    pe = f;     f += ch * tile;
    mc = reinterpret_cast<int*>(f);
  }
};

template <bool TIMED>
__global__ void __launch_bounds__(32)
block_sweep_kernel(const float2* __restrict__ st, const float2* __restrict__ lt,
                   const float2* __restrict__ pu, const float* __restrict__ pem,
                   const float2* __restrict__ pim, const int* __restrict__ mc,
                   const float2* __restrict__ ct, const float* __restrict__ pe,
                   const float2* __restrict__ pi, float2* __restrict__ out,
                   int ch, int B, int LV, int tile, long long* stamps) {
  extern __shared__ __align__(16) char smem_raw[];
  Smem s(smem_raw, ch, LV, tile);
  const int lane = threadIdx.x;
  long long cycles[2] = {0, 0}, clk = 0;
  unsigned long long gt0 = 0;
  if (TIMED && lane == 0) {
    gt0 = global_ns();
    clk = clock64();
  }
  const int R = LV + 1;               // ring slots
  int w = 0, r1 = R - 1, rl = 1;      // slots of bins b, b-1 and b-LV
  for (int base = 0; base < B; base += tile) {
    const int n = min(tile, B - base);
    // ---- stage the tile's inputs (coalesced) ----
    for (int i = lane; i < n; i += 32) {
      s.st[i] = st[base + i];
      s.lt[i] = lt[base + i];
      s.pu[i] = pu[base + i];
      s.pim[i] = pim[base + i];
      s.pem[i] = pem[base + i];
      s.mc[i] = mc[base + i];
    }
    for (int c = 0; c < ch; ++c) {
      const long long row = (long long)c * B + base;
      for (int i = lane; i < n; i += 32) {
        s.ct[c * tile + i] = ct[row + i];
        s.pi[c * tile + i] = pi[row + i];
        s.pe[c * tile + i] = pe[row + i];
      }
    }
    __syncwarp();
    if (TIMED && lane == 0) {
      const long long t = clock64();
      cycles[0] += t - clk;
      clk = t;
    }
    // ---- the dependent chain over the tile's bins ----
    for (int i = 0; i < n; ++i) {
      const int b = base + i;
      const int m = s.mc[i];
      float2 v1 = make_float2(0.f, 0.f), v2 = make_float2(0.f, 0.f);
      if (b > 0) v1 = cmul(s.ring[r1 * ch + m], s.st[i]);
      if (b >= LV) v2 = cmul(s.ring[rl * ch + m], s.lt[i]);
      const float2 ph = make_float2((s.pu[i].x + v1.x) + v2.x,
                                    (s.pu[i].y + v1.y) + v2.y);
      const float2 lead = make_output(s.pem[i], s.pim[i], ph);
      for (int c = lane; c < ch; c += 32) {
        const float2 o =
            c == m ? lead
                   : make_output(s.pe[c * tile + i], s.pi[c * tile + i],
                                 cmul(lead, s.ct[c * tile + i]));
        s.ring[w * ch + c] = o;
        out[(long long)c * B + b] = o;
      }
      r1 = w;
      w = w + 1 == R ? 0 : w + 1;
      rl = rl + 1 == R ? 0 : rl + 1;
      __syncwarp();
    }
    if (TIMED && lane == 0) {
      const long long t = clock64();
      cycles[1] += t - clk;
      clk = t;
    }
  }
  if (TIMED && lane == 0) {
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    stamps[0] = cycles[0];
    stamps[1] = cycles[1];
    stamps[2] = (long long)gt0;
    stamps[3] = (long long)global_ns();
    stamps[4] = smid;
  }
}

template <bool TIMED>
static int launch(const float2* st, const float2* lt, const float2* pu,
                  const float* pem, const float2* pim, const int* mc,
                  const float2* ct, const float* pe, const float2* pi,
                  float2* out, int ch, int B, int LV, int tile, int smem,
                  long long* stamps, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        block_sweep_kernel<TIMED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  block_sweep_kernel<TIMED><<<1, 32, smem, (cudaStream_t)stream>>>(
      st, lt, pu, pem, pim, mc, ct, pe, pi, out, ch, B, LV, tile, stamps);
  return (int)cudaGetLastError();
}

// Inputs as ops/block_sweep.BlockSweepInputs orders them: st, lt, pu [B]
// complex64, pe_max [B] f32, pi_max [B] complex64, max_ch [B] int32, ct
// [ch, B] complex64, pe [ch, B] f32, pi [ch, B] complex64; out [ch, B]
// complex64; tile bins a stage and smem bytes (block_sweep.tile_bins).
extern "C" int sst_block_sweep(const float2* st, const float2* lt,
                               const float2* pu, const float* pem,
                               const float2* pim, const int* mc,
                               const float2* ct, const float* pe,
                               const float2* pi, float2* out, int ch, int B,
                               int LV, int tile, int smem, void* stream) {
  return launch<false>(st, lt, pu, pem, pim, mc, ct, pe, pi, out, ch, B, LV,
                       tile, smem, nullptr, stream);
}

// The same, timed: stamps [5] int64 get the cycles of the loads and of the
// chain, the start and end on the global timer (ns) and the SM.
extern "C" int sst_block_sweep_timed(const float2* st, const float2* lt,
                                     const float2* pu, const float* pem,
                                     const float2* pim, const int* mc,
                                     const float2* ct, const float* pe,
                                     const float2* pi, float2* out, int ch,
                                     int B, int LV, int tile, int smem,
                                     long long* stamps, void* stream) {
  return launch<true>(st, lt, pu, pem, pim, mc, ct, pe, pi, out, ch, B, LV,
                      tile, smem, stamps, stream);
}
