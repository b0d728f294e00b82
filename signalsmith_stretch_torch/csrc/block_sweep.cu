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
// ops/block_sweep.block_sweep_plain; tests/test_torch_block.py replays this
// kernel's schedule on the CPU (`schedule_model`).
//
// Bound on this card: the dependent chain of the lead channel, not bytes
// (~0.4 MB at two channels would stream in ~0.1 us).  Bin b's short vote
// down1 = out[mc[b], b-1] is the lead output of bin b-1 when the lead does
// not change (70-80% of a stream's bins) and a locked output, formed from
// it, when it does; the long vote downl = out[mc[b], b-LV] depends only on
// bin b-LV.  So the chain is one makeOutput a bin (an IEEE division and
// square root), and a second one only at a lead change.
//
// Design: one CTA of four warps.
// - Warp 0 runs the chain.  Lane 0 carries the lead output in a register
//   (no shared-memory round trip, no barrier between bins); at a lead
//   change it forms locked(mc[b], b-1) itself from inputs staged for it.
//   Lanes 1-31 run the same instructions on other data: in the makeOutput
//   of bin b they form the early lock locked(mc[b+2], b+2-LV) from the
//   lead of bin b+2-LV, which lane 0 receives by a shuffle one bin later
//   and uses one bin after that: downl comes off the chain (LV >= 4;
//   below that lane 0 forms downl in place).  Each lane keeps the leads
//   (shuffled from lane 0) in its own column of a shared-memory ring, so
//   no lane reads another's stores.  A warp issues in order, so the loop
//   body holds nothing the chain would wait behind: bins unrolled by 8,
//   tiles padded to TILE bins, each bin's record loaded one bin ahead, the
//   shuffles' results used a bin later, no per-bin branch but the lead
//   change's, and no zero operand (a zero energy takes sqrtf's slow path)
//   for lanes whose result is not used.
// - Warps 1-3 stage each tile of TILE bins into a ring of SLOTS stage
//   slots two tiles ahead of the chain (the chain's records, with the
//   gathered inputs of a possible lock, and the early locks' records),
//   release them with a named barrier (bar.arrive), wait for the chain's
//   leads of a tile (named barrier), form every channel's output of the
//   tile in parallel and store them coalesced.  The chain waits only for
//   staged inputs.
#include <cuda_runtime.h>

#define NOISE_FLOOR 1e-15f

constexpr int TILE = 32;              // bins a stage slot
constexpr int GROUP = 8;              // bins unrolled in the chain
constexpr int SLOTS = 3;              // the chain's tile, the next, one filling
constexpr int HELPERS = 3;            // helper warps
constexpr int THREADS = 32 * (1 + HELPERS);
constexpr int HTHREADS = 32 * HELPERS;
// named barriers: 0 is __syncthreads; a slot's inputs staged, a slot's
// leads written, and the helpers among themselves
constexpr int BAR_FULL = 1, BAR_LEADS = BAR_FULL + SLOTS,
              BAR_HELPERS = BAR_LEADS + SLOTS;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  __threadfence_block();
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
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

// One makeOutput's inputs, 64 bytes.  The chain's record of bin b (lane
// 0): tw = st (0 at b = 0), pu, f = pi_max, pe = pe_max, lt (0 below LV),
// and ctc, pic, pec = ct, pi, pe of (mc[b], b-1) at a lead change.  The
// early record of bin b (lanes 1-31): tw, f, pe = ct, pi, pe of (mc[k],
// k-LV) for k = b+2, pu = -0 (x + -0 is x, zeros' signs too), same =
// mc[k-LV] == mc[k]; below LV = 4, those of (mc[b], b-LV), which the chain
// locks in place.  flag in both: bit 0 the lead changes at b, bit 1 (LV <
// 4) mc[b-LV] != mc[b].  Fields no lane uses hold ones, not zeros.
struct __align__(16) Rec {
  float2 tw, pu, f, lt, ctc, pic;
  float pe, pec;
  int flag, same;
};
static_assert(sizeof(Rec) == 64, "Rec is four 16-byte words");

struct Slot {
  Rec* rec;
  Rec* erec;
  float2* lead;
  int* mc;
};

// dynamic shared memory: SLOTS x (rec [TILE], a record's pad (so that
// rec[i] and erec[i] fall in other banks), erec [TILE], lead [TILE], mc
// [TILE]), then the leads' ring [H][32] (ops/block_sweep.tile_bins)
constexpr int SLOT_BYTES =
    TILE * (2 * sizeof(Rec) + sizeof(float2) + sizeof(int)) + sizeof(Rec);

__device__ __forceinline__ Slot slot_at(char* base, int s) {
  char* p = base + s * SLOT_BYTES;
  Slot S;
  S.rec = reinterpret_cast<Rec*>(p);
  S.erec = S.rec + TILE + 1;
  S.lead = reinterpret_cast<float2*>(S.erec + TILE);
  S.mc = reinterpret_cast<int*>(S.lead + TILE);
  return S;
}

__device__ __forceinline__ Rec load_rec(const Rec* r) {
  Rec v;
  const float4* s = reinterpret_cast<const float4*>(r);
  float4* d = reinterpret_cast<float4*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) d[k] = s[k];
  return v;
}

struct Planes {
  const float2 *st, *lt, *pu, *pim, *ct, *pi;
  const float *pem, *pe;
  const int* mc;
  float2* out;
  int ch, B, LV;
};

// Stage tile t into its slot: helper thread h < TILE the chain's record
// of bin h, TILE <= h < 2 TILE the early record of bin h - TILE; bins past
// B (the last tile's padding) get records that make no zero operand.
__device__ void stage(const Planes& P, char* smem, int t, int h) {
  const Slot S = slot_at(smem, t % SLOTS);
  const int i = h < TILE ? h : h - TILE;
  if (h >= 2 * TILE) return;
  const int b = t * TILE + i, B = P.B, LV = P.LV;
  const bool early = LV >= 4, in = b < B;
  const int m = in ? P.mc[b] : 0;
  const bool chg1 = in && b > 0 && P.mc[b - 1] != m;
  const bool chgl = in && !early && b >= LV && P.mc[b - LV] != m;
  const float2 zero = make_float2(0.f, 0.f), one = make_float2(1.f, 0.f);
  Rec r;
  r.ctc = r.pic = one;
  r.pec = 1.f;
  r.flag = int(chg1) | int(chgl) << 1;
  r.same = 1;
  if (h < TILE) {
    r.tw = in && b > 0 ? P.st[b] : zero;
    r.pu = in ? P.pu[b] : one;
    r.f = in ? P.pim[b] : one;
    r.pe = in ? P.pem[b] : 1.f;
    r.lt = in && b >= LV ? P.lt[b] : zero;
    if (chg1) {
      const long long k = (long long)m * B + b - 1;
      r.ctc = P.ct[k];
      r.pic = P.pi[k];
      r.pec = P.pe[k];
    }
    S.rec[i] = r;
    S.mc[i] = m;
  } else {
    r.tw = r.f = one;
    r.pe = 1.f;
    r.lt = zero;
    r.pu = make_float2(-0.f, -0.f);
    long long k = -1;
    if (early) {
      const int kb = b + 2;
      if (kb < B && kb >= LV) {
        const int m2 = P.mc[kb];
        k = (long long)m2 * B + kb - LV;
        r.same = P.mc[kb - LV] == m2;
      }
    } else if (in && b >= LV) {
      k = (long long)m * B + b - LV;
    }
    if (k >= 0) {
      r.tw = P.ct[k];
      r.f = P.pi[k];
      r.pe = P.pe[k];
    }
    S.erec[i] = r;
  }
}

// Every channel's output of tile t, from the chain's leads, stored
// coalesced (helper thread h takes pairs h, h + HTHREADS, ... of the
// tile's channel-major [ch, n] outputs); the first pair's inputs are read
// before the leads are waited for.  Returns the cycles spent waiting
// (TIMED).
template <bool TIMED>
__device__ long long outputs(const Planes& P, char* smem, int t, int h) {
  const Slot S = slot_at(smem, t % SLOTS);
  const int base = t * TILE, n = min(TILE, P.B - base), total = P.ch * n;
  float pe = 0.f;
  float2 pi = make_float2(0.f, 0.f), ct = pi;
  long long at = 0;
  int p = h;
  if (p < total) {
    at = (long long)(p / n) * P.B + base + p % n;
    pe = P.pe[at];
    pi = P.pi[at];
    ct = P.ct[at];
  }
  const long long c0 = TIMED ? clock64() : 0;
  bar_sync(BAR_LEADS + t % SLOTS, THREADS);
  const long long waited = TIMED ? clock64() - c0 : 0;
  while (p < total) {
    const int q = p + HTHREADS;
    long long at2 = 0;
    float pe2 = 0.f;
    float2 pi2 = make_float2(0.f, 0.f), ct2 = pi2;
    if (q < total) {
      at2 = (long long)(q / n) * P.B + base + q % n;
      pe2 = P.pe[at2];
      pi2 = P.pi[at2];
      ct2 = P.ct[at2];
    }
    const int c = p / n, i = p % n;
    const float2 lead = S.lead[i];
    P.out[at] = c == S.mc[i] ? lead : make_output(pe, pi, cmul(lead, ct));
    p = q;
    at = at2;
    pe = pe2;
    pi = pi2;
    ct = ct2;
  }
  return waited;
}

// a 32-bit shuffle the compiler cannot prove uniform (so it stays out of
// the uniform registers, whose moves would wait for it in issue order)
__device__ __forceinline__ float shfl(float v, int src) {
  float r;
  asm volatile("shfl.sync.idx.b32 %0, %1, %2, 0x1f, 0xffffffff;"
               : "=f"(r) : "f"(v), "r"(src));
  return r;
}

__device__ __forceinline__ float2 shfl2(float2 v, int src) {
  return make_float2(shfl(v.x, src), shfl(v.y, src));
}

// The chain warp.  hist: the leads' ring [H][32], lane L's column at
// hist[k * 32 + L] holding the lead of bin k (H a power of two > LV).
template <bool TIMED, bool EARLY>
__device__ void chain(const Planes& P, char* smem, float2* hist, int H,
                      long long* cyc) {
  const int lane = threadIdx.x, LV = P.LV;
  const int NT = (P.B + TILE - 1) / TILE, mask = H - 1;
  // the ring slot read at bin b's end: the lead of b+3-LV (early: the
  // early lanes' next lead) or of b+1-LV (late: lane 0's next downl)
  const int off = EARLY ? 3 - LV : 1 - LV;
  const float2 zero = make_float2(0.f, 0.f);
  // o: lane 0 the lead of the previous bin, the other lanes their last
  // result; L: the lead the next early lock starts from (late: the lead of
  // b-LV); dl: lane 0's downl of this bin; dlv: the early lock just formed
  float2 o = zero, L = zero, dl = zero, dlv = zero;
  float2* col = hist + lane;
  for (int k = 0; k < H; ++k) col[k * 32] = zero;
  long long clk = TIMED ? clock64() : 0;
  bar_sync(BAR_FULL, THREADS);
  Rec r = load_rec(lane ? slot_at(smem, 0).erec : slot_at(smem, 0).rec);
  int b = 0;
  for (int t = 0; t < NT; ++t) {
    const Slot S = slot_at(smem, t % SLOTS);
    const Slot Sn = slot_at(smem, (t + 1) % SLOTS);
    if (t + 1 < NT) bar_sync(BAR_FULL + (t + 1) % SLOTS, THREADS);
    if (TIMED) {
      const long long c = clock64();
      cyc[0] += c - clk;
      clk = c;
    }
    const Rec* R = lane ? S.erec : S.rec;
    const Rec* Rn = lane ? Sn.erec : Sn.rec;
    for (int g = 0; g < TILE; g += GROUP) {
      const Rec* G = R + g;
      const Rec* Gn = g + GROUP < TILE ? G + GROUP : Rn;
#pragma unroll
      for (int j = 0; j < GROUP; ++j, ++b) {
        // down1: the lead of b-1, or at a lead change locked to it (the
        // one branch: what follows it shares the main makeOutput's basic
        // block, where the compiler hides it in the chain's latencies)
        float2 d1 = o;
        if (r.flag & 1) d1 = make_output(r.pec, r.pic, cmul(o, r.ctc));
        // used a bin later: the lead of b-1, lane 1's early lock (the
        // downl of bin b+1), the next bin's record
        const float2 lnew = shfl2(o, 0);
        const float2 x = EARLY ? shfl2(dlv, 1) : zero;
        const Rec rn = load_rec(j + 1 < GROUP ? G + j + 1 : Gn);
        if (lane) d1 = L;
        if (!EARLY) {       // downl: the lead of b-LV, or locked to it
          dl = LV == 1 ? o : L;
          if (r.flag & 2) {
            const Rec e = load_rec(S.erec + g + j);
            dl = make_output(e.pe, e.f, cmul(dl, e.tw));
          }
        }
        float2 v2 = cmul(dl, r.lt);
        if (lane) v2 = make_float2(-0.f, -0.f);
        const float2 v1 = cmul(d1, r.tw);
        o = make_output(r.pe, r.f, make_float2((r.pu.x + v1.x) + v2.x,
                                               (r.pu.y + v1.y) + v2.y));
        if (lane == 0) S.lead[g + j] = o;
        dlv = r.same ? L : o;
        col[((b - 1) & mask) * 32] = lnew;
        L = col[((b + off) & mask) * 32];
        if (EARLY) dl = x;
        r = rn;
      }
    }
    if (TIMED) {
      const long long c = clock64();
      cyc[1] += c - clk;
      clk = c;
    }
    bar_arrive(BAR_LEADS + t % SLOTS, THREADS);
  }
}

template <bool TIMED>
__global__ void __launch_bounds__(THREADS)
block_sweep_kernel(Planes P, int H, long long* stamps) {
  extern __shared__ __align__(16) char smem_raw[];
  float2* hist = reinterpret_cast<float2*>(smem_raw + SLOTS * SLOT_BYTES);
  __shared__ long long cyc[6];        // TIMED: the phases, then the ends
  __shared__ long long ends[2];
  unsigned long long gt0 = 0;
  if (TIMED && threadIdx.x == 0) gt0 = global_ns();
  const int NT = (P.B + TILE - 1) / TILE;
  if (threadIdx.x < 32) {
    long long c[2] = {0, 0};
    if (P.LV >= 4)
      chain<TIMED, true>(P, smem_raw, hist, H, c);
    else
      chain<TIMED, false>(P, smem_raw, hist, H, c);
    if (TIMED && threadIdx.x == 0) {
      cyc[0] = c[0];
      cyc[1] = c[1];
      ends[0] = clock64();
    }
  } else {
    const int h = threadIdx.x - 32;
    long long st = 0, out = 0, idle = 0, clk = TIMED ? clock64() : 0;
    auto lap = [&](long long& acc) {
      if (TIMED) {
        const long long c = clock64();
        acc += c - clk;
        clk = c;
      }
    };
    for (int t = 0; t < min(SLOTS, NT); ++t) {
      stage(P, smem_raw, t, h);
      bar_sync(BAR_HELPERS, HTHREADS);
      lap(st);
      bar_arrive(BAR_FULL + t, THREADS);
    }
    for (int t = 0; t < NT; ++t) {
      const long long w = outputs<TIMED>(P, smem_raw, t, h);
      bar_sync(BAR_HELPERS, HTHREADS);
      lap(out);
      idle += w;
      if (t + SLOTS < NT) {
        stage(P, smem_raw, t + SLOTS, h);
        bar_sync(BAR_HELPERS, HTHREADS);
        lap(st);
        bar_arrive(BAR_FULL + t % SLOTS, THREADS);
      }
    }
    if (TIMED && h == 0) {
      cyc[3] = st;
      cyc[4] = out - idle;
      cyc[5] = idle;
      ends[1] = clock64();
    }
  }
  if (TIMED) {
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned smid;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
      cyc[2] = ends[1] > ends[0] ? ends[1] - ends[0] : 0;
      for (int k = 0; k < 6; ++k) stamps[k] = cyc[k];
      stamps[6] = (long long)gt0;
      stamps[7] = (long long)global_ns();
      stamps[8] = smid;
    }
  }
}

template <bool TIMED>
static int launch(const float2* st, const float2* lt, const float2* pu,
                  const float* pem, const float2* pim, const int* mc,
                  const float2* ct, const float* pe, const float2* pi,
                  float2* out, int ch, int B, int LV, int tile, int smem,
                  long long* stamps, void* stream) {
  if (tile != TILE) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        block_sweep_kernel<TIMED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  int H = 2;
  while (H <= LV) H *= 2;
  if (smem != SLOTS * SLOT_BYTES + H * 32 * (int)sizeof(float2))
    return (int)cudaErrorInvalidValue;
  const Planes P{st, lt, pu, pim, ct, pi, pem, pe, mc, out, ch, B, LV};
  block_sweep_kernel<TIMED><<<1, THREADS, smem, (cudaStream_t)stream>>>(
      P, H, stamps);
  return (int)cudaGetLastError();
}

// Inputs as ops/block_sweep.BlockSweepInputs orders them: st, lt, pu [B]
// complex64, pe_max [B] f32, pi_max [B] complex64, max_ch [B] int32, ct
// [ch, B] complex64, pe [ch, B] f32, pi [ch, B] complex64; out [ch, B]
// complex64; the tile (TILE) and smem bytes (block_sweep.tile_bins).
extern "C" int sst_block_sweep(const float2* st, const float2* lt,
                               const float2* pu, const float* pem,
                               const float2* pim, const int* mc,
                               const float2* ct, const float* pe,
                               const float2* pi, float2* out, int ch, int B,
                               int LV, int tile, int smem, void* stream) {
  return launch<false>(st, lt, pu, pem, pim, mc, ct, pe, pi, out, ch, B, LV,
                       tile, smem, nullptr, stream);
}

// The same, timed: stamps [9] int64 get the clock64() cycles of the chain
// warp waiting for staged inputs, running its bins, and of the helpers'
// tail after its last bin (waiting on the consumers); the helpers'
// staging, output and lead-waiting cycles (block_sweep.PHASES); the start
// and end on the global timer (ns) and the SM.
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

// The dependency floor of the work on this card: one thread runs only the
// lead recursion, lead = makeOutput(pe, f, (pu + lead*st) + h*lt) with h
// the lead U bins earlier, over `bins` bins (a multiple of U), its inputs
// (U bins of the planes) in registers.  out [1] gets the last
// lead; stamps [4] the cycles, the start and end (ns) and the bins run.
// The U bins are spread over the block (bins (2j + 1) B / 2U): a block's
// first bins are often silent, and a zero energy takes sqrtf's slow path.
constexpr int U = 8;

__global__ void __launch_bounds__(1)
block_sweep_floor_kernel(const float2* __restrict__ st,
                         const float2* __restrict__ lt,
                         const float2* __restrict__ pu,
                         const float* __restrict__ pem,
                         const float2* __restrict__ pim, int B, int bins,
                         float2* out, long long* stamps) {
  float2 rst[U], rlt[U], rpu[U], rpim[U], h[U];
  float rpem[U];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const int k = B >= U ? (int)((2LL * j + 1) * B / (2 * U)) : j % B;
    rst[j] = st[k];
    rlt[j] = lt[k];
    rpu[j] = pu[k];
    rpim[j] = pim[k];
    rpem[j] = pem[k];
    h[j] = make_float2(0.f, 0.f);
  }
  float2 o = make_float2(0.f, 0.f);
  const unsigned long long g0 = global_ns();
  const long long c0 = clock64();
  for (int k = 0; k < bins; k += U) {
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const float2 v1 = cmul(o, rst[j]);
      const float2 v2 = cmul(h[j], rlt[j]);
      o = make_output(rpem[j], rpim[j],
                      make_float2((rpu[j].x + v1.x) + v2.x,
                                  (rpu[j].y + v1.y) + v2.y));
      h[j] = o;
    }
  }
  const long long c1 = clock64();
  const unsigned long long g1 = global_ns();
  out[0] = o;
  stamps[0] = c1 - c0;
  stamps[1] = (long long)g0;
  stamps[2] = (long long)g1;
  stamps[3] = bins;
}

extern "C" int sst_block_sweep_floor(const float2* st, const float2* lt,
                                     const float2* pu, const float* pem,
                                     const float2* pim, int B, int bins,
                                     float2* out, long long* stamps,
                                     void* stream) {
  if (bins % U) return (int)cudaErrorInvalidValue;
  block_sweep_floor_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      st, lt, pu, pem, pim, B, bins, out, stamps);
  return (int)cudaGetLastError();
}
