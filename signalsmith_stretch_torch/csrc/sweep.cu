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
// with values outside the grid read as zero.  Cell (k, b) runs on diagonal
// t = b + k*sigma for a schedule step sigma >= LV+1: out[k,b-1] lies on
// diagonal t-1, out[k,b-LV] on t-LV, out[k-1,b+1] on t+1-sigma and
// out[k-1,b+LV] on t+LV-sigma, all earlier, so a clip takes
// D = B + (nB-1)*sigma diagonals in sequence (sigma = LV+1 = 7 and
// D = 6434 at 48 kHz, 10 s, 1.0x).
//
// Bound on this card: the dependent chain, not bytes.  Each diagonal is one
// cell's arithmetic (four complex products, two makeOutputs with an IEEE
// division and square root each) and one __syncthreads(); the ~60 bytes a
// cell reads would stream in well under a millisecond.  Design: one CTA per
// clip; thread k walks row k left to right, one cell per diagonal, and then
// rows k+T, k+2T, ... when the clip has more rows than the CTA has threads
// (sigma is raised so that T*sigma >= B, and a thread's rows never overlap
// in time).  None of the inputs depend on the recursion, so none is loaded
// on the chain, and none is loaded uncoalesced:
// - `stage_kernel` first copies the inputs, on every SM, into a layout
//   skewed within each group of 32 rows: word w of cell (k, b) goes to
//   [k/32][b + (k%32)*sigma][w][k%32], so the 32 cells a warp needs on one
//   diagonal are 32 consecutive words (the row-major planes put them B-sigma
//   apart, one line each);
// - each thread copies the staged words of its next PREFETCH-1 cells into
//   its slots of a shared-memory ring with cp.async, so no register waits on
//   a load issued for a later diagonal (the diagonal loop is unrolled by
//   PREFETCH, so every slot index is a constant);
// - the last sigma diagonals' outputs of every row sit in a shared-memory
//   ring, so the two own-row reads and the two reads of the row above are
//   shared-memory loads, and the barrier publishes a diagonal to the row
//   below; outputs go to device memory in the same skewed layout
//   (coalesced), and `unstage_kernel` transposes them back to [ch, nB, B].
// When the ring does not fit in shared memory (very long clips), the same
// reads go to the skewed outputs, which hold the same values.  Clips of one
// or two channels keep their channel words in the prefetch slots too;
// others load them at the cell.  Built with --fmad=false so every product
// and sum rounds as in the plain version.
#include <cuda_runtime.h>

#define NOISE_FLOOR 1e-15f
#define MAX_THREADS 512   // wavefront.SWEEP_MAX_THREADS
#define PREFETCH 4        // diagonals of inputs in flight per thread

// asynchronous 4-byte copy device memory -> shared memory, and its groups
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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

// The skewed layout of one clip: G = ceil(nB/32) groups of 32 rows, E =
// B + 31*sigma diagonals a group, `words` 32-bit words a cell: a1, a2, d1,
// d2 (re, im), mc, pe per channel, pi per channel (re, im).
struct Skew {
  int G, E, sigma;
  // flat index of word w (of `words`) of cell (k, b)
  __device__ __forceinline__ int at(int k, int b, int w, int words) const {
    return (((k >> 5) * E + b + (k & 31) * sigma) * words + w) * 32 + (k & 31);
  }
};

// one of the planner's input planes, [batch, nB, B] with unit bin stride:
// a1, a2, d1, d2 (complex, as float pairs), mc (int32), pe per channel
// (f32), pi per channel (complex); its strides of clip and row in elements.
// The 5 + 2 ch planes travel as a table in device memory, so the kernel
// takes any channel count.
struct Plane {
  const float* p;
  long long clip, row;
};

// the plane of word w of a cell, and the float offset of the word within
// the plane's element (the real or imaginary half of a complex value)
__device__ __forceinline__ int plane_of(int w, int ch) {
  return w < 8 ? w >> 1 : w < 9 + ch ? w - 4 : 5 + ch + ((w - 9 - ch) >> 1);
}

// word w of cell (k, b) of clip `clip`, from its plane pl
__device__ __forceinline__ float input_word(const Plane& pl, int ch,
                                            long long clip, int k, int b,
                                            int w) {
  const long long j = clip * pl.clip + (long long)k * pl.row + b;
  if (w == 8)
    return __int_as_float(__ldg(reinterpret_cast<const int*>(pl.p) + j));
  if (w < 8 || w >= 9 + ch)
    return __ldg(pl.p + 2 * j + ((w < 8 ? w : w - 9 - ch) & 1));
  return __ldg(pl.p + j);
}

// stage[clip] = the inputs in the skewed layout, zero where no cell lies.
// Grid (ceil(E/32), G, batch), block (32, 8): a 32 x 32 tile of (row, e),
// read along bins and written along rows through shared memory.
__global__ void __launch_bounds__(256)
stage_kernel(const Plane* __restrict__ planes, float* __restrict__ stage,
             int nB, int B, int ch, Skew s) {
  __shared__ float tile[32][33];
  const int words = 9 + 3 * ch;
  const int e0 = blockIdx.x * 32, g = blockIdx.y, tx = threadIdx.x;
  const long long clip = blockIdx.z;
  float* st = stage + clip * s.G * s.E * words * 32;
  for (int w = 0; w < words; ++w) {
    const Plane pl = planes[plane_of(w, ch)];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int l = threadIdx.y + 8 * r, k = 32 * g + l;
      const int b = e0 + tx - l * s.sigma;
      tile[l][tx] = (k < nB && b >= 0 && b < B)
                        ? input_word(pl, ch, clip, k, b, w)
                        : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int e = e0 + threadIdx.y + 8 * r;
      if (e < s.E)
        st[((g * s.E + e) * words + w) * 32 + tx] =
            tile[tx][threadIdx.y + 8 * r];
    }
    __syncthreads();
  }
}

// out[clip] ([ch, nB, B]) from the skewed outputs ([G][E][ch][32] float2).
// Grid (ceil(E/32), G, batch * ch), block (32, 8).
__global__ void __launch_bounds__(256)
unstage_kernel(const float2* __restrict__ skewed, float2* __restrict__ out,
               int nB, int B, int ch, Skew s) {
  __shared__ float2 tile[32][33];
  const int e0 = blockIdx.x * 32, g = blockIdx.y, tx = threadIdx.x;
  const long long clip = blockIdx.z / ch;
  const int c = blockIdx.z % ch;
  const float2* sk = skewed + clip * s.G * s.E * ch * 32;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int e = e0 + threadIdx.y + 8 * r;
    if (e < s.E)
      tile[threadIdx.y + 8 * r][tx] = sk[((g * s.E + e) * ch + c) * 32 + tx];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int l = threadIdx.y + 8 * r, k = 32 * g + l, e = e0 + tx;
    const int b = e - l * s.sigma;
    if (k < nB && b >= 0 && b < B && e < s.E)
      out[((clip * ch + c) * nB + k) * (long long)B + b] = tile[tx][l];
  }
}

// one cell's inputs; channels prefetched when CH > 0 (CH = 0: any count,
// loaded at the cell)
template <int CH>
struct CellIn {
  float2 a1, a2, d1, d2;
  int m;
  float pe[CH ? CH : 1];
  float2 pi[CH ? CH : 1];
};

// this thread's cell on successive diagonals: row k, bin rel (live when
// 0 <= rel < B and k < nB), and its position (k/32)*E + rel + (k%32)*sigma
// in the skewed layout; after `period` diagonals it moves to row k+T
struct Walk {
  int k, rel, pos;
  __device__ __forceinline__ bool live(int nB, int B) const {
    return rel >= 0 && rel < B && k < nB;
  }
  __device__ __forceinline__ void next(int T, int period, const Skew& s) {
    ++pos;
    if (++rel == period) {
      rel = 0;
      k += T;
      pos = (k >> 5) * s.E + (k & 31) * s.sigma;
    }
  }
};

struct Grid {
  int nB, B, ch, LV, words, T;
  Skew s;
  const float* __restrict__ in;   // this clip's staged inputs
  float2* ring;      // [sigma][ch][nB] in shared memory, or null
  float* pref;       // [PREFETCH][T][pref_stride] in shared memory
  float2* out;       // this clip's skewed outputs
  // staged word w of cell (k, b), read at the cell
  __device__ __forceinline__ float word(int k, int b, int w) const {
    return __ldg(in + s.at(k, b, w, words));
  }
  __device__ __forceinline__ float2 pair(int k, int b, int w) const {
    return make_float2(word(k, b, w), word(k, b, w + 1));
  }
};

// staged words a thread copies ahead: all of a cell's for one or two
// channels, else the nine that do not depend on the channel count
template <int CH>
__host__ __device__ constexpr int prefetched_words() {
  return CH > 0 ? 9 + 3 * CH : 9;
}
// a thread's words in a prefetch slot, [slot][thread][stride]: an odd stride
// keeps the copies and the reads of a warp on 32 different banks, and every
// offset within a slot is a constant
template <int CH>
__host__ __device__ constexpr int pref_stride() {
  return prefetched_words<CH>() | 1;
}

// start copying this thread's words of its cell on walk w into prefetch
// slot `slot`
template <int CH>
__device__ __forceinline__ void issue_cell(int slot, const Walk& w,
                                           const Grid& g) {
  if (!w.live(g.nB, g.B)) return;
  const float* src = g.in + w.pos * g.words * 32 + (w.k & 31);
  float* dst = g.pref + (slot * g.T + threadIdx.x) * pref_stride<CH>();
#pragma unroll
  for (int i = 0; i < prefetched_words<CH>(); ++i)
    cp_async4(dst + i, src + i * 32);
}

template <int CH>
__device__ __forceinline__ CellIn<CH> read_cell(int slot, const Grid& g) {
  const float* p = g.pref + (slot * g.T + threadIdx.x) * pref_stride<CH>();
  const auto pair = [&](int i) { return make_float2(p[i], p[i + 1]); };
  CellIn<CH> c;
  c.a1 = pair(0);
  c.a2 = pair(2);
  c.d1 = pair(4);
  c.d2 = pair(6);
  c.m = __float_as_int(p[8]);
#pragma unroll
  for (int ch = 0; ch < CH; ++ch) {
    c.pe[ch] = p[9 + ch];
    c.pi[ch] = pair(9 + CH + 2 * ch);
  }
  return c;
}

template <typename V, int N>
__device__ __forceinline__ V pick(const V (&a)[N], int m) {
  V r = a[0];
#pragma unroll
  for (int j = 1; j < N; ++j)
    if (m == j) r = a[j];
  return r;
}

// ring slots of diagonals t (written), t-1, t-LV, t+1-sigma and t+LV-sigma
struct Slots {
  int s0, s1, sl, su1, sul;
  __device__ __forceinline__ void next(int sigma) {
    s0 = s0 + 1 == sigma ? 0 : s0 + 1;
    s1 = s1 + 1 == sigma ? 0 : s1 + 1;
    sl = sl + 1 == sigma ? 0 : sl + 1;
    su1 = su1 + 1 == sigma ? 0 : su1 + 1;
    sul = sul + 1 == sigma ? 0 : sul + 1;
  }
};

template <int CH, bool RING>
__device__ __forceinline__ void cell(const CellIn<CH>& c, const Walk& w,
                                     const Slots& s, const Grid& g) {
  const int k = w.k, b = w.rel, B = g.B, LV = g.LV, m = c.m;
  // the outputs this cell reads: own row at b-1 and b-LV, the row above at
  // b+1 and b+LV, zero outside the grid
  const bool has1 = b >= 1, hasl = b >= LV;
  const bool hasu1 = k >= 1 && b + 1 < B, hasul = k >= 1 && b + LV < B;
  float2 down1 = make_float2(0.f, 0.f), downl = down1, up1 = down1,
         upl = down1;
  if constexpr (RING) {
    const float2* r = g.ring + m * g.nB + k;
    const int sl = g.ch * g.nB;
    if (has1) down1 = r[s.s1 * sl];
    if (hasl) downl = r[s.sl * sl];
    if (hasu1) up1 = r[s.su1 * sl - 1];
    if (hasul) upl = r[s.sul * sl - 1];
  } else {
    if (has1) down1 = g.out[g.s.at(k, b - 1, m, g.ch)];
    if (hasl) downl = g.out[g.s.at(k, b - LV, m, g.ch)];
    if (hasu1) up1 = g.out[g.s.at(k - 1, b + 1, m, g.ch)];
    if (hasul) upl = g.out[g.s.at(k - 1, b + LV, m, g.ch)];
  }
  const float2 v1 = cmul(c.d1, down1);
  const float2 v2 = cmul(c.d2, downl);
  const float2 v3 = cmul(c.a1, up1);
  const float2 v4 = cmul(c.a2, upl);
  const float2 phase = make_float2(((v1.x + v2.x) + v3.x) + v4.x,
                                   ((v1.y + v2.y) + v3.y) + v4.y);
  float2 pim;
  float pem;
  if constexpr (CH > 0) {
    pim = pick(c.pi, m);
    pem = pick(c.pe, m);
  } else {
    pim = g.pair(k, b, 9 + g.ch + 2 * m);
    pem = g.word(k, b, 9 + m);
  }
  const float2 lead = make_output(pem, pim, phase);
  if constexpr (CH == 2) {     // the other channel, without divergence
    const float2 pic = pick(c.pi, 1 - m);
    const float pec = pick(c.pe, 1 - m);
    const float2 ct = make_float2(pic.x * pim.x + pic.y * pim.y,
                                  pic.y * pim.x - pic.x * pim.y);
    const float2 other = make_output(pec, pic, cmul(lead, ct));
    float2* o = g.out + w.pos * 64 + (k & 31);
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
      const float2 v = ch == m ? lead : other;
      o[ch * 32] = v;
      if constexpr (RING) g.ring[(s.s0 * 2 + ch) * g.nB + k] = v;
    }
    return;
  }
  const int nch = CH > 0 ? CH : g.ch;
#pragma unroll
  for (int ch = 0; ch < nch; ++ch) {
    float2 v = lead;
    if (ch != m) {
      float2 pic;
      float pec;
      if constexpr (CH > 0) {
        pic = c.pi[ch];
        pec = c.pe[ch];
      } else {
        pic = g.pair(k, b, 9 + g.ch + 2 * ch);
        pec = g.word(k, b, 9 + ch);
      }
      // pi_c * conj(pi_m)
      const float2 ct = make_float2(pic.x * pim.x + pic.y * pim.y,
                                    pic.y * pim.x - pic.x * pim.y);
      v = make_output(pec, pic, cmul(lead, ct));
    }
    g.out[(w.pos * g.ch + ch) * 32 + (k & 31)] = v;
    if constexpr (RING) g.ring[(s.s0 * g.ch + ch) * g.nB + k] = v;
  }
}

// stage [batch][G][E][words][32] f32 (stage_kernel), skewed outputs
// [batch][G][E][ch][32] complex; one CTA per clip.
template <int CH, bool RING>
__global__ void __launch_bounds__(MAX_THREADS)
sweep_kernel(const float* __restrict__ stage, float2* skewed, int nB, int B,
             int ch, int LV, Skew sk) {
  extern __shared__ float2 smem[];
  const int words = 9 + 3 * ch, sigma = sk.sigma, T = blockDim.x;
  const long long clip = blockIdx.x;
  const size_t ring = RING ? (size_t)sigma * ch * nB : 0;
  const Grid g{nB, B, ch, LV, words, T, sk,
               stage + clip * sk.G * sk.E * words * 32,
               RING ? smem : nullptr,
               reinterpret_cast<float*>(smem + ring),
               skewed + clip * sk.G * sk.E * ch * 32};
  // a thread moves to its next row after T*sigma diagonals; with one row
  // per thread it never does
  const int period = nB > T ? T * sigma : 0x7fffffff;
  const int D = B + (nB - 1) * sigma;
  const int tid = threadIdx.x;
  // row tid, bin -tid*sigma on diagonal 0
  Walk wl{tid, -tid * sigma,
          (tid >> 5) * sk.E + (tid & 31) * sigma - tid * sigma};
  Walk wc = wl;   // wl walks PREFETCH-1 diagonals ahead (the copies), wc at t
  Slots s{0, sigma - 1, sigma - LV, 1 % sigma, LV};
#pragma unroll
  for (int u = 0; u < PREFETCH - 1; ++u) {
    issue_cell<CH>(u, wl, g);
    cp_async_commit();
    wl.next(T, period, sk);
  }
  for (int t0 = 0; t0 < D; t0 += PREFETCH) {
#pragma unroll
    for (int u = 0; u < PREFETCH; ++u) {
      if (t0 + u >= D) break;                 // uniform across the CTA
      // the slot of diagonal t-1, read before the last barrier, takes t+P-1
      issue_cell<CH>((u + PREFETCH - 1) % PREFETCH, wl, g);
      cp_async_commit();
      wl.next(T, period, sk);
      cp_async_wait<PREFETCH - 1>();          // diagonal t's words are in
      if (wc.live(nB, B)) cell<CH, RING>(read_cell<CH>(u, g), wc, s, g);
      wc.next(T, period, sk);
      s.next(sigma);
      __syncthreads();
    }
  }
}

template <int CH>
static int launch(const Plane* in, void* out, float* stage, void* skewed,
                  int batch, int nB, int B, int ch, int LV, int threads,
                  Skew sk, cudaStream_t stream) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  const dim3 tiles((sk.E + 31) / 32, sk.G, batch), tb(32, 8);
  stage_kernel<<<tiles, tb, 0, stream>>>(in, stage, nB, B, ch, sk);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const size_t ring = (size_t)sk.sigma * ch * nB * sizeof(float2);
  const size_t pref =
      (size_t)PREFETCH * pref_stride<CH>() * threads * sizeof(float);
  const bool use_ring = ring + pref <= (size_t)optin;
  const size_t smem = (use_ring ? ring : 0) + pref;
  const auto kernel =
      use_ring ? sweep_kernel<CH, true> : sweep_kernel<CH, false>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<batch, threads, smem, stream>>>(stage, (float2*)skewed, nB, B, ch,
                                           LV, sk);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const dim3 otiles((sk.E + 31) / 32, sk.G, batch * ch);
  unstage_kernel<<<otiles, tb, 0, stream>>>((const float2*)skewed,
                                            (float2*)out, nB, B, ch, sk);
  return (int)cudaGetLastError();
}

// planes: a table in device memory of 5 + 2 ch entries (pointer, clip
// stride, row stride; three 64-bit words each, strides in elements), one a
// [batch, nB, B] plane with unit bin stride: a1, a2, d1, d2 (complex), mc
// (int32), pe per channel (f32), pi per channel (complex); out [batch, ch,
// nB, B] complex; scratch: stage
// [batch][G][E][9 + 3 ch][32] f32 and skewed [batch][G][E][ch][32] complex,
// G = ceil(nB/32), E = B + 31 sigma.  Three grids: the staging copy, the
// sweep (one CTA of `threads` per clip, schedule step `sigma`,
// wavefront.sweep_schedule) and the copy back.  Returns the cudaError_t of
// the launches (cudaErrorInvalidValue for a schedule the kernel cannot run
// or shapes past 32-bit indexing).
extern "C" int sst_sweep(const void* planes, void* out, void* stage,
                         void* skewed, int batch, int nB, int B, int ch,
                         int LV, int threads, int sigma, void* stream) {
  if (batch <= 0 || nB <= 0 || B <= 0) return 0;
  const Skew sk{(nB + 31) / 32, B + 31 * sigma, sigma};
  if (ch < 1 || LV < 1 || sigma < LV + 1 || threads < 32 ||
      threads > MAX_THREADS || threads % 32 ||
      (nB > threads && (long long)threads * sigma < B) ||
      (long long)batch * ch > 65535 ||    // the copy back's grid
      (long long)(ch > 4 ? ch : 4) * nB * B > 0x7fffffffLL ||
      (long long)sk.G * sk.E * (9 + 3 * ch) * 32 > 0x7fffffffLL ||
      (long long)B + (long long)(nB - 1) * sigma > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Plane* in = (const Plane*)planes;
  cudaStream_t s = (cudaStream_t)stream;
  float* st = (float*)stage;
  switch (ch) {
    case 1: return launch<1>(in, out, st, skewed, batch, nB, B, ch, LV,
                             threads, sk, s);
    case 2: return launch<2>(in, out, st, skewed, batch, nB, B, ch, LV,
                             threads, sk, s);
    default: return launch<0>(in, out, st, skewed, batch, nB, B, ch, LV,
                              threads, sk, s);
  }
}
