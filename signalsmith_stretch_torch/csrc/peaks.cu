// The peaks and output map (kernel G), writing the position sets of the
// mapped planner's interpolation (kernel A): per row of energy and its
// smoothed curve [R, B], the runs of bins where energy > smoothed (the
// peaks), each run's sums of b*energy[b] and energy[b], its average band and
// that band through the frequency map with its tonality limit, then for
// every bin the input bin and the gradient of the output map: the
// smoothstep between the two peaks around it, and the bottom, top and
// no-peak rules (signalsmith-stretch.h:859-917; plain version
// ops/peaks.peaks_positions_plain over spectral._peaks_and_map).  Outputs:
// pos [R, 3, B], the sets input_bin, input_bin - tf[blk] and
// input_bin - ltf[blk] (blk = row % nB: rows are block-major per clip),
// and freq_grad [R, B].  The frequency map's constants (limit, mult,
// above_off) are ctl[row % nC]: one set (nC = 1) or one per block (nC = nB,
// automation).
//
// Replaces signalsmith_stretch_tpu/spectral.py:260-319, _peaks_and_map (not
// a Pallas kernel: two jax.ops.segment_sum calls, a scatter histogram and
// gathers; on the TPU ops/interp.py:_peaks_and_map_batched runs the sums as
// an MXU matmul), and the vote positions the JAX planner subtracts from it
// (planner.py:598-601).  No single PyTorch call computes it.
//
// Order.  Each run's two sums add bin-ascending from 0.0f, ((0 + x_a) +
// x_{a+1}) + ..., in float32: the C++ `+=` order, and the order of the plain
// version's index_put_ on the CPU.  One thread sums a whole run, with no
// tree and no atomics, so the sums do not depend on the launch.  k[b], the
// number of peaks whose clamp(ceil(output), 0, B) is at most b, is a count
// (shared-memory integer atomics and an integer prefix), exact in any order.
// The other expressions keep the plain version's order, operation for
// operation, and the build's --fmad=false keeps every product and sum
// rounded on its own.  The plain version divides by N as a tensor by a
// Python scalar, which the card computes as a product with 1/N; so does
// the kernel, and for N a power of two (the wrapper requires it) that
// product is the division, correctly rounded, as on the CPU.  Inputs are
// finite: the plain version casts ceil(peak_out) to an integer, which has
// no value for a NaN.
//
// Bound on this card: bytes, 24 per bin (two inputs read, four output
// planes written once), 0.079 ms at [2680, 4096].  Design: a persistent
// grid (as many CTAs of 512 threads as fit, two an SM at B = 4096) walks
// rows; while a row runs, the next row's energy and smoothed curve arrive
// in the other half of a double buffer in shared memory by cp.async, so the
// loads leave the critical path and no wave has a tail.  Four barriers a
// row:
//   wait   the row's copies land (and the next row's are issued);
//   flags  a warp takes 256 bins (a segment): one __ballot_sync a 32-bin
//          word of above-flags, a bitmask; run starts are
//          above & ~(above << 1 | carry), and each segment's count of them
//          goes to shared memory;
//   runs   a thread owns 8 bins; a warp prefix of its lanes' start counts
//          over the segments' base gives each run its id; the thread walks
//          the bitmask to each run's end and sums the run bin-ascending,
//          maps its peak and counts clamp(ceil(output), 0, B) in a
//          histogram with a shared-memory integer atomic;
//   prefix a warp turns a segment of the histogram into its inclusive
//          prefix (8 bins a lane, 16-byte accesses), its total to shared
//          memory; the map's constants of each pair of neighbouring peaks
//          (one division a pair, not a bin) go where the row's energy was;
//   map    a lane takes 4 neighbouring bins (16-byte loads and stores where
//          B % 4 == 0 and the tensors are aligned), k[b] = the prefix plus
//          the earlier segments' totals (zeroing the histogram as it reads
//          it, for the next row), and writes the four planes.
//
// A custom frequency map (a Python callable) cannot run inside the kernel,
// so it splits G around the callable into two entries (plain versions
// ops/peaks.peak_runs_plain and output_positions_plain), each a persistent
// grid of its own with a shared-memory layout sized for its own work (no
// histogram in the runs entry, no energy in the out entry), bound by bytes
// (runs: 0.039 ms, out: 0.056 ms at [2680, 4096]; chip_smoke.split_bounds
// counts them).  Each runs at two CTAs an SM at B = 4096, held there by
// its registers: at three, with registers capped to 40, each entry ran
// slower on an H100.
//   runs (sst_peaks_runs)   energy and smoothed double-buffered as above,
//          rows walked as above, two barriers a row: wait, then flags;
//          once flags have given the row's n_peaks, every thread stores
//          zeros to the slots from n_peaks to nseg = B / 2 + 2 of peak_in
//          and avg_freq [R, nseg] (8-byte stores where the row allows)
//          while the runs phase sums each run and its thread writes the
//          run's own slot, avg and (avg + 0.5) / N, straight to global
//          memory; n_peaks [R] int32 once a row.  A slot below n_peaks is
//          written by its run alone, one from n_peaks on by the fill alone.
//   out (sst_peaks_out)     the CTAs claim their rows from a queue a row
//          ahead (claim_row), so a CTA whose rows cost less takes more of
//          them.  Per row, the n_peaks[r] valid slots of peak_in and
//          mapped [R, nseg] (the callable's output; later slots are never
//          read, so NaN there is harmless) arrive by cp.async in one half
//          of a double buffer while the previous row runs, its count read
//          a row ahead (clamped to [0, (B + 1) / 2]).  Three barriers a
//          row, each after a phase: wait; peaks, peak_out = mapped * N -
//          0.5 in place and its histogram count (none for cell B, which no
//          k[b], b < B, counts), from shared memory only; prefix, the
//          pairs' three tables (the fourth, the previous peak's output
//          band, is peak_out itself); then map as above.
// The one-launch entry keeps serving the built-in maps.  The split calls
// G's row loads, flags and runs helpers as they are, and forks the two it
// needed otherwise (split_prefix_phase, split_map_phase: the same
// operation order).
#include <cuda_runtime.h>

#define PEAKS_THREADS 512
#define FULL 0xffffffffu

// the timed entries' phases (ops/peaks.PHASES, RUNS_PHASES, OUT_PHASES)
#define PEAKS_PHASES 5
#define RUNS_PHASES 3
#define OUT_PHASES 4

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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int warp_inclusive_scan(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// warp-collective, s the same in every lane: the sum of cnt[0..s) and, in
// *total, of cnt[0..n)
__device__ __forceinline__ int segment_base(const int* cnt, int n, int s,
                                            int lane, int* total) {
  int run = 0, base = 0;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int v = i0 + lane < n ? cnt[i0 + lane] : 0;
    const int incl = warp_inclusive_scan(v, lane);
    const int ex = __shfl_sync(FULL, incl - v, (s - i0) & 31);
    if (s >= i0 && s < i0 + 32) base = run + ex;
    run += __shfl_sync(FULL, incl, 31);
  }
  *total = run;
  return base;
}

// shared memory, in 4-byte words, each part a multiple of four: the double
// buffer (energy and smoothed, twice), the histogram (its segments and the
// clamped bin B), the peak tables (two of (B + 1) / 2), the above-words and
// a zero word past them, the segments' start counts and histogram totals
struct Layout {
  int Bp, HW, PR, AW, NS, W;
  __host__ __device__ Layout(int B) {
    Bp = (B + 3) & ~3;
    NS = (B + 255) >> 8;
    W = (B + 31) >> 5;
    HW = NS * 256 + 4;
    PR = (((B + 1) / 2) + 3) & ~3;
    AW = (W + 1 + 3) & ~3;
  }
  __host__ __device__ int words() const {
    return 4 * Bp + HW + 2 * PR + AW + 2 * ((NS + 3) & ~3);
  }
};

template <int VEC>
__device__ __forceinline__ void load_row(float* E, float* S, const float* e,
                                         const float* s, int B, int tid) {
  if (VEC == 4) {
    for (int i = tid; i < B / 4; i += PEAKS_THREADS) {
      cp_async16(E + 4 * i, e + 4 * i);
      cp_async16(S + 4 * i, s + 4 * i);
    }
  } else {
    for (int i = tid; i < B; i += PEAKS_THREADS) {
      cp_async4(E + i, e + i);
      cp_async4(S + i, s + i);
    }
  }
  cp_async_commit();
}

// the per-row constants of the map
struct RowPeaks {
  const float* prev_o;       // the pairs' tables (index k - 1)
  const float* range_scale;
  const float* out_offset;
  const float* out_scale;
  int n, top_start;
  float first_in, first_out, last_in, last_out;
};

// one bin of the map: the plain version's selects and operation order (the
// pair's constants are the plain version's per-bin expressions, computed
// once for the pair from the same operands)
__device__ __forceinline__ void map_bin(const RowPeaks& p, int b, int kb,
                                        float* ib_out, float* grad_out) {
  const float fb = (float)b;
  float ib, grad = 1.f;
  if (p.n == 0) {
    ib = fb;
  } else if (b >= p.top_start) {            // the top rule runs last in C++
    ib = fb + (p.last_in - p.last_out);
  } else if (kb == 0) {                     // below the first peak
    ib = fb + (p.first_in - p.first_out);
  } else {
    const float prev_o = p.prev_o[kb - 1];
    const float range_scale = p.range_scale[kb - 1];
    const float out_offset = p.out_offset[kb - 1];
    const float out_scale = p.out_scale[kb - 1];
    const float grad_scale = out_scale * range_scale;
    const float r = (fb - prev_o) * range_scale;
    const float h = (r * r) * (3.f - 2.f * r);
    ib = (fb + out_offset) + h * out_scale;
    grad = 1.f + ((6.f * r) * (1.f - r)) * grad_scale;
  }
  *ib_out = ib;
  *grad_out = grad;
}

// TIMED: thread 0 adds the clock64() cycles of phase i - 1 (from the
// previous stamp to the barrier that ends it) to its CTA's count; at the
// end (end_stamps) it writes the counts, the CTA's start and end on the
// global timer (ns) and its SM to stamps[blockIdx.x * (P + 3) ...], P the
// kernel's number of phases
#define STAMP(i)                                 \
  if (TIMED && tid == 0) {                       \
    const long long c = clock64();               \
    cycles[(i) - 1] += c - clk;                  \
    clk = c;                                     \
  }

__device__ __forceinline__ void end_stamps(long long* stamps,
                                           const long long* cycles, int P,
                                           unsigned long long gt0) {
  unsigned smid;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
  long long* st = stamps + (long long)blockIdx.x * (P + 3);
  for (int i = 0; i < P; ++i) st[i] = cycles[i];
  st[P] = (long long)gt0;
  st[P + 1] = (long long)global_ns();
  st[P + 2] = smid;
}

// the shared-memory tables of a row (Layout): the histogram, the peak
// tables, the above-words and the segments' counts and totals
struct Tables {
  int* H;
  float* peak_in;
  float* peak_out;
  unsigned* above;
  int* seg_starts;
  int* seg_total;
  __device__ Tables(float* smem, const Layout& L) {
    H = reinterpret_cast<int*>(smem + 4 * L.Bp);
    peak_in = reinterpret_cast<float*>(H + L.HW);
    peak_out = peak_in + L.PR;
    above = reinterpret_cast<unsigned*>(peak_out + L.PR);
    seg_starts = reinterpret_cast<int*>(above + L.AW);
    seg_total = seg_starts + ((L.NS + 3) & ~3);
  }
  // the runs entry's: only the above-words and the start counts
  __device__ Tables(unsigned* above_, int* seg_starts_)
      : H(nullptr), peak_in(nullptr), peak_out(nullptr), above(above_),
        seg_starts(seg_starts_), seg_total(nullptr) {}
};

// --- flags: the above-words and each segment's run starts -----------------
__device__ __forceinline__ void flags_phase(const float* E, const float* S,
                                            const Tables& t, int B, int NS,
                                            int W, int tid, int lane,
                                            int warp) {
  const int NW = PEAKS_THREADS >> 5;
  if (tid == 0) t.above[W] = 0u;          // a run ends before word W
  for (int s = warp; s < NS; s += NW) {
    const int b0 = s << 8;
    bool hi[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int b = b0 + (j << 5) + lane;
      hi[j] = b < B && E[b] > S[b];
    }
    unsigned carry = b0 > 0 && E[b0 - 1] > S[b0 - 1];
    int count = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int w = (s << 3) + j;
      if (w >= W) break;                  // the same in every lane
      const unsigned a = __ballot_sync(FULL, hi[j]);
      if (lane == 0) t.above[w] = a;
      count += __popc(a & ~((a << 1) | carry));
      carry = a >> 31;
    }
    if (lane == 0) t.seg_starts[s] = count;
  }
}

// --- runs: each run's id, its sums and its average band --------------------
// thread t owns the 8 bins of chunk c = c0 + t; chunk c lies in segment
// c / 32, which is one warp's.  peak(id, avg) is called once a run, by the
// thread that summed it.  Returns the row's number of peaks (in every
// thread).
template <class Peak>
__device__ __forceinline__ int runs_phase(const float* E, const Tables& t,
                                          int B, int NS, int tid, int lane,
                                          int warp, Peak peak) {
  int n_peaks;
  segment_base(t.seg_starts, NS, 0, lane, &n_peaks);
  for (int c0 = 0; c0 < NS * 32; c0 += PEAKS_THREADS) {
    const int s = (c0 >> 5) + warp;
    if (s >= NS) break;                    // the same in every lane
    int unused;
    const int base = segment_base(t.seg_starts, NS, s, lane, &unused);
    const int c = c0 + tid, b0 = c << 3;
    unsigned st = 0;
    if (b0 < B) {
      const unsigned a8 = (t.above[c >> 2] >> ((c & 3) << 3)) & 0xffu;
      const unsigned prev =
          b0 > 0 ? (t.above[(b0 - 1) >> 5] >> ((b0 - 1) & 31)) & 1u : 0u;
      st = a8 & ~((a8 << 1) | prev) & 0xffu;
    }
    const int cnt = __popc(st);
    int id = base + warp_inclusive_scan(cnt, lane) - cnt;
    while (st) {
      const int a = b0 + __ffs(st) - 1;
      st &= st - 1;
      int w = a >> 5;                       // the run's last bin z: the
      unsigned m = ~t.above[w] & (FULL << (a & 31));   // first 0 after a
      while (!m) m = ~t.above[++w];
      const int z = (w << 5) + __ffs(m) - 2;
      float band_sum = 0.f, energy_sum = 0.f;
#pragma unroll 4
      for (int b = a; b <= z; ++b) {
        const float x = E[b];
        band_sum = band_sum + (float)b * x;
        energy_sum = energy_sum + x;
      }
      peak(id, band_sum / (energy_sum == 0.f ? 1.f : energy_sum));
      ++id;
    }
  }
  return n_peaks;
}

// a peak of the output map: its input band, its output band from the
// mapped frequency, and its count in the histogram of clamp(ceil(output),
// 0, B)
__device__ __forceinline__ void count_peak(const Tables& t, int id, float avg,
                                           float mapped, float N, int B) {
  const float out = mapped * N - 0.5f;
  t.peak_in[id] = avg;
  t.peak_out[id] = out;
  atomicAdd(&t.H[(int)fminf(fmaxf(ceilf(out), 0.f), (float)B)], 1);
}

// --- prefix: each segment's inclusive prefix and its total; the map's
// constants of each pair of neighbouring peaks ------------------------------
// pair k (k = 1..n, the bins with k peaks at or below them) between peaks
// k - 1 and k (past the last: input 0, output +inf), in `pairs` (four
// tables of (B + 1) / 2), which the caller has done reading
__device__ __forceinline__ void prefix_phase(const Tables& t, float* pairs,
                                             int n_peaks, int B, int NS,
                                             int tid, int lane, int warp) {
  const int NW = PEAKS_THREADS >> 5;
  const int nseg = B / 2 + 2, M = (B + 1) / 2;
  for (int k = tid + 1; k <= n_peaks; k += PEAKS_THREADS) {
    const float inf = __int_as_float(0x7f800000);
    const int pi = min(max(k - 1, 0), nseg - 1);
    const int ni = min(max(k, 0), nseg - 1);
    const float prev_o = pi < n_peaks ? t.peak_out[pi] : inf;
    const float prev_in = pi < n_peaks ? t.peak_in[pi] : 0.f;
    const float next_o = ni < n_peaks ? t.peak_out[ni] : inf;
    const float next_in = ni < n_peaks ? t.peak_in[ni] : 0.f;
    pairs[k - 1] = prev_o;
    pairs[M + k - 1] = 1.f / (next_o - prev_o);          // range_scale
    pairs[2 * M + k - 1] = prev_in - prev_o;
    pairs[3 * M + k - 1] = ((next_in - next_o) - prev_in) + prev_o;
  }
  for (int s = warp; s < NS; s += NW) {
    int4* h = reinterpret_cast<int4*>(t.H + (s << 8) + (lane << 3));
    int4 u = h[0], v = h[1];
    u.y += u.x; u.z += u.y; u.w += u.z;
    v.x += u.w; v.y += v.x; v.z += v.y; v.w += v.z;
    const int incl = warp_inclusive_scan(v.w, lane);
    const int ex = incl - v.w;
    u.x += ex; u.y += ex; u.z += ex; u.w += ex;
    v.x += ex; v.y += ex; v.z += ex; v.w += ex;
    h[0] = u;
    h[1] = v;
    if (lane == 31) t.seg_total[s] = incl;
  }
}

// --- map: four planes, lanes on neighbouring bins --------------------------
template <int VEC>
__device__ __forceinline__ void map_phase(const Tables& t, const float* pairs,
                                          int n_peaks, int B, int NS,
                                          float tf_r, float ltf_r,
                                          float* out0, float* grad_row,
                                          int tid, int lane, int warp) {
  const int M = (B + 1) / 2;
  RowPeaks p;
  p.prev_o = pairs;
  p.range_scale = pairs + M;
  p.out_offset = pairs + 2 * M;
  p.out_scale = pairs + 3 * M;
  p.n = n_peaks;
  const int top = max(n_peaks - 1, 0);
  p.first_in = n_peaks > 0 ? t.peak_in[0] : 0.f;
  p.first_out = n_peaks > 0 ? t.peak_out[0] : __int_as_float(0x7f800000);
  p.last_in = n_peaks > 0 ? t.peak_in[top] : 0.f;
  p.last_out = n_peaks > 0 ? t.peak_out[top] : 0.f;
  p.top_start = max((int)p.last_out, 0);   // truncation, as .to(int32)
  float* out1 = out0 + B;
  float* out2 = out1 + B;
  int* H = t.H;
  const int nq = (B + VEC - 1) / VEC;
  for (int q0 = 0; q0 < nq; q0 += PEAKS_THREADS) {
    // a warp's bins lie in one segment (32 * VEC divides 256)
    const int s = ((q0 + (warp << 5)) * VEC) >> 8;
    if (s >= NS) break;                     // the same in every lane
    int unused;
    const int kbase = segment_base(t.seg_total, NS, s, lane, &unused);
    const int q = q0 + tid;
    if (q >= nq) continue;
    if (VEC == 4) {
      const int4 k4 = reinterpret_cast<const int4*>(H)[q];
      reinterpret_cast<int4*>(H)[q] = make_int4(0, 0, 0, 0);
      float4 ib, g;
      const int b = q << 2;
      map_bin(p, b, k4.x + kbase, &ib.x, &g.x);
      map_bin(p, b + 1, k4.y + kbase, &ib.y, &g.y);
      map_bin(p, b + 2, k4.z + kbase, &ib.z, &g.z);
      map_bin(p, b + 3, k4.w + kbase, &ib.w, &g.w);
      reinterpret_cast<float4*>(out0)[q] = ib;
      reinterpret_cast<float4*>(out1)[q] =
          make_float4(ib.x - tf_r, ib.y - tf_r, ib.z - tf_r, ib.w - tf_r);
      reinterpret_cast<float4*>(out2)[q] = make_float4(
          ib.x - ltf_r, ib.y - ltf_r, ib.z - ltf_r, ib.w - ltf_r);
      reinterpret_cast<float4*>(grad_row)[q] = g;
    } else {
      float ib, g;
      const int kq = H[q];
      H[q] = 0;
      map_bin(p, q, kq + kbase, &ib, &g);
      out0[q] = ib;
      out1[q] = ib - tf_r;
      out2[q] = ib - ltf_r;
      grad_row[q] = g;
    }
  }
}

// the one-launch G: the built-in map, its constants ctl[row % nC]
template <int VEC, bool TIMED>
__global__ void __launch_bounds__(PEAKS_THREADS, 2)
peaks_map_kernel(const float* __restrict__ energy,
                 const float* __restrict__ smoothed,
                 const float* __restrict__ tf, const float* __restrict__ ltf,
                 float* __restrict__ pos, float* __restrict__ freq_grad,
                 int R, int B, int nB, float N, float inv_N,
                 const float* __restrict__ ctl, int nC, long long* stamps) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(B);
  const Tables t(smem, L);
  const int NS = L.NS, W = L.W;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned long long gt0 = 0;
  long long clk = 0, cycles[PEAKS_PHASES] = {};
  if (TIMED && tid == 0) {
    gt0 = global_ns();
    clk = clock64();
  }

  for (int i = tid; i < B; i += PEAKS_THREADS) t.H[i] = 0;
  int row = blockIdx.x;
  if (row < R)
    load_row<VEC>(smem, smem + L.Bp, energy + (long long)row * B,
                  smoothed + (long long)row * B, B, tid);
  for (int it = 0; row < R; ++it, row += gridDim.x) {
    float* E = smem + (it & 1) * 2 * L.Bp;
    float* S = E + L.Bp;
    const int blk = row % nB;
    const float tf_r = tf[blk], ltf_r = ltf[blk];
    const float* ctl_r = ctl + 3 * (row % nC);
    const float limit = ctl_r[0], mult = ctl_r[1], above_off = ctl_r[2];
    cp_async_wait_all();
    __syncthreads();
    STAMP(1)
    // every thread is past the previous row: its buffer, the histogram,
    // the tables and the counts are free
    const int next = row + gridDim.x;
    if (next < R) {
      float* nE = smem + ((it + 1) & 1) * 2 * L.Bp;
      load_row<VEC>(nE, nE + L.Bp, energy + (long long)next * B,
                    smoothed + (long long)next * B, B, tid);
    }

    // (the map zeroed the histogram's bins below B as it read them)
    for (int i = B + tid; i < L.HW; i += PEAKS_THREADS) t.H[i] = 0;
    flags_phase(E, S, t, B, NS, W, tid, lane, warp);
    __syncthreads();
    STAMP(2)

    const int n_peaks = runs_phase(
        E, t, B, NS, tid, lane, warp, [&](int id, float avg) {
          const float freq = (avg + 0.5f) * inv_N;   // N a power of two
          const float mapped =
              freq > limit ? freq + above_off : freq * mult;
          count_peak(t, id, avg, mapped, N, B);
        });
    __syncthreads();
    STAMP(3)

    // the pairs' tables go where the row's energy and smoothed curve were
    prefix_phase(t, E, n_peaks, B, NS, tid, lane, warp);
    __syncthreads();
    STAMP(4)

    map_phase<VEC>(t, E, n_peaks, B, NS, tf_r, ltf_r,
                   pos + (long long)row * 3 * B,
                   freq_grad + (long long)row * B, tid, lane, warp);
    if (TIMED) __syncthreads();
    STAMP(5)
  }
  if (TIMED && tid == 0) end_stamps(stamps, cycles, PEAKS_PHASES, gt0);
}

// --- G split around a custom map ------------------------------------------
// the runs entry's shared memory, in 4-byte words: the double buffer, the
// above-words with the zero word past them, the segments' start counts
struct RunsLayout {
  int Bp, AW, NS, W;
  __host__ __device__ RunsLayout(int B) {
    Bp = (B + 3) & ~3;
    NS = (B + 255) >> 8;
    W = (B + 31) >> 5;
    AW = (W + 1 + 3) & ~3;
  }
  __host__ __device__ int words() const {
    return 4 * Bp + AW + ((NS + 3) & ~3);
  }
};

// slots [n0, n1) of two rows a and b set to 0: 8-byte stores where both
// rows lie alike against 8 bytes, one 4-byte store before and after
__device__ __forceinline__ void zero_slots(float* a, float* b, int n0, int n1,
                                           int tid) {
  int i = n0;
  if (((reinterpret_cast<size_t>(a) ^ reinterpret_cast<size_t>(b)) & 7) ==
      0) {
    if ((reinterpret_cast<size_t>(a + i) & 4) && i < n1) {
      if (tid == 0) a[i] = b[i] = 0.f;
      ++i;
    }
    const int pairs = (n1 - i) >> 1;
    float2* a2 = reinterpret_cast<float2*>(a + i);
    float2* b2 = reinterpret_cast<float2*>(b + i);
    for (int j = tid; j < pairs; j += PEAKS_THREADS) {
      a2[j] = make_float2(0.f, 0.f);
      b2[j] = make_float2(0.f, 0.f);
    }
    i += 2 * pairs;
  }
  for (int j = i + tid; j < n1; j += PEAKS_THREADS) a[j] = b[j] = 0.f;
}

// the runs entry: peak_in and avg_freq [R, nseg] (slots from n_peaks on 0)
// and n_peaks [R]
template <int VEC, bool TIMED>
__global__ void __launch_bounds__(PEAKS_THREADS, 2)
peaks_runs_kernel(const float* __restrict__ energy,
                  const float* __restrict__ smoothed,
                  float* __restrict__ peak_in_out,
                  float* __restrict__ avg_freq_out,
                  int* __restrict__ n_peaks_out, int R, int B, float inv_N,
                  long long* stamps) {
  extern __shared__ __align__(16) float smem[];
  const RunsLayout L(B);
  unsigned* above = reinterpret_cast<unsigned*>(smem + 4 * L.Bp);
  const Tables t(above, reinterpret_cast<int*>(above + L.AW));
  const int NS = L.NS, W = L.W, nseg = B / 2 + 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned long long gt0 = 0;
  long long clk = 0, cycles[RUNS_PHASES] = {};
  if (TIMED && tid == 0) {
    gt0 = global_ns();
    clk = clock64();
  }

  int row = blockIdx.x;                     // < R: the grid is at most R
  load_row<VEC>(smem, smem + L.Bp, energy + (long long)row * B,
                smoothed + (long long)row * B, B, tid);
  for (int it = 0; row < R; ++it, row += gridDim.x) {
    float* E = smem + (it & 1) * 2 * L.Bp;
    float* S = E + L.Bp;
    cp_async_wait_all();
    // every thread is past the previous row's runs: its buffer, the
    // above-words and the counts are free
    __syncthreads();
    STAMP(1)
    const int next = row + gridDim.x;
    if (next < R) {
      float* nE = smem + ((it + 1) & 1) * 2 * L.Bp;
      load_row<VEC>(nE, nE + L.Bp, energy + (long long)next * B,
                    smoothed + (long long)next * B, B, tid);
    }

    flags_phase(E, S, t, B, NS, W, tid, lane, warp);
    __syncthreads();
    STAMP(2)

    // the row's count, then its empty slots while the runs fill the others
    float* pin = peak_in_out + (long long)row * nseg;
    float* fq = avg_freq_out + (long long)row * nseg;
    int n_peaks;
    segment_base(t.seg_starts, NS, 0, lane, &n_peaks);
    if (tid == 0) n_peaks_out[row] = n_peaks;
    zero_slots(pin, fq, n_peaks, nseg, tid);
    runs_phase(E, t, B, NS, tid, lane, warp, [&](int id, float avg) {
      pin[id] = avg;
      fq[id] = (avg + 0.5f) * inv_N;               // N a power of two
    });
    if (TIMED) __syncthreads();
    STAMP(3)
  }
  if (TIMED && tid == 0) end_stamps(stamps, cycles, RUNS_PHASES, gt0);
}

// The out entry's row queue: queue[0] counts the rows claimed past the first
// gridDim.x (a CTA's first row is its blockIdx.x), queue[1] the CTAs done.
// Both are 0 when a launch starts; the last CTA done sets them to 0 again
// (every claim of the launch is in by then), for the next launch on the
// stream.  A CTA claims its next row a row ahead, so the rows go to the
// CTAs as they free up, whatever each row costs.
__device__ __forceinline__ int claim_row(int* queue) {
  return (int)gridDim.x + atomicAdd(queue, 1);
}
__device__ __forceinline__ void release_queue(int* queue, int tid) {
  if (tid == 0 && atomicAdd(queue + 1, 1) == (int)gridDim.x - 1) {
    queue[0] = 0;
    queue[1] = 0;
  }
}

// the out entry's shared memory, in 4-byte words: the double buffer of the
// valid slots (peak_in, then mapped, which becomes peak_out in place; PR
// words each), the pairs' three tables (PR each), the histogram (its
// segments: a peak whose cell is B counts in no k[b], b < B, and is not
// counted) and the segments' totals
struct OutLayout {
  int PR, HW, NS;
  __host__ __device__ OutLayout(int B) {
    NS = (B + 255) >> 8;
    HW = NS * 256;
    PR = (((B + 1) / 2) + 3) & ~3;
  }
  __host__ __device__ int words() const {
    return 7 * PR + HW + ((NS + 3) & ~3);
  }
};

// the first n slots of a row of peak_in and of mapped into shared memory
// by cp.async, 8 bytes at a time where both rows allow (slot n too when n
// is odd: it lies inside the row, B / 2 + 2 > (B + 1) / 2, and is never
// read), else 4
__device__ __forceinline__ void stage_slots(float* di, float* dm,
                                            const float* si, const float* sm,
                                            int n, int tid) {
  if (((reinterpret_cast<size_t>(si) | reinterpret_cast<size_t>(sm)) & 7) ==
      0) {
    for (int j = tid; j < (n + 1) >> 1; j += PEAKS_THREADS) {
      cp_async8(di + 2 * j, si + 2 * j);
      cp_async8(dm + 2 * j, sm + 2 * j);
    }
  } else {
    for (int i = tid; i < n; i += PEAKS_THREADS) {
      cp_async4(di + i, si + i);
      cp_async4(dm + i, sm + i);
    }
  }
  cp_async_commit();
}

// a row's valid slots: its count clamped to [0, (B + 1) / 2], the most
// peaks a row holds and the size of the tables
__device__ __forceinline__ int valid_slots(const int* n_peaks, int row,
                                           int B) {
  return min(max(n_peaks[row], 0), (B + 1) / 2);
}

// prefix_phase for the split: the pairs' range_scale, out_offset and
// out_scale in three tables of P words (pair k - 1 between peaks k - 1 and
// k; past the last: input 0, output +inf; its prev_o is peak_out[k - 1]
// itself), then each segment's inclusive prefix and its total
__device__ __forceinline__ void split_prefix_phase(
    const float* pin, const float* pout, float* pairs, int P, int* H,
    int* seg_total, int n_peaks, int NS, int tid, int lane, int warp) {
  const int NW = PEAKS_THREADS >> 5;
  for (int k = tid + 1; k <= n_peaks; k += PEAKS_THREADS) {
    const float inf = __int_as_float(0x7f800000);
    const float prev_o = pout[k - 1];
    const float prev_in = pin[k - 1];
    const float next_o = k < n_peaks ? pout[k] : inf;
    const float next_in = k < n_peaks ? pin[k] : 0.f;
    pairs[k - 1] = 1.f / (next_o - prev_o);                 // range_scale
    pairs[P + k - 1] = prev_in - prev_o;
    pairs[2 * P + k - 1] = ((next_in - next_o) - prev_in) + prev_o;
  }
  for (int s = warp; s < NS; s += NW) {
    int4* h = reinterpret_cast<int4*>(H + (s << 8) + (lane << 3));
    int4 u = h[0], v = h[1];
    u.y += u.x; u.z += u.y; u.w += u.z;
    v.x += u.w; v.y += v.x; v.z += v.y; v.w += v.z;
    const int incl = warp_inclusive_scan(v.w, lane);
    const int ex = incl - v.w;
    u.x += ex; u.y += ex; u.z += ex; u.w += ex;
    v.x += ex; v.y += ex; v.z += ex; v.w += ex;
    h[0] = u;
    h[1] = v;
    if (lane == 31) seg_total[s] = incl;
  }
}

// map_phase for the split, on split_prefix_phase's tables
template <int VEC>
__device__ __forceinline__ void split_map_phase(
    const float* pin, const float* pout, const float* pairs, int P, int* H,
    const int* seg_total, int n_peaks, int B, int NS, float tf_r,
    float ltf_r, float* out0, float* grad_row, int tid, int lane, int warp) {
  RowPeaks p;
  p.prev_o = pout;
  p.range_scale = pairs;
  p.out_offset = pairs + P;
  p.out_scale = pairs + 2 * P;
  p.n = n_peaks;
  const int top = max(n_peaks - 1, 0);
  p.first_in = n_peaks > 0 ? pin[0] : 0.f;
  p.first_out = n_peaks > 0 ? pout[0] : __int_as_float(0x7f800000);
  p.last_in = n_peaks > 0 ? pin[top] : 0.f;
  p.last_out = n_peaks > 0 ? pout[top] : 0.f;
  p.top_start = max((int)p.last_out, 0);   // truncation, as .to(int32)
  float* out1 = out0 + B;
  float* out2 = out1 + B;
  const int nq = (B + VEC - 1) / VEC;
  for (int q0 = 0; q0 < nq; q0 += PEAKS_THREADS) {
    // a warp's bins lie in one segment (32 * VEC divides 256)
    const int s = ((q0 + (warp << 5)) * VEC) >> 8;
    if (s >= NS) break;                     // the same in every lane
    int unused;
    const int kbase = segment_base(seg_total, NS, s, lane, &unused);
    const int q = q0 + tid;
    if (q >= nq) continue;
    if (VEC == 4) {
      const int4 k4 = reinterpret_cast<const int4*>(H)[q];
      reinterpret_cast<int4*>(H)[q] = make_int4(0, 0, 0, 0);
      float4 ib, g;
      const int b = q << 2;
      map_bin(p, b, k4.x + kbase, &ib.x, &g.x);
      map_bin(p, b + 1, k4.y + kbase, &ib.y, &g.y);
      map_bin(p, b + 2, k4.z + kbase, &ib.z, &g.z);
      map_bin(p, b + 3, k4.w + kbase, &ib.w, &g.w);
      reinterpret_cast<float4*>(out0)[q] = ib;
      reinterpret_cast<float4*>(out1)[q] =
          make_float4(ib.x - tf_r, ib.y - tf_r, ib.z - tf_r, ib.w - tf_r);
      reinterpret_cast<float4*>(out2)[q] = make_float4(
          ib.x - ltf_r, ib.y - ltf_r, ib.z - ltf_r, ib.w - ltf_r);
      reinterpret_cast<float4*>(grad_row)[q] = g;
    } else {
      float ib, g;
      const int kq = H[q];
      H[q] = 0;
      map_bin(p, q, kq + kbase, &ib, &g);
      out0[q] = ib;
      out1[q] = ib - tf_r;
      out2[q] = ib - ltf_r;
      grad_row[q] = g;
    }
  }
}

// the out entry: the output map of n_peaks[r] peaks of peak_in and mapped
// [R, nseg], and the position sets
template <int VEC, bool TIMED>
__global__ void __launch_bounds__(PEAKS_THREADS, 2)
peaks_out_kernel(const float* __restrict__ peak_in_in,
                 const float* __restrict__ mapped_in,
                 const int* __restrict__ n_peaks_in,
                 const float* __restrict__ tf, const float* __restrict__ ltf,
                 float* __restrict__ pos, float* __restrict__ freq_grad,
                 int R, int B, int nB, float N, int* __restrict__ queue,
                 long long* stamps) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int next_row, next_n;
  const OutLayout L(B);
  const int P = L.PR, NS = L.NS, nseg = B / 2 + 2;
  float* pairs = smem + 4 * P;
  int* H = reinterpret_cast<int*>(pairs + 3 * P);
  int* seg_total = H + L.HW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned long long gt0 = 0;
  long long clk = 0, cycles[OUT_PHASES] = {};
  if (TIMED && tid == 0) {
    gt0 = global_ns();
    clk = clock64();
  }

  for (int i = tid; i < L.HW; i += PEAKS_THREADS) H[i] = 0;
  int row = blockIdx.x;                     // < R: the grid is at most R
  int n_peaks = valid_slots(n_peaks_in, row, B);
  stage_slots(smem, smem + P, peak_in_in + (long long)row * nseg,
              mapped_in + (long long)row * nseg, n_peaks, tid);
  if (tid == 0) {
    next_row = claim_row(queue);
    next_n = next_row < R ? valid_slots(n_peaks_in, next_row, B) : 0;
  }
  for (int it = 0; row < R; ++it) {
    float* pin = smem + (it & 1) * 2 * P;
    float* pout = pin + P;                  // mapped, then peak_out
    const int blk = row % nB;
    const float tf_r = tf[blk], ltf_r = ltf[blk];
    cp_async_wait_all();
    // every thread is past the previous row: its buffer and the pairs'
    // tables are free, the histogram is zero (the map zeroed its bins
    // below B as it read them, the tail below), and next_row and next_n
    // hold the next row and its count
    __syncthreads();
    STAMP(1)
    const int next = next_row, n_next = next_n;
    if (next < R) {
      float* npin = smem + ((it + 1) & 1) * 2 * P;
      stage_slots(npin, npin + P, peak_in_in + (long long)next * nseg,
                  mapped_in + (long long)next * nseg, n_next, tid);
    }

    // --- peaks: each output band in place, and its histogram count ------
    for (int i = tid; i < n_peaks; i += PEAKS_THREADS) {
      const float out = pout[i] * N - 0.5f;        // count_peak's order
      const int cell = (int)fminf(fmaxf(ceilf(out), 0.f), (float)B);
      pout[i] = out;
      if (cell < B) atomicAdd(&H[cell], 1);
    }
    __syncthreads();
    STAMP(2)
    // the row after next, claimed while the prefix goes on (every thread
    // has read next_row and next_n), and its count during the map
    int claim = R, n_claim = 0;
    if (tid == 0 && next < R) claim = claim_row(queue);

    split_prefix_phase(pin, pout, pairs, P, H, seg_total, n_peaks, NS, tid,
                       lane, warp);
    __syncthreads();
    STAMP(3)

    if (tid == 0 && claim < R) n_claim = valid_slots(n_peaks_in, claim, B);
    split_map_phase<VEC>(pin, pout, pairs, P, H, seg_total, n_peaks, B, NS,
                         tf_r, ltf_r, pos + (long long)row * 3 * B,
                         freq_grad + (long long)row * B, tid, lane, warp);
    // the prefix's bins from B on, which the map does not read
    for (int i = B + tid; i < L.HW; i += PEAKS_THREADS) H[i] = 0;
    if (tid == 0) {
      next_row = claim;
      next_n = n_claim;
    }
    if (TIMED) __syncthreads();
    STAMP(4)
    row = next;
    n_peaks = n_next;
  }
  release_queue(queue, tid);
  if (TIMED && tid == 0) end_stamps(stamps, cycles, OUT_PHASES, gt0);
}

// the grid of a persistent kernel: as many CTAs as are resident at once,
// found once per kernel, size and card
struct Grid {
  int bytes = -1, dev = -1, per_sm = 0, sms = 0;
};

template <class Kernel>
static int resident_grid(Kernel kernel, Grid& g, int bytes, int R,
                         int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (bytes != g.bytes || dev != g.dev) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&g.sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &g.per_sm, kernel, PEAKS_THREADS, bytes);
    if (err != cudaSuccess) return (int)err;
    if (g.per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    g.bytes = bytes;
    g.dev = dev;
  }
  *grid = R < g.per_sm * g.sms ? R : g.per_sm * g.sms;
  return 0;
}

template <int VEC, bool TIMED>
static int launch(const float* energy, const float* smoothed, const float* tf,
                  const float* ltf, float* pos, float* freq_grad, int R, int B,
                  int nB, int N, const float* ctl, int nC, long long* stamps,
                  void* stream) {
  static Grid g;
  auto kernel = peaks_map_kernel<VEC, TIMED>;
  const int bytes = 4 * Layout(B).words();
  int grid = 0;
  const int err = resident_grid(kernel, g, bytes, R, &grid);
  if (err) return err;
  kernel<<<grid, PEAKS_THREADS, bytes, (cudaStream_t)stream>>>(
      energy, smoothed, tf, ltf, pos, freq_grad, R, B, nB, (float)N,
      1.f / (float)N, ctl, nC, stamps);
  return (int)cudaGetLastError();
}

template <bool TIMED>
static int dispatch(const float* energy, const float* smoothed,
                    const float* tf, const float* ltf, float* pos,
                    float* freq_grad, int R, int B, int nB, int N,
                    const float* ctl, int nC, long long* stamps,
                    void* stream) {
  if (R <= 0 || B <= 0) return 0;
  if (nC < 1 || nB < 1 || R % nB || (nC != 1 && nC != nB))
    return (int)cudaErrorInvalidValue;
  // 16-byte rows: B a multiple of four and every plane aligned
  const bool vec = B % 4 == 0 &&
                   ((reinterpret_cast<size_t>(energy) |
                     reinterpret_cast<size_t>(smoothed) |
                     reinterpret_cast<size_t>(pos) |
                     reinterpret_cast<size_t>(freq_grad)) & 15) == 0;
  return (vec ? launch<4, TIMED> : launch<1, TIMED>)(
      energy, smoothed, tf, ltf, pos, freq_grad, R, B, nB, N, ctl, nC, stamps,
      stream);
}

template <int VEC, bool TIMED>
static int launch_runs(const float* energy, const float* smoothed,
                       float* peak_in, float* avg_freq, int* n_peaks, int R,
                       int B, int N, long long* stamps, void* stream) {
  static Grid g;
  auto kernel = peaks_runs_kernel<VEC, TIMED>;
  const int bytes = 4 * RunsLayout(B).words();
  int grid = 0;
  const int err = resident_grid(kernel, g, bytes, R, &grid);
  if (err) return err;
  kernel<<<grid, PEAKS_THREADS, bytes, (cudaStream_t)stream>>>(
      energy, smoothed, peak_in, avg_freq, n_peaks, R, B, 1.f / (float)N,
      stamps);
  return (int)cudaGetLastError();
}

template <bool TIMED>
static int dispatch_runs(const float* energy, const float* smoothed,
                         float* peak_in, float* avg_freq, int* n_peaks, int R,
                         int B, int N, long long* stamps, void* stream) {
  if (R <= 0 || B <= 0) return 0;
  const bool vec = B % 4 == 0 &&
                   ((reinterpret_cast<size_t>(energy) |
                     reinterpret_cast<size_t>(smoothed)) & 15) == 0;
  return (vec ? launch_runs<4, TIMED> : launch_runs<1, TIMED>)(
      energy, smoothed, peak_in, avg_freq, n_peaks, R, B, N, stamps, stream);
}

template <int VEC, bool TIMED>
static int launch_out(const float* peak_in, const float* mapped,
                      const int* n_peaks, const float* tf, const float* ltf,
                      float* pos, float* freq_grad, int R, int B, int nB,
                      int N, int* queue, long long* stamps, void* stream) {
  static Grid g;
  auto kernel = peaks_out_kernel<VEC, TIMED>;
  const int bytes = 4 * OutLayout(B).words();
  int grid = 0;
  const int err = resident_grid(kernel, g, bytes, R, &grid);
  if (err) return err;
  kernel<<<grid, PEAKS_THREADS, bytes, (cudaStream_t)stream>>>(
      peak_in, mapped, n_peaks, tf, ltf, pos, freq_grad, R, B, nB, (float)N,
      queue, stamps);
  return (int)cudaGetLastError();
}

template <bool TIMED>
static int dispatch_out(const float* peak_in, const float* mapped,
                        const int* n_peaks, const float* tf, const float* ltf,
                        float* pos, float* freq_grad, int R, int B, int nB,
                        int N, int* queue, long long* stamps, void* stream) {
  if (R <= 0 || B <= 0) return 0;
  if (nB < 1 || R % nB) return (int)cudaErrorInvalidValue;
  const bool vec = B % 4 == 0 &&
                   ((reinterpret_cast<size_t>(pos) |
                     reinterpret_cast<size_t>(freq_grad)) & 15) == 0;
  return (vec ? launch_out<4, TIMED> : launch_out<1, TIMED>)(
      peak_in, mapped, n_peaks, tf, ltf, pos, freq_grad, R, B, nB, N, queue,
      stamps, stream);
}

// energy, smoothed [R, B] f32; tf, ltf [nB] f32 (rows block-major per
// clip, R a multiple of nB); pos [R, 3, B] and freq_grad [R, B] f32 out; N
// the FFT size; ctl [nC, 3] f32 (nC 1 or nB) the frequency map's float32
// constants limit, mult and above_off = f32(f32(mult - 1) * limit), of the
// render or of each block.  Returns the cudaError_t of the launch.
extern "C" int sst_peaks_map(const float* energy, const float* smoothed,
                             const float* tf, const float* ltf, float* pos,
                             float* freq_grad, int R, int B, int nB, int N,
                             const float* ctl, int nC, void* stream) {
  return dispatch<false>(energy, smoothed, tf, ltf, pos, freq_grad, R, B, nB,
                         N, ctl, nC, nullptr, stream);
}

// the same, and per CTA the phase stamps (see STAMP) into stamps, at least
// [min(R, CTAs resident), PEAKS_PHASES + 3] int64; not on the main path
extern "C" int sst_peaks_map_timed(const float* energy, const float* smoothed,
                                   const float* tf, const float* ltf,
                                   float* pos, float* freq_grad, int R, int B,
                                   int nB, int N, const float* ctl, int nC,
                                   long long* stamps, void* stream) {
  return dispatch<true>(energy, smoothed, tf, ltf, pos, freq_grad, R, B, nB,
                        N, ctl, nC, stamps, stream);
}

// the runs entry: energy, smoothed [R, B] f32 -> peak_in, avg_freq [R, B /
// 2 + 2] f32 and n_peaks [R] int32; N the FFT size (a power of two)
extern "C" int sst_peaks_runs(const float* energy, const float* smoothed,
                              float* peak_in, float* avg_freq, int* n_peaks,
                              int R, int B, int N, void* stream) {
  return dispatch_runs<false>(energy, smoothed, peak_in, avg_freq, n_peaks, R,
                              B, N, nullptr, stream);
}

// the same with the stamps, [min(R, CTAs resident), RUNS_PHASES + 3]
extern "C" int sst_peaks_runs_timed(const float* energy,
                                    const float* smoothed, float* peak_in,
                                    float* avg_freq, int* n_peaks, int R,
                                    int B, int N, long long* stamps,
                                    void* stream) {
  return dispatch_runs<true>(energy, smoothed, peak_in, avg_freq, n_peaks, R,
                             B, N, stamps, stream);
}

// the out entry: peak_in, mapped [R, B / 2 + 2] f32 and n_peaks [R] int32
// (the runs entry's outputs, avg_freq through the frequency map), tf, ltf
// [nB] f32 -> pos [R, 3, B] and freq_grad [R, B] f32, as sst_peaks_map;
// queue int32 [2], zero (the row queue, claim_row: every launch leaves it
// zero; launches that share one run in turn, on one stream)
extern "C" int sst_peaks_out(const float* peak_in, const float* mapped,
                             const int* n_peaks, const float* tf,
                             const float* ltf, float* pos, float* freq_grad,
                             int R, int B, int nB, int N, int* queue,
                             void* stream) {
  return dispatch_out<false>(peak_in, mapped, n_peaks, tf, ltf, pos,
                             freq_grad, R, B, nB, N, queue, nullptr, stream);
}

// the same with the stamps, [min(R, CTAs resident), OUT_PHASES + 3]
extern "C" int sst_peaks_out_timed(const float* peak_in, const float* mapped,
                                   const int* n_peaks, const float* tf,
                                   const float* ltf, float* pos,
                                   float* freq_grad, int R, int B, int nB,
                                   int N, int* queue, long long* stamps,
                                   void* stream) {
  return dispatch_out<true>(peak_in, mapped, n_peaks, tf, ltf, pos,
                            freq_grad, R, B, nB, N, queue, stamps, stream);
}

// a kernel's CTAs resident an SM at `bytes` of dynamic shared memory and
// its registers a thread, into out[0] and out[1]; its dynamic limit goes
// to the card's most beside its static shared memory, which every launch's
// own size fits
template <class Kernel>
static int occupancy(Kernel kernel, int bytes, int* out) {
  int dev = 0, most = 0;
  cudaFuncAttributes a;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most - (int)a.sharedSizeBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], kernel, PEAKS_THREADS, bytes);
  if (err == cudaSuccess) out[1] = a.numRegs;
  return (int)err;
}

// the split's entries as the main path launches them at width B (16-byte
// rows): out[0..1] the runs entry's CTAs resident an SM and registers a
// thread, out[2..3] the out entry's.  Launches nothing.
extern "C" int sst_peaks_split_occupancy(int B, int* out) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  int err = occupancy(peaks_runs_kernel<4, false>, 4 * RunsLayout(B).words(),
                      out);
  if (!err)
    err = occupancy(peaks_out_kernel<4, false>, 4 * OutLayout(B).words(),
                    out + 2);
  return err;
}
