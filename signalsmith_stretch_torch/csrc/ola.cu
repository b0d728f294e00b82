// The synthesis's assembly (kernel L): the windowed blocks of kernel K
// overlap-added into the output ring, divided by the WOLA weight, with the
// outputSeek pre-roll cancellation, the flush tail and the silence bypass,
// written straight into the render's output [rows, out_samples] (rows =
// batch x ch).  Output-stationary: each output sample is written once, by
// one thread, which sums the <= m = ceil(block / H) blocks over its ring
// position itself; no ring, no padded strips and no concatenation reach
// device memory.
//
// Contract (engine.assemble_plain, the plain version, on the same blocks;
// reference signalsmith-stretch.h:198-203, :240-278, :444-454).  Block k of
// a row sits at ring position first + k H.
// - ring(p): the blocks over p summed as the plain overlap-add sums its m
//   group strips (group g = k mod m, g = 0, 1, ..., m-1 in order, into
//   zero); a strip's zero padding past `block` adds +0, which leaves a sum
//   that started from +0 unchanged, so it is skipped.
// - r(p) = (ring(p) - pre(2L-1-p)) / w[p], the pre-roll term only for
//   L <= p < 2L, with pre(q) = ring(q) / w[q] (the negated, reversed
//   pre-roll of outputSeek).
// - out[s] = r(L + s) for s < main_out + flush_block_out (main, then the
//   flush's block); the tail, s = main_out + flush_block_out + i, i < T:
//   r(head + i) - r(head + 2T - 1 - i), head = L + main_out +
//   flush_block_out.
// - The silence bypass, per clip, from the two energies the caller summed
//   (pre-roll and main input): main bypassed -> the main segment is the
//   input passthrough (input[seek_length + s mod main_in], or zeros) and
//   the tail is the restricted-ring tail of the pre-roll blocks at head L;
//   else flush bypassed -> the flush block's samples are zeros and the
//   tail is the restricted tail of the pre-roll and main blocks at head
//   L + main_out.  A restricted tail sums its blocks in block order (the
//   plain version's spans), subtracts pre() where it meets [L, 2L), and
//   divides by its own restricted weights.
// Every sum, difference and quotient is one IEEE float32 operation
// (__fadd_rn, __fsub_rn, __fdiv_rn) in the plain version's order, so the
// output is bit-equal to it on the same blocks.
//
// Replaces no Pallas kernel: the JAX package assembles with plain jnp
// (signalsmith_stretch_tpu/engine.py: _overlap_add and synthesis_stage);
// the plain PyTorch version runs ~45 operations a render (the zeroed ring,
// four group strips padded and added, five WOLA divisions, the flip, the
// selects and a torch.cat of the whole output).
//
// Bound on this card: bytes.  Each block sample is read once (blocks of
// different groups meet at a sample, each at its own offset) and each output
// sample written once: at 3x, 1.48 GB read and 0.37 GB written, 0.55 ms at
// 3.35 TB/s (the weights, 5.8 MB, stay in L2).  Design: a CTA of 256
// threads takes 1024 consecutive samples of one row, four a thread at a
// stride of 256, so that a warp's reads of a block are 128 consecutive
// bytes; the grid is (ceil(out_samples / 1024), rows): a batch-1 render of
// a few seconds still gives thousands of CTAs.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int OLA_THREADS = 256, OLA_PER_THREAD = 4, OLA_GROUPS = 4;

// bits of `modes`: the bypasses the plan can reach (engine.SilencePlan)
constexpr int MAIN_POSSIBLE = 1, FLUSH_PRE = 2, FLUSH_ALONE = 4;

struct Geometry {
  int nB, block, H, m, first, L;
};

// ring(p): the blocks over p in group order, into +0.  The first
// OLA_GROUPS groups' loads are independent and issued together (m is 4 for
// presetDefault, 3 for presetCheaper); any further group follows in order.
__device__ __forceinline__ float ring_sum(const float* __restrict__ b, int p,
                                          const Geometry& g) {
  const int rel = p - g.first;
  float acc = 0.f;
  if (rel < 0) return acc;
  const int q = rel / g.H;            // the last block that starts by p
  const int r = q % g.m;              // its group
  float v[OLA_GROUPS];
  bool ok[OLA_GROUPS];
#pragma unroll
  for (int gi = 0; gi < OLA_GROUPS; ++gi) {   // group gi's block over p
    const int k = q - (r >= gi ? r - gi : r - gi + g.m);
    const int j = rel - k * g.H;
    ok[gi] = gi < g.m && k >= 0 && k < g.nB && j < g.block;
    v[gi] = ok[gi] ? __ldg(b + (long long)k * g.block + j) : 0.f;
  }
#pragma unroll
  for (int gi = 0; gi < OLA_GROUPS; ++gi)
    if (ok[gi]) acc = __fadd_rn(acc, v[gi]);
  for (int gi = OLA_GROUPS; gi < g.m; ++gi) {
    const int k = q - (r >= gi ? r - gi : r - gi + g.m);
    const int j = rel - k * g.H;
    if (k >= 0 && k < g.nB && j < g.block)
      acc = __fadd_rn(acc, __ldg(b + (long long)k * g.block + j));
  }
  return acc;
}

// pre(q) = ring(q) / w[q], q < L
__device__ __forceinline__ float preroll(const float* __restrict__ b,
                                         const float* __restrict__ w, int q,
                                         const Geometry& g) {
  return __fdiv_rn(ring_sum(b, q, g), __ldg(w + q));
}

// r(p): the ring after outputSeek's cancellation, over the WOLA weight
__device__ __forceinline__ float read(const float* __restrict__ b,
                                      const float* __restrict__ w, int p,
                                      const Geometry& g) {
  float v = ring_sum(b, p, g);
  if (p >= g.L && p < 2 * g.L)
    v = __fsub_rn(v, preroll(b, w, 2 * g.L - 1 - p, g));
  return __fdiv_rn(v, __ldg(w + p));
}

// a restricted-ring value at ring position P = w0 + x: blocks k < n_lim in
// block order, the pre-roll term, over the restricted weight wt[x]
__device__ __forceinline__ float restricted(const float* __restrict__ b,
                                            const float* __restrict__ w,
                                            const float* __restrict__ wt,
                                            int w0, int x, int n_lim,
                                            const Geometry& g) {
  const int P = w0 + x, rel = P - g.first;
  float acc = 0.f;
  if (rel >= 0) {
    const int q = rel / g.H;
    const int k_hi = q < n_lim - 1 ? q : n_lim - 1;
    const int k_lo = rel >= g.block ? (rel - g.block) / g.H + 1 : 0;
    for (int k = k_lo; k <= k_hi; ++k)
      acc = __fadd_rn(acc,
                      __ldg(b + (long long)k * g.block + rel - k * g.H));
  }
  if (P >= g.L && P < 2 * g.L)
    acc = __fsub_rn(acc, preroll(b, w, 2 * g.L - 1 - P, g));
  return __fdiv_rn(acc, __ldg(wt + x));
}

__global__ void __launch_bounds__(OLA_THREADS)
ola_kernel(const float* __restrict__ blocks, const float* __restrict__ w,
           const float* __restrict__ audio, const float* __restrict__ pre_e,
           const float* __restrict__ main_e,
           const float* __restrict__ pre_wt, const float* __restrict__ pm_wt,
           float* __restrict__ out, Geometry g, int ch, int main_out,
           int flush_out, int T, int in_samples, int seek_length,
           int main_in, int n_pre, int n_pm, int modes,
           float noise_floor) {
  const int row = blockIdx.y, clip = row / ch;
  const int out_samples = main_out + flush_out + T;
  const int head = g.L + main_out + flush_out;
  // the clip's bypass decisions (engine.assemble_plain's selects)
  bool main_b = false, flush_b = false;
  if (pre_e != nullptr) {
    const bool pre_s = pre_e[clip] < noise_floor;
    const bool main_s = main_e[clip] < noise_floor;
    const bool fp = modes & FLUSH_PRE, fa = modes & FLUSH_ALONE;
    main_b = (modes & MAIN_POSSIBLE) && main_s && pre_s;
    flush_b = fp == fa ? main_s && fp : main_s && pre_s && fp;
  }
  const bool tail_pre = main_b && T > 0;
  const bool tail_pm = !tail_pre && flush_b && flush_out > 0;
  const float* b = blocks + (long long)row * g.nB * g.block;
  const float* in = audio ? audio + (long long)row * in_samples : audio;
  float* o = out + (long long)row * out_samples;
  const int s0 = blockIdx.x * (OLA_THREADS * OLA_PER_THREAD) + threadIdx.x;
#pragma unroll 1
  for (int i = 0; i < OLA_PER_THREAD; ++i) {
    const int s = s0 + i * OLA_THREADS;
    if (s >= out_samples) break;
    float v;
    if (s < main_out) {
      v = !main_b ? read(b, w, g.L + s, g)
          : main_in > 0 ? in[seek_length + s % main_in] : 0.f;
    } else if (s < main_out + flush_out) {
      v = flush_b ? 0.f : read(b, w, g.L + s, g);
    } else {
      const int t = s - main_out - flush_out, u = 2 * T - 1 - t;
      if (tail_pre) {
        v = __fsub_rn(restricted(b, w, pre_wt, g.L, t, n_pre, g),
                      restricted(b, w, pre_wt, g.L, u, n_pre, g));
      } else if (tail_pm) {
        const int w0 = g.L + main_out;
        v = __fsub_rn(restricted(b, w, pm_wt, w0, t, n_pm, g),
                      restricted(b, w, pm_wt, w0, u, n_pm, g));
      } else {
        v = __fsub_rn(read(b, w, head + t, g), read(b, w, head + u, g));
      }
    }
    o[s] = v;
  }
}

// blocks [rows, nB, block] f32 (kernel K's windowed blocks); w [ring] f32
// floored WOLA weights; out [rows, main_out + flush_out + T] f32.  The
// bypass: audio [rows, in_samples] f32, pre_e and main_e [rows / ch] f32
// energies (all null: no bypass), pre_wt and pm_wt [2T] f32 restricted
// weights (null where the plan cannot reach that tail).  Returns a
// cudaError_t (cudaErrorInvalidValue for arguments out of range).
extern "C" int sst_ola(const float* blocks, const float* w,
                       const float* audio, const float* pre_e,
                       const float* main_e, const float* pre_wt,
                       const float* pm_wt, float* out, int rows, int ch,
                       int nB, int block, int H, int first, int L,
                       int main_out, int flush_out, int T, int in_samples,
                       int seek_length, int main_in, int n_pre, int n_pm,
                       int modes, float noise_floor, void* stream) {
  const long long out_samples = (long long)main_out + flush_out + T;
  if (rows <= 0 || out_samples <= 0) return (int)cudaSuccess;
  if (rows > 65535 || ch < 1 || rows % ch || nB < 1 || block < 1 || H < 1 ||
      first < 0 || L < 0 || main_out < 0 || flush_out < 0 || T < 0 ||
      out_samples > (1LL << 30) || (pre_e != nullptr &&
      (audio == nullptr || main_e == nullptr ||
       ((modes & MAIN_POSSIBLE) && T > 0 && pre_wt == nullptr) ||
       (flush_out > 0 && T > 0 && pm_wt == nullptr))))
    return (int)cudaErrorInvalidValue;
  const Geometry g{nB, block, H, (block + H - 1) / H, first, L};
  const int per_cta = OLA_THREADS * OLA_PER_THREAD;
  const dim3 grid((unsigned)((out_samples + per_cta - 1) / per_cta),
                  (unsigned)rows);
  ola_kernel<<<grid, OLA_THREADS, 0, (cudaStream_t)stream>>>(
      blocks, w, audio, pre_e, main_e, pre_wt, pm_wt, out, g, ch, main_out,
      flush_out, T, in_samples, seek_length, main_in, n_pre, n_pm, modes,
      noise_floor);
  return (int)cudaGetLastError();
}
