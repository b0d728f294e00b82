// The pitch estimator's top-3 local maxima (kernel F): per row, what the
// insertion ladder of signalsmith-stretch.h:931-948 leaves after bins
// 1..B-2, from the state (indices 0, values metric[0]).  A bin is a local
// maximum when !(e < prev) && !(e <= next), so ties and NaNs fall as in the
// reference.
//
// Replaces signalsmith_stretch_tpu/spectral.py:_top3_local_maxima, a
// lax.scan over bins on the TPU (not a Pallas kernel; PyTorch has no
// counterpart).
//
// Why a merge is exact.  The ladder only compares and selects: whether a bin
// is a local maximum depends on the row alone, and only e > v inserts, so
// the state is the top three, under "larger value first, earlier bin first
// among equals", of the local maxima with e > metric[0], below which rank the
// three starting entries (0, metric[0]).  A NaN at bin 0 makes every e > v
// false (nothing is inserted); a NaN local maximum is never inserted; floats
// compare as floats (-0.0 == +0.0 falls to the earlier bin) and each output
// value is the chosen element's own.  So each lane runs the ladder over its
// own bins in ascending order, which gives its top three under that order,
// and a butterfly of shuffles merges the lanes' lists; the order is total on
// distinct entries, so the merge's tree does not change the result.
// tests/test_torch_scan.py holds a CPU model of this partition and merge
// bit-equal to the plain loop.
//
// Bound on this card: bytes (the row read once: ~0.013 ms for [2680, 4096];
// six values a row written).  Design: one warp a row; lane L holds W
// consecutive bins of each chunk of 32*W (float4 loads when the rows are
// 16-byte aligned, W = 4, else W = 1), GROUP chunks loaded a group ahead of
// the one being scanned; a bin's neighbours come from the lanes beside it.
// Outputs: idx [3, R] int32 and val [3, R] f32 (i0, i1, i2 and v0, v1, v2;
// i2/v2 the best), bit-equal to the plain loop.
#include <cuda_runtime.h>

#define TOP3_WARPS 8     // rows a CTA
#define TOP3_GROUP 4     // chunks a group

// a better than b: larger value, then earlier bin
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

template <int W>
__device__ __forceinline__ void load_chunk(const float* mr, int at, int B,
                                           float* v) {
  if (W == 4) {
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (at < B) q = *reinterpret_cast<const float4*>(mr + at);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) v[j] = at + j < B ? mr[at + j] : 0.f;
  }
}

template <int W>
__global__ void __launch_bounds__(32 * TOP3_WARPS)
top3_kernel(const float* __restrict__ m, int* __restrict__ idx,
            float* __restrict__ val, int R, int B) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * TOP3_WARPS + (threadIdx.x >> 5);
  if (r >= R) return;                       // the whole warp
  const float* mr = m + r * B;
  const float m0 = mr[0];
  int i0 = 0, i1 = 0, i2 = 0;
  float v0 = m0, v1 = m0, v2 = m0;
  constexpr int CHUNK = 32 * W, SPAN = TOP3_GROUP * CHUNK;
  float cur[TOP3_GROUP][W], nxt[TOP3_GROUP][W];
#pragma unroll
  for (int g = 0; g < TOP3_GROUP; ++g)
    load_chunk<W>(mr, g * CHUNK + lane * W, B, cur[g]);
  float carry = 0.f;                        // the bin before the chunk
  for (int base = 0; base < B; base += SPAN) {
#pragma unroll
    for (int g = 0; g < TOP3_GROUP; ++g)
      load_chunk<W>(mr, base + SPAN + g * CHUNK + lane * W, B, nxt[g]);
#pragma unroll
    for (int g = 0; g < TOP3_GROUP; ++g) {
      const float up = __shfl_up_sync(full, cur[g][W - 1], 1);
      const float left = lane ? up : carry;
      const float after = g + 1 < TOP3_GROUP ? cur[(g + 1) % TOP3_GROUP][0]
                                             : nxt[0][0];
      // every lane takes part in every shuffle
      const float down = __shfl_down_sync(full, cur[g][0], 1);
      const float next_first = __shfl_sync(full, after, 0);
      const float right = lane < 31 ? down : next_first;
      carry = __shfl_sync(full, cur[g][W - 1], 31);
      const int b0 = base + g * CHUNK + lane * W;
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const int b = b0 + j;
        const float e = cur[g][j];
        const float ep = j ? cur[g][j - 1] : left;
        const float en = j + 1 < W ? cur[g][j + 1] : right;
        const bool is_max = b >= 1 && b <= B - 2 && !(e < ep) && !(e <= en);
        // the ladder of spectral.py:_top3_local_maxima, from the old state
        const bool s0 = is_max && (e > v0);
        const bool s1 = s0 && (e > v1);
        const bool s2 = s1 && (e > v2);
        const int n_i0 = s1 ? i1 : (s0 ? b : i0);
        const float n_v0 = s1 ? v1 : (s0 ? e : v0);
        const int n_i1 = s2 ? i2 : (s1 ? b : i1);
        const float n_v1 = s2 ? v2 : (s1 ? e : v1);
        i2 = s2 ? b : i2;
        v2 = s2 ? e : v2;
        i0 = n_i0; v0 = n_v0; i1 = n_i1; v1 = n_v1;
      }
    }
#pragma unroll
    for (int g = 0; g < TOP3_GROUP; ++g)
#pragma unroll
      for (int j = 0; j < W; ++j) cur[g][j] = nxt[g][j];
  }

  // butterfly merge of the lanes' lists, best first: (2, 1, 0)
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    float av[3] = {v2, v1, v0}, bv[3];
    int ai[3] = {i2, i1, i0}, bi[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      bv[q] = __shfl_xor_sync(full, av[q], o);
      bi[q] = __shfl_xor_sync(full, ai[q], o);
    }
    float ov[3];
    int oi[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const bool take_b = better(bv[0], bi[0], av[0], ai[0]);
      ov[q] = take_b ? bv[0] : av[0];
      oi[q] = take_b ? bi[0] : ai[0];
      if (take_b) {
        bv[0] = bv[1]; bi[0] = bi[1]; bv[1] = bv[2]; bi[1] = bi[2];
      } else {
        av[0] = av[1]; ai[0] = ai[1]; av[1] = av[2]; ai[1] = ai[2];
      }
    }
    v2 = ov[0]; i2 = oi[0]; v1 = ov[1]; i1 = oi[1]; v0 = ov[2]; i0 = oi[2];
  }
  if (lane == 0) {
    idx[r] = i0; idx[R + r] = i1; idx[2 * R + r] = i2;
    val[r] = v0; val[R + r] = v1; val[2 * R + r] = v2;
  }
}

// metric [R, B] f32 (B >= 3); idx [3, R] int32; val [3, R] f32.  Returns the
// cudaError_t of the launch.
extern "C" int sst_top3(const float* metric, int* idx, float* val, int R,
                        int B, void* stream) {
  if (R > 0) {
    const int ctas = (R + TOP3_WARPS - 1) / TOP3_WARPS;
    const bool vec = B % 4 == 0 && (reinterpret_cast<size_t>(metric) & 15) == 0;
    if (vec)
      top3_kernel<4><<<ctas, 32 * TOP3_WARPS, 0, (cudaStream_t)stream>>>(
          metric, idx, val, R, B);
    else
      top3_kernel<1><<<ctas, 32 * TOP3_WARPS, 0, (cudaStream_t)stream>>>(
          metric, idx, val, R, B);
  }
  return (int)cudaGetLastError();
}
