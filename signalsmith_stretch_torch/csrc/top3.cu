// The pitch estimator's top-3 local maxima: per row, the insertion ladder of
// signalsmith-stretch.h:931-948 over bins 1..B-2, from the state
// (indices 0, values metric[0]).  A bin is a local maximum when
// !(e < prev) && !(e <= next), so ties and NaNs fall as in the reference.
//
// Replaces signalsmith_stretch_tpu/spectral.py:_top3_local_maxima, a
// lax.scan over bins on the TPU (not a Pallas kernel; PyTorch has no
// counterpart, and a loop of per-bin launches would cost tens of thousands
// of launches).
//
// Bound on this card: latency.  The row is read once (~0.013 ms for
// [2680, 4096] at the memory rate) and six values per row are written, but
// the state is one chain of B-2 dependent selections.  Design: one thread
// per row, serial over bins, the previous and current values carried in
// registers so each bin is loaded once.  Outputs: idx [3, R] int32 and
// val [3, R] f32 (i0, i1, i2 and v0, v1, v2), bit-equal to the plain loop.
#include <cuda_runtime.h>

__global__ void top3_kernel(const float* __restrict__ m, int* __restrict__ idx,
                            float* __restrict__ val, int R, int B) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float* mr = m + r * B;
  int i0 = 0, i1 = 0, i2 = 0;
  float v0 = mr[0], v1 = mr[0], v2 = mr[0];
  float ep = mr[0], e = mr[1];
#pragma unroll 4
  for (int b = 1; b < B - 1; ++b) {
    const float en = mr[b + 1];
    const bool is_max = !(e < ep) && !(e <= en);
    const bool m0 = is_max && (e > v0);
    const bool m1 = m0 && (e > v1);
    const bool m2 = m1 && (e > v2);
    // the ladder of spectral.py:_top3_local_maxima, all from the old state
    const int n_i0 = m1 ? i1 : (m0 ? b : i0);
    const float n_v0 = m1 ? v1 : (m0 ? e : v0);
    const int n_i1 = m2 ? i2 : (m1 ? b : i1);
    const float n_v1 = m2 ? v2 : (m1 ? e : v1);
    i2 = m2 ? b : i2;
    v2 = m2 ? e : v2;
    i0 = n_i0; v0 = n_v0; i1 = n_i1; v1 = n_v1;
    ep = e;
    e = en;
  }
  idx[r] = i0; idx[R + r] = i1; idx[2 * R + r] = i2;
  val[r] = v0; val[R + r] = v1; val[2 * R + r] = v2;
}

// metric [R, B] f32 (B >= 3); idx [3, R] int32; val [3, R] f32.  Returns the
// cudaError_t of the launch.
extern "C" int sst_top3(const float* metric, int* idx, float* val, int R,
                        int B, void* stream) {
  if (R > 0) {
    const int threads = 128;
    top3_kernel<<<(R + threads - 1) / threads, threads, 0,
                  (cudaStream_t)stream>>>(metric, idx, val, R, B);
  }
  return (int)cudaGetLastError();
}
