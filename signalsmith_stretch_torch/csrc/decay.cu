// Formant envelope decay passes: the recurrence along bins
//   y_b = op(x_b, d * y_{b-1})        (y_{-1} = init, d one value per row)
// run forward or backward over every row, with op the C++ selection
//   max: (x_b < t) ? t : x_b          min: (t < x_b) ? t : x_b
// so a NaN product t (d = inf on a silent row, times 0) is discarded
// (signalsmith-stretch.h:984-1007).
//
// Replaces signalsmith_stretch_tpu/ops/scan_ops.py:_decay_scan
// (decay_max_forward/backward, decay_min_forward/backward), which on the TPU
// are log-depth lax.associative_scan compositions (not a Pallas kernel;
// PyTorch has no such scan, and a loop of per-bin launches would cost
// thousands of launches per pass).
//
// Bound on this card: latency, like the slew scan (csrc/scan.cu).  Each
// element is read once and written once for one multiply and one compare
// (the bytes would take ~0.026 ms at [2680, 4096]), but each row is one
// chain of B dependent steps.  Design: one thread per row, serial over bins
// in the reference's order, so the result is the C++ value (bit-equal to the
// plain loop); the row's coefficient is read once; the loads do not depend
// on the chain, so the unrolled loop issues them ahead of the arithmetic.
#include <cuda_runtime.h>

template <bool IS_MIN>
__device__ __forceinline__ float pick(float a, float t) {
  if (IS_MIN) return (t < a) ? t : a;
  return (a < t) ? t : a;
}

template <bool IS_MIN>
__global__ void decay_kernel(const float* __restrict__ x,
                             const float* __restrict__ init,
                             const float* __restrict__ coef,
                             float* __restrict__ y, float* __restrict__ fin,
                             int R, int B, int backward) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float* xr = x + r * B;
  float* yr = y + r * B;
  const float d = coef[r];
  float v = init[r];
  if (backward) {
#pragma unroll 8
    for (int b = B - 1; b >= 0; --b) {
      v = pick<IS_MIN>(xr[b], d * v);
      yr[b] = v;
    }
  } else {
#pragma unroll 8
    for (int b = 0; b < B; ++b) {
      v = pick<IS_MIN>(xr[b], d * v);
      yr[b] = v;
    }
  }
  fin[r] = v;
}

// x, y [R, B] f32; init, coef, fin [R] f32.  Returns the cudaError_t of the
// launch.
extern "C" int sst_decay(const float* x, const float* init, const float* coef,
                         float* y, float* fin, int R, int B, int is_min,
                         int backward, void* stream) {
  if (R > 0 && B > 0) {
    const int threads = 128;
    const int blocks = (R + threads - 1) / threads;
    cudaStream_t s = (cudaStream_t)stream;
    if (is_min)
      decay_kernel<true><<<blocks, threads, 0, s>>>(x, init, coef, y, fin, R,
                                                    B, backward);
    else
      decay_kernel<false><<<blocks, threads, 0, s>>>(x, init, coef, y, fin, R,
                                                     B, backward);
  }
  return (int)cudaGetLastError();
}
