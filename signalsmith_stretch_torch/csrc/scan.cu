// Energy slew smoothing: the first-order recurrence along bins
//   y_b = y_{b-1} + (x_b - y_{b-1}) * slew        (y_{-1} = init)
// run forward or backward over every row (signalsmith-stretch.h:816-848).
//
// Replaces signalsmith_stretch_tpu/ops/scan_ops.py:iir_forward/iir_backward,
// which on the TPU are log-depth lax.associative_scan compositions (not a
// Pallas kernel; the scan needs its own kernel here because PyTorch has
// none, and a loop of per-bin launches costs thousands of launches).
//
// Bound on this card: latency.  Each element is read once and written once
// for 3 flops (the bytes would take ~0.03 ms at bench shapes), but each row
// is one chain of B dependent steps.  Design: one thread per row, serial over
// bins in the reference's own order, so the result is the C++ value rather
// than the associative reassociation.  The loads do not depend on the chain,
// so the unrolled loop issues several bins' loads ahead of the dependent
// arithmetic.  Neighbouring threads own neighbouring rows, so the loads of
// one step are strided by B (uncoalesced); staging tiles of rows through
// shared memory is the next step.  Built with --fmad=false so the update rounds
// after the subtract, the multiply and the add exactly as the plain version.
#include <cuda_runtime.h>

__global__ void iir_kernel(const float* __restrict__ x,
                           const float* __restrict__ init,
                           float* __restrict__ y, float* __restrict__ fin,
                           int R, int B, float slew, int backward) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float* xr = x + r * B;
  float* yr = y + r * B;
  float v = init[r];
  if (backward) {
#pragma unroll 8
    for (int b = B - 1; b >= 0; --b) {
      v = v + (xr[b] - v) * slew;
      yr[b] = v;
    }
  } else {
#pragma unroll 8
    for (int b = 0; b < B; ++b) {
      v = v + (xr[b] - v) * slew;
      yr[b] = v;
    }
  }
  fin[r] = v;
}

// x, y [R, B] f32; init, fin [R] f32.  Returns the cudaError_t of the launch.
extern "C" int sst_iir(const float* x, const float* init, float* y,
                       float* fin, int R, int B, float slew, int backward,
                       void* stream) {
  if (R > 0 && B > 0) {
    const int threads = 128;
    iir_kernel<<<(R + threads - 1) / threads, threads, 0,
                 (cudaStream_t)stream>>>(x, init, y, fin, R, B, slew,
                                         backward);
  }
  return (int)cudaGetLastError();
}
