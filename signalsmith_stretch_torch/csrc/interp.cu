// Fractional-bin interpolation of several planes at several position sets.
//
// Replaces the TPU kernel signalsmith_stretch_tpu/ops/pallas/interp.py
// (interp_multi -> _call -> kernel).  The TPU version kept one row's planes
// in VMEM, cut a window around each 128-bin chunk and selected the taps with
// one-hot matrix products, counting taps that fell outside the window.
//
// Contract (set s reads the first nsel planes at positions pos[row, s, :]):
//   lo = planes[row, j, floor(pos)], hi = planes[row, j, floor(pos) + 1],
//   zero outside [0, W0); out = lo + (hi - lo) * frac (lerp mode) or the raw
//   (lo, hi) pair (taps mode).  There is no capacity window here, so the
//   wrapper reports 0 violations.
//
// Bound on this card: bytes.  Each output element costs up to two 4-byte tap
// reads and one write against 3 flops, far below the H100's ~20 flop/byte
// balance point.  Design: one thread per (row, set, output bin), looping
// over the set's planes; neighbouring threads read neighbouring, nearly
// monotone taps, so the loads coalesce and L1/L2 absorb the overlap between
// the sets of a row.  Built with --fmad=false: the lerp rounds after the
// subtract, the multiply and the add, exactly as the plain PyTorch version.
#include <cuda_runtime.h>

#define MAX_SETS 8

struct Sets {
  int nsel[MAX_SETS];   // planes read by the set
  int taps[MAX_SETS];   // 1: write the (lo, hi) pair, 0: the lerp
  int off[MAX_SETS];    // first output plane of the set
};

__global__ void interp_multi_kernel(const float* __restrict__ planes,
                                    const float* __restrict__ pos,
                                    float* __restrict__ out, Sets sets,
                                    int n, int W0, int B, int nsets,
                                    int nout) {
  const long long row = blockIdx.x;
  const int s = blockIdx.y;
  const int nsel = sets.nsel[s], taps = sets.taps[s], o = sets.off[s];
  const float* prow = planes + row * n * (long long)W0;
  const float* posr = pos + (row * nsets + s) * (long long)B;
  float* orow = out + row * nout * (long long)B;
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const float p = posr[b];
    const float low = floorf(p);
    const float frac = p - low;
    // validity from the float floor, so a NaN position reads zeros
    const bool vlo = low >= 0.f && low < (float)W0;
    const bool vhi = low >= -1.f && low < (float)(W0 - 1);
    const int li = vlo ? (int)low : 0;
    const int hi_i = vhi ? (int)low + 1 : 0;
    for (int j = 0; j < nsel; ++j) {
      const float lo = vlo ? prow[(long long)j * W0 + li] : 0.f;
      const float hi = vhi ? prow[(long long)j * W0 + hi_i] : 0.f;
      if (taps) {
        orow[(long long)(o + j) * B + b] = lo;
        orow[(long long)(o + nsel + j) * B + b] = hi;
      } else {
        orow[(long long)(o + j) * B + b] = lo + (hi - lo) * frac;
      }
    }
  }
}

// planes [rows, n, W0] f32, pos [rows, nsets, B] f32, out [rows, nout, B]
// f32; meta (host memory) holds (nsel, taps, output plane offset) per set.
// Returns the cudaError_t of the launch.
extern "C" int sst_interp_multi(const float* planes, const float* pos,
                                const int* meta, float* out, int rows, int n,
                                int W0, int B, int nsets, int nout,
                                void* stream) {
  if (nsets < 1 || nsets > MAX_SETS) return (int)cudaErrorInvalidValue;
  if (rows <= 0 || B <= 0) return 0;
  Sets sets = {};
  for (int s = 0; s < nsets; ++s) {
    sets.nsel[s] = meta[3 * s];
    sets.taps[s] = meta[3 * s + 1];
    sets.off[s] = meta[3 * s + 2];
  }
  dim3 grid(rows, nsets);
  interp_multi_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      planes, pos, out, sets, n, W0, B, nsets, nout);
  return (int)cudaGetLastError();
}
