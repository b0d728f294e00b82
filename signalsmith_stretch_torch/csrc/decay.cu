// Formant envelope decay passes (kernel E): the recurrence along bins
//   y_b = op(x_b, d * y_{b-1})        (y_{-1} = init, d one value per row)
// run forward or backward over every row, with op the C++ selection
//   max: (x_b < t) ? t : x_b          min: (t < x_b) ? t : x_b
// so a NaN product t (d = inf on a silent row, times 0) is discarded
// (signalsmith-stretch.h:984-1007).  The envelope's eight passes run as one
// chain in one launch: max backward, forward, backward, forward with the
// decay, then min with its inverse, each from the previous pass's last
// value.
//
// Replaces signalsmith_stretch_tpu/ops/scan_ops.py:95-148 (_decay_scan:
// decay_max_forward/backward, decay_min_forward/backward), which on the TPU
// are log-depth lax.associative_scan compositions (not a Pallas kernel;
// PyTorch has no such scan).
//
// Bound on this card: the chain, B dependent steps of a multiply, a compare
// and a select a pass (~28 us a pass at B = 4096), not the bytes (~0.026 ms
// to read the plane once and write it once at [2680, 4096]).  The design is
// the shared chain kernel of csrc/chain.cuh: one lane a row, tiles of 32
// rows staged through shared memory by copying warps, every pass in one
// launch; the lane keeps its row's two coefficients in registers.  The
// selections are written as above, not fmaxf/fminf, which differ when x_b
// is NaN: bit-equal to the plain loop.
#include "chain.cuh"

template <bool IS_MIN>
struct DecayStep {
  float d;
  __device__ __forceinline__ float operator()(float v, float a) const {
    const float t = d * v;
    if (IS_MIN) return (t < a) ? t : a;
    return (a < t) ? t : a;
  }
};

// pass flags: bit 0 backward, bit 1 min (else max), bit 2 the second
// coefficient row (ops/scan_ops.BACKWARD, MIN, COEF1)
struct DecayOp {
  const float* c0;
  const float* c1;
  float d0, d1;
  __device__ __forceinline__ void load(long long r) {
    d0 = c0[r];
    d1 = c1[r];
  }
  __device__ __forceinline__ float run(float* row, int w, float v,
                                       int flags) const {
    const float d = (flags & 4) ? d1 : d0;
    switch (flags & 3) {
      case 0: return chain::run_tile<false>(row, w, v, DecayStep<false>{d});
      case 1: return chain::run_tile<true>(row, w, v, DecayStep<false>{d});
      case 2: return chain::run_tile<false>(row, w, v, DecayStep<true>{d});
      default: return chain::run_tile<true>(row, w, v, DecayStep<true>{d});
    }
  }
};

// x, y [R, B] f32 (distinct); init, coef0, coef1, fin [R] f32; walk the
// step table of ops/scan_ops.chain_walk on the card ([nsteps][8] int32)
// needing `slots` ring slots.  Returns the cudaError_t of the launch.
extern "C" int sst_decay_chain(const float* x, const float* init,
                               const float* coef0, const float* coef1,
                               float* y, float* fin, int R, int B,
                               const int* walk, int nsteps, int slots,
                               int tile, int lead, void* stream) {
  return chain::launch(x, init, y, fin, R, B, walk, nsteps, slots, tile, lead,
                       DecayOp{coef0, coef1, 0.f, 0.f}, (cudaStream_t)stream);
}
