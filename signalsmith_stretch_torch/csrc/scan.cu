// Energy slew smoothing (kernel C): the first-order recurrence along bins
//   y_b = y_{b-1} + (x_b - y_{b-1}) * slew        (y_{-1} = init)
// run forward or backward over every row (signalsmith-stretch.h:816-848),
// as a chain of passes in one launch: the planner's smoothing is four
// (backward, forward, backward, forward), each from the previous pass's
// last value; the freqEstimate chains over blocks are one forward pass.
//
// Replaces signalsmith_stretch_tpu/ops/scan_ops.py:60-92 (iir_forward /
// iir_backward), which on the TPU are log-depth lax.associative_scan
// compositions (not a Pallas kernel; PyTorch has no such scan).
//
// Bound on this card: the chain, B dependent steps of three float32
// operations a pass (~28 us a pass at B = 4096), not the bytes (reading the
// plane once and writing it once takes ~0.026 ms at [2680, 4096]).  The
// design is the shared chain kernel of csrc/chain.cuh: one lane a row,
// tiles of 32 rows staged through shared memory by copying warps, every
// pass in one launch.  The update keeps the reference's order, subtract,
// multiply, add, each rounded (--fmad=false): bit-equal to the plain loop.
#include "chain.cuh"

struct SlewStep {
  float slew;
  __device__ __forceinline__ float operator()(float v, float x) const {
    return v + (x - v) * slew;
  }
};

struct SlewOp {
  float slew;
  __device__ __forceinline__ void load(long long) {}
  __device__ __forceinline__ float run(float* row, int w, float v,
                                       int flags) const {
    return (flags & 1) ? chain::run_tile<true>(row, w, v, SlewStep{slew})
                       : chain::run_tile<false>(row, w, v, SlewStep{slew});
  }
};

// x, y [R, B] f32 (distinct); init, fin [R] f32; walk the step table of
// ops/scan_ops.chain_walk on the card ([nsteps][8] int32, pass flags bit 0
// backward) needing `slots` ring slots.  Returns the cudaError_t of the
// launch.
extern "C" int sst_iir_chain(const float* x, const float* init, float* y,
                             float* fin, int R, int B, float slew,
                             const int* walk, int nsteps, int slots, int tile,
                             int lead, void* stream) {
  return chain::launch(x, init, y, fin, R, B, walk, nsteps, slots, tile, lead,
                       SlewOp{slew}, (cudaStream_t)stream);
}
