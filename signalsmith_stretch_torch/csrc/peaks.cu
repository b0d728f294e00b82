// The peaks and output map (kernel G): per row of energy and its smoothed
// curve [R, B], the runs of bins where energy > smoothed (the peaks), each
// run's sums of b*energy[b] and energy[b], its average band and that band
// through the frequency map with its tonality limit, then for every bin the
// input bin and the gradient of the output map: the smoothstep between the
// two peaks around it, and the bottom, top and no-peak rules
// (signalsmith-stretch.h:859-917; plain version spectral._peaks_and_map).
//
// Replaces signalsmith_stretch_tpu/spectral.py:260-319, _peaks_and_map (not
// a Pallas kernel: two jax.ops.segment_sum calls, a scatter histogram and
// gathers; on the TPU ops/interp.py:_peaks_and_map_batched runs the sums as
// an MXU matmul).  No single PyTorch call computes it.
//
// Order.  Each run's two sums add bin-ascending from 0.0f, ((0 + x_a) +
// x_{a+1}) + ..., in float32: the C++ `+=` order, and the order of the plain
// version's index_put_ on the CPU.  One thread sums a whole run, with no
// tree and no atomics, so the sums do not depend on the launch.  The other
// expressions keep the plain version's order, operation for operation, and
// the build's --fmad=false keeps every product and sum rounded on its own.
// The plain version divides by N as a tensor by a Python scalar, which the
// card computes as a product with 1/N: N is a power of two (the wrapper
// requires it), so the two agree with the division here.  Inputs are
// finite: the plain version casts ceil(peak_out) to an integer, which has no
// value for a NaN.
//
// Bound on this card: bytes, 16 per bin (two inputs read, two outputs
// written once), 0.052 ms at [2680, 4096].  Design: one CTA a row; the row's
// energy and its above-flags are staged in shared memory; a block prefix
// over the run-start flags gives each run its id and its first and last bin;
// then runs are the parallel axis (thread s sums runs s, s + T, ... in a
// counted loop); the histogram of ceil(peak_out) is built with shared-memory
// integer atomics (exact in any order) over the row's staged energy, and a
// second block prefix turns it into k[b], the number of peaks whose output
// is at most b; the peak tables stay in shared memory for the per-bin map,
// which reads and writes with neighbouring threads on neighbouring bins.
#include <cuda_runtime.h>

#define PEAKS_THREADS 256

// exclusive prefix of v over the block; *total gets the block's sum.  tmp
// holds one int a warp and must not be in use by another scan.
__device__ __forceinline__ int block_exclusive_scan(int v, int* tmp,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? tmp[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nw) tmp[lane] = w;
  }
  __syncthreads();
  *total = tmp[nw - 1];
  return (warp ? tmp[warp - 1] : 0) + x - v;
}

// shared memory, in 4-byte words: energy then the histogram (B + 1), the
// above-flags (B bytes), then the run tables (two of (B + 1) / 2 entries)
__host__ __device__ __forceinline__ int peaks_smem_words(int B) {
  return B + 1 + (B + 3) / 4 + 2 * ((B + 1) / 2);
}

__global__ void __launch_bounds__(PEAKS_THREADS)
peaks_map_kernel(const float* __restrict__ energy,
                 const float* __restrict__ smoothed,
                 float* __restrict__ input_bin, float* __restrict__ freq_grad,
                 int B, float N, float limit, float mult, float above_off) {
  extern __shared__ float smem[];
  __shared__ int scan_runs[32], scan_hist[32];
  const int max_runs = (B + 1) / 2;
  float* E = smem;                                   // energy, B
  int* H = reinterpret_cast<int*>(smem);             // histogram, B + 1
  unsigned char* above = reinterpret_cast<unsigned char*>(smem + B + 1);
  int* first = reinterpret_cast<int*>(smem + B + 1 + (B + 3) / 4);
  int* last = first + max_runs;
  // thread s reads first[s] and last[s] before it writes peak s: the peak
  // tables take their places
  float* peak_in = reinterpret_cast<float*>(first);
  float* peak_out = reinterpret_cast<float*>(last);

  const int T = blockDim.x, tid = threadIdx.x;
  const long long off = (long long)blockIdx.x * B;
  for (int b = tid; b < B; b += T) {
    const float e = energy[off + b];
    E[b] = e;
    above[b] = e > smoothed[off + b];
  }
  __syncthreads();

  // runs: thread t owns the bins [lo, hi); a run starts where a bin is
  // above and the one before is not, and ends where the one after is not
  const int C = (B + T - 1) / T;
  const int lo = min(tid * C, B), hi = min(lo + C, B);
  int starts = 0;
  for (int b = lo; b < hi; ++b)
    starts += above[b] && !(b > 0 && above[b - 1]);
  int n_peaks;
  int id = block_exclusive_scan(starts, scan_runs, &n_peaks);
  for (int b = lo; b < hi; ++b) {
    if (!above[b]) continue;
    if (b == 0 || !above[b - 1]) first[id++] = b;
    if (b == B - 1 || !above[b + 1]) last[id - 1] = b;   // the open run
  }
  __syncthreads();

  // each run's sums, bin-ascending from 0, and its peak
  for (int s = tid; s < n_peaks; s += T) {
    const int a = first[s], z = last[s];
    float band_sum = 0.f, energy_sum = 0.f;
#pragma unroll 4
    for (int b = a; b <= z; ++b) {
      const float x = E[b];
      band_sum = band_sum + (float)b * x;
      energy_sum = energy_sum + x;
    }
    const float avg = band_sum / (energy_sum == 0.f ? 1.f : energy_sum);
    const float freq = (avg + 0.5f) / N;
    const float mapped = freq > limit ? freq + above_off : freq * mult;
    peak_in[s] = avg;
    peak_out[s] = mapped * N - 0.5f;
  }
  __syncthreads();

  // k[b] = #peaks with output <= b: the histogram of ceil(output), clamped
  // to [0, B], and its inclusive prefix, over the staged energy's place
  for (int b = tid; b <= B; b += T) H[b] = 0;
  __syncthreads();
  for (int s = tid; s < n_peaks; s += T) {
    const float c = fminf(fmaxf(ceilf(peak_out[s]), 0.f), (float)B);
    atomicAdd(&H[(int)c], 1);
  }
  __syncthreads();
  int count = 0;
  for (int b = lo; b < hi; ++b) count += H[b];
  int peaks_total;
  int k = block_exclusive_scan(count, scan_hist, &peaks_total);
  for (int b = lo; b < hi; ++b) {
    k += H[b];
    H[b] = k;
  }
  __syncthreads();

  // the per-bin map; slots past the last peak read as the plain version's
  // padding (input 0, output +inf)
  const float inf = __int_as_float(0x7f800000);
  const int nseg = B / 2 + 2;
  const float first_in = n_peaks > 0 ? peak_in[0] : 0.f;
  const float first_out = n_peaks > 0 ? peak_out[0] : inf;
  const int top = max(n_peaks - 1, 0);
  const float last_in = n_peaks > 0 ? peak_in[top] : 0.f;
  const float last_out = n_peaks > 0 ? peak_out[top] : 0.f;
  const int top_start = max((int)last_out, 0);   // truncation, as .to(int32)
  for (int b = tid; b < B; b += T) {
    const float fb = (float)b;
    float ib, grad = 1.f;
    if (n_peaks == 0) {
      ib = fb;
    } else if (b >= top_start) {            // the top rule runs last in C++
      ib = fb + (last_in - last_out);
    } else if (H[b] == 0) {                 // below the first peak
      ib = fb + (first_in - first_out);
    } else {
      const int kb = H[b];
      const int pi = min(max(kb - 1, 0), nseg - 1);
      const int ni = min(max(kb, 0), nseg - 1);
      const float prev_o = pi < n_peaks ? peak_out[pi] : inf;
      const float prev_in = pi < n_peaks ? peak_in[pi] : 0.f;
      const float next_o = ni < n_peaks ? peak_out[ni] : inf;
      const float next_in = ni < n_peaks ? peak_in[ni] : 0.f;
      const float range_scale = 1.f / (next_o - prev_o);
      const float out_offset = prev_in - prev_o;
      const float out_scale = ((next_in - next_o) - prev_in) + prev_o;
      const float grad_scale = out_scale * range_scale;
      const float r = (fb - prev_o) * range_scale;
      const float h = (r * r) * (3.f - 2.f * r);
      ib = (fb + out_offset) + h * out_scale;
      grad = 1.f + ((6.f * r) * (1.f - r)) * grad_scale;
    }
    input_bin[off + b] = ib;
    freq_grad[off + b] = grad;
  }
}

// energy, smoothed, input_bin, freq_grad [R, B] f32; N the FFT size; limit,
// mult and above_off = f32(f32(mult - 1) * limit) the frequency map's
// float32 constants.  Returns the cudaError_t of the launch.
extern "C" int sst_peaks_map(const float* energy, const float* smoothed,
                             float* input_bin, float* freq_grad, int R, int B,
                             int N, float limit, float mult, float above_off,
                             void* stream) {
  if (R <= 0 || B <= 0) return 0;
  const size_t bytes = 4 * (size_t)peaks_smem_words(B);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        peaks_map_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  peaks_map_kernel<<<R, PEAKS_THREADS, bytes, (cudaStream_t)stream>>>(
      energy, smoothed, input_bin, freq_grad, B, (float)N, limit, mult,
      above_off);
  return (int)cudaGetLastError();
}
