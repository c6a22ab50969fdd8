// K5: exact Euclidean distance transform by jump flooding, whole planes,
// for sm_90a.
//
// Replaces resuneta_tpu/ops/pallas/jfa.py: distance_transform_edt_pallas ->
// _edt_kernel (the pallas_call at :291). For each (H, W) plane of P int32
// planes it gives the distance of every nonzero pixel to the nearest zero
// pixel, as f32, bit-identical to resuneta_tpu/ops/distance.py:
//
//   seed = p (= i*W + j) at zero pixels, -1 elsewhere
//   for s in 1, 2^k .. 2, 1, 1 (2^k >= max(H, W)):        (1+JFA+1)
//     for each pixel, from the PASS-START seeds (Jacobi):
//       best = d2(seed here); for (di, dj) in {-s,0,s}^2 \ (0,0), in order:
//         cand = d2(seed at (i+di, j+dj), -1 outside the plane)
//         if cand < best: take it                        (strict: first wins)
//   out = sqrtf(float(d2(seed))),  d2(-1) = 2^30
//
// Ties between equally distant seeds go to the first candidate in the
// (di, dj) order, and a later pass propagates that seed, so the order and
// the strict < reach the output: both are kept. sqrtf is IEEE (no
// --use_fast_math), as XLA's sqrt is.
//
// What bounds it. Per pass a pixel reads 9 seeds and writes one: 40 bytes,
// and ~11 passes at 256^2. The function itself moves 8 bytes a pixel (int32
// in, f32 out) and does ~1,000 integer operations a pixel: operations
// bound on paper, latency of the dependent passes in practice.
//
// Design: one launch per pass over all planes, ping-pong between two int32
// seed buffers in device memory (Jacobi by construction, never in place).
// A 256^2 int32 plane is 256 KB, more than a block's 227 KB of shared
// memory, and a 17-bit seed has no narrower type; the 80 planes of a
// 16 x 5-class batch are 21 MB, which stays in the 50 MB L2 between passes,
// so the passes read L2, not HBM. One thread per pixel fills the card. The
// first pass builds the seeds from the input, the last writes distances.

#include <cuda_runtime.h>

namespace {

constexpr int BIG = 1 << 30;
constexpr int THREADS = 256;

__device__ __forceinline__ int d2_of(int s, int i, int j, int W) {
  if (s < 0) return BIG;
  const int si = s / W, sj = s - si * W;
  return (i - si) * (i - si) + (j - sj) * (j - sj);
}

__global__ void __launch_bounds__(THREADS)
jfa_init(const int* __restrict__ in, int* __restrict__ seed, long long total, int HW) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;
  seed[idx] = in[idx] != 0 ? -1 : (int)(idx % HW);
}

__global__ void __launch_bounds__(THREADS)
jfa_pass(const int* __restrict__ prev, int* __restrict__ next, long long total, int H,
         int W, int s) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;
  const int HW = H * W;
  const int p = (int)(idx % HW);
  const int* plane = prev + (idx - p);
  const int i = p / W, j = p - (p / W) * W;
  int seed = plane[p];
  int best = d2_of(seed, i, j, W);
#pragma unroll
  for (int a = -1; a <= 1; ++a) {
#pragma unroll
    for (int b = -1; b <= 1; ++b) {
      if (a == 0 && b == 0) continue;
      const int ii = i + a * s, jj = j + b * s;
      const int ns = (ii >= 0 && ii < H && jj >= 0 && jj < W) ? plane[ii * W + jj] : -1;
      const int cand = d2_of(ns, i, j, W);
      if (cand < best) {
        seed = ns;
        best = cand;
      }
    }
  }
  next[idx] = seed;
}

__global__ void __launch_bounds__(THREADS)
jfa_finish(const int* __restrict__ seed, float* __restrict__ out, long long total, int H,
           int W) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;
  const int p = (int)(idx % ((long long)H * W));
  const int i = p / W, j = p - (p / W) * W;
  out[idx] = sqrtf((float)d2_of(seed[idx], i, j, W));
}

}  // namespace

// in: (P, H, W) int32; out: (P, H, W) f32; work: 2 * P * H * W int32.
// Adds the number of kernels it launched to *launched (one a pass plus
// two: 13 at 256^2) and returns the first cudaError_t of the launches.
extern "C" int jfa_edt(const void* in, void* out, void* work, int P, int H, int W,
                       int* launched, void* stream) {
  if (P <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = (long long)P * H * W;
  const unsigned grid = (unsigned)((total + THREADS - 1) / THREADS);
  int* buf[2] = {static_cast<int*>(work), static_cast<int*>(work) + total};

  jfa_init<<<grid, THREADS, 0, st>>>(static_cast<const int*>(in), buf[0], total, H * W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launched;

  // the 1+JFA+1 schedule of resuneta_tpu/ops/pallas/jfa.py _jfa_steps
  int steps[64], n = 0, step = 1;
  const int longest = H > W ? H : W;
  while (step < longest) step <<= 1;
  steps[n++] = 1;
  for (; step >= 1; step >>= 1) steps[n++] = step;
  steps[n++] = 1;

  int cur = 0;
  for (int k = 0; k < n; ++k) {
    jfa_pass<<<grid, THREADS, 0, st>>>(buf[cur], buf[1 - cur], total, H, W, steps[k]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
    cur = 1 - cur;
  }
  jfa_finish<<<grid, THREADS, 0, st>>>(buf[cur], static_cast<float*>(out), total, H, W);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return (int)err;
}
