// K5 and K7: exact Euclidean distance transform by jump flooding, for
// sm_90a, over row bands staged in shared memory.
//
// It replaces both of resuneta_tpu/ops/pallas/jfa.py's kernels: K5, the
// whole-plane flood distance_transform_edt_pallas -> _edt_kernel (the
// pallas_call at :291), and K7, the row-tiled flood
// distance_transform_edt_pallas_tiled -> _tiled_impl -> _edt_pass_kernel
// (the pallas_call at :221). For each (H, W) plane of P int32 planes it
// gives the distance of every nonzero pixel to the nearest zero pixel, as
// f32, bit-identical to resuneta_tpu/ops/distance.py:
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
// --use_fast_math), as XLA's sqrt is. It runs K7's filtered schedule
// (jfa.py:214): a step s >= H and >= W finds every candidate outside the
// plane (-1, never better), so dropping it changes nothing.
//
// What bounds it. Per pass a pixel reads 9 seeds and writes one: 40 bytes,
// and 10-12 passes at 256^2-1024^2. The function itself moves 8 bytes a
// pixel (int32 in, f32 out) and does ~1,000 integer operations a pixel:
// operations bound on paper, latency of the dependent passes in practice.
//
// The design: one launch per pass over all planes, ping-pong between two
// int32 seed buffers in device memory (Jacobi by construction, never in
// place); the first launch builds the seeds from the input, the last writes
// distances. A 256^2 int32 plane is 256 KB, more than a block's 227 KB of
// shared memory, so no plane stays on chip across passes; at 512 and 1024
// px a seed buffer is 42 MB (84 MB with its twin), past the 50 MB L2 too.
// A pass samples rows at exactly {-s, 0, +s}, so a block owns (plane,
// `tile` rows x W), stages those three row bands of the pass-start seeds in
// shared memory once (-1 outside the plane), takes the 9 candidates from
// there and writes its rows of the next seed buffer: each seed is read
// three times a pass instead of nine. When s < tile the bands overlap and
// merge into one window of tile + 2s rows; the row bands collapse to the
// middle one when s >= H, the column candidates when s >= W, as in
// _pass_offsets (jfa.py:117-121). Shared memory: 12 * tile * W bytes at
// most. The threads sweep whole rows and the seeds are packed as
// (i << 16) | j, so no integer division (~20 instructions on this card) is
// left per pixel. On an H100 this pass beat K5's first design (one thread
// a pixel, nine reads from device memory or L2) at 256^2, 512^2 and 1024^2
// alike, so every plane takes it.

#include <cuda_runtime.h>

namespace {

constexpr int BIG = 1 << 30;
constexpr int THREADS = 256;
constexpr int MAX_SMEM = 232448;   // the 227 KB a block may have

// A seed is the packed (i << 16) | j of a zero pixel (no division to
// unpack it; the reference holds p = i*W + j), -1 for none. Only the
// squared distances and their order reach the output, so the two encodings
// give the same result.
__device__ __forceinline__ int d2_of(int s, int i, int j) {
  if (s < 0) return BIG;
  const int si = s >> 16, sj = s & 0xFFFF;
  return (i - si) * (i - si) + (j - sj) * (j - sj);
}

__global__ void __launch_bounds__(THREADS)
jfa_init(const int* __restrict__ in, int* __restrict__ seed, long long total, int W, int HW) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;
  const int p = (int)(idx % HW);
  seed[idx] = in[idx] != 0 ? -1 : ((p / W) << 16) | (p % W);
}

// Shared-memory rows of a pass: the window when the bands merge (s <
// tile), else three bands of `tile` rows; one band when s >= H.
__host__ __device__ __forceinline__ int staged_rows(int H, int s, int tile) {
  return s >= H ? tile : (s < tile ? tile + 2 * s : 3 * tile);
}

// Block (plane blockIdx.x, band blockIdx.y) of one pass at step s. The
// threads sweep rows, tpr threads a row and rps rows a sweep, so no
// index is divided per pixel.
__global__ void __launch_bounds__(THREADS)
jfa_pass(const int* __restrict__ prev, int* __restrict__ next, int H, int W, int s, int tile) {
  extern __shared__ int sm[];
  const long long base = (long long)blockIdx.x * H * W;
  const int r0 = blockIdx.y * tile;
  const int rows = min(tile, H - r0);
  const bool row_cands = s < H, col_cands = s < W;
  const bool merged = s < tile;
  // band a (di = a * s) starts at shared row (a + 1) * off
  const int off = !row_cands ? 0 : (merged ? s : tile);
  const int tpr = min(W, THREADS), rps = THREADS / tpr;
  const int tr = threadIdx.x / tpr, tc = threadIdx.x - tr * tpr;
  const bool sweeps = tr < rps;

  // stage: shared row r holds global row g, -1 outside the plane
  const int nrows = staged_rows(H, s, tile);
  for (int r = tr; sweeps && r < nrows; r += rps) {
    int g = r0 + r;
    bool in_band = true;
    if (row_cands && merged) {
      g = r0 - s + r;
    } else if (row_cands) {
      const int k = r / tile, w = r - k * tile;
      g = r0 + (k - 1) * s + w;
      in_band = w < rows;
    }
    int* dst = sm + r * W;
    if (in_band && g >= 0 && g < H) {
      const int* src = prev + base + (long long)g * W;
      for (int j = tc; j < W; j += tpr) dst[j] = src[j];
    } else {
      for (int j = tc; j < W; j += tpr) dst[j] = -1;
    }
  }
  __syncthreads();

  for (int w = tr; sweeps && w < rows; w += rps) {
    const int i = r0 + w;
    const int* mid = sm + (off + w) * W;
    int* out = next + base + (long long)i * W;
    for (int j = tc; j < W; j += tpr) {
      int seed = mid[j];
      int best = d2_of(seed, i, j);
#pragma unroll
      for (int a = -1; a <= 1; ++a) {
        if (a != 0 && !row_cands) continue;
        const int* row = sm + ((a + 1) * off + w) * W;
#pragma unroll
        for (int b = -1; b <= 1; ++b) {
          if ((a == 0 && b == 0) || (b != 0 && !col_cands)) continue;
          const int jj = j + b * s;
          const int ns = (jj >= 0 && jj < W) ? row[jj] : -1;
          const int cand = d2_of(ns, i, j);
          if (cand < best) {
            seed = ns;
            best = cand;
          }
        }
      }
      out[j] = seed;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
jfa_finish(const int* __restrict__ seed, float* __restrict__ out, long long total, int H,
           int W) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;
  const int p = (int)(idx % ((long long)H * W));
  const int i = p / W, j = p - (p / W) * W;
  out[idx] = sqrtf((float)d2_of(seed[idx], i, j));
}

// The 1+JFA+1 schedule of resuneta_tpu/ops/pallas/jfa.py _jfa_steps
// without the steps s >= H and >= W (jfa.py:214).
int schedule(int H, int W, int* steps) {
  int n = 0, step = 1;
  const int longest = H > W ? H : W;
  while (step < longest) step <<= 1;
  steps[n++] = 1;
  for (; step >= 1; step >>= 1)
    if (step < longest) steps[n++] = step;
  steps[n++] = 1;
  return n;
}

}  // namespace

// K5 and K7. in: (P, H, W) int32; out: (P, H, W) f32; work: 2 * P * H * W
// int32; bands of `tile` rows, 12 * tile * W bytes of shared memory at most
// (<= 232,448), H < 32768 (packed seeds). Adds the number of kernels it
// launched to *launched (one a pass plus two: 12 at 256^2, 13 at 512^2, 14
// at 1024^2) and returns the first cudaError_t of the launches.
extern "C" int jfa_edt(const void* in, void* out, void* work, int P, int H, int W, int tile,
                       int* launched, void* stream) {
  if (P <= 0 || H <= 0 || W <= 0 || H > 32767 || W > 65535 || tile <= 0 ||
      (H + tile - 1) / tile > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = (long long)P * H * W;
  const unsigned grid = (unsigned)((total + THREADS - 1) / THREADS);
  int* buf[2] = {static_cast<int*>(work), static_cast<int*>(work) + total};
  int steps[64];
  const int n = schedule(H, W, steps);
  int smem = 0;
  for (int k = 0; k < n; ++k) {
    const long long b = (long long)staged_rows(H, steps[k], tile) * W * 4;
    if (b > MAX_SMEM) return (int)cudaErrorInvalidValue;
    if (b > smem) smem = (int)b;
  }
  cudaError_t err =
      cudaFuncSetAttribute(jfa_pass, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;

  jfa_init<<<grid, THREADS, 0, st>>>(static_cast<const int*>(in), buf[0], total, W, H * W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ++*launched;

  const dim3 bands((unsigned)P, (unsigned)((H + tile - 1) / tile));
  int cur = 0;
  for (int k = 0; k < n; ++k) {
    jfa_pass<<<bands, THREADS, (size_t)staged_rows(H, steps[k], tile) * W * 4, st>>>(
        buf[cur], buf[1 - cur], H, W, steps[k], tile);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launched;
    cur = 1 - cur;
  }
  jfa_finish<<<grid, THREADS, 0, st>>>(buf[cur], static_cast<float*>(out), total, H, W);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return (int)err;
}
