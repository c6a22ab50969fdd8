// K5 and K7: exact Euclidean distance transform by jump flooding, for
// sm_90a: whole planes in the shared memory of a thread block cluster, or
// banded large-step passes and a fused small-step tail.
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
// Seeds are packed as (i << 16) | j, so no integer division (~20
// instructions on this card) is left per pixel, and "no seed" is NONE, the
// packed point (FAR, FAR): for planes up to MAX_SIDE its d2 from any pixel
// is larger than any real one and fits an int, so it loses every
// comparison as -1 does without a branch of its own; only the distance
// written at the end maps it back to 2^30.
//
// What bounds it: operations. Per pass a pixel weighs 8 candidates, ~10
// integer instructions each (unpack, two differences, d2, compare, take),
// at 10-12 passes: ~1,000 integer operations a pixel against 8 bytes of
// input and output. The first design (one launch a pass over bands of rows,
// two int32 seed buffers in device memory: 21 MB each at 256^2 x 80, 42 MB
// at 512^2 x 40 and 1024^2 x 10) also paid a launch and a round trip of the
// seeds through L2 or HBM every pass, and its init and finish launches. On
// an H100 the passes turned out paced by instructions, in both kernels
// alike, more than by those round trips: a row's set-up (its owner and
// pointers) where a thread took one column, then the candidate loop. So a
// thread takes several columns of a row; the loop is kept free of branches
// (clamped columns, a row of NONE for rows outside the plane, selects) so
// that most of its instructions are the d2s; and a pixel that is its own
// seed (a zero pixel: d2 0, nothing nearer; most of a class plane's
// pixels) loads and weighs no candidate.
//
// The design.
// (a) jfa_cluster over a whole plane (the 256^2 planes of the 256 px step):
//     a cluster of cs blocks holds the plane's seeds in shared memory, R =
//     ceil(H / cs) rows a block, twice (Jacobi: pass k reads buffer k % 2
//     and writes the other, one cluster barrier a pass). A candidate row
//     owned by another block is read through distributed shared memory
//     (cluster.map_shared_rank: a generic pointer, so a row of any block is
//     read by the same loads); a thread takes U = 2 rows at once, so that
//     their candidate loads are in flight together. The seeds are formed
//     from the int32 input while it is staged and the distances written by
//     the last pass: one launch a call, the input read once and the output
//     written once.
// (b) Planes whose two seed buffers pass 8 blocks' shared memory (512^2 is
//     2 MB, 1024^2 8 MB): the leading step-1 pass, which forms the seeds
//     from the input as it stages it, and the steps above TAIL
//     (ops/distance.py) run as banded passes (jfa_pass, below) through two
//     seed buffers in device memory; the steps up to it (4, 2, 1, 1) run in one
//     jfa_cluster launch over bands of `band` rows. A band's window holds
//     halo = the sum of those steps rows beyond it on each side (its rows
//     inside the plane); each pass computes the band and the rows a side
//     that later passes still read, which shrink by the pass's step, so
//     the band's rows leave the last pass exact. Rows beyond the plane's
//     edge are none; a window edge inside the plane is never read by a row
//     that is computed. 1 + (large steps) + 1 launches: 8 at 512^2, 9 at
//     1024^2.
// jfa_pass: a block owns (plane, `tile` rows x W), stages the three row
// bands {-s, 0, +s} of the pass-start seeds in shared memory once (NONE
// outside the plane), takes the 9 candidates from there and writes its rows
// of the next seed buffer: each seed is read three times a pass instead of
// nine. When s < tile the bands merge into one window of tile + 2s rows.
//
// Tried and taken out (chip runs on an H100): one thread a pixel with nine
// reads from device memory (slower than the banded pass at every size);
// separate init and finish launches (folded into the first and last pass);
// skipping a candidate equal to the current seed (a branch a candidate:
// slower); per-load branches between local and remote rows with
// ld.shared::cluster (slower: the branches, not the remote reads, cost);
// plain shared loads for the block's own rows beside generic ones for
// remote rows (slower); U = 1 and U = 4 (fewer loads in flight; spills);
// skipping only the weighing for a pixel that is its own seed (the loads
// kept: about the same); d2 in f32 from converted coordinates (slower); a
// fused tail of the steps up to 16 or 8 (no faster than 4 at 512^2 and
// 1024^2); one column a thread (the rows' set-up, not the candidates, then
// paced the cluster kernel).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;      // a banded pass's block
constexpr int CTHREADS = 1024;    // a cluster block at most
constexpr int U = 2;              // rows a cluster thread takes at once
// Threads a row: a thread takes every tpr-th column of its rows, so the
// rows' pointers (and in a cluster their owners) are set up once for W /
// tpr pixels, and a warp still reads 32 neighbouring seeds. A cluster
// block gives each thread COLS columns (32 threads a row at 256^2, 128 at
// 1024^2), a banded pass 64 threads a row: the best of 16-256 tried on an
// H100.
constexpr int COLS = 8;
constexpr int TPR_PASS = 64;
constexpr int MAX_SMEM = 232448;   // the 227 KB a block may have
constexpr int MAX_SIDE = 8192;
constexpr int MAX_CLUSTER = 8;     // the portable cluster size
constexpr int MAX_STEPS = 32;
constexpr int BIG = 1 << 30;
// "no seed": the packed point (FAR, FAR). From any pixel of a plane up to
// MAX_SIDE its d2 is at least 2 * (FAR - MAX_SIDE + 1)^2 > 2 * 8191^2, the
// largest real one, and at most 2 * FAR^2 < 2^31.
constexpr int FAR = 0x6000;
constexpr int NONE = (FAR << 16) | FAR;

struct Steps {
  int n;
  int s[MAX_STEPS];
};

__device__ __forceinline__ int pack(int i, int j) { return (i << 16) | j; }

__device__ __forceinline__ int d2_of(int s, int i, int j) {
  const int di = i - (s >> 16), dj = j - (s & 0xFFFF);
  return di * di + dj * dj;
}

// The 9 candidates of pixel (., j) at step s, in the reference's order:
// v[3 * a + b] is the seed at (i + (a - 1) * s, j + (b - 1) * s) from row
// pointer rows[a] (a row of NONE stands for one outside the plane), NONE
// for a column outside the plane. No branch: the column is clamped, the
// load made, the value selected.
__device__ __forceinline__ void gather(const int* const rows[3], int j, int s, int W, int v[9]) {
  const bool okl = j >= s, okr = j + s < W;
  const int jl = okl ? j - s : 0, jr = okr ? j + s : 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int l = rows[a][jl], c = rows[a][j], r = rows[a][jr];
    v[3 * a] = okl ? l : NONE;
    v[3 * a + 1] = c;
    v[3 * a + 2] = okr ? r : NONE;
  }
}

// The seed of pixel (i, j) after a pass from its candidates v (v[4] its
// own): strict <, so the first of equally near candidates wins. Sets best
// to its d2.
__device__ __forceinline__ int pick(const int v[9], int i, int j, int& best) {
  int seed = v[4];
  best = d2_of(seed, i, j);
#pragma unroll
  for (int c = 0; c < 9; ++c) {
    if (c == 4) continue;
    const int cand = d2_of(v[c], i, j);
    if (cand < best) {
      seed = v[c];
      best = cand;
    }
  }
  return seed;
}

__device__ __forceinline__ float distance_of(int seed, int best) {
  return sqrtf((float)(seed == NONE ? BIG : best));
}

// Shared-memory rows of a banded pass: the window when the bands merge (s <
// tile), else three bands of `tile` rows; one band when s >= H.
__host__ __device__ __forceinline__ int staged_rows(int H, int s, int tile) {
  return s >= H ? tile : (s < tile ? tile + 2 * s : 3 * tile);
}

// Block (plane blockIdx.x, band blockIdx.y) of one banded pass at step s,
// from the seeds in prev or, with from_input, from the int32 planes (the
// seeds formed as they are staged). The threads sweep rows, tpr threads a
// row and rps rows a sweep, so no index is divided per pixel.
__global__ void __launch_bounds__(THREADS)
jfa_pass(const int* __restrict__ prev, int from_input, int* __restrict__ next, int H, int W,
         int s, int tile) {
  extern __shared__ int sm[];
  const long long base = (long long)blockIdx.x * H * W;
  const int r0 = blockIdx.y * tile;
  const int rows = min(tile, H - r0);
  const bool row_cands = s < H;
  const bool merged = s < tile;
  // band a (di = a * s) starts at shared row (a + 1) * off
  const int off = !row_cands ? 0 : (merged ? s : tile);
  const int tpr = min(W, TPR_PASS), rps = THREADS / tpr;
  const int tr = threadIdx.x / tpr, tc = threadIdx.x - tr * tpr;
  const bool sweeps = tr < rps;

  // stage: shared row r holds global row g, NONE outside the plane; row
  // nrows is all NONE
  const int nrows = staged_rows(H, s, tile);
  for (int r = tr; sweeps && r <= nrows; r += rps) {
    int g = r0 + r;
    bool in_band = r < nrows;
    if (row_cands && merged) {
      g = r0 - s + r;
    } else if (row_cands) {
      const int k = r / tile, w = r - k * tile;
      g = r0 + (k - 1) * s + w;
      in_band = in_band && w < rows;
    }
    int* dst = sm + r * W;
    if (in_band && g >= 0 && g < H) {
      const int* src = prev + base + (long long)g * W;
      if (from_input) {
        for (int j = tc; j < W; j += tpr) dst[j] = src[j] != 0 ? NONE : pack(g, j);
      } else {
        for (int j = tc; j < W; j += tpr) dst[j] = src[j];
      }
    } else {
      for (int j = tc; j < W; j += tpr) dst[j] = NONE;
    }
  }
  __syncthreads();

  const int* none = sm + nrows * W;
  for (int w = tr; sweeps && w < rows; w += rps) {
    const int i = r0 + w;
    const int* rp[3];   // row i + (a - 1) * s
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int gi = i + (a - 1) * s;
      rp[a] = (gi < 0 || gi >= H) ? none : sm + (a * off + w) * W;
    }
    int* out = next + base + (long long)i * W;
    for (int j = tc; j < W; j += tpr) {
      const int own = rp[1][j];
      if (own == pack(i, j)) {   // its own seed (d2 0): nothing is nearer
        out[j] = own;
      } else {
        int v[9], best;
        gather(rp, j, s, W, v);
        out[j] = pick(v, i, j, best);
      }
    }
  }
}

// A cluster of cs blocks (cluster rank = block rank) over band blockIdx.x
// / cs of plane blockIdx.y: the band's rows [b0, b1) and its window [g0,
// g1) = halo rows more a side inside the plane, R window rows a block,
// two buffers of R x W seeds each in shared memory. Stages the window from
// src (the int32 planes with from_input, else seeds), runs the passes of
// st, writes the band's distances. The whole plane: band = H, halo = 0.
// A thread takes U rows at once, so that their 9 * U candidate loads (many
// of them remote at the large steps) are in flight together. rm is the
// magic of the division by R: n / R = umulhi(n, rm) for R >= 2.
__global__ void __launch_bounds__(CTHREADS)
jfa_cluster(const int* __restrict__ src, int from_input, float* __restrict__ out, int H, int W,
            int band, int halo, int R, unsigned rm, Steps st) {
  extern __shared__ int sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const long long base = (long long)blockIdx.y * H * W;
  const int b0 = (blockIdx.x / cs) * band, b1 = min(H, b0 + band);
  const int g0 = max(0, b0 - halo), g1 = min(H, b1 + halo);
  const int r0 = g0 + rank * R, r1 = min(g1, r0 + R);
  const int nthr = (int)blockDim.x;
  const int tpr = min(min(W, nthr), max(32, W / COLS)), rps = nthr / tpr;
  const int tr = threadIdx.x / tpr, tc = threadIdx.x - tr * tpr;
  const bool sweeps = tr < rps;
  int* none = sm + 2 * R * W;   // a row of NONE after the two buffers

  for (int j = threadIdx.x; j < W; j += nthr) none[j] = NONE;
  for (int g = r0 + tr; sweeps && g < r1; g += rps) {
    const int* s_row = src + base + (long long)g * W;
    int* dst = sm + (g - r0) * W;
    if (from_input) {
      for (int j = tc; j < W; j += tpr) dst[j] = s_row[j] != 0 ? NONE : pack(g, j);
    } else {
      for (int j = tc; j < W; j += tpr) dst[j] = s_row[j];
    }
  }
  cluster.sync();

  // the rows a side of the band that later passes still read; the pass
  // computes the band and those, as far as the window holds them (at the
  // plane's edge, rows beyond it are none)
  int rem = halo;
  for (int k = 0; k < st.n; ++k) {
    const int s = st.s[k];
    rem = max(rem - s, 0);
    const bool last = k == st.n - 1;
    const int lo = max(r0, b0 - rem), hi = min(r1, b1 + rem);
    int* cur = sm + (k & 1) * R * W;
    int* nxt = sm + ((k & 1) ^ 1) * R * W;
    for (int i0 = lo + tr; sweeps && i0 < hi; i0 += U * rps) {
      // row i0 + u * rps, candidate row a: in the shared memory of the
      // block that owns it (a generic pointer), or the NONE row
      const int* rp[U][3];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * rps;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const int gi = i + (a - 1) * s;
          rp[u][a] = none;
          if (i < hi && gi >= 0 && gi < H) {
            const unsigned n = (unsigned)(gi - g0);
            const unsigned owner = R == 1 ? n : __umulhi(n, rm);
            rp[u][a] = cluster.map_shared_rank(cur + (n - owner * R) * W, owner);
          }
        }
      }
      for (int j = tc; j < W; j += tpr) {
        int own[U];
#pragma unroll
        for (int u = 0; u < U; ++u) own[u] = rp[u][1][j];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = i0 + u * rps;
          if (i >= hi) continue;
          // a pixel that is its own seed (d2 0) keeps it: nothing is nearer
          int best = 0, seed = own[u];
          if (seed != pack(i, j)) {
            int v[9];
            gather(rp[u], j, s, W, v);
            seed = pick(v, i, j, best);
          }
          if (last) out[base + (long long)i * W + j] = distance_of(seed, best);
          else nxt[(i - r0) * W + j] = seed;
        }
      }
    }
    // the next pass reads what this one wrote; a block leaves only when no
    // other reads its shared memory
    cluster.sync();
  }
}

}  // namespace

// K5 and K7. in: (P, H, W) int32; out: (P, H, W) f32; steps[0:nsteps]:
// the filtered 1+JFA+1 schedule. The first `nbanded` passes run banded
// (tile rows a block, 4 * (3 * tile + 1) * W bytes of shared memory at
// most; the
// first from the input) through work (2 * P * H * W int32; unused when
// nbanded = 0), the rest in one jfa_cluster launch of clusters of cs
// blocks over bands of `band` rows with `halo` rows a side, R window rows
// and 4 * (2 * R + 1) * W bytes of shared memory a block (band = H, halo
// = 0: the
// whole plane, from the input when nbanded = 0). H, W <= 8192; the caller
// (ops/distance.py plan) chooses the layout. Adds the number of kernels it
// launched to *launched (nbanded + 1) and returns the first cudaError_t.
extern "C" int jfa_edt(const void* in, void* out, void* work, int P, int H, int W,
                       const int* steps, int nsteps, int nbanded, int tile, int cs, int band,
                       int halo, int R, int* launched, void* stream) {
  if (P <= 0 || P > 65535 || H <= 0 || W <= 0 || H > MAX_SIDE || W > MAX_SIDE ||
      nsteps <= nbanded || nsteps - nbanded > MAX_STEPS || nbanded < 0 || cs < 1 ||
      cs > MAX_CLUSTER || band < 1 || halo < 0 || R < 1 ||
      (long long)cs * R < (long long)min(H, band + 2 * halo) ||
      4LL * (2 * R + 1) * W > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = (long long)P * H * W;
  int* buf[2] = {static_cast<int*>(work), static_cast<int*>(work) + total};
  cudaError_t err;

  if (nbanded > 0) {
    if (tile < 1 || (H + tile - 1) / tile > 65535) return (int)cudaErrorInvalidValue;
    int smem = 0;
    for (int k = 0; k < nbanded; ++k) {
      const long long b = (long long)(staged_rows(H, steps[k], tile) + 1) * W * 4;
      if (b > MAX_SMEM) return (int)cudaErrorInvalidValue;
      if (b > smem) smem = (int)b;
    }
    err = cudaFuncSetAttribute(jfa_pass, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(jfa_pass, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    const dim3 bands((unsigned)P, (unsigned)((H + tile - 1) / tile));
    for (int k = 0; k < nbanded; ++k) {
      const int* prev = k == 0 ? static_cast<const int*>(in) : buf[k & 1];
      jfa_pass<<<bands, THREADS, (size_t)(staged_rows(H, steps[k], tile) + 1) * W * 4, st>>>(
          prev, k == 0, buf[(k & 1) ^ 1], H, W, steps[k], tile);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      ++*launched;
    }
  }

  Steps tail{};
  tail.n = nsteps - nbanded;
  for (int k = 0; k < tail.n; ++k) tail.s[k] = steps[nbanded + k];
  const int smem = 4 * (2 * R + 1) * W;
  err = cudaFuncSetAttribute(jfa_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(jfa_cluster, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int nbands = (H + band - 1) / band;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(cs * nbands), (unsigned)P);
  // 512 threads where three blocks share an SM, else 1024
  cfg.blockDim = dim3(3 * smem <= MAX_SMEM ? CTHREADS / 2 : CTHREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int* src = nbanded == 0 ? static_cast<const int*>(in) : buf[nbanded & 1];
  const unsigned rm = R == 1 ? 0u : (unsigned)(((1ULL << 32) + R - 1) / R);
  err = cudaLaunchKernelEx(&cfg, jfa_cluster, src, (int)(nbanded == 0),
                           static_cast<float*>(out), H, W, band, halo, R, rm, tail);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return (int)err;
}
