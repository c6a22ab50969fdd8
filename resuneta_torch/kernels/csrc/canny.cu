// K6 and K8: boundary labels, Canny(0, 1) then a 3x3 cross dilation, for
// sm_90a: K6 on whole planes, K8 on row bands of larger ones.
//
// K6 replaces resuneta_tpu/ops/pallas/canny.py: boundary_label_pallas ->
// _canny_dilate_kernel -> _canny_core (the pallas_call at :227); K8 the
// same function's row-tiled path, _canny_tiled_kernel (the pallas_call at
// :257). For each (H, W) plane of P int32 planes both give f32 {0, 1},
// bit-identical to resuneta_tpu/ops/boundary.py (OpenCV's Canny on class
// planes):
//
//   Sobel dx, dy, aperture 3, BORDER_REPLICATE, int32;  mag = |dx| + |dy|
//   NMS on mag with zero outside the plane: with tg22x = |dx|*13573 and
//   tg67x = tg22x + (2|dx| << 15), |dy| << 15 below tg22x is horizontal
//   (keep if mag > left and mag >= right), above tg67x vertical
//   (mag > up and mag >= down), else diagonal by sign(dx ^ dy)
//   (mag > up-left and mag > down-right, or up-right and down-left)
//   strong = kept & mag > 1, weak = kept & mag == 1 (low 0, high 1)
//   hysteresis: edges = strong; at most 32 Jacobi rounds of
//   edges |= weak & dilate8(edges), from the ROUND-START edges, stopping
//   early when a round changes nothing
//   out = edges | its 4 neighbours (cv2.MORPH_CROSS), zero outside
//
// The 32-round cap with round-start edges is the reference's semantics: a
// flood fill or in-place growth would run past the cap and differ. The
// int32 arithmetic wraps as XLA's does (done in unsigned here).
//
// What bounds it. The function moves 8 bytes a pixel (int32 in, f32 out);
// the work is ~50 integer operations a pixel for Sobel, NMS, thresholds and
// the dilation: bytes bound on an H100. No hysteresis round ever runs on
// int32 planes: dx and dy see the same four corner pixels with weight 1 and
// the rest with weight 2 or 0, so dx + dy is even (under wrapping too),
// mag = |dx| + |dy| is even, and no pixel has the weak magnitude 1.
//
// Design: two passes, one launch each, no host sync between them.
//
// Pass 1, canny_tile_kernel, the same for K6 and K8: a block of 256
// threads takes a TH x TW = 32 x 64 tile of output pixels of one plane (a
// 256^2 plane has 32 tiles, 80 of them 2,560 blocks) and stages its int32
// input with a 3-pixel halo in shared memory once, coalesced, every load
// of a thread in flight together, with the replicate border on the plane's
// coordinates. A tile whose staged input is of one value has mag 0 around
// it and writes 0 at once: most tiles of class planes. Else a thread walks
// a strip of 12 rows of one column of the mag frame (the tile and 2
// pixels around) three times, keeping the rows above and below in
// registers: Sobel from three input loads a row (dx, dy and mag once a
// pixel, mag 0 outside the plane, NMS's direction kept in a register),
// then NMS and the thresholds from three mag loads a row, then the cross
// dilation of the strong pixels from three loads a row, written out: the
// result wherever the plane has no weak pixel. If any of its pixels is
// weak, the block sets its plane's flag (atomicOr); the wrapper's call
// clears the flags first (cudaMemsetAsync, on the stream). What paces it
// is instructions, not bytes: tools/torch_canny_ablate.py times it with
// each part changed, PERF.md has the readings.
//
// Pass 2, canny_kernel, the first design kept as the hysteresis path: one
// block of 1024 threads per (plane, band of `tile` rows); a block whose
// plane's flag is clear returns at once, so on integer planes the launch
// is near empty. A flagged plane is computed again from its input and its
// output rewritten, with the reference's rounds: hysteresis rounds are
// separated by block barriers (__syncthreads_or also gives "changed"). The
// block's state lives in shared memory as one byte a pixel over its
// WINDOW, the band plus `halo` rows on each side inside the plane: bit 0
// weak, bits 1 and 2 the edges of alternate rounds (ping-pong, so each
// round reads only round-start edges). Sobel and NMS recompute the
// magnitudes of the 3x3 neighbourhood from the input (a 5x5 window read
// through L1) and use GLOBAL rows: the replicate border and NMS's zero
// magnitudes apply at the plane's edges only, so they are exact on every
// window row. Only the hysteresis sees the window's edge (no edge beyond
// it), and a round moves edges by one row, so after 32 rounds rows within
// 32 of that edge may differ from the whole-plane result; the cross
// dilation reads one row more. A halo of hysteresis_iters + 3 = 35 rows,
// the reference's (canny.py:57-59), keeps every band row exact; the early
// exit is per band, as the reference's: a band that stops changing is at
// its fixed point, which the remaining rounds would keep. K6 is the
// one-band case (tile = H, halo 0, window = plane): H * W bytes, 147,456 at
// the reference's 384^2 whole-plane limit; K8's window is (tile + 70) * W
// bytes, 101,376 at 512^2 and 202,752 at 1024^2 with tile 128, inside the
// 227 KB a block may have. The reference has no VMEM plan for 1024^2
// planes (_plan_tile(1024, 1024) is None, so XLA runs there); shared
// memory is K8's only limit, so it runs there too, with the same result.
// canny_hysteresis runs pass 2 alone on flags the caller gives, so the
// path that integer planes never reach can be run and checked.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;      // pass 2
constexpr int MAX_SMEM = 232448;   // the 227 KB a block may have
constexpr unsigned TG22 = 13573u;  // tan(22.5 deg) * 2^15
constexpr unsigned char WEAK = 1;

// pass 1: a tile of TH x TW output pixels, 256 threads, each walking a
// strip of STRIP rows of one column of the mag frame
constexpr int TW = 64, TH = 32, TILE_THREADS = 256, STRIP = 12;
constexpr int IW = TW + 6, IH = TH + 6;  // the input: 3 pixels around
constexpr int MW = TW + 4, MH = TH + 4;  // mag: 2 around (the NMS: 1)
constexpr int STRIPS = MW * (MH / STRIP);
static_assert(MH % STRIP == 0 && STRIPS <= TILE_THREADS && 2 * STRIP <= 32,
              "one strip a thread, its directions in one word");

__device__ __forceinline__ int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

__device__ __forceinline__ unsigned uabs(int v) {
  return v < 0 ? 0u - (unsigned)v : (unsigned)v;
}

// NMS's direction from dx, dy: 0 horizontal, 1 vertical, 2 the diagonal
// up-right / down-left (dx ^ dy < 0), 3 up-left / down-right.
__device__ __forceinline__ int direction(int dx, int dy) {
  const unsigned x_abs = uabs(dx);
  const int y_sh = (int)(uabs(dy) << 15);
  const int tg22x = (int)(x_abs * TG22);
  const int tg67x = (int)((unsigned)tg22x + ((x_abs + x_abs) << 15));
  if (y_sh < tg22x) return 0;
  if (y_sh > tg67x) return 1;
  return (dx ^ dy) < 0 ? 2 : 3;
}

// Pass 1. Block b: plane b / tiles, tile b % tiles (row-major over the
// tiles_w tiles of a tile row). Shared arrays in the tile's frame: img[r][c]
// is input pixel (i0 - 3 + r, j0 - 3 + c) clamped into the plane;
// mag[r][c] and edge[r][c] pixel (i0 - 2 + r, j0 - 2 + c), edge on the
// frame less its outer ring. Thread t < STRIPS walks column c = t % MW,
// rows r0 = (t / MW) STRIP on, of the mag frame in each phase, with the
// rows above and below its row in registers: Sobel from three img loads a
// row (its directions kept in a register, two bits a row), the NMS from
// three mag loads a row, the cross dilation from three edge loads a row.
__global__ void __launch_bounds__(TILE_THREADS)
canny_tile_kernel(const int* __restrict__ in, float* __restrict__ out, int* __restrict__ flags,
                  int H, int W, int tiles_w, int tiles) {
  __shared__ int img[IH][IW];
  __shared__ int mag[MH][MW];
  __shared__ unsigned char edge[MH][MW];
  const int plane = blockIdx.x / tiles, t = blockIdx.x - plane * tiles;
  const int i0 = (t / tiles_w) * TH, j0 = (t % tiles_w) * TW;
  const int* src = in + (long long)plane * H * W;
  const int tid = threadIdx.x;

  // all of a thread's loads in flight at once, then its stores
  constexpr int LOADS = (IH * IW + TILE_THREADS - 1) / TILE_THREADS;
  int v[LOADS];
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const int q = tid + u * TILE_THREADS;
    const int r = q / IW, c = q - (q / IW) * IW;
    if (q < IH * IW)
      v[u] = src[(long long)clampi(i0 - 3 + r, H - 1) * W + clampi(j0 - 3 + c, W - 1)];
  }
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const int q = tid + u * TILE_THREADS;
    if (q < IH * IW) (&img[0][0])[q] = v[u];
  }
  __syncthreads();

  // A frame of one value has dx = dy = 0, so mag = 0, on its mag frame:
  // nothing is kept and the tile's output is 0 (exact for any plane). Class
  // planes are mostly such tiles.
  int same = 1;
#pragma unroll
  for (int u = 0; u < LOADS; ++u)
    same &= tid + u * TILE_THREADS >= IH * IW || v[u] == img[0][0];
  if (__syncthreads_and(same)) {
    float* dst = out + (long long)plane * H * W;
    for (int q = tid; q < TH * TW; q += TILE_THREADS) {
      const int i = i0 + q / TW, j = j0 + q % TW;
      if (i < H && j < W) dst[(long long)i * W + j] = 0.0f;
    }
    return;
  }

  const bool walks = tid < STRIPS;
  const int c = tid % MW, r0 = (tid / MW) * STRIP;
  const int j = j0 - 2 + c;
  const bool col_in = (unsigned)j < (unsigned)W;

  // Sobel on the strip: mag (r, c) has the 3x3 window img[r..r+2][c..c+2];
  // a row's terms are hd = right - left and hs = left + 2 centre + right,
  // dx = hd[r] + 2 hd[r+1] + hd[r+2] and dy = hs[r+2] - hs[r] (wrapping,
  // so in any order). Outside the plane NMS reads mag 0.
  unsigned dirs = 0;
  if (walks) {
    unsigned hd[3], hs[3];
#pragma unroll
    for (int k = 0; k < STRIP + 2; ++k) {
      const unsigned l = img[r0 + k][c], m = img[r0 + k][c + 1], rt = img[r0 + k][c + 2];
      hd[k % 3] = rt - l;
      hs[k % 3] = l + 2u * m + rt;
      if (k >= 2) {
        const int r = r0 + k - 2;
        const int dx = (int)(hd[(k - 2) % 3] + 2u * hd[(k - 1) % 3] + hd[k % 3]);
        const int dy = (int)(hs[k % 3] - hs[(k - 2) % 3]);
        const bool in_plane = col_in && (unsigned)(i0 - 2 + r) < (unsigned)H;
        mag[r][c] = in_plane ? (int)(uabs(dx) + uabs(dy)) : 0;
        dirs |= (unsigned)direction(dx, dy) << (2 * (k - 2));
      }
    }
  }
  __syncthreads();

  // NMS and the thresholds on the frame less its outer ring (the tile and
  // one pixel around); the window's rows are clamped into the frame, which
  // changes only rows that are not computed
  int any_weak = 0;
  if (walks && c >= 1 && c <= MW - 2) {
    int up[3], mid[3];
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      up[x] = mag[r0 > 0 ? r0 - 1 : 0][c - 1 + x];
      mid[x] = mag[r0][c - 1 + x];
    }
#pragma unroll
    for (int k = 0; k < STRIP; ++k) {
      const int r = r0 + k;
      const int rd = r + 1 < MH ? r + 1 : MH - 1;
      int dn[3];
#pragma unroll
      for (int x = 0; x < 3; ++x) dn[x] = mag[rd][c - 1 + x];
      if (r >= 1 && r <= MH - 2) {
        const int m = mid[1];
        const unsigned dir = (dirs >> (2 * k)) & 3u;
        // the two neighbours of the direction, by selects
        const int na = dir == 0 ? mid[0] : dir == 1 ? up[1] : dir == 2 ? up[2] : up[0];
        const int nb = dir == 0 ? mid[2] : dir == 1 ? dn[1] : dir == 2 ? dn[0] : dn[2];
        bool kept = m > na && (dir < 2 ? m >= nb : m > nb);
        // mag is 0 outside the plane, so no pixel there is kept
        kept = kept && m > 0;
        edge[r][c] = kept && m > 1;
        any_weak |= kept && m == 1;
      }
#pragma unroll
      for (int x = 0; x < 3; ++x) {
        up[x] = mid[x];
        mid[x] = dn[x];
      }
    }
  }
  if (__syncthreads_or(any_weak) && tid == 0) atomicOr(&flags[plane], 1);

  // the cross dilation of the strong pixels on the tile (the frame less
  // two rings); edge is 0 outside the plane
  if (walks && c >= 2 && c <= MW - 3) {
    float* dst = out + (long long)plane * H * W;
    unsigned char up = edge[r0 > 1 ? r0 - 1 : 1][c], mid = edge[r0 > 1 ? r0 : 1][c];
#pragma unroll
    for (int k = 0; k < STRIP; ++k) {
      const int r = r0 + k;
      const unsigned char dn = edge[r + 1 < MH - 1 ? r + 1 : MH - 2][c];
      const int i = i0 - 2 + r;
      if (r >= 2 && r <= MH - 3 && i < H && j < W)
        dst[(long long)i * W + j] =
            (mid | up | dn | edge[r][c - 1] | edge[r][c + 1]) ? 1.0f : 0.0f;
      up = mid;
      mid = dn;
    }
  }
}

// Sobel dx, dy at (i, j) with replicate border, wrapping int32 arithmetic.
__device__ __forceinline__ void sobel(const int* __restrict__ img, int H, int W, int i, int j,
                                      int& dx, int& dy) {
  const int jl = clampi(j - 1, W - 1), jr = clampi(j + 1, W - 1);
  const int iu = clampi(i - 1, H - 1), id = clampi(i + 1, H - 1);
  unsigned sx = 0, sy = 0;
#pragma unroll
  for (int r = -1; r <= 1; ++r) {
    const unsigned wgt = r == 0 ? 2u : 1u;
    const int row = clampi(i + r, H - 1) * W;
    sx += wgt * ((unsigned)img[row + jr] - (unsigned)img[row + jl]);
    const int col = clampi(j + r, W - 1);
    sy += wgt * ((unsigned)img[id * W + col] - (unsigned)img[iu * W + col]);
  }
  dx = (int)sx;
  dy = (int)sy;
}

__device__ __forceinline__ int magnitude(const int* __restrict__ img, int H, int W, int i,
                                         int j) {
  if (i < 0 || i >= H || j < 0 || j >= W) return 0;  // NMS pads mag with 0
  int dx, dy;
  sobel(img, H, W, i, j, dx, dy);
  return (int)(uabs(dx) + uabs(dy));
}

// Pass 2. Block (plane blockIdx.x, band blockIdx.y): nothing unless the
// plane's flag is set; then output rows [r0, r1), state over the window
// rows [w0, w1); st[q] is pixel (w0 + q / W, q % W).
__global__ void __launch_bounds__(THREADS)
canny_kernel(const int* __restrict__ in, float* __restrict__ out,
             const int* __restrict__ flags, int H, int W, int tile, int halo, int iters) {
  if (!flags[blockIdx.x]) return;
  extern __shared__ unsigned char st[];
  const int r0 = blockIdx.y * tile, r1 = min(r0 + tile, H);
  const int w0 = max(r0 - halo, 0), w1 = min(r1 + halo, H);
  const int n = (w1 - w0) * W;
  const int* img = in + (long long)blockIdx.x * H * W;
  float* o = out + (long long)blockIdx.x * H * W;
  const int tid = threadIdx.x;

  int any_weak = 0;
  for (int q = tid; q < n; q += THREADS) {
    const int i = w0 + q / W, j = q - (q / W) * W;
    int dx, dy;
    sobel(img, H, W, i, j, dx, dy);
    const int mag = (int)(uabs(dx) + uabs(dy));
    bool kept;
    switch (direction(dx, dy)) {
      case 0:
        kept = mag > magnitude(img, H, W, i, j - 1) && mag >= magnitude(img, H, W, i, j + 1);
        break;
      case 1:
        kept = mag > magnitude(img, H, W, i - 1, j) && mag >= magnitude(img, H, W, i + 1, j);
        break;
      case 2:
        kept = mag > magnitude(img, H, W, i - 1, j + 1) &&
               mag > magnitude(img, H, W, i + 1, j - 1);
        break;
      default:
        kept = mag > magnitude(img, H, W, i - 1, j - 1) &&
               mag > magnitude(img, H, W, i + 1, j + 1);
    }
    kept = kept && mag > 0;
    const bool strong = kept && mag > 1;
    const bool weak = kept && !strong;
    st[q] = (unsigned char)((weak ? WEAK : 0) | (strong ? 2 : 0));
    any_weak |= weak;
  }
  int changed = __syncthreads_or(any_weak);

  const int rows = w1 - w0;
  unsigned char cur = 2, nxt = 4;
  for (int round = 0; round < iters && changed; ++round) {
    int ch = 0;
    for (int q = tid; q < n; q += THREADS) {
      const unsigned char s = st[q];
      const bool e = s & cur;
      bool grown = e;
      if (!e && (s & WEAK)) {
        const int i = q / W, j = q - (q / W) * W;   // window row
        for (int a = -1; a <= 1 && !grown; ++a) {
          const int ii = i + a;
          if (ii < 0 || ii >= rows) continue;
          for (int b = -1; b <= 1; ++b) {
            const int jj = j + b;
            if ((a || b) && jj >= 0 && jj < W && (st[ii * W + jj] & cur)) {
              grown = true;
              break;
            }
          }
        }
      }
      // only this thread writes pixel q; the others read its `cur` bit,
      // which this store leaves as it was
      st[q] = (unsigned char)((s & ~nxt) | (grown ? nxt : 0));
      ch |= grown != e;
    }
    changed = __syncthreads_or(ch);
    const unsigned char t = cur;
    cur = nxt;
    nxt = t;
  }

  // the band's rows only; their neighbour rows lie in the window, or past
  // the plane's edge, where the dilation's fill is zero
  for (int q = (r0 - w0) * W + tid; q < (r1 - w0) * W; q += THREADS) {
    const int i = w0 + q / W, j = q - (q / W) * W;
    bool e = st[q] & cur;
    e = e || (j > 0 && (st[q - 1] & cur)) || (j + 1 < W && (st[q + 1] & cur)) ||
        (i > 0 && (st[q - W] & cur)) || (i + 1 < H && (st[q + W] & cur));
    o[(long long)i * W + j] = e ? 1.0f : 0.0f;
  }
}

// The shared memory of pass 2's window and its bands, or an error for a
// plan it cannot take.
cudaError_t band_plan(int P, int H, int W, int tile, int halo, int iters, int* smem,
                      unsigned* bands) {
  if (P <= 0 || H <= 0 || W <= 0 || tile <= 0 || halo < 0 || iters < 0 ||
      (tile < H && halo < iters + 3))
    return cudaErrorInvalidValue;
  const long long rows = (long long)tile + 2LL * halo < H ? (long long)tile + 2LL * halo : H;
  const long long nb = (H + (long long)tile - 1) / tile;
  if (rows * W > MAX_SMEM || nb > 65535 || P > 2147483647LL / ((H + TH - 1) / TH) /
                                                      ((W + TW - 1) / TW))
    return cudaErrorInvalidValue;
  *smem = (int)(rows * W);
  *bands = (unsigned)nb;
  return cudaSuccess;
}

int hysteresis(const void* in, void* out, const void* flags, int P, int H, int W, int tile,
               int halo, int iters, void* stream) {
  int smem;
  unsigned bands;
  cudaError_t err = band_plan(P, H, W, tile, halo, iters, &smem, &bands);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(canny_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  canny_kernel<<<dim3((unsigned)P, bands), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(in), static_cast<float*>(out), static_cast<const int*>(flags), H,
      W, tile, halo, iters);
  return (int)cudaGetLastError();
}

// Both passes: clear the flags, pass 1, pass 2.
int launch(const void* in, void* out, void* flags, int P, int H, int W, int tile, int halo,
           int iters, void* stream) {
  int smem;
  unsigned bands;
  cudaError_t err = band_plan(P, H, W, tile, halo, iters, &smem, &bands);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((err = cudaMemsetAsync(flags, 0, (size_t)P * sizeof(int), s)) != cudaSuccess)
    return (int)err;
  const int tiles_w = (W + TW - 1) / TW, tiles = tiles_w * ((H + TH - 1) / TH);
  canny_tile_kernel<<<(unsigned)(P * tiles), TILE_THREADS, 0, s>>>(
      static_cast<const int*>(in), static_cast<float*>(out), static_cast<int*>(flags), H, W,
      tiles_w, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return hysteresis(in, out, flags, P, H, W, tile, halo, iters, stream);
}

}  // namespace

// in: (P, H, W) int32; out: (P, H, W) f32 {0, 1}; flags: (P,) int32
// scratch. Each returns the first cudaError_t; nothing is launched for a
// plan the kernels cannot take.

// K6: pass 1 and pass 2 on whole planes. H * W <= 232,448 (pass 2's
// byte-a-pixel state in shared memory).
extern "C" int canny_boundary(const void* in, void* out, void* flags, int P, int H, int W,
                              int iters, void* stream) {
  return launch(in, out, flags, P, H, W, H, 0, iters, stream);
}

// K8: pass 1, then pass 2 over bands of `tile` rows, each from a window of
// `halo` (>= iters + 3) more rows on each side; min(H, tile + 2 * halo) * W
// <= 232,448.
extern "C" int canny_boundary_tiled(const void* in, void* out, void* flags, int P, int H,
                                    int W, int tile, int halo, int iters, void* stream) {
  return launch(in, out, flags, P, H, W, tile, halo, iters, stream);
}

// Pass 2 alone (whole planes: tile = H, halo = 0): every plane whose flag
// is nonzero is computed again, hysteresis rounds and all, and its output
// rewritten; the others are left as they are.
extern "C" int canny_hysteresis(const void* in, void* out, const void* flags, int P, int H,
                                int W, int tile, int halo, int iters, void* stream) {
  return hysteresis(in, out, flags, P, H, W, tile, halo, iters, stream);
}
