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
// the dilation. No hysteresis round ever runs on int32 planes: dx and dy
// see the same four corner pixels with weight 1 and the rest with weight 2
// or 0, so dx + dy is even, mag = |dx| + |dy| is even, and no pixel has the
// weak magnitude 1. The rounds stay, as the reference's, behind the early
// exit that skips them.
//
// Design: one block of 1024 threads per (plane, band of `tile` rows), so
// hysteresis rounds are separated by block barriers (__syncthreads_or also
// gives "changed"). The block's state lives in shared memory as one byte a
// pixel over its WINDOW, the band plus `halo` rows on each side inside the
// plane: bit 0 weak, bits 1 and 2 the edges of alternate rounds (ping-pong,
// so each round reads only round-start edges). Sobel and NMS recompute the
// magnitudes of the 3x3 neighbourhood from the input (a 5x5 window read
// through L1) instead of storing an int32 magnitude plane, which would not
// fit, and use GLOBAL rows: the replicate border and NMS's zero magnitudes
// apply at the plane's edges only, so they are exact on every window row.
// Only the hysteresis sees the window's edge (no edge beyond it), and a
// round moves edges by one row, so after 32 rounds rows within 32 of that
// edge may differ from the whole-plane result; the cross dilation reads
// one row more. A halo of hysteresis_iters + 3 = 35 rows, the reference's
// (canny.py:57-59), keeps every band row exact; the early exit is per
// band, as the reference's: a band that stops changing is at its fixed
// point, which the remaining rounds would keep.
//
// K6 is the one-band case (tile = H, halo 0, window = plane): H * W bytes,
// 147,456 at the reference's 384^2 whole-plane limit. K8 takes larger
// planes: its window is (tile + 70) * W bytes, 101,376 at 512^2 and
// 202,752 at 1024^2 with tile 128, inside the 227 KB a block may have.
// The reference has no VMEM plan for 1024^2 planes (_plan_tile(1024, 1024)
// is None, so XLA runs there); shared memory is K8's only limit, so it
// runs there too, with the same result. The halo costs recomputed pixel
// work: (tile + 70) / tile per interior band, 1.55x at tile 128.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;
constexpr int MAX_SMEM = 232448;   // the 227 KB a block may have
constexpr unsigned TG22 = 13573u;  // tan(22.5 deg) * 2^15
constexpr unsigned char WEAK = 1;

__device__ __forceinline__ int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

__device__ __forceinline__ unsigned uabs(int v) {
  return v < 0 ? 0u - (unsigned)v : (unsigned)v;
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

// Block (plane blockIdx.x, band blockIdx.y): output rows [r0, r1), state
// over the window rows [w0, w1); st[q] is pixel (w0 + q / W, q % W).
__global__ void __launch_bounds__(THREADS)
canny_kernel(const int* __restrict__ in, float* __restrict__ out, int H, int W, int tile,
             int halo, int iters) {
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
    const unsigned x_abs = uabs(dx);
    const int y_sh = (int)(uabs(dy) << 15);
    const int tg22x = (int)(x_abs * TG22);
    const int tg67x = (int)((unsigned)tg22x + ((x_abs + x_abs) << 15));
    bool kept;
    if (y_sh < tg22x) {
      kept = mag > magnitude(img, H, W, i, j - 1) && mag >= magnitude(img, H, W, i, j + 1);
    } else if (y_sh > tg67x) {
      kept = mag > magnitude(img, H, W, i - 1, j) && mag >= magnitude(img, H, W, i + 1, j);
    } else if ((dx ^ dy) < 0) {
      kept = mag > magnitude(img, H, W, i - 1, j + 1) &&
             mag > magnitude(img, H, W, i + 1, j - 1);
    } else {
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

int launch(const void* in, void* out, int P, int H, int W, int tile, int halo, int iters,
           void* stream) {
  if (P <= 0 || H <= 0 || W <= 0 || tile <= 0 || halo < 0 || iters < 0 ||
      (tile < H && halo < iters + 3))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)tile + 2LL * halo < H ? (long long)tile + 2LL * halo : H;
  const long long bands = (H + (long long)tile - 1) / tile;
  if (rows * W > MAX_SMEM || bands > 65535) return (int)cudaErrorInvalidValue;
  const int smem = (int)(rows * W);
  cudaError_t err =
      cudaFuncSetAttribute(canny_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  canny_kernel<<<dim3((unsigned)P, (unsigned)bands), THREADS, smem,
                 static_cast<cudaStream_t>(stream)>>>(static_cast<const int*>(in),
                                                      static_cast<float*>(out), H, W, tile,
                                                      halo, iters);
  return (int)cudaGetLastError();
}

}  // namespace

// K6. in: (P, H, W) int32; out: (P, H, W) f32 {0, 1}. H * W <= 232,448 (the
// byte-a-pixel state in shared memory). Returns the first cudaError_t.
extern "C" int canny_boundary(const void* in, void* out, int P, int H, int W, int iters,
                              void* stream) {
  return launch(in, out, P, H, W, H, 0, iters, stream);
}

// K8: the same over bands of `tile` rows, each from a window of `halo`
// (>= iters + 3) more rows on each side; min(H, tile + 2 * halo) * W <=
// 232,448. Returns the first cudaError_t.
extern "C" int canny_boundary_tiled(const void* in, void* out, int P, int H, int W, int tile,
                                    int halo, int iters, void* stream) {
  return launch(in, out, P, H, W, tile, halo, iters, stream);
}
