// K2 and K9: the one-pass backward of the fused train segment
//   y = conv_{3x3, dilation d, SAME}(z) + bias,  z = act(x*a + b),
// NHWC, C == Cout in {32, 64, 128} (K2) or 256 (K9, the wide tier), act
// the ReLU or the identity, for sm_90a.
//
// Replaces resuneta_tpu/ops/pallas/convseg.py: _segment_bwd_pallas_dense ->
// _bwd_kernel (the pallas_call at :611), its narrow tier (K2) and its wide
// tier C % 128 == 0, C <= 256 (K9, opt-in there with
// RESUNETA_CONVSEG_BWD_WIDE=1). From x and the output cotangent g it
// computes
//
//   dz[m]   = sum_t gb[m - t*d] @ W_t^T          (gb = bf16(g), 0 outside)
//   dz_pre  = dz * 1[z_pre > 0] (act) or dz,  z_pre = fma(x, a, b) in f32
//   dx      = dz_pre * a                          (in x's type)
//   dW_t    = sum_m zb[m] (outer) gb[m - t*d]     (zb = bf16(act(z_pre)))
//   S1 = sum dz_pre,  S2 = sum dz_pre * (x - mean) * invstd,  dc = sum g
//
// with the TPU kernel's roundings: z and the taps in bf16, g (in x's type)
// rounded to bf16 for both products, f32 sums; S1, S2 and dc in f32 from
// the unrounded dz_pre and g. ops/convseg.fold_cotangents turns dW, S1, S2
// and dc into the seven cotangents.
//
// What bounds it. Two GEMMs of 18*C^2 flops per pixel each (dgrad and
// wgrad): 36*C^2 per pixel against 4 elements moved (x, g in; dx out; w is
// small). In bf16 that is 144 flops a byte at C = 32 (bytes bound on the
// H100), 576 at C = 64, 2304 at C = 128 and 9216 at C = 256 (tensor-core
// bound).
//
// Design: four launches of three kernels per call, all on the caller's
// stream, no atomics.
// * dgrad_kernel: an implicit GEMM on the tensor cores (WMMA bf16 16x16x16,
//   f32 accumulators) shaped as K1's forward: M = pixels (128 per block),
//   N = C in column tiles of up to 128 channels (one tile up to C = 128,
//   two at C = 256: a block that owned all 256 would need 52 KB of static
//   shared memory and 16 accumulator fragments a warp), K = 9 taps x C.
//   Each K step gathers the tap-shifted g of the tile (shift -t*d, zero
//   outside the image) into shared memory: no halo, so shared memory does
//   not depend on d (at d = 31 a halo would not fit). The epilogue
//   recomputes z_pre from x in registers (z never reaches device memory),
//   applies the ReLU mask, writes dx, and reduces S1, S2 and dc of the
//   tile's channels (they are per channel) over the block's pixels (warp
//   shuffles, then a fixed-order sum over warps) into its part of one row
//   of per-block partials.
// * wgrad_kernel: the nine (C x C) tap GEMMs with K = pixels. The TPU
//   kernel accumulates dW across its sequential grid (:428-431); blocks on
//   the H100 run in no order, so each block owns (pixel chunk, tap, input
//   channel tile of up to 128, output column tile of up to 64), recomputes
//   zb for its pixels and channels while staging them, gathers the shifted
//   gb, sums over its chunk on the tensor cores (warps split the pixels
//   when the tile is small, then add in a fixed order) and writes one
//   partial tile.
// * reduce_rows: a second pass that sums the per-block partials over
//   blocks in a fixed order (dW over chunks, S1/S2/dc over pixel tiles).
// The result is deterministic; against the plain version only the order of
// the f32 sums differs. No TMA, wgmma or software pipelining yet: this is
// the simple kernel that is right first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int BM = 128;       // dgrad: output pixels per block
constexpr int BK = 32;        // dgrad: channels of g per K step
constexpr int A_LD = BK + 8;
constexpr int A_CHUNKS = BM * BK / 8 / THREADS;
constexpr int WG_CHUNK_TARGET = 4 * 132;  // wgrad blocks to aim for: ~4 waves

template <typename T>
struct Io;

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
    uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

template <>
struct Io<float> {
  static __device__ __forceinline__ void load8(const float* p, float* v) {
    float4 lo = *reinterpret_cast<const float4*>(p);
    float4 hi = *reinterpret_cast<const float4*>(p + 4);
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  }
  static __device__ __forceinline__ void store8(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
};

// ------------------------------------------------------------------ dgrad

template <int C>
struct DgradShape {
  static constexpr int BN = C < 128 ? C : 128;  // channels per column tile
  static constexpr int TILES = C / BN;          // the grid's y extent
};

template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
dgrad_kernel(const T* __restrict__ x, const T* __restrict__ g,
             const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ mean, const float* __restrict__ invstd,
             const __nv_bfloat16* __restrict__ wT, T* __restrict__ dx,
             float* __restrict__ part, int N, int H, int W, int d, int act) {
  constexpr int BN = DgradShape<C>::BN;  // the block's column tile
  constexpr int B_LD = BN + 8;
  constexpr int WARP_N = BN / 2;   // 8 warps: 4 along M x 2 along N
  constexpr int FM = 2;
  constexpr int FN = WARP_N / 16;
  constexpr int B_CHUNKS_ALL = BK * BN / 8;
  constexpr int B_CHUNKS = (B_CHUNKS_ALL + THREADS - 1) / THREADS;

  __shared__ __align__(128) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * B_LD];
  __shared__ __align__(128) float Cs[THREADS / 32][16 * 16];
  __shared__ float sa[BN], sb[BN], smu[BN], sinv[BN];
  __shared__ float red[4][3][BN];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int warp_m = warp >> 1, warp_n = warp & 1;
  const long long M = (long long)N * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int cb0 = blockIdx.y * BN;  // the tile's first channel

  for (int i = tid; i < BN; i += THREADS) {
    sa[i] = a[cb0 + i];
    sb[i] = b[cb0 + i];
    smu[i] = mean[cb0 + i];
    sinv[i] = invstd[cb0 + i];
  }

  int pn[A_CHUNKS], ph[A_CHUNKS], pw[A_CHUNKS], pc[A_CHUNKS];
  bool pin[A_CHUNKS];
#pragma unroll
  for (int i = 0; i < A_CHUNKS; ++i) {
    const int chunk = tid + i * THREADS;
    const long long m = m0 + chunk / (BK / 8);
    pc[i] = (chunk % (BK / 8)) * 8;
    pin[i] = m < M;
    const long long mm = pin[i] ? m : 0;
    pw[i] = (int)(mm % W);
    const long long t = mm / W;
    ph[i] = (int)(t % H);
    pn[i] = (int)(t / H);
  }

  constexpr int kc_steps = C / BK;
  constexpr int k_steps = 9 * kc_steps;

  float ra[A_CHUNKS][8];
  bool rv[A_CHUNKS];
  uint4 rb[B_CHUNKS];

  // K step ks = (tap, 32 channels o of g): g at (h - dy, w - dx) and the
  // rows o of W_tap^T.
  auto load_global = [&](int ks) {
    const int tap = ks / kc_steps;
    const int c0 = (ks - tap * kc_steps) * BK;
    const int dy = (tap / 3 - 1) * d, dxs = (tap % 3 - 1) * d;
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int hs = ph[i] - dy, ws = pw[i] - dxs;
      rv[i] = pin[i] && hs >= 0 && hs < H && ws >= 0 && ws < W;
      if (rv[i]) {
        const long long off = (((long long)pn[i] * H + hs) * W + ws) * C + c0 + pc[i];
        Io<T>::load8(g + off, ra[i]);
      }
    }
#pragma unroll
    for (int j = 0; j < B_CHUNKS; ++j) {
      const int chunk = tid + j * THREADS;
      if (chunk < B_CHUNKS_ALL) {
        const int row = chunk / (BN / 8), col = (chunk % (BN / 8)) * 8;
        const long long off = (long long)(tap * C + c0 + row) * C + cb0 + col;
        rb[j] = *reinterpret_cast<const uint4*>(wT + off);
      }
    }
  };

  auto store_smem = [&]() {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int r = (tid + i * THREADS) / (BK / 8);
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = rv[i] ? ra[i][e] : 0.0f;
      Io<__nv_bfloat16>::store8(&As[r * A_LD + pc[i]], v);
    }
#pragma unroll
    for (int j = 0; j < B_CHUNKS; ++j) {
      const int chunk = tid + j * THREADS;
      if (chunk < B_CHUNKS_ALL) {
        const int row = chunk / (BN / 8), col = (chunk % (BN / 8)) * 8;
        *reinterpret_cast<uint4*>(&Bs[row * B_LD + col]) = rb[j];
      }
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  __syncthreads();
  load_global(0);
  for (int ks = 0; ks < k_steps; ++ks) {
    store_smem();
    __syncthreads();
    if (ks + 1 < k_steps) load_global(ks + 1);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], &As[(warp_m * 32 + i * 16) * A_LD + kk], A_LD);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], &Bs[kk * B_LD + warp_n * WARP_N + j * 16], B_LD);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: per fragment through a per-warp 16x16 f32 scratch; each lane
  // takes one pixel row and 8 channels (co within the tile, cg in the
  // tensor): mask, dx, and S1/S2/dc partials.
  float* cs = Cs[warp];
  const int r = lane >> 1, cc = (lane & 1) * 8;
#pragma unroll
  for (int j = 0; j < FN; ++j) {
    const int co = warp_n * WARP_N + j * 16 + cc;
    const int cg = cb0 + co;
    float s1[8], s2[8], sg[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) s1[e] = s2[e] = sg[e] = 0.0f;
#pragma unroll
    for (int i = 0; i < FM; ++i) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const long long m = m0 + warp_m * 32 + i * 16 + r;
      if (m < M) {
        float xv[8], gv[8], out[8];
        Io<T>::load8(x + m * C + cg, xv);
        Io<T>::load8(g + m * C + cg, gv);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int c = co + e;
          const float zp = __fmaf_rn(xv[e], sa[c], sb[c]);
          float dzp = cs[r * 16 + cc + e];
          if (act && !(zp > 0.0f)) dzp = 0.0f;
          out[e] = dzp * sa[c];
          const float xhat = __fmul_rn(__fsub_rn(xv[e], smu[c]), sinv[c]);
          s1[e] += dzp;
          s2[e] += dzp * xhat;
          sg[e] += gv[e];
        }
        Io<T>::store8(dx + m * C + cg, out);
      }
      __syncwarp();
    }
    // sum over the 16 lanes that share cc (lane bit 0), in a fixed tree
#pragma unroll
    for (int off = 2; off < 32; off <<= 1) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], off);
        s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], off);
        sg[e] += __shfl_xor_sync(0xffffffffu, sg[e], off);
      }
    }
    if (lane < 2) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        red[warp_m][0][co + e] = s1[e];
        red[warp_m][1][co + e] = s2[e];
        red[warp_m][2][co + e] = sg[e];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < 3 * BN; i += THREADS) {
    const int k = i / BN, c = i % BN;
    part[((long long)blockIdx.x * 3 + k) * C + cb0 + c] =
        ((red[0][k][c] + red[1][k][c]) + red[2][k][c]) + red[3][k][c];
  }
}

// ------------------------------------------------------------------ wgrad

template <int C>
struct WgradShape {
  static constexpr int WBM = C < 128 ? C : 128;     // input channels (rows) per block
  static constexpr int WBN = C < 64 ? C : 64;       // output columns per block
  static constexpr int TILES = (WBM / 32) * (WBN / 32);  // 32x32 warp tiles
  static constexpr int G = 8 / TILES;               // warps splitting the pixels
  static constexpr int KSTEP = 32 * G;              // pixels staged per step
  static constexpr int Z_LD = WBM + 8;
  static constexpr int G_LD = WBN + 8;
  static constexpr int STAGE_BYTES = KSTEP * (Z_LD + G_LD) * 2;
  static constexpr int RED_BYTES = G * WBM * WBN * 4;
  static constexpr int SMEM = STAGE_BYTES > RED_BYTES ? STAGE_BYTES : RED_BYTES;
  static constexpr int BLOCK_TILES = (C / WBM) * (C / WBN);  // the grid's z extent
  static_assert(TILES * G == 8, "8 warps");
};

template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g,
             const float* __restrict__ a, const float* __restrict__ b,
             float* __restrict__ part, int N, int H, int W, int d, int act,
             long long chunk_pixels) {
  using S = WgradShape<C>;
  constexpr int WBM = S::WBM, WBN = S::WBN, G = S::G, KSTEP = S::KSTEP;
  constexpr int Z_LD = S::Z_LD, G_LD = S::G_LD, TN = WBN / 32;
  constexpr int Z_CHUNKS = KSTEP * WBM / 8 / THREADS;
  constexpr int G_CHUNKS = KSTEP * WBN / 8 / THREADS;
  static_assert(Z_CHUNKS * THREADS * 8 == KSTEP * WBM, "z staging");
  static_assert(G_CHUNKS * THREADS * 8 == KSTEP * WBN, "g staging");

  __shared__ __align__(128) unsigned char smem[S::SMEM];
  __shared__ float sa[WBM], sb[WBM];
  __nv_bfloat16* Zs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Gs = Zs + KSTEP * Z_LD;
  float* Red = reinterpret_cast<float*>(smem);  // reused after the main loop

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int kg = warp / S::TILES, tile = warp % S::TILES;
  const int tm = tile / TN, tn = tile % TN;
  const int tap = blockIdx.y;
  const int cm0 = (blockIdx.z / (C / WBN)) * WBM;  // the tile's input channels
  const int co0 = (blockIdx.z % (C / WBN)) * WBN;  // and output channels
  const int dy = (tap / 3 - 1) * d, dxs = (tap % 3 - 1) * d;
  const long long M = (long long)N * H * W;
  const long long p_begin = (long long)blockIdx.x * chunk_pixels;
  long long p_end = p_begin + chunk_pixels;
  if (p_end > M) p_end = M;

  for (int i = tid; i < WBM; i += THREADS) {
    sa[i] = a[cm0 + i];
    sb[i] = b[cm0 + i];
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (long long p0 = p_begin; p0 < p_end; p0 += KSTEP) {
    // zb of the step's pixels, the tile's input channels
#pragma unroll
    for (int i = 0; i < Z_CHUNKS; ++i) {
      const int chunk = tid + i * THREADS;
      const int pix = chunk / (WBM / 8), c8 = (chunk % (WBM / 8)) * 8;
      const long long m = p0 + pix;
      float v[8];
      if (m < p_end) {
        Io<T>::load8(x + m * C + cm0 + c8, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          v[e] = __fmaf_rn(v[e], sa[c8 + e], sb[c8 + e]);
          if (act) v[e] = fmaxf(v[e], 0.0f);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = 0.0f;
      }
      Io<__nv_bfloat16>::store8(&Zs[pix * Z_LD + c8], v);
    }
    // gb at the tap-shifted pixel, the block's output columns
#pragma unroll
    for (int i = 0; i < G_CHUNKS; ++i) {
      const int chunk = tid + i * THREADS;
      const int pix = chunk / (WBN / 8), o8 = (chunk % (WBN / 8)) * 8;
      const long long m = p0 + pix;
      float v[8];
      bool ok = m < p_end;
      long long src = 0;
      if (ok) {
        const int w = (int)(m % W);
        const long long t = m / W;
        const int h = (int)(t % H);
        const long long n = t / H;
        const int hs = h - dy, ws = w - dxs;
        ok = hs >= 0 && hs < H && ws >= 0 && ws < W;
        src = ((n * H + hs) * W + ws) * C + co0 + o8;
      }
      if (ok) {
        Io<T>::load8(g + src, v);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = 0.0f;
      }
      Io<__nv_bfloat16>::store8(&Gs[pix * G_LD + o8], v);
    }
    __syncthreads();
    // dW_tap[c, o] += sum_pix zb[pix, c] gb[pix, o]: A = zb^T (col-major
    // view of the staged rows), B = gb (row-major); warp group kg takes
    // pixels [32 kg, 32 kg + 32) of the step
#pragma unroll
    for (int kk = 0; kk < 32; kk += 16) {
      const int k = kg * 32 + kk;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &Zs[k * Z_LD + tm * 32 + i * 16], Z_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &Gs[k * G_LD + tn * 32 + j * 16], G_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // the G warp groups' tiles, then their fixed-order sum
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Red[(kg * WBM + tm * 32 + i * 16) * WBN + tn * 32 + j * 16],
                              acc[i][j], WBN, wmma::mem_row_major);
  __syncthreads();
  float* out = part + ((long long)blockIdx.x * 9 + tap) * C * C;
  for (int i = tid; i < WBM * WBN; i += THREADS) {
    float s = Red[i];
#pragma unroll
    for (int k = 1; k < G; ++k) s += Red[k * WBM * WBN + i];
    const int c = i / WBN, o = i % WBN;
    out[(cm0 + c) * C + co0 + o] = s;
  }
}

// --------------------------------------------------------------- reduce

// out[col] = sum over rows of part[row, col], in a fixed order.
__global__ void __launch_bounds__(1024)
reduce_rows(const float* __restrict__ part, long long rows, int cols, float* __restrict__ out) {
  __shared__ float sm[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * 32 + tx;
  float s = 0.0f;
  if (col < cols)
    for (long long r = ty; r < rows; r += 32) s += part[r * cols + col];
  sm[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && col < cols) {
    float t = 0.0f;
    for (int k = 0; k < 32; ++k) t += sm[k][tx];
    out[col] = t;
  }
}

long long dgrad_blocks(int N, int H, int W) {
  return ((long long)N * H * W + BM - 1) / BM;
}

// WgradShape<C>::BLOCK_TILES at run time
int wgrad_tiles(int C) {
  const int wbm = C < 128 ? C : 128, wbn = C < 64 ? C : 64;
  return (C / wbm) * (C / wbn);
}

long long wgrad_chunk_pixels(int N, int H, int W, int C) {
  const long long M = (long long)N * H * W;
  const int tiles = wgrad_tiles(C);
  long long chunks = (WG_CHUNK_TARGET + 9 * tiles - 1) / (9 * tiles);
  long long per = (M + chunks - 1) / chunks;
  per = (per + 255) / 256 * 256;  // whole staging steps
  return per;
}

long long wgrad_chunks(int N, int H, int W, int C) {
  const long long M = (long long)N * H * W;
  const long long per = wgrad_chunk_pixels(N, H, W, C);
  return (M + per - 1) / per;
}

template <typename T, int C>
cudaError_t launch(const void* x, const void* g, const float* a, const float* b,
                   const float* mean, const float* invstd, const __nv_bfloat16* wT,
                   void* dx, float* dw, float* vec, float* work, int N, int H, int W,
                   int d, int act, int* launched, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  const long long blocks = dgrad_blocks(N, H, W);
  const long long chunks = wgrad_chunks(N, H, W, C);
  const long long per = wgrad_chunk_pixels(N, H, W, C);
  float* vec_part = work;                       // [blocks][3][C]
  float* dw_part = work + blocks * 3 * C;       // [chunks][9][C][C]
  static_assert(WgradShape<C>::BLOCK_TILES > 0 && DgradShape<C>::TILES > 0, "tiles");

  dgrad_kernel<T, C><<<dim3((unsigned)blocks, DgradShape<C>::TILES), THREADS, 0, stream>>>(
      xt, gt, a, b, mean, invstd, wT, static_cast<T*>(dx), vec_part, N, H, W, d, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launched;
  wgrad_kernel<T, C><<<dim3((unsigned)chunks, 9, WgradShape<C>::BLOCK_TILES), THREADS, 0,
                        stream>>>(xt, gt, a, b, dw_part, N, H, W, d, act, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launched;
  const dim3 rblock(32, 32);
  reduce_rows<<<(3 * C + 31) / 32, rblock, 0, stream>>>(vec_part, blocks, 3 * C, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launched;
  reduce_rows<<<(9 * C * C + 31) / 32, rblock, 0, stream>>>(dw_part, chunks, 9 * C * C, dw);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return err;
}

template <typename T>
cudaError_t dispatch(int C, const void* x, const void* g, const float* a, const float* b,
                     const float* mean, const float* invstd, const __nv_bfloat16* wT,
                     void* dx, float* dw, float* vec, float* work, int N, int H, int W,
                     int d, int act, int* launched, cudaStream_t s) {
  switch (C) {
    case 32:
      return launch<T, 32>(x, g, a, b, mean, invstd, wT, dx, dw, vec, work, N, H, W, d, act,
                           launched, s);
    case 64:
      return launch<T, 64>(x, g, a, b, mean, invstd, wT, dx, dw, vec, work, N, H, W, d, act,
                           launched, s);
    case 128:
      return launch<T, 128>(x, g, a, b, mean, invstd, wT, dx, dw, vec, work, N, H, W, d, act,
                            launched, s);
    case 256:
      return launch<T, 256>(x, g, a, b, mean, invstd, wT, dx, dw, vec, work, N, H, W, d, act,
                            launched, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Floats of device workspace convseg_backward needs for this shape.
extern "C" long long convseg_backward_workspace(int N, int H, int W, int C) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0) return 0;
  return dgrad_blocks(N, H, W) * 3 * C + wgrad_chunks(N, H, W, C) * 9LL * C * C;
}

// x, g, dx: (N, H, W, C) contiguous, bf16 (x_is_bf16 = 1) or f32, 16-byte
// aligned; a, b, mean, invstd: (C,) f32; wT: (3, 3, C, C) bf16 with
// wT[t][o][c] = w[t][c][o]; dw: (3, 3, C, C) f32 HWIO; vec: (3, C) f32 =
// [S1, S2, dc]; work: convseg_backward_workspace(N, H, W, C) floats.
// C in {32, 64, 128, 256}; act 1 for z = relu(x*a + b), 0 for z = x*a + b.
// Adds the number of kernels it launched to *launched (four when all go)
// and returns the first cudaError_t of the launches.
extern "C" int convseg_backward(const void* x, const void* g, const void* a, const void* b,
                                const void* mean, const void* invstd, const void* wT,
                                void* dx, void* dw, void* vec, void* work, int N, int H,
                                int W, int C, int d, int act, int x_is_bf16, int* launched,
                                void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || d <= 0 ||
      (C != 32 && C != 64 && C != 128 && C != 256))
    return (int)cudaErrorInvalidValue;
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* mf = static_cast<const float*>(mean);
  const float* isf = static_cast<const float*>(invstd);
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(wT);
  float* dwf = static_cast<float*>(dw);
  float* vf = static_cast<float*>(vec);
  float* wk = static_cast<float*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      x_is_bf16
          ? dispatch<__nv_bfloat16>(C, x, g, af, bf, mf, isf, wb, dx, dwf, vf, wk, N, H, W, d,
                                    act, launched, s)
          : dispatch<float>(C, x, g, af, bf, mf, isf, wb, dx, dwf, vf, wk, N, H, W, d, act,
                            launched, s);
  return (int)err;
}
