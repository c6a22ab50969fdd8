// PR 3's 1x1 convolutions as GEMMs over NHWC tensors whose A operand is
// gathered on the fly, for sm_90a: K3's f32 path (densemm.cu; K3's bf16
// path has Hopper kernels of its own there). densemm.cu wraps these device
// bodies in __global__ kernels of its own names. K4 (poolconv.cu), which
// took them first, has kernels of its own.
//
// A "part" is one NHWC input of a 1x1 convolution, read at output pixel
// (n, h, w) of an (N, H, W, cout) result as
//   ups k > 1:    input pixel (h / k, w / k)        (nearest upsample)
//   stride s > 1: input pixel (h * s, w * s)        (strided 1x1 conv)
// with a ReLU on the values where `act` is set. The weights of all parts
// are one (sum cin_p, cout) matrix, part p's rows starting at `koff`.
//
// Roundings, as the TPU kernels: the gathered values and the weights are
// rounded to the compute type (bf16 for bf16 tensors, exact here since
// the ReLU of bf16 values is a bf16 value; f32 for f32 tensors),
// products are summed in f32, the bias is added in f32 and the result is
// cast once. bf16 runs on the tensor cores (WMMA 16x16x16, f32
// accumulators); f32 runs the same tiles with f32 FMAs on the CUDA cores.
//
// The weight gradient sums over every pixel. Blocks run in no order on
// the H100, so wgrad writes one partial tile per (pixel chunk, tile) and
// reduce_rows sums the partials over chunks in a fixed order: the result
// is deterministic, and against the plain version only the order of the
// f32 sums differs. The bias gradient is one more "part" of that GEMM, a
// row of ones against g.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace gemm1x1 {

using namespace nvcuda;

constexpr int THREADS = 256;   // 8 warps
constexpr int BM = 128;        // fwd / dgrad: pixels per block
constexpr int BK = 16;         // contraction depth per staging step
constexpr int KS = 64;         // wgrad: pixels per staging step
constexpr int WG_TILE_C = 32;  // wgrad: input channels per block
constexpr int MAX_PARTS = 6;   // five parts and the bias row

struct Part {
  const void* x;    // NHWC input; null for the bias row (ones)
  void* dx;         // NHWC gradient of x (dgrad)
  int cin, ups, stride, act, koff;
  int Hi, Wi;       // x's height and width
  long long first;  // dgrad: first block (x); wgrad: first tile (y)
  long long per;    // wgrad: pixels per chunk
};

struct Parts {
  Part p[MAX_PARTS];
  int P;
};

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

__device__ __forceinline__ void zero8(float* v) {
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = 0.0f;
}

// The compute type of a tensor type, and whether it runs on tensor cores.
template <typename T>
struct Cfg;
template <>
struct Cfg<__nv_bfloat16> {
  using S = __nv_bfloat16;
  static constexpr bool TC = true;
};
template <>
struct Cfg<float> {
  using S = float;
  static constexpr bool TC = false;
};

// Shared memory of the BM x BN tile GEMMs (fwd, dgrad): the staged A
// (BM x BK) and B (BK x BN) tiles, then the f32 result tile in their place.
template <typename S, int BN>
struct Layout {
  static constexpr int A_LD = BK + 8;
  static constexpr int B_LD = BN + 8;
  static constexpr int C_LD = BN + 4;
  static constexpr int A_BYTES = BM * A_LD * (int)sizeof(S);
  static constexpr int B_BYTES = BK * B_LD * (int)sizeof(S);
  static constexpr int C_BYTES = BM * C_LD * 4;
  static constexpr int SMEM = A_BYTES + B_BYTES > C_BYTES ? A_BYTES + B_BYTES : C_BYTES;
};

// One BK step of the BM x BN tile product, and the tile's store.
template <bool TC, int BN>
struct Mma;

template <int BN>
struct Mma<true, BN> {
  using L = Layout<__nv_bfloat16, BN>;
  static constexpr int WN = BN >= 64 ? 2 : 1;  // warps along N
  static constexpr int WM = 8 / WN;
  static constexpr int FM = BM / WM / 16;
  static constexpr int FN = BN / WN / 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
  int wm, wn;

  __device__ __forceinline__ void init(int tid) {
    const int warp = tid >> 5;
    wm = warp / WN;
    wn = warp % WN;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  }
  __device__ __forceinline__ void step(const __nv_bfloat16* As, const __nv_bfloat16* Bs) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[FM];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[FN];
#pragma unroll
    for (int i = 0; i < FM; ++i)
      wmma::load_matrix_sync(fa[i], As + (wm * FM * 16 + i * 16) * L::A_LD, L::A_LD);
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::load_matrix_sync(fb[j], Bs + wn * FN * 16 + j * 16, L::B_LD);
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
  }
  __device__ __forceinline__ void store(float* Cs) {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::store_matrix_sync(Cs + (wm * FM * 16 + i * 16) * L::C_LD + wn * FN * 16 + j * 16,
                                acc[i][j], L::C_LD, wmma::mem_row_major);
  }
};

template <int BN>
struct Mma<false, BN> {
  using L = Layout<float, BN>;
  static constexpr int TN = BN / 16;  // columns per thread, 16 apart
  static constexpr int TM = 8;        // rows per thread: 16 x 16 threads
  float acc[TM][TN];
  int ty, tx;

  __device__ __forceinline__ void init(int tid) {
    ty = tid >> 4;
    tx = tid & 15;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  }
  __device__ __forceinline__ void step(const float* As, const float* Bs) {
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[(ty * TM + i) * L::A_LD + kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk * L::B_LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  __device__ __forceinline__ void store(float* Cs) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) Cs[(ty * TM + i) * L::C_LD + tx + 16 * j] = acc[i][j];
  }
};

// The 8 channels [c, c + 8) of part pt at output pixel (n, h, w), as f32.
template <typename T>
__device__ __forceinline__ void gather8(const Part& pt, int n, int h, int w, int c, float* v) {
  const T* x = static_cast<const T*>(pt.x);
  const int hi = pt.stride > 1 ? h * pt.stride : h / pt.ups;
  const int wi = pt.stride > 1 ? w * pt.stride : w / pt.ups;
  Io<T>::load8(x + (((long long)n * pt.Hi + hi) * pt.Wi + wi) * pt.cin + c, v);
  if (pt.act) {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = fmaxf(v[e], 0.0f);
  }
}

// Channels [o, o + 8) of the f32 sum of the k rows h0 .. h0 + k - 1 of g at
// column w, left to right (the TPU kernel's _from_super order).
template <typename T>
__device__ __forceinline__ void rowsum8(const T* g, int n, int h0, int k, int w, int o, int H,
                                        int W, int cout, float* v) {
  Io<T>::load8(g + (((long long)n * H + h0) * W + w) * cout + o, v);
  for (int a = 1; a < k; ++a) {
    float u[8];
    Io<T>::load8(g + (((long long)n * H + h0 + a) * W + w) * cout + o, u);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] += u[e];
  }
}

// ------------------------------------------------------------- forward
//
// y[m, o] = sum_p sum_c gather_p(m)[c] * w[koff_p + c, o] + bias[o] over
// output pixels m: an implicit GEMM, BM pixels x BN output channels a
// block, each BK step staging one part's 16 channels.
template <typename T, int BN>
__device__ __forceinline__ void fwd_body(const Parts& parts, const typename Cfg<T>::S* __restrict__ w,
                                         const float* __restrict__ bias, T* __restrict__ y, int N,
                                         int H, int W, int cout) {
  using S = typename Cfg<T>::S;
  using L = Layout<S, BN>;
  __shared__ __align__(128) unsigned char smem[L::SMEM];
  S* As = reinterpret_cast<S*>(smem);
  S* Bs = reinterpret_cast<S*>(smem + L::A_BYTES);
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const long long M = (long long)N * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int o0 = blockIdx.y * BN;
  // A staging: one row and 8 channels a thread (BM * BK / 8 == THREADS)
  const int ar = tid >> 1, ac = (tid & 1) * 8;
  const long long m = m0 + ar;
  const bool mv = m < M;
  int n = 0, h = 0, wc = 0;
  if (mv) {
    wc = (int)(m % W);
    const long long t = m / W;
    h = (int)(t % H);
    n = (int)(t / H);
  }
  // B staging: BK * BN / 8 chunks of 8 output channels
  const int br = tid / (BN / 8), bc = (tid % (BN / 8)) * 8;
  const bool bthread = tid < BK * BN / 8;

  Mma<Cfg<T>::TC, BN> mma;
  mma.init(tid);
  for (int p = 0; p < parts.P; ++p) {
    const Part& pt = parts.p[p];
    for (int c0 = 0; c0 < pt.cin; c0 += BK) {
      float v[8];
      if (mv && c0 + ac < pt.cin) gather8<T>(pt, n, h, wc, c0 + ac, v);
      else zero8(v);
      Io<S>::store8(As + ar * L::A_LD + ac, v);
      if (bthread) {
        float u[8];
        const int k = c0 + br, o = o0 + bc;
        if (k < pt.cin && o < cout) Io<S>::load8(w + (long long)(pt.koff + k) * cout + o, u);
        else zero8(u);
        Io<S>::store8(Bs + br * L::B_LD + bc, u);
      }
      __syncthreads();
      mma.step(As, Bs);
      __syncthreads();
    }
  }
  mma.store(Cs);
  __syncthreads();
  for (int i = tid; i < BM * BN / 8; i += THREADS) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    const long long mm = m0 + r;
    const int o = o0 + c;
    if (mm < M && o < cout) {
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = Cs[r * L::C_LD + c + e] + bias[o + e];
      Io<T>::store8(y + mm * cout + o, v);
    }
  }
}

// --------------------------------------------------------------- wgrad
//
// dW[koff_p + c, o] = sum_q z_p(q)[c] * gg_p(q)[o] for every part, and the
// bias row sum_q g(q)[o]. q runs over pixels with the rows of the part's
// input and the columns of the output: for an upsampled part (k > 1) z is
// the input pixel (hq, wo / k) and gg = bf16(sum of the k rows hq*k + a of
// g at column wo), so the column replicas sum inside the f32 product, as in
// the TPU kernel; for the other parts q is the output pixel. Block
// (chunk, tile, o tile) takes WG_TILE_C input channels x BN output
// channels over one chunk of q and writes one partial tile; with few
// fragments a tile, warp groups split the staged pixels and are summed in
// a fixed order.
template <typename S, int BN>
struct WLayout {
  static constexpr int Z_LD = WG_TILE_C + 8;
  static constexpr int G_LD = BN + 8;
  static constexpr int Z_BYTES = KS * Z_LD * (int)sizeof(S);
  static constexpr int G_BYTES = KS * G_LD * (int)sizeof(S);
  static constexpr int F = (WG_TILE_C / 16) * (BN / 16);  // 16x16 fragments a tile
  static constexpr int G = 8 / F;                         // warp groups over pixels
  static constexpr int RED_BYTES = G * WG_TILE_C * BN * 4;
  static constexpr int SMEM = Z_BYTES + G_BYTES > RED_BYTES ? Z_BYTES + G_BYTES : RED_BYTES;
};

template <typename T, int BN>
__device__ __forceinline__ void wgrad_body(const Parts& parts, const T* __restrict__ g,
                                           float* __restrict__ part_out, int N, int H, int W,
                                           int cout, int krows) {
  using S = typename Cfg<T>::S;
  using WL = WLayout<S, BN>;
  constexpr int TC_ = WG_TILE_C;
  __shared__ __align__(128) unsigned char smem[WL::SMEM];
  S* Zs = reinterpret_cast<S*>(smem);
  S* Gs = reinterpret_cast<S*>(smem + WL::Z_BYTES);

  const int tid = threadIdx.x;
  int p = 0;
  while (p + 1 < parts.P && (long long)blockIdx.y >= parts.p[p + 1].first) ++p;
  const Part& pt = parts.p[p];
  const bool ones = pt.x == nullptr;
  const int c0 = (int)(blockIdx.y - pt.first) * TC_;
  const int o0 = blockIdx.z * BN;
  const int k = pt.ups;  // row replicas summed into gg (1 unless upsampled)
  const int Hq = H / k;
  const long long Q = (long long)N * Hq * W;
  const long long q_begin = (long long)blockIdx.x * pt.per;
  long long q_end = q_begin + pt.per;
  if (q_end > Q) q_end = Q;

  // TC: one fragment a warp; f32: BN / 8 outputs a thread
  const int warp = tid >> 5;
  const int kg = warp / WL::F, f = warp % WL::F;
  const int fc = f / (BN / 16), fo = f % (BN / 16);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  constexpr int OUT = TC_ * BN / THREADS;
  float sacc[OUT];
  if constexpr (Cfg<T>::TC) {
    wmma::fill_fragment(acc, 0.0f);
  } else {
#pragma unroll
    for (int j = 0; j < OUT; ++j) sacc[j] = 0.0f;
  }

  for (long long q0 = q_begin; q0 < q_end; q0 += KS) {
    {  // z: one pixel and 8 channels a thread (KS * 32 / 8 == THREADS)
      const int pix = tid >> 2, c8 = (tid & 3) * 8;
      const long long q = q0 + pix;
      float v[8];
      zero8(v);
      if (q < q_end && c0 + c8 < pt.cin) {
        const int wo = (int)(q % W);
        const long long t = q / W;
        const int hq = (int)(t % Hq);
        const int n = (int)(t / Hq);
        if (ones) v[0] = 1.0f;
        else gather8<T>(pt, n, hq * k, wo, c0 + c8, v);
      }
      Io<S>::store8(Zs + pix * WL::Z_LD + c8, v);
    }
    for (int i = tid; i < KS * BN / 8; i += THREADS) {
      const int pix = i / (BN / 8), o8 = (i % (BN / 8)) * 8;
      const long long q = q0 + pix;
      float v[8];
      zero8(v);
      if (q < q_end && o0 + o8 < cout) {
        const int wo = (int)(q % W);
        const long long t = q / W;
        const int hq = (int)(t % Hq);
        const int n = (int)(t / Hq);
        rowsum8<T>(g, n, hq * k, k, wo, o0 + o8, H, W, cout, v);
      }
      Io<S>::store8(Gs + pix * WL::G_LD + o8, v);
    }
    __syncthreads();
    if constexpr (Cfg<T>::TC) {
      // dW[c, o] += sum_q Zs[q][c] Gs[q][o]: A = Zs^T (col-major view)
#pragma unroll
      for (int kk = kg * (KS / WL::G); kk < (kg + 1) * (KS / WL::G); kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, reinterpret_cast<const __nv_bfloat16*>(Zs) + kk * WL::Z_LD + fc * 16,
                               WL::Z_LD);
        wmma::load_matrix_sync(fb, reinterpret_cast<const __nv_bfloat16*>(Gs) + kk * WL::G_LD + fo * 16,
                               WL::G_LD);
        wmma::mma_sync(acc, fa, fb, acc);
      }
    } else {
#pragma unroll
      for (int j = 0; j < OUT; ++j) {
        const int idx = tid + j * THREADS;
        const int c = idx / BN, o = idx % BN;
        float s = sacc[j];
        for (int kk = 0; kk < KS; ++kk)
          s = fmaf((float)Zs[kk * WL::Z_LD + c], (float)Gs[kk * WL::G_LD + o], s);
        sacc[j] = s;
      }
    }
    __syncthreads();
  }

  float* out = part_out + (long long)blockIdx.x * krows * cout;
  if constexpr (Cfg<T>::TC) {
    float* Red = reinterpret_cast<float*>(smem);  // [G][32][BN]
    wmma::store_matrix_sync(Red + (kg * TC_ + fc * 16) * BN + fo * 16, acc, BN, wmma::mem_row_major);
    __syncthreads();
    for (int i = tid; i < TC_ * BN; i += THREADS) {
      float s = Red[i];
#pragma unroll
      for (int r = 1; r < WL::G; ++r) s += Red[r * TC_ * BN + i];
      const int c = i / BN, o = i % BN;
      if (c0 + c < pt.cin && o0 + o < cout)
        out[(long long)(pt.koff + c0 + c) * cout + o0 + o] = s;
    }
  } else {
#pragma unroll
    for (int j = 0; j < OUT; ++j) {
      const int idx = tid + j * THREADS;
      const int c = idx / BN, o = idx % BN;
      if (c0 + c < pt.cin && o0 + o < cout)
        out[(long long)(pt.koff + c0 + c) * cout + o0 + o] = sacc[j];
    }
  }
}

// out[col] = sum over rows of part[row, col], in a fixed order.
__device__ __forceinline__ void reduce_rows_body(const float* __restrict__ part, long long rows,
                                                 long long cols, float* __restrict__ out) {
  __shared__ float sm[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long col = (long long)blockIdx.x * 32 + tx;
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

// ------------------------------------------------------------ host side

inline int bn_for(int c) { return c <= 16 ? 16 : (c <= 32 ? 32 : 64); }

inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// Fill the wgrad tiling of `parts` (the bias row last): each part's first
// tile and pixels per chunk. Returns the number of tiles along y.
inline long long wgrad_plan(Parts& parts, int N, int H, int W, int nchunks) {
  long long tiles = 0;
  for (int p = 0; p < parts.P; ++p) {
    Part& pt = parts.p[p];
    pt.first = tiles;
    tiles += ceil_div(pt.cin, WG_TILE_C);
    const long long Q = (long long)N * (H / pt.ups) * W;
    pt.per = ceil_div(ceil_div(Q, nchunks), KS) * KS;
  }
  return tiles;
}

}  // namespace gemm1x1
