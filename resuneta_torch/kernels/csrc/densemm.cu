// K3: the 1x1 convolution over concat parts, NHWC, for sm_90a,
//
//   y = sum_p up_{k_p}(act_p?(x_p)) @ W_p + bias      (P <= 5 parts)
//
// with no concat and no upsampled tensor in device memory, and its
// backward: every dx_p, every dW_p and dbias. A part may also read every
// s-th row and column (stride s, the encoder's stride-2 1x1 convolutions):
// its dx is then full-resolution and zero at the pixels the convolution
// does not read.
//
// Replaces resuneta_tpu/ops/pallas/densemm.py: dense_mm -> _fwd_kernel (the
// pallas_call at :321) and _dense_mm_bwd -> _bwd_kernel (:355). What it
// leaves behind is the TPU's: the kron / block-diagonal weights, the
// super-row lane slices and the VMEM planner. On NHWC tensors a 1x1
// convolution is a plain GEMM over pixels whose A operand is gathered.
//
// Roundings, as densemm.py:190-262: x and W in the compute type, f32 sums
// and bias, one cast; in the backward the ROW replicas of g of an
// upsampled part are summed in f32 and rounded to bf16 before the product
// (:236-244), the COLUMN replicas sum inside the f32 accumulation; dW is
// f32 and dbias the f32 sum of g.
//
// What bounds it: widths 8 to 256 give 8 to 85 flops a byte, far below
// the H100's ~295 bf16 flops a byte: bytes. Every call moves each part,
// y (forward) or g and every dx (backward) once at best.
//
// bf16 (the train step): Hopper kernels, TMA-fed and mbarrier-pipelined,
// bf16 wgmma with f32 accumulators (sm90.cuh's pieces: tensor maps with
// zero fill, the stage ring, the swizzles, persistent blocks). A pixel
// tile is 128 pixels, a rectangle of one image (sm90::Geo), every block
// a producer warp that keeps TMA boxes in flight and two consumer
// warpgroups of 64 rows. Narrow tensors are padded by the boxes' zero
// fill: K to 16 (W's padded rows are zeros), M and N where they must be.
// * k3_fwd_kernel: M = the tile, N = all of cout (padded to 8, 16, ...,
//   256: one wgmma, two n128 at 256), K = each part's channels, 64 a step;
//   W^T stays in shared memory for the block's life. A part's box is of
//   16, 32 or 64 channels (the 32-, 64- or 128-byte swizzle). A plain
//   part's lands as the A operand; a strided part's comes through a map
//   of the output geometry whose strides are s times the part's, so TMA
//   reads only the pixels the convolution reads. An upsampled part (k = 2,
//   4, 8) comes as its low-resolution box (BW/k x BH/k pixels), a part
//   with the ReLU as its tile; the consumers form A from it in place (the
//   x k replication, the ReLU). The epilogue adds the f32 bias from the
//   accumulators and stores y. One read of every part, one write of y.
// * k3_rowsum_kernel (only where a part is upsampled): gg_k = bf16 of the
//   f32 sum of k rows of g, for each k, in one pass over g.
// * k3_dgrad_kernel: N = a column group's input channels: the parts at
//   the output's resolution or strided together (up to 256 columns: g is
//   read once for all of them), each upsampled part alone; M = a tile of
//   the group's geometry (the output's, or the upsampled part's input), K
//   = cout, or k x cout for an upsampled part: gg_k's k column replicas
//   come as the boxes of a 5-D map and sum inside the f32 product; W's
//   rows are B, K-major as they lie. A member with the ReLU has its x
//   boxes brought with the item's last K step for the mask. The epilogue
//   goes through a swizzled tile in shared memory and writes every dx with
//   16-byte stores; a strided part's unread pixels get zeros.
// * k3_wgrad_kernel: M = 64 channels of one part (a warpgroup, two a
//   unit), N = cout (padded to 64, 128 or 256), K = pixels, 64 a stage;
//   x and g (or gg_k) are MN-major operands as TMA lays them down, an
//   upsampled part's x replicated along the row in place. A block sums
//   its pixel chunk in registers and writes one partial dW; a unit of an
//   upsampled part takes a k-th of the chunks, the one dbias unit also
//   sums g's columns from the staged boxes. densemm_reduce_kernel sums
//   the partials over chunks in a fixed order: deterministic, and against
//   the plain version only the order of the f32 sums differs.
// A forward call is one launch, a backward call three (dgrad, wgrad, the
// sum), four with an upsampled part (the row sums first).
//
// f32 (the card-against-CPU check): PR 3's CUDA-core tiles of
// gemm1x1.cuh, kept as they are: a block gathers one part's 16 channels a
// step into shared memory; three backward launches.

#include "gemm1x1.cuh"
#include "sm90.cuh"

#include <type_traits>

using namespace gemm1x1;

namespace {

// ------------------------------------------- f32: PR 3's kernels (gemm1x1.cuh)

template <typename T, int BN>
__global__ void __launch_bounds__(THREADS)
densemm_fwd_kernel(Parts parts, const typename Cfg<T>::S* __restrict__ w,
                   const float* __restrict__ bias, T* __restrict__ y, int N, int H, int W,
                   int cout) {
  fwd_body<T, BN>(parts, w, bias, y, N, H, W, cout);
}

template <typename T, int BN>
__global__ void __launch_bounds__(THREADS)
densemm_wgrad_kernel(Parts parts, const T* __restrict__ g, float* __restrict__ part_out, int N,
                     int H, int W, int cout, int krows) {
  wgrad_body<T, BN>(parts, g, part_out, N, H, W, cout, krows);
}

__global__ void __launch_bounds__(1024)
densemm_reduce_kernel(const float* __restrict__ part, long long rows, long long cols,
                      float* __restrict__ out) {
  reduce_rows_body(part, rows, cols, out);
}

// dx_p[i, c] = mask_p * sum_{b, o} gg_p(i, b)[o] * W[koff_p + c, o] over the
// input pixels i of each part: b runs over the k column replicas of an
// upsampled part (gg = bf16 of the f32 sum of its k row replicas); a
// strided part reads g only where both coordinates are multiples of s and
// is zero elsewhere; mask_p = 1[x_p > 0] where the part has the ReLU. A
// block takes BM input pixels x BN channels of one part (blocks laid out
// part after part along x), a BK step 16 channels of g.
template <typename T, int BN>
__global__ void __launch_bounds__(THREADS)
densemm_dgrad_kernel(Parts parts, const T* __restrict__ g, const typename Cfg<T>::S* __restrict__ wT,
                     int ktot, int N, int H, int W, int cout) {
  using S = typename Cfg<T>::S;
  using L = Layout<S, BN>;
  __shared__ __align__(128) unsigned char smem[L::SMEM];
  S* As = reinterpret_cast<S*>(smem);
  S* Bs = reinterpret_cast<S*>(smem + L::A_BYTES);
  float* Cs = reinterpret_cast<float*>(smem);

  int p = 0;
  while (p + 1 < parts.P && (long long)blockIdx.x >= parts.p[p + 1].first) ++p;
  const Part& pt = parts.p[p];
  const int c0 = blockIdx.y * BN;
  if (c0 >= pt.cin) return;  // uniform over the block

  const int tid = threadIdx.x;
  const long long Mi = (long long)N * pt.Hi * pt.Wi;
  const long long m0 = ((long long)blockIdx.x - pt.first) * BM;
  const int ar = tid >> 1, ao = (tid & 1) * 8;
  const long long i = m0 + ar;
  const bool iv = i < Mi;
  int n = 0, hi = 0, wi = 0;
  if (iv) {
    wi = (int)(i % pt.Wi);
    const long long t = i / pt.Wi;
    hi = (int)(t % pt.Hi);
    n = (int)(t / pt.Hi);
  }
  const int s = pt.stride;
  const bool sampled = s <= 1 || (hi % s == 0 && wi % s == 0);
  const int br = tid / (BN / 8), bc = (tid % (BN / 8)) * 8;
  const bool bthread = tid < BK * BN / 8;

  Mma<Cfg<T>::TC, BN> mma;
  mma.init(tid);
  for (int b = 0; b < pt.ups; ++b) {
    for (int o0 = 0; o0 < cout; o0 += BK) {
      float v[8];
      zero8(v);
      if (iv && sampled && o0 + ao < cout) {
        if (pt.ups > 1) rowsum8<T>(g, n, hi * pt.ups, pt.ups, wi * pt.ups + b, o0 + ao, H, W, cout, v);
        else if (s > 1) rowsum8<T>(g, n, hi / s, 1, wi / s, o0 + ao, H, W, cout, v);
        else rowsum8<T>(g, n, hi, 1, wi, o0 + ao, H, W, cout, v);
      }
      Io<S>::store8(As + ar * L::A_LD + ao, v);
      if (bthread) {
        float u[8];
        const int o = o0 + br, c = c0 + bc;
        if (o < cout && c < pt.cin) Io<S>::load8(wT + (long long)o * ktot + pt.koff + c, u);
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
  const T* x = static_cast<const T*>(pt.x);
  T* dx = static_cast<T*>(pt.dx);
  for (int e8 = tid; e8 < BM * BN / 8; e8 += THREADS) {
    const int r = e8 / (BN / 8), c = (e8 % (BN / 8)) * 8;
    const long long ii = m0 + r;
    const int cc = c0 + c;
    if (ii < Mi && cc < pt.cin) {
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = Cs[r * L::C_LD + c + e];
      if (pt.act) {
        float xv[8];
        Io<T>::load8(x + ii * pt.cin + cc, xv);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (!(xv[e] > 0.0f)) v[e] = 0.0f;
      }
      Io<T>::store8(dx + ii * pt.cin + cc, v);
    }
  }
}

Parts make_parts(const void* const* xs, void* const* dxs, const int* cins, const int* ups,
                 const int* strides, const int* acts, int P, int H, int W) {
  Parts parts{};
  parts.P = P;
  int koff = 0;
  for (int p = 0; p < P; ++p) {
    Part& pt = parts.p[p];
    pt.x = xs[p];
    pt.dx = dxs ? dxs[p] : nullptr;
    pt.cin = cins[p];
    pt.ups = ups[p] > 1 ? ups[p] : 1;
    pt.stride = strides[p] > 1 ? strides[p] : 1;
    pt.act = acts[p];
    pt.koff = koff;
    pt.Hi = pt.stride > 1 ? H * pt.stride : H / pt.ups;
    pt.Wi = pt.stride > 1 ? W * pt.stride : W / pt.ups;
    koff += pt.cin;
  }
  return parts;
}

bool valid(const int* cins, const int* ups, const int* strides, int P, int N, int H, int W,
           int cout) {
  if (P < 1 || P > MAX_PARTS - 1 || N <= 0 || H <= 0 || W <= 0 || cout <= 0 || cout % 8) return false;
  for (int p = 0; p < P; ++p) {
    if (cins[p] <= 0 || cins[p] % 8) return false;
    if (ups[p] > 1 && strides[p] > 1) return false;
    if (ups[p] > 1 && (H % ups[p] || W % ups[p])) return false;
  }
  return true;
}

template <typename T>
cudaError_t f32_forward(const Parts& parts, const void* w, const float* bias, void* y, int N, int H,
                    int W, int cout, int* launched, cudaStream_t stream) {
  using S = typename Cfg<T>::S;
  const int bn = bn_for(cout);
  const dim3 grid((unsigned)ceil_div((long long)N * H * W, BM), (unsigned)ceil_div(cout, bn));
  const S* ws = static_cast<const S*>(w);
  T* yt = static_cast<T*>(y);
  if (bn == 16) densemm_fwd_kernel<T, 16><<<grid, THREADS, 0, stream>>>(parts, ws, bias, yt, N, H, W, cout);
  else if (bn == 32) densemm_fwd_kernel<T, 32><<<grid, THREADS, 0, stream>>>(parts, ws, bias, yt, N, H, W, cout);
  else densemm_fwd_kernel<T, 64><<<grid, THREADS, 0, stream>>>(parts, ws, bias, yt, N, H, W, cout);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return err;
}

template <typename T>
cudaError_t f32_backward(Parts parts, const void* g, const void* wT, float* dwb, float* work,
                     int nchunks, int N, int H, int W, int cout, int* launched,
                     cudaStream_t stream) {
  using S = typename Cfg<T>::S;
  const T* gt = static_cast<const T*>(g);
  const S* wTs = static_cast<const S*>(wT);
  const int P = parts.P;
  int ktot = 0, cmax = 0;
  long long blocks = 0;
  for (int p = 0; p < P; ++p) {
    Part& pt = parts.p[p];
    pt.first = blocks;
    blocks += ceil_div((long long)N * pt.Hi * pt.Wi, BM);
    ktot += pt.cin;
    if (pt.cin > cmax) cmax = pt.cin;
  }
  // dgrad: every part's dx
  {
    const int bn = bn_for(cmax);
    const dim3 grid((unsigned)blocks, (unsigned)ceil_div(cmax, bn));
    if (bn == 16) densemm_dgrad_kernel<T, 16><<<grid, THREADS, 0, stream>>>(parts, gt, wTs, ktot, N, H, W, cout);
    else if (bn == 32) densemm_dgrad_kernel<T, 32><<<grid, THREADS, 0, stream>>>(parts, gt, wTs, ktot, N, H, W, cout);
    else densemm_dgrad_kernel<T, 64><<<grid, THREADS, 0, stream>>>(parts, gt, wTs, ktot, N, H, W, cout);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
  }
  // wgrad: every dW_p and the bias row, per chunk
  Parts wp = parts;
  Part& bias_row = wp.p[P];
  bias_row = Part{};
  bias_row.x = nullptr;
  bias_row.cin = 1;
  bias_row.ups = 1;
  bias_row.stride = 1;
  bias_row.koff = ktot;
  bias_row.Hi = H;
  bias_row.Wi = W;
  wp.P = P + 1;
  const long long tiles = wgrad_plan(wp, N, H, W, nchunks);
  const int krows = ktot + 1;
  {
    const int bn = bn_for(cout);
    const dim3 grid((unsigned)nchunks, (unsigned)tiles, (unsigned)ceil_div(cout, bn));
    if (bn == 16) densemm_wgrad_kernel<T, 16><<<grid, THREADS, 0, stream>>>(wp, gt, work, N, H, W, cout, krows);
    else if (bn == 32) densemm_wgrad_kernel<T, 32><<<grid, THREADS, 0, stream>>>(wp, gt, work, N, H, W, cout, krows);
    else densemm_wgrad_kernel<T, 64><<<grid, THREADS, 0, stream>>>(wp, gt, work, N, H, W, cout, krows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
  }
  const long long cols = (long long)krows * cout;
  densemm_reduce_kernel<<<(unsigned)ceil_div(cols, 32), dim3(32, 32), 0, stream>>>(work, nchunks, cols, dwb);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return err;
}

}  // namespace

// ------------------------------------------------ bf16: the Hopper kernels

namespace k3 {

using bf16 = __nv_bfloat16;
using sm90::Geo;

constexpr int CONSUMERS = 256;              // two warpgroups
constexpr int WARPS = CONSUMERS / 32;       // consumer warps: each arrives on `empty`
constexpr int THREADS = CONSUMERS + 32;     // and the producer warp
constexpr int CB = 64;                      // channels of an operand row
constexpr int ROW = 2 * CB;                 // its bytes: the 128-byte swizzle
constexpr int TILE = 128;                   // fwd / dgrad: pixels a tile
constexpr int WPIX = 64;                    // wgrad: pixels a stage
constexpr int A_BYTES = TILE * ROW;         // a tile's A operand (16 KB)
constexpr int WG_BYTES = 64 * ROW;          // a warpgroup's 64 rows (8 KB)
constexpr int MAXP = 5;
constexpr int MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 220 * 1024;      // 227 KB less the static shared memory
constexpr int TWO_BLOCKS = 110 * 1024;      // dynamic shared memory of one of two blocks an SM
constexpr int W_BUDGET = 128 * 1024;        // fwd / dgrad: W resident in shared memory
constexpr int MAX_UNITS = 16;
constexpr int X_ROOM = 32 * 1024;           // dgrad: the x boxes a stage may bring

struct KPart {
  const bf16* x;
  bf16* dx;
  int cin, ups, stride, act, koff;
  int Hi, Wi;         // x's height and width
  int slices;         // ceil(cin / 64): K steps (fwd), M tiles (wgrad)
  int bwk, bhk;       // fwd: its box's columns and rows (the tile's at ups 1)
  int rb;             // fwd: its box's row bytes (2 row_ch(cin))
  Geo geo;            // its tiling: the output's, at ups > 1 its input's
};

struct KParams {
  KPart p[MAXP];
  int P, N, H, W, cout, ktot;
  int grb;            // dgrad: the row bytes of g's and gg's boxes (2 row_ch(cout))
  Geo geo;            // the output's tiling: 128 pixels (fwd, dgrad) or 64 (wgrad)
};

// fwd: one map a part; dgrad: g's at m[MAXP], an upsampled part's gg_k
// at m[p], a part's x (for its ReLU mask) at m[MAXP + 4 + p]; wgrad: the
// parts' x at m[p], g's at m[MAXP], gg_k's at m[MAXP + log2 k]
struct Maps {
  CUtensorMap m[2 * MAXP + 4];
};

// wgrad: a unit's M tiles (part, 64-channel slice) for its two
// warpgroups (p = -1: none), all of one k (its parts' ups) and so of one
// pixel tiling, over `chunks` blocks; `dbias` for the one unit that also
// sums g
struct Unit {
  int dbias, k, p[2], sl[2];
  int chunks, first;  // its blocks (pixel chunks) and the first one's index
  Geo geo;
};
struct Units {
  Unit u[MAX_UNITS];
  int n;
};

// dgrad: a column group, whose dx come from one GEMM: the parts at the
// output's resolution or strided, packed while their channels fit one
// wgmma N (256), or one upsampled part; member m's channels are columns
// [col[m], col[m] + its cin)
struct DGroup {
  int k, n, width;
  int part[MAXP], col[MAXP];
  int xoff[MAXP];   // a member with the ReLU: its x boxes' offset in the stage's x room, else -1
  int xbytes;       // those boxes' bytes, brought with the item's last K step
  long long first;  // its first work item
  Geo geo;          // its tiling: the output's, or the upsampled part's input's
};
struct DGroups {
  DGroup g[MAXP];
  int n;
};

// Blocks an SM must hold: two up to 64 accumulator columns (the register
// budget then caps a thread at 112; one register more leaves one block an
// SM, and the narrow calls of the path run at half speed), else one.
template <int NP>
constexpr int MIN_BLOCKS = NP <= 64 ? 2 : 1;

// the smallest wgmma width >= n that the kernels instantiate
inline int pad_n(int n) {
  int p = 8;
  while (p < n) p *= 2;
  return p;
}

// The channels of an operand row over a tensor of c channels: 16, 32 or
// 64, the 32-, 64- or 128-byte swizzle. TMA streams a box whose rows are
// mostly zero fill (8 channels of 64) far slower than one of exact rows.
__host__ __device__ inline int row_ch(int c) { return c <= 16 ? 16 : (c <= 32 ? 32 : CB); }

// the swizzle and the wgmma descriptor layout of rows of rb bytes
__device__ __forceinline__ uint32_t swz(uint32_t o, int rb) {
  return o ^ ((o >> 3) & (uint32_t)(rb - 16));  // sm90::swizzle<rb>, rb a runtime value
}
__device__ __forceinline__ uint32_t layout(int rb) { return rb == 128 ? 1 : (rb == 64 ? 2 : 3); }

// Copies a kernel-parameter struct into shared memory: the kernels index
// its arrays with values known only at run time, and such a load from
// the parameter space waits about as long as one from device memory.
template <typename T>
__device__ __forceinline__ void to_shared(T& dst, const T& src, int tid) {
  static_assert(sizeof(T) % 4 == 0, "whole words");
  int* d = reinterpret_cast<int*>(&dst);
  const int* from = reinterpret_cast<const int*>(&src);
  for (int i = tid; i < (int)(sizeof(T) / 4); i += THREADS) d[i] = from[i];
}

__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// bf16 pairs with the sign bit set become +0 (the ReLU of bf16 values)
__device__ __forceinline__ uint4 relu8(uint4 v) {
  uint32_t* u = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) u[i] &= ~(((u[i] & 0x80008000u) >> 15) * 0xFFFFu);
  return v;
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return u;
}

__device__ __forceinline__ void add8(const bf16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] += f.x;
    v[2 * i + 1] += f.y;
  }
}

// D[64 x NP] += A[64 x 16] B[16 x NP]: one wgmma, two n128 at NP = 256
// (the second B `half` bytes on); T = 1 for MN-major operands
template <int NP, int T>
__device__ __forceinline__ void mma(float* acc, uint64_t da, const unsigned char* b, int half,
                                    uint32_t lbo) {
  if constexpr (NP <= 128) {
    sm90::wgmma<NP, T, T>(acc, da, sm90::desc(b, lbo, 1024, 1));
  } else {
    sm90::wgmma<128, T, T>(acc, da, sm90::desc(b, lbo, 1024, 1));
    sm90::wgmma<128, T, T>(acc + 64, da, sm90::desc(b + half, lbo, 1024, 1));
  }
}

// The accumulator layout of a warpgroup's 64 x NP tile: this thread holds
// rows row(hh) = 16 (warp % 4) + lane / 4 + 8 hh, columns 8j + 2 (lane % 4)
// + {0, 1} at acc[4j + 2hh + {0, 1}] (at NP = 256 the second n128's 64
// values follow the first's, the same formula).
__device__ __forceinline__ int acc_row(int warp, int lane, int hh) {
  return (warp & 3) * 16 + (lane >> 2) + 8 * hh;
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// dgrad's epilogue goes through a tile scratch ys, 128 rows (pixels) of
// 64 channels in bf16, 128-byte rows swizzled, each warpgroup its 64 rows:
// this writes the warpgroup's accumulator columns c in [64 q, 64 q + 64)
// (+ bias[c], bias in shared memory, where given) into it, so that threads
// then store whole 16-byte chunks of a pixel, neighbours on neighbouring
// addresses. Four-byte stores straight from the accumulators, each with
// its part's address arithmetic and the ReLU mask's load, cost more than
// the rest of the tile (the forward's lean epilogue stores straight).
template <int NP>
__device__ __forceinline__ void acc_to_tile(const float* acc, unsigned char* ys, int q, int wg,
                                            int warp, int lane, const float* bias) {
  const int q2 = 2 * (lane & 3);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = wg * 64 + acc_row(warp, lane, hh);
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
      if ((j >> 3) != q) continue;
      const int c = 8 * j + q2;
      const float b0 = bias ? bias[c] : 0.0f, b1 = bias ? bias[c + 1] : 0.0f;
      *reinterpret_cast<__nv_bfloat162*>(ys + sm90::swizzle<128>(r * ROW + (j & 7) * 16) + q2 * 2) =
          __floats2bfloat162_rn(acc[4 * j + 2 * hh] + b0, acc[4 * j + 2 * hh + 1] + b1);
    }
  }
}

// v's bf16 values where x's are not > 0 become +0 (the ReLU's mask)
__device__ __forceinline__ uint4 mask8(uint4 v, uint4 x) {
  uint32_t* vv = reinterpret_cast<uint32_t*>(&v);
  const __nv_bfloat162* xx = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(xx[i]);
    if (!(f.x > 0.0f)) vv[i] &= 0xFFFF0000u;
    if (!(f.y > 0.0f)) vv[i] &= 0x0000FFFFu;
  }
  return v;
}

// -------------------------------------------------------------- forward

// A block walks output tiles blockIdx.x, + gridDim.x, ...; a tile's K
// steps are (part, 64-channel slice), every one a ring stage holding the
// part's swizzled box of 64 channels (zero-filled past its cin; TMA
// streams 128-byte rows far faster than narrower ones). A plain or
// strided part's box is the A operand as it lands. A part with the ReLU
// or an upsample is formed in place: its box is the low-resolution
// pixels the tile replicates (BW/k x BH/k); every consumer reads the
// chunks its rows take (pixel r of the tile from the pixel r maps to; the
// ReLU), all meet where rows move (k > 1), then each writes its rows in
// the swizzled layout. The stage is freed once the wgmma has read it.
// Dynamic shared memory: W^T's regions (one a step: NP rows of output
// channels x 64 input channels, K-major, swizzled), the ring, the tile
// scratch of the epilogue.
template <int NP>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS<NP>)
k3_fwd_kernel(const __grid_constant__ Maps maps, const __grid_constant__ KParams kp_,
              const bf16* __restrict__ wT, const float* __restrict__ bias, bf16* __restrict__ y,
              int stages) {
  extern __shared__ unsigned char dsmem[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  __shared__ float sbias[NP];
  __shared__ KParams kp;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  to_shared(kp, kp_, tid);
  __syncthreads();
  int wslices = 0;
  for (int p = 0; p < kp.P; ++p) wslices += kp.p[p].slices;
  unsigned char* wsm = sm90::align1024(dsmem);
  unsigned char* ring = wsm + wslices * NP * ROW;

  for (int i = tid; i < wslices * NP * 8; i += THREADS) {
    const int r = i >> 3, ch = i & 7;
    const int sl = r / NP, n = r - sl * NP;
    int p = 0, first = 0;
    while (sl >= first + kp.p[p].slices) first += kp.p[p++].slices;
    const KPart& pt = kp.p[p];
    const int c = (sl - first) * CB + ch * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (n < kp.cout && c < pt.cin)
      v = *reinterpret_cast<const uint4*>(wT + (long long)n * kp.ktot + pt.koff + c);
    *reinterpret_cast<uint4*>(wsm + sl * NP * ROW + sm90::swizzle<128>(n * ROW + ch * 16)) = v;
  }
  for (int i = tid; i < NP; i += THREADS) sbias[i] = i < kp.cout ? bias[i] : 0.0f;
  if (tid == 0) sm90::ring_init(full, empty, stages, WARPS);
  sm90::fence_proxy_async();
  __syncthreads();
  const Geo& geo = kp.geo;

  if (warp == WARPS) {
    if (lane == 0) {
      int gs = 0;
      for (long long t = blockIdx.x; t < geo.tiles; t += gridDim.x) {
        int n, h0, w0;
        sm90::tile_origin(geo, t, n, h0, w0);
        for (int p = 0; p < kp.P; ++p) {
          const KPart& pt = kp.p[p];
          const uint32_t bytes = pt.bwk * pt.bhk * pt.rb;
          for (int sl = 0; sl < pt.slices; ++sl, ++gs) {
            const int s = gs % stages;
            sm90::ring_acquire(full, empty, s, gs / stages, bytes);
            sm90::tma_load_4d(ring + s * A_BYTES, &maps.m[p], &full[s], sl * CB, w0 / pt.ups,
                              h0 / pt.ups, n);
          }
        }
      }
    }
    return;
  }

  const int wg = warp >> 2, t128 = tid & 127;
  const int bw = 1 << geo.bw_log2;
  int gs = 0;
  for (long long t = blockIdx.x; t < geo.tiles; t += gridDim.x) {
    int n, h0, w0;
    sm90::tile_origin(geo, t, n, h0, w0);
    float acc[NP / 2];
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) acc[i] = 0.0f;
    int pend = -1;  // the stage whose wgmma is in flight, freed once it is done
    int wsl = 0;    // the step's region of W^T
    for (int p = 0; p < kp.P; ++p) {
      const KPart& pt = kp.p[p];
      for (int sl = 0; sl < pt.slices; ++sl, ++gs, ++wsl) {
        const int s = gs % stages;
        sm90::mbar_wait(&full[s], (gs / stages) & 1);
        unsigned char* A = ring + s * A_BYTES;
        const int rb = pt.rb, cpr = rb / 16;  // row bytes, chunks a row
        if (pt.ups > 1 || pt.act) {
          // thread t128 takes chunk ch of rows r0, r0 + 128 / cpr, ...
          // (cpr / 2 of them); its source pixel rr * bwk + rc, k = 2^kl
          const int kl = __ffs(pt.ups) - 1, act = pt.act, bwk = pt.bwk;
          const int cl = __ffs(cpr) - 1, ch = t128 & (cpr - 1);
          const int r0 = wg * 64 + (t128 >> cl), dr = 128 >> cl;
          uint4 v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (u >= cpr / 2) break;
            const int r = r0 + u * dr;
            const int rr = ((h0 + (r >> geo.bw_log2)) >> kl) - (h0 >> kl);
            const int rc = ((w0 + (r & (bw - 1))) >> kl) - (w0 >> kl);
            v[u] = *reinterpret_cast<const uint4*>(A + swz((rr * bwk + rc) * rb + ch * 16, rb));
            if (act) v[u] = relu8(v[u]);
          }
          if (kl) sm90::consumers_sync<CONSUMERS>();
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (u >= cpr / 2) break;
            *reinterpret_cast<uint4*>(A + swz((r0 + u * dr) * rb + ch * 16, rb)) = v[u];
          }
          sm90::fence_proxy_async();
          wg_sync(wg);
        }
        const unsigned char* As = A + wg * 64 * rb;
        const unsigned char* Bs = wsm + wsl * NP * ROW;
        const int ksteps = (min(CB, pt.cin - sl * CB) + 15) / 16;
        sm90::wgmma_fence();
        for (int kk = 0; kk < ksteps; ++kk)
          mma<NP, 0>(acc, sm90::desc(As + kk * 32, 16, 8 * rb, layout(rb)), Bs + kk * 32,
                     128 * ROW, 16);
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
        if (pend >= 0 && lane == 0) sm90::mbar_arrive(&empty[pend]);
        pend = s;
      }
    }
    sm90::wgmma_wait<0>();
    if (pend >= 0 && lane == 0) sm90::mbar_arrive(&empty[pend]);

    // y straight from the accumulators, + bias in f32: this thread's rows
    // r and r + 8 of the warpgroup's 64, channels 8j + 2 (lane % 4) + {0, 1}
    const int q2 = 2 * (lane & 3);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = wg * 64 + acc_row(warp, lane, hh);
      const int h = h0 + (r >> geo.bw_log2), w = w0 + (r & (bw - 1));
      if (h < geo.H && w < geo.W) {
        bf16* dst = y + (((long long)n * geo.H + h) * geo.W + w) * kp.cout;
#pragma unroll
        for (int j = 0; j < NP / 8; ++j) {
          const int c = 8 * j + q2;
          if (c < kp.cout) store2(dst + c, acc[4 * j + 2 * hh] + sbias[c], acc[4 * j + 2 * hh + 1] + sbias[c + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- dgrad

// Work items: every column group's tiles, group after group. Every K
// step is a ring stage: a k = 1 group's are g's 64-channel boxes of the
// tile (maps.m[MAXP]); an upsampled part's are (column replica b, 64
// channels) of gg = bf16(f32 sum of k rows of g), which
// k3_rowsum_kernel wrote, through a 5-D map (channels, replica, input
// column, input row, image) whose box at replica b is the tile's gg at
// columns w*k + b (maps.m[p]). Dynamic shared memory: W's regions (one a
// (group, 64 channels of cout): NP rows of the group's input channels x
// 64 output channels, K-major, swizzled), the ring, the tile scratch of
// the epilogue.
template <int NP>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS<NP>)
k3_dgrad_kernel(const __grid_constant__ Maps maps, const __grid_constant__ KParams kp_,
                const __grid_constant__ DGroups gr_, const bf16* __restrict__ w, long long items,
                int stages, int sb) {
  extern __shared__ unsigned char dsmem[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  __shared__ KParams kp;
  __shared__ DGroups gr;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  to_shared(kp, kp_, tid);
  to_shared(gr, gr_, tid);
  __syncthreads();
  const int cout = kp.cout, nos = (cout + CB - 1) / CB;
  unsigned char* wsm = sm90::align1024(dsmem);
  unsigned char* ring = wsm + gr.n * nos * NP * ROW;

  for (int i = tid; i < gr.n * nos * NP * 8; i += THREADS) {
    const int r = i >> 3, ch = i & 7;
    const int reg = r / NP, c = r - reg * NP;
    const int gi = reg / nos, o = (reg - gi * nos) * CB + ch * 8;
    const DGroup& G = gr.g[gi];
    uint4 v = make_uint4(0, 0, 0, 0);
    for (int m = 0; m < G.n; ++m) {
      const KPart& pt = kp.p[G.part[m]];
      if (c >= G.col[m] && c < G.col[m] + pt.cin && o < cout)
        v = *reinterpret_cast<const uint4*>(w + (long long)(pt.koff + c - G.col[m]) * cout + o);
    }
    *reinterpret_cast<uint4*>(wsm + reg * NP * ROW + sm90::swizzle<128>(c * ROW + ch * 16)) = v;
  }
  if (tid == 0) sm90::ring_init(full, empty, stages, WARPS);
  sm90::fence_proxy_async();
  __syncthreads();

  auto locate = [&](long long item, int& gi, long long& t) {
    gi = 0;
    while (gi + 1 < gr.n && item >= gr.g[gi + 1].first) ++gi;
    t = item - gr.g[gi].first;
  };

  if (warp == WARPS) {
    if (lane == 0) {
      int gs = 0;
      for (long long item = blockIdx.x; item < items; item += gridDim.x) {
        int gi, n, h0, w0;
        long long t;
        locate(item, gi, t);
        const DGroup& G = gr.g[gi];
        sm90::tile_origin(G.geo, t, n, h0, w0);
        for (int st = 0; st < G.k * nos; ++st, ++gs) {
          const int s = gs % stages, b = st / nos, os = st - b * nos;
          const bool last = st == G.k * nos - 1;
          unsigned char* stage = ring + s * sb;
          sm90::ring_acquire(full, empty, s, gs / stages, TILE * kp.grb + (last ? G.xbytes : 0));
          if (G.k > 1)
            sm90::tma_load_5d(stage, &maps.m[G.part[0]], &full[s], os * CB, b, w0, h0, n);
          else
            sm90::tma_load_4d(stage, &maps.m[MAXP], &full[s], os * CB, w0, h0, n);
          for (int m = 0; last && m < G.n; ++m) {
            if (G.xoff[m] < 0) continue;
            const KPart& pt = kp.p[G.part[m]];
            for (int sl = 0; sl * CB < pt.cin; ++sl)
              sm90::tma_load_4d(stage + A_BYTES + G.xoff[m] + sl * TILE * pt.rb,
                                &maps.m[MAXP + 4 + G.part[m]], &full[s], sl * CB, w0, h0, n);
          }
        }
      }
    }
    return;
  }

  const int wg = warp >> 2, t128 = tid & 127;
  unsigned char* ybuf = ring + stages * sb;
  int gs = 0;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    int gi, n, h0, w0;
    long long t;
    locate(item, gi, t);
    const DGroup& G = gr.g[gi];
    const Geo& geo = G.geo;
    const int bw = 1 << geo.bw_log2;
    sm90::tile_origin(geo, t, n, h0, w0);
    float acc[NP / 2];
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) acc[i] = 0.0f;
    for (int st = 0; st < G.k * nos; ++st, ++gs) {
      const int s = gs % stages, os = st % nos;
      sm90::mbar_wait(&full[s], (gs / stages) & 1);
      const unsigned char* As = ring + s * sb + wg * 64 * kp.grb;
      const unsigned char* Bs = wsm + (gi * nos + os) * NP * ROW;
      const int ksteps = (min(CB, cout - os * CB) + 15) / 16;
      sm90::wgmma_fence();
      for (int kk = 0; kk < ksteps; ++kk)
        mma<NP, 0>(acc, sm90::desc(As + kk * 32, 16, 8 * kp.grb, layout(kp.grb)), Bs + kk * 32,
                   128 * ROW, 16);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      if (st > 0 && lane == 0) sm90::mbar_arrive(&empty[(gs - 1) % stages]);
    }
    sm90::wgmma_wait<0>();
    // the last stage also holds the x boxes of the members with the ReLU
    const unsigned char* xs = ring + ((gs - 1) % stages) * sb + A_BYTES;

    // dx of each member at its input pixel (s*h, s*w), 64 columns a pass
    // through ys; a strided part's other pixels of the s x s block are
    // zero
    for (int q = 0; q * CB < G.width; ++q) {
      wg_sync(wg);  // the warpgroup's reads of its rows of ys are done
      acc_to_tile<NP>(acc, ybuf, q, wg, warp, lane, nullptr);
      wg_sync(wg);
      // thread t128 takes chunk ch (8 channels) of rows r0, r0 + 16, ...:
      // one member, found once a pass
      const int ch = t128 & 7, c = q * CB + ch * 8, r0 = wg * 64 + (t128 >> 3);
      if (c >= G.width) continue;
      int m = 0;
      while (m + 1 < G.n && c >= G.col[m + 1]) ++m;
      const KPart& pt = kp.p[G.part[m]];
      const int cc = c - G.col[m], sd = pt.stride, cin = pt.cin, Hi = pt.Hi, Wi = pt.Wi;
      const int xoff = pt.act ? G.xoff[m] : -2, xrb = pt.rb;
      const unsigned char* xbox = xs + (xoff > 0 ? xoff : 0) + (cc / CB) * TILE * xrb;
      const bf16* x = pt.x + cc;
      bf16* dx = pt.dx + cc;
#pragma unroll 1
      for (int u = 0; u < 4; ++u) {
        const int r = r0 + 16 * u;
        const int h = h0 + (r >> geo.bw_log2), wc = w0 + (r & (bw - 1));
        if (h >= geo.H || wc >= geo.W) continue;
        const long long pix = ((long long)n * Hi + h * sd) * Wi + wc * sd;
        uint4 v = *reinterpret_cast<const uint4*>(ybuf + sm90::swizzle<128>(r * ROW + ch * 16));
        if (xoff >= 0)
          v = mask8(v, *reinterpret_cast<const uint4*>(xbox + swz(r * xrb + (cc % CB) * 2, xrb)));
        else if (xoff == -1)
          v = mask8(v, *reinterpret_cast<const uint4*>(x + pix * cin));
        *reinterpret_cast<uint4*>(dx + pix * cin) = v;
        for (int bb = 1; bb < sd; ++bb)
          *reinterpret_cast<uint4*>(dx + (pix + bb) * cin) = make_uint4(0, 0, 0, 0);
      }
    }
    // a strided part's rows s*h + a, a > 0, under this warpgroup's pixels
    // are all zero: 16-byte stores over each contiguous run of them
    for (int m = 0; m < G.n; ++m) {
      const KPart& pt = kp.p[G.part[m]];
      const int sd = pt.stride;
      if (sd == 1) continue;
      const int segw = bw < 64 ? bw : 64;
      for (int seg = 0; seg < 64 / segw; ++seg) {
        const int r = wg * 64 + seg * segw;
        const int h = h0 + (r >> geo.bw_log2), c0 = w0 + (r & (bw - 1));
        if (h >= geo.H || c0 >= geo.W) continue;
        const int n16 = (min(c0 + segw, geo.W) - c0) * sd * pt.cin / 8;
        for (int a = 1; a < sd; ++a) {
          uint4* row = reinterpret_cast<uint4*>(
              pt.dx + (((long long)n * pt.Hi + h * sd + a) * pt.Wi + c0 * sd) * pt.cin);
          for (int i = tid & 127; i < n16; i += 128) row[i] = make_uint4(0, 0, 0, 0);
        }
      }
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[(gs - 1) % stages]);
  }
}

// gg_k = bf16(f32 sum of k rows of g), top to bottom (the reference's
// _from_super order), for every k of `kmask` (bit j: k = 2^j, k <= 8)
// into ws: gg_2, gg_4, gg_8 as present, each (N, H/k, W, cout). A thread
// takes 8 channels of one column over kmax rows, one f32 running sum for
// each k.
__global__ void __launch_bounds__(256)
k3_rowsum_kernel(const bf16* __restrict__ g, bf16* __restrict__ ws, int N, int H, int W,
                 int cout, int kmask, int kmax) {
  const int c8 = cout / 8;
  const long long total = (long long)N * (H / kmax) * W * c8;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int o = (int)(i % c8) * 8;
  long long r = i / c8;
  const int w = (int)(r % W);
  r /= W;
  const int hb = (int)(r % (H / kmax)), n = (int)(r / (H / kmax));
  bf16* out[4];
  long long off = 0;
  for (int j = 1; j <= 3; ++j) {
    out[j] = ws + off;
    if (kmask >> j & 1) off += (long long)N * (H >> j) * W * cout;
  }
  float acc[4][8] = {};
  for (int a = 0; a < kmax; ++a) {
    const int h = hb * kmax + a;
    float v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    add8(g + (((long long)n * H + h) * W + w) * cout + o, v);
#pragma unroll
    for (int j = 1; j <= 3; ++j) {
      if (!(kmask >> j & 1)) continue;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[j][e] = (a & ((1 << j) - 1)) ? acc[j][e] + v[e] : v[e];
      if (((a + 1) & ((1 << j) - 1)) == 0) {
        const long long row = ((long long)n * (H >> j) + (h >> j)) * W + w;
        *reinterpret_cast<uint4*>(out[j] + row * cout + o) = pack8(acc[j]);
      }
    }
  }
}

// ---------------------------------------------------------------- wgrad

// Block -> (unit, chunk): warpgroup v sums dW rows [64 sl, 64 sl + 64) of
// part p = unit.p[v] over the chunk's pixels q: D[c][o] += z(q)[c] gg(q)[o],
// both operands MN-major (64-pixel rows of 64 channels, swizzled, as TMA
// lays a box down). A unit's q are the 64-pixel tiles of its geometry (a
// chunk: a run of them): the output's for its k = 1 parts, (input row,
// output column) for an upsampled part's (k > 1). Each stage brings the
// unit's B boxes (NP / 64 of them: g's at k = 1, gg_k's, written by
// k3_rowsum_kernel, else) and its parts' x boxes: a strided part's
// through its map of the output geometry; an upsampled part's of BW / k
// x BH pixels, which its warpgroup replicates k times along the row in
// place. All are swizzled 64-channel boxes. The ReLU is applied in place or in that pass. The dbias unit sums g's columns
// from the staged boxes: thread (rg, ch) takes 8 channels of rows rg, rg
// + RG, ...; the RG partial rows are summed in order at the end. Each
// block writes its rows of the chunk's partial dW (and the bias row) once.
template <int NP>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS<NP>)
k3_wgrad_kernel(const __grid_constant__ Maps maps, const __grid_constant__ KParams kp_,
                const __grid_constant__ Units units, float* __restrict__ part, int nchunks,
                int stages) {
  constexpr int NB = NP / CB;                  // B boxes across NP
  constexpr int CH = NP / 8;                   // dbias: 16-byte chunks of a row
  constexpr int RG = CONSUMERS / CH;           // dbias: row groups
  constexpr int REGION = WPIX * ROW;           // a box: WPIX pixels of 64 channels
  constexpr int STAGE = (NB + 2) * REGION;
  extern __shared__ unsigned char dsmem[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  __shared__ KParams kp;
  __shared__ Unit u;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int ui = 0;
  while (ui + 1 < units.n && (int)blockIdx.x >= units.u[ui + 1].first) ++ui;
  to_shared(kp, kp_, tid);
  to_shared(u, units.u[ui], tid);
  __syncthreads();
  unsigned char* ring = sm90::align1024(dsmem);
  const int chunk = blockIdx.x - u.first;
  const int cout = kp.cout, k = u.k;
  const Geo& geo = u.geo;
  const int bw = 1 << geo.bw_log2;
  const long long per = (geo.tiles + u.chunks - 1) / u.chunks;
  const long long t_begin = min((long long)chunk * per, geo.tiles);
  const long long t_end = min(t_begin + per, geo.tiles);
  const int steps = (int)(t_end - t_begin);
  const int lg = __ffs(k) - 1;  // k = 2^lg
  const CUtensorMap* map_b = &maps.m[MAXP + lg];
  if (tid == 0) sm90::ring_init(full, empty, stages, WARPS);
  __syncthreads();

  if (warp == WARPS) {
    if (lane == 0) {
      uint32_t bytes = NB * REGION;
      for (int v = 0; v < 2; ++v) bytes += u.p[v] >= 0 ? WPIX / k * ROW : 0;
      for (int i = 0; i < steps; ++i) {
        const int s = i % stages;
        sm90::ring_acquire(full, empty, s, i / stages, bytes);
        unsigned char* st = ring + s * STAGE;
        int n, h0, w0;
        sm90::tile_origin(geo, t_begin + i, n, h0, w0);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          sm90::tma_load_4d(st + nb * REGION, map_b, &full[s], nb * CB, w0, h0, n);
        for (int v = 0; v < 2; ++v)
          if (u.p[v] >= 0)
            sm90::tma_load_4d(st + (NB + v) * REGION, &maps.m[u.p[v]], &full[s], u.sl[v] * CB,
                              w0 / k, h0, n);
      }
    }
    return;
  }

  const int wg = warp >> 2, t128 = tid & 127;
  const int p = u.p[wg];
  const KPart* pt = p >= 0 ? &kp.p[p] : nullptr;
  const int act = pt ? pt->act : 0;
  float acc[NP / 2];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) acc[i] = 0.0f;
  float db[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  const int dch = tid % CH, drg = tid / CH;

  for (int i = 0; i < steps; ++i) {
    const int s = i % stages;
    sm90::mbar_wait(&full[s], (i / stages) & 1);
    unsigned char* st = ring + s * STAGE;
    unsigned char* As = st + (NB + wg) * REGION;
    if (pt && k > 1) {
      // z in place of the raw box: row q = (tile row, column c) from the
      // box's pixel c / k, read by the warpgroup before it overwrites
      constexpr int U = WPIX * 8 / 128;  // 16-byte chunks a thread
      uint4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = t128 + 128 * u, q = e >> 3;
        const int rr = q >> geo.bw_log2, rc = (q & (bw - 1)) >> lg;
        v[u] = *reinterpret_cast<const uint4*>(
            As + sm90::swizzle<128>((rr * (bw >> lg) + rc) * ROW + (e & 7) * 16));
        if (act) v[u] = relu8(v[u]);
      }
      wg_sync(wg);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = t128 + 128 * u;
        *reinterpret_cast<uint4*>(As + sm90::swizzle<128>((e >> 3) * ROW + (e & 7) * 16)) = v[u];
      }
      sm90::fence_proxy_async();
      wg_sync(wg);
    } else if (act) {
      for (int e = t128; e < WPIX * 8; e += 128) {
        uint4* c = reinterpret_cast<uint4*>(As + e * 16);
        *c = relu8(*c);
      }
      sm90::fence_proxy_async();
      wg_sync(wg);
    }
    if (u.dbias)
      for (int r = drg; r < WPIX; r += RG)
        add8(reinterpret_cast<const bf16*>(st + (dch >> 3) * REGION +
                                           sm90::swizzle<128>(r * ROW + (dch & 7) * 16)),
             db);
    sm90::wgmma_fence();
    if (pt)
#pragma unroll
      for (int kk = 0; kk < WPIX / 16; ++kk)
        mma<NP, 1>(acc, sm90::desc(As + kk * 16 * ROW, REGION, 1024, 1), st + kk * 16 * ROW,
                   2 * REGION, REGION);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    if (i > 0 && lane == 0) sm90::mbar_arrive(&empty[(i - 1) % stages]);
  }
  sm90::wgmma_wait<0>();
  if (steps > 0 && lane == 0) sm90::mbar_arrive(&empty[(steps - 1) % stages]);

  // the unit's rows of partial `chunk`, and zeros in the partials its
  // u.chunks do not reach (slots chunk + u.chunks, ... < nchunks), which the
  // fixed-order sum reads too
  const long long slot = (long long)(kp.ktot + 1) * cout;
  float* out = part + chunk * slot;
  if (pt) {
    const int q2 = 2 * (lane & 3);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c = u.sl[wg] * CB + acc_row(warp, lane, hh);
      if (c >= pt->cin) continue;
      float* row = out + (long long)(pt->koff + c) * cout;
#pragma unroll
      for (int j = 0; j < NP / 8; ++j) {
        const int o = 8 * j + q2;
        if (o >= cout) continue;
        *reinterpret_cast<float2*>(row + o) = make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
        for (int z = chunk + u.chunks; z < nchunks; z += u.chunks)
          *reinterpret_cast<float2*>(row + (z - chunk) * slot + o) = make_float2(0.0f, 0.0f);
      }
    }
  }
  if (u.dbias) {
    // every TMA load has landed and every wgmma is done: the ring is free
    sm90::consumers_sync<CONSUMERS>();
    float* red = reinterpret_cast<float*>(ring);  // [RG][NP]
#pragma unroll
    for (int e = 0; e < 8; ++e) red[drg * NP + dch * 8 + e] = db[e];
    sm90::consumers_sync<CONSUMERS>();
    for (int o = tid; o < cout; o += CONSUMERS) {
      float v = red[o];
      for (int r = 1; r < RG; ++r) v += red[r * NP + o];
      out[(long long)kp.ktot * cout + o] = v;
      for (int z = chunk + u.chunks; z < nchunks; z += u.chunks)
        out[(z - chunk) * slot + (long long)kp.ktot * cout + o] = 0.0f;
    }
  }
}

}  // namespace k3

// ------------------------------------------------------ bf16: host side

namespace k3 {

// Why the bf16 kernels refuse a call, or null (ops/densemm.py states the
// same limits): N up to 256 in one wgmma; ups 1, 2, 4 or 8; a part at
// the output's resolution or strided (the dbias pass rides on its
// blocks); W resident in shared memory.
const char* refusal(const int* cins, const int* ups, int P, int cout) {
  if (cout > 256) return "cout > 256";
  int wslices = 0, full_res = 0;
  for (int p = 0; p < P; ++p) {
    if (cins[p] > 256) return "cin > 256";
    if (ups[p] > 1 && (ups[p] & (ups[p] - 1))) return "ups not a power of two";
    if (ups[p] > 8) return "ups > 8";
    full_res |= ups[p] <= 1;
    wslices += (cins[p] + CB - 1) / CB;
  }
  if (!full_res) return "no part at the output's resolution";
  if ((long long)wslices * pad_n(cout) * ROW > W_BUDGET) return "W^T over the forward's budget";
  // dgrad's column groups (as backward forms them): the k = 1 parts while
  // they fit 256 columns, each upsampled part alone
  int groups = 0, wmax = 0, open = 0;
  for (int k = 1; k <= 8; k *= 2)
    for (int p = 0; p < P; ++p) {
      if ((ups[p] > 1 ? ups[p] : 1) != k) continue;
      if (!groups || k > 1 || open + cins[p] > 256) {
        ++groups;
        open = 0;
      }
      open = k > 1 ? cins[p] : open + cins[p];
      wmax = open > wmax ? open : wmax;
    }
  if ((long long)groups * ((cout + CB - 1) / CB) * pad_n(wmax) * ROW > W_BUDGET)
    return "W over dgrad's budget";
  return nullptr;
}

KParams make_params(const void* const* xs, void* const* dxs, const int* cins, const int* ups,
                    const int* strides, const int* acts, int P, int N, int H, int W, int cout,
                    int pix) {
  KParams kp{};
  kp.P = P;
  kp.N = N;
  kp.H = H;
  kp.W = W;
  kp.cout = cout;
  kp.geo = sm90::make_geo(N, H, W, pix);
  kp.grb = 2 * row_ch(cout);
  const int bw = 1 << kp.geo.bw_log2;
  int koff = 0;
  for (int p = 0; p < P; ++p) {
    KPart& pt = kp.p[p];
    pt.x = static_cast<const bf16*>(xs[p]);
    pt.dx = dxs ? static_cast<bf16*>(dxs[p]) : nullptr;
    pt.cin = cins[p];
    pt.ups = ups[p] > 1 ? ups[p] : 1;
    pt.stride = strides[p] > 1 ? strides[p] : 1;
    pt.act = acts[p];
    pt.koff = koff;
    pt.Hi = pt.stride > 1 ? H * pt.stride : H / pt.ups;
    pt.Wi = pt.stride > 1 ? W * pt.stride : W / pt.ups;
    pt.slices = (pt.cin + CB - 1) / CB;
    pt.bwk = bw / pt.ups;
    pt.bhk = kp.geo.bh >= pt.ups ? kp.geo.bh / pt.ups : 1;
    pt.rb = 2 * row_ch(pt.cin);
    pt.geo = pt.ups > 1 ? sm90::make_geo(N, pt.Hi, pt.Wi, TILE) : kp.geo;
    koff += pt.cin;
  }
  kp.ktot = koff;
  return kp;
}

// A map over part pt at the output's geometry (a strided part: its
// strides s times the part's, so a box holds only the pixels read; an
// upsampled part: its own geometry), boxes of box_c channels x box_w x
// box_h, swizzled by their rows.
bool part_map(CUtensorMap* m, const KPart& pt, int N, int box_w, int box_h, int box_c) {
  const cuuint64_t s = pt.stride, c = pt.cin;
  const cuuint64_t dims[4] = {c, (cuuint64_t)pt.Wi / s, (cuuint64_t)pt.Hi / s, (cuuint64_t)N};
  const cuuint64_t strides[3] = {s * c * 2, s * pt.Wi * c * 2, (cuuint64_t)pt.Hi * pt.Wi * c * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_c, (cuuint32_t)box_w, (cuuint32_t)box_h, 1};
  return sm90::make_map(m, pt.x, 4, dims, strides, box, 2 * box_c);
}

// A map over an (N, H, W, C) bf16 tensor, boxes of box_c channels x the
// tiling's BW x BH pixels, swizzled by their rows.
bool nhwc_map(CUtensorMap* m, const void* t, int N, int H, int W, int C, const Geo& geo,
              int box_c) {
  const cuuint64_t c = C;
  const cuuint64_t dims[4] = {c, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t strides[3] = {c * 2, W * c * 2, (cuuint64_t)H * W * c * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_c, (cuuint32_t)(1 << geo.bw_log2), (cuuint32_t)geo.bh, 1};
  return sm90::make_map(m, t, 4, dims, strides, box, 2 * box_c);
}

// dgrad's map over gg_k (N, H/k, W, cout) as (channels, replica b,
// input column, input row, image): a box at replica b holds gg at
// columns w*k + b of an input-pixel tile.
bool gg_dgrad_map(CUtensorMap* m, const void* gg, const KParams& kp, const KPart& pt) {
  const cuuint64_t c = kp.cout, k = pt.ups;
  const cuuint64_t dims[5] = {c, k, (cuuint64_t)pt.Wi, (cuuint64_t)pt.Hi, (cuuint64_t)kp.N};
  const cuuint64_t strides[4] = {c * 2, k * c * 2, kp.W * c * 2, (cuuint64_t)pt.Hi * kp.W * c * 2};
  const cuuint32_t box[5] = {(cuuint32_t)kp.grb / 2, 1, (cuuint32_t)(1 << pt.geo.bw_log2),
                            (cuuint32_t)pt.geo.bh, 1};
  return sm90::make_map(m, gg, 5, dims, strides, box, kp.grb);
}

template <int V>
using Int = std::integral_constant<int, V>;

template <typename F>
cudaError_t by_np(int np, F&& f) {
  switch (np) {
    case 8: return f(Int<8>{});
    case 16: return f(Int<16>{});
    case 32: return f(Int<32>{});
    case 64: return f(Int<64>{});
    case 128: return f(Int<128>{});
    case 256: return f(Int<256>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename F>
cudaError_t by_np_wide(int np, F&& f) {
  switch (np) {
    case 64: return f(Int<64>{});
    case 128: return f(Int<128>{});
    case 256: return f(Int<256>{});
    default: return cudaErrorInvalidValue;
  }
}

// Stages of `stage` bytes beside `fixed` bytes: at most MAX_STAGES, and
// fewer (but three or more) where that lets two blocks share an SM.
int ring_stages(int fixed, int stage) {
  int s = (SMEM_LIMIT - 1024 - fixed) / stage;
  s = s > MAX_STAGES ? MAX_STAGES : s;
  const int two = (TWO_BLOCKS - 1024 - fixed) / stage;
  return two >= 3 && two < s ? two : s;
}

cudaError_t forward(const KParams& kp, const void* wT, const float* bias, void* y,
                    int* launched, cudaStream_t stream) {
  Maps maps;
  int wslices = 0;
  for (int p = 0; p < kp.P; ++p) {
    const KPart& pt = kp.p[p];
    wslices += pt.slices;
    if (!part_map(&maps.m[p], pt, kp.N, pt.bwk, pt.bhk, pt.rb / 2)) return cudaErrorNotSupported;
  }
  const int np = pad_n(kp.cout);
  const int wbytes = wslices * np * ROW;
  const int stages = ring_stages(wbytes, A_BYTES);
  if (stages < 2) return cudaErrorInvalidValue;
  const int smem = 1024 + wbytes + stages * A_BYTES;
  cudaError_t err = by_np(np, [&](auto c) {
    constexpr int NP = decltype(c)::value;
    auto kernel = k3_fwd_kernel<NP>;
    long long grid = 0;
    cudaError_t e = sm90::wave_blocks(kernel, THREADS, smem, SMEM_LIMIT, &grid);
    if (e != cudaSuccess) return e;
    if (grid > kp.geo.tiles) grid = kp.geo.tiles;
    kernel<<<(unsigned)grid, THREADS, smem, stream>>>(maps, kp, static_cast<const bf16*>(wT),
                                                      bias, static_cast<bf16*>(y), stages);
    return cudaGetLastError();
  });
  if (err == cudaSuccess) ++*launched;
  return err;
}

// the gg_k workspace of k3_rowsum_kernel: gg_2, gg_4, gg_8 as present
// (bit j of kmask: k = 2^j), each (N, H/k, W, cout) bf16
long long gg_offset(const KParams& kp, int kmask, int j) {
  long long off = 0;
  for (int i = 1; i < j; ++i)
    if (kmask >> i & 1) off += (long long)kp.N * (kp.H >> i) * kp.W * kp.cout;
  return off;
}

int log2i(int k) {
  int j = 0;
  while ((1 << j) < k) ++j;
  return j;
}

// the wgrad block rows, k = 1, 2, 4, 8 in turn: the 64-channel slices of
// that k's parts, two a row (the first row of k = 1 also sums dbias),
// tiled over the output (k = 1) or (input row, output column), each
// over ceil(nchunks / k) blocks
Units make_units(const KParams& kp, int nchunks) {
  Units us{};
  int blocks = 0;
  for (int k = 1; k <= 8; k *= 2) {
    int list[2 * 4 * MAXP], m = 0;
    for (int p = 0; p < kp.P; ++p)
      if (kp.p[p].ups == k)
        for (int sl = 0; sl < kp.p[p].slices; ++sl) {
          list[m++] = p;
          list[m++] = sl;
        }
    for (int i = 0; i < m; i += 4) {
      Unit& u = us.u[us.n];
      u.dbias = us.n == 0 && k == 1;
      u.k = k;
      u.p[0] = list[i];
      u.sl[0] = list[i + 1];
      u.p[1] = i + 2 < m ? list[i + 2] : -1;
      u.sl[1] = i + 2 < m ? list[i + 3] : 0;
      u.geo = sm90::make_geo(kp.N, kp.H / k, kp.W, WPIX);
      // chunks in proportion to the unit's pixels: a k-th of the rows
      u.chunks = (nchunks + k - 1) / k;
      u.first = blocks;
      blocks += u.chunks;
      ++us.n;
    }
  }
  return us;
}

cudaError_t backward(const KParams& kd, const KParams& kw, const void* g, const void* w,
                     float* dwb, float* work, int nchunks, int* launched, cudaStream_t stream) {
  const int cout = kd.cout;
  bf16* ws = reinterpret_cast<bf16*>(work + (long long)nchunks * (kd.ktot + 1) * cout);
  int kmask = 0, kmax = 1;
  for (int p = 0; p < kd.P; ++p)
    if (kd.p[p].ups > 1) {
      kmask |= kd.p[p].ups;
      kmax = kd.p[p].ups > kmax ? kd.p[p].ups : kmax;
    }
  // gg_k for the upsampled parts
  if (kmask) {
    const long long threads = (long long)kd.N * (kd.H / kmax) * kd.W * (cout / 8);
    k3_rowsum_kernel<<<(unsigned)ceil_div(threads, 256), 256, 0, stream>>>(
        static_cast<const bf16*>(g), ws, kd.N, kd.H, kd.W, cout, kmask, kmax);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
  }
  // dgrad: every column group's tiles
  {
    const KParams& kp = kd;
    Maps maps;
    DGroups gr{};
    long long items = 0;
    int wmax = 0, xroom = 0;
    for (int k = 1; k <= 8; k *= 2)
      for (int p = 0; p < kp.P; ++p) {
        const KPart& pt = kp.p[p];
        if (pt.ups != k) continue;
        DGroup* G = gr.n ? &gr.g[gr.n - 1] : nullptr;
        if (!G || k > 1 || G->k > 1 || G->width + pt.cin > 256) {
          G = &gr.g[gr.n++];
          G->k = k;
          G->geo = pt.geo;
          G->first = items;
          items += pt.geo.tiles;
        }
        G->part[G->n] = p;
        G->xoff[G->n] = -1;
        if (pt.act) {
          // its x boxes ride with the last K step, while they fit X_ROOM
          const int bytes = (pt.cin + CB - 1) / CB * TILE * pt.rb;
          if (G->xbytes + bytes <= X_ROOM) {
            G->xoff[G->n] = G->xbytes;
            G->xbytes += bytes;
            xroom = G->xbytes > xroom ? G->xbytes : xroom;
            if (!part_map(&maps.m[MAXP + 4 + p], pt, kp.N, 1 << G->geo.bw_log2, G->geo.bh,
                          pt.rb / 2))
              return cudaErrorNotSupported;
          }
        }
        G->col[G->n++] = G->width;
        G->width += pt.cin;
        wmax = G->width > wmax ? G->width : wmax;
        if (k > 1 && !gg_dgrad_map(&maps.m[p], ws + gg_offset(kp, kmask, log2i(k)), kp, pt))
          return cudaErrorNotSupported;
      }
    if (!nhwc_map(&maps.m[MAXP], g, kp.N, kp.H, kp.W, cout, kp.geo, kp.grb / 2))
      return cudaErrorNotSupported;
    const int np = pad_n(wmax), nos = (cout + CB - 1) / CB;
    const int wbytes = gr.n * nos * np * ROW;
    const int sb = A_BYTES + xroom;  // a stage: g's box, then the x boxes
    const int stages = ring_stages(wbytes + A_BYTES, sb);  // and the tile scratch
    if (stages < 2) return cudaErrorInvalidValue;
    const int smem = 1024 + wbytes + stages * sb + A_BYTES;
    const cudaError_t err = by_np(np, [&](auto c) {
      constexpr int NP = decltype(c)::value;
      auto kernel = k3_dgrad_kernel<NP>;
      long long grid = 0;
      cudaError_t e = sm90::wave_blocks(kernel, THREADS, smem, SMEM_LIMIT, &grid);
      if (e != cudaSuccess) return e;
      if (grid > items) grid = items;
      kernel<<<(unsigned)grid, THREADS, smem, stream>>>(maps, kp, gr, static_cast<const bf16*>(w),
                                                        items, stages, sb);
      return cudaGetLastError();
    });
    if (err != cudaSuccess) return err;
    ++*launched;
  }
  // wgrad: the chunks' partial dW and bias rows
  {
    Maps maps;
    const Geo& geo = kw.geo;
    const int bw = 1 << geo.bw_log2;
    for (int p = 0; p < kw.P; ++p) {
      const KPart& pt = kw.p[p];
      const bool ok = part_map(&maps.m[p], pt, kw.N, bw / pt.ups, geo.bh, CB);
      if (!ok) return cudaErrorNotSupported;
    }
    if (!nhwc_map(&maps.m[MAXP], g, kw.N, kw.H, kw.W, cout, geo, CB)) return cudaErrorNotSupported;
    for (int j = 1; j <= 3; ++j)
      if ((kmask >> j & 1) && !nhwc_map(&maps.m[MAXP + j], ws + gg_offset(kw, kmask, j), kw.N,
                                        kw.H >> j, kw.W, cout, geo, CB))
        return cudaErrorNotSupported;
    const Units units = make_units(kw, nchunks);
    const Unit& last = units.u[units.n - 1];
    const int np = pad_n(cout) < CB ? CB : pad_n(cout);
    const int stage = (np / CB + 2) * WPIX * ROW;
    const int stages = ring_stages(0, stage);
    if (stages < 2) return cudaErrorInvalidValue;
    const int smem = 1024 + stages * stage;
    const cudaError_t err = by_np_wide(np, [&](auto c) {
      constexpr int NP = decltype(c)::value;
      auto kernel = k3_wgrad_kernel<NP>;
      cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           SMEM_LIMIT);
      if (e != cudaSuccess) return e;
      kernel<<<(unsigned)(last.first + last.chunks), THREADS, smem, stream>>>(
          maps, kw, units, work, nchunks, stages);
      return cudaGetLastError();
    });
    if (err != cudaSuccess) return err;
    ++*launched;
  }
  const long long cols = (long long)(kd.ktot + 1) * cout;
  densemm_reduce_kernel<<<(unsigned)ceil_div(cols, 32), dim3(32, 32), 0, stream>>>(work, nchunks,
                                                                                  cols, dwb);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return err;
}

}  // namespace k3

// xs[p]: (N, H/ups_p, W/ups_p, cins[p]) or, for a strided part,
// (N, H*s, W*s, cins[p]) NHWC, contiguous, bf16 (is_bf16 = 1) or f32,
// 16-byte aligned; w: for bf16 x W^T, (cout, sum cins) bf16, for f32 x W,
// (sum cins, cout) f32; bias: (cout,) f32; y: (N, H, W, cout) in x's type.
// cins and cout multiples of 8, P <= 5; bf16 also within k3::refusal's
// limits. Adds the kernels it launched to *launched (one) and returns the
// cudaError_t of the launch.
extern "C" int densemm_forward(const void* const* xs, const int* cins, const int* ups,
                               const int* strides, const int* acts, int P, const void* w,
                               const void* bias, void* y, int N, int H, int W, int cout,
                               int is_bf16, int* launched, void* stream) {
  if (!valid(cins, ups, strides, P, N, H, W, cout)) return (int)cudaErrorInvalidValue;
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (k3::refusal(cins, ups, P, cout)) return (int)cudaErrorInvalidValue;
    const k3::KParams kp =
        k3::make_params(xs, nullptr, cins, ups, strides, acts, P, N, H, W, cout, k3::TILE);
    return (int)k3::forward(kp, w, b, y, launched, s);
  }
  const Parts parts = make_parts(xs, nullptr, cins, ups, strides, acts, P, H, W);
  return (int)f32_forward<float>(parts, w, b, y, N, H, W, cout, launched, s);
}

// As densemm_forward for xs; g: (N, H, W, cout) in x's type; w: for bf16
// x W, (sum cins, cout) bf16, for f32 x W^T, (cout, sum cins) f32. Writes
// dxs[p] (x_p's shape and type), dwb: (sum cins + 1, cout) f32, the weight
// gradient with the bias gradient as its last row; work: nchunks * (sum
// cins + 1) * cout floats, the per-chunk partials of dwb. Adds the kernels
// it launched to *launched (three when all go: dgrad, wgrad, the
// reduction) and returns the first cudaError_t.
extern "C" int densemm_backward(const void* const* xs, const int* cins, const int* ups,
                                const int* strides, const int* acts, int P, const void* g,
                                const void* w, void* const* dxs, void* dwb, void* work,
                                int nchunks, int N, int H, int W, int cout, int is_bf16,
                                int* launched, void* stream) {
  if (!valid(cins, ups, strides, P, N, H, W, cout) || nchunks < 1) return (int)cudaErrorInvalidValue;
  float* d = static_cast<float*>(dwb);
  float* wk = static_cast<float*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (k3::refusal(cins, ups, P, cout)) return (int)cudaErrorInvalidValue;
    const k3::KParams kd =
        k3::make_params(xs, dxs, cins, ups, strides, acts, P, N, H, W, cout, k3::TILE);
    const k3::KParams kw =
        k3::make_params(xs, dxs, cins, ups, strides, acts, P, N, H, W, cout, k3::WPIX);
    return (int)k3::backward(kd, kw, g, w, d, wk, nchunks, launched, s);
  }
  const Parts parts = make_parts(xs, dxs, cins, ups, strides, acts, P, H, W);
  return (int)f32_backward<float>(parts, g, w, d, wk, nchunks, N, H, W, cout, launched, s);
}
