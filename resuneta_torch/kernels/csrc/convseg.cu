// K1: fused BN affine -> ReLU -> dilated 3x3 conv (+ bias), NHWC, for sm_90a.
//
// Replaces resuneta_tpu/ops/pallas/convseg.py: bn_act_conv_pallas ->
// bn_act_conv_pallas_dense -> _segment_kernel (the pallas_call at :550).
// It computes
//
//   y[n,h,w,o] = bias[o] + sum_{ky,kx,c} zb[n, h+(ky-1)d, w+(kx-1)d, c]
//                                        * wb[ky,kx,c,o]
//   zb = bf16(act(x*a + b)) inside the image, 0 outside it
//
// with z = x*a + b rounded once to f32 (a fused multiply-add, as XLA
// computes it; the plain PyTorch version forms the exact product in f64 and
// rounds the sum to f32), rounded to bf16 once,
// wb = bf16(w), products summed in f32, the bias added in f32 and y written
// in x's type (bf16 or f32). Zero outside the image is the conv's SAME
// padding of z, not act(b).
//
// What bounds it. Per output pixel the segment does 18*C*Cout flops and
// must move C + Cout elements (x in, y out). At bf16 that is 144 flops a
// byte at C = 32 (below the H100's ~295 flops/byte ridge: bytes bound),
// 288 at C = 64 (balanced) and 576 at C = 128 (tensor-core bound).
//
// Design. An implicit GEMM on the tensor cores (WMMA bf16 16x16x16, f32
// accumulators): M = output pixels, N = Cout, K = 9 taps x C. A block owns
// 128 consecutive output pixels (row-major over n, h, w) by BN output
// channels. Each K step gathers, for one tap and 32 input channels, the
// tap-shifted input pixels of the tile, applies affine + ReLU + bf16
// rounding while it stages them into shared memory, and zero-fills pixels
// outside the image. So z never reaches device memory, and shared memory
// does not depend on the dilation: a (tile + 2d)-row halo window would need
// 62 halo rows at d = 31 (1 MB at C = 32, W = 256), far past the 227 KB a
// block may use, while the 9 tap gathers re-read x from L2. The next K
// step's global loads are issued before this step's MMAs (one register
// stage). No TMA, no wgmma, no pipelining beyond that: those are for a
// later, faster kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;       // output pixels per block
constexpr int BK = 32;        // input channels per K step
constexpr int THREADS = 256;  // 8 warps: 4 along M x 2 along N
constexpr int A_LD = BK + 8;  // padded smem row, a multiple of 8 elements
constexpr int MAX_C = 512;
constexpr int A_CHUNKS = BM * BK / 8 / THREADS;  // 8-channel chunks a thread stages

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

template <typename T, int BN>
__global__ void __launch_bounds__(THREADS)
convseg_kernel(const T* __restrict__ x, const float* __restrict__ a,
               const float* __restrict__ b, const __nv_bfloat16* __restrict__ w,
               const float* __restrict__ bias, T* __restrict__ y,
               int N, int H, int W, int C, int Cout, int d, int act) {
  constexpr int B_LD = BN + 8;
  constexpr int WARP_N = BN / 2;  // output channels per warp
  constexpr int FM = 2;           // 32 pixel rows per warp, 16 per fragment
  constexpr int FN = WARP_N / 16;
  constexpr int B_CHUNKS_ALL = BK * BN / 8;
  constexpr int B_CHUNKS = (B_CHUNKS_ALL + THREADS - 1) / THREADS;

  __shared__ __align__(128) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * B_LD];
  __shared__ __align__(128) float Cs[THREADS / 32][16 * 16];
  __shared__ float sa[MAX_C], sb[MAX_C];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int warp_m = warp >> 1, warp_n = warp & 1;
  const long long M = (long long)N * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int co0 = blockIdx.y * BN;

  for (int i = tid; i < C; i += THREADS) {
    sa[i] = a[i];
    sb[i] = b[i];
  }

  // The pixels this thread stages: chunk -> (tile row, 8-channel offset).
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

  const int kc_steps = C / BK;
  const int k_steps = 9 * kc_steps;

  float ra[A_CHUNKS][8];
  bool rv[A_CHUNKS];
  uint4 rb[B_CHUNKS];

  // Issue the global loads of K step ks into registers.
  auto load_global = [&](int ks) {
    const int tap = ks / kc_steps;
    const int c0 = (ks - tap * kc_steps) * BK;
    const int dy = (tap / 3 - 1) * d, dx = (tap % 3 - 1) * d;
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int hs = ph[i] + dy, ws = pw[i] + dx;
      rv[i] = pin[i] && hs >= 0 && hs < H && ws >= 0 && ws < W;
      if (rv[i]) {
        const long long off = (((long long)pn[i] * H + hs) * W + ws) * C + c0 + pc[i];
        Io<T>::load8(x + off, ra[i]);
      }
    }
#pragma unroll
    for (int j = 0; j < B_CHUNKS; ++j) {
      const int chunk = tid + j * THREADS;
      if (chunk < B_CHUNKS_ALL) {
        const int row = chunk / (BN / 8), col = (chunk % (BN / 8)) * 8;
        const long long off = (long long)(tap * C + c0 + row) * Cout + co0 + col;
        rb[j] = *reinterpret_cast<const uint4*>(w + off);
      }
    }
  };

  // z = bf16(act(x*a + b)) (0 outside the image) and the weights into smem.
  auto store_smem = [&](int ks) {
    const int c0 = (ks % kc_steps) * BK;
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int r = (tid + i * THREADS) / (BK / 8);
      float z[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = c0 + pc[i] + e;
        float v = __fmaf_rn(ra[i][e], sa[c], sb[c]);
        if (act) v = fmaxf(v, 0.0f);
        z[e] = rv[i] ? v : 0.0f;
      }
      Io<__nv_bfloat16>::store8(&As[r * A_LD + pc[i]], z);
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

  __syncthreads();  // sa, sb
  load_global(0);
  for (int ks = 0; ks < k_steps; ++ks) {
    store_smem(ks);
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

  // Epilogue: each fragment through a per-warp 16x16 f32 scratch, then
  // + bias in f32 and one 8-element store per lane.
  float* cs = Cs[warp];
  const int r = lane >> 1, cc = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const long long m = m0 + warp_m * 32 + i * 16 + r;
      const int co = co0 + warp_n * WARP_N + j * 16 + cc;
      if (m < M) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = cs[r * 16 + cc + e] + bias[co + e];
        Io<T>::store8(y + m * Cout + co, v);
      }
      __syncwarp();
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* a, const float* b, const __nv_bfloat16* w,
                   const float* bias, void* y, int N, int H, int W, int C, int Cout, int d,
                   int act, cudaStream_t stream) {
  const long long M = (long long)N * H * W;
  const unsigned gx = (unsigned)((M + BM - 1) / BM);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (Cout % 128 == 0) {
    convseg_kernel<T, 128><<<dim3(gx, Cout / 128), THREADS, 0, stream>>>(
        xt, a, b, w, bias, yt, N, H, W, C, Cout, d, act);
  } else if (Cout % 64 == 0) {
    convseg_kernel<T, 64><<<dim3(gx, Cout / 64), THREADS, 0, stream>>>(
        xt, a, b, w, bias, yt, N, H, W, C, Cout, d, act);
  } else {
    convseg_kernel<T, 32><<<dim3(gx, Cout / 32), THREADS, 0, stream>>>(
        xt, a, b, w, bias, yt, N, H, W, C, Cout, d, act);
  }
  return cudaGetLastError();
}

}  // namespace

// x, y: (N, H, W, C|Cout) contiguous, bf16 (x_is_bf16 = 1) or f32, 16-byte
// aligned; a, b: (C,) f32; w: (3, 3, C, Cout) HWIO bf16; bias: (Cout,) f32.
// C and Cout multiples of 32, C <= 512. Returns the cudaError_t of the launch.
extern "C" int convseg_forward(const void* x, const void* a, const void* b, const void* w,
                               const void* bias, void* y, int N, int H, int W, int C,
                               int Cout, int d, int act, int x_is_bf16, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || d <= 0 || C <= 0 || C % BK != 0 || C > MAX_C ||
      Cout <= 0 || Cout % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
  const float* biasf = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      x_is_bf16 ? launch<__nv_bfloat16>(x, af, bf, wb, biasf, y, N, H, W, C, Cout, d, act, s)
                : launch<float>(x, af, bf, wb, biasf, y, N, H, W, C, Cout, d, act, s);
  return (int)err;
}
