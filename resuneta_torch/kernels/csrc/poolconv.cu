// K4: k x k / stride-k max pool followed by a 1x1 convolution, NHWC, for
// sm_90a,
//
//   y = maxpool_k(x) @ W + bias,   k in {2, 4, 8},
//
// with no pooled tensor in device memory, and its backward
//
//   dz = g @ W^T,   dx = 1[x == pooled] * dz / ties,   dW, dbias,
//
// where ties counts the elements of a window equal to its max: a tie splits
// the gradient equally (jnp.max's VJP, not F.max_pool2d's, which routes it
// to one element).
//
// Replaces resuneta_tpu/ops/pallas/poolconv.py: pool_conv -> _fwd_kernel
// (the pallas_call at :237) and _pool_conv_bwd -> _bwd_kernel (:264). What
// it leaves behind is the TPU's: the lane rolls of the column max, the
// bit-fill that spreads a window's max and dz over the window, and the
// selection kron that drops the non-base pixels. On NHWC tensors the pool
// is a max over the k x k window read while the A tile is staged.
//
// Roundings, as poolconv.py:127-193: the pool in f32 (exact), the pooled
// values and W in the compute type, f32 sums and bias, one cast; dz in f32,
// dx = mask * dz / count cast once; dW f32, dbias the f32 sum of g.
//
// What bounds it: the PSP levels pool C = 32 at 256^2 into cout = 8, a few
// flops a byte of x: bytes. The forward reads x once and writes y once.
// The backward is three launches: dgrad (dz on the tensor cores, then each
// window's max, tie count and dx, reading the window twice from L1/L2),
// wgrad (the pooled values re-gathered against g, with the bias row, as
// per-chunk partials) and a fixed-order reduction.

#include "gemm1x1.cuh"

using namespace gemm1x1;

namespace {

template <typename T, int BN>
__global__ void __launch_bounds__(THREADS)
poolconv_fwd_kernel(Parts parts, const typename Cfg<T>::S* __restrict__ w,
                    const float* __restrict__ bias, T* __restrict__ y, int N, int H, int W,
                    int cout) {
  fwd_body<T, BN>(parts, w, bias, y, N, H, W, cout);
}

template <typename T, int BN>
__global__ void __launch_bounds__(THREADS)
poolconv_wgrad_kernel(Parts parts, const T* __restrict__ g, float* __restrict__ part_out, int N,
                      int H, int W, int cout, int krows) {
  wgrad_body<T, BN>(parts, g, part_out, N, H, W, cout, krows);
}

__global__ void __launch_bounds__(1024)
poolconv_reduce_kernel(const float* __restrict__ part, long long rows, long long cols,
                       float* __restrict__ out) {
  reduce_rows_body(part, rows, cols, out);
}

// Block: BM pooled pixels x BN input channels. dz = g @ W^T for the tile
// (K = cout in BK steps), then per (pooled pixel, 8 channels) the window's
// max and tie count and dx over the k x k window.
template <typename T, int BN>
__global__ void __launch_bounds__(THREADS)
poolconv_dgrad_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      const typename Cfg<T>::S* __restrict__ wT, T* __restrict__ dx, int N, int H,
                      int W, int C, int cout, int k) {
  using S = typename Cfg<T>::S;
  using L = Layout<S, BN>;
  __shared__ __align__(128) unsigned char smem[L::SMEM];
  S* As = reinterpret_cast<S*>(smem);
  S* Bs = reinterpret_cast<S*>(smem + L::A_BYTES);
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const long long M = (long long)N * H * W;  // pooled pixels
  const long long m0 = (long long)blockIdx.x * BM;
  const int c0 = blockIdx.y * BN;
  const int ar = tid >> 1, ao = (tid & 1) * 8;
  const long long m = m0 + ar;
  const int br = tid / (BN / 8), bc = (tid % (BN / 8)) * 8;
  const bool bthread = tid < BK * BN / 8;

  Mma<Cfg<T>::TC, BN> mma;
  mma.init(tid);
  for (int o0 = 0; o0 < cout; o0 += BK) {
    float v[8];
    if (m < M && o0 + ao < cout) Io<T>::load8(g + m * cout + o0 + ao, v);
    else zero8(v);
    Io<S>::store8(As + ar * L::A_LD + ao, v);
    if (bthread) {
      float u[8];
      const int o = o0 + br, c = c0 + bc;
      if (o < cout && c < C) Io<S>::load8(wT + (long long)o * C + c, u);
      else zero8(u);
      Io<S>::store8(Bs + br * L::B_LD + bc, u);
    }
    __syncthreads();
    mma.step(As, Bs);
    __syncthreads();
  }
  mma.store(Cs);
  __syncthreads();

  const int Hi = H * k, Wi = W * k;
  for (int e8 = tid; e8 < BM * BN / 8; e8 += THREADS) {
    const int r = e8 / (BN / 8), c = (e8 % (BN / 8)) * 8;
    const long long q = m0 + r;
    const int cc = c0 + c;
    if (q >= M || cc >= C) continue;
    const int wo = (int)(q % W);
    const long long t = q / W;
    const int ho = (int)(t % H);
    const int n = (int)(t / H);
    const T* xw = x + (((long long)n * Hi + ho * k) * Wi + wo * k) * C + cc;
    T* dxw = dx + (((long long)n * Hi + ho * k) * Wi + wo * k) * C + cc;
    float mx[8], cnt[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      mx[e] = -INFINITY;
      cnt[e] = 0.0f;
    }
    for (int a = 0; a < k; ++a) {
      for (int b = 0; b < k; ++b) {
        float u[8];
        Io<T>::load8(xw + ((long long)a * Wi + b) * C, u);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (u[e] > mx[e]) {
            mx[e] = u[e];
            cnt[e] = 1.0f;
          } else if (u[e] == mx[e]) {
            cnt[e] += 1.0f;
          }
        }
      }
    }
    float dpix[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) dpix[e] = Cs[r * L::C_LD + c + e] / cnt[e];
    for (int a = 0; a < k; ++a) {
      for (int b = 0; b < k; ++b) {
        float u[8], out[8];
        Io<T>::load8(xw + ((long long)a * Wi + b) * C, u);
#pragma unroll
        for (int e = 0; e < 8; ++e) out[e] = u[e] == mx[e] ? dpix[e] : 0.0f;
        Io<T>::store8(dxw + ((long long)a * Wi + b) * C, out);
      }
    }
  }
}

Parts make_parts(const void* x, int C, int k, int H, int W) {
  Parts parts{};
  parts.P = 1;
  Part& pt = parts.p[0];
  pt.x = x;
  pt.cin = C;
  pt.ups = 1;
  pt.stride = 1;
  pt.pool = k;
  pt.act = 0;
  pt.koff = 0;
  pt.Hi = H * k;
  pt.Wi = W * k;
  return parts;
}

bool valid(int N, int Hin, int Win, int C, int cout, int k) {
  return N > 0 && Hin > 0 && Win > 0 && C > 0 && C % 8 == 0 && cout > 0 && cout % 8 == 0 &&
         k >= 2 && Hin % k == 0 && Win % k == 0;
}

template <typename T>
cudaError_t forward(const void* x, const void* w, const float* bias, void* y, int N, int Hin,
                    int Win, int C, int cout, int k, int* launched, cudaStream_t stream) {
  using S = typename Cfg<T>::S;
  const int H = Hin / k, W = Win / k;
  const Parts parts = make_parts(x, C, k, H, W);
  const int bn = bn_for(cout);
  const dim3 grid((unsigned)ceil_div((long long)N * H * W, BM), (unsigned)ceil_div(cout, bn));
  const S* ws = static_cast<const S*>(w);
  T* yt = static_cast<T*>(y);
  if (bn == 16) poolconv_fwd_kernel<T, 16><<<grid, THREADS, 0, stream>>>(parts, ws, bias, yt, N, H, W, cout);
  else if (bn == 32) poolconv_fwd_kernel<T, 32><<<grid, THREADS, 0, stream>>>(parts, ws, bias, yt, N, H, W, cout);
  else poolconv_fwd_kernel<T, 64><<<grid, THREADS, 0, stream>>>(parts, ws, bias, yt, N, H, W, cout);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return err;
}

template <typename T>
cudaError_t backward(const void* x, const void* g, const void* wT, void* dx, float* dwb,
                     float* work, int nchunks, int N, int Hin, int Win, int C, int cout, int k,
                     int* launched, cudaStream_t stream) {
  using S = typename Cfg<T>::S;
  const int H = Hin / k, W = Win / k;
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  const S* wTs = static_cast<const S*>(wT);
  {
    const int bn = bn_for(C);
    const dim3 grid((unsigned)ceil_div((long long)N * H * W, BM), (unsigned)ceil_div(C, bn));
    T* dxt = static_cast<T*>(dx);
    if (bn == 16) poolconv_dgrad_kernel<T, 16><<<grid, THREADS, 0, stream>>>(xt, gt, wTs, dxt, N, H, W, C, cout, k);
    else if (bn == 32) poolconv_dgrad_kernel<T, 32><<<grid, THREADS, 0, stream>>>(xt, gt, wTs, dxt, N, H, W, C, cout, k);
    else poolconv_dgrad_kernel<T, 64><<<grid, THREADS, 0, stream>>>(xt, gt, wTs, dxt, N, H, W, C, cout, k);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
  }
  Parts wp = make_parts(x, C, k, H, W);
  Part& bias_row = wp.p[1];
  bias_row.x = nullptr;
  bias_row.cin = 1;
  bias_row.ups = 1;
  bias_row.stride = 1;
  bias_row.pool = 1;
  bias_row.koff = C;
  bias_row.Hi = H;
  bias_row.Wi = W;
  wp.P = 2;
  const long long tiles = wgrad_plan(wp, N, H, W, nchunks);
  const int krows = C + 1;
  {
    const int bn = bn_for(cout);
    const dim3 grid((unsigned)nchunks, (unsigned)tiles, (unsigned)ceil_div(cout, bn));
    if (bn == 16) poolconv_wgrad_kernel<T, 16><<<grid, THREADS, 0, stream>>>(wp, gt, work, N, H, W, cout, krows);
    else if (bn == 32) poolconv_wgrad_kernel<T, 32><<<grid, THREADS, 0, stream>>>(wp, gt, work, N, H, W, cout, krows);
    else poolconv_wgrad_kernel<T, 64><<<grid, THREADS, 0, stream>>>(wp, gt, work, N, H, W, cout, krows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
  }
  const long long cols = (long long)krows * cout;
  poolconv_reduce_kernel<<<(unsigned)ceil_div(cols, 32), dim3(32, 32), 0, stream>>>(work, nchunks, cols, dwb);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return err;
}

}  // namespace

// x: (N, Hin, Win, C) NHWC, contiguous, bf16 (is_bf16 = 1) or f32, 16-byte
// aligned; w: (C, cout) in the compute type (bf16 for bf16 x, else f32);
// bias: (cout,) f32; y: (N, Hin/k, Win/k, cout) in x's type. C and cout
// multiples of 8, k >= 2 dividing Hin and Win. Adds the kernels it launched
// to *launched (one) and returns the cudaError_t of the launch.
extern "C" int poolconv_forward(const void* x, const void* w, const void* bias, void* y, int N,
                                int Hin, int Win, int C, int cout, int k, int is_bf16,
                                int* launched, void* stream) {
  if (!valid(N, Hin, Win, C, cout, k)) return (int)cudaErrorInvalidValue;
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? forward<__nv_bfloat16>(x, w, b, y, N, Hin, Win, C, cout, k, launched, s)
                       : forward<float>(x, w, b, y, N, Hin, Win, C, cout, k, launched, s));
}

// As poolconv_forward for x, with wT: (cout, C) in the compute type and g:
// (N, Hin/k, Win/k, cout) in x's type. Writes dx (x's shape and type), dwb:
// (C + 1, cout) f32, the weight gradient with the bias gradient as its last
// row; work: nchunks * (C + 1) * cout floats, the per-chunk partials of
// dwb. Adds the kernels it
// launched to *launched (three when all go) and returns the first
// cudaError_t.
extern "C" int poolconv_backward(const void* x, const void* g, const void* wT, void* dx, void* dwb,
                                 void* work, int nchunks, int N, int Hin, int Win, int C, int cout,
                                 int k, int is_bf16, int* launched, void* stream) {
  if (!valid(N, Hin, Win, C, cout, k) || nchunks < 1) return (int)cudaErrorInvalidValue;
  float* d = static_cast<float*>(dwb);
  float* wk = static_cast<float*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? backward<__nv_bfloat16>(x, g, wT, dx, d, wk, nchunks, N, Hin, Win, C, cout, k,
                                                  launched, s)
                       : backward<float>(x, g, wT, dx, d, wk, nchunks, N, Hin, Win, C, cout, k,
                                         launched, s));
}
