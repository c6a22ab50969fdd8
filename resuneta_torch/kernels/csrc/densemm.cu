// K3: the 1x1 convolution over concat parts, NHWC, for sm_90a,
//
//   y = sum_p up_{k_p}(act_p?(x_p)) @ W_p + bias      (P <= 5 parts)
//
// with no concat and no upsampled tensor in device memory, and its
// backward, every dx_p, every dW_p and dbias from one pass over (x, g).
// A part may also read every s-th row and column (stride s, the encoder's
// stride-2 1x1 convolutions): its dx is then full-resolution and zero at
// the pixels the convolution does not read.
//
// Replaces resuneta_tpu/ops/pallas/densemm.py: dense_mm -> _fwd_kernel (the
// pallas_call at :321) and _dense_mm_bwd -> _bwd_kernel (:355). What it
// leaves behind is the TPU's: the kron / block-diagonal weights, the
// super-row lane slices and the VMEM planner. On NHWC tensors a 1x1
// convolution is a plain GEMM over pixels, and the gathers (upsample,
// stride, ReLU) happen while the A tile is staged (gemm1x1.cuh).
//
// Roundings, as densemm.py:190-262: x and W in the compute type, f32 sums
// and bias, one cast; in the backward the ROW replicas of g of an
// upsampled part are summed in f32 and rounded to bf16 before the product
// (:236-244), the COLUMN replicas sum inside the f32 accumulation; dW is
// f32 and dbias the f32 sum of g.
//
// What bounds it: widths 8 to 256 give 8 to 85 flops a byte, far below
// the H100's ~295 bf16 flops a byte: bytes. The design reads each part
// once a (pixel tile, 64 output channels) block and writes y once; the
// backward is three launches: dgrad (all parts' dx), wgrad (all dW tiles
// and the bias row as per-chunk partials) and a fixed-order reduction.
// No TMA, wgmma or pipelining yet: the simple kernel that is right first.

#include "gemm1x1.cuh"

using namespace gemm1x1;

namespace {

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
    pt.pool = 1;
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
cudaError_t forward(const Parts& parts, const void* w, const float* bias, void* y, int N, int H,
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
cudaError_t backward(Parts parts, const void* g, const void* wT, float* dwb, float* work,
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
  bias_row.pool = 1;
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

// xs[p]: (N, H/ups_p, W/ups_p, cins[p]) or, for a strided part,
// (N, H*s, W*s, cins[p]) NHWC, contiguous, bf16 (is_bf16 = 1) or f32,
// 16-byte aligned; w: (sum cins, cout) in the compute type (bf16 for bf16
// x, else f32); bias: (cout,) f32; y: (N, H, W, cout) in x's type. cins and
// cout multiples of 8, P <= 5. Adds the kernels it launched to *launched
// (one) and returns the cudaError_t of the launch.
extern "C" int densemm_forward(const void* const* xs, const int* cins, const int* ups,
                               const int* strides, const int* acts, int P, const void* w,
                               const void* bias, void* y, int N, int H, int W, int cout,
                               int is_bf16, int* launched, void* stream) {
  if (!valid(cins, ups, strides, P, N, H, W, cout)) return (int)cudaErrorInvalidValue;
  const Parts parts = make_parts(xs, nullptr, cins, ups, strides, acts, P, H, W);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? forward<__nv_bfloat16>(parts, w, b, y, N, H, W, cout, launched, s)
                       : forward<float>(parts, w, b, y, N, H, W, cout, launched, s));
}

// As densemm_forward for xs, w's transpose wT: (cout, sum cins) in the
// compute type, and g: (N, H, W, cout) in x's type. Writes dxs[p] (x_p's
// shape and type), dwb: (sum cins + 1, cout) f32, the weight gradient with
// the bias gradient as its last row; work: nchunks * (sum cins + 1) *
// cout floats, the per-chunk partials of dwb. Adds the kernels it launched to *launched (three when all go:
// dgrad, wgrad, reduction) and returns the first cudaError_t.
extern "C" int densemm_backward(const void* const* xs, const int* cins, const int* ups,
                                const int* strides, const int* acts, int P, const void* g,
                                const void* wT, void* const* dxs, void* dwb, void* work,
                                int nchunks, int N, int H, int W, int cout, int is_bf16,
                                int* launched, void* stream) {
  if (!valid(cins, ups, strides, P, N, H, W, cout) || nchunks < 1) return (int)cudaErrorInvalidValue;
  const Parts parts = make_parts(xs, dxs, cins, ups, strides, acts, P, H, W);
  float* d = static_cast<float*>(dwb);
  float* wk = static_cast<float*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? backward<__nv_bfloat16>(parts, g, wT, d, wk, nchunks, N, H, W, cout, launched, s)
                       : backward<float>(parts, g, wT, d, wk, nchunks, N, H, W, cout, launched, s));
}
