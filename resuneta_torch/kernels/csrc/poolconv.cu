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
// selection kron that drops the non-base pixels. On NHWC tensors a
// window's row is k pixels x C channels, contiguous.
//
// Roundings, as poolconv.py:127-193: the pool in f32 (exact), the pooled
// values and W in the compute type, f32 sums and bias, one cast; dz in f32,
// dx = mask * dz / count cast once; dW f32, dbias the f32 sum of g.
//
// What bounds it: bytes. The PSP levels pool C = 32 at 256^2 into cout =
// 8: a pooled pixel reads k^2 x 64 bytes of bf16 x for 256 multiply-adds
// (2 a byte at k = 2, fewer at k = 4, 8), far under the card's ~10 f32
// multiply-adds a byte of HBM, so the products run on the CUDA cores in
// f32: the operands are bf16 values (the pooled values are x's own, W and
// g are rounded to the compute type), so each product is exact and only
// the order of the f32 sums differs from the plain version. Tensor cores
// would buy nothing, and cout = 8 would leave half of a 16-wide tile empty
// (the first design, on gemm1x1.cuh).
//
// The design: G * k threads a pooled pixel (G = C / 8 channel groups of 16
// bytes, k window columns), inside one warp, so that a warp's load of a
// window row is one contiguous run of 32 x 16 bytes. A thread reads its
// window column's k pixels x 8 channels with 16-byte loads once, into
// registers (two pixels a thread at k = 2); the window's max,
// and in the backward its tie count, are combined across the k column
// threads by shuffles. Thread (group, column b) takes the outputs o = b
// (mod k), so the k column threads share the products instead of
// repeating them, and the group sums follow by shuffles in a fixed order.
// - Forward: one launch, one pass over x; a pooled pixel's cout outputs are
//   gathered to one thread and stored as one vector.
// - Backward: one pass over (x, g): dz for the thread's 8 channels (its
//   share of the outputs, summed across the column threads), dx written
//   from the registers that hold the window, and dW / dbias accumulated per
//   thread over a grid-stride loop of pooled pixels; each block sums its
//   threads' accumulators in a fixed order (shuffles across the warp's
//   pixels, then the warps in order) into its row of partials, and a second
//   launch sums the rows in a fixed order. Two launches a call, x read once
//   and dx written once; a repeated call is bit-identical. W arrives in f32
//   and is rounded to the compute type as it is staged, so no cast runs
//   beside the kernels.
// The kernels take k in {2, 4, 8}, C in {8, 16, 32} (so a pixel's C / 8 *
// k threads lie in one warp and the block's partials fit static shared
// memory), cout in {8, 16}: the main path's C = 32, cout = 8. f32 x takes
// the same kernels with f32 operands.
//
// Tried and taken out: the first design's three-launch backward (dgrad on
// the tensor cores, reading each window twice; wgrad re-gathering the
// pooled values from x; the reduce) and its forward on gemm1x1.cuh's
// 16-wide tiles. gemm1x1.cuh stays for K3's f32 path.

#include <algorithm>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// the backward's blocks at most (four an SM of the H100's 132), each one
// row of dW / dbias partials; a function of the shapes alone, so a
// repeated call is bit-identical
constexpr int BWD_BLOCKS = 4 * 132;
constexpr int MAX_C = 32;
constexpr int MAX_COUT = 16;
constexpr int MAX_CW = MAX_C * MAX_COUT;
constexpr unsigned FULL = 0xffffffffu;

// 8 channels of x: loaded raw (16 bytes of bf16, 32 of f32) so that many
// are in flight before any is used, unpacked to f32 where they are.
template <typename T>
struct Io;

template <>
struct Io<__nv_bfloat16> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load_raw(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ void unpack(const Raw& u, float* v) {
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
  static __device__ __forceinline__ float load1(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

template <>
struct Io<float> {
  struct Raw {
    float4 lo, hi;
  };
  static __device__ __forceinline__ Raw load_raw(const float* p) {
    return {*reinterpret_cast<const float4*>(p), *reinterpret_cast<const float4*>(p + 4)};
  }
  static __device__ __forceinline__ void unpack(const Raw& u, float* v) {
    v[0] = u.lo.x; v[1] = u.lo.y; v[2] = u.lo.z; v[3] = u.lo.w;
    v[4] = u.hi.x; v[5] = u.hi.y; v[6] = u.hi.z; v[7] = u.hi.w;
  }
  static __device__ __forceinline__ void store8(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
  static __device__ __forceinline__ float load1(const float* p) { return *p; }
};

template <typename T>
struct Rnd;
template <>
struct Rnd<__nv_bfloat16> {
  static __device__ __forceinline__ float to(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};
template <>
struct Rnd<float> {
  static __device__ __forceinline__ float to(float v) { return v; }
};

// The threads of a pooled pixel: tpp = G * K lanes, group cg = lane % G
// fastest, then window column b; a block holds THREADS / tpp pixels. A
// warp's load of window row a is one contiguous run of 32 x 16 bytes.
struct Lanes {
  int G, tpp, cg, b, slot;
  __device__ Lanes(int C, int K) {
    G = C / 8;
    tpp = G * K;
    const int l = threadIdx.x % tpp;
    cg = l % G;
    b = l / G;
    slot = threadIdx.x / tpp;
  }
};

// W (C x cout, f32) into shared memory, rounded to the compute type T
template <typename T>
__device__ __forceinline__ void stage_w(const float* __restrict__ w, float* ws, int n) {
  for (int e = threadIdx.x; e < n; e += THREADS) ws[e] = Rnd<T>::to(w[e]);
}

// x at (pooled pixel q, window row 0, window column b, group cg): pooled
// row r = q / Wo (over all images) starts at input row r * K, so one
// 32-bit division a pixel; window row a is a * Wo * K * C further.
__device__ __forceinline__ long long x_off(int q, int Wo, int C, int K, int b, int cg) {
  const int r = q / Wo, wo = q - r * Wo;
  return ((long long)r * K * Wo * K + (long long)wo * K + b) * C + cg * 8;
}

// A thread's pooled pixels a trip: NP of them, THREADS / tpp apart, so
// that its loads are in flight together: 2 at k = 2 (4 loads of 16 bytes),
// 1 above (4 and 8 loads). More at k = 2 and 4 measured slower on an H100
// (more registers, fewer blocks an SM).
template <int K>
struct Np {
  static constexpr int value = K == 2 ? 2 : 1;
};

template <typename T, int K, int COUT>
__global__ void __launch_bounds__(THREADS)
poolconv_fwd(const T* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
             T* __restrict__ y, long long M, int Wo, int C) {
  constexpr int cout = COUT;
  constexpr int NP = Np<K>::value;
  constexpr int NO = (COUT + K - 1) / K;
  __shared__ float ws[MAX_CW];
  stage_w<T>(w, ws, C * cout);
  __syncthreads();
  const Lanes ln(C, K);
  const int ppb = THREADS / ln.tpp;

  const long long rstride = (long long)Wo * K * C;   // a window row further
  typename Io<T>::Raw raw[NP][K];
  long long q[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    q[p] = ((long long)blockIdx.x * NP + p) * ppb + ln.slot;
    if (q[p] < M) {
      const T* xr = x + x_off((int)q[p], Wo, C, K, ln.b, ln.cg);
#pragma unroll
      for (int a = 0; a < K; ++a) raw[p][a] = Io<T>::load_raw(xr + a * rstride);
    }
  }
  const int lane0 = (threadIdx.x & 31) - (threadIdx.x % ln.tpp);
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const bool live = q[p] < M;   // whole pixels: a pixel's lanes agree
    float m[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) m[e] = -INFINITY;
    if (live) {
#pragma unroll
      for (int a = 0; a < K; ++a) {
        float u[8];
        Io<T>::unpack(raw[p][a], u);
#pragma unroll
        for (int e = 0; e < 8; ++e) m[e] = u[e] > m[e] ? u[e] : m[e];
      }
    }
    // the window's max across its K column threads
    for (int off = ln.G; off < ln.tpp; off <<= 1) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float v = __shfl_xor_sync(FULL, m[e], off);
        m[e] = v > m[e] ? v : m[e];
      }
    }
    // this thread's outputs o = a + K * i: its 8 channels' share
    float acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      acc[i] = 0.0f;
      const int o = ln.b + K * i;
      if (o < cout) {
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i] = fmaf(m[e], ws[(ln.cg * 8 + e) * cout + o], acc[i]);
      }
    }
    for (int off = 1; off < ln.G; off <<= 1) {
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[i] += __shfl_xor_sync(FULL, acc[i], off);
    }
    // gather the pixel's outputs to its first lane, one vector store
    float out[COUT];
#pragma unroll
    for (int o = 0; o < COUT; ++o)
      out[o] = __shfl_sync(FULL, acc[o / K], lane0 + (o % K) * ln.G) + bias[o];
    if (live && ln.cg == 0 && ln.b == 0) {
      T* yp = y + q[p] * cout;
#pragma unroll
      for (int o = 0; o < COUT; o += 8) Io<T>::store8(yp + o, out + o);
    }
  }
}

// One pass over (x, g): dx, and this block's row of dW / dbias partials
// (part: gridDim.x rows of (C + 1) x cout, the bias row last).
template <typename T, int K, int COUT>
__global__ void __launch_bounds__(THREADS)
poolconv_bwd(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ w,
             T* __restrict__ dx, float* __restrict__ part, long long M, int Wo,
             int C) {
  constexpr int cout = COUT;
  constexpr int NO = (COUT + K - 1) / K;
  constexpr int NA = 9 * NO;          // per thread: dW[8][NO], then dbias[NO]
  __shared__ float ws[MAX_CW];
  __shared__ float red[WARPS * 9 * MAX_CW / 8];
  stage_w<T>(w, ws, C * cout);
  __syncthreads();
  const Lanes ln(C, K);
  const int ppb = THREADS / ln.tpp;

  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.0f;

  // every lane of a warp runs the same trip count (the shuffles need them
  // all): pixels past M take no part. A trip takes NP pixels a thread,
  // their window rows loaded first.
  constexpr int NP = Np<K>::value;
  const long long rstride = (long long)Wo * K * C;   // a window row further
  const long long stride = (long long)gridDim.x * ppb * NP;
  for (long long base = (long long)blockIdx.x * ppb * NP; base < M; base += stride) {
    typename Io<T>::Raw raw[NP][K];
    long long xo[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const long long q = base + p * ppb + ln.slot;
      xo[p] = q < M ? x_off((int)q, Wo, C, K, ln.b, ln.cg) : -1;
      if (xo[p] >= 0) {
#pragma unroll
        for (int a = 0; a < K; ++a) raw[p][a] = Io<T>::load_raw(x + xo[p] + a * rstride);
      }
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const long long q = base + p * ppb + ln.slot;
      const bool live = xo[p] >= 0;
      float m[8], c[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        m[e] = -INFINITY;
        c[e] = 0.0f;
      }
      if (live) {
#pragma unroll
        for (int a = 0; a < K; ++a) {
          float u[8];
          Io<T>::unpack(raw[p][a], u);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (u[e] > m[e]) {
              m[e] = u[e];
              c[e] = 1.0f;
            } else if (u[e] == m[e]) {
              c[e] += 1.0f;
            }
          }
        }
      }
      // the window's max and tie count across its K column threads
      for (int off = ln.G; off < ln.tpp; off <<= 1) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float vm = __shfl_xor_sync(FULL, m[e], off);
          const float vc = __shfl_xor_sync(FULL, c[e], off);
          if (vm > m[e]) {
            m[e] = vm;
            c[e] = vc;
          } else if (vm == m[e]) {
            c[e] += vc;
          }
        }
      }
      // g at this thread's outputs o = a + K * i (a pixel's lanes read one
      // 16-byte line of g)
      float gs[NO];
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        const int o = ln.b + K * i;
        gs[i] = live && o < cout ? Io<T>::load1(g + q * cout + o) : 0.0f;
      }
      // dz for the 8 channels: this thread's outputs, summed across the
      // column threads
      float dz[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        dz[e] = 0.0f;
#pragma unroll
        for (int i = 0; i < NO; ++i) {
          const int o = ln.b + K * i;
          if (o < cout) dz[e] = fmaf(gs[i], ws[(ln.cg * 8 + e) * cout + o], dz[e]);
        }
      }
      for (int off = ln.G; off < ln.tpp; off <<= 1) {
#pragma unroll
        for (int e = 0; e < 8; ++e) dz[e] += __shfl_xor_sync(FULL, dz[e], off);
      }
      if (live) {
        float share[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) share[e] = dz[e] / c[e];
#pragma unroll
        for (int a = 0; a < K; ++a) {
          float u[8], d[8];
          Io<T>::unpack(raw[p][a], u);
#pragma unroll
          for (int e = 0; e < 8; ++e) d[e] = u[e] == m[e] ? share[e] : 0.0f;
          Io<T>::store8(dx + xo[p] + a * rstride, d);
        }
        // dW[c][o] += pooled[c] * g[o], dbias[o] += g[o], o = b (mod K)
#pragma unroll
        for (int i = 0; i < NO; ++i) {
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e * NO + i] = fmaf(m[e], gs[i], acc[e * NO + i]);
          if (ln.cg == 0) acc[8 * NO + i] += gs[i];
        }
      }
    }
  }

  // the block's sum in a fixed order: the warp's pixels by shuffles, then
  // the warps in order
  for (int off = ln.tpp; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] += __shfl_xor_sync(FULL, acc[i], off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int per_warp = ln.tpp * NA;
  if (lane < ln.tpp) {
#pragma unroll
    for (int i = 0; i < NA; ++i) red[warp * per_warp + lane * NA + i] = acc[i];
  }
  __syncthreads();
  const int cols = (C + 1) * cout;
  float* row = part + (long long)blockIdx.x * cols;
  for (int t = threadIdx.x; t < cols; t += THREADS) {
    const int c = t / cout, o = t - c * cout;
    const int b = o % K, i = o / K;
    const int l = b * ln.G + (c < C ? c / 8 : 0);
    const int idx = c < C ? (c % 8) * NO + i : 8 * NO + i;
    float s = 0.0f;
    for (int wp = 0; wp < WARPS; ++wp) s += red[wp * per_warp + l * NA + idx];
    row[t] = s;
  }
}

// out[col] = sum over rows of part[row, col], in a fixed order.
__global__ void __launch_bounds__(1024)
poolconv_reduce(const float* __restrict__ part, int rows, int cols, float* __restrict__ out) {
  __shared__ float sm[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * 32 + tx;
  float s = 0.0f;
  if (col < cols)
    for (int r = ty; r < rows; r += 32) s += part[(long long)r * cols + col];
  sm[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && col < cols) {
    float t = 0.0f;
    for (int k = 0; k < 32; ++k) t += sm[k][tx];
    out[col] = t;
  }
}

bool valid(int N, int Hin, int Win, int C, int cout, int k) {
  const int G = C / 8;
  return N > 0 && Hin > 0 && Win > 0 && (k == 2 || k == 4 || k == 8) && Hin % k == 0 &&
         Win % k == 0 && (C == 8 || C == 16 || C == 32) && (cout == 8 || cout == 16) &&
         (long long)N * Hin * Win < (1LL << 31);
}

// Blocks of pooled pixels for M of them: a block takes THREADS / (C / 8 *
// K) pixel slots of Np<K> pixels each a trip.
template <int K>
long long blocks_for(long long M, int C) {
  const long long per_block = (long long)THREADS / (C / 8 * K) * Np<K>::value;
  return (M + per_block - 1) / per_block;
}

template <typename T, int K, int COUT>
cudaError_t forward_k(const void* x, const void* w, const float* bias, void* y, int N, int Hin,
                      int Win, int C, cudaStream_t st) {
  const int Ho = Hin / K, Wo = Win / K;   // pooled
  const long long M = (long long)N * Ho * Wo;
  poolconv_fwd<T, K, COUT><<<(unsigned)blocks_for<K>(M, C), THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), bias, static_cast<T*>(y), M, Wo, C);
  return cudaGetLastError();
}

template <typename T, int K, int COUT>
cudaError_t backward_k(const void* x, const void* g, const void* w, void* dx, float* dwb,
                       float* part, int N, int Hin, int Win, int C, int* launched,
                       cudaStream_t st) {
  const int Ho = Hin / K, Wo = Win / K;   // pooled
  const long long M = (long long)N * Ho * Wo;
  const int nblocks = (int)std::min<long long>(BWD_BLOCKS, blocks_for<K>(M, C));
  poolconv_bwd<T, K, COUT><<<nblocks, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const float*>(w),
      static_cast<T*>(dx), part, M, Wo, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launched;
  const int cols = (C + 1) * COUT;
  poolconv_reduce<<<(cols + 31) / 32, dim3(32, 32), 0, st>>>(part, nblocks, cols, dwb);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return err;
}

template <typename T, int K>
cudaError_t forward(const void* x, const void* w, const float* bias, void* y, int N, int Hin,
                    int Win, int C, int cout, cudaStream_t st) {
  return cout == 8 ? forward_k<T, K, 8>(x, w, bias, y, N, Hin, Win, C, st)
                   : forward_k<T, K, 16>(x, w, bias, y, N, Hin, Win, C, st);
}

template <typename T, int K>
cudaError_t backward(const void* x, const void* g, const void* w, void* dx, float* dwb,
                     float* part, int N, int Hin, int Win, int C, int cout, int* launched,
                     cudaStream_t st) {
  return cout == 8
             ? backward_k<T, K, 8>(x, g, w, dx, dwb, part, N, Hin, Win, C, launched, st)
             : backward_k<T, K, 16>(x, g, w, dx, dwb, part, N, Hin, Win, C, launched, st);
}

template <typename T>
cudaError_t forward_t(const void* x, const void* w, const float* bias, void* y, int N, int Hin,
                      int Win, int C, int cout, int k, cudaStream_t st) {
  if (k == 2) return forward<T, 2>(x, w, bias, y, N, Hin, Win, C, cout, st);
  if (k == 4) return forward<T, 4>(x, w, bias, y, N, Hin, Win, C, cout, st);
  return forward<T, 8>(x, w, bias, y, N, Hin, Win, C, cout, st);
}

template <typename T>
cudaError_t backward_t(const void* x, const void* g, const void* w, void* dx, float* dwb,
                       float* part, int N, int Hin, int Win, int C, int cout, int k,
                       int* launched, cudaStream_t st) {
  if (k == 2)
    return backward<T, 2>(x, g, w, dx, dwb, part, N, Hin, Win, C, cout, launched, st);
  if (k == 4)
    return backward<T, 4>(x, g, w, dx, dwb, part, N, Hin, Win, C, cout, launched, st);
  return backward<T, 8>(x, g, w, dx, dwb, part, N, Hin, Win, C, cout, launched, st);
}

}  // namespace

// x: (N, Hin, Win, C) NHWC, contiguous, bf16 (is_bf16 = 1) or f32, 16-byte
// aligned; w: (C, cout) f32, rounded to the compute type (bf16 for bf16
// x, else f32) as it is staged; bias: (cout,) f32; y: (N, Hin/k, Win/k, cout) in x's type. k in {2, 4,
// 8} dividing Hin and Win; C in {8, 16, 32}, cout in {8, 16}. Adds the kernels it
// launched to *launched (one) and returns the cudaError_t of the launch.
extern "C" int poolconv_forward(const void* x, const void* w, const void* bias, void* y, int N,
                                int Hin, int Win, int C, int cout, int k, int is_bf16,
                                int* launched, void* stream) {
  if (!valid(N, Hin, Win, C, cout, k)) return (int)cudaErrorInvalidValue;
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? forward_t<__nv_bfloat16>(x, w, b, y, N, Hin, Win, C, cout, k, s)
              : forward_t<float>(x, w, b, y, N, Hin, Win, C, cout, k, s);
  if (err == cudaSuccess) ++*launched;
  return (int)err;
}

// As poolconv_forward for x and w, with g: (N, Hin/k, Win/k, cout) in x's
// type. Writes dx (x's shape and type), dwb: (C + 1, cout) f32, the weight
// gradient with the bias gradient as its last row; part:
// poolconv_partial_rows() * (C + 1) * cout floats, the blocks' partials of
// dwb (the kernel chooses its blocks from the shapes, at most that many).
// Adds the kernels it launched to *launched (two when both go) and returns
// the first cudaError_t.
extern "C" int poolconv_backward(const void* x, const void* g, const void* w, void* dx, void* dwb,
                                 void* part, int N, int Hin, int Win, int C, int cout, int k,
                                 int is_bf16, int* launched, void* stream) {
  if (!valid(N, Hin, Win, C, cout, k)) return (int)cudaErrorInvalidValue;
  float* d = static_cast<float*>(dwb);
  float* p = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? backward_t<__nv_bfloat16>(x, g, w, dx, d, p, N, Hin, Win, C, cout, k,
                                                   launched, s)
                       : backward_t<float>(x, g, w, dx, d, p, N, Hin, Win, C, cout, k, launched,
                                           s));
}

// The rows of partials poolconv_backward may write.
extern "C" int poolconv_partial_rows() { return BWD_BLOCKS; }
