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
// 288 at C = 64 (at the ridge: bytes bound by a hair) and 576 at C = 128
// (tensor-core bound).
//
// Two designs, chosen in convseg_forward by the channels alone:
//
// * C == Cout in {32, 64, 128} (every segment of the default model) and
//   256 (the opt-in wide tier's RB(256)): tma_fwd_kernel, TMA-fed,
//   mbarrier-pipelined wgmma. An implicit GEMM with M = a tile of 128
//   output pixels (a rectangle of one image, 1 x 128 at W >= 128, 2 x 64
//   at W = 64: sm90::Geo), N = Cout (at C = 256 one half of it a block,
//   the other half on another), K = 9 taps x C, two consumer warpgroups of 64 pixels and one producer warp whose
//   one thread keeps TMA loads in flight through a ring of stages. A K
//   step is one stencil row ky and CB channels: the producer loads the
//   raw x box of that row, BH rows x (BW + 2d) columns from (h0 + (ky-1)d,
//   w0 - d), unswizzled and in x's type. w (HWIO w[ky, kx] is C x Cout
//   with Cout contiguous: B is MN-major as it lies) stays in shared memory
//   for the block's life at C <= 64 (18 or 72 KB, loaded once), and comes
//   with each stage, the step's three taps, at C >= 128 (288 KB in all at
//   C = 128).
//   The consumers form z from the box once, in shared memory (__fmaf_rn;
//   the ReLU and the one bf16 rounding in one cvt.rn.relu.bf16x2; a mask
//   on the box's image coordinates, since TMA's zero fill gives x = 0, not
//   z = 0), write it in the swizzled K-major layout wgmma reads, fence the
//   generic proxy against the async one, meet at a barrier, and the three
//   taps read it at row offsets kx*d. So x is read from device memory
//   about once and from L2 3 (BW + 2d) / BW times, z is formed 3 (BW +
//   2d) / BW times per element instead of 9, and never reaches device
//   memory; the next step's z is formed while this step's wgmma runs
//   (three z buffers, one barrier a step). Where BW + 2d > 256 (TMA's box
//   limit), a warpgroup's 64 pixels span image rows (W <= 32) or the halo
//   plan does not fit shared memory, a K step is one tap and its box is
//   the tile itself (HALO = 0). Blocks are persistent (one wave); the
//   epilogue adds the bias in f32 and writes y straight from the
//   accumulators (4- or 8-byte stores, no barrier), masking the pixels a
//   ragged tile overhangs.
//   At C = 32 and 64 the bound is bytes (x once in, y once out), at C =
//   128 the tensor cores; the kernel runs at 3-4x its bound on an H100.
//   What paces it is one block's critical path a step (wait for the box,
//   form z, barrier, issue the wgmma) and its stores, not the ring's depth
//   or the L2 reads: tools/torch_k1_ablate.py times the kernel with each
//   part taken out, PERF.md has the readings.
//
// * Anything else the wrapper takes (C = 512, the wide tier's RB(512) at
//   16x16; C != Cout): convseg_kernel, the first design, kept as it is. WMMA
//   bf16 16x16x16 with f32 accumulators: a block owns 128 consecutive
//   output pixels (row-major over n, h, w) by BN output channels; each K
//   step gathers, for one tap and 32 input channels, the tap-shifted input
//   pixels with 16-byte loads, forms z while staging them into shared
//   memory and zero-fills pixels outside the image, so every input element
//   is transformed 9 times and re-read from L2 9 times. One register
//   stage; no TMA, no wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "sm90.cuh"

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
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float u, float v) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(u, v);
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
  static __device__ __forceinline__ void store2(float* p, float u, float v) {
    *reinterpret_cast<float2*>(p) = make_float2(u, v);
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


// ------------------------------- the Hopper kernel (C == Cout in {32, 64, 128})

using sm90::align1024;
using sm90::consumers_sync;
using sm90::Geo;

template <int C>
struct FwdShape {
  static_assert(C == 32 || C == 64 || C == 128 || C == 256, "the TMA kernel's channel counts");
  static constexpr int CB = C < 64 ? 32 : 64;   // channels a K step: one swizzle row of z
  static constexpr int SW = CB * 2;             // z's row bytes: the swizzle (64 or 128)
  static constexpr uint32_t LAYOUT = SW == 128 ? 1 : 2;  // wgmma descriptor layout
  static constexpr int KC = C / CB;             // channel slices of a stencil row
  // output channels a block computes (the wgmma's N): all, or at C = 256
  // one half of them, the tile's other half on another block
  static constexpr int NT = C < 256 ? C : 128;
  static constexpr int NSPLIT = C / NT;
  static constexpr int NB = NT / CB;            // w boxes across NT
  static constexpr int B_REGION = CB * SW;      // a w box: CB rows (c) x CB columns (o)
  // C <= 64: one box a tap, and all nine taps (18 or 72 KB) stay in shared
  // memory for the block's life; C = 128: each stage brings its taps' w
  static constexpr bool W_RESIDENT = KC == 1;
  static constexpr int W_BYTES = 9 * B_REGION;
  static constexpr int CPR = CB / 8;            // 16-byte chunks of z a pixel
  static constexpr int CONSUMERS = 256;         // two warpgroups
  static constexpr int WARPS = CONSUMERS / 32;
  static constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
  // the ring: two stages keep the box loads ahead (three or four measured
  // no faster on an H100, PERF.md)
  static constexpr int STAGES = 2;
  static_assert(B_REGION % 1024 == 0, "swizzle atoms stay aligned");
};

// Two f32 values rounded to one bf16x2 word (lo in the low half), through
// the ReLU when `relu`: cvt's .relu clamps the rounded value, which is the
// rounded clamped value.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi, int relu) {
  uint32_t r;
  if (relu)
    asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  else
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// Element e of 8 elements of T held as 32-bit words (bf16: two a word, the
// first in the low half).
template <typename T>
__device__ __forceinline__ float elem(const uint32_t* wd, int e) {
  if (sizeof(T) == 4) return __uint_as_float(wd[e]);
  return __uint_as_float((e & 1) ? wd[e >> 1] & 0xFFFF0000u : wd[e >> 1] << 16);
}

// A block walks tiles blockIdx.x, + gridDim.x, ... (persistent: one wave
// of resident blocks), its producer running ahead across tiles; at C =
// 256 a tile is (128 pixels, one half of the output channels), the two
// halves of a pixel tile neighbours in the order, so the second finds its
// boxes in L2. K step ks
// of a tile is (step, kc): with HALO step = ky and the raw box spans the
// BW + 2d columns from w0 - d that the three taps of the row read; else
// step = the tap and the box is the tile shifted by it. Dynamic shared
// memory: at C <= 64 the nine taps of w; STAGES stages of (the raw box,
// raw_room bytes; at C = 128 the step's taps of w); then three z buffers
// of z_room bytes.
template <typename T, int C, int HALO>
__global__ void __launch_bounds__(FwdShape<C>::THREADS, 1)
tma_fwd_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
               const float* __restrict__ a, const float* __restrict__ b,
               const float* __restrict__ bias, T* __restrict__ y, Geo geo, int d, int act,
               int raw_room, int z_room) {
  using S = FwdShape<C>;
  constexpr int TAPS = HALO ? 3 : 1;  // taps a K step
  constexpr int KSTEPS = (9 / TAPS) * S::KC;
  const int bw = 1 << geo.bw_log2;
  const int box_w = HALO ? bw + 2 * d : bw;
  const int box_pix = geo.bh * box_w;
  constexpr int STAGE_W = S::W_RESIDENT ? 0 : TAPS * S::NB * S::B_REGION;
  const int stage_bytes = raw_room + STAGE_W;
  // what TMA brings a stage: the box (not its rounded room) and the taps' w
  const uint32_t stage_tx = box_pix * S::CB * (int)sizeof(T) + STAGE_W;
  extern __shared__ unsigned char dsmem[];
  unsigned char* wsm = align1024(dsmem);  // W_RESIDENT: w's nine taps
  unsigned char* smem = wsm + (S::W_RESIDENT ? S::W_BYTES : 0);
  unsigned char* zbase = smem + S::STAGES * stage_bytes;
  __shared__ __align__(8) uint64_t full[S::STAGES], empty[S::STAGES], w_full;
  __shared__ float sa[C], sb[C], sbias[C];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < C; i += S::THREADS) {
    sa[i] = a[i];
    sb[i] = b[i];
    sbias[i] = bias[i];
  }
  if (tid == 0) {
    if (S::W_RESIDENT) sm90::mbar_init(&w_full, 1);
    sm90::ring_init(full, empty, S::STAGES, S::WARPS);
  }
  __syncthreads();

  if (warp == S::WARPS) {
    if (lane == 0) {
      if (S::W_RESIDENT) {
        sm90::mbar_arrive_expect_tx(&w_full, S::W_BYTES);
        for (int tap = 0; tap < 9; ++tap)
          sm90::tma_load_3d(wsm + tap * S::B_REGION, &map_w, &w_full, 0, 0, tap);
      }
      int gs = 0;
      for (long long t = blockIdx.x; t < geo.tiles * S::NSPLIT; t += gridDim.x) {
        int n, h0, w0;
        sm90::tile_origin(geo, t / S::NSPLIT, n, h0, w0);
        const int n0 = (int)(t % S::NSPLIT) * S::NT;  // the block's first output channel
        for (int ks = 0; ks < KSTEPS; ++ks, ++gs) {
          const int s = gs % S::STAGES;
          sm90::ring_acquire(full, empty, s, gs / S::STAGES, stage_tx);
          unsigned char* st = smem + s * stage_bytes;
          const int step = ks / S::KC, kc = ks - step * S::KC;
          const int ky = HALO ? step : step / 3;
          const int col = HALO ? w0 - d : w0 + (step % 3 - 1) * d;
          sm90::tma_load_4d(st, &map_x, &full[s], kc * S::CB, col, h0 + (ky - 1) * d, n);
          if (!S::W_RESIDENT)
            for (int tx = 0; tx < TAPS; ++tx)
#pragma unroll
              for (int nb = 0; nb < S::NB; ++nb)
                sm90::tma_load_3d(st + raw_room + (tx * S::NB + nb) * S::B_REGION, &map_w,
                                  &full[s], n0 + nb * S::CB, kc * S::CB,
                                  HALO ? ky * 3 + tx : step);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg takes pixels [64 wg, 64 wg + 64) of a tile:
  // z rows from arow (with HALO for the tap at column offset -d; tap kx
  // reads kx*d rows further). Each thread forms one 16-byte chunk (ch) of
  // z in every pixel it takes.
  const int wg = warp >> 2;
  const int arow = HALO ? ((wg * 64) >> geo.bw_log2) * box_w + ((wg * 64) & (bw - 1)) : wg * 64;
  const int ch = tid % S::CPR;
  if (S::W_RESIDENT) sm90::mbar_wait(&w_full, 0);
  int gs = 0;
  for (long long t = blockIdx.x; t < geo.tiles * S::NSPLIT; t += gridDim.x) {
    int n, h0, w0;
    sm90::tile_origin(geo, t / S::NSPLIT, n, h0, w0);
    const int n0 = (int)(t % S::NSPLIT) * S::NT;
    float acc[S::NT / 2];
#pragma unroll
    for (int i = 0; i < S::NT / 2; ++i) acc[i] = 0.0f;
    for (int ks = 0; ks < KSTEPS; ++ks, ++gs) {
      const int s = gs % S::STAGES;
      const int step = ks / S::KC, kc = ks - step * S::KC;
      const int ky = HALO ? step : step / 3;
      const int h_org = h0 + (ky - 1) * d;
      const int w_org = HALO ? w0 - d : w0 + (step % 3 - 1) * d;
      const int c0 = kc * S::CB + ch * 8;  // the chunk's channels: its logical index
      float av[8], bv[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        av[e] = sa[c0 + e];
        bv[e] = sb[c0 + e];
      }
      const unsigned char* st = smem + s * stage_bytes;
      unsigned char* zs = zbase + (gs % 3) * z_room;
      sm90::mbar_wait(&full[s], (gs / S::STAGES) & 1);
      // z of the box into buffer gs % 3, last read by step gs - 3's wgmma,
      // which every warpgroup waited for before the barrier of step gs - 1.
      // U chunks a pass, their loads issued together.
      constexpr int WORDS = 2 * (int)sizeof(T);  // 32-bit words in 8 elements of T
      constexpr int U = sizeof(T) == 2 ? 4 : 2;
      constexpr int PASS = S::CONSUMERS / S::CPR;  // pixels a pass of the consumers
      for (int p0 = tid / S::CPR; p0 < box_pix; p0 += U * PASS) {
        uint32_t wd[U][WORDS];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int p = p0 + u * PASS;
          const uint4* src =
              reinterpret_cast<const uint4*>(st + (p * S::CB + ch * 8) * (int)sizeof(T));
          if (p < box_pix)
#pragma unroll
            for (int k = 0; k < WORDS / 4; ++k) *reinterpret_cast<uint4*>(&wd[u][4 * k]) = src[k];
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int p = p0 + u * PASS;
          if (p >= box_pix) break;
          // the box row: HALO boxes have BH <= 2 rows (BW >= 64), the
          // others BW = box_w columns, a power of two
          const int br = HALO ? (p >= box_w) : p >> geo.bw_log2, bc = p - br * box_w;
          const bool in = (unsigned)(h_org + br) < (unsigned)geo.H &&
                          (unsigned)(w_org + bc) < (unsigned)geo.W;
          uint4 zw;
          uint32_t* zp = reinterpret_cast<uint32_t*>(&zw);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t pk = bf16x2(__fmaf_rn(elem<T>(wd[u], 2 * i), av[2 * i], bv[2 * i]),
                                       __fmaf_rn(elem<T>(wd[u], 2 * i + 1), av[2 * i + 1],
                                                 bv[2 * i + 1]),
                                       act);
            zp[i] = in ? pk : 0u;
          }
          *reinterpret_cast<uint4*>(zs + sm90::swizzle<S::SW>(p * S::SW + ch * 16)) = zw;
        }
      }
      sm90::fence_proxy_async();
      consumers_sync<S::CONSUMERS>();
      // with w resident the stage held only the box, now formed: free it
      if (S::W_RESIDENT && lane == 0) sm90::mbar_arrive(&empty[s]);
      // the step's first tap of w: ky's three (HALO) or the one
      const unsigned char* Bs = S::W_RESIDENT ? wsm + (HALO ? ky * 3 : step) * S::B_REGION
                                              : st + raw_room;
      sm90::wgmma_fence();
#pragma unroll
      for (int tx = 0; tx < TAPS; ++tx) {
        const unsigned char* As = zs + (arow + (HALO ? tx * d : 0)) * S::SW;
#pragma unroll
        for (int k = 0; k < S::CB / 16; ++k) {
          const uint64_t da = sm90::desc(As + k * 32, 16, 8 * S::SW, S::LAYOUT);
          const uint64_t db = sm90::desc(Bs + tx * S::NB * S::B_REGION + k * 16 * S::SW,
                                         S::B_REGION, 8 * S::SW, S::LAYOUT);
          sm90::wgmma<S::NT, 0, 1>(acc, da, db);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      // else the stage's w is free once its wgmma is done
      if (!S::W_RESIDENT && ks > 0 && lane == 0) sm90::mbar_arrive(&empty[(gs - 1) % S::STAGES]);
    }
    sm90::wgmma_wait<0>();
    if (!S::W_RESIDENT && lane == 0) sm90::mbar_arrive(&empty[(gs - 1) % S::STAGES]);

    // epilogue straight from the accumulators, + bias in f32: this
    // thread's rows r and r + 8 of the warpgroup's 64, channels n0 + 8j +
    // 2q + {0, 1}; no barrier, the z buffers are not touched
    const int q = lane & 3;
    const int r0 = wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 8 * hh;
      const int h = h0 + (r >> geo.bw_log2), w = w0 + (r & (bw - 1));
      if (h < geo.H && w < geo.W) {
        T* dst = y + (((long long)n * geo.H + h) * geo.W + w) * C;
#pragma unroll
        for (int j = 0; j < S::NT / 8; ++j) {
          const int c = n0 + 8 * j + 2 * q;
          Io<T>::store2(dst + c, acc[4 * j + 2 * hh] + sbias[c], acc[4 * j + 2 * hh + 1] + sbias[c + 1]);
        }
      }
    }
  }
}

// ------------------------------------------------------ the Hopper host side

constexpr int FWD_SMEM_LIMIT = 223 * 1024;  // 227 KB less the static shared memory (3 KB at C = 256)

int round1024(int bytes) { return (bytes + 1023) / 1024 * 1024; }

// The shared-memory plan of a call: the halo box where a warpgroup's 64
// pixels lie in one image row and the box fits TMA's 256 columns and the
// shared memory, else a box a tap.
struct FwdPlan {
  int halo, raw_room, z_room, smem;
};

template <typename T, int C>
FwdPlan fwd_plan(const Geo& g, int d) {
  using S = FwdShape<C>;
  const int bw = 1 << g.bw_log2;
  FwdPlan p;
  for (p.halo = bw >= 64 && bw + 2 * d <= 256;; p.halo = 0) {
    const int box_pix = g.bh * (p.halo ? bw + 2 * d : bw);
    p.raw_room = round1024(box_pix * S::CB * (int)sizeof(T));
    p.z_room = round1024(box_pix * S::SW);
    const int stage_w = S::W_RESIDENT ? 0 : (p.halo ? 3 : 1) * S::NB * S::B_REGION;
    p.smem = (S::W_RESIDENT ? S::W_BYTES : 0) + S::STAGES * (p.raw_room + stage_w) +
             3 * p.z_room + 1024;
    if (p.smem <= FWD_SMEM_LIMIT || !p.halo) return p;
  }
}

// Launches the kernel as one wave of resident blocks.
template <typename T, int C, int HALO>
cudaError_t launch_tma_fwd(const CUtensorMap& map_x, const CUtensorMap& map_w, const float* a,
                           const float* b, const float* bias, void* y, const Geo& geo, int d,
                           int act, const FwdPlan& p, cudaStream_t stream) {
  using S = FwdShape<C>;
  auto kernel = tma_fwd_kernel<T, C, HALO>;
  long long grid = 0;
  const cudaError_t err = sm90::wave_blocks(kernel, S::THREADS, p.smem, FWD_SMEM_LIMIT, &grid);
  if (err != cudaSuccess) return err;
  if (grid > geo.tiles * S::NSPLIT) grid = geo.tiles * S::NSPLIT;
  kernel<<<(unsigned)grid, S::THREADS, p.smem, stream>>>(map_x, map_w, a, b, bias,
                                                        static_cast<T*>(y), geo, d, act,
                                                        p.raw_room, p.z_room);
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t launch_tma(const void* x, const float* a, const float* b, const __nv_bfloat16* w,
                       const float* bias, void* y, int N, int H, int W, int d, int act,
                       cudaStream_t stream) {
  using S = FwdShape<C>;
  const Geo geo = sm90::make_geo(N, H, W, 128);
  const FwdPlan p = fwd_plan<T, C>(geo, d);
  const int bw = 1 << geo.bw_log2;
  CUtensorMap map_x, map_w;
  const cuuint64_t wdims[3] = {(cuuint64_t)C, (cuuint64_t)C, 9};
  const cuuint64_t wstrides[2] = {(cuuint64_t)C * 2, (cuuint64_t)C * C * 2};
  const cuuint32_t wbox[3] = {(cuuint32_t)S::CB, (cuuint32_t)S::CB, 1};
  const CUtensorMapDataType xtype =
      sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (!sm90::act_map(&map_x, x, geo, C, S::CB, p.halo ? bw + 2 * d : bw, 0, xtype) ||
      !sm90::make_map(&map_w, w, 3, wdims, wstrides, wbox, S::SW))
    return cudaErrorNotSupported;
  return p.halo ? launch_tma_fwd<T, C, 1>(map_x, map_w, a, b, bias, y, geo, d, act, p, stream)
                : launch_tma_fwd<T, C, 0>(map_x, map_w, a, b, bias, y, geo, d, act, p, stream);
}

template <typename T>
cudaError_t dispatch_tma(int C, const void* x, const float* a, const float* b,
                         const __nv_bfloat16* w, const float* bias, void* y, int N, int H, int W,
                         int d, int act, cudaStream_t s) {
  switch (C) {
    case 32:
      return launch_tma<T, 32>(x, a, b, w, bias, y, N, H, W, d, act, s);
    case 64:
      return launch_tma<T, 64>(x, a, b, w, bias, y, N, H, W, d, act, s);
    case 128:
      return launch_tma<T, 128>(x, a, b, w, bias, y, N, H, W, d, act, s);
    case 256:
      return launch_tma<T, 256>(x, a, b, w, bias, y, N, H, W, d, act, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: (N, H, W, C|Cout) contiguous, bf16 (x_is_bf16 = 1) or f32, 16-byte
// aligned; a, b: (C,) f32; w: (3, 3, C, Cout) HWIO bf16; bias: (Cout,) f32.
// C and Cout multiples of 32, C <= 512. C == Cout in {32, 64, 128, 256} runs
// tma_fwd_kernel, anything else convseg_kernel: one launch either
// way. Returns the cudaError_t of the launch (no other kernel is tried).
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
  cudaError_t err;
  if (C == Cout && (C == 32 || C == 64 || C == 128 || C == 256))
    err = x_is_bf16 ? dispatch_tma<__nv_bfloat16>(C, x, af, bf, wb, biasf, y, N, H, W, d, act, s)
                    : dispatch_tma<float>(C, x, af, bf, wb, biasf, y, N, H, W, d, act, s);
  else
    err = x_is_bf16 ? launch<__nv_bfloat16>(x, af, bf, wb, biasf, y, N, H, W, C, Cout, d, act, s)
                    : launch<float>(x, af, bf, wb, biasf, y, N, H, W, C, Cout, d, act, s);
  return (int)err;
}
