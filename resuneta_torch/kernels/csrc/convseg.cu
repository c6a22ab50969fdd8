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
// One design, tma_fwd_kernel, for C == Cout in {32, 64, 128} (every
// segment of the default model), 256 (the opt-in wide tier's RB(256)) and
// 512 (the wide eval tier's RB(512)); convseg_forward refuses anything
// else. TMA-fed, mbarrier-pipelined wgmma: an implicit GEMM with M = a
// tile of 128 output pixels (a rectangle of one image, 1 x 128 at W >=
// 128, 2 x 64 at W = 64: sm90::Geo; 64 pixels at C = 512, below), N = Cout
// (at C = 256 one 128-channel half of it a work item, the other half
// another), K = 9 taps x C, two consumer warpgroups of 64 pixels and one
// producer warp whose one thread keeps TMA loads in flight through a ring
// of stages. A K step is one stencil row ky and CB
// channels: the producer loads the raw x box of that row, BH rows x (BW +
// 2d) columns from (h0 + (ky-1)d, w0 - d), unswizzled and in x's type. w
// (HWIO w[ky, kx] is C x Cout with Cout contiguous: B is MN-major as it
// lies) stays in shared memory for the block's life at C <= 64 (18 or 72
// KB, loaded once), and comes with each stage, the step's taps of the
// item's 128 (or C) output channels, at C >= 128.
// The consumers form z from the box once, in shared memory (__fmaf_rn; the
// ReLU and the one bf16 rounding in one cvt.rn.relu.bf16x2; a mask on the
// box's image coordinates, since TMA's zero fill gives x = 0, not z = 0),
// write it in the swizzled K-major layout wgmma reads, fence the generic
// proxy against the async one, meet at a barrier, and the three taps read
// it at row offsets kx*d. So x is read from device memory about once and
// from L2 3 (BW + 2d) / BW times, z is formed 3 (BW + 2d) / BW times per
// element instead of 9, and never reaches device memory; the next step's z
// is formed while this step's wgmma runs (three z buffers, one barrier a
// step). Where BW + 2d > 256 (TMA's box limit), a warpgroup's 64 pixels
// span image rows (W <= 32) or the halo plan does not fit shared memory, a
// K step is one tap and its box is the tile itself (HALO = 0). Blocks are
// persistent (one wave); the epilogue adds the bias in f32 and writes y
// straight from the accumulators (4- or 8-byte stores, no barrier),
// masking the pixels a ragged tile overhangs.
// At C = 32 and 64 the bound is bytes (x once in, y once out), at C >= 128
// the tensor cores; the kernel runs at 3-4x its bound on an H100. What
// paces it is one block's critical path a step (wait for the box, form z,
// barrier, issue the wgmma) and its stores, not the ring's depth or the L2
// reads: tools/torch_k1_ablate.py times the kernel with each part taken
// out, PERF.md has the readings.
// C = 512 (RB(512) at 16^2; W <= 32: HALO = 0, a K step one tap and 64
// channels, 72 steps a work item): a work item is 64 pixels x 256 output
// channels (SPLIT_N), the two consumer warpgroups on the same z, each on
// 128 channels (64 accumulators a thread, as at C = 256), so z is formed
// once for 256 output channels: twice for each x element and tap, where
// 128-pixel items of 128 channels would form it four times. A stage is the x box (64 px x 64 ch, 8
// KB in bf16, 16 KB in f32) and four w boxes of 64 x 64 (32 KB), held
// until the stage's wgmma is done, so the ring is four stages deep
// (fwd_stages); the z buffers are 8 KB each: 185 KB (bf16) or 217 KB
// (f32) of the 220 KB a block may have beside its 6 KB of static scale,
// shift and bias, so one block an SM. A 32-patch batch has 128 pixel tiles
// (4 x 16) x 2 halves of N = 256 work items; the grid is one block an SM
// (132), each walking items blockIdx.x + k * 132: 124 blocks take two, 8
// one (1.94 waves). What paces it: tools/torch_k1_ablate.py --c512
// (PERF.md has the readings).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

// y's stores: two output channels of T from f32.
template <typename T>
struct Io;

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float u, float v) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(u, v);
  }
};

template <>
struct Io<float> {
  static __device__ __forceinline__ void store2(float* p, float u, float v) {
    *reinterpret_cast<float2*>(p) = make_float2(u, v);
  }
};

// ---------------------------- the Hopper kernel (C == Cout in {32, ..., 512})

using sm90::align1024;
using sm90::consumers_sync;
using sm90::Geo;

template <int C>
struct FwdShape {
  static_assert(C == 32 || C == 64 || C == 128 || C == 256 || C == 512,
                "the TMA kernel's channel counts");
  static constexpr int CB = C < 64 ? 32 : 64;   // channels a K step: one swizzle row of z
  static constexpr int SW = CB * 2;             // z's row bytes: the swizzle (64 or 128)
  static constexpr uint32_t LAYOUT = SW == 128 ? 1 : 2;  // wgmma descriptor layout
  static constexpr int KC = C / CB;             // channel slices of a stencil row
  // A work item: PIX pixels x NI output channels. Up to C = 256 128
  // pixels, a warpgroup each 64 of them, on all C channels or (C = 256)
  // one 128-channel half, the other half another item's. At C = 512
  // (SPLIT_N) 64 pixels x 256 channels, the two warpgroups on the same z,
  // each on 128 channels, so z is formed once for 256 of them. A
  // warpgroup's N (the wgmma's) is NT, at most 128: 128 f32 accumulators a
  // thread would spill.
  static constexpr bool SPLIT_N = C == 512;
  static constexpr int PIX = SPLIT_N ? 64 : 128;
  static constexpr int NT = C < 256 ? C : 128;
  static constexpr int NI = SPLIT_N ? 2 * NT : NT;
  static constexpr int NSPLIT = C / NI;
  static constexpr int NB = NT / CB;            // w boxes across NT
  static constexpr int NB_ITEM = NI / CB;       // and across NI
  static constexpr int B_REGION = CB * SW;      // a w box: CB rows (c) x CB columns (o)
  // C <= 64: one box a tap, and all nine taps (18 or 72 KB) stay in shared
  // memory for the block's life; C >= 128: each stage brings its taps' w
  static constexpr bool W_RESIDENT = KC == 1;
  static constexpr int W_BYTES = 9 * B_REGION;
  static constexpr int CPR = CB / 8;            // 16-byte chunks of z a pixel
  static constexpr int CONSUMERS = 256;         // two warpgroups
  static constexpr int WARPS = CONSUMERS / 32;
  static constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
  // the ring: two stages keep the box loads ahead up to C = 256 (three or
  // four measured no faster on an H100, PERF.md); C = 512: fwd_stages
  static constexpr int STAGES = 2;
  static_assert(B_REGION % 1024 == 0, "swizzle atoms stay aligned");
};

// The ring's depth: at C = 512 a stage holds its w boxes until the
// stage's wgmma is done, and four stages keep the loads ahead (two are
// ~45% slower, three within 2% of four: tools/torch_k1_ablate.py --c512).
template <typename T, int C>
__host__ __device__ constexpr int fwd_stages() {
  return C < 512 ? FwdShape<C>::STAGES : 4;
}

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

// A block walks work items blockIdx.x, + gridDim.x, ... (persistent: one
// wave of resident blocks), its producer running ahead across items; at C
// >= 256 an item is (128 pixels, one 128-channel part of the output
// channels), the NSPLIT parts of a pixel tile neighbours in the order, so
// the later ones find their boxes in L2. K step ks
// of a tile is (step, kc): with HALO step = ky and the raw box spans the
// BW + 2d columns from w0 - d that the three taps of the row read; else
// step = the tap and the box is the tile shifted by it. Dynamic shared
// memory: at C <= 64 the nine taps of w; STAGES stages of (the raw box,
// raw_room bytes; at C >= 128 the step's taps of w); then three z buffers
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
  constexpr int STAGE_W = S::W_RESIDENT ? 0 : TAPS * S::NB_ITEM * S::B_REGION;
  const int stage_bytes = raw_room + STAGE_W;
  // what TMA brings a stage: the box (not its rounded room) and the taps' w
  const uint32_t stage_tx = box_pix * S::CB * (int)sizeof(T) + STAGE_W;
  extern __shared__ unsigned char dsmem[];
  unsigned char* wsm = align1024(dsmem);  // W_RESIDENT: w's nine taps
  unsigned char* smem = wsm + (S::W_RESIDENT ? S::W_BYTES : 0);
  constexpr int STAGES = fwd_stages<T, C>();
  unsigned char* zbase = smem + STAGES * stage_bytes;
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], w_full;
  __shared__ float sa[C], sb[C], sbias[C];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < C; i += S::THREADS) {
    sa[i] = a[i];
    sb[i] = b[i];
    sbias[i] = bias[i];
  }
  if (tid == 0) {
    if (S::W_RESIDENT) sm90::mbar_init(&w_full, 1);
    sm90::ring_init(full, empty, STAGES, S::WARPS);
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
        const int n0 = (int)(t % S::NSPLIT) * S::NI;  // the item's first output channel
        for (int ks = 0; ks < KSTEPS; ++ks, ++gs) {
          const int s = gs % STAGES;
          sm90::ring_acquire(full, empty, s, gs / STAGES, stage_tx);
          unsigned char* st = smem + s * stage_bytes;
          const int step = ks / S::KC, kc = ks - step * S::KC;
          const int ky = HALO ? step : step / 3;
          const int col = HALO ? w0 - d : w0 + (step % 3 - 1) * d;
          sm90::tma_load_4d(st, &map_x, &full[s], kc * S::CB, col, h0 + (ky - 1) * d, n);
          if (!S::W_RESIDENT)
            for (int tx = 0; tx < TAPS; ++tx)
#pragma unroll
              for (int nb = 0; nb < S::NB_ITEM; ++nb)
                sm90::tma_load_3d(st + raw_room + (tx * S::NB_ITEM + nb) * S::B_REGION, &map_w,
                                  &full[s], n0 + nb * S::CB, kc * S::CB,
                                  HALO ? ky * 3 + tx : step);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg takes pixels [wpix, wpix + 64) of a tile and
  // its channels [wch, wch + NT) of the item: z rows from arow (with HALO
  // for the tap at column offset -d; tap kx reads kx*d rows further). Each
  // thread forms one 16-byte chunk (ch) of z in every pixel it takes.
  const int wg = warp >> 2;
  const int wpix = S::SPLIT_N ? 0 : wg * 64, wch = S::SPLIT_N ? wg * S::NT : 0;
  const int arow = HALO ? (wpix >> geo.bw_log2) * box_w + (wpix & (bw - 1)) : wpix;
  const int ch = tid % S::CPR;
  if (S::W_RESIDENT) sm90::mbar_wait(&w_full, 0);
  int gs = 0;
  for (long long t = blockIdx.x; t < geo.tiles * S::NSPLIT; t += gridDim.x) {
    int n, h0, w0;
    sm90::tile_origin(geo, t / S::NSPLIT, n, h0, w0);
    const int n0 = (int)(t % S::NSPLIT) * S::NI;
    float acc[S::NT / 2];
#pragma unroll
    for (int i = 0; i < S::NT / 2; ++i) acc[i] = 0.0f;
    for (int ks = 0; ks < KSTEPS; ++ks, ++gs) {
      const int s = gs % STAGES;
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
      sm90::mbar_wait(&full[s], (gs / STAGES) & 1);
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
                                              : st + raw_room + wch / S::CB * S::B_REGION;
      sm90::wgmma_fence();
#pragma unroll
      for (int tx = 0; tx < TAPS; ++tx) {
        const unsigned char* As = zs + (arow + (HALO ? tx * d : 0)) * S::SW;
#pragma unroll
        for (int k = 0; k < S::CB / 16; ++k) {
          const uint64_t da = sm90::desc(As + k * 32, 16, 8 * S::SW, S::LAYOUT);
          const uint64_t db = sm90::desc(Bs + tx * S::NB_ITEM * S::B_REGION + k * 16 * S::SW,
                                         S::B_REGION, 8 * S::SW, S::LAYOUT);
          sm90::wgmma<S::NT, 0, 1>(acc, da, db);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      // else the stage's w is free once its wgmma is done
      if (!S::W_RESIDENT && ks > 0 && lane == 0) sm90::mbar_arrive(&empty[(gs - 1) % STAGES]);
    }
    sm90::wgmma_wait<0>();
    if (!S::W_RESIDENT && lane == 0) sm90::mbar_arrive(&empty[(gs - 1) % STAGES]);

    // epilogue straight from the accumulators, + bias in f32: this
    // thread's rows r and r + 8 of the warpgroup's 64, channels n0 + wch +
    // 8j + 2q + {0, 1}; no barrier, the z buffers are not touched
    const int q = lane & 3;
    const int r0 = wpix + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 8 * hh;
      const int h = h0 + (r >> geo.bw_log2), w = w0 + (r & (bw - 1));
      if (h < geo.H && w < geo.W) {
        T* dst = y + (((long long)n * geo.H + h) * geo.W + w) * C;
#pragma unroll
        for (int j = 0; j < S::NT / 8; ++j) {
          const int c = n0 + wch + 8 * j + 2 * q;
          Io<T>::store2(dst + c, acc[4 * j + 2 * hh] + sbias[c], acc[4 * j + 2 * hh + 1] + sbias[c + 1]);
        }
      }
    }
  }
}

// ------------------------------------------------------ the Hopper host side

// The dynamic shared memory a block may have: 227 KB less the static
// (sa, sb, sbias: 12 C bytes, and the barriers), counted at C >= 256 (223
// KB up to C = 256, 220 KB at 512).
constexpr int fwd_smem_limit(int C) { return 227 * 1024 - 1024 - 12 * (C > 256 ? C : 256); }

int round1024(int bytes) { return (bytes + 1023) / 1024 * 1024; }

// The shared-memory plan of a call: the halo box where a warpgroup's 64
// pixels lie in one image row and the box fits TMA's 256 columns and the
// shared memory, else a box a tap.
struct FwdPlan {
  int halo, raw_room, z_room, smem;
};

template <typename T, int C>
FwdPlan fwd_plan(const Geo& g, int d) {
  constexpr int LIMIT = fwd_smem_limit(C);
  using S = FwdShape<C>;
  const int bw = 1 << g.bw_log2;
  FwdPlan p;
  for (p.halo = bw >= 64 && bw + 2 * d <= 256;; p.halo = 0) {
    const int box_pix = g.bh * (p.halo ? bw + 2 * d : bw);
    p.raw_room = round1024(box_pix * S::CB * (int)sizeof(T));
    p.z_room = round1024(box_pix * S::SW);
    const int stage_w = S::W_RESIDENT ? 0 : (p.halo ? 3 : 1) * S::NB_ITEM * S::B_REGION;
    p.smem = (S::W_RESIDENT ? S::W_BYTES : 0) + fwd_stages<T, C>() * (p.raw_room + stage_w) +
             3 * p.z_room + 1024;
    if (p.smem <= LIMIT || !p.halo) return p;
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
  const cudaError_t err = sm90::wave_blocks(kernel, S::THREADS, p.smem, fwd_smem_limit(C), &grid);
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
  const Geo geo = sm90::make_geo(N, H, W, S::PIX);
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
    case 512:
      return launch_tma<T, 512>(x, a, b, w, bias, y, N, H, W, d, act, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: (N, H, W, C) contiguous, bf16 (x_is_bf16 = 1) or f32, 16-byte
// aligned; a, b, bias: (C,) f32; w: (3, 3, C, C) HWIO bf16. C == Cout in
// {32, 64, 128, 256, 512}, one launch of tma_fwd_kernel; anything else
// returns cudaErrorInvalidValue. Returns the cudaError_t of the launch.
extern "C" int convseg_forward(const void* x, const void* a, const void* b, const void* w,
                               const void* bias, void* y, int N, int H, int W, int C,
                               int Cout, int d, int act, int x_is_bf16, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || d <= 0 || C != Cout)
    return (int)cudaErrorInvalidValue;
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
  const float* biasf = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_is_bf16 ? dispatch_tma<__nv_bfloat16>(C, x, af, bf, wb, biasf, y, N, H, W, d, act, s)
                : dispatch_tma<float>(C, x, af, bf, wb, biasf, y, N, H, W, d, act, s);
  return (int)err;
}
