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
// bound). At the 256 px step's shapes (1M, 256K, 64K pixels) every call is
// 38.7 GFLOP: 0.039 ms at the card's bf16 peak; K9's calls (16K-32K
// pixels at C = 256) are 38.7-77.3 GFLOP, 0.039-0.078 ms.
//
// Every call is four launches on the caller's stream, no atomics, and the
// result is deterministic; against the plain version only the order of
// the f32 sums differs.
//
// One design for every C: TMA-fed, mbarrier-pipelined wgmma, in two
// kernels.
// * Pixel tiles are rectangles of one image, BH rows x BW columns (BW the
//   power of two >= W up to the tile: dgrad's 128 pixels are 1 x 128 at W
//   >= 128, 2 x 64 at W = 64 and 4 x 32 at W = 32; wgrad's 64 are 1 x 64
//   or 2 x 32), so each tap-shifted operand is one TMA box of a 4-D tensor
//   map over (C, W, H, N); TMA fills zeros where the box leaves the
//   image, which is the conv's SAME padding with no bounds arithmetic;
//   where W is not a multiple of BW the box overhangs and the epilogue
//   masks those pixels.
// * A block is consumer warpgroups and one producer warp whose one thread
//   keeps TMA loads in flight through a ring of stages, each with a `full`
//   mbarrier (transaction bytes) and an `empty` one (one arrival per
//   consumer warp once its wgmma has read the stage). A wait that lasts
//   seconds traps instead of hanging.
// * tma_dgrad_kernel: M = a tile's 128 pixels (two warpgroups of 64), N =
//   NC = min(C, 128) channels of dz, K = 9 taps x C. A is gb, K-major; B
//   the taps' rows of wT, MN-major (wgmma's transpose bit). A work item is
//   (tile, N part): one part at C <= 128, two halves of 128 channels at C
//   = 256. A block owning all 256 would hold 128 f32 accumulators a
//   thread, a 96 KB stage of three taps' wT rows and a 135 KB epilogue
//   scratch; as halves a K9 item is K2's C = 128 item with K doubled, and
//   g, read twice, comes mostly from L2 (9216 flops a byte leaves room).
//   Blocks are persistent (one wave, a multiple of the parts, so a block
//   keeps one half: its BN parameters and its row of partials), the
//   producer running ahead across items. Where a warpgroup's 64 pixels
//   lie in one image row (BW >= 64) a K step loads one box BW + 2d
//   columns wide and the three taps of a stencil row start their
//   descriptors at row offsets 0, d, 2d of it: a third of the shifted
//   loads (at 32^2, BW = 32, a K step is one tap). The epilogue recomputes
//   z_pre = __fmaf_rn(x, a, b), masks, writes dx and zb = bf16(act(z_pre))
//   to a workspace (N, H, W, C) bf16 (an item owns its channels of its
//   pixels, so wgrad never forms z again), and sums S1, S2 and dc over the
//   block's items in a fixed order into its half of one row of partials
//   (blocks 2r and 2r + 1 share row r at C = 256); at C >= 64 it goes
//   through an f32 scratch in shared memory for 16-byte accesses, at C =
//   32 straight from the accumulators (the scratch path's registers would
//   cost resident blocks).
// * tma_wgrad_kernel: dW_t = sum_p zb[p + t*d] (outer) gb[p], the same
//   pairs as above since both are 0 outside the image; M = a 64-row tile
//   of (tap, input channel), N = NC output channels, K = pixels. zb is the
//   shifted operand, gb the unshifted one, both MN-major. At C = 32 the 64
//   rows are two taps' 32 channels (two 64-byte-swizzled boxes one LBO
//   apart; tap 8 has no partner), at C >= 64 one tap's 64 channels. A
//   block is (pixel chunk, 5 M tiles at C = 32, else 3: the three taps of
//   one stencil row, which share one halo box of zb, N part), stages of 64
//   pixels; each warpgroup writes its tile of the chunk's partial dW. At C
//   = 256 an n256 accumulator (128 registers a thread) would allow two
//   consumer warpgroups, which do not share a row's box; N in two n128
//   halves keeps three and reads zb twice. A chunk's partial is 9 C^2
//   floats (2.36 MB at C = 256), so K9 takes one wave of blocks (5 chunks
//   x 24), K2 two.
// * reduce_rows sums the S1/S2/dc partials over dgrad's rows, and the dW
//   partials over chunks (reduce_cols at C >= 128, whose 9 C^2 columns
//   fill the card a thread each), each in a fixed order.
// * f32 inputs: TMA reads bf16, so the caller appends bf16(g) to the
//   workspace (the same round to nearest); x stays f32 for the epilogue
//   and dx is written in x's type.
// * The bound is the tensor cores at C >= 64 and the four activation
//   streams at C = 32. At C = 256 both kernels are paced by the stages
//   they stream from L2 (tools/torch_k9_ablate.py: without the wgmma
//   dgrad keeps 70% of its time and wgrad 70%; a deeper wgrad ring
//   changes nothing), dgrad's mostly wT, read again for every 128-pixel
//   item, and its epilogue, which the tensor cores wait for, 18%. So the
//   halo box stays where it fits (a box a tap reads 40% more and is 10%
//   slower at 64^2 and 128^2) and wgrad keeps one wave (two waves write
//   twice the dW partials and lose what they gain). PERF.md has the
//   times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using sm90::act_map;
using sm90::align1024;
using sm90::consumers_sync;
using sm90::Geo;
using sm90::make_geo;
using sm90::ring_acquire;
using sm90::ring_init;
using sm90::tile_origin;

// The epilogue's loads and stores of x's type: 8 elements (Io) or 2 (Io2)
// as f32.
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

template <typename T>
struct Io2;

template <>
struct Io2<__nv_bfloat16> {
  static __device__ __forceinline__ float2 load(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float u, float v) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(u, v);
  }
};

template <>
struct Io2<float> {
  static __device__ __forceinline__ float2 load(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ void store(float* p, float u, float v) {
    *reinterpret_cast<float2*>(p) = make_float2(u, v);
  }
};

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

// out[4i..4i+3] = sum over rows of part[row, 4i..4i+3], rows in order: a
// thread a float4 column, so every row is read coalesced (the dW
// partials: 5-44 rows, 9*C^2 columns); eight rows' loads in flight.
__global__ void __launch_bounds__(256)
reduce_cols(const float4* __restrict__ part, long long rows, int cols4, float4* __restrict__ out) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= cols4) return;
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (long long r0 = 0; r0 < rows; r0 += 8) {
    float4 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v[k] = r0 + k < rows ? part[(r0 + k) * cols4 + i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      s.x += v[k].x;
      s.y += v[k].y;
      s.z += v[k].z;
      s.w += v[k].w;
    }
  }
  out[i] = s;
}

// ------------------------------------------------------- TMA + wgmma

constexpr int SMS = 132;                   // the H100's multiprocessors
constexpr int WG_TARGET_BLOCKS = 2 * SMS;  // K2's wgrad blocks: two waves

// dgrad: two consumer warpgroups of 64 pixels each (a tile of 128) and
// one producer warp; a ring of stages of (the shifted gb box, the taps' wT
// rows of the item's N part) and the epilogue's f32 dz scratch (see
// tma_dgrad_kernel)
template <int C>
struct DgShape {
  static_assert(C == 32 || C == 64 || C == 128 || C == 256, "K2's and K9's channel counts");
  static constexpr int CB = C < 64 ? 32 : 64;   // channels of a box: one swizzle row
  static constexpr int SW = CB * 2;             // its bytes: the swizzle (64 or 128)
  static constexpr uint32_t LAYOUT = SW == 128 ? 1 : 2;  // wgmma descriptor layout
  static constexpr int NC = C < 128 ? C : 128;  // a work item's channels of dz: its N
  static constexpr int NH = C / NC;             // N parts of a tile (2 at C = 256)
  static constexpr int NB = NC / CB;            // wT boxes across an item's N
  static constexpr int KC = C / CB;             // gb boxes across C: K steps a tap
  static constexpr int PIX = 128;
  static constexpr int A = PIX * SW;            // the shifted gb box
  static constexpr int B_REGION = CB * SW;      // wT: CB rows (o) x CB channels (c)
  static constexpr int SCR_LD = NC + 8;         // f32 dz row: 8 banks apart
  static constexpr int SCRATCH = PIX * SCR_LD * 4;
  static constexpr int THREADS = 288;
  static constexpr int CONSUMERS = 256;
  static constexpr int WARPS = 8;               // consumer warps
  static_assert(A % 1024 == 0 && B_REGION % 1024 == 0, "swizzle atoms stay aligned");
};

// wgrad: NWG consumer warpgroups, one 64-row M tile of (tap, input
// channel) each, NC output channels, stages of 64 pixels, and one
// producer warp
template <int C>
struct WgShape {
  static constexpr int CB = C < 64 ? 32 : 64;
  static constexpr int SW = CB * 2;
  static constexpr uint32_t LAYOUT = SW == 128 ? 1 : 2;
  static constexpr int NC = C < 128 ? C : 128;              // a block's output channels
  static constexpr int NH = C / NC;                         // N parts (2 at C = 256)
  static constexpr int NB = NC / CB;                        // gb boxes a stage
  static constexpr int NWG = C == 32 ? 5 : 3;               // M tiles a block
  static constexpr int PIX = 64;                            // pixels a stage
  static constexpr int MTILES = C == 32 ? 5 : 9 * C / 64;   // 5, 9, 18, 36
  static constexpr int GROUPS = (MTILES + NWG - 1) / NWG;
  static constexpr int YS = GROUPS * NH;                    // the grid's y extent
  static constexpr int REGION = PIX * SW;                   // a box of zb or gb
  static constexpr int A = (C == 32 ? 2 : 1) * REGION;      // a warpgroup's zb
  static constexpr int THREADS = NWG * 128 + 32;
  static constexpr int WARPS = NWG * 4;
  static_assert(REGION % 1024 == 0, "swizzle atoms stay aligned");
};

// A block walks work items blockIdx.x, + gridDim.x, ... (persistent: one
// wave of resident blocks), its producer running ahead across items, and
// sums S1, S2, dc over its items in a fixed order into one row of
// partials. Item t is tile t / NH, N part t % NH: gridDim.x is a multiple
// of NH, so a block keeps one part, channels [c_base, c_base + NC), and
// blocks NH r .. NH r + NH - 1 share row r.
// HALO (BW >= 64, BW + 2d <= 256): a K step is (ty, CB channels) and its A
// box spans BW + 2d columns, so the three taps of a row of the stencil
// read one box at row offsets (1 - tx) d: a descriptor may start on any
// row, since wgmma swizzles by the absolute shared-memory address as TMA
// does (base offset 0). Else a K step is (tap, CB channels). Dynamic
// shared memory: `stages` stages of stage bytes (the A room, a_bytes with
// HALO, and the taps' wT rows), then at C >= 64 the f32 scratch of the
// epilogue.
template <typename T, int C, int HALO>
__global__ void __launch_bounds__(DgShape<C>::THREADS, 1)
tma_dgrad_kernel(const __grid_constant__ CUtensorMap map_g, const __grid_constant__ CUtensorMap map_w,
                 const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ a,
                 const float* __restrict__ b, const float* __restrict__ mean,
                 const float* __restrict__ invstd, T* __restrict__ dx,
                 __nv_bfloat16* __restrict__ zb, float* __restrict__ part, Geo geo, int d,
                 int act, int a_bytes, int stages) {
  using S = DgShape<C>;
  constexpr int NC = S::NC, NH = S::NH, KC = S::KC;
  constexpr int TAPS = HALO ? 3 : 1;                 // taps a K step
  constexpr int KSTEPS = (9 / TAPS) * KC;
  const int a_room = HALO ? a_bytes : S::A;
  const int stage_bytes = a_room + TAPS * S::NB * S::B_REGION;
  // what TMA brings a stage: the A box (without the room's rounding) and
  // the taps' wT rows
  const int stage_tx = (HALO ? ((1 << geo.bw_log2) + 2 * d) * geo.bh * S::SW : S::A) +
                       TAPS * S::NB * S::B_REGION;
  extern __shared__ unsigned char dsmem[];
  unsigned char* smem = align1024(dsmem);
  float* scr = reinterpret_cast<float*>(smem + stages * stage_bytes);
  __shared__ __align__(8) uint64_t full[4], empty[4];
  __shared__ float sa[NC], sb[NC], smu[NC], sinv[NC];
  __shared__ float red[S::WARPS][3][NC];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c_base = (blockIdx.x % NH) * NC;
  const long long items = geo.tiles * NH;
  for (int i = tid; i < NC; i += S::THREADS) {
    sa[i] = a[c_base + i];
    sb[i] = b[c_base + i];
    smu[i] = mean[c_base + i];
    sinv[i] = invstd[c_base + i];
  }
  for (int i = tid; i < S::WARPS * 3 * NC; i += S::THREADS) (&red[0][0][0])[i] = 0.0f;
  if (tid == 0) ring_init(full, empty, stages, S::WARPS);
  __syncthreads();

  if (warp == S::WARPS) {
    // producer: K step ks of an item = (tap, channels kc*CB of g): the box
    // of gb at (h0 - ty*d, w0 - tx*d) and rows kc*CB.. of wT[tap], columns
    // c_base..; with HALO (ty, kc): one box from column w0 - d and the
    // three taps' wT
    if (lane == 0) {
      int gs = 0;
      for (long long t = blockIdx.x; t < items; t += gridDim.x) {
        int n, h0, w0;
        tile_origin(geo, t / NH, n, h0, w0);
        for (int ks = 0; ks < KSTEPS; ++ks, ++gs) {
          const int s = gs % stages;
          ring_acquire(full, empty, s, gs / stages, stage_tx);
          unsigned char* st = smem + s * stage_bytes;
          const int step = ks / KC, kc = ks - step * KC;
          if (HALO) {
            sm90::tma_load_4d(st, &map_g, &full[s], kc * S::CB, w0 - d, h0 - (step - 1) * d, n);
            for (int tx = 0; tx < 3; ++tx)
#pragma unroll
              for (int nb = 0; nb < S::NB; ++nb)
                sm90::tma_load_3d(st + a_room + (tx * S::NB + nb) * S::B_REGION, &map_w,
                                  &full[s], c_base + nb * S::CB, kc * S::CB, step * 3 + tx);
          } else {
            const int ty = step / 3 - 1, tx = step % 3 - 1;
            sm90::tma_load_4d(st, &map_g, &full[s], kc * S::CB, w0 - tx * d, h0 - ty * d, n);
#pragma unroll
            for (int nb = 0; nb < S::NB; ++nb)
              sm90::tma_load_3d(st + a_room + nb * S::B_REGION, &map_w, &full[s],
                                c_base + nb * S::CB, kc * S::CB, step);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg takes pixels [64 wg, 64 wg + 64) of a tile;
  // with HALO their first row in the box for tx = 1
  const int wg = warp >> 2;
  const int bw = 1 << geo.bw_log2;
  const int hrow = ((wg * 64) >> geo.bw_log2) * (bw + 2 * d) + ((wg * 64) & (bw - 1));
  const int cq = 2 * (lane & 3);
  int gs = 0;
  for (long long t = blockIdx.x; t < items; t += gridDim.x) {
    int n, h0, w0;
    tile_origin(geo, t / NH, n, h0, w0);
    float acc[NC / 2];
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc[i] = 0.0f;
    for (int ks = 0; ks < KSTEPS; ++ks, ++gs) {
      const int s = gs % stages;
      sm90::mbar_wait(&full[s], (gs / stages) & 1);
      const unsigned char* st = smem + s * stage_bytes;
      const unsigned char* Bs = st + a_room;
      sm90::wgmma_fence();
      if (HALO) {
#pragma unroll
        for (int tx = 0; tx < 3; ++tx) {
          // tap (ty, tx - 1) reads box rows from hrow + (2 - tx) d
          const unsigned char* As = st + (hrow + (2 - tx) * d) * S::SW;
#pragma unroll
          for (int k = 0; k < S::CB / 16; ++k) {
            const uint64_t da = sm90::desc(As + k * 32, 16, 8 * S::SW, S::LAYOUT);
            const uint64_t db = sm90::desc(Bs + tx * S::NB * S::B_REGION + k * 16 * S::SW,
                                           S::B_REGION, 8 * S::SW, S::LAYOUT);
            sm90::wgmma<NC, 0, 1>(acc, da, db);
          }
        }
      } else {
        const unsigned char* As = st + wg * 64 * S::SW;
#pragma unroll
        for (int k = 0; k < S::CB / 16; ++k) {
          const uint64_t da = sm90::desc(As + k * 32, 16, 8 * S::SW, S::LAYOUT);
          const uint64_t db = sm90::desc(Bs + k * 16 * S::SW, S::B_REGION, 8 * S::SW, S::LAYOUT);
          sm90::wgmma<NC, 0, 1>(acc, da, db);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      if (ks > 0 && lane == 0) sm90::mbar_arrive(&empty[(gs - 1) % stages]);
    }
    sm90::wgmma_wait<0>();
    if (lane == 0) sm90::mbar_arrive(&empty[(gs - 1) % stages]);

    if constexpr (C == 32) {
      // epilogue from the accumulators (at C = 32 the scratch path's
      // registers would cost resident blocks; NC = C, one part): this
      // thread's rows r and r + 8 of the warpgroup's 64, channels 8j + cq +
      // {0, 1}
      const int r0 = wg * 64 + (warp & 3) * 16 + (lane >> 2);
      long long pix[2];
      bool ok[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + 8 * hh;
        const int h = h0 + (r >> geo.bw_log2), w = w0 + (r & (bw - 1));
        ok[hh] = h < geo.H && w < geo.W;
        pix[hh] = ((long long)n * geo.H + h) * geo.W + w;
      }
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        const int c = 8 * j + cq;
        float s1[2] = {0.0f, 0.0f}, s2[2] = {0.0f, 0.0f}, sg[2] = {0.0f, 0.0f};
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          if (!ok[hh]) continue;
          const long long off = pix[hh] * C + c;
          const float2 xv = Io2<T>::load(x + off);
          const float2 gv = Io2<T>::load(g + off);
          const float xs[2] = {xv.x, xv.y}, gs2[2] = {gv.x, gv.y};
          float out[2], zv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float zp = __fmaf_rn(xs[e], sa[c + e], sb[c + e]);
            float dzp = acc[4 * j + 2 * hh + e];
            if (act && !(zp > 0.0f)) dzp = 0.0f;
            out[e] = dzp * sa[c + e];
            zv[e] = act ? fmaxf(zp, 0.0f) : zp;
            const float xhat = __fmul_rn(__fsub_rn(xs[e], smu[c + e]), sinv[c + e]);
            s1[e] += dzp;
            s2[e] += dzp * xhat;
            sg[e] += gs2[e];
          }
          Io2<T>::store(dx + off, out[0], out[1]);
          Io2<__nv_bfloat16>::store(zb + off, zv[0], zv[1]);
        }
        // over the 8 lanes that share cq (lane bits 2-4), in a fixed tree
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], o);
            s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], o);
            sg[e] += __shfl_xor_sync(0xffffffffu, sg[e], o);
          }
        }
        if (lane < 4) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            red[warp][0][c + e] += s1[e];
            red[warp][1][c + e] += s2[e];
            red[warp][2][c + e] += sg[e];
          }
        }
      }
    } else {
      // epilogue through shared memory: dz to an f32 tile (pixels x NC),
      // then each thread takes 8 channels of a pixel (16- or 32-byte
      // loads and stores); the first barrier: the last item's reads of
      // the scratch are done
      consumers_sync<S::CONSUMERS>();
      const int r0 = wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
      for (int j = 0; j < NC / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(&scr[(r0 + 8 * hh) * S::SCR_LD + 8 * j + cq]) =
              make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
      consumers_sync<S::CONSUMERS>();
      constexpr int CPR = NC / 8;               // 8-channel chunks a pixel
      constexpr int RPP = S::CONSUMERS / CPR;   // pixels a pass
      const int c8 = (tid % CPR) * 8;
      float s1[8], s2[8], sg[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) s1[e] = s2[e] = sg[e] = 0.0f;
      for (int r = tid / CPR; r < S::PIX; r += RPP) {
        const int h = h0 + (r >> geo.bw_log2), w = w0 + (r & (bw - 1));
        if (h >= geo.H || w >= geo.W) continue;
        const long long off = (((long long)n * geo.H + h) * geo.W + w) * C + c_base + c8;
        float xv[8], gv[8], out[8], zv[8];
        Io<T>::load8(x + off, xv);
        Io<T>::load8(g + off, gv);
        const float4 lo = *reinterpret_cast<const float4*>(&scr[r * S::SCR_LD + c8]);
        const float4 hi = *reinterpret_cast<const float4*>(&scr[r * S::SCR_LD + c8 + 4]);
        const float dz[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int c = c8 + e;
          const float zp = __fmaf_rn(xv[e], sa[c], sb[c]);
          float dzp = dz[e];
          if (act && !(zp > 0.0f)) dzp = 0.0f;
          out[e] = dzp * sa[c];
          zv[e] = act ? fmaxf(zp, 0.0f) : zp;
          const float xhat = __fmul_rn(__fsub_rn(xv[e], smu[c]), sinv[c]);
          s1[e] += dzp;
          s2[e] += dzp * xhat;
          sg[e] += gv[e];
        }
        Io<T>::store8(dx + off, out);
        Io<__nv_bfloat16>::store8(zb + off, zv);
      }
      // over the lanes that share c8 (lane bits log2(CPR)..4), in a fixed
      // tree
#pragma unroll
      for (int o = CPR; o < 32; o <<= 1) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], o);
          s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], o);
          sg[e] += __shfl_xor_sync(0xffffffffu, sg[e], o);
        }
      }
      if (lane < CPR) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          red[warp][0][c8 + e] += s1[e];
          red[warp][1][c8 + e] += s2[e];
          red[warp][2][c8 + e] += sg[e];
        }
      }
    }
  }
  consumers_sync<S::CONSUMERS>();
  float* row = part + (long long)(blockIdx.x / NH) * 3 * C + c_base;
  for (int i = tid; i < 3 * NC; i += S::CONSUMERS) {
    const int k = i / NC, c = i % NC;
    float t = red[0][k][c];
#pragma unroll
    for (int w = 1; w < S::WARPS; ++w) t += red[w][k][c];
    row[k * C + c] = t;
  }
}

// The tap and first input channel of rows [32 q, 32 q + 32) (C = 32) or
// of all 64 rows (q = 0) of M tile mt. Group g of the grid's y holds M
// tiles 3g..3g+2 at C >= 64: the three taps of stencil row g / (C / 64)
// at the 64 channels from 64 (g % (C / 64)), one quarter of them at C =
// 256. Tap 9 (the pair of tap 8 at C = 32) does not exist.
template <int C>
__device__ __forceinline__ void mtile_tap(int mt, int q, int& tap, int& c0) {
  if constexpr (C == 32) {
    tap = 2 * mt + q;
    c0 = 0;
  } else {
    constexpr int Q = C / 64;  // 64-channel blocks across C
    const int grp = mt / 3;
    tap = (grp / Q) * 3 + mt % 3;
    c0 = (grp % Q) * 64;
  }
}

// HALO (BW = 64, 64 + 2d <= 256): zb comes as one box per stencil row ty
// the block needs (three at C = 32, one at C >= 64), 64 + 2d columns wide
// from column w0 - d; tap (ty, tx) starts its descriptor (1 + tx) d rows
// into it. At C = 32 the two taps of an M tile sit one LBO apart, the
// lower address first. Else each warpgroup gets its taps' shifted boxes.
// blockIdx.y = N part x GROUPS + group: the part's NC output channels of
// gb, from o_base. Dynamic shared memory: `stages` stages of stage_bytes:
// gb's boxes, then the zb room (h_room a halo box).
template <int C, int HALO>
__global__ void __launch_bounds__(WgShape<C>::THREADS, 1)
tma_wgrad_kernel(const __grid_constant__ CUtensorMap map_z, const __grid_constant__ CUtensorMap map_g,
                 float* __restrict__ part, Geo geo, int d, int tiles_per_chunk, int stages,
                 int h_room) {
  using S = WgShape<C>;
  constexpr int NWG = S::NWG, NC = S::NC;
  constexpr int HB = C == 32 ? 3 : 1;   // halo boxes a stage
  const int group = blockIdx.y % S::GROUPS;
  const int o_base = (blockIdx.y / S::GROUPS) * NC;
  extern __shared__ unsigned char dsmem[];
  unsigned char* smem = align1024(dsmem);
  __shared__ __align__(8) uint64_t full[4], empty[4];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int stage_bytes = S::NB * S::REGION + (HALO ? HB * h_room : NWG * S::A);
  const int h_rows = S::PIX + 2 * d;
  const long long t_begin = (long long)blockIdx.x * tiles_per_chunk;
  long long t_end = t_begin + tiles_per_chunk;
  if (t_end > geo.tiles) t_end = geo.tiles;
  const int steps = (int)(t_end - t_begin);
  if (tid == 0) ring_init(full, empty, stages, S::WARPS);
  __syncthreads();

  if (warp == S::WARPS) {
    // producer: per tile, gb's boxes (the part's NC) and the zb boxes; without
    // HALO a warpgroup past the last M tile repeats the last (and stores
    // nothing) and tap 9 is not loaded
    if (lane == 0) {
      uint32_t bytes = S::NB * S::REGION;
      if (HALO) {
        bytes += HB * h_rows * S::SW;
      } else {
        for (int wg = 0; wg < NWG; ++wg)
          for (int q = 0; q < (C == 32 ? 2 : 1); ++q) {
            int tap, c0;
            mtile_tap<C>(min(group * NWG + wg, S::MTILES - 1), q, tap, c0);
            if (tap <= 8) bytes += S::REGION;
          }
      }
      for (int i = 0; i < steps; ++i) {
        const int s = i % stages;
        ring_acquire(full, empty, s, i / stages, bytes);
        unsigned char* st = smem + s * stage_bytes;
        unsigned char* za = st + S::NB * S::REGION;
        int n, h0, w0;
        tile_origin(geo, t_begin + i, n, h0, w0);
#pragma unroll
        for (int nb = 0; nb < S::NB; ++nb)
          sm90::tma_load_4d(st + nb * S::REGION, &map_g, &full[s], o_base + nb * S::CB, w0, h0,
                            n);
        if (HALO) {
          for (int hb = 0; hb < HB; ++hb) {
            int tap, c0;  // the first tap of the block's row (C >= 64), or row hb
            mtile_tap<C>(group * NWG, 0, tap, c0);
            const int ty = (C == 32 ? hb : tap / 3) - 1;
            sm90::tma_load_4d(za + hb * h_room, &map_z, &full[s], c0, w0 - d, h0 + ty * d, n);
          }
        } else {
#pragma unroll
          for (int wg = 0; wg < NWG; ++wg) {
            const int mt = min(group * NWG + wg, S::MTILES - 1);
#pragma unroll
            for (int q = 0; q < (C == 32 ? 2 : 1); ++q) {
              int tap, c0;
              mtile_tap<C>(mt, q, tap, c0);
              if (tap > 8) continue;
              const int ty = tap / 3 - 1, tx = tap % 3 - 1;
              sm90::tma_load_4d(za + wg * S::A + q * S::REGION, &map_z, &full[s], c0,
                                w0 + tx * d, h0 + ty * d, n);
            }
          }
        }
      }
    }
    return;
  }

  // this warpgroup's M tile: the offset of its A operand in a stage, the
  // LBO between its two 32-row halves (C = 32) and the tap of each half
  const int wg = warp >> 2;
  const int mt_raw = group * NWG + wg;
  const int mt = min(mt_raw, S::MTILES - 1);
  int a_off, lbo, half_tap[2];
  {
    int t0, t1, c0;
    mtile_tap<C>(mt, 0, t0, c0);
    mtile_tap<C>(mt, 1, t1, c0);
    if (!HALO) {
      a_off = wg * S::A;
      lbo = S::REGION;
      half_tap[0] = t0;
      half_tap[1] = t1;
    } else {
      // tap t's rows start (1 + tx) d into the box of its row
      auto start = [&](int t) {
        return (C == 32 ? (t / 3) * h_room : 0) + (t % 3) * d * S::SW;
      };
      const int s0 = start(t0);
      const int s1 = (C == 32 && t1 <= 8) ? start(t1) : s0;
      a_off = s0 < s1 ? s0 : s1;
      lbo = s0 < s1 ? s1 - s0 : s0 - s1;
      half_tap[0] = s0 <= s1 ? t0 : t1;
      half_tap[1] = s0 <= s1 ? t1 : t0;
    }
  }
  float acc[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[i] = 0.0f;
  for (int i = 0; i < steps; ++i) {
    const int s = i % stages;
    sm90::mbar_wait(&full[s], (i / stages) & 1);
    const unsigned char* st = smem + s * stage_bytes;
    const unsigned char* Bs = st;
    const unsigned char* As = st + S::NB * S::REGION + a_off;
    sm90::wgmma_fence();
#pragma unroll
    for (int k = 0; k < S::PIX / 16; ++k) {
      const uint64_t da = sm90::desc(As + k * 16 * S::SW, lbo, 8 * S::SW, S::LAYOUT);
      const uint64_t db = sm90::desc(Bs + k * 16 * S::SW, S::REGION, 8 * S::SW, S::LAYOUT);
      sm90::wgmma<NC, 1, 1>(acc, da, db);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    if (i > 0 && lane == 0) sm90::mbar_arrive(&empty[(i - 1) % stages]);
  }
  sm90::wgmma_wait<0>();

  // this warpgroup's tile of the chunk's partial dW: rows r, r + 8 (of 64),
  // columns o = o_base + 8j + cq + {0, 1}
  if (mt_raw >= S::MTILES) return;
  const int cq = 2 * (lane & 3);
  float* out = part + (long long)blockIdx.x * 9 * C * C;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = (warp & 3) * 16 + (lane >> 2) + 8 * hh;
    int tap, c0;
    mtile_tap<C>(mt, 0, tap, c0);
    if (C == 32) tap = half_tap[r >> 5];
    if (tap > 8) continue;
    const int c = c0 + (C == 32 ? (r & 31) : r);
    float* row = out + ((long long)tap * C + c) * C + o_base;
#pragma unroll
    for (int j = 0; j < NC / 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j + cq) =
          make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
  }
}

// ------------------------------------------------------------ host side

constexpr int SMEM_LIMIT = 211 * 1024;  // 227 KB less the static shared memory

struct Plan {
  Geo dg, wg;             // the two kernels' pixel tilings
  long long per, chunks;  // wgrad: tiles a chunk, chunks
};

// wgrad's chunks: two waves of blocks at C <= 128; one at C = 256, where
// a chunk's dW partial (9 C^2 floats, 2.36 MB) is written and summed once
template <int C>
Plan make_plan(int N, int H, int W) {
  using S = WgShape<C>;
  Plan p;
  p.dg = make_geo(N, H, W, 128);
  p.wg = make_geo(N, H, W, S::PIX);
  const long long target = S::NH > 1 ? SMS / S::YS : (WG_TARGET_BLOCKS + S::YS - 1) / S::YS;
  p.per = (p.wg.tiles + target - 1) / target;
  p.chunks = (p.wg.tiles + p.per - 1) / p.per;
  return p;
}

// The workspace in floats: zb (N, H, W, C) bf16, then the [S1, S2, dc]
// partials (a row per dgrad block, fewer than the tiles), then the
// per-chunk dW partials.
template <int C>
long long tma_workspace(int N, int H, int W) {
  const Plan p = make_plan<C>(N, H, W);
  return (long long)N * H * W * C / 2 + p.dg.tiles * 3 * C + p.chunks * 9LL * C * C;
}

// dgrad's dynamic shared memory: the ring (stage = the A room + the taps'
// wT rows) and, at C >= 64, the epilogue's scratch
template <int C>
int dgrad_smem(int stages, int halo, int a_bytes) {
  using S = DgShape<C>;
  const int stage = (halo ? a_bytes : S::A) + (halo ? 3 : 1) * S::NB * S::B_REGION;
  return stages * stage + (C == 32 ? 0 : S::SCRATCH) + 1024;
}

// Launches dgrad, one wave of resident blocks, a multiple of the N parts;
// *rows = its rows of S1/S2/dc partials (blocks / parts).
template <typename T, int C, int HALO>
cudaError_t launch_dgrad(const CUtensorMap& map_g, const CUtensorMap& map_w, const void* x,
                         const void* g, const float* a, const float* b, const float* mean,
                         const float* invstd, void* dx, __nv_bfloat16* zb, float* part,
                         const Geo& geo, int d, int act, int a_bytes, int stages,
                         long long* rows, cudaStream_t stream) {
  using S = DgShape<C>;
  auto kernel = tma_dgrad_kernel<T, C, HALO>;
  const int smem = dgrad_smem<C>(stages, HALO, a_bytes);
  long long grid = 0;
  cudaError_t err = sm90::wave_blocks(kernel, S::THREADS, smem, SMEM_LIMIT, &grid);
  if (err != cudaSuccess) return err;
  if (grid > geo.tiles * S::NH) grid = geo.tiles * S::NH;
  grid -= grid % S::NH;  // at least NH: a wave holds more blocks
  *rows = grid / S::NH;
  kernel<<<(unsigned)grid, S::THREADS, smem, stream>>>(
      map_g, map_w, static_cast<const T*>(x), static_cast<const T*>(g), a, b, mean, invstd,
      static_cast<T*>(dx), zb, part, geo, d, act, a_bytes, stages);
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t launch_tma(const void* x, const void* g, const float* a, const float* b,
                       const float* mean, const float* invstd, const __nv_bfloat16* wT,
                       void* dx, float* dw, float* vec, float* work, int N, int H, int W,
                       int d, int act, int* launched, cudaStream_t stream) {
  constexpr int CB = C < 64 ? 32 : 64;
  using WS = WgShape<C>;
  const Plan p = make_plan<C>(N, H, W);
  __nv_bfloat16* zb = reinterpret_cast<__nv_bfloat16*>(work);
  float* vec_part = work + (long long)N * H * W * C / 2;  // [dgrad rows][3][C]
  float* dw_part = vec_part + p.dg.tiles * 3 * C;          // [chunks][9][C][C]
  // TMA reads bf16: g itself, or bf16(g) the caller put past the workspace
  const void* gb = sizeof(T) == 2 ? g : static_cast<const void*>(work + tma_workspace<C>(N, H, W));

  // dgrad: the halo box where a warpgroup's 64 pixels lie in one image row
  // and the box fits TMA's 256 columns and the shared memory
  const int bw = 1 << p.dg.bw_log2;
  int halo = bw >= 64 && bw + 2 * d <= 256;
  const int a_bytes = halo ? ((bw + 2 * d) * p.dg.bh * CB * 2 + 1023) / 1024 * 1024 : 0;
  if (dgrad_smem<C>(2, halo, a_bytes) > SMEM_LIMIT) halo = 0;
  int stages = 4;
  while (stages > 2 && dgrad_smem<C>(stages, halo, a_bytes) > SMEM_LIMIT) --stages;

  // wgrad: the halo boxes where its tile is 1 x 64 pixels and a box fits
  const int wbw = 1 << p.wg.bw_log2;
  const int h_room = ((WS::PIX + 2 * d) * CB * 2 + 1023) / 1024 * 1024;
  int whalo = wbw == WS::PIX && WS::PIX + 2 * d <= 256;
  auto wg_stage = [&](int halo_on) {
    return WS::NB * WS::REGION + (halo_on ? (C == 32 ? 3 : 1) * h_room : WS::NWG * WS::A);
  };
  if (2 * wg_stage(whalo) + 1024 > SMEM_LIMIT) whalo = 0;
  int wstages = 4;
  while (wstages > 2 && wstages * wg_stage(whalo) + 1024 > 200 * 1024) --wstages;

  CUtensorMap map_gd, map_gw, map_z, map_w;
  const cuuint64_t wdims[3] = {(cuuint64_t)C, (cuuint64_t)C, 9};
  const cuuint64_t wstrides[2] = {(cuuint64_t)C * 2, (cuuint64_t)C * C * 2};
  const cuuint32_t wbox[3] = {(cuuint32_t)CB, (cuuint32_t)CB, 1};
  if (!act_map(&map_gd, gb, p.dg, C, CB, halo ? bw + 2 * d : bw, CB * 2) ||
      !act_map(&map_gw, gb, p.wg, C, CB, wbw, CB * 2) ||
      !act_map(&map_z, zb, p.wg, C, CB, whalo ? WS::PIX + 2 * d : wbw, CB * 2) ||
      !sm90::make_map(&map_w, wT, 3, wdims, wstrides, wbox, CB * 2))
    return cudaErrorNotSupported;

  long long vec_rows = 0;
  cudaError_t err =
      halo ? launch_dgrad<T, C, 1>(map_gd, map_w, x, g, a, b, mean, invstd, dx, zb, vec_part,
                                   p.dg, d, act, a_bytes, stages, &vec_rows, stream)
           : launch_dgrad<T, C, 0>(map_gd, map_w, x, g, a, b, mean, invstd, dx, zb, vec_part,
                                   p.dg, d, act, a_bytes, stages, &vec_rows, stream);
  if (err != cudaSuccess) return err;
  ++*launched;
  auto wkernel = whalo ? tma_wgrad_kernel<C, 1> : tma_wgrad_kernel<C, 0>;
  const int wsmem = wstages * wg_stage(whalo) + 1024;
  static int wg_attr_dev[2] = {-1, -1};  // the attribute, once a kernel and device
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (wg_attr_dev[whalo] != dev) {
    err = cudaFuncSetAttribute(wkernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return err;
    wg_attr_dev[whalo] = dev;
  }
  wkernel<<<dim3((unsigned)p.chunks, WS::YS), WS::THREADS, wsmem, stream>>>(
      map_z, map_gw, dw_part, p.wg, d, (int)p.per, wstages, h_room);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launched;
  const dim3 rblock(32, 32);
  reduce_rows<<<(3 * C + 31) / 32, rblock, 0, stream>>>(vec_part, vec_rows, 3 * C, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launched;
  // dW's partials: a float4 column a thread where the columns fill the
  // card (C >= 128), else reduce_rows' 32 x 32 blocks (more threads a
  // column over the chunks' rows)
  if (9 * C * C / 4 >= SMS * 256)
    reduce_cols<<<(9 * C * C / 4 + 255) / 256, 256, 0, stream>>>(
        reinterpret_cast<const float4*>(dw_part), p.chunks, 9 * C * C / 4,
        reinterpret_cast<float4*>(dw));
  else
    reduce_rows<<<(9 * C * C + 31) / 32, rblock, 0, stream>>>(dw_part, p.chunks, 9 * C * C, dw);
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
      return launch_tma<T, 32>(x, g, a, b, mean, invstd, wT, dx, dw, vec, work, N, H, W, d,
                               act, launched, s);
    case 64:
      return launch_tma<T, 64>(x, g, a, b, mean, invstd, wT, dx, dw, vec, work, N, H, W, d,
                               act, launched, s);
    case 128:
      return launch_tma<T, 128>(x, g, a, b, mean, invstd, wT, dx, dw, vec, work, N, H, W, d,
                                act, launched, s);
    case 256:
      return launch_tma<T, 256>(x, g, a, b, mean, invstd, wT, dx, dw, vec, work, N, H, W, d,
                                act, launched, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Floats of device workspace convseg_backward needs for this shape (with
// f32 inputs the caller appends N*H*W*C/2 floats holding bf16(g), (N, H,
// W, C)); 0 for a channel count it does not take.
extern "C" long long convseg_backward_workspace(int N, int H, int W, int C) {
  if (N <= 0 || H <= 0 || W <= 0) return 0;
  if (C == 32) return tma_workspace<32>(N, H, W);
  if (C == 64) return tma_workspace<64>(N, H, W);
  if (C == 128) return tma_workspace<128>(N, H, W);
  if (C == 256) return tma_workspace<256>(N, H, W);
  return 0;
}

// x, g, dx: (N, H, W, C) contiguous, bf16 (x_is_bf16 = 1) or f32, 16-byte
// aligned; a, b, mean, invstd: (C,) f32; wT: (3, 3, C, C) bf16 with
// wT[t][o][c] = w[t][c][o]; dw: (3, 3, C, C) f32 HWIO; vec: (3, C) f32 =
// [S1, S2, dc]; work: convseg_backward_workspace(N, H, W, C) floats, 16-byte
// aligned, followed with f32 inputs by bf16(g) (N, H, W, C).
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
