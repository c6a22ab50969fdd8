// Hopper (sm_90a) building blocks for hand-written kernels: mbarriers, TMA
// tensor-map loads, wgmma shared-memory descriptors and the bf16 wgmma
// products with an f32 accumulator, as PTX. Host side: the tensor-map
// encoder taken from the CUDA driver API through the runtime (no libcuda
// link).
//
// Shared-memory layouts (bf16, the canonical wgmma layouts; a 16-byte chunk
// is T = 8 elements):
// * K-major, swizzle S in {64, 128} bytes: rows of S bytes (S/2 elements of
//   K) for each row of M (or N); 8 rows form one swizzle atom of 8*S bytes;
//   SBO = 8*S (the next 8 rows), LBO unused; a step of 16 in K adds 32
//   bytes to the start address.
// * MN-major, swizzle S: rows of S bytes (S/2 elements of M or N) for each
//   element of K; 8 rows of K form one atom; SBO = 8*S (the next 8 rows of
//   K), LBO = the distance to the next S/2 elements of M or N; a step of
//   16 in K adds 16*S bytes.
// A TMA box whose innermost extent is S bytes, loaded with the same
// swizzle into an 8*S-aligned buffer, lands in exactly these layouts;
// threads that write such a buffer themselves put the 16-byte chunk at
// byte offset o (from a 1024-aligned base) at swizzle(o) below.
//
// Also the pieces the pipelined convolution kernels (K1 in convseg.cu, K2
// in convseg_bwd.cu) share: the pixel tiling (Geo), the producer/consumer
// ring of stages, and the tensor maps over NHWC activations.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed (a fresh barrier
// counts its phase of parity 1 as complete). A wait that has not ended
// after two seconds (a stage takes microseconds) traps, so a broken
// pipeline fails its launch instead of holding the card.
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0, polls = 0;
  uint64_t since = 0;
  do {
    if ((++polls & 0xFFFF) == 0) {
      const uint64_t now = global_ns();
      if (since == 0) since = now;
      else if (now - since > 2000000000ull) __trap();
    }
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Orders this thread's generic-proxy writes to shared memory (st.shared)
// before async-proxy reads of them (wgmma, TMA), once a barrier has joined
// the writers and the readers.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The byte offset of the 16-byte chunk at offset o of a buffer swizzled by
// S = 32, 64 or 128 bytes: chunk bits 4..(log2 S - 1) XOR address bits
// 7.., as TMA writes and wgmma reads it.
template <int S>
__device__ __forceinline__ uint32_t swizzle(uint32_t o) {
  static_assert(S == 32 || S == 64 || S == 128, "swizzle span");
  return o ^ ((o >> 3) & (S == 128 ? 0x70u : (S == 64 ? 0x30u : 0x10u)));
}

// ------------------------------------------------------------------ TMA

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}

// ---------------------------------------------------------------- wgmma

// layout: 1 = 128-byte swizzle, 2 = 64-byte, 3 = 32-byte. The base offset
// (bits 49-51) stays 0: the swizzle follows the absolute shared-memory
// address, as TMA's does, so a matrix may start on any 16-byte row of an
// atom that TMA filled.
__device__ __forceinline__ uint64_t desc(const void* smem, uint32_t lbo_bytes,
                                         uint32_t sbo_bytes, uint32_t layout) {
  uint64_t d = (uint64_t)((smem_u32(smem) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)layout << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D[64 x N] += A[64 x 16] B[16 x N] in bf16 with f32 D, A and B in shared
// memory through their descriptors; TA / TB = 1 for an MN-major operand.
// D's layout: thread t of the warpgroup holds, for each 8 columns j,
// d[4j + {0, 1}] at row 16*(t/32) + (t%32)/4, columns 8j + 2*(t%4) + {0, 1},
// and d[4j + {2, 3}] 8 rows below.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n8(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, %7, %8;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n16(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n32(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma(float* d, uint64_t da, uint64_t db) {
  static_assert(N == 8 || N == 16 || N == 32 || N == 64 || N == 128, "wgmma width");
  if constexpr (N == 8) wgmma_n8<TA, TB>(d, da, db);
  else if constexpr (N == 16) wgmma_n16<TA, TB>(d, da, db);
  else if constexpr (N == 32) wgmma_n32<TA, TB>(d, da, db);
  else if constexpr (N == 64) wgmma_n64<TA, TB>(d, da, db);
  else wgmma_n128<TA, TB>(d, da, db);
}

// ----------------------------------------------------------- host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA driver API, through the runtime; null
// if the installed CUDA driver does not give it.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tiled map of `rank` dimensions of `dtype` (dims and box innermost
// first, strides in bytes of dims 1..rank-1), zero fill outside the
// tensor, swizzle 32, 64 or 128 bytes, or none (0) for a box that threads
// read. Returns false if it cannot be encoded.
inline bool make_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                     const cuuint64_t* strides, const cuuint32_t* box, int swizzle_bytes,
                     CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUtensorMapSwizzle sw = swizzle_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : swizzle_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                : swizzle_bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                      : CU_TENSOR_MAP_SWIZZLE_NONE;
  return fn(map, dtype, (cuuint32_t)rank, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The blocks of `kernel` (`threads` a block, `smem` bytes of dynamic shared
// memory) that the current device holds at once: its multiprocessors times
// the blocks each holds (at least one), the grid of a persistent kernel.
// On first use for a kernel, device and size it raises the kernel's dynamic
// shared-memory ceiling to `smem_limit` and queries the occupancy; then the
// answer is cached (the host's cost counts in every call), a few slots,
// since the size follows the dilation.
template <typename Kernel>
inline cudaError_t wave_blocks(Kernel kernel, int threads, int smem, int smem_limit,
                               long long* blocks) {
  struct Seen {
    const void* fn;
    int dev, smem;
    long long blocks;
  };
  static Seen seen[16] = {};
  static int next = 0;
  const void* fn = reinterpret_cast<const void*>(kernel);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (const Seen& e : seen)
    if (e.fn == fn && e.dev == dev && e.smem == smem) {
      *blocks = e.blocks;
      return cudaSuccess;
    }
  int sms = 0, per_sm = 0;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem_limit)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
          cudaSuccess)
    return err;
  *blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  seen[next] = {fn, dev, smem, *blocks};
  next = (next + 1) % 16;
  return cudaSuccess;
}

// ------------------------------------------------ pixel tiles and rings

// The pixel tiling of an image for tiles of `pix` pixels: BW = the power
// of two >= W up to pix, BH = pix / BW.
struct Geo {
  int N, H, W, bw_log2, bh, tiles_w, tiles_h;
  long long tiles;
};

inline Geo make_geo(int N, int H, int W, int pix) {
  Geo g;
  g.N = N;
  g.H = H;
  g.W = W;
  g.bw_log2 = 0;
  while ((1 << g.bw_log2) < W && (2 << g.bw_log2) <= pix) ++g.bw_log2;
  g.bh = pix >> g.bw_log2;
  g.tiles_w = (W + (1 << g.bw_log2) - 1) >> g.bw_log2;
  g.tiles_h = (H + g.bh - 1) / g.bh;
  g.tiles = (long long)N * g.tiles_h * g.tiles_w;
  return g;
}

// tile -> (image, first row, first column)
__device__ __forceinline__ void tile_origin(const Geo& g, long long t, int& n, int& h0, int& w0) {
  const int per = g.tiles_h * g.tiles_w;
  n = (int)(t / per);
  const int r = (int)(t - (long long)n * per);
  h0 = (r / g.tiles_w) * g.bh;
  w0 = (r % g.tiles_w) << g.bw_log2;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t s = smem_u32(p);
  return p + ((1024 - (s & 1023)) & 1023);
}

// A barrier among the THREADS consumer threads (the producer warp, last
// in the block, does not take part).
template <int THREADS>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

// Producer side of a ring: wait until stage s is free for its use-th
// fill, then expect `bytes` on full[s].
__device__ __forceinline__ void ring_acquire(uint64_t* full, uint64_t* empty, int s, int use,
                                             uint32_t bytes) {
  mbar_wait(&empty[s], (use & 1) ^ 1);
  mbar_arrive_expect_tx(&full[s], bytes);
}

// One thread: the ring's barriers, `full` awaiting the producer's one
// arrival (and the bytes it expects), `empty` one arrival a consumer warp.
__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty, int stages,
                                          int consumer_warps) {
  for (int s = 0; s < stages; ++s) {
    mbar_init(&full[s], 1);
    mbar_init(&empty[s], consumer_warps);
  }
  mbar_fence_init();
}

// A map over an (N, H, W, C) activation of `dtype` (bf16 or f32), boxes of
// cb channels x box_w columns x BH rows, swizzled as make_map says.
inline bool act_map(CUtensorMap* map, const void* base, const Geo& g, int C, int cb, int box_w,
                    int swizzle_bytes,
                    CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const cuuint64_t es = dtype == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)g.W, (cuuint64_t)g.H, (cuuint64_t)g.N};
  const cuuint64_t strides[3] = {(cuuint64_t)C * es, (cuuint64_t)g.W * C * es,
                                 (cuuint64_t)g.H * g.W * C * es};
  const cuuint32_t box[4] = {(cuuint32_t)cb, (cuuint32_t)box_w, (cuuint32_t)g.bh, 1};
  return make_map(map, base, 4, dims, strides, box, swizzle_bytes, dtype);
}

}  // namespace sm90
