// The bf16 body of the ROI window pool for Hopper (sm_90a): every bf16
// launch of K1 (window_pool_multi, the 1x view over c3 + c4 + c5; replaces
// _multi_window_pool_kernel / pallas_window_pool_multi in
// multipathnet_tpu/ops/roi_pallas.py), K2 (resident_pool, the context
// views over c5; replaces _resident_pool_kernel / pallas_resident_pool) and
// K5 (window_pool: K1 at one level; replaces _window_pool_kernel /
// pallas_window_pool), with and without the int8 epilogue (_quant_view).
// roi_window_pool.cu keeps the float32 instances on the CUDA cores and
// routes every bf16 launch here; there is no other bf16 route.
//
// What it computes: the reference's GEMM, per view and 512-channel tile,
//     out (49, C) = W2 (49, L * 160) . win (L * 160, C),
//     W2[i * 7 + j][l, y, x] = bf16(wy_l[i][y] * wx_l[j][x])
// with the float32 product rounded once to bf16 (roi_pallas.py:156, :534,
// :975) and the products summed in float32: exactly what wgmma computes
// from a bf16 A and B into float32 accumulators. The L windows are stacked
// along K, so the level sum happens in the accumulators.
//
// Layout. One persistent block per SM walks the views in launch order
// (image-major), so the views in flight at one time share their image's
// pyramid rows in L2. A block is one or two consumer warpgroups (C <= 256:
// one), each owning 256 channels, and one producer warpgroup, which hands
// its registers to the consumers (setmaxnreg: 224 and 56 per thread):
//   - the producer's first thread waits for a free stage of a 2-deep
//     shared-memory ring and fills it by TMA with 5 window rows of one
//     (view, level): one box {64 channels, 16 x, 5 rows} per 64 channels,
//     128-byte swizzle, out of a tiled tensor map over the level's (rows,
//     Wmax, C) buffer. That is the MN-major B layout wgmma reads for 16-bit
//     types (a window row is one contiguous 16 * C span, but its [x][c] order
//     is not). A stage is 80 KB, a whole window 160 KB at C = 512, so the
//     ring stages by window rows; each stage ends in one wgmma wait, so
//     stages are made as large as two fit.
//   - each consumer warpgroup waits for the stage, builds A = W2 in
//     registers (one k16 step is one window row: 16 x cells; M = 49 bins
//     padded to 64 with zero rows), issues one m64n256k16 wgmma per window
//     row on the stage and frees it. K1 is 30 k-steps per view, K2 10. The
//     view's wy/wx rows (182 floats per level) are fetched into registers
//     one view ahead and staged in shared memory, double buffered.
//   - at the view's end the consumers round their accumulators to bf16 into
//     a (49, 512) tile in shared memory (stmatrix: the accumulator layout
//     is its fragment layout) and go on to the next view; the producer's
//     other three warps empty the tile meanwhile by 49 bulk copies to the
//     output rows. In quant mode the consumers store
//     _quant_view's y = relu(round(round(acc) + bias)) instead, with each
//     warp's max, and the three warps write one float32 scale per view and
//     the int8 codes (8-byte streaming stores), with the helpers of
//     roi_window_pool.cuh bit for bit. The consumers accumulate alike in
//     both modes, so the quant output is quant_view_ref of the plain
//     instance's output.
// A view whose window would fall outside its buffer is not read (TMA would
// zero-fill it silently): NaN out, or zero codes and a NaN scale.
//
// What bounds it. Not the tensor cores: the W2 GEMM is 2 * 49 * 160 FLOP
// per view, level and channel (padded to 64 rows), 0.2 ms at the main path
// at the bf16 rate. Every view reads its whole windows (160 KB per level at
// C = 512) through L2, since TMA does not cache in L1: K2's c5 pyramids sit
// in L2, and K1's overlapping c3 windows mostly do. On an H100 K1 and K2
// move 7-8 TB/s of window reads and output writes through L2 (PERF.md), so
// the L2 rate bounds them, not HBM. The quant instances add the epilogue's
// arithmetic, which shares the SMs' issue slots with the consumers; the
// consumers do the cheap half (bf16x2) and the division runs branch-free.
//
// The tensor maps are encoded on the host through the runtime's
// driver-entry-point lookup, so the library links no libcuda. TMA needs
// 16-byte global strides: the wrappers raise for C % 8 != 0 and unaligned
// pyramids.

#include <cuda.h>  // CUtensorMap and its enums; no driver symbol is linked
#include <stdint.h>

#include "roi_window_pool.cuh"

namespace mpn {
namespace {

constexpr int ROWS_PER_STAGE = 5;
constexpr int STAGES_PER_LEVEL = WIN_Y / ROWS_PER_STAGE;
constexpr int RING = 2;
constexpr int CHUNK_C = 64;                  // channels per TMA box: 128 B
constexpr int TILE_C = 512;                  // channels per work item
constexpr int CHUNKS = TILE_C / CHUNK_C;
constexpr int WG_C = 256;                    // channels per consumer group
constexpr int ROW_BYTES = WIN_X * CHUNK_C * 2;          // one window row
constexpr int CHUNK_BYTES = ROWS_PER_STAGE * ROW_BYTES;
constexpr int STAGE_BYTES = CHUNKS * CHUNK_BYTES;
constexpr int MAX_THREADS = 3 * 128;
constexpr int EPI_THREADS = 96;              // the producer group's warps 1-3
constexpr int TILE_PITCH = TILE_C + 8;       // staged row: 16 bytes of pad
constexpr int WY_FLOATS = G * WIN_Y;
constexpr int WX_FLOATS = G * WIN_X;
constexpr int W_FLOATS = WY_FLOATS + WX_FLOATS;          // per level

struct __align__(64) WgmmaParams {
  CUtensorMap map[MAX_LEVELS];
  PoolParams p;
  int n_items;   // n_views * n_tiles, item = view * n_tiles + tile
  int n_tiles;   // 512-channel tiles per view
  int n_wg;      // consumer warpgroups
};

struct Smem {
  uint8_t ring[RING][STAGE_BYTES];  // 1024-aligned: the swizzle's atoms
  // the view's pool result, bf16, for the epilogue warps; the pad puts the
  // 8 rows of an stmatrix fragment on distinct banks
  __align__(16) __nv_bfloat16 tile[G * G][TILE_PITCH];
  uint64_t full[RING];
  uint64_t empty[RING];
  float wy[2][MAX_LEVELS][WIN_Y][GP];  // [buffer][level][y][i], i = G: 0
  float wx[2][MAX_LEVELS][WIN_X][GP];  // [buffer][level][x][j], j = G: 0
  __nv_bfloat162 bias[TILE_C / 2];     // quant mode: the skip bias
  float vmax[8];                       // quant mode: each consumer warp's max
  int inside;                          // whether the staged view was read
};

constexpr int SMEM_BYTES = sizeof(Smem) + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// an L2 policy for the window reads (evict last: neighbouring views read
// the same pyramid cells) or the output stores (evict first)
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c, int x,
                                            int row, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%3, %4, %5}], [%2], %6;" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c),
      "r"(x), "r"(row), "l"(policy)
      : "memory");
}

// wgmma's shared-memory descriptor of B: a 16 (x) by 256 (channel) slice,
// MN-major with the 128-byte swizzle. Leading offset: the next 64
// channels (one TMA box, CHUNK_BYTES on); stride offset: the next 8 x rows
// (1024 B on). Both in 16-byte units.
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(CHUNK_BYTES >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// d (64 x 256, float32) += A (64 x 16, bf16 from registers) . B (16 x 256)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from touching registers that an async wgmma owns
// before its wait
__device__ __forceinline__ void own(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

__device__ __forceinline__ void own(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// named barriers (0 is __syncthreads)
constexpr int BAR_CONSUMERS = 1;   // the consumer warpgroups
constexpr int BAR_TILE_FULL = 2;   // consumers -> epilogue warps
constexpr int BAR_TILE_EMPTY = 3;  // epilogue warps -> consumers

__device__ __forceinline__ void bar_sync(int id, int n_threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n_threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n_threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n_threads) : "memory");
}

// _quant_view's y = relu(round(t + b)) of a pair t already rounded to bf16,
// in bf16x2 arithmetic: add.rn.bf16x2 rounds the exact sum of two bf16 once,
// which is what the float32 sum rounded to bf16 gives (their exact sum
// fits float32's 24 bits, or lies within 2^-16 of t or b, far from a bf16
// midpoint)
__device__ __forceinline__ __nv_bfloat162 biased_relu2(__nv_bfloat162 t,
                                                       __nv_bfloat162 b) {
  return __hmax2(__hadd2(t, b), __floats2bfloat162_rn(0.f, 0.f));
}

// the codes clip(rint(y / s), -127, 127) of eight bf16 values y >= 0 (four
// packed pairs), packed in order, in full-rate instructions and no branch:
// q + 1.5 * 2^23
// rounds q = div_rn(y, s, r) (< 2^22) to an integer, half to even, in its
// low mantissa bits, so the low byte of its bits is the code. y <= amax
// makes q <= 127.00001 (s is amax * float32(1/127), float32(1/127) <
// 1/127, floored at 1e-12), so the clip to [-127, 127] never bites here.
__device__ __forceinline__ uint2 quantize_8(uint4 v, float s, float r) {
  constexpr float MAGIC = 12582912.f;
  const uint32_t in[4] = {v.x, v.y, v.z, v.w};
  uint32_t m[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float y = __uint_as_float(k & 1 ? in[k >> 1] & 0xffff0000u
                                          : in[k >> 1] << 16);
    m[k] = __float_as_uint(__fadd_rn(div_rn(y, s, r), MAGIC));
  }
  // bytes 0 of m[0..3] and of m[4..7]
  return make_uint2(
      __byte_perm(__byte_perm(m[0], m[1], 0x0040),
                  __byte_perm(m[2], m[3], 0x0040), 0x5410),
      __byte_perm(__byte_perm(m[4], m[5], 0x0040),
                  __byte_perm(m[6], m[7], 0x0040), 0x5410));
}

// the epilogue warps: the staged tile of view n out to global memory,
// by bulk copies (bf16) or through the int8 epilogue (QUANT)
template <bool QUANT>
__device__ __forceinline__ void epilogue_warps(const WgmmaParams& w, Smem& sm,
                                               int et, int n_tile) {
  const PoolParams& p = w.p;
  const int c_all = p.channels;
  bar_arrive(BAR_TILE_EMPTY, n_tile);  // the tile starts empty
  for (int item = blockIdx.x; item < w.n_items; item += gridDim.x) {
    const int n = item / w.n_tiles;
    const int c0 = (item % w.n_tiles) * TILE_C;
    const int width = min(TILE_C, c_all - c0);
    bar_sync(BAR_TILE_FULL, n_tile);
    if constexpr (!QUANT) {
      if (et == 0) {
        __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) +
                             (size_t)n * G * G * c_all + c0;
        // the output must not push the pyramids out of L2
        const uint64_t policy = l2_evict_first();
        for (int m = 0; m < G * G; ++m)
          asm volatile(
              "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"
              " [%0], [%1], %2, %3;" ::"l"(out + (size_t)m * c_all),
              "r"(smem_u32(sm.tile[m])), "r"(width * 2), "l"(policy)
              : "memory");
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      }
    } else {
      // the tile holds _quant_view's y (the consumers added the bias):
      // the view's scale from the consumers' maxima, then the codes.
      // Thread et owns the 8-channel chunks et % 32 and et % 32 + 32 of
      // the rows et / 32, + 3, ...: 16 values a row.
      const int chunks = width / 8;
      const int cc = et & 31;
      float m = 0.f;
      for (int k = 0; k < 4 * w.n_wg; ++k) m = fmaxf(m, sm.vmax[k]);
      const bool inside = sm.inside;
      const float sc = view_scale(m);
      if (et == 0) p.scale[n] = inside ? sc : NAN;
      const float r = view_reciprocal(sc);
      signed char* out = static_cast<signed char*>(p.out) +
                         (size_t)n * G * G * c_all + c0;
      for (int row = et >> 5; row < G * G; row += EPI_THREADS / 32) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (cc + 32 * h < chunks) {
            const uint4 v = *reinterpret_cast<const uint4*>(
                &sm.tile[row][8 * (cc + 32 * h)]);
            const uint2 q = inside ? quantize_8(v, sc, r) : make_uint2(0, 0);
            __stcs(reinterpret_cast<uint2*>(out + (size_t)row * c_all +
                                            8 * (cc + 32 * h)), q);
          }
        }
      }
    }
    if (item + (int)gridDim.x < w.n_items) bar_arrive(BAR_TILE_EMPTY, n_tile);
  }
  if (!QUANT && et == 0)
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

template <int L, bool QUANT>
__global__ void __launch_bounds__(MAX_THREADS, 1)
window_pool_wgmma_kernel(const __grid_constant__ WgmmaParams w) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const PoolParams& p = w.p;
  const int tid = threadIdx.x;
  const int n_cons = w.n_wg * 128;
  const int n_tile = n_cons + EPI_THREADS;  // the tile barriers' threads

  if (tid == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 4 * w.n_wg);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  float* wzero = &sm.wy[0][0][0][0];
  for (int t = tid; t < 2 * MAX_LEVELS * (WIN_Y + WIN_X) * GP; t += blockDim.x)
    wzero[t] = 0.f;  // wy and wx are adjacent; their pads stay zero
  if (QUANT)  // C <= 512, one channel tile
    for (int t = tid; t < p.channels / 2; t += blockDim.x)
      sm.bias[t] = static_cast<const __nv_bfloat162*>(p.bias)[t];
  __syncthreads();

  if (tid >= n_cons) {
    // ---- producer warpgroup: its registers go to the consumers; warp 0's
    // first thread fills the ring by TMA, warps 1-3 run the epilogue ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;");
    if (tid >= n_cons + 32) {
      epilogue_warps<QUANT>(w, sm, tid - n_cons - 32, n_tile);
      return;
    }
    if (tid != n_cons) return;
    const uint64_t policy = l2_evict_last();
    int s = 0;
    uint32_t phase = 0;
    for (int item = blockIdx.x; item < w.n_items; item += gridDim.x) {
      const int n = item / w.n_tiles;
      const int c0 = (item % w.n_tiles) * TILE_C;
      const int nq = min(CHUNKS, (p.channels - c0 + CHUNK_C - 1) / CHUNK_C);
      const int img_row = (n / p.views_per_image) * p.rows_per_image;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const int r0 = p.row0[(size_t)l * p.n_views + n];
        const int x0 = p.x0[(size_t)l * p.n_views + n];
        const bool inside = window_inside(p, l, r0, x0);
        for (int st = 0; st < STAGES_PER_LEVEL; ++st) {
          mbar_wait(&sm.empty[s], phase ^ 1);
          if (inside) {
            mbar_expect_tx(&sm.full[s], nq * CHUNK_BYTES);
            for (int q = 0; q < nq; ++q)
              tma_load_3d(sm.ring[s] + q * CHUNK_BYTES, &w.map[l],
                          &sm.full[s], c0 + q * CHUNK_C, x0,
                          img_row + r0 + st * ROWS_PER_STAGE, policy);
          } else {
            mbar_arrive(&sm.full[s]);  // nothing read; consumers skip it
          }
          if (++s == RING) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns channels c0 + wg * 256 + [0, 256) ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;");
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  // this thread's two A rows (bins m = i * 7 + j) and four x columns
  const int m0 = warp * 16 + (lane >> 2), m1 = m0 + 8;
  const int i0 = m0 < G * G ? m0 / G : G, j0 = m0 < G * G ? m0 % G : G;
  const int i1 = m1 < G * G ? m1 / G : G, j1 = m1 < G * G ? m1 % G : G;
  const int xa = 2 * (lane & 3);
  // the tile column of accumulator pair v: cw + 8 v
  const int cw = wg * WG_C + xa;

  // one view's wy/wx rows, fetched a view ahead: thread t holds elements
  // t, t + n_cons, ... of the (L, 182) floats
  constexpr int PER_THREAD = (L * W_FLOATS + 127) / 128;
  float wreg[PER_THREAD];
  int rreg[L], xreg[L];
  auto fetch = [&](int item) {
    const int n = item / w.n_tiles;
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int e = tid + k * n_cons;
      if (e < L * WY_FLOATS) {
        const int l = e / WY_FLOATS;
        wreg[k] = p.wy[((size_t)l * p.n_views + n) * WY_FLOATS +
                       e % WY_FLOATS];
      } else if (e < L * W_FLOATS) {
        const int l = (e - L * WY_FLOATS) / WX_FLOATS;
        wreg[k] = p.wx[((size_t)l * p.n_views + n) * WX_FLOATS +
                       (e - L * WY_FLOATS) % WX_FLOATS];
      }
    }
#pragma unroll
    for (int l = 0; l < L; ++l) {
      rreg[l] = p.row0[(size_t)l * p.n_views + n];
      xreg[l] = p.x0[(size_t)l * p.n_views + n];
    }
  };

  float acc[128];
  int s = 0, buf = 0;
  uint32_t phase = 0;
  if (blockIdx.x < w.n_items) fetch(blockIdx.x);
  for (int item = blockIdx.x; item < w.n_items; item += gridDim.x) {
    const int c0 = (item % w.n_tiles) * TILE_C;
    // stage this view's weights, transposed: [y][i] and [x][j]
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int e = tid + k * n_cons;
      if (e < L * WY_FLOATS) {
        const int l = e / WY_FLOATS, r = e % WY_FLOATS;
        sm.wy[buf][l][r % WIN_Y][r / WIN_Y] = wreg[k];
      } else if (e < L * W_FLOATS) {
        const int l = (e - L * WY_FLOATS) / WX_FLOATS;
        const int r = (e - L * WY_FLOATS) % WX_FLOATS;
        sm.wx[buf][l][r % WIN_X][r / WIN_X] = wreg[k];
      }
    }
    bool inside = true;
#pragma unroll
    for (int l = 0; l < L; ++l)
      inside = inside && window_inside(p, l, rreg[l], xreg[l]);
    bar_sync(BAR_CONSUMERS, n_cons);
    if (item + (int)gridDim.x < w.n_items) fetch(item + gridDim.x);

#pragma unroll
    for (int v = 0; v < 128; ++v) acc[v] = 0.f;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      // wx at this thread's columns xa, xa + 1, xa + 8, xa + 9, for j0, j1
      float wx0[4], wx1[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int x = xa + (k & 1) + 8 * (k >> 1);
        wx0[k] = sm.wx[buf][l][x][j0];
        wx1[k] = sm.wx[buf][l][x][j1];
      }
#pragma unroll 1
      for (int st = 0; st < STAGES_PER_LEVEL; ++st) {
        mbar_wait(&sm.full[s], phase);
        if (inside) {
          uint32_t a[ROWS_PER_STAGE][4];
#pragma unroll
          for (int t = 0; t < ROWS_PER_STAGE; ++t) {
            const int y = st * ROWS_PER_STAGE + t;
            const float wy0 = sm.wy[buf][l][y][i0];
            const float wy1 = sm.wy[buf][l][y][i1];
            // the mma A fragment: rows m0 / m1, columns xa(+1), xa + 8(+1)
            a[t][0] = pack_bf16(__fmul_rn(wy0, wx0[0]), __fmul_rn(wy0, wx0[1]));
            a[t][1] = pack_bf16(__fmul_rn(wy1, wx1[0]), __fmul_rn(wy1, wx1[1]));
            a[t][2] = pack_bf16(__fmul_rn(wy0, wx0[2]), __fmul_rn(wy0, wx0[3]));
            a[t][3] = pack_bf16(__fmul_rn(wy1, wx1[2]), __fmul_rn(wy1, wx1[3]));
          }
          const uint32_t base = smem_u32(sm.ring[s]) +
                                wg * (WG_C / CHUNK_C) * CHUNK_BYTES;
          wgmma_fence();
#pragma unroll
          for (int t = 0; t < ROWS_PER_STAGE; ++t)
            wgmma_m64n256k16(acc, a[t], desc_b(base + t * ROW_BYTES));
          wgmma_commit_and_wait();
#pragma unroll
          for (int v = 0; v < 128; ++v) own(acc[v]);
#pragma unroll
          for (int t = 0; t < ROWS_PER_STAGE; ++t)
#pragma unroll
            for (int k = 0; k < 4; ++k) own(a[t][k]);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&sm.empty[s]);
        if (++s == RING) {
          s = 0;
          phase ^= 1;
        }
      }
    }

    // ---- the view's pool result, rounded to bf16, into the tile for the
    // epilogue warps: accumulator pair v holds channels cw + 8 v (+1) of
    // rows m0 (acc[4v], acc[4v + 1]) and m1 (acc[4v + 2], acc[4v + 3]) ----
    // In quant mode, _quant_view's first step on the way: y =
    // relu(round(round(acc) + bias)) (bf16: what the tile holds) and its max.
    bar_sync(BAR_TILE_EMPTY, n_tile);
    __nv_bfloat162 vmax = __floats2bfloat162_rn(0.f, 0.f);
    const __nv_bfloat162 nan2 = __floats2bfloat162_rn(NAN, NAN);
    const int width = min(TILE_C, p.channels - c0);
    // accumulator pair v of row m0 (h = 0) or m1 (h = 1), as stored
    auto pair = [&](int v, int h) {
      __nv_bfloat162 e = __floats2bfloat162_rn(acc[4 * v + 2 * h],
                                               acc[4 * v + 2 * h + 1]);
      if (QUANT) e = biased_relu2(e, sm.bias[(cw + 8 * v) / 2]);
      return e;
    };
    if (warp < 3) {
      // rows 0-47: stmatrix.x4 stores the four 8 x 8 fragments (rows m0 /
      // m1, 8 channels v / v + 1) of pairs v, v + 1 at once; lane l gives
      // the address of row l % 8 of fragment l / 8
      const uint32_t dst = smem_u32(
          &sm.tile[warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)]
                  [wg * WG_C + 8 * (lane >> 4)]);
#pragma unroll
      for (int v = 0; v < 32; v += 2) {
        const int c = wg * WG_C + 8 * v;  // the fragments' first channel
        if (c < width) {
          __nv_bfloat162 e[4] = {pair(v, 0), pair(v, 1), pair(v + 1, 0),
                                 pair(v + 1, 1)};
          vmax = __hmax2(vmax, __hmax2(e[0], e[1]));
          if (c + 8 < width) vmax = __hmax2(vmax, __hmax2(e[2], e[3]));
          if (!inside) e[0] = e[1] = e[2] = e[3] = nan2;
          asm volatile(
              "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, "
              "%4};" ::"r"(dst + 2 * 8 * v),
              "r"(*reinterpret_cast<uint32_t*>(&e[0])),
              "r"(*reinterpret_cast<uint32_t*>(&e[1])),
              "r"(*reinterpret_cast<uint32_t*>(&e[2])),
              "r"(*reinterpret_cast<uint32_t*>(&e[3]))
              : "memory");
        }
      }
    } else {
      // rows 48-63, of which only 48 exists: pair by pair
#pragma unroll
      for (int v = 0; v < 32; ++v) {
        const int c = cw + 8 * v;
        if (c < width && m0 < G * G) {
          const __nv_bfloat162 e = pair(v, 0);
          vmax = __hmax2(vmax, e);
          *reinterpret_cast<__nv_bfloat162*>(&sm.tile[m0][c]) =
              inside ? e : nan2;
        }
      }
    }
    if (QUANT) {
      const float2 f = __bfloat1622float2(vmax);
      float mx = fmaxf(f.x, f.y);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      if (lane == 0) sm.vmax[tid >> 5] = mx;
    }
    if (tid == 0) sm.inside = inside;
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    bar_arrive(BAR_TILE_FULL, n_tile);
    buf ^= 1;
  }
}

// ---------------------------------------------------------------- host ---

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                            cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// level l's (rows, wmax, C) bf16 buffer as a tensor map with boxes of 64
// channels x 16 x x ROWS_PER_STAGE rows, 128-byte swizzle
cudaError_t encode_level(CUtensorMap* map, const void* flat, int rows,
                         int wmax, int channels) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)channels, (cuuint64_t)wmax,
                              (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)channels * 2,
                                 (cuuint64_t)wmax * channels * 2};
  const cuuint32_t box[3] = {CHUNK_C, WIN_X, ROWS_PER_STAGE};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(flat), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int L, bool QUANT>
cudaError_t launch_instance(const WgmmaParams& w, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      window_pool_wgmma_kernel<L, QUANT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int grid = w.n_items < sms ? w.n_items : sms;
  window_pool_wgmma_kernel<L, QUANT>
      <<<grid, (w.n_wg + 1) * 128, SMEM_BYTES, stream>>>(w);
  return cudaGetLastError();
}

template <int L>
cudaError_t launch_levels(const WgmmaParams& w, cudaStream_t stream) {
  return w.p.bias != nullptr ? launch_instance<L, true>(w, stream)
                             : launch_instance<L, false>(w, stream);
}

template <int L, bool QUANT>
cudaError_t attrs(int* out) {
  cudaFuncAttributes a;
  const cudaError_t e =
      cudaFuncGetAttributes(&a, window_pool_wgmma_kernel<L, QUANT>);
  if (e != cudaSuccess) return e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = SMEM_BYTES;
  out[4] = a.maxThreadsPerBlock;
  return cudaSuccess;
}

}  // namespace

cudaError_t launch_wgmma_pool(const PoolParams& p, int n_levels,
                              cudaStream_t stream) {
  if (p.channels % 8 != 0 || (p.bias != nullptr && p.channels > TILE_C) ||
      (p.bias != nullptr && p.scale == nullptr))
    return cudaErrorInvalidValue;
  WgmmaParams w;
  w.p = p;
  w.n_tiles = (p.channels + TILE_C - 1) / TILE_C;
  w.n_items = p.n_views * w.n_tiles;
  w.n_wg = p.channels > WG_C ? 2 : 1;
  // K2's buffer holds n_views / views_per_image images of rows_per_image
  // rows; K1's levels are absolute
  for (int l = 0; l < n_levels; ++l) {
    const int rows = p.rows_per_image
                         ? (p.n_views / p.views_per_image) * p.rows_per_image
                         : p.rows[l];
    const cudaError_t e =
        encode_level(&w.map[l], p.flat[l], rows, p.wmax[l], p.channels);
    if (e != cudaSuccess) return e;
  }
  switch (n_levels) {
    case 1: return launch_levels<1>(w, stream);
    case 2: return launch_levels<2>(w, stream);
    case 3: return launch_levels<3>(w, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t wgmma_pool_attrs(int n_levels, int quant, int* out) {
  switch (n_levels * 2 + (quant ? 1 : 0)) {
    case 2: return attrs<1, false>(out);
    case 3: return attrs<1, true>(out);
    case 4: return attrs<2, false>(out);
    case 5: return attrs<2, true>(out);
    case 6: return attrs<3, false>(out);
    case 7: return attrs<3, true>(out);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mpn
