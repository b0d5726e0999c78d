// A ResNet 1x1 convolution and the frozen BatchNorm after it, for Hopper
// (sm_90a), in one launch: the bf16 GEMM on wgmma with float32
// accumulators, then csrc/bn_epilogue.cu's arithmetic on the accumulators
// in registers (ops/conv_bn.conv1x1_bn launches it; models/layers.conv_bn
// routes every stride-1, bias-free 1x1 convolution of a bf16 trunk to it
// when serving on the card).
//
// It replaces no TPU kernel: the JAX package leaves the convolution and
// its BatchNorm to XLA (multipathnet_tpu/models/backbones/resnet.py). On
// the card they ran as a TF32 GEMM (cuBLAS/cuDNN) over float32 copies of
// the bf16 operands, its float32 sum written out, and kernel N
// (bn_epilogue.cu) reading it back: about 100 bytes of device traffic per
// element of a bottleneck's inner width on its two 1x1 sides. Here the
// block input is read once in bf16, the weights once per tile from L2, and
// only the finished output (bf16, or float32 where a 3x3 convolution reads
// it) is written, with a bf16 residual read once where there is one. At
// ResNet-101's shapes (K = 64-1024 channels, 12,800-204,800 rows) every
// instance is bound by those bytes, not by the tensor cores.
//
// What it computes, per output element (row m, channel n):
//     s = sum_k bf16 x[m, k] * bf16 w[n, k]     float32 (the products are
//                                                exact; only the order of
//                                                the additions differs
//                                                from the plain version)
//     y = ((s - mean[n]) * mul[n]) + bias[n]     three float32 roundings
//     o = bf16(y), o = bf16(float(r) + float(o)) with a residual r, then
//     the ReLU (o <= 0 gives +0, a NaN stays), written in bf16 or widened
//     to float32: bn_epilogue.cu's steps and intrinsics exactly, so that
//     the same float32 sum gives the same bits.
//
// Layout. One persistent block per SM walks the output tiles (128 rows x
// BN channels, BN = 128, or 64 where C_out is not a multiple of 128) with
// the channel tiles of one row block adjacent, so that blocks running at
// once share their rows of x in L2. A block is two consumer warpgroups,
// each owning 64 of the tile's rows, and one producer warp:
//   - the producer's first thread keeps a 4-stage shared-memory ring full
//     by TMA: per stage one 64-channel slice of K of the x tile (128 x 64)
//     and of the weight tile (BN x 64), 128-byte swizzle, the K-major
//     layout wgmma reads. It runs up to three stages (at K = 64, three
//     tiles) ahead of the consumers, so the next tile's operands arrive
//     while the consumers finish this one's epilogue.
//   - each consumer warpgroup runs four m64nBNk16 wgmmas a stage, keeps
//     one stage's group in flight while it waits for the next, and frees
//     each stage once its products are done.
//   - the epilogue: the warpgroup's leader has already asked TMA for the
//     residual's 64 x BN tile (bf16) at the tile's start, into the
//     warpgroup's staging buffer; each thread applies the arithmetic above
//     to its accumulators, reads its residual values from the buffer and
//     writes its results in place, in the 128-byte-swizzled layout of the
//     output's TMA boxes (conflict-free: a warp's 8 rows land on 8
//     distinct 16-byte columns); the leader then stores the buffer by TMA
//     and goes on. The next tile waits for that store to have read the
//     buffer before the buffer is written again.
// TMA zero-fills the rows of a ragged last row block and does not store
// them. The wrapper takes C_in and C_out multiples of 64, 16-byte aligned
// channels-last tensors and a residual only with a bf16 output.

#include <cuda_bf16.h>
#include <stdint.h>

#include "tma.cuh"

namespace mpn_c1 {
namespace {

using namespace mpn;

constexpr int BM = 128;                 // rows a tile
constexpr int BK = 64;                  // K a stage: one 128-byte row
constexpr int BN_MAX = 128;
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;          // two warpgroups
constexpr int THREADS = CONSUMERS + 128;
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BN_MAX * BK * 2;
constexpr int WG_ROWS = 64;
constexpr int BOX_BYTES = WG_ROWS * 128;        // one 64-row output box
constexpr int EPI_BYTES = WG_ROWS * BN_MAX * 4; // a warpgroup's float32 rows

struct __align__(64) Params {
  CUtensorMap a;      // x (rows, C_in) bf16, boxes 64 x 128 rows
  CUtensorMap b;      // w (C_out, C_in) bf16, boxes 64 x BN rows
  CUtensorMap out;    // (rows, C_out), boxes 128 bytes x 64 rows
  CUtensorMap res;    // (rows, C_out) bf16, boxes 64 x 64 rows
  const float* mean;
  const float* mul;
  const float* bias;
  int k_steps;        // C_in / 64
  int n_tiles_n;      // C_out / BN
  int n_tiles;        // row blocks x n_tiles_n
};

struct Smem {
  uint8_t a[STAGES][A_BYTES];   // 1024-aligned: the swizzle's atoms
  uint8_t b[STAGES][B_BYTES];
  uint8_t epi[2][EPI_BYTES];    // each warpgroup's residual / output boxes
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
  uint64_t res_full[2];
};

constexpr int SMEM_BYTES = sizeof(Smem) + 1024;

// wgmma's descriptor of a K-major operand with the 128-byte swizzle: rows
// of 128 bytes (64 bf16 of K), 8-row atoms 1024 bytes apart; the k16 step
// kk starts 32 kk bytes into the row
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x 128, float32) = A . B (+ d if accumulate): A (64 x 16) and B
// (128 x 16), both bf16 K-major in shared memory (descriptors)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, float32) = A . B (+ d if accumulate): A (64 x 16) and B
// (64 x 16), both bf16 K-major in shared memory (descriptors)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db, int accumulate) {
  if constexpr (BN == 128) wgmma_m64n128k16(d, da, db, accumulate);
  else wgmma_m64n64k16(d, da, db, accumulate);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from touching registers that an async wgmma owns
// before its wait
__device__ __forceinline__ void own(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// bn_epilogue.cu's arithmetic on two channels of one row: the BN in three
// float32 roundings, bf16, the residual pair r (RES), the ReLU (RELU)
template <bool RES, bool RELU>
__device__ __forceinline__ __nv_bfloat162 epilogue2(float s0, float s1,
                                                    float2 mn, float2 ml,
                                                    float2 bs,
                                                    __nv_bfloat162 r) {
  const float y0 = __fadd_rn(__fmul_rn(__fsub_rn(s0, mn.x), ml.x), bs.x);
  const float y1 = __fadd_rn(__fmul_rn(__fsub_rn(s1, mn.y), ml.y), bs.y);
  __nv_bfloat16 o0 = __float2bfloat16_rn(y0), o1 = __float2bfloat16_rn(y1);
  if constexpr (RES) {
    o0 = __float2bfloat16_rn(__fadd_rn(__bfloat162float(r.x),
                                       __bfloat162float(o0)));
    o1 = __float2bfloat16_rn(__fadd_rn(__bfloat162float(r.y),
                                       __bfloat162float(o1)));
  }
  if constexpr (RELU) {
    if (__bfloat162float(o0) <= 0.f) o0 = __float2bfloat16_rn(0.f);
    if (__bfloat162float(o1) <= 0.f) o1 = __float2bfloat16_rn(0.f);
  }
  __nv_bfloat162 o;
  o.x = o0;
  o.y = o1;
  return o;
}

// BN: the tile's channels (128 or 64); RES: a bf16 residual; RELU;
// OUT_F32: the output widened to float32 (else bf16)
template <int BN, bool RES, bool RELU, bool OUT_F32>
__global__ void __launch_bounds__(THREADS, 1)
conv1x1_bn_kernel(const __grid_constant__ Params p) {
  static_assert(!(RES && OUT_F32), "a residual only with a bf16 output");
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMERS / 32);
    }
    mbar_init(&sm.res_full[0], 1);
    mbar_init(&sm.res_full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer: one thread fills the ring ----
    if (tid != CONSUMERS) return;
    int s = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
      const int m0 = (t / p.n_tiles_n) * BM, n0 = (t % p.n_tiles_n) * BN;
      for (int kb = 0; kb < p.k_steps; ++kb) {
        mbar_wait(&sm.empty[s], phase ^ 1);
        mbar_expect_tx(&sm.full[s], A_BYTES + BN * BK * 2);
        tma_load_2d(sm.a[s], &p.a, &sm.full[s], kb * BK, m0);
        tma_load_2d(sm.b[s], &p.b, &sm.full[s], kb * BK, n0);
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of a tile ----
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const bool leader = (tid & 127) == 0;
  uint8_t* epi = sm.epi[wg];
  // this thread's accumulator rows (r, r + 8) and channel pair 2 q: pair j
  // holds channels 8 j + 2 q (+1) of rows r (acc[4 j], acc[4 j + 1]) and
  // r + 8 (acc[4 j + 2], acc[4 j + 3]); both rows are r % 8 == lane / 4 in
  // their 8-row swizzle atom
  const int q = lane & 3, sw = lane >> 2, r = warp * 16 + sw;
  float acc[BN / 2];
#pragma unroll
  for (int v = 0; v < BN / 2; ++v) acc[v] = 0.f;
  int s = 0;
  uint32_t phase = 0, res_phase = 0;
  for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
    const int m0 = (t / p.n_tiles_n) * BM + wg * WG_ROWS;
    const int n0 = (t % p.n_tiles_n) * BN;
    if (RES && leader) {
      // the last tile's store has read the buffer: the residual may land
      bulk_wait_read();
      mbar_expect_tx(&sm.res_full[wg], WG_ROWS * BN * 2);
#pragma unroll
      for (int bx = 0; bx < BN / 64; ++bx)
        tma_load_2d(epi + bx * BOX_BYTES, &p.res, &sm.res_full[wg],
                    n0 + 64 * bx, m0);
    }

    int prev = -1;
    for (int kb = 0; kb < p.k_steps; ++kb) {
      mbar_wait(&sm.full[s], phase);
      const uint32_t a = smem_u32(sm.a[s]) + wg * BOX_BYTES;
      const uint32_t b = smem_u32(sm.b[s]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_tile<BN>(acc, desc_k(a + 32 * kk), desc_k(b + 32 * kk),
                       kb > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();   // the last stage's products are done
      if (prev >= 0 && lane == 0) mbar_arrive(&sm.empty[prev]);
      prev = s;
      if (++s == STAGES) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int v = 0; v < BN / 2; ++v) own(acc[v]);
    if (lane == 0) mbar_arrive(&sm.empty[prev]);

    // ---- the epilogue into the staging buffer, then one TMA store ----
    if constexpr (RES) {
      mbar_wait(&sm.res_full[wg], res_phase);
      res_phase ^= 1;
    } else {
      if (leader) bulk_wait_read();
      bar_sync(1 + wg, 128);
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = n0 + 8 * j + 2 * q;
      const float2 mn = ldg2(p.mean + c), ml = ldg2(p.mul + c),
                   bs = ldg2(p.bias + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r + 8 * h;
        // the byte of (row, channel 8 j + 2 q) in the swizzled boxes
        const int off =
            OUT_F32 ? (j / 4) * BOX_BYTES + row * 128 +
                          (((2 * (j % 4) + (q >> 1)) ^ sw) << 4) + 8 * (q & 1)
                    : (j / 8) * BOX_BYTES + row * 128 +
                          (((j % 8) ^ sw) << 4) + 4 * q;
        __nv_bfloat162 res = __floats2bfloat162_rn(0.f, 0.f);
        if constexpr (RES)
          res = *reinterpret_cast<const __nv_bfloat162*>(epi + off);
        const __nv_bfloat162 o = epilogue2<RES, RELU>(
            acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], mn, ml, bs, res);
        if constexpr (OUT_F32)
          *reinterpret_cast<float2*>(epi + off) = __bfloat1622float2(o);
        else
          *reinterpret_cast<__nv_bfloat162*>(epi + off) = o;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    bar_sync(1 + wg, 128);
    if (leader) {
      constexpr int BOX_C = OUT_F32 ? 32 : 64;
#pragma unroll
      for (int bx = 0; bx < BN / BOX_C; ++bx)
        tma_store_2d(&p.out, epi + bx * BOX_BYTES, n0 + BOX_C * bx, m0);
      bulk_commit();
    }
  }
  if (leader) bulk_wait();
}

// ---------------------------------------------------------------- host ---

// a (rows, cols) row-major tensor as a 2-D tensor map with boxes of
// box_c x box_rows, 128-byte swizzle (box_c x the element's bytes = 128)
cudaError_t encode_2d(CUtensorMap* map, const void* ptr, bool f32, int rows,
                      int cols, int box_c, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const int esize = f32 ? 4 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * esize};
  const cuuint32_t box[2] = {(cuuint32_t)box_c, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(
      map,
      f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BN, bool RES, bool RELU, bool OUT_F32>
const void* instance() {
  return reinterpret_cast<const void*>(
      &conv1x1_bn_kernel<BN, RES, RELU, OUT_F32>);
}

template <int BN>
const void* pick_bn(int res, int relu, int out_f32) {
  if (res)
    return relu ? instance<BN, true, true, false>()
                : instance<BN, true, false, false>();
  if (out_f32)
    return relu ? instance<BN, false, true, true>()
                : instance<BN, false, false, true>();
  return relu ? instance<BN, false, true, false>()
              : instance<BN, false, false, false>();
}

// the instance for the flags; null for a residual with a float32 output
const void* pick(int bn, int res, int relu, int out_f32) {
  if (res && out_f32) return nullptr;
  if (bn == 128) return pick_bn<128>(res, relu, out_f32);
  if (bn == 64) return pick_bn<64>(res, relu, out_f32);
  return nullptr;
}

}  // namespace
}  // namespace mpn_c1

// x (rows, c_in) bf16 times w (c_out, c_in) bf16, then the BN epilogue
// with mean, mul and bias (c_out,) float32 and res (rows, c_out) bf16 or
// null, into out (rows, c_out): float32 if out_f32 (no residual then),
// else bf16; relu != 0 applies the ReLU. c_in and c_out multiples of 64,
// every pointer 16-byte aligned.
extern "C" int mpn_conv1x1_bn(int relu, int out_f32, int rows, int c_in,
                              int c_out, const void* x, const void* w,
                              const float* mean, const float* mul,
                              const float* bias, const void* res, void* out,
                              void* stream) {
  using namespace mpn_c1;
  const int bn = c_out % 128 == 0 ? 128 : 64;
  const void* fn = pick(bn, res != nullptr, relu, out_f32);
  if (rows <= 0 || c_in <= 0 || c_in % 64 || c_out <= 0 || c_out % 64 ||
      fn == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  cudaError_t e;
  if ((e = encode_2d(&p.a, x, false, rows, c_in, 64, BM)) != cudaSuccess ||
      (e = encode_2d(&p.b, w, false, c_out, c_in, 64, bn)) != cudaSuccess ||
      (e = encode_2d(&p.out, out, out_f32, rows, c_out, out_f32 ? 32 : 64,
                     WG_ROWS)) != cudaSuccess)
    return static_cast<int>(e);
  if (res != nullptr &&
      (e = encode_2d(&p.res, res, false, rows, c_out, 64, WG_ROWS)) !=
          cudaSuccess)
    return static_cast<int>(e);
  p.mean = mean;
  p.mul = mul;
  p.bias = bias;
  p.k_steps = c_in / BK;
  p.n_tiles_n = c_out / bn;
  p.n_tiles = (rows + BM - 1) / BM * p.n_tiles_n;
  // the shared-memory size once per device and instance, the SM count
  // once per device
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  static uint32_t sized[64] = {};
  static int sms[64] = {};
  const uint32_t bit = 1u << ((bn == 128) * 8 + (res != nullptr) * 4 +
                              (relu != 0) * 2 + (out_f32 != 0));
  if (!(sized[dev] & bit)) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized[dev] |= bit;
  }
  if (sms[dev] == 0) {
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = p.n_tiles < sms[dev] ? p.n_tiles : sms[dev];
  void* args[] = {&p};
  return static_cast<int>(cudaLaunchKernel(fn, dim3(grid), dim3(THREADS),
                                           args, SMEM_BYTES,
                                           static_cast<cudaStream_t>(stream)));
}

// Attributes into out[5] (registers per thread, local bytes per thread,
// static shared bytes, dynamic shared bytes, max threads per block) of the
// instance for a tile of bn (64 or 128) channels and the flags.
extern "C" int mpn_conv1x1_bn_attrs(int bn, int res, int relu, int out_f32,
                                    int* out) {
  using namespace mpn_c1;
  const void* fn = pick(bn, res, relu, out_f32);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = SMEM_BYTES;
  out[4] = a.maxThreadsPerBlock;
  return cudaSuccess;
}
