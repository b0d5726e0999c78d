// The frozen-BatchNorm epilogue of a ResNet convolution, for Hopper
// (sm_90a): the normalization of the convolution's float32 sum, the
// rounding to the compute dtype, the residual add and the ReLU in one pass
// (ops/batchnorm.bn_epilogue launches it; models/layers.FrozenBatchNorm
// calls that on its serving route).
//
// It replaces no TPU kernel: the JAX package leaves BatchNorm to XLA, which
// fuses it into the convolution's neighbours (multipathnet_tpu/models/
// backbones/resnet.py). Run as separate PyTorch ops (a subtract, a
// multiply, an add, the cast, the ReLU, the residual add and its ReLU, and
// the float32 copy the next convolution reads) they cost about 39 bytes of
// device traffic per element of the trunk's 94 convolution outputs. The
// work is bound by bytes: here it is one pass, 4 bytes read per element of
// the sum, 2 of the residual where there is one, 2 (bf16) or 4 (float32)
// written.
//
// Per element of x (rows, C), channels-last (the channel fastest), with
// per-channel float32 vectors mean, mul and bias (mul = rsqrt(var + eps) *
// scale, computed by the caller as torch computes it):
//     y = ((x - mean) * mul) + bias      three float32 roundings, in
//                                        flax's _normalize order
//     o = round(y)                       to the compute dtype (bf16: to
//                                        nearest even, NaN kept; float32:
//                                        as is)
//     o = round(float(r) + float(o))     with a residual r (compute dtype),
//                                        as PyTorch's bf16 add rounds its
//                                        float32 sum once
//     o = o <= 0 ? +0 : o                with the ReLU, as F.relu on the
//                                        card (a NaN stays NaN, -0 gives
//                                        +0; on the CPU F.relu keeps -0)
// written in the compute dtype, or, for bf16, widened to float32 where the
// only reader is the next convolution (models/layers.conv_f32 reads it as
// it is). The roundings are the intrinsics' (__fsub_rn, __fmul_rn,
// __fadd_rn): nvcc would otherwise contract the multiply and the add into
// one fused multiply-add, which rounds once and differs from the plain
// version.
//
// A unit is 4 channels of a row: one 16-byte load of the sum, one 8-byte
// load of a bf16 residual (16 of a float32 one), one 8-byte store of bf16
// (16 of float32). A thread takes two units a step, 32 units apart, so that
// each load and store instruction of a warp covers one contiguous span (512
// or 256 bytes) and every 32-byte sector is whole in one instruction: with
// 8 adjacent channels a thread (two 16-byte loads and stores), a warp's
// float32 stores each wrote half of every sector, and the float32-output
// instances ran at 69-77% of their bound (chip_smoke.py phase 26). The
// per-channel vectors are read through the read-only cache and only when
// a unit's channels change: a grid-stride loop whose stride is a multiple
// of C / 4 (every trunk width, 64-1024, against 256-thread blocks) keeps
// each of a thread's units on its channels. The grid is at most 8 blocks
// an SM, as many threads as an SM holds.
//
// The backward (bn_epilogue_backward_kernel, ops/batchnorm.BNEpilogue
// under a gradient) computes what autograd computes through the plain
// ops, in its roundings, per element of the incoming gradient g:
//     g = round(g)                       to bf16 where a bf16 result was
//                                        widened (the widening's backward)
//     g = out <= 0 ? +0 : g              with the ReLU, on the forward's
//                                        saved output (a NaN passes g)
//     dres = g                           with a residual, in its dtype
//     dx = float(g) * mul                one float32 rounding
//     dbias[c] += float(g)               per-channel float32 sums, and of
//     dmul[c] += float(g) * (x - mean)   the product rounded once, x -
//                                        mean by __fsub_rn as the forward
// Bound by bytes as the forward is: it reads g, the float32 sum and the
// output (ReLU) and writes dx and dres, 10-16 bytes an element in place of
// about 40 over autograd's chain of passes. It keeps the forward's access
// pattern (two 4-channel units a thread, 32 apart, 16-byte loads), with a
// grid stride `span` that is a multiple of C / 4 for every C: a thread's
// two units never change channels, so its 16 partial sums stay in
// registers across its rows. A block is 1024 threads, one an SM, so that
// the scratch of per-block partials is one row of 2 C floats an SM (1 MB
// at C = 1024 on 132 SMs, a quarter of what four 256-thread blocks an SM
// write, in the same time). A block sums its threads' partials
// in shared memory in a fixed order, the bias's then mul's, and writes
// its row; a second launch (bn_backward_sum_kernel) sums those rows in a
// fixed order. No atomics: the result is the same bits run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mpn_bn {

constexpr int THREADS = 256;
constexpr int VEC = 4;     // channels a unit
constexpr int UNITS = 2;   // units a thread takes a step, 32 apart
constexpr int BLOCKS_PER_SM = 8;   // 2048 threads: an SM's most

__device__ __forceinline__ void load4(const float* p, float (&v)[VEC]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void stream4(const float* p, float (&v)[VEC]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[VEC]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

struct alignas(8) Bf4 {
  __nv_bfloat16 v[VEC];
};

// BF16: the compute dtype is bf16 (else float32); RES: a residual in the
// compute dtype; RELU; OUT_F32: the output in float32 (always for a float32
// compute dtype)
template <bool BF16, bool RES, bool RELU, bool OUT_F32>
__global__ void __launch_bounds__(THREADS)
bn_epilogue_kernel(const float* __restrict__ x, const float* __restrict__ mean,
                   const float* __restrict__ mul,
                   const float* __restrict__ bias,
                   const void* __restrict__ res, void* __restrict__ out,
                   unsigned units, unsigned upr) {
  static_assert(BF16 || OUT_F32, "a float32 compute dtype writes float32");
  constexpr unsigned SPAN = 32 * UNITS;   // units a warp takes a step
  const unsigned lane = threadIdx.x % 32;
  const unsigned warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const unsigned stride = gridDim.x * blockDim.x / 32 * SPAN;
  unsigned c[UNITS];
  float mn[UNITS][VEC], ml[UNITS][VEC], bs[UNITS][VEC];
#pragma unroll
  for (int h = 0; h < UNITS; ++h) c[h] = 0xffffffffu;
  for (unsigned base = warp * SPAN; base < units; base += stride) {
#pragma unroll
    for (int h = 0; h < UNITS; ++h) {
      const unsigned u = base + h * 32 + lane;
      if (u >= units) continue;
      const unsigned cu = (u % upr) * VEC;
      if (cu != c[h]) {
        c[h] = cu;
        load4(mean + cu, mn[h]);
        load4(mul + cu, ml[h]);
        load4(bias + cu, bs[h]);
      }
      const size_t e0 = static_cast<size_t>(u) * VEC;
      float y[VEC];
      stream4(x + e0, y);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        y[e] = __fadd_rn(__fmul_rn(__fsub_rn(y[e], mn[h][e]), ml[h][e]),
                         bs[h][e]);
      if constexpr (BF16) {
        Bf4 o;
#pragma unroll
        for (int e = 0; e < VEC; ++e) o.v[e] = __float2bfloat16_rn(y[e]);
        if constexpr (RES) {
          const uint2 raw = __ldcs(reinterpret_cast<const uint2*>(
              static_cast<const __nv_bfloat16*>(res) + e0));
          const Bf4 r = *reinterpret_cast<const Bf4*>(&raw);
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            o.v[e] = __float2bfloat16_rn(__fadd_rn(
                __bfloat162float(r.v[e]), __bfloat162float(o.v[e])));
        }
        if constexpr (RELU) {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            if (__bfloat162float(o.v[e]) <= 0.f)
              o.v[e] = __float2bfloat16_rn(0.f);
        }
        if constexpr (OUT_F32) {
          float w[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) w[e] = __bfloat162float(o.v[e]);
          store4(static_cast<float*>(out) + e0, w);
        } else {
          *reinterpret_cast<Bf4*>(static_cast<__nv_bfloat16*>(out) + e0) = o;
        }
      } else {
        if constexpr (RES) {
          float r[VEC];
          stream4(static_cast<const float*>(res) + e0, r);
#pragma unroll
          for (int e = 0; e < VEC; ++e) y[e] = __fadd_rn(r[e], y[e]);
        }
        if constexpr (RELU) {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            if (y[e] <= 0.f) y[e] = 0.f;
        }
        store4(static_cast<float*>(out) + e0, y);
      }
    }
  }
}

template <bool BF16, bool RES, bool RELU, bool OUT_F32>
const void* instance() {
  return reinterpret_cast<const void*>(
      &bn_epilogue_kernel<BF16, RES, RELU, OUT_F32>);
}

// the instance for the flags; null for a float32 compute dtype with a bf16
// output
const void* pick(int bf16, int res, int relu, int out_f32) {
  if (!bf16 && !out_f32) return nullptr;
  if (bf16) {
    if (res) {
      if (relu) return out_f32 ? instance<true, true, true, true>()
                               : instance<true, true, true, false>();
      return out_f32 ? instance<true, true, false, true>()
                     : instance<true, true, false, false>();
    }
    if (relu) return out_f32 ? instance<true, false, true, true>()
                             : instance<true, false, true, false>();
    return out_f32 ? instance<true, false, false, true>()
                   : instance<true, false, false, false>();
  }
  if (res) return relu ? instance<false, true, true, true>()
                       : instance<false, true, false, true>();
  return relu ? instance<false, false, true, true>()
              : instance<false, false, false, true>();
}

// ------------------------------------------------------------ backward ---

constexpr int BWD_THREADS = 1024;   // one block an SM, 64 registers
constexpr unsigned BLOCK_UNITS = BWD_THREADS * UNITS;   // 2048

__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&v)[VEC]) {
  const uint2 raw = __ldcs(reinterpret_cast<const uint2*>(p));
  const Bf4 b = *reinterpret_cast<const Bf4*>(&raw);
#pragma unroll
  for (int e = 0; e < VEC; ++e) v[e] = __bfloat162float(b.v[e]);
}

// BF16: the compute dtype is bf16 (else float32); OUT_F32: the forward's
// output, and so g, is float32 (always for a float32 compute dtype); RELU:
// out (the forward's output) masks g. dres is null where there is no
// residual. partial: (gridDim.x, 2, C), the block's sums of g and of
// g * (x - mean) over its rows.
template <bool BF16, bool RELU, bool OUT_F32>
__global__ void __launch_bounds__(BWD_THREADS, 1)
bn_epilogue_backward_kernel(const void* __restrict__ g,
                            const float* __restrict__ x,
                            const float* __restrict__ mean,
                            const float* __restrict__ mul,
                            const void* __restrict__ out,
                            float* __restrict__ dx, void* __restrict__ dres,
                            float* __restrict__ partial, unsigned units,
                            unsigned upr, unsigned span) {
  static_assert(BF16 || OUT_F32, "a float32 compute dtype writes float32");
  __shared__ float red[BLOCK_UNITS][VEC];
  const unsigned lane = threadIdx.x % 32;
  const unsigned first = blockIdx.x * BLOCK_UNITS;
  unsigned j[UNITS];
  float mn[UNITS][VEC], ml[UNITS][VEC], sg[UNITS][VEC], sgy[UNITS][VEC];
#pragma unroll
  for (int h = 0; h < UNITS; ++h) {
    j[h] = first + threadIdx.x / 32 * (32 * UNITS) + h * 32 + lane;
    const unsigned cu = (j[h] % upr) * VEC;
    if (j[h] < span) {
      load4(mean + cu, mn[h]);
      load4(mul + cu, ml[h]);
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) sg[h][e] = sgy[h][e] = 0.f;
  }
  for (unsigned base = 0; base < units; base += span) {
#pragma unroll
    for (int h = 0; h < UNITS; ++h) {
      const unsigned u = base + j[h];
      if (j[h] >= span || u >= units) continue;
      const size_t e0 = static_cast<size_t>(u) * VEC;
      // g in the compute dtype: gb its bf16 bits (as a bf16 tensor holds
      // them, so a NaN keeps its payload), gv its value in float32
      float gv[VEC];
      Bf4 gb;
      if constexpr (BF16 && !OUT_F32) {
        const uint2 raw = __ldcs(reinterpret_cast<const uint2*>(
            static_cast<const __nv_bfloat16*>(g) + e0));
        gb = *reinterpret_cast<const Bf4*>(&raw);
      } else {
        stream4(static_cast<const float*>(g) + e0, gv);
      }
      if constexpr (BF16) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          if constexpr (OUT_F32) gb.v[e] = __float2bfloat16_rn(gv[e]);
          gv[e] = __bfloat162float(gb.v[e]);
        }
      }
      if constexpr (RELU) {
        float o[VEC];
        if constexpr (OUT_F32)
          stream4(static_cast<const float*>(out) + e0, o);
        else
          load4(static_cast<const __nv_bfloat16*>(out) + e0, o);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (o[e] <= 0.f) {
            gv[e] = 0.f;
            if constexpr (BF16) gb.v[e] = __float2bfloat16_rn(0.f);
          }
      }
      if (dres != nullptr) {
        if constexpr (BF16)
          *reinterpret_cast<Bf4*>(static_cast<__nv_bfloat16*>(dres) + e0) =
              gb;
        else
          store4(static_cast<float*>(dres) + e0, gv);
      }
      float xv[VEC];
      stream4(x + e0, xv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        sg[h][e] = __fadd_rn(sg[h][e], gv[e]);
        sgy[h][e] = __fadd_rn(
            sgy[h][e], __fmul_rn(gv[e], __fsub_rn(xv[e], mn[h][e])));
      }
      float d[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) d[e] = __fmul_rn(gv[e], ml[h][e]);
      store4(dx + e0, d);
    }
  }
  // the block's units that hold channel unit cu lie upr apart from the
  // first of them; a unit past span or units summed zeros
  const unsigned c = upr * VEC;
  const unsigned shift = first % upr;
  float* row = partial + static_cast<size_t>(blockIdx.x) * 2 * c;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int h = 0; h < UNITS; ++h)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        red[j[h] - first][e] = s == 0 ? sg[h][e] : sgy[h][e];
    __syncthreads();
    for (unsigned ch = threadIdx.x; ch < c; ch += BWD_THREADS) {
      const unsigned cu = ch / VEC, e = ch % VEC;
      float sum = 0.f;
      for (unsigned l = (cu + upr - shift) % upr; l < BLOCK_UNITS; l += upr)
        sum = __fadd_rn(sum, red[l][e]);
      row[s * c + ch] = sum;
    }
    __syncthreads();
  }
}

// the sum of partial[b][i] over the blocks b, for i < n (= 2 C), in a
// fixed order: 32 columns a block, its 32 warps each taking every 32nd
// row, then the 32 warps' sums in order; written to dbias[i] for i < C,
// to dmul[i - C] after
__global__ void __launch_bounds__(1024)
bn_backward_sum_kernel(const float* __restrict__ partial,
                       float* __restrict__ dbias, float* __restrict__ dmul,
                       unsigned blocks, unsigned n) {
  __shared__ float t[32][33];
  const unsigned col = blockIdx.x * 32 + threadIdx.x % 32;
  const unsigned row = threadIdx.x / 32;
  float s = 0.f;
  if (col < n)
    for (unsigned b = row; b < blocks; b += 32)
      s = __fadd_rn(s, partial[static_cast<size_t>(b) * n + col]);
  t[row][threadIdx.x % 32] = s;
  __syncthreads();
  if (row == 0 && col < n) {
    float total = 0.f;
#pragma unroll
    for (int k = 0; k < 32; ++k) total = __fadd_rn(total, t[k][threadIdx.x]);
    if (col < n / 2)
      dbias[col] = total;
    else
      dmul[col - n / 2] = total;
  }
}

template <bool BF16, bool RELU, bool OUT_F32>
const void* backward_instance() {
  return reinterpret_cast<const void*>(
      &bn_epilogue_backward_kernel<BF16, RELU, OUT_F32>);
}

const void* pick_backward(int bf16, int relu, int out_f32) {
  if (!bf16 && !out_f32) return nullptr;
  if (bf16) {
    if (relu) return out_f32 ? backward_instance<true, true, true>()
                             : backward_instance<true, true, false>();
    return out_f32 ? backward_instance<true, false, true>()
                   : backward_instance<true, false, false>();
  }
  return relu ? backward_instance<false, true, true>()
              : backward_instance<false, false, true>();
}

}  // namespace mpn_bn

// The epilogue of x (rows, c) float32, channels-last (c % 8 == 0, 16-byte
// aligned), with mean, mul and bias (c,) float32 (16-byte aligned) and res
// (rows, c) in the compute dtype (bf16 if compute_bf16, else float32) or
// null, into out (rows, c): float32 if out_f32, else bf16 (compute_bf16
// only); relu != 0 applies the ReLU.
extern "C" int mpn_bn_epilogue(int compute_bf16, int out_f32, int relu,
                               int rows, int c, const float* x,
                               const float* mean, const float* mul,
                               const float* bias, const void* res, void* out,
                               void* stream) {
  using namespace mpn_bn;
  const long long units = static_cast<long long>(rows) * (c / VEC);
  const void* fn = pick(compute_bf16, res != nullptr, relu, out_f32);
  if (rows <= 0 || c <= 0 || c % 8 || units > 0x7fffffffLL ||
      fn == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per_block = THREADS * UNITS;
  const long long needed = (units + per_block - 1) / per_block;
  const long long cap = static_cast<long long>(sms) * BLOCKS_PER_SM;
  const unsigned blocks = static_cast<unsigned>(needed < cap ? needed : cap);
  unsigned n = static_cast<unsigned>(units);
  unsigned upr = static_cast<unsigned>(c / VEC);
  void* args[] = {&x, &mean, &mul, &bias, &res, &out, &n, &upr};
  return static_cast<int>(cudaLaunchKernel(
      fn, dim3(blocks), dim3(THREADS), args, 0,
      static_cast<cudaStream_t>(stream)));
}

// Attributes into out[5] (registers per thread, local bytes per thread,
// static shared bytes, max threads per block, blocks resident on one SM)
// of the instance for the flags, as mpn_bn_epilogue picks it.
extern "C" int mpn_bn_epilogue_attrs(int compute_bf16, int out_f32, int res,
                                     int relu, int* out) {
  using namespace mpn_bn;
  const void* fn = pick(compute_bf16, res, relu, out_f32);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = a.maxThreadsPerBlock;
  out[4] = per_sm;
  return cudaSuccess;
}

// The backward of mpn_bn_epilogue's flags, for x (rows, c) float32
// channels-last (c % 8 == 0, every map and vector 16-byte aligned): g
// (rows, c) in the forward's output dtype (float32 if out_f32, else bf16),
// out the forward's output (read only if relu), mean and mul (c,)
// float32. Writes dx (rows, c) float32, dres (rows, c) in the compute
// dtype where it is not null, and dbias and dmul (c) float32: the sums of
// g (the bias's gradient) and of g * (x - mean) (mul's). partial is
// scratch of partial_rows x 2 x c floats, a row a block: the grid takes
// at most partial_rows blocks of 1024 threads (one an SM fills the card).
extern "C" int mpn_bn_epilogue_backward(int compute_bf16, int out_f32,
                                        int relu, int rows, int c,
                                        const void* g, const float* x,
                                        const float* mean, const float* mul,
                                        const void* out, float* dx,
                                        void* dres, float* partial,
                                        int partial_rows, float* dbias,
                                        float* dmul, void* stream) {
  using namespace mpn_bn;
  const long long units = static_cast<long long>(rows) * (c / VEC);
  const void* fn = pick_backward(compute_bf16, relu, out_f32);
  if (rows <= 0 || c <= 0 || c % 8 || c / VEC > BLOCK_UNITS ||
      units > 0x7fffffffLL || partial_rows <= 0 || fn == nullptr ||
      dx == nullptr || dbias == nullptr || dmul == nullptr ||
      (relu && out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long needed = (units + BLOCK_UNITS - 1) / BLOCK_UNITS;
  unsigned blocks = static_cast<unsigned>(
      needed < partial_rows ? needed : partial_rows);
  unsigned n = static_cast<unsigned>(units);
  unsigned upr = static_cast<unsigned>(c / VEC);
  // units a grid step takes: a multiple of upr (at least upr, as a block
  // holds BLOCK_UNITS >= upr), so that a unit keeps its channels
  unsigned span = blocks * BLOCK_UNITS / upr * upr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* args[] = {&g, &x, &mean, &mul, &out, &dx, &dres, &partial, &n, &upr,
                  &span};
  cudaError_t err = cudaLaunchKernel(fn, dim3(blocks), dim3(BWD_THREADS),
                                     args, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned width = static_cast<unsigned>(2 * c);
  bn_backward_sum_kernel<<<(width + 31) / 32, 1024, 0, s>>>(
      partial, dbias, dmul, blocks, width);
  return static_cast<int>(cudaGetLastError());
}

// Attributes into out[5], as mpn_bn_epilogue_attrs, of the backward's
// instance for the flags.
extern "C" int mpn_bn_epilogue_backward_attrs(int compute_bf16, int out_f32,
                                              int relu, int* out) {
  using namespace mpn_bn;
  const void* fn = pick_backward(compute_bf16, relu, out_f32);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, BWD_THREADS,
                                                    0);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = a.maxThreadsPerBlock;
  out[4] = per_sm;
  return cudaSuccess;
}
