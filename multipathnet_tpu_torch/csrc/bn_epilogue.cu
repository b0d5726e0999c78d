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
