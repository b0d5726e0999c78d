// The int8 serving head's elementwise work around its GEMMs, for Hopper
// (sm_90a): the per-row quantize of an Int8Linear's input and the epilogue
// of its int32 products (ops/quant.quantize_rows_padded and
// ops/quant.int8_epilogue launch them; models/heads.py calls those).
//
// It replaces no TPU kernel: the JAX package leaves these steps to XLA,
// which fuses them into the GEMMs' neighbours (multipathnet_tpu/ops/
// quant.py). Run as separate PyTorch ops they cost about 47 bytes of device
// traffic per element of a quantize (a float32 copy, abs, amax, divide,
// round, clamp, int8 cast) and 34 per element of an epilogue (a float32
// copy, a float64 addcmul, a slice copy, a cast, a ReLU). Both are bound by
// bytes, and each is one pass here.
//
// quantize_rows_kernel: per row m of x (M, K), bf16 or float32,
//     scale[m] = max(amax[m] * float32(1/127), 1e-12)
//     codes[m][k] = clip(rint(x[m][k] / scale[m]), -127, 127)   k < K
//     codes[m][k] = 0                                        K <= k < K_pad
// amax[m] is the row's largest magnitude, or the caller's (a row-parallel
// layer's maximum over every rank's columns). The arithmetic is
// ops/quant.quantize_rows': the constant multiply (not amax / 127), the
// IEEE quotient (the pool epilogue's div_rn, no fast math), round half to
// even. The max keeps a NaN (max.NaN), as torch.amax does, so a row holding
// one gets a NaN scale and, every quotient being NaN, zero codes (C11). A
// group of tpr threads owns a row and holds all of it in registers (NV
// loads of 16 bytes a thread, or of one element where the row is not
// 16-byte aligned; rows up to 32768 elements, the widest the wrapper
// takes), so the row is read from device memory once and nothing crosses
// blocks: no atomics, the same codes on every run. Bound: 2 (bf16) or 4
// (float32) bytes read and 1 written per element.
//
// int8_epilogue_kernel: per kept element of the (M, N_pad) int32 products,
//     y = fma(float(acc[m][j]), x_scale[m] * w_scale[j], bias[j])
// (without a bias, float(acc) * sc), x_scale * w_scale rounded to float32
// first, as ops/quant.rescale_int32 does; y rounded once to the output
// dtype (bf16 or float32), then the optional ReLU, as F.relu after the
// cast. The true FMA is the reference's arithmetic (XLA contracts the
// multiply and add into one); the plain version's float64 addcmul differs
// from it only where its float64 sum is an exact float32 tie. Only the
// logical N columns are written, through a row stride and a column offset
// (the out pointer), so a branch's output can land in its column slice of
// a wider buffer. A thread takes 4 columns: one 16-byte load of the
// products, one 8- or 16-byte store where the destination is aligned.
// Bound: 4 bytes read and 2 (bf16) or 4 written per element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "roi_window_pool.cuh"  // fmax_nan, view_reciprocal, div_rn

namespace mpn_head {

using mpn::div_rn;
using mpn::fmax_nan;

constexpr float INV_127 = 0x1.020408p-7f;   // float32(1/127)
constexpr float MIN_SCALE = 1e-12f;
constexpr int MAX_ROW_THREADS = 1024;
constexpr int MIN_BLOCK = 256;
constexpr int EPILOGUE_THREADS = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// rint(x / s) clipped to +-127, the quotient as div.rn rounds it (div_rn
// with r = view_reciprocal(s): the pool epilogue's division, correctly
// rounded wherever the code can depend on it, s >= 1e-12 and |x / s| <=
// 127, roi_window_pool.cuh). A NaN quotient gives 0: a NaN row (s NaN), and
// an infinity over an infinite scale, as the IEEE quotient gives; a finite
// x over an infinite scale gives 0 either way.
__device__ __forceinline__ signed char code(float x, float s, float r) {
  const float q = rintf(div_rn(x, s, r));
  return q != q ? 0
                : static_cast<signed char>(fminf(fmaxf(q, -127.f), 127.f));
}

template <int N>
struct alignas(N) Codes {
  signed char c[N];
};

// V is the load: uint4 (16 bytes of T) or T itself
template <typename T, typename V, int NV>
__global__ void __launch_bounds__(MAX_ROW_THREADS)
quantize_rows_kernel(const T* __restrict__ x, int ld_x, int m, int k,
                     int k_pad, int tpr, const float* __restrict__ amax_in,
                     signed char* __restrict__ codes,
                     float* __restrict__ scale) {
  constexpr int VALS = sizeof(V) / sizeof(T);
  __shared__ float s_max[MAX_ROW_THREADS / 32];
  const int in_block = threadIdx.x / tpr, lane = threadIdx.x % tpr;
  const int row = blockIdx.x * (blockDim.x / tpr) + in_block;
  const bool live = row < m;
  const int nvec = k / VALS;
  const V* src = reinterpret_cast<const V*>(x + (size_t)(live ? row : 0) *
                                                    ld_x);
  V v[NV];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = lane + j * tpr;
    if (live && i < nvec) {
      v[j] = __ldcs(src + i);
      const T* t = reinterpret_cast<const T*>(&v[j]);
#pragma unroll
      for (int e = 0; e < VALS; ++e)
        amax = fmax_nan(amax, fabsf(to_float(t[e])));
    }
  }
  float a;
  if (amax_in != nullptr) {
    a = live ? amax_in[row] : 0.f;
  } else {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmax_nan(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (tpr > 32) {  // the row's warps through shared memory
      if ((threadIdx.x & 31) == 0) s_max[threadIdx.x >> 5] = amax;
      __syncthreads();
      const int first = in_block * (tpr >> 5);
      amax = s_max[first];
      for (int w = 1; w < (tpr >> 5); ++w)
        amax = fmax_nan(amax, s_max[first + w]);
    }
    a = amax;
  }
  if (!live) return;
  const float s = fmax_nan(__fmul_rn(a, INV_127), MIN_SCALE);
  const float r = mpn::view_reciprocal(s);
  if (lane == 0) scale[row] = s;
  signed char* dst = codes + (size_t)row * k_pad;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = lane + j * tpr;
    if (i < nvec) {
      const T* t = reinterpret_cast<const T*>(&v[j]);
      Codes<VALS> q;
#pragma unroll
      for (int e = 0; e < VALS; ++e) q.c[e] = code(to_float(t[e]), s, r);
      *reinterpret_cast<Codes<VALS>*>(dst + i * VALS) = q;
    }
  }
  for (int c = k + lane; c < k_pad; c += tpr) dst[c] = 0;
}

template <typename T, typename V>
cudaError_t launch_quantize(const T* x, int ld_x, int m, int k, int k_pad,
                            const float* amax, signed char* codes,
                            float* scale, cudaStream_t s) {
  constexpr int VALS = sizeof(V) / sizeof(T);
  const int nvec = k / VALS;
  // a row's threads: about 4 loads each, 32 to MAX_ROW_THREADS
  int tpr = 32;
  while (tpr < MAX_ROW_THREADS && tpr * 4 < nvec) tpr *= 2;
  const int nv = (nvec + tpr - 1) / tpr;
  const int rows = tpr >= MIN_BLOCK ? 1 : MIN_BLOCK / tpr;
  const dim3 grid((m + rows - 1) / rows), block(rows * tpr);
#define MPN_QUANTIZE(NV)                                                  \
  quantize_rows_kernel<T, V, NV><<<grid, block, 0, s>>>(                  \
      x, ld_x, m, k, k_pad, tpr, amax, codes, scale)
  if (nv <= 1) MPN_QUANTIZE(1);
  else if (nv <= 2) MPN_QUANTIZE(2);
  else if (nv <= 4) MPN_QUANTIZE(4);
  else if (nv <= 8) MPN_QUANTIZE(8);
  else if constexpr (VALS == 1) {  // one element a load: up to 32
    if (nv <= 16) MPN_QUANTIZE(16);
    else if (nv <= 32) MPN_QUANTIZE(32);
    else return cudaErrorInvalidValue;
  } else {
    return cudaErrorInvalidValue;
  }
#undef MPN_QUANTIZE
  return cudaGetLastError();
}

template <typename T>
cudaError_t quantize(const void* x, int ld_x, int m, int k, int k_pad,
                     const float* amax, signed char* codes, float* scale,
                     cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  constexpr int VALS = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       ld_x % VALS == 0 && k % VALS == 0 &&
                       k_pad % VALS == 0 &&
                       reinterpret_cast<uintptr_t>(codes) % VALS == 0;
  return aligned ? launch_quantize<T, uint4>(xt, ld_x, m, k, k_pad, amax,
                                             codes, scale, s)
                 : launch_quantize<T, T>(xt, ld_x, m, k, k_pad, amax, codes,
                                         scale, s);
}

// y rounded to O, then the ReLU (as F.relu after the cast: a NaN stays
// NaN, a -0 stays -0)
template <typename O, bool RELU>
__device__ __forceinline__ O finish(float y) {
  if constexpr (sizeof(O) == sizeof(float)) {
    return RELU && y < 0.f ? 0.f : y;
  } else {
    const __nv_bfloat16 o = __float2bfloat16_rn(y);
    return RELU && __bfloat162float(o) < 0.f ? __float2bfloat16_rn(0.f) : o;
  }
}

template <typename O, bool BIAS, bool RELU>
__global__ void __launch_bounds__(EPILOGUE_THREADS)
int8_epilogue_kernel(const int* __restrict__ acc, int m, int n_pad, int n,
                     const float* __restrict__ x_scale,
                     const float* __restrict__ w_scale,
                     const float* __restrict__ bias, O* __restrict__ out,
                     int ld_out, int vec_out) {
  const unsigned groups = static_cast<unsigned>(n_pad) / 4u;
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= static_cast<unsigned>(m) * groups) return;
  const unsigned row = i / groups;
  const int c = static_cast<int>(i - row * groups) * 4;
  if (c >= n) return;  // padding columns only
  const int4 a = __ldcs(reinterpret_cast<const int4*>(acc + (size_t)row *
                                                            n_pad + c));
  const float4 ws = *reinterpret_cast<const float4*>(w_scale + c);
  const float xs = x_scale[row];
  const int av[4] = {a.x, a.y, a.z, a.w};
  const float wv[4] = {ws.x, ws.y, ws.z, ws.w};
  float bv[4] = {0.f, 0.f, 0.f, 0.f};
  if (BIAS) {
    const float4 b = *reinterpret_cast<const float4*>(bias + c);
    bv[0] = b.x; bv[1] = b.y; bv[2] = b.z; bv[3] = b.w;
  }
  struct alignas(4 * sizeof(O)) Row4 { O v[4]; } y;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float sc = __fmul_rn(xs, wv[e]);
    const float af = __int2float_rn(av[e]);
    y.v[e] = finish<O, RELU>(BIAS ? __fmaf_rn(af, sc, bv[e])
                                  : __fmul_rn(af, sc));
  }
  O* dst = out + (size_t)row * ld_out + c;
  if (vec_out && c + 4 <= n) {
    *reinterpret_cast<Row4*>(dst) = y;
  } else {
    for (int e = 0; e < 4 && c + e < n; ++e) dst[e] = y.v[e];
  }
}

template <typename O, bool BIAS, bool RELU>
cudaError_t launch_epilogue(const int* acc, int m, int n_pad, int n,
                            const float* x_scale, const float* w_scale,
                            const float* bias, void* out, int ld_out,
                            cudaStream_t s) {
  O* o = static_cast<O*>(out);
  const int vec_out = reinterpret_cast<uintptr_t>(o) % (4 * sizeof(O)) == 0
                      && ld_out % 4 == 0;
  const size_t threads = (size_t)m * (n_pad / 4);
  const unsigned blocks = static_cast<unsigned>(
      (threads + EPILOGUE_THREADS - 1) / EPILOGUE_THREADS);
  int8_epilogue_kernel<O, BIAS, RELU><<<blocks, EPILOGUE_THREADS, 0, s>>>(
      acc, m, n_pad, n, x_scale, w_scale, bias, o, ld_out, vec_out);
  return cudaGetLastError();
}

template <typename O>
cudaError_t epilogue(int relu, const int* acc, int m, int n_pad, int n,
                     const float* x_scale, const float* w_scale,
                     const float* bias, void* out, int ld_out,
                     cudaStream_t s) {
  if (bias != nullptr)
    return relu ? launch_epilogue<O, true, true>(acc, m, n_pad, n, x_scale,
                                                 w_scale, bias, out, ld_out, s)
                : launch_epilogue<O, true, false>(acc, m, n_pad, n, x_scale,
                                                  w_scale, bias, out, ld_out,
                                                  s);
  return relu ? launch_epilogue<O, false, true>(acc, m, n_pad, n, x_scale,
                                                w_scale, bias, out, ld_out, s)
              : launch_epilogue<O, false, false>(acc, m, n_pad, n, x_scale,
                                                 w_scale, bias, out, ld_out,
                                                 s);
}

cudaError_t attrs_of(const void* fn, int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return e;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = a.maxThreadsPerBlock;
  return cudaSuccess;
}

}  // namespace mpn_head

// Row quantize of x (m, k), bf16 (is_bf16) or float32, rows ld_x elements
// apart, into codes (m, k_pad) int8 (row-major, the pad columns zero) and
// scale (m,) float32; amax (m,) float32 or null (each row's own).
extern "C" int mpn_quantize_rows(int is_bf16, int m, int k, int ld_x,
                                 int k_pad, const void* x, const float* amax,
                                 signed char* codes, float* scale,
                                 void* stream) {
  using namespace mpn_head;
  if (m <= 0 || k <= 0 || ld_x < k || k_pad < k)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? quantize<__nv_bfloat16>(x, ld_x, m, k, k_pad, amax, codes,
                                        scale, s)
              : quantize<float>(x, ld_x, m, k, k_pad, amax, codes, scale, s));
}

// Epilogue of acc (m, n_pad) int32 (row-major, n_pad % 4 == 0, 16-byte
// aligned) with x_scale (m,), w_scale (n_pad,) and bias (n_pad,) or null,
// all float32: the first n columns into out, bf16 (out_bf16) or float32,
// rows ld_out elements apart; relu != 0 applies the ReLU.
extern "C" int mpn_int8_epilogue(int out_bf16, int relu, int m, int n_pad,
                                 int n, int ld_out, const int* acc,
                                 const float* x_scale, const float* w_scale,
                                 const float* bias, void* out, void* stream) {
  using namespace mpn_head;
  if (m <= 0 || n <= 0 || n > n_pad || n_pad % 4 || ld_out < n ||
      (size_t)m * (n_pad / 4) > 0x7fffffffu)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      out_bf16 ? epilogue<__nv_bfloat16>(relu, acc, m, n_pad, n, x_scale,
                                         w_scale, bias, out, ld_out, s)
               : epilogue<float>(relu, acc, m, n_pad, n, x_scale, w_scale,
                                 bias, out, ld_out, s));
}

// Attributes into out[4] (registers per thread, local bytes per thread,
// static shared bytes, max threads per block) of the bf16 instances the
// serving head runs: kernel 0 the epilogue with bias and ReLU, kernel 1
// the 16-byte quantize holding nv loads a thread (1, 2, 4 or 8).
extern "C" int mpn_int8_head_attrs(int kernel, int nv, int* out) {
  using namespace mpn_head;
  using B = __nv_bfloat16;
  const void* fn = nullptr;
  if (kernel == 0) {
    fn = reinterpret_cast<const void*>(&int8_epilogue_kernel<B, true, true>);
  } else if (kernel == 1) {
    switch (nv) {
      case 1: fn = reinterpret_cast<const void*>(
                  &quantize_rows_kernel<B, uint4, 1>); break;
      case 2: fn = reinterpret_cast<const void*>(
                  &quantize_rows_kernel<B, uint4, 2>); break;
      case 4: fn = reinterpret_cast<const void*>(
                  &quantize_rows_kernel<B, uint4, 4>); break;
      case 8: fn = reinterpret_cast<const void*>(
                  &quantize_rows_kernel<B, uint4, 8>); break;
      default: break;
    }
  }
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(attrs_of(fn, out));
}
