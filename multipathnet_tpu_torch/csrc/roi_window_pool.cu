// ROI window pooling for Hopper (sm_90a): the CUDA port of the three Pallas
// pool kernels, with the int8 epilogue of two of them. This file holds the
// C entry points, which route every bfloat16 launch to the tensor-core body
// (roi_window_pool_wgmma.cu) and every float32 launch to the CUDA-core body
// below.
//
//   window_pool_multi (K1) replaces _multi_window_pool_kernel /
//     pallas_window_pool_multi in multipathnet_tpu/ops/roi_pallas.py:
//     the 1x view pooled over c3 + c4 + c5, the level sum folded into one
//     accumulator per view.
//   resident_pool (K2) replaces _resident_pool_kernel /
//     pallas_resident_pool in the same file: the 1.5x/2x/4x context views
//     pooled over each image's c5 pyramid.
//   window_pool (K5) replaces _window_pool_kernel / pallas_window_pool in
//     the same file: one level at absolute rows, which is exactly K1's
//     function at L = 1, so ops/roi_pool.window_pool launches K1's bodies
//     at one level through mpn_window_pool_multi (no third body).
//   With a skip bias given, either one also runs the int8 epilogue of its
//   Pallas kernel (the quant_bias branches, roi_pallas.py:536 and :977,
//   both calling _quant_view, roi_pallas.py:228): bias + ReLU and one
//   per-view int8 quantization, the input of the int8 serving head.
//
// What it computes. Per view n and level l, a WIN_Y x WIN_X (10 x 16)
// window win_l at (row0_l, x0_l) of level l's stacked avg pyramid, and the
// folded bilinear weights wy_l (G x 10) and wx_l (G x 16), G bins a side,
// 1 <= G <= 7 (the Pallas kernels take every G with G + 3 <= 10; the
// detector's default is 7, AlexNet-family heads take 6):
//     out[i][j][c] = sum_l sum_y sum_x W2_l[i][j][y][x] * win_l[y][x][c]
//     W2_l[i][j][y][x] = round_T(wy_l[i][y] * wx_l[j][x])
// Every G reads the same 10 x 16 window: a G-bin view's samples need G + 3
// rows, and the pyramids give every level at least 10 rows, so the window
// of a coarse level shorter than that stays inside its buffer.
// The Pallas kernels build W2 (G^2 x 160) in float32, round it once to the
// pyramid dtype T (roi_pallas.py:156, :534, :975) and run ONE GEMM per view
// with float32 accumulation. In float32 the rounding is a no-op and the sum
// may be taken in any order; in bf16 it is not, and the bf16 body computes
// W2 exactly so, on the tensor cores.
//
// The float32 body: the contraction evaluated separably in float32 on the
// CUDA cores, x first,
//     tmp[j]     = sum_x wx[j][x] * win[y][x][c]       (16 * G FMA per row y)
//     out[i][j] += wy[i][y] * tmp[j]                   (G * G FMA per row y)
// 1610 FMA per channel per level at G = 7 (10 x (16 G + G^2)) instead of
// 49 * 160 = 7840 for the W2 form
// (TF32 tensor cores would round the windows). Without the epilogue, one
// thread block per (view, 128-channel slice); each of its 64 threads owns 2
// adjacent channels, so every load of win[y][x][c..c+1] is one 8-byte
// access, and a warp reads 512 contiguous bytes of an NHWC cell. The block
// stages the view's wy/wx rows, transposed and padded to 8, in shared
// memory (832 bytes per level); the window itself is read straight from
// global memory into registers, because each element is used by exactly
// one thread. The G^2 x 2 accumulators stay in registers, so G is a
// template parameter, one instance per G; one store of the view's (G^2, C)
// output closes the block. The G = 7 instances use about 255 registers at
// 8 warps per SM; they are bounded by their per-view body (PERF.md).
//
// The int8 epilogue. _quant_view's scale is ONE absolute max over a whole
// view's G^2 * C values, so in quant mode one block owns a whole view: C / 2
// threads (256 at C = 512, so C <= 512), each still owning 2 channels and
// accumulating in exactly the order of the instance without the epilogue.
// Then, from the registers that hold the accumulators:
//   y = relu(acc + bias)                            (float32, the pyramid
//       dtype, which is also the head's)
//   amax = block-wide max of y (warp shuffles, then shared memory)
//   s = max(amax * float32(1/127), 1e-12)         (__fmul_rn, not amax/127)
//   q = clip(rint(y / s), -127, 127)                (y / s the IEEE
//       quotient, div_rn in roi_window_pool.cuh; rint rounds half to even,
//       as jnp.round / torch.round; roundf would not)
// and one store of int8 pairs per thread plus one float32 scale per view.
// The pooled tensor is never written. The build keeps --use_fast_math off:
// the epilogue must match its plain version (ops/roi_pool.quant_view_ref)
// bit for bit. Wider views (C > 512, in either dtype; the bf16 body's
// epilogue also takes one 512-channel tile) go in two launches: the pool
// without the epilogue into the pyramid dtype, then quant_view_kernel
// below over its output, with the same arithmetic: exact, at the price of
// writing and reading the pooled tensor once.
//
// A view whose window would fall outside its level's buffer (never
// produced by view_geometry, which clamps) is not read: its output is NaN,
// or with the epilogue zero codes and a NaN scale. A view whose y holds a
// NaN (a NaN in its windows: features NaN upstream) gets the epilogue's
// zero codes and NaN scale too, as quant_view_ref gives it: the ReLU and
// the max keep a NaN (fmax_nan), where fmaxf would drop it.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "roi_window_pool.cuh"

namespace mpn {
namespace {

constexpr int VEC = 2;                    // channels per thread
constexpr int THREADS = 64;               // threads per block
constexpr int SLICE = THREADS * VEC;      // channels per block
constexpr int QUANT_THREADS = 256;        // most threads of a quant block

// _quant_view's y in float32: the pool result plus the bias, then ReLU
// (a NaN stays NaN, as jnp.maximum and torch.relu keep it)
__device__ __forceinline__ float biased_relu(float acc, float bias) {
  return fmax_nan(acc + bias, 0.f);
}

// clip(rint(y / s), -127, 127), y / s as div_rn; rint rounds half to even,
// as jnp.round and torch.round do
__device__ __forceinline__ signed char quantize(float y, float s, float r) {
  return static_cast<signed char>(
      fminf(fmaxf(rintf(div_rn(y, s, r)), -127.f), 127.f));
}

template <int G, int L, bool QUANT>
__global__ void __launch_bounds__(QUANT ? QUANT_THREADS : THREADS)
window_pool_kernel(const PoolParams p) {
  __shared__ __align__(16) float s_wy[L][WIN_Y][GP];  // [level][y][i]
  __shared__ __align__(16) float s_wx[L][WIN_X][GP];  // [level][x][j]

  const int n = blockIdx.x;
  const int nthreads = QUANT ? blockDim.x : THREADS;
  const int c = (blockIdx.y * nthreads + threadIdx.x) * VEC;

  for (int t = threadIdx.x; t < L * WIN_Y * GP; t += nthreads) {
    const int l = t / (WIN_Y * GP), y = (t / GP) % WIN_Y, i = t % GP;
    s_wy[l][y][i] = i < G
        ? p.wy[(((size_t)l * p.n_views + n) * G + i) * WIN_Y + y] : 0.f;
  }
  for (int t = threadIdx.x; t < L * WIN_X * GP; t += nthreads) {
    const int l = t / (WIN_X * GP), x = (t / GP) % WIN_X, j = t % GP;
    s_wx[l][x][j] = j < G
        ? p.wx[(((size_t)l * p.n_views + n) * G + j) * WIN_X + x] : 0.f;
  }
  __syncthreads();
  const bool active = c < p.channels;
  if (!QUANT && !active) return;
  // a quant block's idle lanes (C / 2 rounded up to whole warps) pool
  // channel 0 and take part in the block's max with 0
  const int cl = active ? c : 0;

  float acc[G][G][VEC];
#pragma unroll
  for (int i = 0; i < G; ++i)
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[i][j][v] = 0.f;

  const int img_row = (n / p.views_per_image) * p.rows_per_image;
  bool in_bounds = true;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int r0 = p.row0[(size_t)l * p.n_views + n];
    const int x0 = p.x0[(size_t)l * p.n_views + n];
    if (!window_inside(p, l, r0, x0)) {
      in_bounds = false;
      continue;
    }
    const size_t cell = (size_t)p.channels;
    const size_t row_stride = (size_t)p.wmax[l] * cell;
    const float* base = static_cast<const float*>(p.flat[l]) +
                        ((size_t)(img_row + r0) * p.wmax[l] + x0) * cell + cl;
#pragma unroll 1
    for (int y = 0; y < WIN_Y; ++y) {
      const float* row = base + y * row_stride;
      float tmp[G][VEC];
#pragma unroll
      for (int j = 0; j < G; ++j) tmp[j][0] = tmp[j][1] = 0.f;
#pragma unroll
      for (int x = 0; x < WIN_X; ++x) {
        const float2 v = *reinterpret_cast<const float2*>(row + x * cell);
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const float w = s_wx[l][x][j];
          tmp[j][0] = fmaf(w, v.x, tmp[j][0]);
          tmp[j][1] = fmaf(w, v.y, tmp[j][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const float w = s_wy[l][y][i];
#pragma unroll
        for (int j = 0; j < G; ++j) {
          acc[i][j][0] = fmaf(w, tmp[j][0], acc[i][j][0]);
          acc[i][j][1] = fmaf(w, tmp[j][1], acc[i][j][1]);
        }
      }
    }
  }

  if constexpr (QUANT) {
    __shared__ float s_max[QUANT_THREADS / 32];
    const float2 b =
        *reinterpret_cast<const float2*>(static_cast<const float*>(p.bias) +
                                         cl);
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int j = 0; j < G; ++j) {
        acc[i][j][0] = biased_relu(acc[i][j][0], b.x);
        acc[i][j][1] = biased_relu(acc[i][j][1], b.y);
        m = fmax_nan(m, fmax_nan(acc[i][j][0], acc[i][j][1]));
      }
    if (!active) m = 0.f;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmax_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) s_max[warp] = m;
    __syncthreads();
    if (warp == 0) {
      m = lane < (int)(blockDim.x >> 5) ? s_max[lane] : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fmax_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (lane == 0) s_max[0] = m;
    }
    __syncthreads();
    const float amax = s_max[0];
    const float s = view_scale(amax);
    // a NaN max (a NaN in the view's y): zero codes and a NaN scale
    const bool finite = in_bounds && !isnan(amax);
    if (threadIdx.x == 0) p.scale[n] = finite ? s : NAN;
    if (!active) return;
    const float r = view_reciprocal(s);
    signed char* out = static_cast<signed char*>(p.out) +
                       (size_t)n * G * G * p.channels + c;
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int j = 0; j < G; ++j) {
        char2 q = make_char2(0, 0);
        if (finite) {
          q.x = quantize(acc[i][j][0], s, r);
          q.y = quantize(acc[i][j][1], s, r);
        }
        *reinterpret_cast<char2*>(out + (size_t)(i * G + j) * p.channels) =
            q;
      }
  } else {
    float* out = static_cast<float*>(p.out) + (size_t)n * G * G * p.channels
                 + c;
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int j = 0; j < G; ++j)
        *reinterpret_cast<float2*>(out + (size_t)(i * G + j) * p.channels) =
            in_bounds ? make_float2(acc[i][j][0], acc[i][j][1])
                      : make_float2(NAN, NAN);
  }
}

// The int8 epilogue as a kernel of its own, for views wider than a pool
// block takes (C > 512): one block per view reads the pool kernel's
// (G^2, C) output in the pyramid dtype T twice, first for the amax of y =
// relu(pooled + bias) (the sum rounded to T, as quant_view_ref computes it
// in torch), then for the codes, in the arithmetic of the fused epilogue.
// A view whose pooled values hold a NaN (the pool kernels' out-of-range
// window) gets zero codes and a NaN scale, as the fused epilogue gives it.
__device__ __forceinline__ float biased_value(float v, float b) {
  return v + b;
}

__device__ __forceinline__ float biased_value(__nv_bfloat16 v,
                                              __nv_bfloat16 b) {
  return __bfloat162float(__float2bfloat16_rn(__bfloat162float(v) +
                                              __bfloat162float(b)));
}

constexpr int EPILOGUE_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(EPILOGUE_THREADS)
quant_view_kernel(const T* pooled, const T* bias, int g, int channels,
                  signed char* out, float* scale) {
  __shared__ float s_max[EPILOGUE_THREADS / 32];
  const int n = blockIdx.x;
  const int per_view = g * g * channels;
  const T* src = pooled + (size_t)n * per_view;
  float m = 0.f;
  int has_nan = 0;
  for (int k = threadIdx.x; k < per_view; k += EPILOGUE_THREADS) {
    const float y = biased_value(src[k], bias[k % channels]);
    has_nan |= y != y;
    m = fmaxf(m, y);
  }
  has_nan = __syncthreads_or(has_nan);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) s_max[warp] = m;
  __syncthreads();
  m = 0.f;
#pragma unroll
  for (int w = 0; w < EPILOGUE_THREADS / 32; ++w) m = fmaxf(m, s_max[w]);
  const float s = view_scale(m);
  if (threadIdx.x == 0) scale[n] = has_nan ? NAN : s;
  const float r = view_reciprocal(s);
  signed char* dst = out + (size_t)n * per_view;
  for (int k = threadIdx.x; k < per_view; k += EPILOGUE_THREADS)
    dst[k] = has_nan ? 0
                 : quantize(fmaxf(biased_value(src[k], bias[k % channels]),
                                  0.f),
                            s, r);
}

template <int G, int L>
cudaError_t launch_levels(const PoolParams& p, cudaStream_t stream) {
  if (p.bias != nullptr) {
    const int threads = ((p.channels / VEC + 31) / 32) * 32;
    if (threads > QUANT_THREADS || p.scale == nullptr)
      return cudaErrorInvalidValue;
    window_pool_kernel<G, L, true><<<p.n_views, threads, 0, stream>>>(p);
  } else {
    const dim3 grid(p.n_views, (p.channels + SLICE - 1) / SLICE);
    window_pool_kernel<G, L, false><<<grid, THREADS, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_f32(const PoolParams& p, int n_levels, cudaStream_t s) {
  switch (n_levels) {
    case 1: return launch_levels<G, 1>(p, s);
    case 2: return launch_levels<G, 2>(p, s);
    case 3: return launch_levels<G, 3>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(const PoolParams& p, int is_bf16, int n_levels,
                     void* stream) {
  if (p.n_views <= 0 || p.channels <= 0 || p.channels % VEC != 0 ||
      p.views_per_image <= 0 || p.g < 1 || p.g > G_MAX)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_wgmma_pool(p, n_levels, s);
  switch (p.g) {
    case 1: return launch_f32<1>(p, n_levels, s);
    case 2: return launch_f32<2>(p, n_levels, s);
    case 3: return launch_f32<3>(p, n_levels, s);
    case 4: return launch_f32<4>(p, n_levels, s);
    case 5: return launch_f32<5>(p, n_levels, s);
    case 6: return launch_f32<6>(p, n_levels, s);
    case 7: return launch_f32<7>(p, n_levels, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int G, int L, bool QUANT>
cudaError_t attrs(int* out) {
  cudaFuncAttributes a;
  const cudaError_t e =
      cudaFuncGetAttributes(&a, window_pool_kernel<G, L, QUANT>);
  if (e != cudaSuccess) return e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = 0;
  out[4] = a.maxThreadsPerBlock;
  return cudaSuccess;
}

template <int G>
cudaError_t f32_attrs(int n_levels, int quant, int* out) {
  switch (n_levels * 2 + (quant ? 1 : 0)) {
    case 2: return attrs<G, 1, false>(out);
    case 3: return attrs<G, 1, true>(out);
    case 4: return attrs<G, 2, false>(out);
    case 5: return attrs<G, 2, true>(out);
    case 6: return attrs<G, 3, false>(out);
    case 7: return attrs<G, 3, true>(out);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace mpn

using mpn::PoolParams;

// K1: level-summed pooling, rows absolute in each level's stacked buffer,
// g bins a side (1..7; wy (n_levels, n_views, g, 10), wx (.., g, 16)).
// bias == NULL: out is (n_views, g, g, channels) in the pyramid dtype;
// otherwise the int8 epilogue: out int8, scale (n_views,) float32.
extern "C" int mpn_window_pool_multi(
    int is_bf16, int g, int n_levels, int n_views, int channels,
    const void* flat0, const void* flat1, const void* flat2,
    int rows0, int rows1, int rows2, int wmax0, int wmax1, int wmax2,
    const int* row0, const int* x0, const float* wy, const float* wx,
    const void* bias, void* out, float* scale, void* stream) {
  PoolParams p;
  p.flat[0] = flat0; p.flat[1] = flat1; p.flat[2] = flat2;
  p.rows[0] = rows0; p.rows[1] = rows1; p.rows[2] = rows2;
  p.wmax[0] = wmax0; p.wmax[1] = wmax1; p.wmax[2] = wmax2;
  p.row0 = row0; p.x0 = x0; p.wy = wy; p.wx = wx; p.out = out;
  p.bias = bias; p.scale = scale;
  p.n_views = n_views;
  p.channels = channels;
  p.g = g;
  p.views_per_image = n_views;
  p.rows_per_image = 0;
  return static_cast<int>(mpn::dispatch(p, is_bf16, n_levels, stream));
}

// K2: one level, image-relative rows into a batch of per-image pyramids,
// views image-major (n = image * views + v); g, bias, out and scale as K1's.
extern "C" int mpn_resident_pool(
    int is_bf16, int g, int batch, int views, int rows, int wmax,
    int channels,
    const void* flat, const int* row0, const int* x0, const float* wy,
    const float* wx, const void* bias, void* out, float* scale,
    void* stream) {
  PoolParams p;
  p.flat[0] = flat; p.flat[1] = nullptr; p.flat[2] = nullptr;
  p.rows[0] = rows; p.rows[1] = 0; p.rows[2] = 0;
  p.wmax[0] = wmax; p.wmax[1] = 0; p.wmax[2] = 0;
  p.row0 = row0; p.x0 = x0; p.wy = wy; p.wx = wx; p.out = out;
  p.bias = bias; p.scale = scale;
  p.n_views = batch * views;
  p.channels = channels;
  p.g = g;
  p.views_per_image = views;
  p.rows_per_image = rows;
  return static_cast<int>(mpn::dispatch(p, is_bf16, 1, stream));
}

// The int8 epilogue of n_views pooled (g, g, channels) views in the
// pyramid dtype (is_bf16: bf16, else float32) with the (channels,) skip
// bias: out int8 (n_views, g, g, channels), scale (n_views,) float32.
extern "C" int mpn_quant_view(int is_bf16, int g, int n_views, int channels,
                              const void* pooled, const void* bias,
                              signed char* out, float* scale, void* stream) {
  if (n_views <= 0 || channels <= 0 || g < 1 || g > mpn::G_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    mpn::quant_view_kernel<__nv_bfloat16>
        <<<n_views, mpn::EPILOGUE_THREADS, 0, s>>>(
            static_cast<const __nv_bfloat16*>(pooled),
            static_cast<const __nv_bfloat16*>(bias), g, channels, out,
            scale);
  else
    mpn::quant_view_kernel<float><<<n_views, mpn::EPILOGUE_THREADS, 0, s>>>(
        static_cast<const float*>(pooled), static_cast<const float*>(bias),
        g, channels, out, scale);
  return static_cast<int>(cudaGetLastError());
}

// The attributes of the pool instance for (dtype, G, levels, epilogue) into
// out[5]: registers per thread, local (spill) bytes per thread, static
// shared bytes, the dynamic shared bytes it launches with, max threads per
// block. The bf16 body is one instance for every G.
extern "C" int mpn_pool_kernel_attrs(int is_bf16, int g, int n_levels,
                                     int quant, int* out) {
  if (g < 1 || g > mpn::G_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16) return static_cast<int>(mpn::wgmma_pool_attrs(n_levels,
                                                              quant, out));
  switch (g) {
    case 1: return static_cast<int>(mpn::f32_attrs<1>(n_levels, quant, out));
    case 2: return static_cast<int>(mpn::f32_attrs<2>(n_levels, quant, out));
    case 3: return static_cast<int>(mpn::f32_attrs<3>(n_levels, quant, out));
    case 4: return static_cast<int>(mpn::f32_attrs<4>(n_levels, quant, out));
    case 5: return static_cast<int>(mpn::f32_attrs<5>(n_levels, quant, out));
    case 6: return static_cast<int>(mpn::f32_attrs<6>(n_levels, quant, out));
    default: return static_cast<int>(mpn::f32_attrs<7>(n_levels, quant, out));
  }
}
