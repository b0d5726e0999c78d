// ROI window pooling for Hopper (sm_90a): the CUDA port of the three Pallas
// pool kernels, with the int8 epilogue of two of them.
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
//     function at L = 1, so ops/roi_pool.window_pool launches
//     window_pool_kernel<T, 1, false> through mpn_window_pool_multi with one
//     level (no second body). One difference from the TPU kernel: it rounds
//     the combined weights W2 = wy (x) wx to the pyramid dtype before its
//     GEMM (roi_pallas.py:156), while this body keeps float32 weights; so
//     in bf16 K5 is held against its plain version, not against the TPU's
//     rounding.
//   With a skip bias given, either one also runs the int8 epilogue of its
//   Pallas kernel (the quant_bias branches, roi_pallas.py:536 and :977,
//   both calling _quant_view, roi_pallas.py:228): bias + ReLU and one
//   per-view int8 quantization, the input of the int8 serving head.
//
// What it computes. Per view n and level l, a WIN_Y x WIN_X (10 x 16)
// window win_l at (row0_l, x0_l) of level l's stacked avg pyramid, and the
// folded bilinear weights wy_l (G x 10) and wx_l (G x 16), G = 7:
//     out[i][j][c] = sum_l sum_y sum_x wy_l[i][y] * wx_l[j][x] * win_l[y][x][c]
// The Pallas kernels rebuild W2 = wy (x) wx (49 x 160) with 0/1 matmuls and
// run ONE GEMM per view, because the TPU's matrix unit wastes M=7/K=10
// shapes. Here there is no matrix unit in the loop: the contraction is
// evaluated separably in float32 on the CUDA cores, x first,
//     tmp[j]     = sum_x wx[j][x] * win[y][x][c]       (16 * 7 FMA per row y)
//     out[i][j] += wy[i][y] * tmp[j]                   (7 * 7 FMA per row y)
// 1610 FMA per channel per level instead of 49 * 160 = 7840 for the W2 form.
//
// Layout. Without the epilogue, one thread block per (view, 128-channel
// slice); each of its 64 threads owns 2 adjacent channels, so every load of
// win[y][x][c..c+1] is one 4-byte (bf16) or 8-byte (f32) access, and a warp
// reads 256 or 512 contiguous bytes of an NHWC cell: coalesced along C. The
// block stages the view's wy/wx rows, transposed and padded to 8, in shared
// memory (832 bytes per level); the window itself is read straight from
// global memory into registers, because each element is used by exactly
// one thread. The 49 x 2 accumulators stay in registers; one bf16 (or f32)
// store of the view's (49, C) output closes the block.
//
// The int8 epilogue. _quant_view's scale is ONE absolute max over a whole
// view's 49 * C values, so in quant mode one block owns a whole view: C / 2
// threads (256 at C = 512, so C <= 512), each still owning 2 channels and
// accumulating in exactly the order of the instance without the epilogue.
// Then, from the registers that hold the accumulators:
//   y = relu(round_T(float(round_T(acc)) + bias))   (T: pyramid dtype, which
//       is also the head's; one float32 add, one rounding to T)
//   amax = block-wide max of y (warp shuffles, then shared memory)
//   s = max(amax * float32(1/127), 1e-12)         (__fmul_rn, not amax/127)
//   q = clip(rint(y / s), -127, 127)                (y / s the IEEE
//       quotient, see quantize(); rint rounds half to even, as jnp.round /
//       torch.round; roundf would not)
// and one store of int8 pairs per thread plus one float32 scale per view.
// The bf16 pooled tensor is never written. A scale taken across blocks
// (atomics, a second pass) would have to write it; so it is not done. The
// build keeps --use_fast_math off: the epilogue must match its plain version
// (ops/roi_pool.quant_view_ref) bit for bit.
//
// What bounds it. Bytes: every view reads L * 160 * C elements (at C = 512
// in bf16: 160 KB per level) and writes 49 * C. FLOPs: 2 * 1610 * C per
// level. At the main path (8 images x 1000 proposals, 640^2):
//   K1: 8000 views x 3 levels: 3.9 GB of window reads, 0.4 GB written
//       (0.2 GB of int8 with the epilogue), 40 GFLOP of f32 FMA. The c3
//       pyramid alone is 0.42 GB, far beyond the 50 MB L2, so K1 is bounded
//       by HBM reads of the windows (neighbouring ROIs of one image share
//       cells, which L2 catches).
//   K2: 8 x 3000 views x 1 level: 3.9 GB of window reads, 1.2 GB written
//       (0.6 GB of int8), 40 GFLOP. The Pallas kernel kept each image's
//       whole c5 pyramid in VMEM; that does not carry over (3.3 MB per image
//       against 227 KB of shared memory). What does: all 8 images' c5
//       pyramids (26 MB) sit in the 50 MB L2, so K2's window reads are L2
//       hits once warm. Views are launched image-major (blockIdx.x = view,
//       views grouped by image), so an image's views run together. K2 is
//       bounded by L2 bandwidth and the FMA rate, and its output write goes
//       to HBM.
//   K5 (chip_smoke's phase 11: the same 8000 1x views over c3 alone): 1.3
//       GB of window reads out of the 0.42 GB c3 pyramid, 0.4 GB written,
//       13 GFLOP; bounded like K1, by HBM reads, at a third of its work.
// The epilogue halves the write and adds about 5 operations per output
// element; the reads and the FMA, which bound both kernels, are unchanged.
// A quant block of 256 threads at 255 registers fills one SM's register
// file, 8 warps per SM: the occupancy of the instance without it.
// No wgmma, TMA or cp.async yet: a later pass can stage windows through a
// shared-memory ring and run the W2 product on the tensor cores.
//
// A view whose window would fall outside its level's buffer (never
// produced by view_geometry, which clamps) is not read: its output is NaN,
// or with the epilogue zero codes and a NaN scale.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int G = 7;
constexpr int WIN_Y = 10;
constexpr int WIN_X = 16;
constexpr int VEC = 2;                    // channels per thread
constexpr int THREADS = 64;               // threads per block
constexpr int SLICE = THREADS * VEC;      // channels per block
constexpr int QUANT_THREADS = 256;        // most threads of a quant block
constexpr int MAX_LEVELS = 3;
constexpr int GP = 8;                     // G padded for 16-byte smem reads

struct PoolParams {
  const void* flat[MAX_LEVELS];  // level l: (.., wmax[l], channels)
  int rows[MAX_LEVELS];          // rows a window may span (per image in K2)
  int wmax[MAX_LEVELS];
  const int* row0;    // (L, n_views) rows within the image's pyramid
  const int* x0;      // (L, n_views)
  const float* wy;    // (L, n_views, G, WIN_Y)
  const float* wx;    // (L, n_views, G, WIN_X)
  void* out;          // (n_views, G, G, channels): T, or int8 in quant mode
  const void* bias;   // (channels,) T skip bias: quant mode when non-null
  float* scale;       // (n_views,) quant mode's per-view scales
  int n_views;
  int channels;
  // view n reads rows (n / views_per_image) * rows_per_image + row0:
  // K2's image-relative rows; K1 passes rows_per_image = 0.
  int views_per_image;
  int rows_per_image;
};

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// x rounded to nearest even in T, returned as float
__device__ __forceinline__ float round_to(float x, float*) { return x; }

__device__ __forceinline__ float round_to(float x, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// _quant_view's y: the pool result in T, plus the bias in float32 rounded
// once to T, then ReLU
template <typename T>
__device__ __forceinline__ float biased_relu(float acc, float bias) {
  const float y = round_to(round_to(acc, (T*)nullptr) + bias, (T*)nullptr);
  return fmaxf(y, 0.f);
}

// clip(rint(y / s), -127, 127) with y / s the IEEE quotient (div.rn), r
// = __frcp_rn(s). The quotient is taken as y * r and divided for real only
// where y * r lies within 1e-4 of a half-integer: both are below 128 and
// within 2.3e-5 of each other (2^-23 and 2^-24 relative), so elsewhere
// they round to the same integer. The IEEE division is a subroutine call at
// 255 registers; one per element made the quant K2 1.9x slower on an H100.
__device__ __forceinline__ signed char quantize(float y, float s, float r) {
  const float t = __fmul_rn(y, r);
  float q = rintf(t);
  if (fabsf(fabsf(t - q) - 0.5f) < 1e-4f) q = rintf(__fdiv_rn(y, s));
  return static_cast<signed char>(fminf(fmaxf(q, -127.f), 127.f));
}

template <typename T, int L, bool QUANT>
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
    if (r0 < 0 || r0 + WIN_Y > p.rows[l] || x0 < 0 ||
        x0 + WIN_X > p.wmax[l]) {
      in_bounds = false;
      continue;
    }
    const size_t cell = (size_t)p.channels;
    const size_t row_stride = (size_t)p.wmax[l] * cell;
    const T* base = static_cast<const T*>(p.flat[l]) +
                    ((size_t)(img_row + r0) * p.wmax[l] + x0) * cell + cl;
#pragma unroll 1
    for (int y = 0; y < WIN_Y; ++y) {
      const T* row = base + y * row_stride;
      float tmp[G][VEC];
#pragma unroll
      for (int j = 0; j < G; ++j) tmp[j][0] = tmp[j][1] = 0.f;
#pragma unroll
      for (int x = 0; x < WIN_X; ++x) {
        const float2 v = load2(row + x * cell);
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
    const float2 b = load2(static_cast<const T*>(p.bias) + cl);
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int j = 0; j < G; ++j) {
        acc[i][j][0] = biased_relu<T>(acc[i][j][0], b.x);
        acc[i][j][1] = biased_relu<T>(acc[i][j][1], b.y);
        m = fmaxf(m, fmaxf(acc[i][j][0], acc[i][j][1]));
      }
    if (!active) m = 0.f;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) s_max[warp] = m;
    __syncthreads();
    if (warp == 0) {
      m = lane < (int)(blockDim.x >> 5) ? s_max[lane] : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (lane == 0) s_max[0] = m;
    }
    __syncthreads();
    // 0x1.020408p-7f is float32(1/127), the reference's jnp.float32(1/127)
    const float s = fmaxf(__fmul_rn(s_max[0], 0x1.020408p-7f), 1e-12f);
    if (threadIdx.x == 0) p.scale[n] = in_bounds ? s : NAN;
    if (!active) return;
    const float r = __frcp_rn(s);
    signed char* out = static_cast<signed char*>(p.out) +
                       (size_t)n * G * G * p.channels + c;
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int j = 0; j < G; ++j) {
        char2 q = make_char2(0, 0);
        if (in_bounds) {
          q.x = quantize(acc[i][j][0], s, r);
          q.y = quantize(acc[i][j][1], s, r);
        }
        *reinterpret_cast<char2*>(out + (size_t)(i * G + j) * p.channels) =
            q;
      }
  } else {
    T* out = static_cast<T*>(p.out) + (size_t)n * G * G * p.channels + c;
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const float a = in_bounds ? acc[i][j][0] : NAN;
        const float b = in_bounds ? acc[i][j][1] : NAN;
        store2(out + (size_t)(i * G + j) * p.channels, a, b);
      }
  }
}

template <typename T, int L>
cudaError_t launch_levels(const PoolParams& p, cudaStream_t stream) {
  if (p.bias != nullptr) {
    const int threads = ((p.channels / VEC + 31) / 32) * 32;
    if (threads > QUANT_THREADS || p.scale == nullptr)
      return cudaErrorInvalidValue;
    window_pool_kernel<T, L, true><<<p.n_views, threads, 0, stream>>>(p);
  } else {
    const dim3 grid(p.n_views, (p.channels + SLICE - 1) / SLICE);
    window_pool_kernel<T, L, false><<<grid, THREADS, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const PoolParams& p, int n_levels, cudaStream_t stream) {
  switch (n_levels) {
    case 1: return launch_levels<T, 1>(p, stream);
    case 2: return launch_levels<T, 2>(p, stream);
    case 3: return launch_levels<T, 3>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(const PoolParams& p, int is_bf16, int n_levels,
                     void* stream) {
  if (p.n_views <= 0 || p.channels <= 0 || p.channels % VEC != 0 ||
      p.views_per_image <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(p, n_levels, s)
                 : launch<float>(p, n_levels, s);
}

}  // namespace

// K1: level-summed pooling, rows absolute in each level's stacked buffer.
// bias == NULL: out is (n_views, G, G, channels) in the pyramid dtype;
// otherwise the int8 epilogue: out int8, scale (n_views,) float32.
extern "C" int mpn_window_pool_multi(
    int is_bf16, int n_levels, int n_views, int channels,
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
  p.views_per_image = n_views;
  p.rows_per_image = 0;
  return static_cast<int>(dispatch(p, is_bf16, n_levels, stream));
}

// K2: one level, image-relative rows into a batch of per-image pyramids,
// views image-major (n = image * views + v); bias, out and scale as K1's.
extern "C" int mpn_resident_pool(
    int is_bf16, int batch, int views, int rows, int wmax, int channels,
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
  p.views_per_image = views;
  p.rows_per_image = rows;
  return static_cast<int>(dispatch(p, is_bf16, 1, stream));
}
