// The window-read probe for Hopper (sm_90a): the CUDA port of the Pallas
// probe _kernel / run in tools/probe_int8_window_dma.py (P). It measures how
// fast the pool kernels' access pattern can be read at all, bf16 windows
// against int8 ones: the floor under K1/K2's window reads.
//
// What it computes. Per view n, the WIN_Y x WIN_X (10 x 16) window at
// (row0[n], x0[n]) of a (rows, wmax, C) buffer in bf16 or int8. Each element
// is converted to bf16 and then to float; for int8 that is one conversion to
// float, since every integer of magnitude <= 256 is a bf16 value. The 160
// cells are summed per channel in float32 (window rows in order, the 16
// cells of a row in order), the sum is rounded once to bf16 and written to
// all 49 rows of out[n] (N, 49, C): the Pallas probe's ones(49, 160) @
// window product with float32 accumulation.
//
// Layout. One block of 128 threads per (view, 512-channel slice); each
// thread owns 4 adjacent channels, read as one 8-byte (bf16) or 4-byte
// (int8) load per cell, so a warp reads 256 or 128 contiguous bytes of a
// cell and one window row (16 cells x C) is one contiguous run (16 KB in
// bf16 at C = 512). A row's 16 loads are issued before any is summed, so
// each thread keeps 16 loads in flight. The 49 output rows are 8-byte
// stores of the same 4 bf16 values.
//
// What bounds it. Bytes: N * 160 * C elements read and N * 49 * C bf16
// written; 160 adds per channel and view. At the tool's shapes (N = 32000,
// a (4096, 160, 512) buffer): bf16 5.2 GB of window reads, int8 2.6 GB, and
// 1.6 GB written either way. The buffer (0.67 GB bf16, 0.34 GB int8) is far
// beyond the 50 MB L2 and the rows are random, so windows rarely share L2
// lines: the reads go to HBM. The bound that chip_smoke.py states counts the
// distinct cells under the windows once, so it sits below what this layout
// can reach.
//
// A view whose window falls outside the buffer is not read: its output is
// NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int WIN_Y = 10;
constexpr int WIN_X = 16;
constexpr int OUT_ROWS = 49;
constexpr int VEC = 4;                 // channels per thread
constexpr int THREADS = 128;           // threads per block
constexpr int SLICE = THREADS * VEC;   // channels per block

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  return make_float4(static_cast<float>(v.x), static_cast<float>(v.y),
                     static_cast<float>(v.z), static_cast<float>(v.w));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
window_read_probe_kernel(const T* __restrict__ flat,
                         const int* __restrict__ row0,
                         const int* __restrict__ x0,
                         __nv_bfloat16* __restrict__ out, int rows, int wmax,
                         int channels) {
  const int n = blockIdx.x;
  const int c = (blockIdx.y * THREADS + threadIdx.x) * VEC;
  if (c >= channels) return;
  const int r = row0[n];
  const int x = x0[n];
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r < 0 || r + WIN_Y > rows || x < 0 || x + WIN_X > wmax) {
    acc = make_float4(NAN, NAN, NAN, NAN);
  } else {
    const size_t cell = (size_t)channels;
    const T* base = flat + ((size_t)r * wmax + x) * cell + c;
#pragma unroll 1
    for (int y = 0; y < WIN_Y; ++y) {
      const T* row = base + (size_t)y * wmax * cell;
      float4 v[WIN_X];
#pragma unroll
      for (int i = 0; i < WIN_X; ++i) v[i] = load4(row + i * cell);
#pragma unroll
      for (int i = 0; i < WIN_X; ++i) {
        acc.x += v[i].x;
        acc.y += v[i].y;
        acc.z += v[i].z;
        acc.w += v[i].w;
      }
    }
  }
  const __nv_bfloat162 lo = __floats2bfloat162_rn(acc.x, acc.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(acc.z, acc.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned int*>(&lo);
  u.y = *reinterpret_cast<const unsigned int*>(&hi);
  __nv_bfloat16* dst = out + (size_t)n * OUT_ROWS * channels + c;
#pragma unroll 7
  for (int i = 0; i < OUT_ROWS; ++i)
    *reinterpret_cast<uint2*>(dst + (size_t)i * channels) = u;
}

}  // namespace

// P: flat (rows, wmax, channels) bf16 (is_int8 == 0) or int8; row0/x0
// (n_views,) window origins; out (n_views, 49, channels) bf16. channels
// must be a multiple of 4 and the buffers 8-byte aligned.
extern "C" int mpn_window_read_probe(int is_int8, int n_views, int rows,
                                     int wmax, int channels, const void* flat,
                                     const int* row0, const int* x0,
                                     void* out, void* stream) {
  if (n_views <= 0 || channels <= 0 || channels % VEC != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_views, (channels + SLICE - 1) / SLICE);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (is_int8)
    window_read_probe_kernel<int8_t><<<grid, THREADS, 0, s>>>(
        static_cast<const int8_t*>(flat), row0, x0, o, rows, wmax, channels);
  else
    window_read_probe_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(flat), row0, x0, o, rows, wmax,
        channels);
  return static_cast<int>(cudaGetLastError());
}
