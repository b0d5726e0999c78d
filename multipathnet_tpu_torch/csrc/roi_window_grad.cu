// The backward of the ROI window pool for Hopper (sm_90a): the CUDA port of
// the two Pallas gradient kernels on the detector's training path.
//
//   window_grad (K3) replaces _window_grad_kernel / pallas_window_grad in
//     multipathnet_tpu/ops/roi_pallas.py: image-relative windows into a
//     float32 (batch * rows, wmax, C) gradient. At multipath_vgg16_train it
//     takes c5 (80 rows x 40 wide per image), both pool groups.
//   window_rmw_grad (K4) replaces _window_rmw_grad_kernel /
//     pallas_window_rmw_grad in the same file: absolute windows into the
//     (rows, wmax, C) gradient of a level too wide for K3. At
//     multipath_vgg16_train it takes c3 (320 rows x 160 wide per image).
// One device kernel serves both; the entry points differ in how a view's
// rows are offset (K3: view n's image times rows per image) and in what the
// wrapper does with the float32 result.
//
// What it computes. The forward pools, per view, out = wy . win . wx^T over
// a WIN_Y x WIN_X (10 x 16) window at (row0, x0). Its transpose sends the
// cotangent g (G x G x C, G = 7) back to the window,
//     gwin[y][x][c] = sum_j (sum_i wy[i][y] * g[i][j][c]) * wx[j][x],
// and adds gwin into the pyramid gradient at the window. The Pallas kernels
// run the (49 x 160) W2^T GEMM per view on the TPU's matrix unit. Here the
// contraction is separable on the CUDA cores, i first, one window row at a
// time, so only one row of partial sums (G x 2 floats) is live:
//     m[j]        = sum_i wy[i][y] * g[i][j][c]        (49 FMA per row y)
//     gwin[y][x]  = sum_j m[j] * wx[j][x]              (16 * 7 FMA per row y)
//
// Layout. One thread block per (view, 128-channel slice); each of its 64
// threads owns 2 adjacent channels, so every global access is 8 bytes and a
// warp covers 256 contiguous bytes of an NHWC cell. The block stages the
// view's (49, 128) cotangent slice (25 KB) and its weight rows in shared
// memory, then walks the 10 window rows.
//
// Accumulation. Views overlap and blocks run in no order, so gwin goes into
// a zeroed float32 buffer with atomicAdd. A window row (column) whose
// bilinear weights are all zero contributes exactly zero and is skipped, the
// same for every thread of the block. K3's reference keeps its buffer in
// float32 as well; K4's reference accumulates in the buffer's dtype (bf16 on
// the training path) one view at a time, while the port accumulates in
// float32 and the wrapper rounds once at the end: strictly closer to the
// exact sum. Float additions in an order that changes from run to run make
// the gradient's last bits depend on the run; the reference kernels are
// deterministic.
//
// What bounds it (prediction, at multipath_vgg16_train: 8 images x 64 ROIs,
// 640^2, C = 512). Per view and channel: 49 floats read, 1610 FMA, up to 160
// atomic adds. K3 on c5, 2048 views: 205 MB of cotangent read, 3.4 GFLOP,
// at most 168 M float32 atomics into a 52 MB buffer that nearly fits the
// 50 MB L2. K4 on c3, 512 views: 51 MB read, 0.8 GFLOP, at most 42 M atomics
// into an 838 MB buffer. The FMA work is under 0.1 ms at 67 TF/s; the
// atomics, each a read-modify-write in L2, bound both kernels: K3 near 1 ms,
// K4 near 0.3 ms. K4's wrapper adds the zeroing (838 MB) and the bf16 cast
// (838 MB read, 419 MB written), about 0.6 ms of HBM traffic.
//
// A view whose window falls outside its buffer is not written; the wrappers
// check on the host that none does, as the reference's clamps guarantee.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int G = 7;
constexpr int WIN_Y = 10;
constexpr int WIN_X = 16;
constexpr int VEC = 2;                    // channels per thread
constexpr int THREADS = 64;               // threads per block
constexpr int SLICE = THREADS * VEC;      // channels per block

struct GradParams {
  const float* gout;  // (n_views, G, G, channels)
  const int* row0;    // (n_views,) rows within the view's image (K3) or
                      // within the whole buffer (K4)
  const int* x0;      // (n_views,)
  const float* wy;    // (n_views, G, WIN_Y)
  const float* wx;    // (n_views, G, WIN_X)
  float* out;         // (.., wmax, channels), zeroed by the caller
  int n_views;
  int channels;
  int wmax;
  int rows;           // rows a window may span: per image (K3), all (K4)
  // view n writes rows (n / views_per_image) * rows_per_image + row0:
  // K3's image-relative rows; K4 passes rows_per_image = 0.
  int views_per_image;
  int rows_per_image;
};

__global__ void __launch_bounds__(THREADS)
window_grad_kernel(const GradParams p) {
  __shared__ __align__(16) float s_g[G * G][SLICE];  // [bin][channel]
  __shared__ float s_wy[WIN_Y][G];                   // [y][i]
  __shared__ float s_wx[WIN_X][G];                   // [x][j]
  __shared__ int s_row_live[WIN_Y];
  __shared__ int s_col_live[WIN_X];

  const int n = blockIdx.x;
  const int c0 = blockIdx.y * SLICE;
  const int t = threadIdx.x;

  for (int k = t; k < WIN_Y * G; k += THREADS) {
    const int y = k / G, i = k % G;
    s_wy[y][i] = p.wy[((size_t)n * G + i) * WIN_Y + y];
  }
  for (int k = t; k < WIN_X * G; k += THREADS) {
    const int x = k / G, j = k % G;
    s_wx[x][j] = p.wx[((size_t)n * G + j) * WIN_X + x];
  }
  const float* g = p.gout + (size_t)n * G * G * p.channels;
  for (int k = t; k < G * G * (SLICE / VEC); k += THREADS) {
    const int bin = k / (SLICE / VEC), q = (k % (SLICE / VEC)) * VEC;
    const int c = c0 + q;
    float2 v = make_float2(0.f, 0.f);
    if (c < p.channels)
      v = *reinterpret_cast<const float2*>(g + (size_t)bin * p.channels + c);
    *reinterpret_cast<float2*>(&s_g[bin][q]) = v;
  }
  __syncthreads();
  if (t < WIN_Y) {
    int live = 0;
    for (int i = 0; i < G; ++i) live |= s_wy[t][i] != 0.f;
    s_row_live[t] = live;
  } else if (t < WIN_Y + WIN_X) {
    int live = 0;
    for (int j = 0; j < G; ++j) live |= s_wx[t - WIN_Y][j] != 0.f;
    s_col_live[t - WIN_Y] = live;
  }
  __syncthreads();

  const int c = c0 + t * VEC;
  const int r0 = p.row0[n];
  const int x0 = p.x0[n];
  if (c >= p.channels || r0 < 0 || r0 + WIN_Y > p.rows || x0 < 0 ||
      x0 + WIN_X > p.wmax)
    return;
  const size_t cell = (size_t)p.channels;
  const size_t row_stride = (size_t)p.wmax * cell;
  const int img_row = (n / p.views_per_image) * p.rows_per_image;
  float* base = p.out + ((size_t)(img_row + r0) * p.wmax + x0) * cell + c;

#pragma unroll 1
  for (int y = 0; y < WIN_Y; ++y) {
    if (!s_row_live[y]) continue;
    float m[G][VEC];
#pragma unroll
    for (int j = 0; j < G; ++j) m[j][0] = m[j][1] = 0.f;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const float w = s_wy[y][i];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const float2 v = *reinterpret_cast<const float2*>(
            &s_g[i * G + j][t * VEC]);
        m[j][0] = fmaf(w, v.x, m[j][0]);
        m[j][1] = fmaf(w, v.y, m[j][1]);
      }
    }
    float* row = base + y * row_stride;
#pragma unroll
    for (int x = 0; x < WIN_X; ++x) {
      if (!s_col_live[x]) continue;
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const float w = s_wx[x][j];
        a = fmaf(w, m[j][0], a);
        b = fmaf(w, m[j][1], b);
      }
      atomicAdd(row + x * cell, a);
      atomicAdd(row + x * cell + 1, b);
    }
  }
}

cudaError_t launch(const GradParams& p, void* stream) {
  if (p.n_views <= 0 || p.channels <= 0 || p.channels % VEC != 0 ||
      p.views_per_image <= 0 || p.wmax < WIN_X || p.rows < WIN_Y)
    return cudaErrorInvalidValue;
  const dim3 grid(p.n_views, (p.channels + SLICE - 1) / SLICE);
  window_grad_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      p);
  return cudaGetLastError();
}

}  // namespace

// K3: views image-major (n = image * views_per_image + v), rows relative to
// the view's image; out is (n_views / views_per_image * rows, wmax, C).
extern "C" int mpn_window_grad(
    int n_views, int views_per_image, int rows, int wmax, int channels,
    const float* gout, const int* row0, const int* x0, const float* wy,
    const float* wx, float* out, void* stream) {
  GradParams p;
  p.gout = gout; p.row0 = row0; p.x0 = x0; p.wy = wy; p.wx = wx;
  p.out = out;
  p.n_views = n_views;
  p.channels = channels;
  p.wmax = wmax;
  p.rows = rows;
  p.views_per_image = views_per_image;
  p.rows_per_image = rows;
  return static_cast<int>(launch(p, stream));
}

// K4: rows absolute in the (rows, wmax, C) buffer.
extern "C" int mpn_window_rmw_grad(
    int n_views, int rows, int wmax, int channels, const float* gout,
    const int* row0, const int* x0, const float* wy, const float* wx,
    float* out, void* stream) {
  GradParams p;
  p.gout = gout; p.row0 = row0; p.x0 = x0; p.wy = wy; p.wx = wx;
  p.out = out;
  p.n_views = n_views;
  p.channels = channels;
  p.wmax = wmax;
  p.rows = rows;
  p.views_per_image = n_views;
  p.rows_per_image = 0;
  return static_cast<int>(launch(p, stream));
}
