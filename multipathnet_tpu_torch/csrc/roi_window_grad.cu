// The backward of the ROI window pool for Hopper (sm_90a): the CUDA port of
// the two Pallas gradient kernels on the detector's training path.
//
//   window_grad (K3) replaces _window_grad_kernel / pallas_window_grad in
//     multipathnet_tpu/ops/roi_pallas.py: image-relative windows into a
//     (batch * rows, wmax, C) gradient. At multipath_vgg16_train it takes
//     c5 (80 rows x 40 wide per image) and, on the card, c4.
//   window_rmw_grad (K4) replaces _window_rmw_grad_kernel /
//     pallas_window_rmw_grad in the same file: absolute windows into the
//     (rows, wmax, C) gradient of a level. At multipath_vgg16_train it takes
//     c3 (320 rows x 160 wide per image), and every single-level backward.
// One device kernel serves both; K4 is K3 with one image of all the rows.
// The output is float32 or bf16, written once, rounded once.
//
// What it computes. The forward pools, per view, out = wy . win . wx^T over
// a WIN_Y x WIN_X (10 x 16) window at (row0, x0). Its transpose sends the
// cotangent g (G x G x C, G = 7) back to the window,
//     gwin[y][x][c] = sum_j (sum_i wy[i][y] * g[i][j][c]) * wx[j][x],
// summed over the views into the gradient at each view's window.
//
// Design: gather, not scatter. The TPU kernels walk the views in grid order
// and read-modify-write the buffer window by window; blocks on a GPU run in
// no order, so that form needs atomics, whose order (and so the last bits
// of the sum) changes from run to run. Here each block owns one tile of the
// output, TILE_Y (16) rows x TILE_X (16) columns x TILE_C (32) channels, and
// one thread owns each (tile column, channel) pair of two rows: its 32 sums
// live in its registers, and no other thread touches them. Three launches:
//   - count_kernel: one thread per view adds one to each tile its window
//     meets (integer adds: the same counts on every run).
//   - transpose_kernel: each view's weight rows, transposed and padded to
//     8 ([y][i], [x][j]) into the scratch, so a stage copies them 16 bytes
//     at a time.
//   - window_grad_kernel, per tile:
//     - Finding the views: the block walks the views that can reach it (K3:
//       its image's, K4: all) in index order, CHUNK (1024) at a time, four
//       a thread, and lists those whose window meets the tile, compacted by
//       warp ballots and a block-wide prefix, so the list stays in view
//       order; it stops once it has found the tile's count, and a tile no
//       view meets skips it. No sort, no host sync.
//     - Summing: the listed views, in list order, BATCH (4) at a time: the
//       block copies a batch's cotangent slices (49 x 32 floats a view) and
//       weight rows into shared memory by cp.async while it sums the batch
//       before (two stages). Per view, each warp whose two rows meet the
//       window forms, for its rows, m[r][j] = sum_i wy[i][y] * g[i][j] (i
//       in order), then for each tile column under the window (all 16, or
//       one half: x0 is a multiple of 8) the view's gwin = sum_j m[r][j] *
//       wx[j][x] (j in order), and adds it to the sum. Every sum thus runs
//       over the views in index order, each term formed in the same order:
//       the result is the same, bit for bit, on every run.
//     - Writing: the block writes its whole tile once, float32 or rounded
//       once to bf16 (through shared memory, 16 bytes a store); a tile no
//       view reaches writes zeros, so the wrappers allocate with torch.empty
//       and zero nothing.
//     Blocks run the bottom tile rows first: the coarse pyramid levels,
//     stacked below the finer ones, take most views.
// K3's reference returns float32 and its caller casts to the pyramid dtype;
// this kernel writes that dtype directly (the same single rounding). K4's
// reference accumulates in the buffer's dtype (bf16 on the training path)
// one view at a time; the port sums in float32 and rounds once: strictly
// closer to the exact sum.
//
// What bounds it (at multipath_vgg16_train: 8 images x 64 ROIs, 640^2,
// C = 512). Bytes: the float32 cotangent read once and the whole gradient
// written once. K3 on c5: 2048 views, 205 MB read, a (640, 40, 512) output
// of 26 MB in bf16; K4 on c3: 512 views, 51 MB read, a (2560, 160, 512)
// bf16 buffer of 419 MB, written in full. A window spans at most 2 x 2
// tiles, so each view's cotangent slice is read by up to 4 blocks per
// channel slice, through L2 (not counted in the bound). The FMA work,
// 1610 per view and channel plus m again for a second column tile, is
// under 0.1 ms at 67 TF/s. What the bound leaves out, and what holds the
// kernel (PERF.md): views crowd onto few tiles (at c5 a coarse pyramid
// level's 16 x 16 tile holds up to 196 of its image's 256 views), one block
// sums its tile's views one after another, and the staging of each batch
// (copies, two barriers) costs as much as the arithmetic; and the scan
// reads row0/x0 of every view once per block that has views, cheap at the
// train path's 256 views per image, a cost of its own at pool_api's
// 8000-24000 views per K4 call.
//
// A view whose window falls outside its buffer is not written; the wrappers
// check on the host that none does, as the reference's clamps guarantee.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int G = 7;
constexpr int WIN_Y = 10;
constexpr int WIN_X = 16;
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS_PER_WARP = 2;
constexpr int TILE_Y = WARPS * ROWS_PER_WARP;  // 16 rows
constexpr int TILE_X = 16;                     // columns
constexpr int TILE_C = 32;                     // channels: one per lane
constexpr int SCAN = 4;          // views each thread checks per scan step
constexpr int CHUNK = SCAN * THREADS;          // views per scan step
constexpr int LIST = 2 * CHUNK;  // listed views held before they are summed
constexpr int BATCH = 4;         // listed views per pipeline stage
constexpr int GP = 8;            // G padded, for 16-byte loads of a weight row

struct GradParams {
  const float* gout;  // (n_views, G, G, channels)
  const int* row0;    // (n_views,) rows within the view's image (K3) or
                      // within the whole buffer (K4)
  const int* x0;      // (n_views,)
  const float* wy;    // (n_views, G, WIN_Y)
  const float* wx;    // (n_views, G, WIN_X)
  void* out;          // (batch * rows, wmax, channels), float32 or bf16
  int* counts;        // scratch: (batch, row_tiles, col_tiles) views per
                      // tile, then the weights staged as the stages want
                      // them: wyt (n_views, WIN_Y, GP), wxt (n_views,
                      // WIN_X, GP), 16-byte aligned
  float* wyt;
  float* wxt;
  int views_per_image;  // views n of image b: b * views_per_image + [0, v)
  int rows;             // rows of one image's buffer (K4: the whole buffer)
  int wmax;
  int channels;
  int batch;            // images (K4: 1)
  int row_tiles;        // tiles per image: ceil(rows / TILE_Y)
  int col_tiles;        // ceil(wmax / TILE_X)
  int slices;           // channel slices: ceil(channels / TILE_C)
};

// One pipeline stage: BATCH listed views' cotangent slices (49 x TILE_C
// floats each) and weight rows, transposed so that a row of 7 weights is
// two 16-byte loads, copied in by cp.async while the previous stage is
// summed.
struct Stage {
  float g[BATCH][G * G][TILE_C];
  float wy[BATCH][WIN_Y][GP];  // [view][y][i]
  float wx[BATCH][WIN_X][GP];  // [view][x][j]
  int r0[BATCH];
  int x0[BATCH];
};

struct Smem {
  Stage stage[2];
  int list[LIST];        // listed views, in index order
  int count[SCAN][WARPS];
};

constexpr int SMEM_BYTES = sizeof(Smem);

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// a 4-byte asynchronous copy to shared memory; zeros where !valid
__device__ __forceinline__ void copy4(void* dst, const void* src,
                                      bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// a 16-byte one, of `bytes` (0-16) and zeros after them
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// the copies of listed views k0 .. k0 + BATCH (those below n) into `st`:
// the cotangent rows in 16-byte pieces where C % 4 == 0 and the buffer is
// 16-byte aligned (so is each 32-channel row then), else value by value
__device__ __forceinline__ void load_stage(const GradParams& p, Stage& st,
                                           const int* list, int k0, int n,
                                           int c0) {
  const int nb = min(BATCH, n - k0);
  constexpr int PIECES = TILE_C / 4;  // 16-byte pieces of a row
  if (p.channels % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(p.gout) & 15) == 0) {
    for (int e = threadIdx.x; e < nb * G * G * PIECES; e += THREADS) {
      const int row = e / PIECES, piece = e % PIECES;  // row = q * 49 + bin
      const int q = row / (G * G), bin = row % (G * G);
      const int c = c0 + 4 * piece;
      const int bytes = 4 * max(0, min(4, p.channels - c));
      copy16(&st.g[q][bin][4 * piece],
             p.gout + ((size_t)list[k0 + q] * G * G + bin) * p.channels +
                 (bytes ? c : 0),
             bytes);
    }
  } else {
    for (int e = threadIdx.x; e < nb * G * G * TILE_C; e += THREADS) {
      const int q = e / (G * G * TILE_C), r = e % (G * G * TILE_C);
      const int bin = r / TILE_C, lane = r % TILE_C;
      const int c = c0 + lane;
      const bool valid = c < p.channels;
      copy4(&st.g[q][bin][lane],
            p.gout + ((size_t)list[k0 + q] * G * G + bin) * p.channels +
                (valid ? c : 0),
            valid);
    }
  }
  // the weight rows, transposed and padded by count_kernel: 16 bytes a copy
  constexpr int WY_PIECES = WIN_Y * GP / 4, WX_PIECES = WIN_X * GP / 4;
  for (int e = threadIdx.x; e < nb * WY_PIECES; e += THREADS) {
    const int q = e / WY_PIECES, r = e % WY_PIECES;
    copy16(&st.wy[q][0][0] + 4 * r,
           p.wyt + (size_t)list[k0 + q] * WIN_Y * GP + 4 * r, 16);
  }
  for (int e = threadIdx.x; e < nb * WX_PIECES; e += THREADS) {
    const int q = e / WX_PIECES, r = e % WX_PIECES;
    copy16(&st.wx[q][0][0] + 4 * r,
           p.wxt + (size_t)list[k0 + q] * WIN_X * GP + 4 * r, 16);
  }
  if (threadIdx.x < nb) {
    const int n_view = list[k0 + threadIdx.x];
    copy4(&st.r0[threadIdx.x], p.row0 + n_view, true);
    copy4(&st.x0[threadIdx.x], p.x0 + n_view, true);
  }
}

using Rows = float[ROWS_PER_WARP][TILE_X];

// acc[r][x] += gwin[r] = sum_j m[r][j] * w[j] (j in order) on the rows r
// that lie in the window (valid[r]); w is one window column's weight row.
// No branch: a row outside the window is computed from a clamped weight
// row and its add predicated off. x is a constant wherever this is
// inlined.
__device__ __forceinline__ void add_column(Rows& acc, int x,
                                           const float (&m)[ROWS_PER_WARP][G],
                                           const bool (&valid)[ROWS_PER_WARP],
                                           const float* wrow) {
  const float4 lo = *reinterpret_cast<const float4*>(wrow);
  const float4 hi = *reinterpret_cast<const float4*>(wrow + 4);
  const float w[G] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z};
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    float s = __fmul_rn(m[r][0], w[0]);
#pragma unroll
    for (int j = 1; j < G; ++j) s = fmaf(m[r][j], w[j], s);
    if (valid[r]) acc[r][x] = __fadd_rn(acc[r][x], s);
  }
}

// tile columns X0 .. X0 + N under window columns wc0 .. wc0 + N
template <int X0, int N>
__device__ __forceinline__ void add_columns(Rows& acc,
                                            const float (&m)[ROWS_PER_WARP][G],
                                            const bool (&valid)[ROWS_PER_WARP],
                                            const float (*wx)[GP], int wc0) {
#pragma unroll
  for (int k = 0; k < N; ++k) add_column(acc, X0 + k, m, valid, wx[wc0 + k]);
}

// one listed view's gwin added to this warp's rows of the tile: dy is the
// window row of the warp's first row, dx the window column of the tile's
// first column
__device__ __forceinline__ void add_view(Rows& acc, const Stage& st, int q,
                                         int dy, int dx, int lane) {
  bool valid[ROWS_PER_WARP];
  int y[ROWS_PER_WARP];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    y[r] = min(max(dy + r, 0), WIN_Y - 1);
    valid[r] = y[r] == dy + r;
  }
  // m[r][j] = sum_i wy[i][y] * g[i][j], i in order (the first fmaf from 0
  // is the rounded product)
  float m[ROWS_PER_WARP][G];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r)
#pragma unroll
    for (int j = 0; j < G; ++j) m[r][j] = 0.f;
#pragma unroll
  for (int i = 0; i < G; ++i) {
    float gi[G];
#pragma unroll
    for (int j = 0; j < G; ++j) gi[j] = st.g[q][i * G + j][lane];
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const float w = st.wy[q][y[r]][i];
#pragma unroll
      for (int j = 0; j < G; ++j) m[r][j] = fmaf(w, gi[j], m[r][j]);
    }
  }
  // the tile columns under the window: x0 is a multiple of 8 wherever
  // view_geometry made it, so the window covers the whole tile or one half
  if (dx == 0) {
    add_columns<0, TILE_X>(acc, m, valid, st.wx[q], 0);
  } else if (dx == 8) {
    add_columns<0, 8>(acc, m, valid, st.wx[q], 8);
  } else if (TILE_X == 16 && dx == -8) {
    add_columns<TILE_X - 8, 8>(acc, m, valid, st.wx[q], 0);
  } else {
    // any other offset (a caller's own origins): column by column
#pragma unroll
    for (int x = 0; x < TILE_X; ++x) {
      const int wc = dx + x;
      if (wc >= 0 && wc < WIN_X)  // block-uniform
        add_column(acc, x, m, valid, st.wx[q][wc]);
    }
  }
}

// the block's tile into the output, each cell's TILE_C channels once: bf16
// through a shared-memory copy of the tile and 16-byte stores (4 of them a
// cell) where the channels fill the slice and rows are 16-byte aligned;
// otherwise, and for float32 (128 bytes a warp already), value by value
template <typename T>
__device__ __forceinline__ void write_tile(const GradParams& p, Smem& sm,
                                           const Rows& acc, int img, int tr0,
                                           int tc0, int c0, bool any) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr0 = tr0 + warp * ROWS_PER_WARP;
  T* out = static_cast<T*>(p.out);
  const bool vector = sizeof(T) == 2 && c0 + TILE_C <= p.channels &&
                      p.channels % 8 == 0 &&
                      (reinterpret_cast<uintptr_t>(p.out) & 15) == 0;
  if (!vector) {
    const int c = c0 + lane;
    if (c >= p.channels) return;
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int row = wr0 + r;
      if (row >= p.rows) break;
      T* dst = out + ((size_t)(img * p.rows + row) * p.wmax + tc0) *
                         p.channels + c;
#pragma unroll
      for (int x = 0; x < TILE_X; ++x)
        if (tc0 + x < p.wmax) store(dst + (size_t)x * p.channels, acc[r][x]);
    }
    return;
  }
  // [cell][channel] bf16 in the first stage's buffer, which no copy fills
  // any more
  __nv_bfloat16(*tile)[TILE_C] =
      reinterpret_cast<__nv_bfloat16(*)[TILE_C]>(&sm.stage[0].g[0][0][0]);
  if (any) {
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r)
#pragma unroll
      for (int x = 0; x < TILE_X; ++x)
        tile[((wr0 - tr0) + r) * TILE_X + x][lane] =
            __float2bfloat16_rn(acc[r][x]);
    __syncthreads();
  }
  constexpr int PIECES = TILE_C * 2 / 16;  // 16-byte pieces of a cell
  for (int e = tid; e < TILE_Y * TILE_X * PIECES; e += THREADS) {
    const int cell = e / PIECES, piece = e % PIECES;
    const int row = tr0 + cell / TILE_X, col = tc0 + cell % TILE_X;
    if (row >= p.rows || col >= p.wmax) continue;
    const uint4 v = any ? *reinterpret_cast<const uint4*>(
                              &tile[cell][piece * 8])
                        : make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(
        out + ((size_t)(img * p.rows + row) * p.wmax + col) * p.channels +
        c0 + piece * 8) = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
window_grad_kernel(const GradParams p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // block order: channel slice, tile column, image, then tile rows from
  // the bottom up, so the first blocks to run take the coarse pyramid
  // levels, stacked below the finer ones, where most views land (at c5 a
  // tile there lists up to 196 views, the median tile with a view 17:
  // chip_smoke.py phase 6 prints the counts)
  int t = blockIdx.x;
  const int c0 = (t % p.slices) * TILE_C;
  t /= p.slices;
  const int tc0 = (t % p.col_tiles) * TILE_X;
  t /= p.col_tiles;
  const int img = t % p.batch;
  const int tr0 = (p.row_tiles - 1 - t / p.batch) * TILE_Y;
  const int wr0 = tr0 + warp * ROWS_PER_WARP;  // this warp's first row
  // the views that meet this tile (count_kernel): the scan stops once it
  // has found them all, and an empty tile skips it
  const int expected =
      p.counts[(img * p.row_tiles + tr0 / TILE_Y) * p.col_tiles +
               tc0 / TILE_X];

  float acc[ROWS_PER_WARP][TILE_X];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r)
#pragma unroll
    for (int x = 0; x < TILE_X; ++x) acc[r][x] = 0.f;

  const int v_begin = img * p.views_per_image;
  const int v_end = v_begin + p.views_per_image;
  int listed = 0, found = 0;
  for (int base = v_begin; base < v_end && found < expected;
       base += CHUNK) {
    // ---- the views base .. base + CHUNK that meet the tile, in order:
    // step k checks base + k * THREADS + [0, THREADS)
    bool hit[SCAN];
    unsigned ballot[SCAN];
#pragma unroll
    for (int k = 0; k < SCAN; ++k) {
      const int v = base + k * THREADS + tid;
      hit[k] = false;
      if (v < v_end) {
        const int r0 = p.row0[v], x0 = p.x0[v];
        hit[k] = r0 >= 0 && r0 + WIN_Y <= p.rows && x0 >= 0 &&
                 x0 + WIN_X <= p.wmax && r0 < tr0 + TILE_Y &&
                 r0 + WIN_Y > tr0 && x0 < tc0 + TILE_X && x0 + WIN_X > tc0;
      }
      ballot[k] = __ballot_sync(0xffffffffu, hit[k]);
      if (lane == 0) sm.count[k][warp] = __popc(ballot[k]);
    }
    __syncthreads();
    // a hit's place: the hits of earlier steps, of earlier warps in this
    // step, of earlier lanes in this warp
    int offset = listed;
#pragma unroll
    for (int k = 0; k < SCAN; ++k) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w)
        if (w < warp) offset += sm.count[k][w];
      if (hit[k])
        sm.list[offset + __popc(ballot[k] & ((1u << lane) - 1u))] =
            base + k * THREADS + tid;
#pragma unroll
      for (int w = 0; w < WARPS; ++w)
        if (w >= warp) offset += sm.count[k][w];
    }
    found += offset - listed;  // every thread's offset ends at the new
    listed = offset;           // list length
    __syncthreads();
    if (listed + CHUNK <= LIST && base + CHUNK < v_end && found < expected)
      continue;

    // ---- sum the listed views, in list order, BATCH at a time: the
    // next stage's copies are in flight while this one is summed
    const int n_batches = (listed + BATCH - 1) / BATCH;
    if (n_batches > 0) load_stage(p, sm.stage[0], sm.list, 0, listed, c0);
    asm volatile("cp.async.commit_group;" ::: "memory");
    for (int b = 0; b < n_batches; ++b) {
      if (b + 1 < n_batches)
        load_stage(p, sm.stage[(b + 1) & 1], sm.list, (b + 1) * BATCH,
                   listed, c0);
      asm volatile("cp.async.commit_group;" ::: "memory");
      asm volatile("cp.async.wait_group 1;" ::: "memory");
      __syncthreads();
      const Stage& st = sm.stage[b & 1];
      const int nb = min(BATCH, listed - b * BATCH);
      for (int q = 0; q < nb; ++q) {
        const int dy = wr0 - st.r0[q];  // the window row of this warp's row 0
        if (dy >= WIN_Y || dy + ROWS_PER_WARP <= 0) continue;  // warp-uniform
        add_view(acc, st, q, dy, tc0 - st.x0[q], lane);
      }
      __syncthreads();  // this stage is read: the next copies may land
    }
    listed = 0;
  }

  // ---- the tile, written once
  write_tile<T>(p, sm, acc, img, tr0, tc0, c0, expected > 0);
}

// the views' weight rows transposed, [y][i] and [x][j], padded to GP, so
// the stages copy them 16 bytes at a time: one thread per output value
constexpr int WT_WORDS = (WIN_Y + WIN_X) * GP;  // per view

__global__ void transpose_kernel(const GradParams p, int n_views) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)n_views * WT_WORDS) return;
  const int n = e / WT_WORDS, r = e % WT_WORDS;
  if (r < WIN_Y * GP) {
    const int y = r / GP, i = r % GP;
    p.wyt[(size_t)n * WIN_Y * GP + r] =
        i < G ? p.wy[((size_t)n * G + i) * WIN_Y + y] : 0.f;
  } else {
    const int x = (r - WIN_Y * GP) / GP, j = r % GP;
    p.wxt[(size_t)n * WIN_X * GP + r - WIN_Y * GP] =
        j < G ? p.wx[((size_t)n * G + j) * WIN_X + x] : 0.f;
  }
}

// views per tile: one thread per view adds one to each tile its window
// meets (integer adds, so the counts are the same on every run)
__global__ void count_kernel(const GradParams p, int n_views) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_views) return;
  const int r0 = p.row0[n], x0 = p.x0[n];
  if (r0 < 0 || r0 + WIN_Y > p.rows || x0 < 0 || x0 + WIN_X > p.wmax) return;
  int* img = p.counts + (size_t)(n / p.views_per_image) * p.row_tiles *
                            p.col_tiles;
  for (int rt = r0 / TILE_Y; rt <= (r0 + WIN_Y - 1) / TILE_Y; ++rt)
    for (int ct = x0 / TILE_X; ct <= (x0 + WIN_X - 1) / TILE_X; ++ct)
      atomicAdd(img + rt * p.col_tiles + ct, 1);
}

template <typename T>
cudaError_t launch_instance(const GradParams& p, dim3 grid,
                            cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      window_grad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return e;
  window_grad_kernel<T><<<grid, THREADS, SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch(const GradParams& p, int out_bf16, void* stream) {
  if (p.batch <= 0 || p.views_per_image < 0 || p.channels <= 0 ||
      p.rows <= 0 || p.wmax <= 0)
    return cudaErrorInvalidValue;
  const long long blocks =
      (long long)p.batch * p.row_tiles * p.col_tiles * p.slices;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_views = p.batch * p.views_per_image;
  cudaError_t e = cudaMemsetAsync(
      p.counts, 0, sizeof(int) * p.batch * p.row_tiles * p.col_tiles, s);
  if (e != cudaSuccess) return e;
  if (n_views > 0) {
    count_kernel<<<(n_views + 255) / 256, 256, 0, s>>>(p, n_views);
    const long long words = (long long)n_views * WT_WORDS;
    transpose_kernel<<<(unsigned)((words + 255) / 256), 256, 0, s>>>(
        p, n_views);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return out_bf16 ? launch_instance<__nv_bfloat16>(p, grid, s)
                  : launch_instance<float>(p, grid, s);
}

// the scratch's parts: the counts, then wyt and wxt, 16-byte aligned
size_t count_ints(int batch, int rows, int wmax) {
  const size_t n = (size_t)batch * ((rows + TILE_Y - 1) / TILE_Y) *
                   ((wmax + TILE_X - 1) / TILE_X);
  return (n + 3) / 4 * 4;
}

GradParams params(const float* gout, const int* row0, const int* x0,
                  const float* wy, const float* wx, void* out, void* scratch,
                  int batch, int views_per_image, int rows, int wmax,
                  int channels) {
  GradParams p;
  p.gout = gout; p.row0 = row0; p.x0 = x0; p.wy = wy; p.wx = wx;
  p.out = out;
  p.counts = static_cast<int*>(scratch);
  p.wyt = reinterpret_cast<float*>(p.counts + count_ints(batch, rows, wmax));
  p.wxt = p.wyt + (size_t)batch * views_per_image * WIN_Y * GP;
  p.views_per_image = views_per_image;
  p.rows = rows;
  p.wmax = wmax;
  p.channels = channels;
  p.batch = batch;
  p.row_tiles = (rows + TILE_Y - 1) / TILE_Y;
  p.col_tiles = (wmax + TILE_X - 1) / TILE_X;
  p.slices = (channels + TILE_C - 1) / TILE_C;
  return p;
}

}  // namespace

// The scratch, in 4-byte words, that both entry points need for `batch`
// images of (rows, wmax) and n_views views: a count per tile, then each
// view's weight rows, transposed and padded.
extern "C" long long mpn_grad_scratch_words(int batch, int rows, int wmax,
                                            int n_views) {
  return (long long)count_ints(batch, rows, wmax) +
         (long long)n_views * WT_WORDS;
}

// K3: views image-major (n = image * views_per_image + v), rows relative to
// the view's image; out is (batch * rows, wmax, C), float32 or (out_bf16)
// bf16; scratch holds mpn_grad_scratch_words(batch, rows, wmax,
// batch * views_per_image) words, 16-byte aligned.
extern "C" int mpn_window_grad(
    int out_bf16, int batch, int views_per_image, int rows, int wmax,
    int channels, const float* gout, const int* row0, const int* x0,
    const float* wy, const float* wx, void* out, void* scratch,
    void* stream) {
  return static_cast<int>(launch(
      params(gout, row0, x0, wy, wx, out, scratch, batch, views_per_image,
             rows, wmax, channels),
      out_bf16, stream));
}

// K4: rows absolute in the (rows, wmax, C) buffer: one image of all rows;
// scratch holds mpn_grad_scratch_words(1, rows, wmax, n_views) words,
// 16-byte aligned.
extern "C" int mpn_window_rmw_grad(
    int out_bf16, int n_views, int rows, int wmax, int channels,
    const float* gout, const int* row0, const int* x0, const float* wy,
    const float* wx, void* out, void* scratch, void* stream) {
  return static_cast<int>(launch(
      params(gout, row0, x0, wy, wx, out, scratch, 1, n_views, rows, wmax,
             channels),
      out_bf16, stream));
}

// The kernel's attributes into out[5], float32 (out_bf16 = 0) or bf16
// output: registers per thread, local (spill) bytes per thread, static
// shared bytes, the dynamic shared bytes it launches with, max threads per
// block.
extern "C" int mpn_grad_kernel_attrs(int out_bf16, int* out) {
  cudaFuncAttributes a;
  const cudaError_t e =
      out_bf16 ? cudaFuncGetAttributes(&a, window_grad_kernel<__nv_bfloat16>)
               : cudaFuncGetAttributes(&a, window_grad_kernel<float>);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = SMEM_BYTES;
  out[4] = a.maxThreadsPerBlock;
  return 0;
}
