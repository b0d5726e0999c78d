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
// What bounds it. Bytes: the distinct cells under the windows read once
// and N * 49 * C bf16 written; 160 adds per channel and view. At the tool's
// shapes (N = 32000 views with random rows over a (4096, 160, 512) buffer)
// the windows cover 95% of the buffer (0.64 GB bf16, 0.32 GB int8) but read
// 5.2 GB (bf16): each cell about 8 times. Read in the given order, the
// views in flight land anywhere in a buffer 13 times the 50 MB L2, so
// every re-read goes to HBM. The output (1.6 GB) is most of the bound.
//
// Design.
//   1. The order pass sorts the views by row band (BAND = 16 rows) into
//      `order` as (view, row0, x0), in two launches over blocks of
//      ORDER_VIEWS views: count_bands_kernel counts each block's views per
//      band, scatter_views_kernel scans the counts and puts each view
//      after those of earlier bands, and of earlier blocks in its band.
//      The order within a block's share of a band depends on its atomics,
//      but each view's sum has a fixed order, so the output is the same
//      bit for bit.
//   2. window_read_probe_kernel: a persistent grid (two blocks per SM)
//      walks `order` in items of (view, SLICE channels), block b taking
//      items b, b + grid, ...; the items in flight then cover a few dozen
//      neighbouring rows (a few MB), so a window's re-reads by the next
//      views of its band hit L2, which the loads ask to keep (evict last).
//      One producer thread fills a ring of RING shared-memory stages by
//      TMA, each stage one box {box_c channels, 16 x, 2 rows} out of a
//      tiled 3-D tensor map over the buffer; TMA does not cache in L1 and
//      takes no registers. 128 consumer threads sum the stage, one channel
//      pair each, rows and cells in order, and free it. On an H100 a
//      deeper ring, or more blocks per SM, made the body slower, not
//      faster (PERF.md, row P).
//   3. The output. Each consumer puts its bf16 pair into a staged row of
//      the item's channels (double buffered, so that one barrier an item
//      will do), then every consumer writes the 49 output rows from it by
//      16-byte streaming stores. On an H100, 49 bulk copies (cp.async.bulk)
//      of the row were no faster in int8 and not reliably faster in bf16
//      (PERF.md, row P).
// A view whose window falls outside the buffer is not read (TMA would
// zero-fill it silently): its output is NaN.
//
// TMA needs 16-byte global strides and a 16-byte aligned buffer: C * the
// element size must be a multiple of 16 (C % 8 in bf16, C % 16 in int8);
// the wrapper raises otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "tma.cuh"

namespace mpn {
namespace {

constexpr int WIN_Y = 10;
constexpr int WIN_X = 16;
constexpr int OUT_ROWS = 49;
constexpr int BAND = 16;                // rows per band of the view order
constexpr int MAX_BANDS = 4096;         // bands: the order pass's counters
constexpr int ORDER_THREADS = 1024;
constexpr int ORDER_VIEWS = 2048;       // views per block of the order pass
constexpr int SLICE = 256;              // channels per item: the TMA box's
                                        // inner extent, at most 256
constexpr int ROWS_PER_STAGE = 2;       // window rows per ring stage
constexpr int STAGES_PER_ITEM = WIN_Y / ROWS_PER_STAGE;
constexpr int CONSUMERS = SLICE / 2;    // one thread per channel pair
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int BLOCKS_PER_SM = 2;
constexpr int RING = 4;                 // stages in a block's ring
constexpr int MAX_STAGE_BYTES = SLICE * WIN_X * ROWS_PER_STAGE * 2;
constexpr int BAR_OUT = 1;              // named barrier: the consumers
constexpr int SMEM_BYTES =
    128 + RING * MAX_STAGE_BYTES + 2 * SLICE * 2 + 2 * RING * 8;

struct __align__(64) ProbeParams {
  CUtensorMap map;     // the buffer: dims {C, wmax, rows}, box {box_c, 16, 2}
  const int4* order;   // (n_views,) {view, row0, x0, 0} by row band
  __nv_bfloat16* out;  // (n_views, 49, C)
  int n_items;         // n_views * n_slices
  int n_slices;        // SLICE-channel slices per view
  int channels;
  int box_c;           // min(C, SLICE)
  int stage_bytes;
  int rows;
  int wmax;
};

// rows per band: BAND, or more where the buffer has over MAX_BANDS bands
int band_rows(int rows) {
  const int band = (rows + MAX_BANDS - 1) / MAX_BANDS;
  return band > BAND ? band : BAND;
}

int order_blocks(int n_views) {
  return (n_views + ORDER_VIEWS - 1) / ORDER_VIEWS;
}

__device__ __forceinline__ int band_of(int r, int rows, int band) {
  return min(max(r, 0), rows - 1) / band;
}

__device__ __forceinline__ bool inside(const int4& v, int rows, int wmax) {
  return v.y >= 0 && v.y + WIN_Y <= rows && v.z >= 0 && v.z + WIN_X <= wmax;
}

// the order pass, first launch: block b counts the views [b, b + 1) *
// ORDER_VIEWS of each band into hist[b]
__global__ void __launch_bounds__(ORDER_THREADS)
count_bands_kernel(const int* __restrict__ row0, int n_views, int rows,
                   int band, int n_bands, int* __restrict__ hist) {
  __shared__ int count[MAX_BANDS];
  const int tid = threadIdx.x;
  for (int b = tid; b < n_bands; b += ORDER_THREADS) count[b] = 0;
  __syncthreads();
  const int v1 = min((blockIdx.x + 1) * ORDER_VIEWS, n_views);
  for (int n = blockIdx.x * ORDER_VIEWS + tid; n < v1; n += ORDER_THREADS)
    atomicAdd(&count[band_of(row0[n], rows, band)], 1);
  __syncthreads();
  for (int b = tid; b < n_bands; b += ORDER_THREADS)
    hist[blockIdx.x * n_bands + b] = count[b];
}

// the order pass, second launch: block b puts its views at their band's
// start, after the views of earlier bands and of earlier blocks in the band
__global__ void __launch_bounds__(ORDER_THREADS)
scatter_views_kernel(const int* __restrict__ row0, const int* __restrict__ x0,
                     int n_views, int rows, int band, int n_bands,
                     const int* __restrict__ hist, int4* __restrict__ order) {
  constexpr int PER = MAX_BANDS / ORDER_THREADS;
  __shared__ int start[MAX_BANDS];
  __shared__ int warp_total[ORDER_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // thread tid owns the bands tid * PER + [0, PER)
  int total[PER], own = 0;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int b = tid * PER + k;
    int all = 0, below = 0;
    if (b < n_bands)
      for (int blk = 0; blk < (int)gridDim.x; ++blk) {
        const int h = hist[blk * n_bands + b];
        all += h;
        below += blk < (int)blockIdx.x ? h : 0;
      }
    total[k] = all;
    own += all;
    if (b < n_bands) start[b] = below;
  }
  // exclusive scan of the threads' totals
  int incl = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_total[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += t;
    }
    warp_total[lane] = w;
  }
  __syncthreads();
  int base = incl - own + (warp ? warp_total[warp - 1] : 0);
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int b = tid * PER + k;
    if (b < n_bands) start[b] += base;
    base += total[k];
  }
  __syncthreads();
  const int v1 = min((blockIdx.x + 1) * ORDER_VIEWS, n_views);
  for (int n = blockIdx.x * ORDER_VIEWS + tid; n < v1; n += ORDER_THREADS) {
    const int r = row0[n];
    order[atomicAdd(&start[band_of(r, rows, band)], 1)] =
        make_int4(n, r, x0[n], 0);
  }
}

// A consumer's two channels, summed over the window's cells in order.
template <typename T>
struct PairSum;

// bf16 windows: two float32 sums
template <>
struct PairSum<__nv_bfloat16> {
  float x = 0.f, y = 0.f;
  // the 16 cells of one window row, `step` elements apart
  __device__ __forceinline__ void add_row(const __nv_bfloat16* p, int step) {
    float2 c[WIN_X];
#pragma unroll
    for (int i = 0; i < WIN_X; ++i)
      c[i] = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(p + i * step));
#pragma unroll
    for (int i = 0; i < WIN_X; ++i) {
      x += c[i].x;
      y += c[i].y;
    }
  }
  __device__ __forceinline__ __nv_bfloat162 rounded() const {
    return __floats2bfloat162_rn(x, y);
  }
};

// int8 windows: every partial float32 sum of at most 160 int8 values is an
// integer below 2^24, so float32 adds them exactly and in any order gives
// their integer sum. So each cell is biased by 128 into [0, 255] and the
// pair summed in the two 16-bit halves of one integer (at most 160 * 255 <
// 2^16, no carry between them): two integer instructions a cell instead of
// int-to-float conversions, which run at a quarter of the add rate.
template <>
struct PairSum<int8_t> {
  uint32_t acc = 0;
  __device__ __forceinline__ void add_row(const int8_t* p, int step) {
    uint32_t c[WIN_X];
#pragma unroll
    for (int i = 0; i < WIN_X; ++i)
      c[i] = *reinterpret_cast<const uint16_t*>(p + i * step);
#pragma unroll
    for (int i = 0; i < WIN_X; ++i)  // bytes b0, b1 -> halves b0, b1
      acc += __byte_perm(c[i] ^ 0x8080u, 0, 0x4140);
  }
  __device__ __forceinline__ __nv_bfloat162 rounded() const {
    constexpr int BIAS = WIN_Y * WIN_X * 128;
    return __floats2bfloat162_rn(
        static_cast<float>(static_cast<int>(acc & 0xffffu) - BIAS),
        static_cast<float>(static_cast<int>(acc >> 16) - BIAS));
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
window_read_probe_kernel(const __grid_constant__ ProbeParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  __nv_bfloat16* staged =
      reinterpret_cast<__nv_bfloat16*>(ring + RING * MAX_STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(staged + 2 * SLICE);
  uint64_t* empty = full + RING;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- the producer: one thread fills the ring by TMA ----
    if (tid != CONSUMERS) return;
    const uint64_t policy = l2_evict_last();
    int s = 0;
    uint32_t phase = 0;
    for (int item = blockIdx.x; item < p.n_items; item += gridDim.x) {
      const int4 v = p.order[item / p.n_slices];
      const int c0 = (item % p.n_slices) * SLICE;
      const bool read = inside(v, p.rows, p.wmax);
      for (int st = 0; st < STAGES_PER_ITEM; ++st) {
        mbar_wait(&empty[s], phase ^ 1);
        if (read) {
          mbar_expect_tx(&full[s], p.stage_bytes);
          tma_load_3d(ring + s * p.stage_bytes, &p.map, &full[s], c0, v.z,
                      v.y + st * ROWS_PER_STAGE, policy);
        } else {
          mbar_arrive(&full[s]);  // nothing read; the consumers skip it
        }
        if (++s == RING) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- the consumers: thread tid owns channels c0 + 2 tid, + 1 ----
  const int lane = tid & 31;
  int s = 0, buf = 0;
  uint32_t phase = 0;
  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x) {
    const int4 v = p.order[item / p.n_slices];
    const int c0 = (item % p.n_slices) * SLICE;
    const int width = min(SLICE, p.channels - c0);
    const bool read = inside(v, p.rows, p.wmax);
    const bool mine = 2 * tid < width;
    PairSum<T> sum;
    for (int st = 0; st < STAGES_PER_ITEM; ++st) {
      mbar_wait(&full[s], phase);
      if (read && mine) {
        const T* stage =
            reinterpret_cast<const T*>(ring + s * p.stage_bytes) + 2 * tid;
#pragma unroll
        for (int y = 0; y < ROWS_PER_STAGE; ++y)
          sum.add_row(stage + y * WIN_X * p.box_c, p.box_c);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (++s == RING) {
        s = 0;
        phase ^= 1;
      }
    }
    // the staged row: every consumer finished this buffer's last stores
    // before the previous item's barrier
    __nv_bfloat16* row = staged + buf * SLICE;
    if (mine)
      reinterpret_cast<__nv_bfloat162*>(row)[tid] =
          read ? sum.rounded() : __floats2bfloat162_rn(NAN, NAN);
    __nv_bfloat16* dst =
        p.out + (size_t)v.x * OUT_ROWS * p.channels + c0;
    bar_sync(BAR_OUT, CONSUMERS);
    const int chunks = width / 8;  // 16-byte chunks of the row
    for (int k = tid; k < OUT_ROWS * chunks; k += CONSUMERS) {
      const int m = k / chunks, j = k - m * chunks;
      __stcs(reinterpret_cast<uint4*>(dst + (size_t)m * p.channels + 8 * j),
             reinterpret_cast<const uint4*>(row)[j]);
    }
    buf ^= 1;
  }
}

template <typename T>
cudaError_t launch_body(const ProbeParams& p, cudaStream_t stream) {
  cudaError_t e =
      cudaFuncSetAttribute(window_read_probe_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_BYTES);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int grid =
      p.n_items < sms * BLOCKS_PER_SM ? p.n_items : sms * BLOCKS_PER_SM;
  window_read_probe_kernel<T>
      <<<grid, THREADS, SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t attrs(int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, window_read_probe_kernel<T>);
  if (e != cudaSuccess) return e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = SMEM_BYTES;
  out[4] = a.maxThreadsPerBlock;
  return cudaSuccess;
}

}  // namespace
}  // namespace mpn

// the int32 words of P's scratch: the ordered views (4 a view), then the
// order pass's per-block band counts
extern "C" long long mpn_window_read_probe_scratch_words(int n_views,
                                                         int rows) {
  using namespace mpn;
  const int band = band_rows(rows);
  return 4LL * n_views +
         (long long)order_blocks(n_views) * ((rows + band - 1) / band);
}

// P: flat (rows, wmax, channels) bf16 (is_int8 == 0) or int8, channels *
// its element size a multiple of 16 and the buffer 16-byte aligned,
// rows >= 10 and wmax >= 16; row0/x0 (n_views,) window origins; scratch
// 16-byte aligned, of mpn_window_read_probe_scratch_words; out (n_views,
// 49, channels) bf16, 16-byte aligned. Three launches: the order pass's
// two, then the body.
extern "C" int mpn_window_read_probe(int is_int8, int n_views,
                                     int rows, int wmax, int channels,
                                     const void* flat, const int* row0,
                                     const int* x0, void* scratch, void* out,
                                     void* stream) {
  using namespace mpn;
  const int size = is_int8 ? 1 : 2;
  if (n_views <= 0 || channels <= 0 || (channels * size) % 16 != 0 ||
      rows < WIN_Y || wmax < WIN_X)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  ProbeParams p;
  p.box_c = channels < SLICE ? channels : SLICE;
  const cuuint64_t dims[3] = {(cuuint64_t)channels, (cuuint64_t)wmax,
                              (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)channels * size,
                                 (cuuint64_t)wmax * channels * size};
  const cuuint32_t box[3] = {(cuuint32_t)p.box_c, WIN_X, ROWS_PER_STAGE};
  const cuuint32_t unit[3] = {1, 1, 1};
  if (encode(&p.map,
             is_int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             3, const_cast<void*>(flat), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  p.order = static_cast<const int4*>(scratch);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.n_slices = (channels + SLICE - 1) / SLICE;
  p.n_items = n_views * p.n_slices;
  p.channels = channels;
  p.stage_bytes = p.box_c * WIN_X * ROWS_PER_STAGE * size;
  p.rows = rows;
  p.wmax = wmax;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int band = band_rows(rows);
  const int n_bands = (rows + band - 1) / band;
  const int blocks = order_blocks(n_views);
  int4* ordered = static_cast<int4*>(scratch);
  int* hist = reinterpret_cast<int*>(ordered + n_views);
  count_bands_kernel<<<blocks, ORDER_THREADS, 0, s>>>(row0, n_views, rows,
                                                     band, n_bands, hist);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  scatter_views_kernel<<<blocks, ORDER_THREADS, 0, s>>>(
      row0, x0, n_views, rows, band, n_bands, hist, ordered);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  e = is_int8 ? launch_body<int8_t>(p, s) : launch_body<__nv_bfloat16>(p, s);
  return static_cast<int>(e);
}

// the body's attributes for is_int8: registers, local bytes (spills),
// static shared bytes, the dynamic shared bytes it launches with, max
// threads per block
extern "C" int mpn_probe_kernel_attrs(int is_int8, int* out) {
  using namespace mpn;
  return static_cast<int>(is_int8 ? attrs<int8_t>(out)
                                  : attrs<__nv_bfloat16>(out));
}
