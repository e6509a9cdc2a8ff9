// Ordered cell scatter: out[idx[i]] += rows[i], summed in a fixed order
// (Hopper, sm_90a).
//
// The port's own kernel: the TPU path has no Pallas kernel here. It
// replaces the JAX package's XLA scatter-add of the cell scatter
// (attentive_dfprior_tpu/ops/grid_sample.py:322, ``.at[cell].add(upd)``),
// the first half of every feature-grid backward: each point's 8 weighted
// corner updates, one (W = 8C)-wide row, added into the row of its floor
// cell. An atomic add sums a cell's rows in the order the threads arrive,
// so two runs part in the last bits; this kernel has no atomics, and its
// result depends on the inputs alone.
//
// Order of the sum. The wrapper sorts the indices (a stable sort: equal
// cells keep the points' order), giving scell (sorted cells) and order
// (their rows). The sorted positions are cut into chunks of CHUNK = 32; a
// segment is a maximal stretch of one cell inside one chunk. Each segment
// is summed from zero in sorted order; each cell's segments are then summed
// from zero in chunk order:
//
//   out[c] = (...((0 + S_1) + S_2) + ...) + S_m,  S_k = (...((0 + r_1) + r_2) ...)
//
// A cell whose rows sit in one chunk has one segment, the sequential sum of
// its rows. ops/cuda/cell_scatter_kernel.py:cell_scatter_plain computes the
// same association with two sequential row sums; the two are bit-identical.
// A strictly sequential sum per cell would chain thousands of adds where
// many rays leave one camera (every ray's first samples share the camera's
// cells): here the longest chain is CHUNK + (run / CHUNK).
//
// Kernels (one warp per chunk and 32*V-column tile; lane l holds columns
// l, l + 32, ...):
//   chunk_sum: the chunk's segments in order. A segment that is a whole run
//     (it starts and ends the cell's rows) is written to out directly; the
//     chunk's first segment, if its run began in an earlier chunk, goes to
//     first[chunk]; its last segment, if its run starts in this chunk and
//     goes on past it, to last[chunk].
//   run_join: for a chunk whose last segment starts a run that goes on, the
//     sum 0 + last[chunk] + first[chunk + 1] + ... over the chunks the run
//     spans, written to out.
// Rows of out no index names keep the zeros the wrapper wrote.
//
// Bound on this card: memory. The rows are read once (n * W * 4 bytes, in
// the sorted order: each row is W contiguous floats), the indices once, out
// written once (nrows * W * 4 bytes, mostly the wrapper's zeros).

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 32;  // sorted positions a chunk: one per lane
constexpr int V = 8;       // columns a lane holds per tile: a tile is 256 columns

__global__ void chunk_sum_kernel(const int* __restrict__ scell, const long long* __restrict__ order,
                                 const float* __restrict__ rows, float* __restrict__ out,
                                 float* __restrict__ first, float* __restrict__ last, long long n, int W,
                                 int ntiles) {
  long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  long long nchunks = (n + CHUNK - 1) / CHUNK;
  if (warp >= nchunks * ntiles) return;
  long long chunk = warp / ntiles;
  int col0 = (int)(warp % ntiles) * 32 * V;
  long long p0 = chunk * CHUNK;
  int len = (int)min((long long)CHUNK, n - p0);
  int my_cell = lane < len ? scell[p0 + lane] : -1;
  long long my_row = lane < len ? order[p0 + lane] : 0;
  int prev_cell = p0 > 0 ? scell[p0 - 1] : -1;
  int next_cell = p0 + len < n ? scell[p0 + len] : -1;

  float acc[V], nxt[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0f;
  // row j + 1 is loaded while row j is added
  long long r = __shfl_sync(0xffffffffu, my_row, 0);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    int col = col0 + lane + 32 * v;
    nxt[v] = col < W ? rows[r * W + col] : 0.0f;
  }
  bool seg_at_start = true;  // the current segment began at the chunk's first position
  for (int j = 0; j < len; ++j) {
    int cell = __shfl_sync(0xffffffffu, my_cell, j);
    int cell_after = __shfl_sync(0xffffffffu, my_cell, (j + 1) & 31);
    long long r_next = __shfl_sync(0xffffffffu, my_row, (j + 1) & 31);
    float cur[V];
#pragma unroll
    for (int v = 0; v < V; ++v) cur[v] = nxt[v];
    if (j + 1 < len) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        int col = col0 + lane + 32 * v;
        nxt[v] = col < W ? rows[r_next * W + col] : 0.0f;
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] += cur[v];
    bool at_end = j + 1 == len;
    if (!at_end && cell_after == cell) continue;
    // the segment ends at position j
    bool starts_run = !seg_at_start || prev_cell != cell;
    bool ends_run = !at_end || next_cell != cell;
    float* dst;
    if (starts_run && ends_run) {
      dst = out + (long long)cell * W;
    } else if (starts_run) {
      dst = last + chunk * W;
    } else {
      dst = first + chunk * W;
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      int col = col0 + lane + 32 * v;
      if (col < W) dst[col] = acc[v];
      acc[v] = 0.0f;
    }
    seg_at_start = false;
  }
}

__global__ void run_join_kernel(const int* __restrict__ scell, const float* __restrict__ first,
                                const float* __restrict__ last, float* __restrict__ out, long long n, int W,
                                int ntiles) {
  long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  long long nchunks = (n + CHUNK - 1) / CHUNK;
  if (warp >= nchunks * ntiles) return;
  long long chunk = warp / ntiles;
  int col0 = (int)(warp % ntiles) * 32 * V;
  long long p0 = chunk * CHUNK;
  long long p1 = min(p0 + CHUNK, n);
  int cell = scell[p1 - 1];
  // this chunk owns a run that goes on: it starts here and continues past the chunk
  bool starts_here = p0 == 0 || scell[p0 - 1] != cell;
  if (!starts_here || p1 >= n || scell[p1] != cell) return;
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    int col = col0 + lane + 32 * v;
    acc[v] = col < W ? 0.0f + last[chunk * W + col] : 0.0f;
  }
  for (long long c = chunk + 1; c < nchunks; ++c) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      int col = col0 + lane + 32 * v;
      if (col < W) acc[v] += first[c * W + col];
    }
    long long e = (c + 1) * CHUNK;
    if (e >= n || scell[e] != cell) break;
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    int col = col0 + lane + 32 * v;
    if (col < W) out[(long long)cell * W + col] = acc[v];
  }
}

}  // namespace

extern "C" int cell_scatter_chunk_size() { return CHUNK; }

// scell: (n,) sorted cells; order: (n,) their rows in rows (n, W); out:
// (nrows, W), zeroed; first, last: (ceil(n / CHUNK), W) scratch.
extern "C" int cell_scatter_launch(const int* scell, const long long* order, const float* rows, float* out,
                                   float* first, float* last, long long n, int W, void* stream) {
  if (n == 0 || W == 0) return 0;
  int ntiles = (W + 32 * V - 1) / (32 * V);
  long long warps = (n + CHUNK - 1) / CHUNK * ntiles;
  const int threads = 128;
  long long blocks = (warps * 32 + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  chunk_sum_kernel<<<(unsigned)blocks, threads, 0, s>>>(scell, order, rows, out, first, last, n, W, ntiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  run_join_kernel<<<(unsigned)blocks, threads, 0, s>>>(scell, first, last, out, n, W, ntiles);
  return (int)cudaGetLastError();
}
