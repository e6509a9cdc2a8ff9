// Ordered cell scatter: out[idx[i]] += rows[i], summed in a fixed order
// (Hopper, sm_90a).
//
// The port's own kernel: the TPU path has no Pallas kernel here. It
// replaces the JAX package's XLA scatter-add of the cell scatter
// (attentive_dfprior_tpu/ops/grid_sample.py:322, ``.at[cell].add(upd)``),
// the first half of every feature-grid backward: each point's 8 weighted
// corner updates, one (W = 8C)-wide row, added into the row of its floor
// cell. An atomic add sums a cell's rows in the order the threads arrive,
// so two runs part in the last bits; this kernel adds floats with no
// atomics, and its result depends on the inputs alone.
//
// Order of the sum. The indices are sorted stably (equal cells keep the
// points' order), giving scell (sorted cells) and spos (their rows). The
// sorted positions are cut into chunks of CHUNK = 32; a segment is a
// maximal stretch of one cell inside one chunk. Each segment is summed from
// zero in sorted order; each cell's segments are then summed from zero in
// chunk order:
//
//   out[c] = (...((0 + S_1) + S_2) + ...) + S_m,  S_k = (...((0 + r_1) + r_2) ...)
//
// A cell whose rows sit in one chunk has one segment, the sequential sum of
// its rows. ops/cuda/cell_scatter_kernel.py:cell_scatter_plain computes the
// same association with two sequential row sums; the two are bit-identical.
// The longest chain of adds is CHUNK + (run / CHUNK), where a strictly
// sequential sum per cell would chain thousands (every ray's first samples
// share its camera's cells).
//
// Launches (3 + passes: 5 for nrows <= 2^20), all on the caller's stream,
// no host read, scratch from the caller:
//   1. hist: per block of HIST_KEYS indices, the digit counts of every
//      radix pass; traps on an index outside [0, nrows); zeroes the
//      look-back words, the tile counters and the occupancy bytes.
//   2. one stable pass a digit (LSD radix sort over the key range: bits =
//      ceil(log2(nrows)) cut into at least 2 passes of <= 10 bits, the plan
//      from the wrapper). A block takes the next tile of TILE_KEYS keys (a
//      counter: tiles in the order blocks start), sums the histogram
//      blocks' counts of its 4 digits a thread and scans them into the
//      digit starts, ranks its keys stably inside the block (warp w holds
//      keys w*256.. in order; each 32-key step finds the lanes of equal
//      digit by one ballot a bit, and a per-warp digit counter carries the
//      steps), and finds the tile's offset per digit by a decoupled
//      look-back over the earlier tiles' published counts, LOOK words at a
//      time. The first pass reads the int64 indices, makes the positions
//      itself and marks each taken row's occupancy byte (a plain store:
//      every writer writes 1). Counts are integers, so the permutation
//      depends on the inputs alone, and it equals torch.sort(stable=True)'s.
//      Beside the last pass, extra blocks write zeros to every row no index
//      takes: the fill (most of the bytes) runs under the sort (most of the
//      latency).
//   3. sum: the chunk sums, one warp per chunk and 256-column tile. A
//      segment that is a whole run goes to out; the chunk's first segment,
//      if its run began in an earlier chunk, to first[chunk]; its last, if
//      its run starts here and goes on, to last[chunk]. Rows are streamed
//      global -> shared by bulk asynchronous copies (cp.async.bulk, one
//      row's tile each) into a ring of STAGES buffers a warp, completed on
//      mbarriers, so a warp keeps STAGES rows in flight; a width that is
//      not a multiple of 4 floats (or an unaligned base) loads per lane.
//   4. run_join: for a chunk whose last segment starts a run that goes on,
//      0 + last[chunk] + first[chunk + 1] + ... over the run's chunks, to out.
// Every row of out is written once: by a zero block, a chunk sum or run_join.
//
// Bound on this card: memory. The rows are read once (n * W * 4 bytes, in
// the sorted order: each row is W contiguous floats), the indices once, out
// written once (nrows * W * 4 bytes, mostly zeros); the sort moves about
// 40 bytes a key.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 32;                        // sorted positions a chunk: one per lane
constexpr int V = 8;                             // columns a lane holds per tile
constexpr int TILE_COLS = 32 * V;                // columns a warp sums: 256
constexpr int RADIX_BITS = 10;                   // most bits one pass sorts
constexpr int RADIX = 1 << RADIX_BITS;
constexpr int MAX_PASSES = 4;                    // 31 bits
constexpr int SORT_THREADS = 256;
constexpr int SORT_WARPS = SORT_THREADS / 32;
constexpr int ITEMS = 8;                         // keys a thread holds
constexpr int WARP_KEYS = 32 * ITEMS;            // 256 consecutive keys a warp
constexpr int TILE_KEYS = SORT_THREADS * ITEMS;  // 2048 keys a tile of a pass
constexpr int DIGITS = RADIX / SORT_THREADS;     // 4 consecutive digits a thread of a pass
constexpr int LOOK = 8;                          // earlier tiles' words read at once a digit
constexpr int HIST_THREADS = 1024;
constexpr int HIST_KEYS = HIST_THREADS * ITEMS;  // 8192 keys a block of the histogram
constexpr int SUM_WARPS = 4;                     // warps a block of the sum launch
constexpr int STAGES = 4;                        // rows in flight a warp
constexpr int ZERO_BLOCKS = 528;                 // the last pass's zero-fill blocks: 4 an SM
constexpr unsigned FULL = 0xffffffffu;
// a look-back word: the flag in the top two bits, a count (< 2^30) below
constexpr unsigned FLAG_AGG = 1u << 30;     // this tile's own count
constexpr unsigned FLAG_PREFIX = 2u << 30;  // the count of this tile and every earlier one
constexpr unsigned COUNT_MASK = FLAG_AGG - 1;

struct Plan {
  int shift[MAX_PASSES];
  int bits[MAX_PASSES];
};

// The workspace (int32 words): keys and values of two buffers (the last
// pass writes buffer 0: scell, then spos), the histogram blocks' digit
// counts, then what the histogram launch zeroes: the look-back words, the
// tile counters, the occupancy bytes (one a row).
struct Layout {
  long long keys[2], vals[2], hist, status, counter, occ, zero_words, total;
};

Layout layout(long long n, long long nrows, int passes) {
  long long ntiles = (n + TILE_KEYS - 1) / TILE_KEYS, nhist = (n + HIST_KEYS - 1) / HIST_KEYS;
  Layout L;
  long long off = 0;
  for (int b = 0; b < 2; ++b) {
    L.keys[b] = off;
    off += n;
    L.vals[b] = off;
    off += n;
  }
  L.hist = off;
  off += passes * nhist * RADIX;
  L.status = off;
  off += passes * ntiles * RADIX;
  L.counter = off;
  off += MAX_PASSES;
  L.occ = off;
  off += (nrows + 3) / 4;
  L.zero_words = off - L.status;
  L.total = off;
  return L;
}

__device__ __forceinline__ unsigned digit_of(int key, int shift, int bits) {
  return ((unsigned)key >> shift) & ((1u << bits) - 1u);
}

// The lanes whose d equals this lane's, from one ballot a bit (d < 2^(bits + 1)).
__device__ __forceinline__ unsigned match_digit(unsigned d, int bits) {
  unsigned peers = FULL;
  for (int b = 0; b <= bits; ++b) {
    bool set = (d >> b) & 1u;
    unsigned ballot = __ballot_sync(FULL, set);
    peers &= set ? ballot : ~ballot;
  }
  return peers;
}

__global__ void __launch_bounds__(HIST_THREADS)
    hist_kernel(const long long* __restrict__ idx, long long n, long long nrows, int passes, Plan plan,
                int* __restrict__ hist, long long nhist, unsigned* __restrict__ zero, long long zero_words) {
  __shared__ int counts[MAX_PASSES * RADIX];
  for (int i = threadIdx.x; i < passes * RADIX; i += HIST_THREADS) counts[i] = 0;
  long long base = (long long)blockIdx.x * HIST_KEYS;
  long long key[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {  // every load in flight at once
    long long i = base + j * HIST_THREADS + threadIdx.x;
    key[j] = i < n ? idx[i] : 0;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (key[j] < 0 || key[j] >= nrows) __trap();  // an index outside [0, nrows): no sum is defined
    if (base + j * HIST_THREADS + threadIdx.x < n)
      for (int p = 0; p < passes; ++p)
        atomicAdd(&counts[p * RADIX + digit_of((int)key[j], plan.shift[p], plan.bits[p])], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < passes * RADIX; i += HIST_THREADS) {
    int p = i / RADIX, d = i % RADIX;
    hist[((long long)p * nhist + blockIdx.x) * RADIX + d] = counts[i];
  }
  for (long long i = (long long)blockIdx.x * HIST_THREADS + threadIdx.x; i < zero_words;
       i += (long long)gridDim.x * HIST_THREADS)
    zero[i] = 0u;
}

// Zeros to every row no index takes (occ: a byte a row, or nullptr: no
// row taken): warp z of nwarps takes 32 rows at a time.
__device__ __forceinline__ void zero_rows(float* __restrict__ out, int W, const unsigned char* __restrict__ occ,
                                          long long nrows, long long z, long long nwarps) {
  int lane = threadIdx.x & 31;
  for (long long g = z; g * 32 < nrows; g += nwarps) {
    long long mine = g * 32 + lane;
    unsigned taken = __ballot_sync(FULL, occ != nullptr && mine < nrows && occ[mine] != 0);
    int nr = (int)min(32LL, nrows - g * 32);
    for (int r = 0; r < nr; ++r) {
      if ((taken >> r) & 1u) continue;
      float* row = out + (g * 32 + r) * W;
      if ((W & 3) == 0) {
        float4* dst = reinterpret_cast<float4*>(row);
        for (int c = lane; c < W / 4; c += 32) dst[c] = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        for (int c = lane; c < W; c += 32) row[c] = 0.f;
      }
    }
  }
}

// One stable pass over one digit, a tile of TILE_KEYS keys a block of the
// first ntiles; the tiles numbered in the order blocks start (a counter),
// so the look-back waits only on started ones. The first pass (FIRST)
// reads the int64 indices, makes the values (positions) and marks the
// taken rows. The blocks past ntiles (a later pass only, where every taken
// row is marked) write zeros to the rows of out no index takes, beside the
// sort.
template <bool FIRST>
__global__ void __launch_bounds__(SORT_THREADS)
    pass_kernel(const long long* __restrict__ idx64, const int* __restrict__ keys_in,
                const int* __restrict__ vals_in, int* __restrict__ keys_out, int* __restrict__ vals_out,
                unsigned char* __restrict__ occ, int shift, int bits, const int* __restrict__ hist,
                long long nhist, unsigned* status, int* __restrict__ counter, long long n, long long ntiles,
                float* __restrict__ out, int W, long long nrows) {
  __shared__ __align__(16) int wcount[SORT_WARPS][RADIX];  // per warp and digit: its count, then its first slot
  __shared__ int warp_sums[SORT_WARPS];
  __shared__ long long tile_s;
  int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  if (!FIRST && blockIdx.x >= ntiles) {
    long long zb = blockIdx.x - ntiles, nzb = gridDim.x - ntiles;
    zero_rows(out, W, occ, nrows, zb * SORT_WARPS + w, nzb * SORT_WARPS);
    return;
  }
  for (int i = tid; i < SORT_WARPS * RADIX; i += SORT_THREADS) (&wcount[0][0])[i] = 0;
  if (tid == 0) tile_s = atomicAdd(counter, 1);
  __syncthreads();
  long long tile = tile_s;
  long long base = tile * TILE_KEYS + w * WARP_KEYS;

  int key[ITEMS], val[ITEMS], rank[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {  // every load in flight at once
    long long i = base + j * 32 + lane;
    key[j] = val[j] = 0;
    if (i < n) {
      if (FIRST) {
        key[j] = (int)idx64[i];
        val[j] = (int)i;
      } else {
        key[j] = keys_in[i];
        val[j] = vals_in[i];
      }
    }
  }
  // this thread's digits' totals over the histogram blocks
  int total[DIGITS] = {};
#pragma unroll 4
  for (long long hb = 0; hb < nhist; ++hb) {
    int4 c = *reinterpret_cast<const int4*>(hist + hb * RADIX + tid * DIGITS);
    total[0] += c.x;
    total[1] += c.y;
    total[2] += c.z;
    total[3] += c.w;
  }
  // stable ranks: lane order inside a 32-key step, the steps in order (a
  // counter a warp and digit); lanes past n take the digit 1 << bits
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    bool valid = base + j * 32 + lane < n;
    unsigned d = valid ? digit_of(key[j], shift, bits) : 1u << bits;
    unsigned peers = match_digit(d, bits);
    int leader = __ffs(peers) - 1;
    int before = 0;
    if (valid && lane == leader) {
      before = wcount[w][d];
      wcount[w][d] = before + __popc(peers);
    }
    before = __shfl_sync(FULL, before, leader);
    rank[j] = before + __popc(peers & ((1u << lane) - 1u));
    __syncwarp();
    if (FIRST && valid) occ[key[j]] = 1;  // every writer writes the same byte
  }
  __syncthreads();

  // per digit: the warps' exclusive prefix, and this tile's count published
  int count[DIGITS] = {};
#pragma unroll
  for (int ww = 0; ww < SORT_WARPS; ++ww) {
    int4* row = reinterpret_cast<int4*>(&wcount[ww][tid * DIGITS]);
    int4 c = *row;
    *row = make_int4(count[0], count[1], count[2], count[3]);
    count[0] += c.x;
    count[1] += c.y;
    count[2] += c.z;
    count[3] += c.w;
  }
#pragma unroll
  for (int q = 0; q < DIGITS; ++q) {
    unsigned flag = FLAG_AGG;
    if (tile == 0) flag = FLAG_PREFIX;
    *(volatile unsigned*)&status[tile * RADIX + tid * DIGITS + q] = flag | (unsigned)count[q];
  }
  // the digit starts: the totals exclusive-scanned over the block (thread
  // tid holds digits 4 tid .. 4 tid + 3)
  int mine = total[0] + total[1] + total[2] + total[3], x = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[w] = x;
  __syncthreads();
  int start = x - mine;
  for (int ww = 0; ww < w; ++ww) start += warp_sums[ww];
  // the look-back: each digit walks down the earlier tiles, LOOK words read
  // at once, adding their own counts until an inclusive prefix; a word not
  // yet written is read again
  int excl[DIGITS];
  long long next[DIGITS];
  bool done[DIGITS];
  bool all_done = tile == 0;
#pragma unroll
  for (int q = 0; q < DIGITS; ++q) {
    excl[q] = 0;
    next[q] = tile - 1;
    done[q] = tile == 0;
  }
  while (!all_done) {
    unsigned word[DIGITS][LOOK];
#pragma unroll
    for (int q = 0; q < DIGITS; ++q)
#pragma unroll
      for (int i = 0; i < LOOK; ++i) {
        long long t = next[q] - i;
        unsigned v = 0u;
        if (!done[q] && t >= 0) v = *(volatile unsigned*)&status[t * RADIX + tid * DIGITS + q];
        word[q][i] = v;
      }
    all_done = true;
#pragma unroll
    for (int q = 0; q < DIGITS; ++q) {
#pragma unroll
      for (int i = 0; i < LOOK; ++i) {
        unsigned v = word[q][i];
        if (done[q] || (v & ~COUNT_MASK) == 0u) break;
        excl[q] += (int)(v & COUNT_MASK);
        --next[q];
        done[q] = (v & FLAG_PREFIX) != 0u;
      }
      all_done = all_done && done[q];
    }
  }
  int off[DIGITS];
#pragma unroll
  for (int q = 0; q < DIGITS; ++q) {
    if (tile > 0)
      *(volatile unsigned*)&status[tile * RADIX + tid * DIGITS + q] = FLAG_PREFIX | (unsigned)(excl[q] + count[q]);
    off[q] = start + excl[q];
    start += total[q];
  }
#pragma unroll
  for (int ww = 0; ww < SORT_WARPS; ++ww) {
    int4* row = reinterpret_cast<int4*>(&wcount[ww][tid * DIGITS]);
    int4 c = *row;
    *row = make_int4(c.x + off[0], c.y + off[1], c.z + off[2], c.w + off[3]);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (base + j * 32 + lane < n) {
      int dest = wcount[w][digit_of(key[j], shift, bits)] + rank[j];
      keys_out[dest] = key[j];
      vals_out[dest] = val[j];
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(1) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// one row's tile, global -> shared, completing on bar
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

constexpr int SUM_SMEM = SUM_WARPS * (STAGES * TILE_COLS * 4 + STAGES * 8 + CHUNK * 4);

// The chunk sums, a warp per chunk and 256-column tile. bulk: rows streamed
// by cp.async.bulk (W % 4 == 0 and a 16-byte aligned base), else per-lane
// loads.
__global__ void __launch_bounds__(SUM_WARPS * 32)
    sum_kernel(const int* __restrict__ scell, const int* __restrict__ spos, const float* __restrict__ rows,
               float* __restrict__ out, float* __restrict__ first, float* __restrict__ last, long long n, int W,
               int ntiles, int bulk) {
  extern __shared__ __align__(128) unsigned char smem[];
  int wib = threadIdx.x >> 5, lane = threadIdx.x & 31;
  long long warp = (long long)blockIdx.x * SUM_WARPS + wib;
  long long nchunks = (n + CHUNK - 1) / CHUNK;
  if (warp >= nchunks * ntiles) return;
  long long chunk = warp / ntiles;
  int col0 = (int)(warp % ntiles) * TILE_COLS;
  int tlen = min(TILE_COLS, W - col0);
  long long p0 = chunk * CHUNK;
  int len = (int)min((long long)CHUNK, n - p0);
  int my_cell = lane < len ? scell[p0 + lane] : -1;
  int my_row = lane < len ? spos[p0 + lane] : 0;
  int prev_cell = p0 > 0 ? scell[p0 - 1] : -1;
  int next_cell = p0 + len < n ? scell[p0 + len] : -1;

  float* buf = reinterpret_cast<float*>(smem) + wib * STAGES * TILE_COLS;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + SUM_WARPS * STAGES * TILE_COLS * 4) + wib * STAGES;
  int* ridx = reinterpret_cast<int*>(smem + SUM_WARPS * (STAGES * TILE_COLS * 4 + STAGES * 8)) + wib * CHUNK;
  const uint32_t bytes = (uint32_t)tlen * 4u;
  float acc[V], cur[V], nxt[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0f;
  if (bulk) {
    ridx[lane] = my_row;
    if (lane == 0) {
      for (int s = 0; s < STAGES; ++s) mbar_init(&bar[s]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    if (lane == 0)
      for (int j = 0; j < min(STAGES, len); ++j)
        bulk_load(buf + j * TILE_COLS, rows + (long long)ridx[j] * W + col0, bytes, &bar[j]);
  } else {
    // row j + 1 is loaded while row j is added
    long long r = __shfl_sync(FULL, my_row, 0);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      int c = lane + 32 * v;
      nxt[v] = c < tlen ? rows[r * W + col0 + c] : 0.0f;
    }
  }
  bool seg_at_start = true;  // the current segment began at the chunk's first position
  for (int j = 0; j < len; ++j) {
    int cell = __shfl_sync(FULL, my_cell, j);
    int cell_after = __shfl_sync(FULL, my_cell, (j + 1) & 31);
    if (bulk) {
      int s = j % STAGES;
      mbar_wait(&bar[s], (uint32_t)(j / STAGES) & 1u);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        int c = lane + 32 * v;
        cur[v] = c < tlen ? buf[s * TILE_COLS + c] : 0.0f;
      }
      __syncwarp();  // every lane has read stage s before it is refilled
      if (lane == 0 && j + STAGES < len) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bulk_load(buf + s * TILE_COLS, rows + (long long)ridx[j + STAGES] * W + col0, bytes, &bar[s]);
      }
    } else {
      long long r_next = __shfl_sync(FULL, my_row, (j + 1) & 31);
#pragma unroll
      for (int v = 0; v < V; ++v) cur[v] = nxt[v];
      if (j + 1 < len) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          int c = lane + 32 * v;
          nxt[v] = c < tlen ? rows[r_next * W + col0 + c] : 0.0f;
        }
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
      int c = lane + 32 * v;
      if (c < tlen) dst[col0 + c] = acc[v];
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
  int col0 = (int)(warp % ntiles) * TILE_COLS;
  long long p0 = chunk * CHUNK;
  long long p1 = min(p0 + CHUNK, n);
  int cell = scell[p1 - 1];
  // this chunk owns a run that goes on: it starts here and continues past the chunk
  bool starts_here = p0 == 0 || scell[p0 - 1] != cell;
  if (!starts_here || p1 >= n || scell[p1] != cell) return;
  // the run's last chunk: the chunks after this one whose first position holds the cell, 32 tested at once
  long long end = chunk + 1;
  for (long long c0 = chunk + 2;; c0 += 32) {
    long long c = c0 + lane;
    unsigned stop = __ballot_sync(FULL, c >= nchunks || scell[c * CHUNK] != cell);
    if (stop) {
      end = c0 + __ffs(stop) - 2;
      break;
    }
  }
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    int col = col0 + lane + 32 * v;
    acc[v] = col < W ? 0.0f + last[chunk * W + col] : 0.0f;
  }
  for (long long c = chunk + 1; c <= end; ++c) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      int col = col0 + lane + 32 * v;
      if (col < W) acc[v] += first[c * W + col];
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    int col = col0 + lane + 32 * v;
    if (col < W) out[(long long)cell * W + col] = acc[v];
  }
}

}  // namespace

extern "C" int cell_scatter_chunk_size() { return CHUNK; }
extern "C" int cell_scatter_tile_keys() { return TILE_KEYS; }
extern "C" int cell_scatter_warp_keys() { return WARP_KEYS; }
extern "C" int cell_scatter_radix_bits() { return RADIX_BITS; }

// int32 words of workspace for n indices into nrows rows sorted in `passes` passes
extern "C" long long cell_scatter_workspace_words(long long n, long long nrows, int passes) {
  return layout(n, nrows, passes).total;
}

// idx: (n,) int64 in [0, nrows); rows: (n, W) float32; out: (nrows, W),
// every row written; ws: cell_scatter_workspace_words int32 words; fl:
// (2 * ceil(n / CHUNK), W) float32 scratch (first, then last). plan: for
// each pass p < passes, (shift, bits) at plan[2p], plan[2p + 1], bits <=
// RADIX_BITS. sort_only: stop after the sort, leaving scell in ws[0, n) and
// spos in ws[n, 2n). Returns the first CUDA error of a launch, else 0.
extern "C" int cell_scatter_launch(const long long* idx, const float* rows, float* out, int* ws, float* fl,
                                   long long n, long long nrows, int W, int passes, const int* plan_in,
                                   int sort_only, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (passes < 2 || passes > MAX_PASSES || W < 0) return (int)cudaErrorInvalidValue;
  bool bulk = (W & 3) == 0 && ((uintptr_t)rows & 15) == 0;
  int ntiles_col = (W + TILE_COLS - 1) / TILE_COLS;
  if (n == 0) {  // no index: every row is zero
    if (W == 0 || sort_only) return 0;
    pass_kernel<false><<<ZERO_BLOCKS, SORT_THREADS, 0, s>>>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0,
                                                           0, nullptr, 0, nullptr, nullptr, 0, 0, out, W, nrows);
    return (int)cudaGetLastError();
  }
  Plan plan;
  for (int p = 0; p < MAX_PASSES; ++p) {
    plan.shift[p] = p < passes ? plan_in[2 * p] : 0;
    plan.bits[p] = p < passes ? plan_in[2 * p + 1] : 0;
    if (p < passes && (plan.bits[p] < 0 || plan.bits[p] > RADIX_BITS)) return (int)cudaErrorInvalidValue;
  }
  Layout L = layout(n, nrows, passes);
  long long ntiles = (n + TILE_KEYS - 1) / TILE_KEYS, nhist = (n + HIST_KEYS - 1) / HIST_KEYS;
  unsigned* status = reinterpret_cast<unsigned*>(ws + L.status);
  unsigned char* occ = reinterpret_cast<unsigned char*>(ws + L.occ);
  hist_kernel<<<(unsigned)nhist, HIST_THREADS, 0, s>>>(idx, n, nrows, passes, plan, ws + L.hist, nhist, status,
                                                       L.zero_words);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bool fill = !sort_only && W > 0;
  for (int p = 0; p < passes; ++p) {
    int out_b = (passes - 1 - p) % 2, in_b = (passes - p) % 2;  // the last pass writes buffer 0
    auto kernel = p == 0 ? pass_kernel<true> : pass_kernel<false>;
    long long blocks = ntiles + (p == passes - 1 && fill ? ZERO_BLOCKS : 0);  // the zero fill beside the last pass
    kernel<<<(unsigned)blocks, SORT_THREADS, 0, s>>>(
        idx, ws + L.keys[in_b], ws + L.vals[in_b], ws + L.keys[out_b], ws + L.vals[out_b], occ, plan.shift[p],
        plan.bits[p], ws + L.hist + (long long)p * nhist * RADIX, nhist, status + (long long)p * ntiles * RADIX,
        ws + L.counter + p, n, ntiles, out, W, nrows);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (sort_only || W == 0) return 0;
  const int* scell = ws + L.keys[0];
  const int* spos = ws + L.vals[0];
  long long nchunks = (n + CHUNK - 1) / CHUNK;
  float* first = fl;
  float* last = fl + nchunks * W;
  long long sum_warps = nchunks * ntiles_col;
  long long blocks = (sum_warps + SUM_WARPS - 1) / SUM_WARPS;
  sum_kernel<<<(unsigned)blocks, SUM_WARPS * 32, bulk ? SUM_SMEM : 0, s>>>(scell, spos, rows, out, first, last, n,
                                                                          W, ntiles_col, bulk ? 1 : 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int threads = 128;
  long long join_blocks = (sum_warps * 32 + threads - 1) / threads;
  run_join_kernel<<<(unsigned)join_blocks, threads, 0, s>>>(scell, first, last, out, n, W, ntiles_col);
  return (int)cudaGetLastError();
}
