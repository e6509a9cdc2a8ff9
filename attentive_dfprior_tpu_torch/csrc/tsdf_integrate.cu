// TSDF integration: fuse one RGB-D frame into the volume, in place (Hopper,
// sm_90a).
//
// K5. Replaces no TPU kernel: it is the port's counterpart of the JAX
// package's compiled program attentive_dfprior_tpu/tsdf/fusion.py:32
// (integrate_frame, jax.jit with donate_argnums=(0, 1, 2)), which XLA fuses
// into one loop over the volume written in place. The reference system ships
// the same update as a CUDA kernel (ref: src/fusion.py:69-144). A voxel
// (x, y, z) of the (X, Y, Z) volume is updated so:
//
//   world  p = origin + (x, y, z) * voxel_size
//   camera c = w2c[:3, :3] p + w2c[:3, 3]
//   pixel  (u, v) = round(f * c.xy / c.z + cxy)       (half to even)
//   update where 0 <= u < W, 0 <= v < H, c.z > 0, depth[v, u] > 0 and
//          depth[v, u] - c.z >= -trunc:
//     dist   = min(1, (depth[v, u] - c.z) * (1 / trunc))
//     w_new  = w + obs_weight
//     tsdf   = (tsdf * w + obs_weight * dist) / w_new
//     colour = min(255, round((colour * w + obs_weight * rgb[v, u]) / w_new))
//     weight = w_new
//
// Bound on this card: bytes. The function needs the voxels the frame
// updates read and written (tsdf, weight, 3 colours: 20 B each way) and the
// frame read once; a frame updates a few percent of the volume (1.8 % of
// room0's 196 M voxels for a 680x1200 frame with depth up to 4 m), some
// 150 MB, 0.05 ms at 3.35 TB/s. Their arithmetic (about 54 fp32 operations
// a voxel) is a few microseconds.
//
// Design: cull, then fuse only what can be updated. Whether a voxel is
// updated depends on the geometry and the frame, never on the volume's
// contents, so the voxels no frame pixel can reach are skipped without being
// read. The unit of the cull is a column's run: the voxels (x, y, z0..z1) of
// one (x, y) column of the z-contiguous volume that can pass all of
//
//   in front      c.z > 0
//   within depth  c.z <= dmax + trunc   (dmax: the frame's largest depth > 0)
//   in the image  -0.5 <= f c.x / c.z + cx <= W - 0.5, the same in v
//
// Each test, multiplied through by c.z where it divides, is a half-space in
// the exact (real-valued) camera coordinates, so along a column it bounds z
// from one side: the run is the intersection of six intervals, computed per
// column in double. There is no division by c.z in the rule, so voxels on
// or near the camera plane need no special case: the four image planes meet
// at the camera centre, and the slack below keeps every voxel the rounded
// arithmetic could accept.
//
// The slack. The kernel (and the plain version) compute c with one float32
// rounding per operation: p in 2, c in 4 more, each off by at most
// u = 2^-24 relative. Over the volume, |computed c_r - exact c_r| <=
// 6.03 u (sum_j |w2c[r, j]| Pm_j + |w2c[r, 3]|), with Pm_j = |origin_j| +
// (n_j - 1) voxel_size the largest |p_j|. The rule takes 2^-20 = 16 u in
// place of 6.03 u (E_r below); the spare covers the rule's own double
// arithmetic (relative 2^-53 on terms of the same scale, about 2^-29 of the
// slack). A pixel test that passes after rounding (t = fl(fl(f fl(c.x /
// c.z)) + cx) in [-0.5, W - 0.5]) puts the exact f c.x / c.z within
// 3.02 u (W + |cx| + 1) of that range; the rule widens it by one pixel plus
// 2^-20 (W + |cx| + 1). fl(d - c.z) >= -trunc gives c.z <= d + trunc
// (1 + u); the rule adds 2^-20 trunc. Then, with E_r on each camera
// coordinate, each test is an affine inequality g . (x, y, z) + k >= 0 in
// the voxel index, and per column z >= ceil(-b / g_z) - 1 or z <=
// floor(-b / g_z) + 1 (b = g_x x + g_y y + k; the one voxel each side covers
// the division's rounding). A non-finite pose, intrinsic, origin or voxel
// size keeps every voxel (the whole volume is projected); a frame with no
// depth > 0 keeps none; a depth of +inf drops the depth test (such a
// pixel updates with dist = 1). The plain rule, ops/cuda/tsdf_kernel.py:
// kept_runs_plain, computes the same runs with the same double operations
// in the same order (tests/test_torch_tsdf_cull.py holds it conservative;
// chip_smoke.py phase 2 holds this kernel's runs equal to it on the card).
//
// Three launches a call, on the caller's stream, no host round trip:
//   1. pack_kernel: 512 blocks take the frame's largest depth > 0 (NaN and
//      depth <= 0 ignored, +inf kept) into 512 partial maxima, copy the
//      frame into one float4 image (depth, r, g, b), and zero the item
//      count;
//   2. classify_kernel: each block takes the maximum of the partials and
//      builds the rules (one thread, double); a thread a column computes
//      its run and appends it as items of up to 128 voxels (column, z0, z1)
//      to a list, a warp's items at once with one atomicAdd on the count;
//   3. fuse_kernel: a persistent grid (the SMs times the blocks a SM holds,
//      at most 85 registers a thread so that 3 blocks of 256 fit) walks the
//      list, a warp an item, a lane four voxels 32 apart, until the count
//      read on the card; no block is launched only to exit. A lane projects
//      its four voxels and reads their four pixels (one 16-B load each,
//      kept in the L2 by an evict-last hint) before it reads the volume of
//      those that pass, so that four of each load are in flight at once.
//      The partial sums a px + b py of each camera row are
//      the same along a column and are taken once an item (((a px + b py)
//      + c pz) + d is the plain order, so the bits do not change); w2c,
//      intr and origin are read once a thread into registers.
// The items' order in the list follows the atomics' timing and changes from
// run to run, but no bit depends on it: every voxel is read and written by
// one thread alone and no sum crosses voxels.
//
// What holds it back (measured on an H100: chip_smoke.py phase 2, and a
// clock64 probe of the fusion kernel's stages): the volume's
// read-modify-write. A warp waits some
// 4,500 cycles for the volume's loads of an item, a queue at DRAM, which
// serves these short runs in three arrays (a run's tsdf, weight and colour
// are 3 separate bursts of a few hundred bytes) at 1.6-1.8 TB/s; where a
// frame updates 40 % of a run's voxels scattered through it (phase 2's
// random depths) nearly every 32-B sector of the run is read and written,
// 2.5 times the bytes the updated voxels need. Measured not to move it:
// more loads in flight (eight voxels a lane, more warps), coalesced colours
// through shared memory, streaming hints, a list in column order.
//
// Scratch: one int32 buffer a (device, stream), made by the wrapper at the
// first call and grown only when a volume or a frame needs more (its size:
// tsdf_scratch_words), so later calls allocate nothing: the item count, the
// 512 partials, the float4 image (16 B a pixel: 13 MB at 680x1200) and
// X * Y * ceil(Z / 128) items of 8 B (14 MB at room0, 23 MB at ScanNet's
// 345 M voxels).
//
// Numerics: bit for bit the plain version (ops/cuda/tsdf_kernel.py:
// integrate_frame_plain) as PyTorch runs it on the card, one rounded
// operation per tensor op in the same order: __fmul_rn / __fadd_rn keep the
// compiler from contracting a product and a sum into an FMA, __fdiv_rn is
// IEEE division, rintf rounds half to even as torch.round does. voxel_size
// and obs_weight are float32, as PyTorch casts a Python scalar. The plain
// version divides by trunc, a Python scalar, which PyTorch's CUDA division
// computes as a product with the float32 reciprocal (the wrapper passes
// 1 / trunc, rounded to float32 on the host). The pixel is tested against
// the frame on the rounded float: the plain version's int64 cast is exact
// for every value the test passes, so the two decide alike, and near the
// camera plane (c.z about 1e-8) no 32-bit integer wraps. The rule's double
// arithmetic uses __dmul_rn / __dadd_rn / __ddiv_rn for the same reason.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPackBlocks = 512;
constexpr int kChunk = 128;            // voxels of a column an item covers at most
constexpr int kSlots = kChunk / 32;    // voxels a lane of fuse_kernel takes at once
constexpr int kRules = 6;
constexpr double kSlack = 9.5367431640625e-07;  // 2^-20
constexpr int kCull = 0, kAll = 1, kNone = 2;   // Rules::state

// scratch layout, in 32-bit words: the item count, the partial maxima, the
// float4 image (16-B aligned), then the items
constexpr int kCountWord = 0;
constexpr int kPartialWord = 2;
constexpr int kImageWord = (kPartialWord + kPackBlocks + 3) / 4 * 4;
long long item_word(int H, int W) { return kImageWord + 4LL * H * W; }

struct Rules {
  int state;
  int n;
  double gx[kRules], gy[kRules], gz[kRules], k[kRules], m[kRules];
};

__device__ __forceinline__ double dadd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double dsub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double dmul(double a, double b) { return __dmul_rn(a, b); }

__device__ void add_rule(Rules& r, double gx, double gy, double gz, double k) {
  r.gx[r.n] = gx;
  r.gy[r.n] = gy;
  r.gz[r.n] = gz;
  r.k[r.n] = k;
  r.m[r.n] = gz != 0.0 ? -__ddiv_rn(1.0, gz) : 0.0;
  ++r.n;
}

// The cull's rules for one frame (one thread; kept_runs_plain's cull_rules
// does the same operations in the same order).
__device__ void make_rules(const float* intr, const float* w2c, const float* origin, int X, int Y, int Z,
                           int H, int W, float voxel_size, float trunc, float dmax_f, Rules& r) {
  r.n = 0;
  r.state = kCull;
  if (!(dmax_f > 0.0f)) {  // no pixel with depth > 0: nothing is updated
    r.state = kNone;
    return;
  }
  const double u = kSlack, vs = voxel_size, T = trunc, dmax = dmax_f;
  const int dims[3] = {X, Y, Z};
  double o[3], pm[3], G[3][3], K[3], E[3];
  for (int j = 0; j < 3; ++j) {
    o[j] = origin[j];
    pm[j] = dadd(fabs(o[j]), dmul((double)(dims[j] - 1), fabs(vs)));
  }
  for (int i = 0; i < 3; ++i) {
    const double a0 = w2c[4 * i], a1 = w2c[4 * i + 1], a2 = w2c[4 * i + 2], t = w2c[4 * i + 3];
    G[i][0] = dmul(a0, vs);
    G[i][1] = dmul(a1, vs);
    G[i][2] = dmul(a2, vs);
    K[i] = dadd(dadd(dadd(dmul(a0, o[0]), dmul(a1, o[1])), dmul(a2, o[2])), t);
    E[i] = dmul(u, dadd(dadd(dadd(dmul(fabs(a0), pm[0]), dmul(fabs(a1), pm[1])), dmul(fabs(a2), pm[2])), fabs(t)));
  }
  add_rule(r, G[2][0], G[2][1], G[2][2], dadd(K[2], E[2]));  // in front
  if (!isinf(dmax)) {                                        // within depth
    const double D = dadd(dadd(dadd(dmax, T), dmul(T, u)), E[2]);
    add_rule(r, -G[2][0], -G[2][1], -G[2][2], dsub(D, K[2]));
  }
  for (int a = 0; a < 2; ++a) {  // in the image: u (row 0, fx, cx, W), then v (row 1, fy, cy, H)
    const double f = intr[4 * a], c = intr[3 * a + 2], n = a == 0 ? W : H;
    const double pad = dadd(1.0, dmul(u, dadd(dadd(n, fabs(c)), 1.0)));
    const double lo = dsub(dsub(-0.5, c), pad);
    const double hi = dadd(dsub(dsub(n, 0.5), c), pad);
    double s = dadd(dmul(fabs(f), E[a]), dmul(fabs(lo), E[2]));
    add_rule(r, dsub(dmul(f, G[a][0]), dmul(lo, G[2][0])), dsub(dmul(f, G[a][1]), dmul(lo, G[2][1])),
             dsub(dmul(f, G[a][2]), dmul(lo, G[2][2])), dadd(dsub(dmul(f, K[a]), dmul(lo, K[2])), s));
    s = dadd(dmul(fabs(f), E[a]), dmul(fabs(hi), E[2]));
    add_rule(r, dsub(dmul(hi, G[2][0]), dmul(f, G[a][0])), dsub(dmul(hi, G[2][1]), dmul(f, G[a][1])),
             dsub(dmul(hi, G[2][2]), dmul(f, G[a][2])), dadd(dsub(dmul(hi, K[2]), dmul(f, K[a])), s));
  }
  for (int i = 0; i < r.n; ++i) {
    if (!(isfinite(r.gx[i]) && isfinite(r.gy[i]) && isfinite(r.gz[i]) && isfinite(r.k[i]) && isfinite(r.m[i]))) {
      r.state = kAll;  // a non-finite input: no bound holds, keep every voxel
      return;
    }
  }
}

// The run [z0, z1] of column (x, y); false (and (0, -1)) when it is empty.
__device__ bool column_run(const Rules& r, int x, int y, int Z, int& z0, int& z1) {
  z0 = 0;
  z1 = -1;
  if (r.state == kNone) return false;
  double lo = 0.0, hi = (double)(Z - 1);
  if (r.state == kCull) {
    const double xd = x, yd = y;
    for (int i = 0; i < r.n; ++i) {
      const double b = dadd(dadd(dmul(r.gx[i], xd), dmul(r.gy[i], yd)), r.k[i]);
      if (r.gz[i] > 0.0) {
        lo = fmax(lo, dadd(ceil(dmul(b, r.m[i])), -1.0));
      } else if (r.gz[i] < 0.0) {
        hi = fmin(hi, dadd(floor(dmul(b, r.m[i])), 1.0));
      } else if (b < 0.0) {
        return false;
      }
    }
  }
  if (lo > hi) return false;
  z0 = (int)lo;
  z1 = (int)hi;
  return true;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, d));
  return v;
}

// max over the block of v (every thread gets it); v holds no NaN
__device__ float block_max(float v) {
  __shared__ float part[kThreads / 32];
  v = warp_max(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // part may still be read from an earlier call
  if (lane == 0) part[warp] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? part[lane] : 0.0f;
  return warp_max(v);
}

__global__ void __launch_bounds__(kThreads) pack_kernel(const float* __restrict__ depth_im,
                                                        const float* __restrict__ color_im, long long npix,
                                                        float* __restrict__ partials, unsigned* __restrict__ count,
                                                        float4* __restrict__ img) {
  float m = 0.0f;  // the largest depth > 0: NaN and depth <= 0 never pass d > m
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < npix;
       i += (long long)gridDim.x * blockDim.x) {
    const float d = depth_im[i];
    if (d > m) m = d;
    if (color_im != nullptr) img[i] = make_float4(d, color_im[3 * i], color_im[3 * i + 1], color_im[3 * i + 2]);
  }
  m = block_max(m);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = m;
    if (blockIdx.x == 0) *count = 0;
  }
}

__global__ void __launch_bounds__(kThreads) classify_kernel(
    const float* __restrict__ partials, const float* __restrict__ intr, const float* __restrict__ w2c,
    const float* __restrict__ origin, int X, int Y, int Z, int H, int W, float voxel_size, float trunc,
    unsigned* __restrict__ count, uint2* __restrict__ items, int* __restrict__ runs) {
  __shared__ Rules rules;
  float dm = 0.0f;
  for (int i = threadIdx.x; i < kPackBlocks; i += blockDim.x) dm = fmaxf(dm, partials[i]);
  dm = block_max(dm);
  if (threadIdx.x == 0) make_rules(intr, w2c, origin, X, Y, Z, H, W, voxel_size, trunc, dm, rules);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long ncol = (long long)X * Y;
  for (long long c0 = (long long)blockIdx.x * blockDim.x; c0 < ncol; c0 += (long long)gridDim.x * blockDim.x) {
    const long long c = c0 + threadIdx.x;
    int z0 = 0, z1 = -1;
    if (c < ncol) {
      const int x = (int)(c / Y), y = (int)(c - (long long)x * Y);
      column_run(rules, x, y, Z, z0, z1);
      if (runs != nullptr) {
        runs[2 * c] = z0;
        runs[2 * c + 1] = z1;
      }
    }
    const int n = z1 >= z0 ? (z1 - z0) / kChunk + 1 : 0;
    // a warp's items at once: an inclusive scan of n, one atomicAdd
    int incl = n;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    unsigned base = 0;
    if (lane == 0 && total > 0) base = atomicAdd(count, (unsigned)total);
    base = __shfl_sync(0xffffffffu, base, 0) + (unsigned)(incl - n);
    for (int k = 0; k < n; ++k) {
      const int zs = z0 + k * kChunk;
      const int ze = min(z1, zs + kChunk - 1);
      items[base + k] = make_uint2((unsigned)c, (unsigned)zs | ((unsigned)ze << 16));
    }
  }
}

__global__ void __launch_bounds__(kThreads, 3) fuse_kernel(
    float* __restrict__ tsdf, float* __restrict__ weight, float* __restrict__ color, const float4* __restrict__ img,
    const float* __restrict__ intr, const float* __restrict__ w2c, const float* __restrict__ origin,
    const unsigned* __restrict__ count, const uint2* __restrict__ items, int Y, int Z, int H, int W,
    float voxel_size, float trunc, float inv_trunc, float obs_weight) {
  const float o0 = origin[0], o1 = origin[1], o2 = origin[2];
  const float a00 = w2c[0], a01 = w2c[1], a02 = w2c[2], a03 = w2c[3];
  const float a10 = w2c[4], a11 = w2c[5], a12 = w2c[6], a13 = w2c[7];
  const float a20 = w2c[8], a21 = w2c[9], a22 = w2c[10], a23 = w2c[11];
  const float fx = intr[0], cx = intr[2], fy = intr[4], cy = intr[5];
  const float neg_trunc = -trunc;
  const unsigned n = *count;
  const int lane = threadIdx.x & 31;
  const unsigned warps = gridDim.x * (blockDim.x >> 5);
  unsigned long long keep;  // the image's loads stay in the L2 while the volume streams through it
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(keep));

  for (unsigned it = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); it < n; it += warps) {
    const uint2 item = items[it];
    const int x = (int)(item.x / (unsigned)Y), y = (int)(item.x - (unsigned)x * (unsigned)Y);
    const int zs = (int)(item.y & 0xffffu), ze = (int)(item.y >> 16);
    // voxel -> world: origin + index * voxel_size, each op rounded
    const float px = __fadd_rn(o0, __fmul_rn((float)x, voxel_size));
    const float py = __fadd_rn(o1, __fmul_rn((float)y, voxel_size));
    // world -> camera: ((a*px + b*py) + c*pz) + d, row by row; a*px + b*py once a column
    const float rx = __fadd_rn(__fmul_rn(a00, px), __fmul_rn(a01, py));
    const float ry = __fadd_rn(__fmul_rn(a10, px), __fmul_rn(a11, py));
    const float rz = __fadd_rn(__fmul_rn(a20, px), __fmul_rn(a21, py));
    const long long col = (long long)item.x * Z;

    // the lane's voxels zs + lane + 32 j: the four projections and pixel
    // loads first, used only once all four are issued
    bool ok[kSlots];
    float cz[kSlots], depth[kSlots], diff[kSlots], rgb[kSlots][3];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int z = zs + lane + 32 * j;
      const float pz = __fadd_rn(o2, __fmul_rn((float)z, voxel_size));
      cz[j] = __fadd_rn(__fadd_rn(rz, __fmul_rn(a22, pz)), a23);
      const float cxc = __fadd_rn(__fadd_rn(rx, __fmul_rn(a02, pz)), a03);
      const float cyc = __fadd_rn(__fadd_rn(ry, __fmul_rn(a12, pz)), a13);
      // camera -> pixel, nearest (behind the camera the test fails: the
      // plain version's safe_z never reaches it)
      const float u = rintf(__fadd_rn(__fmul_rn(fx, __fdiv_rn(cxc, cz[j])), cx));
      const float v = rintf(__fadd_rn(__fmul_rn(fy, __fdiv_rn(cyc, cz[j])), cy));
      ok[j] = z <= ze && cz[j] > 0.0f && u >= 0.0f && u < (float)W && v >= 0.0f && v < (float)H;
      float4 p = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (ok[j]) {
        const float4* a = img + ((long long)v * W + (long long)u);
        asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
            : "=f"(p.x), "=f"(p.y), "=f"(p.z), "=f"(p.w) : "l"(a), "l"(keep));
      }
      depth[j] = p.x;
      rgb[j][0] = p.y;
      rgb[j][1] = p.z;
      rgb[j][2] = p.w;
    }
    // then the depth test, and the volume of the voxels that pass, all four
    // loaded before any is used
    float w_old[kSlots], t_old[kSlots], c_old[kSlots][3];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      diff[j] = __fsub_rn(depth[j], cz[j]);
      ok[j] = ok[j] && depth[j] > 0.0f && diff[j] >= neg_trunc;
      if (!ok[j]) continue;
      const long long i = col + zs + lane + 32 * j;
      w_old[j] = weight[i];
      t_old[j] = tsdf[i];
#pragma unroll
      for (int k = 0; k < 3; ++k) c_old[j][k] = color[3 * i + k];
    }
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (!ok[j]) continue;
      float dist = __fmul_rn(diff[j], inv_trunc);
      dist = dist > 1.0f ? 1.0f : dist;  // clamp(max=1): NaN passes as NaN
      const long long i = col + zs + lane + 32 * j;
      const float w_new = __fadd_rn(w_old[j], obs_weight);
      tsdf[i] = __fdiv_rn(__fadd_rn(__fmul_rn(t_old[j], w_old[j]), __fmul_rn(obs_weight, dist)), w_new);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float c = rintf(__fdiv_rn(
            __fadd_rn(__fmul_rn(c_old[j][k], w_old[j]), __fmul_rn(obs_weight, rgb[j][k])), w_new));
        color[3 * i + k] = c > 255.0f ? 255.0f : c;
      }
      weight[i] = w_new;
    }
  }
}

// blocks of a kernel that fit the card at once (a SM's share times the SMs),
// cached by device
template <typename Kernel>
int resident_blocks(Kernel kernel, int (&cached)[64]) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < 64 && cached[dev] > 0) return cached[dev];
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const int blocks = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  if (dev >= 0 && dev < 64) cached[dev] = blocks;
  return blocks;
}

int classify_cache[64] = {0};
int fuse_cache[64] = {0};

// launches 1 and 2: the frame's depth maximum (and, with color_im, its
// float4 image), then the runs as items (and, with runs, each column's
// (z0, z1))
void launch_cull(const float* depth_im, const float* color_im, const float* intr, const float* w2c,
                 const float* origin, int* scratch, int* runs, int X, int Y, int Z, int H, int W, float voxel_size,
                 float trunc, cudaStream_t stream) {
  unsigned* count = reinterpret_cast<unsigned*>(scratch + kCountWord);
  float* partials = reinterpret_cast<float*>(scratch + kPartialWord);
  float4* img = reinterpret_cast<float4*>(scratch + kImageWord);
  uint2* items = reinterpret_cast<uint2*>(scratch + item_word(H, W));
  pack_kernel<<<kPackBlocks, kThreads, 0, stream>>>(depth_im, color_im, (long long)H * W, partials, count, img);
  const long long want = ((long long)X * Y + kThreads - 1) / kThreads;
  const int most = resident_blocks(classify_kernel, classify_cache);
  classify_kernel<<<(int)(want < most ? want : most), kThreads, 0, stream>>>(
      partials, intr, w2c, origin, X, Y, Z, H, W, voxel_size, trunc, count, items, runs);
}

}  // namespace

// 32-bit words of scratch an (X, Y, Z) volume and an (H, W) frame need
extern "C" long long tsdf_scratch_words(int X, int Y, int Z, int H, int W) {
  const long long chunks = ((long long)Z + kChunk - 1) / kChunk;
  return item_word(H, W) + 2LL * X * Y * chunks;
}

extern "C" int tsdf_integrate_launch(float* tsdf, float* weight, float* color, const float* depth_im,
                                     const float* color_im, const float* intr, const float* w2c,
                                     const float* origin, int* scratch, int X, int Y, int Z, int H, int W,
                                     float voxel_size, float trunc, float inv_trunc, float obs_weight,
                                     void* stream) {
  if ((long long)X * Y * Z == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  launch_cull(depth_im, color_im, intr, w2c, origin, scratch, nullptr, X, Y, Z, H, W, voxel_size, trunc, s);
  fuse_kernel<<<resident_blocks(fuse_kernel, fuse_cache), kThreads, 0, s>>>(
      tsdf, weight, color, reinterpret_cast<const float4*>(scratch + kImageWord), intr, w2c, origin,
      reinterpret_cast<const unsigned*>(scratch + kCountWord),
      reinterpret_cast<const uint2*>(scratch + item_word(H, W)), Y, Z, H, W, voxel_size, trunc, inv_trunc,
      obs_weight);
  return (int)cudaGetLastError();
}

// launches 1 and 2 alone (no image), writing each column's run to runs
// (X * Y pairs (z0, z1), (0, -1) when empty): for checks against
// kept_runs_plain
extern "C" int tsdf_kept_runs_launch(const float* depth_im, const float* intr, const float* w2c,
                                     const float* origin, int* scratch, int* runs, int X, int Y, int Z, int H,
                                     int W, float voxel_size, float trunc, void* stream) {
  if ((long long)X * Y * Z == 0) return 0;
  launch_cull(depth_im, nullptr, intr, w2c, origin, scratch, runs, X, Y, Z, H, W, voxel_size, trunc,
              (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
