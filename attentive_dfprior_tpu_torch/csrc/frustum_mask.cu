// Frustum masks: the mapper's gradient masks of one frame, on the card
// (Hopper, sm_90a).
//
// K6. Replaces no TPU kernel: the JAX package computes these masks on the
// host in numpy (attentive_dfprior_tpu/slam/mapper.py, get_frustum_mask),
// as does the port on the CPU (slam/mapper.py:get_frustum_mask). This kernel
// computes the same masks, operation for operation, for every grid of a map
// at once. For one lattice (nx, ny, nz) over the scene bound:
//
//   point    p = (x_i, y_j, z_k), x_i = i * step + start (np.linspace: the
//            last point is stop)
//   camera   c = w2c[:3] (p, 1), its x negated
//   pixel    q = K c, z = q.z + 1e-5, (u, v) = float32(q.xy / z)
//   depth    d = float32 of the bilinear sample of the frame at (u, v),
//            zero outside (mapper.py:_bilinear_sample_border0: NaN to
//            -1e9, +-inf to +-1e9, clipped to [-2, W + 1], floor, four taps
//            with weights in float64 summed in the order (u0, v0), (u0 + 1,
//            v0), (u0, v0 + 1), (u0 + 1, v0 + 1))
//   zeros    a sample of 0 counts as the lattice's largest sample
//   keep     (0 < u < W and 0 < v < H and 0 <= -z and -z <= float32(d + 0.5))
//            or |p - eye|^2 < 0.25 (eye: the camera centre, c2w[:3, 3])
//
// Numerics: double throughout, one rounded operation per numpy operation in
// numpy's order: __dmul_rn / __dadd_rn / __ddiv_rn keep the compiler from
// contracting a product and a sum into an FMA (the build's flags are shared
// by every kernel of the port, so the source says it itself). The 4x4 and
// 3x3 products are summed left to right; numpy's BLAS may round one of them
// differently in the last place, which can move a mask only where a value
// lies within that place of a threshold. w2c is numpy's inverse of the pose,
// computed on the host; the lattice's start, step and stop per axis come
// from the host as np.linspace computes them (ops/cuda/frustum_kernel.py:
// pack).
//
// Bound on this card: launches. Room0's three grids are 387,464 lattice
// points a map (ScanNet's 664,608), of which the high and colour grids share
// one lattice, so 204,008 (ScanNet 337,652) are computed; each costs some 70
// double operations and four taps of a frame the L2 holds, and writes 4 or
// 8 bytes: a few microseconds of work in two launches.
//
// Two launches a call, on the caller's stream, no host round trip:
//   1. sample_kernel: kBlocks blocks a lattice sample the frame at each
//      point and write each block's largest sample to a partial (an
//      order-preserving key of the float, NaN above every number, as
//      numpy's max returns NaN where a sample is NaN);
//   2. mask_kernel: each block takes the maximum of its lattice's partials,
//      samples each point again (the same operations, so the same bits) and
//      writes 1.0f or 0.0f to every grid buffer of the lattice.
// Scratch: the partials, kMaxLattices x kBlocks words a (device, stream),
// made by the wrapper; every launch 1 writes all of its lattices' partials,
// so nothing needs zeroing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocks = 128;  // blocks a lattice, and partial maxima a lattice
constexpr int kMaxLattices = 3;
constexpr int kMaxOuts = 3;  // grid buffers a lattice
constexpr int kHeadDoubles = 30;  // w2c (16), K (9), eye (3), the camera's W and H
constexpr int kLatticeDoubles = 9;  // start, step, stop per axis

struct Lattice {
  double start[3], step[3], stop[3];
  int n[3];
  long long points;
  float* out[kMaxOuts];
};

struct Params {
  double w2c[12];  // rows 0-2 of the 4x4 inverse pose
  double K[9];
  double eye[3];
  double cam_w, cam_h;
  int H, W;  // the depth frame
  const float* depth;
  Lattice lat[kMaxLattices];
};

__device__ __forceinline__ double dadd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double dsub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double dmul(double a, double b) { return __dmul_rn(a, b); }

// np.linspace's point i of n
__device__ __forceinline__ double coord(const Lattice& L, int a, int i) {
  return (L.n[a] > 1 && i == L.n[a] - 1) ? L.stop[a] : dadd(dmul((double)i, L.step[a]), L.start[a]);
}

// the NaN / inf replacement and clip of the sampler, float32
__device__ __forceinline__ float clean(float t, float hi) {
  if (isnan(t)) t = -1e9f;
  else if (isinf(t)) t = t > 0.0f ? 1e9f : -1e9f;
  return fminf(fmaxf(t, -2.0f), hi);
}

__device__ __forceinline__ double tap(const Params& P, int iu, int iv) {
  return (iu >= 0 && iu < P.W && iv >= 0 && iv < P.H) ? (double)__ldg(P.depth + (long long)iv * P.W + iu) : 0.0;
}

struct Probe {
  float u, v;  // the pixel, float32
  double nz;   // -z
  float d;     // the depth sample
};

__device__ Probe probe(const Params& P, double x, double y, double z) {
  double c[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const double* w = P.w2c + 4 * r;
    c[r] = dadd(dadd(dadd(dmul(w[0], x), dmul(w[1], y)), dmul(w[2], z)), w[3]);
  }
  c[0] = -c[0];
  double q[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const double* k = P.K + 3 * r;
    q[r] = dadd(dadd(dmul(k[0], c[0]), dmul(k[1], c[1])), dmul(k[2], c[2]));
  }
  const double zz = dadd(q[2], 1e-5);
  Probe out;
  out.u = __double2float_rn(__ddiv_rn(q[0], zz));
  out.v = __double2float_rn(__ddiv_rn(q[1], zz));
  out.nz = -zz;
  const float su = clean(out.u, (float)P.W + 1.0f);
  const float sv = clean(out.v, (float)P.H + 1.0f);
  const float fu = floorf(su), fv = floorf(sv);
  const int u0 = (int)fu, v0 = (int)fv;
  const double du = dsub((double)su, (double)fu), dv = dsub((double)sv, (double)fv);
  const double au = dsub(1.0, du), av = dsub(1.0, dv);
  double acc = 0.0;
  acc = dadd(acc, dmul(dmul(au, av), tap(P, u0, v0)));
  acc = dadd(acc, dmul(dmul(du, av), tap(P, u0 + 1, v0)));
  acc = dadd(acc, dmul(dmul(au, dv), tap(P, u0, v0 + 1)));
  acc = dadd(acc, dmul(dmul(du, dv), tap(P, u0 + 1, v0 + 1)));
  out.d = __double2float_rn(acc);
  return out;
}

// a float's order-preserving key (NaN above +inf, 0 below every number)
__device__ __forceinline__ unsigned key_of(float f) {
  if (isnan(f)) return 0xFFFFFFFFu;
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float float_of(unsigned k) {
  if (k == 0xFFFFFFFFu) return __uint_as_float(0x7FC00000u);
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

__device__ __forceinline__ unsigned block_max(unsigned k, unsigned* shared) {
  k = __reduce_max_sync(0xFFFFFFFFu, k);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) shared[warp] = k;
  __syncthreads();
  if (warp == 0) {
    k = lane < kThreads / 32 ? shared[lane] : 0u;
    k = __reduce_max_sync(0xFFFFFFFFu, k);
    if (lane == 0) shared[0] = k;
  }
  __syncthreads();
  return shared[0];
}

__device__ __forceinline__ void point_of(const Lattice& L, long long p, double& x, double& y, double& z) {
  const long long yz = (long long)L.n[1] * L.n[2];
  const int i = (int)(p / yz);
  const long long r = p - (long long)i * yz;
  const int j = (int)(r / L.n[2]);
  const int k = (int)(r - (long long)j * L.n[2]);
  x = coord(L, 0, i);
  y = coord(L, 1, j);
  z = coord(L, 2, k);
}

__global__ void __launch_bounds__(kThreads) sample_kernel(const Params P, unsigned* partials) {
  __shared__ unsigned shared[kThreads / 32];
  const Lattice& L = P.lat[blockIdx.y];
  unsigned best = 0u;
  for (long long p = (long long)blockIdx.x * kThreads + threadIdx.x; p < L.points; p += (long long)kBlocks * kThreads) {
    double x, y, z;
    point_of(L, p, x, y, z);
    const unsigned k = key_of(probe(P, x, y, z).d);
    best = k > best ? k : best;
  }
  best = block_max(best, shared);
  if (threadIdx.x == 0) partials[blockIdx.y * kBlocks + blockIdx.x] = best;
}

__global__ void __launch_bounds__(kThreads) mask_kernel(const Params P, const unsigned* partials) {
  __shared__ unsigned shared[kThreads / 32];
  const Lattice& L = P.lat[blockIdx.y];
  const float dmax = float_of(block_max(threadIdx.x < kBlocks ? partials[blockIdx.y * kBlocks + threadIdx.x] : 0u,
                                        shared));
  for (long long p = (long long)blockIdx.x * kThreads + threadIdx.x; p < L.points; p += (long long)kBlocks * kThreads) {
    double x, y, z;
    point_of(L, p, x, y, z);
    const Probe s = probe(P, x, y, z);
    const float d = s.d == 0.0f ? dmax : s.d;
    const bool seen = (double)s.u < P.cam_w && (double)s.u > 0.0 && (double)s.v < P.cam_h && (double)s.v > 0.0 &&
                      0.0 <= s.nz && s.nz <= (double)__fadd_rn(d, 0.5f);
    const double dx = dsub(x, P.eye[0]), dy = dsub(y, P.eye[1]), dz = dsub(z, P.eye[2]);
    const bool near = dadd(dadd(dmul(dx, dx), dmul(dy, dy)), dmul(dz, dz)) < 0.25;
    const float m = (seen || near) ? 1.0f : 0.0f;
#pragma unroll
    for (int o = 0; o < kMaxOuts; ++o)
      if (L.out[o] != nullptr) L.out[o][p] = m;
  }
}

}  // namespace

// 32-bit words of scratch a call needs
extern "C" int frustum_partials_words() { return kMaxLattices * kBlocks; }

// params: kHeadDoubles doubles (w2c 4x4 row-major, K 3x3 row-major, the
// camera centre, the camera's W and H), then kLatticeDoubles a lattice
// (start, step, stop per axis); dims: (nx, ny, nz) a lattice; outs:
// kMaxOuts float buffers a lattice (null where unused), each nx * ny * nz;
// all three on the host. depth: (H, W) float32 on the card.
extern "C" int frustum_mask_launch(const double* params, const int* dims, float* const* outs, int lattices,
                                   const float* depth, int H, int W, unsigned* partials, void* stream) {
  if (lattices < 1 || lattices > kMaxLattices) return (int)cudaErrorInvalidValue;
  Params P;
  for (int i = 0; i < 12; ++i) P.w2c[i] = params[i];
  for (int i = 0; i < 9; ++i) P.K[i] = params[16 + i];
  for (int i = 0; i < 3; ++i) P.eye[i] = params[25 + i];
  P.cam_w = params[28];
  P.cam_h = params[29];
  P.H = H;
  P.W = W;
  P.depth = depth;
  for (int l = 0; l < kMaxLattices; ++l) {
    Lattice& L = P.lat[l];
    const bool on = l < lattices;
    for (int a = 0; a < 3; ++a) {
      const double* q = params + kHeadDoubles + kLatticeDoubles * l;
      L.start[a] = on ? q[a] : 0.0;
      L.step[a] = on ? q[3 + a] : 0.0;
      L.stop[a] = on ? q[6 + a] : 0.0;
      L.n[a] = on ? dims[3 * l + a] : 0;
    }
    L.points = (long long)L.n[0] * L.n[1] * L.n[2];
    for (int o = 0; o < kMaxOuts; ++o) L.out[o] = on ? outs[kMaxOuts * l + o] : nullptr;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(kBlocks, lattices);
  sample_kernel<<<grid, kThreads, 0, s>>>(P, partials);
  mask_kernel<<<grid, kThreads, 0, s>>>(P, partials);
  return (int)cudaGetLastError();
}
