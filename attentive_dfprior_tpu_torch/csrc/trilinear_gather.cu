// Trilinear feature-grid lookup: the scene query's forward, on the card
// (Hopper, sm_90a).
//
// K7. Replaces no Pallas kernel: the JAX package leaves the lookup to XLA
// (attentive_dfprior_tpu/ops/grid_sample.py, trilinear_sample: eight row
// gathers and the blends between them), and the port's plain version
// (ops/grid_sample.py:trilinear_sample) launches some 85 kernels a grid, each
// gather and each blend writing a whole (N, C) tensor. This kernel computes
// the same values, bit for bit, in one launch a grid, or in one launch for a
// pair of grids of one shape sampled at the same points. A channels-last grid
// (nx, ny, nz, C), a point p in [-1, 1]^3 (outside clamps to the border):
//
//   idx  = min(max(((p + 1) * 0.5) * (n - 1), 0), n - 1)     each axis, float32
//   i0   = min(int64(floor(idx)), n - 1), i1 = min(i0 + 1, n - 1), f = idx - i0
//   c_xy = g[x, y, z0] * (1 - fz) + g[x, y, z1] * fz           (x, y) = (x0 | x1, y0 | y1)
//   c_x  = c_x,y0 * (1 - fy) + c_x,y1 * fy
//   out  = c_x0 * (1 - fx) + c_x1 * fx
//
// Numerics: every operation rounded once, in the plain version's order:
// __fadd_rn / __fsub_rn / __fmul_rn keep the compiler from contracting a
// product and a sum into an FMA. The clamps are torch.maximum and
// torch.minimum's (a NaN passes, fmaxf / fminf otherwise), floor and the
// int64 cast torch's (cvt.rzi: a NaN becomes 0, so a NaN point reads the
// first cell and blends to NaN, as the plain version does on the card).
//
// Bound on this card: bytes. A point reads its 12 bytes and writes 4C bytes
// a grid: at a render chunk (480,000 points, C = 32) 61.4 MB a grid, larger
// than the 50 MB L2, so the output streams to HBM. Its 8 corner rows (8 x 4C
// bytes a grid) are a thin slab of grids the L2 holds (room0: 2.9 and 23.3
// MB) and, since consecutive points lie along one ray and share cells, often
// of rows the L1 holds already. The design:
//   - C/4 lanes a point, four channels a lane: a corner row is one coalesced
//     16-byte load a lane, the output row one coalesced 16-byte store;
//   - corner rows through the read-only path (ld.global.nc, cached in L1);
//     all 8 (pair: 16) loads of a lane issued before the first blend;
//   - the output written with st.global.cs (streaming), so the rows written
//     once do not push the grid out of the L2;
//   - nothing between the loads and the store leaves the registers;
//   - a grid-stride loop over the points (9,600 a tracking iteration to
//     480,000 a render chunk), at most kBlocksPerSm blocks an SM.
// No allocation and no synchronisation: the wrapper allocates the outputs,
// so a launch can be captured into a CUDA graph.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

struct Args {
  const float* points;  // (n, 3)
  const float* grid[2];  // (nx, ny, nz, C) each
  float* out[2];  // (n, C) each
  long long n;
  int nx, ny, nz;
};

// torch.maximum / torch.minimum of float32 tensors on the card
__device__ __forceinline__ float tmax(float a, float b) { return a != a ? a : (b != b ? b : fmaxf(a, b)); }
__device__ __forceinline__ float tmin(float a, float b) { return a != a ? a : (b != b ? b : fminf(a, b)); }

// one axis of _floor_cell: the floor and upper corners and the fraction
__device__ __forceinline__ void axis(float p, int n, long long& i0, long long& i1, float& f) {
  const float top = __fsub_rn((float)n, 1.0f);
  float idx = __fmul_rn(__fmul_rn(__fadd_rn(p, 1.0f), 0.5f), top);
  idx = tmin(tmax(idx, 0.0f), top);
  const long long last = (long long)n - 1;
  const long long fl = (long long)floorf(idx);
  i0 = fl < last ? fl : last;
  i1 = i0 + 1 < last ? i0 + 1 : last;
  f = __fsub_rn(idx, (float)i0);
}

__device__ __forceinline__ float mix(float a, float wa, float b, float wb) {
  return __fadd_rn(__fmul_rn(a, wa), __fmul_rn(b, wb));
}

__device__ __forceinline__ float4 mix4(const float4& a, float wa, const float4& b, float wb) {
  return make_float4(mix(a.x, wa, b.x, wb), mix(a.y, wa, b.y, wb), mix(a.z, wa, b.z, wb), mix(a.w, wa, b.w, wb));
}

template <int C, int G>
__global__ void __launch_bounds__(kThreads) trilinear_gather_kernel(const Args a) {
  constexpr int kLanes = C / 4;  // lanes a point
  constexpr int kPoints = kThreads / kLanes;  // points a block takes a pass
  const int lane = threadIdx.x % kLanes;
  const long long stride = (long long)gridDim.x * kPoints;
  for (long long i = (long long)blockIdx.x * kPoints + threadIdx.x / kLanes; i < a.n; i += stride) {
    const float* p = a.points + 3 * i;
    long long x0, x1, y0, y1, z0, z1;
    float fx, fy, fz;
    axis(__ldg(p), a.nx, x0, x1, fx);
    axis(__ldg(p + 1), a.ny, y0, y1, fy);
    axis(__ldg(p + 2), a.nz, z0, z1, fz);
    const long long ny = a.ny, nz = a.nz;
    // corner k = 4cx + 2cy + cz, the plain version's order of gathers
    const long long rows[8] = {(x0 * ny + y0) * nz + z0, (x0 * ny + y0) * nz + z1,
                               (x0 * ny + y1) * nz + z0, (x0 * ny + y1) * nz + z1,
                               (x1 * ny + y0) * nz + z0, (x1 * ny + y0) * nz + z1,
                               (x1 * ny + y1) * nz + z0, (x1 * ny + y1) * nz + z1};
    float4 v[G][8];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int k = 0; k < 8; ++k) v[g][k] = __ldg(reinterpret_cast<const float4*>(a.grid[g] + rows[k] * C) + lane);
    const float wz = __fsub_rn(1.0f, fz), wy = __fsub_rn(1.0f, fy), wx = __fsub_rn(1.0f, fx);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float4 c00 = mix4(v[g][0], wz, v[g][1], fz);
      const float4 c01 = mix4(v[g][2], wz, v[g][3], fz);
      const float4 c10 = mix4(v[g][4], wz, v[g][5], fz);
      const float4 c11 = mix4(v[g][6], wz, v[g][7], fz);
      const float4 c0 = mix4(c00, wy, c01, fy);
      const float4 c1 = mix4(c10, wy, c11, fy);
      __stcs(reinterpret_cast<float4*>(a.out[g] + i * C) + lane, mix4(c0, wx, c1, fx));
    }
  }
}

template <int C, int G>
int launch(const Args& a, int n_sm, cudaStream_t s) {
  constexpr int kPoints = kThreads / (C / 4);
  long long blocks = (a.n + kPoints - 1) / kPoints;
  const long long most = (long long)n_sm * kBlocksPerSm;
  if (blocks > most) blocks = most;
  trilinear_gather_kernel<C, G><<<(unsigned)blocks, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <int G>
int dispatch(const Args& a, int c, int n_sm, cudaStream_t s) {
  switch (c) {
    case 8: return launch<8, G>(a, n_sm, s);
    case 16: return launch<16, G>(a, n_sm, s);
    case 32: return launch<32, G>(a, n_sm, s);
    case 64: return launch<64, G>(a, n_sm, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// whether the kernel takes c channels a grid row
extern "C" int trilinear_gather_takes(int c) { return c == 8 || c == 16 || c == 32 || c == 64; }

// points: (n, 3) float32; grid_a, grid_b: (nx, ny, nz, c) float32, grid_b
// null for a single grid; out_a, out_b: (n, c) float32 (out_b null with
// grid_b); every pointer on the card, 16-byte aligned and contiguous.
extern "C" int trilinear_gather_launch(const float* points, long long n, const float* grid_a, const float* grid_b,
                                       float* out_a, float* out_b, int nx, int ny, int nz, int c, int n_sm,
                                       void* stream) {
  if (n <= 0 || nx < 1 || ny < 1 || nz < 1 || n_sm < 1 || (grid_b == nullptr) != (out_b == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.points = points;
  a.grid[0] = grid_a;
  a.grid[1] = grid_b;
  a.out[0] = out_a;
  a.out[1] = out_b;
  a.n = n;
  a.nx = nx;
  a.ny = ny;
  a.nz = nz;
  const cudaStream_t s = (cudaStream_t)stream;
  return grid_b == nullptr ? dispatch<1>(a, c, n_sm, s) : dispatch<2>(a, c, n_sm, s);
}
