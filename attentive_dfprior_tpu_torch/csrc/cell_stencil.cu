// Cell stencil: cell-corner buffer -> trilinear grid gradient (Hopper, sm_90a).
//
// Replaces the TPU kernel attentive_dfprior_tpu/ops/pallas/stencil_kernel.py
// (cell_stencil_pallas, body _kernel). Second half of the "pallas" variant of
// the feature-grid backward (ops/grid_sample.py:trilinear_sample_psc): the
// cell scatter writes each point's 8 weighted corner updates into one
// (8C)-wide row of the (nx*ny*nz, 8C) buffer of its floor cell; this kernel
// turns that buffer into the (nx, ny, nz, C) gradient
//
//   grad[x,y,z,c] = sum_{dx,dy,dz} cells[x-dx, y-dy, z-dz, (4dx+2dy+dz)*C + c]
//
// with zeros outside the grid. It computes the same function as the halo
// fold (halo_fold.cu) in another association.
//
// Bound on this card: memory. Every cell element is read once and every
// output element written once, nvox * 9C * 4 bytes, with 7 adds per output:
// 210 MB at the room0 high grid (74x56x44, C = 32), about 63 us at 3.35 TB/s.
//
// Design: one thread per output element (x, y, z, c), c fastest, so a warp
// reads 128 contiguous bytes of each corner block at C = 32 and writes 128
// contiguous bytes; the eight corner reads land in up to 8 neighbouring rows,
// which the L2 serves. The TPU kernel walks x-planes in order, binds planes x
// and x-1, and extracts each corner from the 8C-lane row with a one-hot
// (8C, C) matrix product because a 32-lane slice is misaligned there; none of
// that is needed here: a thread reads its corners directly.
//
// Numerics: the TPU kernel's association, not the halo fold's. It sums the
// corners of plane x as ((e000 + e001) + e010) + e011, those of plane x-1 in
// the same order (corners 4-7), then cur + prev; at x = 0 there is no plane
// x-1 and prev is 0 (the TPU kernel adds 0 * prev: the same value up to the
// sign of zero). Out-of-grid reads are 0 and plane -1 is never read. Only
// adds, so the result is bit-identical to the plain version
// (ops/cuda/stencil_kernel.py:cell_stencil_plain).

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float corner(const float* __restrict__ cells, int k,
                                        int x, int y, int z, int ny, int nz,
                                        int C, int c) {
  if (x < 0 || y < 0 || z < 0) return 0.0f;
  long long row = ((long long)x * ny + y) * nz + z;
  return cells[row * 8 * C + (long long)k * C + c];
}

// the four corners of one x-plane: dx selects plane x (0) or x-1 (1)
__device__ __forceinline__ float plane(const float* __restrict__ cells, int dx,
                                       int x, int y, int z, int ny, int nz,
                                       int C, int c) {
  int k = 4 * dx;
  int px = x - dx;
  float acc = corner(cells, k, px, y, z, ny, nz, C, c);
  acc = acc + corner(cells, k + 1, px, y, z - 1, ny, nz, C, c);
  acc = acc + corner(cells, k + 2, px, y - 1, z, ny, nz, C, c);
  acc = acc + corner(cells, k + 3, px, y - 1, z - 1, ny, nz, C, c);
  return acc;
}

__global__ void cell_stencil_kernel(const float* __restrict__ cells,
                                    float* __restrict__ out, int nx, int ny,
                                    int nz, int C, long long total) {
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    int c = (int)(t % C);
    long long v = t / C;
    int z = (int)(v % nz);
    long long r = v / nz;
    int y = (int)(r % ny);
    int x = (int)(r / ny);
    float cur = plane(cells, 0, x, y, z, ny, nz, C, c);
    float prev = x > 0 ? plane(cells, 1, x, y, z, ny, nz, C, c) : 0.0f;
    out[t] = cur + prev;
  }
}

}  // namespace

extern "C" int cell_stencil_launch(const float* cells, float* out, int nx,
                                   int ny, int nz, int C, void* stream) {
  long long total = (long long)nx * ny * nz * C;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  cell_stencil_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      cells, out, nx, ny, nz, C, total);
  return (int)cudaGetLastError();
}
