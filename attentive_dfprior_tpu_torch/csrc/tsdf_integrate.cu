// TSDF integration: fuse one RGB-D frame into the volume, in place (Hopper,
// sm_90a).
//
// K5. Replaces no TPU kernel: it is the port's counterpart of the JAX
// package's compiled program attentive_dfprior_tpu/tsdf/fusion.py:32
// (integrate_frame, jax.jit with donate_argnums=(0, 1, 2)), which XLA fuses
// into one loop over the volume written in place. The reference system ships
// the same update as a CUDA kernel (ref: src/fusion.py:69-144). Every voxel
// of the (X, Y, Z) volume is projected into the frame:
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
// Bound on this card: operations. Every voxel is projected (about 30 fp32
// operations, two of them IEEE divisions); only the voxels the frame
// updates are read and written, 20 B each way (tsdf, weight, 3 colours).
// At room0's 196.2 M voxels that is about 5.9 GFLOP, 0.09 ms at 67 TFLOP/s;
// a frame updates a few percent of the volume, a few MB of traffic.
//
// Design: one thread per voxel. The grid is (ceil(Z / 128), Y, X) blocks of
// 128 threads along z, so x and y come from the block index with no
// division; offsets are 64-bit (room0's colour array holds 589 M floats).
// A voxel outside the frustum or without valid depth returns after its
// projection and touches no memory of the volume. Nothing is allocated: the
// kernel writes the three volume arrays in place.
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
// camera plane (c.z about 1e-8) no 32-bit integer wraps.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void tsdf_integrate_kernel(
    float* __restrict__ tsdf, float* __restrict__ weight,
    float* __restrict__ color, const float* __restrict__ depth_im,
    const float* __restrict__ color_im, const float* __restrict__ intr,
    const float* __restrict__ w2c, const float* __restrict__ origin, int Y,
    int Z, int H, int W, float voxel_size, float neg_trunc, float inv_trunc,
    float obs_weight) {
  const int z = blockIdx.x * kThreads + threadIdx.x;
  if (z >= Z) return;
  const int y = blockIdx.y;
  const int x = blockIdx.z;

  // voxel -> world: origin + index * voxel_size, each op rounded
  const float px = __fadd_rn(origin[0], __fmul_rn((float)x, voxel_size));
  const float py = __fadd_rn(origin[1], __fmul_rn((float)y, voxel_size));
  const float pz = __fadd_rn(origin[2], __fmul_rn((float)z, voxel_size));
  // world -> camera: ((a*px + b*py) + c*pz) + d, row by row
  const float cz = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(w2c[8], px), __fmul_rn(w2c[9], py)),
                __fmul_rn(w2c[10], pz)),
      w2c[11]);
  if (!(cz > 0.0f)) return;  // behind the camera (the plain version's safe_z never reaches the test)
  const float cx = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(w2c[0], px), __fmul_rn(w2c[1], py)),
                __fmul_rn(w2c[2], pz)),
      w2c[3]);
  const float cy = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(w2c[4], px), __fmul_rn(w2c[5], py)),
                __fmul_rn(w2c[6], pz)),
      w2c[7]);
  // camera -> pixel, nearest
  const float u = rintf(__fadd_rn(__fmul_rn(intr[0], __fdiv_rn(cx, cz)), intr[2]));
  const float v = rintf(__fadd_rn(__fmul_rn(intr[4], __fdiv_rn(cy, cz)), intr[5]));
  if (!(u >= 0.0f && u < (float)W && v >= 0.0f && v < (float)H)) return;
  const long long pix = (long long)v * W + (long long)u;
  const float d = depth_im[pix];
  if (!(d > 0.0f)) return;
  const float diff = __fsub_rn(d, cz);
  if (!(diff >= neg_trunc)) return;
  float dist = __fmul_rn(diff, inv_trunc);
  dist = dist > 1.0f ? 1.0f : dist;  // clamp(max=1): NaN passes as NaN

  const long long i = ((long long)x * Y + y) * Z + z;
  const float w_old = weight[i];
  const float w_new = __fadd_rn(w_old, obs_weight);
  tsdf[i] = __fdiv_rn(__fadd_rn(__fmul_rn(tsdf[i], w_old), __fmul_rn(obs_weight, dist)), w_new);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float c = rintf(__fdiv_rn(
        __fadd_rn(__fmul_rn(color[3 * i + k], w_old), __fmul_rn(obs_weight, color_im[3 * pix + k])),
        w_new));
    color[3 * i + k] = c > 255.0f ? 255.0f : c;
  }
  weight[i] = w_new;
}

}  // namespace

extern "C" int tsdf_integrate_launch(
    float* tsdf, float* weight, float* color, const float* depth_im,
    const float* color_im, const float* intr, const float* w2c,
    const float* origin, int X, int Y, int Z, int H, int W, float voxel_size,
    float neg_trunc, float inv_trunc, float obs_weight, void* stream) {
  if ((long long)X * Y * Z == 0) return 0;
  if (X > 65535 || Y > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((Z + kThreads - 1) / kThreads), (unsigned)Y, (unsigned)X);
  tsdf_integrate_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      tsdf, weight, color, depth_im, color_im, intr, w2c, origin, Y, Z, H, W,
      voxel_size, neg_trunc, inv_trunc, obs_weight);
  return (int)cudaGetLastError();
}
