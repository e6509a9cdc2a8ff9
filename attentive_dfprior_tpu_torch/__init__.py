"""attentive_dfprior_tpu_torch — the PyTorch/CUDA port of attentive_dfprior_tpu.

Same system (neural-implicit RGB-D SLAM with an attentive TSDF depth
prior), same module layout and public layouts as the JAX package, written
for one NVIDIA Hopper card:

  - plain fp32 PyTorch for every dense op, with TF32 off (set here, once,
    for the whole process — the JAX reference computes in full fp32);
  - hand-written CUDA kernels (``csrc/``, built with nvcc on first use) for
    the three TPU kernels: the halo grid-gradient fold, the fused decoder
    MLP and the cell stencil (``ops/cuda/``);
  - a native host library (``native/``, built with g++ on first use) for
    marching tetrahedra and depth rasterization.

The package imports torch, numpy and scipy only. Entry points run on the
card unless the caller asks for the CPU (``device="cpu"``).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
