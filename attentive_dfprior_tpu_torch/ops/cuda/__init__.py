"""Hand-written CUDA kernels (sources in ``csrc/``) with their plain
PyTorch versions and launch counters: K1 the halo fold, K2 the fused
decoder MLP, K3 the cell stencil, K4 the ordered cell scatter, K5 TSDF
integration, K6 the mapper's frustum masks, K7 the trilinear lookup."""
