"""Device operations of the port: wire decode, walk, the occupancy and NDT
integration phases, and the hand-written CUDA kernels (``expand_cuda`` K1,
``deposit_cuda`` K2 and K3, ``gather_cuda`` K4) with their plain PyTorch
versions."""
