"""Device operations of the port: wire decode, walk, the occupancy, NDT and
TSDF integration phases, and the hand-written CUDA kernels (``expand_cuda``
K1, ``deposit_cuda`` K2, K3 and K6, ``gather_cuda`` K4 and K5,
``probes_cuda`` and ``slotgrid_cuda`` the deposit probe's P) with their
plain PyTorch versions."""
