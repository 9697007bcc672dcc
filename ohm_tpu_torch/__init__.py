"""ohm_tpu_torch — the occupancy mapping engine on PyTorch and CUDA.

The PyTorch port of ``ohm_tpu``, which stays beside it as the reference.
This package imports ``torch`` and never ``jax``.  From ``ohm_tpu`` it uses
only the host modules that are free of JAX: the host map store
(``ohm_tpu.core``), the f64 oracle (``ohm_tpu.oracle``) and the native batch
preparation library (``ohm_tpu.native``).

Layer map (each module names its ``ohm_tpu`` counterpart):
  device.py          explicit device choice; no silent fall back to the CPU
  mapping/batch.py   rayflow host wire              (ohm_tpu/mapping/batch.py)
  mapping/arena.py   device voxel arena             (ohm_tpu/mapping/arena.py)
  mapping/torch_map  TorchRayMapper                 (ohm_tpu/mapping/tpu_map.py)
  mapping/ndt_map    TorchNdtMap, NDT-OM/TM         (ohm_tpu/mapping/ndt_map.py)
  ops/wire.py        rayflow wire decode            (ohm_tpu/ops/integrate.py)
  ops/ddawalk.py     rank walk, K1's plain version  (ohm_tpu/ops/ddawalk.py)
  ops/integrate.py   expand and apply phases        (ohm_tpu/ops/integrate.py)
  ops/integrate_ndt  NDT miss, hit and deposit      (ohm_tpu/ops/integrate_ndt.py)
  ops/ndt.py         NDT math                       (ohm_tpu/ops/ndt.py)
  ops/subvoxel.py    sub-voxel mean codec           (ohm_tpu/ops/subvoxel_jnp.py)
  ops/segments.py    deterministic segment sums     (ohm_tpu/ops/integrate.py, blocked.py)
  ops/expand_cuda    K1 wrapper  -> csrc/expand.cu  (ohm_tpu/ops/expand_pallas.py)
  ops/deposit_cuda   K2, K3      -> csrc/deposit.cu (ohm_tpu/ops/deposit_pallas.py)
  ops/gather_cuda    K4 wrapper  -> csrc/gather.cu  (ohm_tpu/ops/deposit_pallas.py)
"""

__version__ = "0.1.0"

from ohm_tpu_torch.device import require_cuda, resolve_device
from ohm_tpu_torch.mapping.ndt_map import TorchNdtMap
from ohm_tpu_torch.mapping.torch_map import TorchRayMapper

__all__ = ["TorchNdtMap", "TorchRayMapper", "require_cuda", "resolve_device"]
