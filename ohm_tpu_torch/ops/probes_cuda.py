"""P-A, the deposit probes: five tiny kernels that ask on Hopper what
``scripts/probe_deposit.py`` ``probe_lowering`` asked Mosaic on the TPU,
each with a plain PyTorch version of the same output.  The kernels are in
``csrc/probes.cu``.  Each wrapper runs the plain version for tensors on the
CPU and launches its kernel for tensors on a CUDA device.

``probe_lowering(device)`` runs all five on the reference's inputs and
reports, as the reference's ``try_one`` does, ``("OK", first two values)``
or ``("FAIL", first line of the error)`` for each.  A FAIL is a result the
runner prints; nothing falls back.
"""

from __future__ import annotations

import numpy as np
import torch

from ohm_tpu_torch.ops import _build

HI = 64
LO = 512
CHUNK = 512
V = 1 << 15


def _check(t: torch.Tensor, dtype, shape, what: str) -> None:
    if not (t.dtype == dtype and tuple(t.shape) == shape and t.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous {dtype} tensor of shape {shape}")


# 1. vmem_scatter_add -------------------------------------------------------

def scatter_add_reference(idx: torch.Tensor) -> torch.Tensor:
    """f32[1, 128]: 1.0 added at each of ``idx`` (i32[1, n], n <= 128)."""
    out = torch.zeros(128, dtype=torch.float32, device=idx.device)
    flat = (idx.reshape(-1) & 127).long()
    out.index_put_((flat,), torch.ones_like(flat, dtype=torch.float32), accumulate=True)
    return out.reshape(1, 128)


def scatter_add(idx: torch.Tensor) -> torch.Tensor:
    if idx.device.type == "cpu":
        return scatter_add_reference(idx)
    if not (idx.dtype == torch.int32 and idx.dim() == 2 and idx.shape[0] == 1
            and idx.shape[1] <= 128 and idx.is_contiguous()):
        raise ValueError("idx must be a contiguous i32[1, <= 128] tensor")
    out = torch.empty(1, 128, dtype=torch.float32, device=idx.device)
    rc = _build.load().ohm_probe_scatter_add(idx.data_ptr(), idx.shape[1], out.data_ptr(),
                                             _build.stream_of(out))
    _build.check(rc, "probe scatter_add")
    scatter_add.launches += 1
    return out


# 2. take_along_axis --------------------------------------------------------

def take_along_reference(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """f32[8, 128]: x[r, idx[r, c]]."""
    return torch.gather(x, 1, (idx & 127).long())


def take_along(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return take_along_reference(x, idx)
    _check(x, torch.float32, (8, 128), "x")
    _check(idx, torch.int32, (8, 128), "idx")
    out = torch.empty_like(x)
    rc = _build.load().ohm_probe_take_along(x.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                            _build.stream_of(out))
    _build.check(rc, "probe take_along")
    take_along.launches += 1
    return out


# 3. dynamic_fori -----------------------------------------------------------

def dynamic_loop_reference(n: torch.Tensor) -> torch.Tensor:
    """i32[1, 1]: sum of i for i < n[0]."""
    trips = int(n[0])
    return torch.arange(max(trips, 0), dtype=torch.int32, device=n.device).sum(
        dtype=torch.int32).reshape(1, 1)


def dynamic_loop(n: torch.Tensor) -> torch.Tensor:
    if n.device.type == "cpu":
        return dynamic_loop_reference(n)
    _check(n, torch.int32, (1,), "n")
    out = torch.empty(1, 1, dtype=torch.int32, device=n.device)
    rc = _build.load().ohm_probe_dynamic_loop(n.data_ptr(), out.data_ptr(), _build.stream_of(out))
    _build.check(rc, "probe dynamic_loop")
    dynamic_loop.launches += 1
    return out


# 4. dyn_offset_dma ---------------------------------------------------------

def bulk_copy_reference(off: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """f32[4, 128]: rows off[0] .. off[0] + 3 of ``src``."""
    row = int(off[0])
    if not 0 <= row <= src.shape[0] - 4:
        raise IndexError(f"row offset {row} outside [0, {src.shape[0] - 4}]")
    return src[row:row + 4].clone()


def bulk_copy(off: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Rows off[0] .. off[0] + 3 of ``src`` (f32[rows, 128]) through an
    asynchronous bulk copy into shared memory; the offset is read on the
    device.  An offset out of range gives NaN rows (the kernel cannot
    raise)."""
    if src.device.type == "cpu":
        return bulk_copy_reference(off, src)
    _check(off, torch.int32, (1,), "off")
    if not (src.dtype == torch.float32 and src.dim() == 2 and src.shape[1] == 128
            and src.is_contiguous() and src.data_ptr() % 16 == 0 and off.device == src.device):
        raise ValueError("src must be a contiguous, 16-byte aligned f32[rows, 128] tensor")
    out = torch.empty(4, 128, dtype=torch.float32, device=src.device)
    rc = _build.load().ohm_probe_bulk_copy(off.data_ptr(), src.data_ptr(), src.shape[0],
                                           out.data_ptr(), _build.stream_of(out))
    _build.check(rc, "probe bulk_copy")
    bulk_copy.launches += 1
    return out


# 5. onehot_mxu_dot ---------------------------------------------------------

def onehot_mma_reference(v: torch.Tensor) -> torch.Tensor:
    """f32[64, 512]: the one-hot hi (v >> 9) x lo (v & 511) product over
    the records of ``v`` (i32[rows, 128]), f32 factors."""
    flat = v.reshape(-1)
    oh_hi = ((flat >> 9)[None, :] == torch.arange(HI, device=v.device)[:, None]).float()
    oh_lo = ((flat & (LO - 1))[None, :] == torch.arange(LO, device=v.device)[:, None]).float()
    return oh_hi @ oh_lo.T


def onehot_mma(v: torch.Tensor) -> torch.Tensor:
    """The same product on the tensor cores: bf16 one-hot fragments built
    in registers (``mma.sync``), f32 accumulate, exact."""
    if v.device.type == "cpu":
        return onehot_mma_reference(v)
    if not (v.dtype == torch.int32 and v.dim() == 2 and v.shape[1] == 128
            and v.is_contiguous()):
        raise ValueError("v must be a contiguous i32[rows, 128] tensor")
    out = torch.empty(HI, LO, dtype=torch.float32, device=v.device)
    rc = _build.load().ohm_probe_onehot_mma(v.data_ptr(), v.numel(), out.data_ptr(),
                                            _build.stream_of(out))
    _build.check(rc, "probe onehot_mma")
    onehot_mma.launches += 1
    return out


def empty_kernel() -> None:
    """Launch a kernel that does nothing on the current CUDA device: the
    launch floor the probes are timed beside.  No plain version: it
    computes nothing."""
    rc = _build.entry("ohm_probe_empty")(
        torch._C._cuda_getCurrentRawStream(torch.cuda.current_device()))
    _build.check(rc, "probe empty")
    empty_kernel.launches += 1


empty_kernel.launches = 0


PROBES = {"vmem_scatter_add": scatter_add, "take_along_axis": take_along,
          "dynamic_fori": dynamic_loop, "dyn_offset_dma": bulk_copy,
          "onehot_mxu_dot": onehot_mma}
PLAIN = {"vmem_scatter_add": scatter_add_reference, "take_along_axis": take_along_reference,
         "dynamic_fori": dynamic_loop_reference, "dyn_offset_dma": bulk_copy_reference,
         "onehot_mxu_dot": onehot_mma_reference}
# Each wrapper's kernel launches since the count was last set to 0.
for _fn in PROBES.values():
    _fn.launches = 0


def probe_inputs(device) -> dict:
    """Each probe's input tensors, as the reference builds them."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return {
        "vmem_scatter_add": (t(np.arange(8, dtype=np.int32).reshape(1, 8) * 3),),
        "take_along_axis": (t(np.arange(8 * 128, dtype=np.float32).reshape(8, 128)),
                            t(np.tile(np.arange(127, -1, -1, dtype=np.int32), (8, 1)))),
        "dynamic_fori": (t(np.array([37], np.int32)),),
        "dyn_offset_dma": (t(np.array([8], np.int32)),
                           t(np.arange(32 * 128, dtype=np.float32).reshape(32, 128))),
        "onehot_mxu_dot": (t((np.arange(CHUNK, dtype=np.int32) % V).reshape(CHUNK // 128, 128)),),
    }


def expected_outputs() -> dict:
    """What each probe must return on ``probe_inputs`` (numpy)."""
    scatter = np.zeros((1, 128), np.float32)
    scatter[0, np.arange(8) * 3] = 1.0
    v = np.arange(CHUNK) % V
    hist = np.zeros((HI, LO), np.float32)
    np.add.at(hist, (v >> 9, v & (LO - 1)), 1)
    return {
        "vmem_scatter_add": scatter,
        "take_along_axis": (np.arange(8)[:, None] * 128 + 127 - np.arange(128)[None, :]
                            ).astype(np.float32),
        "dynamic_fori": np.array([[sum(range(37))]], np.int32),
        "dyn_offset_dma": np.arange(8 * 128, 12 * 128, dtype=np.float32).reshape(4, 128),
        "onehot_mxu_dot": hist,
    }


def probe_lowering(device) -> dict:
    """Run the five probes on ``device``: name -> ("OK", first two values)
    or ("FAIL", the error's first line).  The one-hot probe also fails when
    its output differs from the numpy histogram, as the reference's does."""
    inputs = probe_inputs(device)
    hist = expected_outputs()["onehot_mxu_dot"]
    res = {}
    for name, fn in PROBES.items():
        try:
            out = fn(*inputs[name]).cpu().numpy()
            if name == "onehot_mxu_dot" and not np.array_equal(out, hist):
                raise AssertionError("one-hot dot mismatch")
            res[name] = ("OK", out.ravel()[:2].tolist())
        except Exception as e:  # noqa: BLE001 -- a failing probe is a result
            res[name] = ("FAIL", str(e).split("\n")[0][:300])
        print(f"  [{name}] {res[name][0]}: {res[name][1]}", flush=True)
    return res
