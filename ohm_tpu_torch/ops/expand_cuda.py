"""K1, the expand kernel: rank walk + slot resolve -> one key per record.

Replaces ``ohm_tpu/ops/expand_pallas.py`` ``expand_keys`` (Pallas kernel
``_kernel``).  The CUDA kernel is ``csrc/expand.cu``; its plain PyTorch
version is ``expand_keys_reference`` (ops.ddawalk.walk_rays_unordered +
ops.integrate.resolve_slots + the validity and EXCLUDE_ORIGIN masking).

``expand_keys`` runs the plain version for tensors on the CPU and launches
the kernel for tensors on a CUDA device; it never swaps one for the other.
The per-ray prelude (walk set-up, ``inv = dd > 0 ? 1/dd : 0``, the overflow
flag and the end voxel's enter time), which the reference computes in XLA
before its kernel, is ``_prelude`` on the CPU and runs inside the kernel on
the card: the kernel reads the unpacked batch's own tensors, and the CUDA
branch issues no PyTorch op but its outputs' allocations.
"""

from __future__ import annotations

import torch

from ohm_tpu_torch.ops import _build
from ohm_tpu_torch.ops.config import IntegrateConfig
from ohm_tpu_torch.ops.ddawalk import init_walk, safe_inverse, walk_rays_unordered

#: Widest candidate table the kernel holds in shared memory (the rayflow
#: wire caps a ray at 32 regions, mapping.batch.prepare_rayflow).
MAX_K = 32


def _prelude(b: dict, cfg: IntegrateConfig):
    """Per-ray kernel inputs and the closed-form aux outputs
    (expand_pallas.py:205-227)."""
    S = cfg.max_steps
    sign, e0, dd, crossings = init_walk(
        b["start_frac"], b["direction"], b["length"], b["start_abs"],
        b["end_abs"], cfg.resolution)
    step_dir = torch.where(sign, -1, 1).to(torch.int32)
    n_ax = torch.clamp(crossings, max=S)
    # An invalid ray emits no valid records.
    n_ax = torch.where(b["valid"][:, None], n_ax, torch.zeros_like(n_ax))
    last_t = torch.where(n_ax > 0, e0 + (n_ax - 1).to(torch.float32) * dd,
                         torch.zeros_like(e0))
    end_enter = torch.clamp(torch.maximum(torch.maximum(
        last_t[:, 0], last_t[:, 1]), last_t[:, 2]), min=0.0)
    aux = {"overflow": torch.any(crossings > S, dim=1), "end_enter": end_enter}
    return e0, dd, safe_inverse(dd), step_dir, n_ax, aux


def expand_keys_reference(b: dict, cfg: IntegrateConfig, exclude_origin: bool = False,
                          with_vox: bool = False, with_trav: bool = False):
    """Plain PyTorch K1: (flat i32[B,3S], missed count i32 0-dim), then with
    ``with_vox`` the voxel planes i32[B,3S,3] (walk["voxels"]), then with
    ``with_trav`` the traversal f32[B,3S] (exits - enters, 0 where the
    record is not valid).

    flat is the record's arena id, or the sentinel where the record is
    invalid, unresolved (missed) or the excluded origin voxel."""
    # Imported here: ops.integrate imports this module.
    from ohm_tpu_torch.ops.integrate import resolve_slots

    walk = walk_rays_unordered(
        b["start_abs"], b["end_abs"], b["start_frac"], b["direction"],
        b["length"], cfg.resolution, cfg.max_steps)
    rec_valid = walk["valid"] & b["valid"][:, None]
    if exclude_origin:
        rec_valid = rec_valid & ~(walk["first"] & b["exclude_start"][:, None])
    flat, missed = resolve_slots(walk["voxels"], cfg, b["tcand"], b["gmeta"])
    flat = torch.where(rec_valid, flat, torch.full_like(flat, cfg.sentinel))
    missed_n = (rec_valid & missed).sum().to(torch.int32)
    out = (flat, missed_n)
    if with_vox:
        out += (walk["voxels"],)
    if with_trav:
        trav = walk["exits"] - walk["enters"]
        out += (torch.where(rec_valid, trav, torch.zeros_like(trav)),)
    return out


def _kernel_batch_ok(b: dict, B: int, K: int) -> bool:
    """The batch tensors the kernel reads, as ops.wire.unpack_batch gives
    them, on one device: start_frac, direction f32[B,3] and length f32[B]
    with any row stride (each row's axes contiguous); start_abs, end_abs
    i32[B,3], valid, exclude_start bool[B], tcand i32[B,K] and gmeta i32[>=3]
    contiguous."""
    sf, dirn, length = b["start_frac"], b["direction"], b["length"]
    sa, ea, valid, excl = b["start_abs"], b["end_abs"], b["valid"], b["exclude_start"]
    tcand, gmeta = b["tcand"], b["gmeta"]
    f32, i32, dev = torch.float32, torch.int32, sa.get_device()
    return (sf.dtype is f32 and dirn.dtype is f32 and length.dtype is f32
            and sf.shape == (B, 3) and dirn.shape == (B, 3) and length.shape == (B,)
            and sf.stride(1) == 1 and dirn.stride(1) == 1
            and sa.dtype is i32 and ea.dtype is i32 and sa.shape == (B, 3) == ea.shape
            and sa.is_contiguous() and ea.is_contiguous()
            and valid.dtype is torch.bool and excl.dtype is torch.bool
            and valid.shape == (B,) == excl.shape
            and valid.is_contiguous() and excl.is_contiguous()
            and tcand.dtype is i32 and tcand.shape == (B, K) and tcand.is_contiguous()
            and gmeta.dtype is i32 and gmeta.dim() == 1 and gmeta.shape[0] >= 3
            and gmeta.is_contiguous()
            and dev >= 0 and all(t.get_device() == dev for t in (
                sf, dirn, length, ea, valid, excl, tcand, gmeta)))


def expand_keys(b: dict, cfg: IntegrateConfig, exclude_origin: bool = False,
                with_trav: bool = False, with_vox: bool = False):
    """Walk + resolve an unpacked rayflow batch (ops.wire.unpack_batch).

    Returns (flat i32[B,3S], aux) with aux = {missed_n (i32 0-dim),
    overflow bool[B], end_enter f32[B]}; flat as expand_keys_reference's.
    ``with_vox`` adds aux["vox"] i32[B,3S,3], each record's absolute voxel,
    as in the reference: it equals the plain version's walk["voxels"] on
    every lane whose key is not the sentinel, and is unspecified elsewhere.
    ``with_trav`` adds aux["trav"] f32[B,3S], each record's traversal
    length, bit for bit the plain version's on every lane."""
    start_abs = b["start_abs"]
    if start_abs.device.type == "cpu":
        aux = _prelude(b, cfg)[-1]
        out = list(expand_keys_reference(b, cfg, exclude_origin, with_vox=with_vox,
                                         with_trav=with_trav))
        if with_trav:
            aux["trav"] = out.pop()
        if with_vox:
            aux["vox"] = out.pop()
        aux["missed_n"] = out[1]
        return out[0], aux

    B, S, K = start_abs.shape[0], cfg.max_steps, b["tcand"].shape[1]
    if K > MAX_K:
        raise ValueError(f"candidate table K={K} exceeds the kernel's {MAX_K}")
    if not _kernel_batch_ok(b, B, K):
        raise ValueError("expand_keys takes an unpacked rayflow batch (ops.wire.unpack_batch) "
                         "on one CUDA device")
    dev, W = start_abs.device, 3 * S
    key = torch.empty((B, W), dtype=torch.int32, device=dev)
    missed = torch.empty((), dtype=torch.int32, device=dev)
    overflow = torch.empty(B, dtype=torch.bool, device=dev)
    end_enter = torch.empty(B, dtype=torch.float32, device=dev)
    trav = torch.empty((B, W), dtype=torch.float32, device=dev) if with_trav else None
    # [B, 3S, 3] over three planes [3][B][3S]: each axis's plane contiguous.
    vox = (torch.empty_strided((B, W, 3), (W, 1, B * W), dtype=torch.int32, device=dev)
           if with_vox else None)
    sf, dirn, length = b["start_frac"], b["direction"], b["length"]
    rc = _build.entry("ohm_expand_keys")(
        sf.data_ptr(), sf.stride(0), dirn.data_ptr(), dirn.stride(0), length.data_ptr(),
        length.stride(0), start_abs.data_ptr(), b["end_abs"].data_ptr(), b["valid"].data_ptr(),
        b["exclude_start"].data_ptr(), b["tcand"].data_ptr(), b["gmeta"].data_ptr(),
        cfg.resolution, key.data_ptr(), trav.data_ptr() if with_trav else None,
        vox.data_ptr() if with_vox else None, missed.data_ptr(), overflow.data_ptr(),
        end_enter.data_ptr(), B, S, K, cfg.region_shift, cfg.voxels_per_region,
        cfg.sentinel, int(exclude_origin), _build.stream_of(key))
    if rc:
        _build.check(rc, "expand_keys")
    expand_keys.launches += 1
    aux = {"missed_n": missed, "overflow": overflow, "end_enter": end_enter}
    if with_trav:
        aux["trav"] = trav
    if with_vox:
        aux["vox"] = vox
    return key, aux


#: Kernel launches since the count was last set to 0.
expand_keys.launches = 0
