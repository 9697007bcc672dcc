"""K1, the expand kernel: rank walk + slot resolve -> one key per record.

Replaces ``ohm_tpu/ops/expand_pallas.py`` ``expand_keys`` (Pallas kernel
``_kernel``).  The CUDA kernel is ``csrc/expand.cu``; its plain PyTorch
version is ``expand_keys_reference`` (ops.ddawalk.walk_rays_unordered +
ops.integrate.resolve_slots + the validity and EXCLUDE_ORIGIN masking).

``expand_keys`` runs the plain version for tensors on the CPU and launches
the kernel for tensors on a CUDA device; it never swaps one for the other.
The per-ray prelude (walk set-up, ``inv = dd > 0 ? 1/dd : 0``, the overflow
flag and the end voxel's enter time) is PyTorch on either device, as the
reference computes it in XLA before its kernel.
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
                          with_vox: bool = False):
    """Plain PyTorch K1: (flat i32[B,3S], missed count i32 0-dim), and with
    ``with_vox`` a third item, the voxel planes i32[B,3S,3] (walk["voxels"]).

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
    if with_vox:
        return flat, missed_n, walk["voxels"]
    return flat, missed_n


def expand_keys(b: dict, cfg: IntegrateConfig, exclude_origin: bool = False,
                with_trav: bool = False, with_vox: bool = False):
    """Walk + resolve an unpacked rayflow batch (ops.wire.unpack_batch).

    Returns (flat i32[B,3S], aux) with aux = {missed_n (i32 0-dim),
    overflow bool[B], end_enter f32[B]}; flat as expand_keys_reference's.
    ``with_vox`` adds aux["vox"] i32[B,3S,3], each record's absolute voxel,
    as in the reference: it equals the plain version's walk["voxels"] on
    every lane whose key is not the sentinel, and is unspecified elsewhere.
    The traversal output serves the traversal layer, which the port does
    not have yet."""
    if with_trav:
        raise NotImplementedError("expand_keys: with_trav output (traversal layer)")
    e0, dd, inv, step_dir, n_ax, aux = _prelude(b, cfg)
    start_abs = b["start_abs"]
    if start_abs.device.type == "cpu":
        out = expand_keys_reference(b, cfg, exclude_origin, with_vox=with_vox)
        aux["missed_n"] = out[1]
        if with_vox:
            aux["vox"] = out[2]
        return out[0], aux

    B, S, K = start_abs.shape[0], cfg.max_steps, b["tcand"].shape[1]
    if K > MAX_K:
        raise ValueError(f"candidate table K={K} exceeds the kernel's {MAX_K}")
    fray = torch.cat([e0, dd, inv], dim=1).to(torch.float32).contiguous()
    iray = torch.cat([start_abs, step_dir, n_ax, b["tcand"],
                      b["exclude_start"].to(torch.int32)[:, None]],
                     dim=1).to(torch.int32).contiguous()
    gmeta = b["gmeta"][0:3].to(torch.int32).contiguous()
    key = torch.empty((B, 3 * S), dtype=torch.int32, device=start_abs.device)
    vox = (torch.empty((3, B, 3 * S), dtype=torch.int32, device=start_abs.device)
           if with_vox else None)
    missed = torch.zeros(1, dtype=torch.int32, device=start_abs.device)
    rc = _build.load().ohm_expand_keys(
        fray.data_ptr(), iray.data_ptr(), gmeta.data_ptr(), key.data_ptr(),
        vox.data_ptr() if with_vox else None, missed.data_ptr(), B, S, K,
        cfg.region_shift, cfg.voxels_per_region, cfg.sentinel,
        int(exclude_origin), _build.stream_of(key))
    _build.check(rc, "expand_keys")
    expand_keys.launches += 1
    aux["missed_n"] = missed[0]
    if with_vox:
        aux["vox"] = vox.permute(1, 2, 0)  # [B, 3S, 3] view of the planes
    return key, aux


#: Kernel launches since the count was last set to 0.
expand_keys.launches = 0
