"""P-B, the slot-grid deposit: per-voxel hit and miss counts of a sorted
(flat << 1 | hit) key stream, slot by slot, then the occupancy sweep, in
place.

Replaces ``scripts/probe_deposit.py`` ``pallas_deposit_build`` (its
``pallas_call``): the reference's prototype of a different occupancy
deposit, whose grid runs over arena slots and counts each slot's records
into an on-chip plane with the sweep fused in.  The CUDA kernel is in
``csrc/slotgrid.cu``; the plain PyTorch version is
``slotgrid_deposit_reference`` (int32 ``index_add_`` counts, then
``sweep_math``).

The sweep is the probe's (``probe_deposit.py`` ``sweep_math``): +inf marks
an unobserved voxel, no exclude flags, no saturation, the one-sided clamp
by the sign of the total, untouched voxels kept.  It is the function K3
(``deposit_cuda.deposit_and_sweep_ndt``) computes with a zero delta and
saturation at +-inf, except that the counts here are not capped at 65535:
the reference accumulates them in f32, exact to 2^24.

Both stage C of the probe (``onehot_deposit``, the reference's
``xla_onehot_deposit``) and its yardstick (``scatter_deposit``, the
reference's ``xla_scatter_deposit``) are plain PyTorch here: the reference
computes them outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from ohm_tpu_torch.ops import _build

#: Voxels of one arena slot (32^3 regions), as the probe's ``V``.
V_SHIFT = 15
V = 1 << V_SHIFT
#: The kernel's grid runs over (slot, part); each part spans V / PARTS
#: voxels and holds its two u32 count planes in shared memory (64 KB).
PARTS = 4
PART_VOX = V // PARTS
#: The probe's one-hot split of a voxel index: hi = v >> 9, lo = v & 511.
HI = 64
LO = 512
#: Records per block of the one-hot segmented matmul (the probe's CHUNK).
CHUNK = 512


def sweep_math(occ, hit_plane, miss_plane, *, hit, miss, min_value, max_value):
    """The probe's occupancy sweep over f32 count planes, in its f32 op
    order (each product and sum separately rounded)."""
    total = hit_plane * hit + miss_plane * miss
    unobs = torch.isposinf(occ)
    value = torch.where(unobs, torch.zeros_like(occ), occ) + total
    value = torch.where(total > 0, torch.clamp(value, max=max_value), value)
    value = torch.where(total < 0, torch.clamp(value, min=min_value), value)
    touched = (hit_plane + miss_plane) > 0
    return torch.where(touched, value, occ)


def part_bounds(keys: torch.Tensor, n_slots: int) -> torch.Tensor:
    """i32[n_slots * PARTS + 1]: the first record of each (slot, part) of
    the sorted key stream, and the end of the last (sentinel keys, with
    flat = n_slots * V, fall past it)."""
    edges = torch.arange(n_slots * PARTS + 1, dtype=torch.int32, device=keys.device) * PART_VOX
    return torch.searchsorted(keys >> 1, edges, out_int32=True)


def slotgrid_deposit_reference(keys, occ, bounds, *, hit, miss, min_value, max_value,
                               fuse_sweep=True):
    """Plain PyTorch P-B on ``occ[:n]``, n = (len(bounds) - 1) * PART_VOX,
    in place.  Record i counts when it lies in the range ``bounds`` gives its
    part and its voxel lies in that part, as the kernel reads them."""
    n_parts = bounds.shape[0] - 1
    n = n_parts * PART_VOX
    flat = keys >> 1
    pos = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
    part = torch.searchsorted(bounds, pos, right=True, out_int32=True) - 1
    live = (part >= 0) & (part < n_parts) & (flat >= 0) & (flat // PART_VOX == part)
    is_hit = (keys & 1) == 1
    counts = []
    for sel in (live & is_hit, live & ~is_hit):
        idx = flat[sel].long()
        plane = torch.zeros(n, dtype=torch.int32, device=occ.device)
        counts.append(plane.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32)))
    hit_plane, miss_plane = (c.to(torch.float32) for c in counts)
    if fuse_sweep:
        occ[:n] = sweep_math(occ[:n], hit_plane, miss_plane, hit=hit, miss=miss,
                             min_value=min_value, max_value=max_value)
    else:
        occ[:n] = hit_plane * 65536.0 + miss_plane
    return occ


def slotgrid_deposit(keys, occ, bounds, *, hit, miss, min_value, max_value, fuse_sweep=True):
    """Deposit the sorted (flat << 1 | hit) stream ``keys`` (i32[N]) into
    ``occ`` (f32[>= n], n = (len(bounds) - 1) * PART_VOX, updated in place;
    nothing past n is read or written) by (slot, part), with the record
    bounds ``bounds`` (i32[slots * PARTS + 1], from ``part_bounds``).

    ``fuse_sweep``: sweep each touched voxel (the probe's ``sweep_math``);
    otherwise write ``hit * 65536 + miss`` to every voxel, 0 where a part
    has no records.  Counts are not capped.  Returns ``occ``."""
    if keys.device.type == "cpu":
        return slotgrid_deposit_reference(keys, occ, bounds, hit=hit, miss=miss,
                                          min_value=min_value, max_value=max_value,
                                          fuse_sweep=fuse_sweep)
    n_parts = bounds.shape[0] - 1
    if not (keys.dtype == torch.int32 and keys.dim() == 1 and keys.is_contiguous()):
        raise ValueError("keys must be a contiguous i32[N] tensor")
    if not (bounds.dtype == torch.int32 and bounds.dim() == 1 and bounds.is_contiguous()
            and n_parts >= 0 and bounds.device == keys.device):
        raise ValueError("bounds must be a contiguous i32[slots * PARTS + 1] tensor on the "
                         "keys' device")
    if not (occ.dtype == torch.float32 and occ.dim() == 1 and occ.is_contiguous()
            and occ.shape[0] >= n_parts * PART_VOX and occ.device == keys.device):
        raise ValueError("occ must be a contiguous f32[>= slots * V] tensor on the keys' device")
    if n_parts % PARTS:
        raise ValueError(f"bounds must hold slots * {PARTS} + 1 entries")
    rc = _build.load().ohm_slotgrid_deposit(
        keys.data_ptr(), bounds.data_ptr(), n_parts, occ.data_ptr(), hit, miss, min_value,
        max_value, int(fuse_sweep), _build.stream_of(occ))
    _build.check(rc, "slotgrid_deposit")
    slotgrid_deposit.launches += 1
    return occ


#: Kernel launches since the count was last set to 0.
slotgrid_deposit.launches = 0


def onehot_deposit(keys, occ, n_slots: int, *, hit, miss, min_value, max_value):
    """The probe's stage C (``xla_onehot_deposit``) in plain PyTorch: one-hot
    hi/lo factors per 512-record block, a batched matrix product into a
    partial (2 x 64, 512) plane per block, a block -> slot add, the sweep.
    Each block deposits only the records of its first record's slot (the
    reference's cost probe drops the rest).  f32 factors: a bf16 product
    returns bf16, which loses counts above 256.  ``occ`` is f32[n_slots * V];
    returns a new tensor."""
    nb = keys.shape[0] // CHUNK
    k = keys[:nb * CHUNK].reshape(nb, CHUNK)
    flat = k >> 1
    is_hit = (k & 1).to(torch.float32)
    block_slot = flat[:, 0] >> V_SHIFT
    base = (block_slot << V_SHIFT)[:, None]
    in_slot = (flat >= base) & (flat < base + V)
    vloc = flat - base
    lo = vloc & (LO - 1)
    hi = vloc >> 9
    il = torch.arange(LO, dtype=torch.int32, device=keys.device)
    ih = torch.arange(HI, dtype=torch.int32, device=keys.device)
    oh_lo = (lo[..., None] == il).to(torch.float32)                       # [nb, CHUNK, LO]
    oh_hi = ((hi[..., None] == ih) & in_slot[..., None]).to(torch.float32)  # [nb, CHUNK, HI]
    a = torch.cat([oh_hi * is_hit[..., None], oh_hi * (1 - is_hit)[..., None]], dim=2)
    partial = torch.bmm(a.transpose(1, 2), oh_lo)                         # [nb, 2HI, LO]
    ok = block_slot < n_slots  # a block of sentinel keys names slot n_slots: dropped
    planes = torch.zeros(n_slots, 2 * HI, LO, dtype=torch.float32, device=keys.device)
    planes.index_add_(0, block_slot[ok].long(), partial[ok])
    hit_plane = planes[:, :HI].reshape(-1)
    miss_plane = planes[:, HI:].reshape(-1)
    return sweep_math(occ, hit_plane, miss_plane, hit=hit, miss=miss,
                      min_value=min_value, max_value=max_value)


def scatter_deposit(keys, occ_flat, n_slots: int, *, hit, miss, min_value, max_value):
    """The probe's yardstick (``xla_scatter_deposit``) in plain PyTorch: run
    starts by cumulative max, per-voxel counts at each voxel's last record,
    capped at 65535 and packed, one scatter to unique targets (every record
    but the real voxel-lasts goes to its own element past the sentinel),
    then the sweep of the whole array.  ``occ_flat`` is
    f32[>= n_slots * V + 1 + N]; returns a new tensor."""
    n_vox = n_slots * V
    n = keys.shape[0]
    if occ_flat.shape[0] < n_vox + 1 + n:
        raise ValueError("occ_flat must hold n_slots * V + 1 + N elements")
    ids = keys >> 1
    hitb = keys & 1
    change = ids[1:] != ids[:-1]
    true = torch.ones(1, dtype=torch.bool, device=keys.device)
    first = torch.cat([true, change])
    last = torch.cat([change, true])
    run_first = torch.cat([true, keys[1:] != keys[:-1]])
    pos = torch.arange(n, dtype=torch.int32, device=keys.device)
    neg = torch.full_like(pos, -(1 << 30))
    p_vox = torch.cummax(torch.where(first, pos, neg), 0).values
    p_run = torch.cummax(torch.where(run_first, pos, neg), 0).values
    n_hit = torch.where(hitb == 1, pos - p_run + 1, 0)
    n_miss = torch.where(hitb == 1, p_run - p_vox, pos - p_vox + 1)
    packed = (torch.clamp(n_hit, max=65535).long() << 16) | torch.clamp(n_miss, max=65535).long()
    real_last = last & (ids != n_vox)
    packed = torch.where(real_last, packed, 0)
    idx = torch.where(real_last, ids.long(), n_vox + 1 + pos.long())
    pending = torch.zeros(occ_flat.shape[0], dtype=torch.int64, device=keys.device)
    pending[idx] = packed
    hp = (pending >> 16).to(torch.float32)
    mp = (pending & 0xFFFF).to(torch.float32)
    return sweep_math(occ_flat, hp, mp, hit=hit, miss=miss, min_value=min_value,
                      max_value=max_value)
