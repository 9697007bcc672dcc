"""P-B, the slot-grid deposit: per-voxel hit and miss counts of a sorted
(flat << 1 | hit) key stream over ``n_slots`` slots of V voxels, then the
occupancy sweep, in place.

Replaces ``scripts/probe_deposit.py`` ``pallas_deposit_build`` (its
``pallas_call``): the reference's prototype of a different occupancy
deposit, whose grid runs over arena slots and counts each slot's records
into an on-chip plane with the sweep fused in.  The CUDA kernel is in
``csrc/slotgrid.cu``: one launch balanced by record, where the record that
ends a voxel's run owns it and reads its counts off positions.  The plain
PyTorch version is ``slotgrid_deposit_reference`` (int32 ``index_add_``
counts, then ``sweep_math``).

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
#: The probe's one-hot split of a voxel index: hi = v >> 9, lo = v & 511.
HI = 64
LO = 512
#: Records per block of the one-hot segmented matmul (the probe's CHUNK).
CHUNK = 512
#: Keys a block of the CUDA kernel takes (``csrc/slotgrid.cu``'s kTile =
#: kThreads * kPer): a run that crosses a multiple of it is searched back
#: in global memory.
TILE = 1024


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


def slotgrid_deposit_reference(keys, occ, n_slots: int, *, hit, miss, min_value, max_value,
                               fuse_sweep=True):
    """Plain PyTorch P-B on ``occ[:n]``, n = n_slots * V, in place: a record
    counts when its flat lies in [0, n).  ``keys`` must be sorted ascending,
    as for ``slotgrid_deposit``; this version alone would count them in
    any order."""
    n = n_slots * V
    flat = keys >> 1
    live = (flat >= 0) & (flat < n)
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


def slotgrid_deposit(keys, occ, n_slots: int, *, hit, miss, min_value, max_value,
                     fuse_sweep=True):
    """Deposit the (flat << 1 | hit) stream ``keys`` (i32[N], sorted
    ascending) into ``occ`` (f32[>= n], n = n_slots * V, updated in place;
    nothing past n is read or written): records whose flat lies outside
    [0, n) count nothing.  The kernel takes the record that ends a voxel's
    run as its owner, so on unsorted keys one voxel can have several owners
    and its counts on the card are undefined (unchecked: a check would cost
    a device operation a call).

    ``fuse_sweep``: sweep each touched voxel (the probe's ``sweep_math``);
    otherwise write ``hit * 65536 + miss`` to every voxel of [0, n).  Counts
    are not capped.  On the card: one launch fused, a memset and one launch
    unfused; the keys must start on a 16-byte boundary.  Returns ``occ``."""
    if keys.device.type == "cpu":
        return slotgrid_deposit_reference(keys, occ, n_slots, hit=hit, miss=miss,
                                          min_value=min_value, max_value=max_value,
                                          fuse_sweep=fuse_sweep)
    n = n_slots * V
    if not (keys.dtype == torch.int32 and keys.dim() == 1 and keys.is_contiguous()):
        raise ValueError("keys must be a contiguous i32[N] tensor")
    if keys.data_ptr() % 16:
        raise ValueError("keys must start on a 16-byte boundary")
    if not (occ.dtype == torch.float32 and occ.dim() == 1 and occ.is_contiguous()
            and 0 <= n <= occ.shape[0] and occ.device == keys.device):
        raise ValueError("occ must be a contiguous f32[>= n_slots * V] tensor on the keys' "
                         "device")
    rc = _build.entry("ohm_slotgrid_deposit")(
        keys.data_ptr(), keys.shape[0], n, occ.data_ptr(), hit, miss, min_value, max_value,
        int(fuse_sweep), _build.stream_of(occ))
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
