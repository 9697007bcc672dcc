"""Deterministic segmented reductions over a sorted stream.

Counterparts of ``_segment_reduce`` (``ohm_tpu/ops/integrate.py:497-543``)
and ``cummax`` / ``segment_sums`` / ``cumsum`` / ``segment_compose_affine_clamp``
(``ohm_tpu/ops/blocked.py:33,60,77,218``).  Each is
written with elementwise PyTorch ops only, in the reference's order of
summation: the same inputs give the same bits on every run and on either
device, and match the JAX functions up to XLA's own contractions.  No float
``index_add_``/``scatter_add_`` appears anywhere: their atomics on the card
would sum in a different order on every run.

``segment_reduce`` replays ``jax.lax.associative_scan`` (the odd/even
recursion) over (value, segment-start) pairs; the payloads of one call are
stacked into one [N, P] tensor, so every level is a handful of kernels.
``segment_sums`` and ``segment_compose_affine_clamp`` replay the blocked
[rows, 1024] log-shift scheme.
"""

from __future__ import annotations

import torch

_C = 1024  # blocked.py row width


def _first_last(ids_sorted: torch.Tensor):
    neq = ids_sorted[1:] != ids_sorted[:-1]
    one = torch.ones(1, dtype=torch.bool, device=ids_sorted.device)
    return torch.cat([one, neq]), torch.cat([neq, one])


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """[e0, o0, e1, o1, ...] along dim 0 (len(even) - len(odd) is 0 or 1)."""
    n = even.shape[0] + odd.shape[0]
    out = torch.empty((n,) + even.shape[1:], dtype=even.dtype, device=even.device)
    out[0::2] = even
    out[1::2] = odd
    return out


def _scan(vals: torch.Tensor, flags: torch.Tensor, op):
    """jax.lax.associative_scan's recursion for the segmented combine
    (va, fa), (vb, fb) -> (where(fb, vb, op(va, vb)), fa | fb)."""
    n = vals.shape[0]
    if n < 2:
        return vals, flags

    def combine(va, fa, vb, fb):
        return torch.where(fb, vb, op(va, vb)), fa | fb

    rv, rf = combine(vals[0:-1:2], flags[0:-1:2], vals[1::2], flags[1::2])
    ov, of = _scan(rv, rf, op)
    if n % 2 == 0:
        ev, ef = combine(ov[:-1], of[:-1], vals[2::2], flags[2::2])
    else:
        ev, ef = combine(ov, of, vals[2::2], flags[2::2])
    ev = torch.cat([vals[0:1], ev])
    ef = torch.cat([flags[0:1], ef])
    return _interleave(ev, ov), _interleave(ef, of)


def segment_reduce(ids_sorted: torch.Tensor, payloads: torch.Tensor, mode: str = "sum"):
    """Running per-segment sum or max of ``payloads`` [N] or [N, P] over
    sorted ``ids_sorted`` [N]; the segment total sits at each segment's
    last record.  Returns (last bool[N], running values like payloads)."""
    first, last = _first_last(ids_sorted)
    op = torch.add if mode == "sum" else torch.maximum
    flags = first if payloads.dim() == 1 else first[:, None].expand_as(payloads)
    scanned, _ = _scan(payloads, flags, op)
    return last, scanned


def segment_u32_max(ids_sorted: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Running per-segment maximum of u32 values held as int32 bit patterns
    [N] over sorted ``ids_sorted``: flipping bit 31 maps unsigned order onto
    int32's."""
    flip = -(1 << 31)
    return segment_reduce(ids_sorted, vals ^ flip, "max")[1] ^ flip


def cummax(x: torch.Tensor, lowest: int) -> torch.Tensor:
    """Inclusive cumulative maximum of an integer stream [N], floored at
    ``lowest`` (blocked.cummax: its rows are padded with ``lowest`` and the
    first row's carry is ``lowest``).  A maximum of integers is exact in any
    order, so torch.cummax gives blocked.cummax's values."""
    if x.dtype.is_floating_point:
        raise TypeError("cummax takes integers")
    if x.shape[0] == 0:
        return x
    return torch.clamp(torch.cummax(x, dim=0).values, min=lowest)


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum; integer inputs only (exact in any order,
    and torch.cumsum is deterministic)."""
    if x.dtype.is_floating_point:
        raise TypeError("cumsum takes integers; float prefix sums go through "
                        "segment_sums or segment_reduce")
    return torch.cumsum(x, dim=0, dtype=x.dtype)


def _shift_right(y: torch.Tensor, shift: int, fill) -> torch.Tensor:
    """y shifted right by ``shift`` along its last dim, ``fill`` entering."""
    pad = torch.full(y.shape[:-1] + (shift,), fill, dtype=y.dtype, device=y.device)
    return torch.cat([pad, y[..., :-shift]], dim=-1)


def _pad_rows(x: torch.Tensor, fill):
    n = x.shape[0]
    rows = -(-n // _C)
    pad = torch.full((rows * _C - n,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad]).reshape(rows, _C), n


def segment_sums(vals: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """Running sum of the current segment at every position of a sorted
    f32 stream (``first`` marks segment starts), in blocked.segment_sums's
    order.  Contract as there: ``vals`` must be non-negative (the in-row
    base propagates by a cumulative max of prefix sums)."""
    lowest = -3.0e38
    y, n = _pad_rows(vals, 0.0)
    f, _ = _pad_rows(first, False)
    rows = y.shape[0]

    c = y
    shift = 1
    while shift < _C:
        c = c + _shift_right(c, shift, 0.0)
        shift *= 2
    base = torch.where(f, c - y, torch.full_like(c, lowest))
    started = f
    shift = 1
    while shift < _C:
        base = torch.maximum(base, _shift_right(base, shift, lowest))
        started = started | _shift_right(started, shift, False)
        shift *= 2
    local = c - base

    any_start = f.any(dim=1)
    rowsum = c[:, -1]
    v = torch.where(any_start, local[:, -1], rowsum)
    r = any_start
    shift = 1
    while shift < rows:
        pv = _shift_right(v, shift, 0.0)
        pr = _shift_right(r, shift, False)
        v = torch.where(r, v, pv + v)
        r = r | pr
        shift *= 2
    carry_prev = torch.cat([torch.zeros(1, dtype=vals.dtype, device=vals.device), v[:-1]])
    out = torch.where(started, local, carry_prev[:, None] + c)
    return out.reshape(-1)[:n]


def segment_compose_affine_clamp(a, b, lo, hi, first):
    """Segmented composition of the monotone maps x -> clamp(a*x + b, lo, hi)
    (a >= 0) over a sorted stream, in blocked.segment_compose_affine_clamp's
    order.  The family is closed under composition:
      (f2 . f1)(x) = clamp(a2*a1*x + a2*b1 + b2,
                           clamp(a2*lo1 + b2, lo2, hi2),
                           clamp(a2*hi1 + b2, lo2, hi2)).
    Returns (A, B, LO, HI) of the map composed since the segment start, at
    every position (inclusive); apply it as min(max(A*x0 + B, LO), HI)."""
    big = 3.0e38
    idents = (1.0, 0.0, -big, big)

    def combine(left, right):
        a1, b1, lo1, hi1 = left
        a2, b2, lo2, hi2 = right
        return (a1 * a2,
                a2 * b1 + b2,
                torch.minimum(torch.maximum(a2 * lo1 + b2, lo2), hi2),
                torch.minimum(torch.maximum(a2 * hi1 + b2, lo2), hi2))

    n = a.shape[0]
    vals = tuple(_pad_rows(x, c)[0] for x, c in zip((a, b, lo, hi), idents))
    f, _ = _pad_rows(first, False)
    rows = f.shape[0]

    started = f
    shift = 1
    while shift < _C:
        shifted = tuple(_shift_right(x, shift, c) for x, c in zip(vals, idents))
        comp = combine(shifted, vals)
        vals = tuple(torch.where(started, v, c) for v, c in zip(vals, comp))
        started = started | _shift_right(started, shift, False)
        shift *= 2

    # Carry across rows over the open segment tails.
    tv = tuple(v[:, -1] for v in vals)
    tr = f.any(dim=1)
    shift = 1
    while shift < rows:
        shifted = tuple(_shift_right(x, shift, c) for x, c in zip(tv, idents))
        comp = combine(shifted, tv)
        tv = tuple(torch.where(tr, v, c) for v, c in zip(tv, comp))
        tr = tr | _shift_right(tr, shift, False)
        shift *= 2
    carry = tuple(torch.cat([torch.full((1,), c, dtype=x.dtype, device=x.device), x[:-1]])
                  for x, c in zip(tv, idents))

    comp = combine(tuple(x[:, None] for x in carry), vals)
    return tuple(torch.where(started, v, c).reshape(-1)[:n] for v, c in zip(vals, comp))
