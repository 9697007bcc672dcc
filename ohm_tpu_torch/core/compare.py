"""Map comparison utilities (reference: ohm/CompareMaps.{h,cpp}).

Structural (layout) and per-voxel content comparison with the reference's
severity model: levelled Log callbacks (Severity kInfo/kWarning/kError —
CompareMaps.h:32-38), a kContinue flag selecting continue-vs-stop-on-error
(CompareMaps.h:41-45), per-layer entry points and a VoxelsResult-style
summary.  Used for CPU-vs-TPU validation and the ohmcmp tool.

Tolerances follow the reference's model (CompareMaps.cpp:57-74,
configureTolerance overloads CompareMaps.cpp:391-470): an epsilon is
configured *per member*, typed like the member itself (an int16 member
takes an integer epsilon), and members without a configured epsilon
compare exactly.  Where the reference bakes the epsilons into a tolerance
``MapLayer`` (member clear values reinterpreted as the epsilon bit
pattern), the natural Python shape is a ``{member_name: epsilon}``
mapping; ``configure_tolerance`` mirrors the reference helper for
call-site parity.  The comparison itself matches ``compareDatum``:
``val == ref or abs-diff <= epsilon`` (the equality test deliberately
admits matching infinities).

Members are matched by NAME, not position (compareVoxel searches the eval
layout for each reference member, CompareMaps.cpp:318-345), so maps whose
layers agree in content but order members differently still compare; a
member missing from the eval map or carrying a different data type fails
the voxel, as in the reference.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np


class Severity(enum.IntEnum):
    """Reference: ohm/CompareMaps.h:32-38."""

    INFO = 0
    WARNING = 1
    ERROR = 2


class Flag(enum.IntFlag):
    """Reference: ohm/CompareMaps.h:41-45."""

    ZERO = 0
    CONTINUE = 1  #: continue comparing after the first error


class CompareStop(Exception):
    """Raised internally to stop a comparison when kContinue is not set."""


@dataclasses.dataclass
class CompareResult:
    """Aggregate result (superset of the reference VoxelsResult:
    voxels_passed/voxels_failed/layout_match, CompareMaps.h:48-56)."""

    layout_match: bool = True
    regions_compared: int = 0
    voxels_compared: int = 0
    voxels_passed: int = 0
    voxels_failed: int = 0
    missing_regions: int = 0
    messages: list = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.layout_match and self.voxels_failed == 0 and self.missing_regions == 0

    def __bool__(self) -> bool:  # reference: explicit operator bool
        return self.ok


def configure_tolerance(tolerance: dict, member_name: str, epsilon) -> dict:
    """Record a per-member comparison epsilon
    (reference: compare::configureTolerance, CompareMaps.cpp:391-470).

    The reference stores epsilons as extra members on a tolerance MapLayer;
    here the tolerance is a plain ``{member: epsilon}`` dict.  Negative
    epsilons are absolute-valued as in the signed-integer overloads.
    """
    tolerance[member_name] = abs(epsilon)
    return tolerance


def _member_epsilon(tolerance, member: str, dtype) -> float | int | None:
    """Resolve the epsilon for one member, or None for an exact compare.

    ``tolerance`` may be None (all exact), a scalar (legacy: applied to
    every FLOAT member, ints exact), or a {member: epsilon} mapping.
    """
    if tolerance is None:
        return None
    if isinstance(tolerance, dict):
        return tolerance.get(member)
    # Scalar legacy form: float members only, zero still engages the
    # finite/NaN-aware float path.
    if np.issubdtype(dtype, np.floating):
        return tolerance
    return None


def _compare_member(a: np.ndarray, b: np.ndarray, epsilon) -> np.ndarray:
    """Vectorised compareDatum (CompareMaps.cpp:57-74): boolean bad-mask.

    Equality passes always (covers matching inf/inf); otherwise the
    absolute difference must be <= epsilon.  NaNs never compare equal in
    the reference's ``val == ref`` either, so mismatched NaNs fail unless
    both sides are NaN (bitwise-equal NaN payloads memcmp equal in the
    exact path; the tolerant path treats any NaN pair as equal, which is
    the useful semantic for maps that use NaN sentinels).
    """
    if epsilon is None:
        # Raw comparison (reference: memcmp). For floats, NaN != NaN under
        # ==, but identical clear-pattern NaNs should pass as they do under
        # memcmp — compare bit patterns.
        if np.issubdtype(a.dtype, np.floating):
            return a.view(np.uint8 if a.dtype.itemsize == 1 else
                          {2: np.uint16, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize]) != \
                   b.view(np.uint8 if b.dtype.itemsize == 1 else
                          {2: np.uint16, 4: np.uint32, 8: np.uint64}[b.dtype.itemsize])
        return a != b
    if np.issubdtype(a.dtype, np.floating):
        both_nan = np.isnan(a) & np.isnan(b)
        eq = a == b  # covers matching infinities
        with np.errstate(invalid="ignore"):
            diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
        good = both_nan | eq | (np.isfinite(a) & np.isfinite(b) & (diff <= epsilon))
        return ~good
    # Integer members: unsigned-safe |a - b| <= eps via max-min, as the
    # reference swaps to subtract from the larger (CompareMaps.cpp:66-73).
    hi = np.maximum(a, b).astype(np.uint64 if np.issubdtype(a.dtype, np.unsignedinteger)
                                 else np.int64)
    lo = np.minimum(a, b).astype(hi.dtype)
    return (hi - lo) > epsilon


def _have_expect(ref: np.ndarray, test: np.ndarray, bad: np.ndarray) -> str:
    """First-mismatch detail string (reference: memberValueErrorString,
    "have <eval> expect <ref>", CompareMaps.cpp:147-158)."""
    idx = int(np.flatnonzero(bad)[0])
    return f"first at voxel index {idx}: have {test.flat[idx]} expect {ref.flat[idx]}"


def _make_log(result: CompareResult, log, flags: Flag, log_limit: int):
    def emit(severity: Severity, msg: str):
        if log is not None:
            log(severity, msg)
        elif len(result.messages) < log_limit:
            result.messages.append((severity, msg))
        if severity >= Severity.ERROR and not (flags & Flag.CONTINUE):
            raise CompareStop(msg)

    return emit


def compare_layout_layer(ref_map, test_map, layer_name: str,
                         flags: Flag = Flag.CONTINUE, log=None,
                         result: CompareResult | None = None) -> CompareResult:
    """Schema equivalence of one named layer with per-member detail
    (reference: CompareMaps::compareLayoutLayer, CompareMaps.cpp:77-144):
    voxel byte size, member count, then per-member name/type/size."""
    result = result or CompareResult()
    emit = _make_log(result, log, flags, log_limit=64)
    try:
        layer = ref_map.layout.layer(layer_name)
        other = test_map.layout.layer(layer_name)
        if layer is None or other is None:
            result.layout_match = False
            emit(Severity.ERROR, f"layer {layer_name!r} missing from "
                                 f"{'reference' if layer is None else 'test'} map")
            return result
        rv, tv = layer.voxel_layout, other.voxel_layout
        if rv.voxel_byte_size() != tv.voxel_byte_size():
            result.layout_match = False
            emit(Severity.ERROR,
                 f"layer {layer_name!r} voxel size mismatch: "
                 f"{tv.voxel_byte_size()} expect {rv.voxel_byte_size()}")
        if len(rv.members) != len(tv.members):
            result.layout_match = False
            emit(Severity.ERROR,
                 f"layer {layer_name!r} member count mismatch: "
                 f"{len(tv.members)} expect {len(rv.members)}")
        for i, (rm, tm) in enumerate(zip(rv.members, tv.members)):
            if rm.name != tm.name:
                result.layout_match = False
                emit(Severity.ERROR, f"layer {layer_name!r} member name mismatch "
                                     f"({i}): {tm.name} expect {rm.name}")
            if rm.type != tm.type:
                result.layout_match = False
                emit(Severity.ERROR, f"layer {layer_name!r} member type mismatch "
                                     f"({i}): {tm.type} expect {rm.type}")
            if rm.byte_size != tm.byte_size:
                result.layout_match = False
                emit(Severity.ERROR, f"layer {layer_name!r} member size mismatch "
                                     f"({i}): {tm.byte_size} expect {rm.byte_size}")
    except CompareStop:
        pass
    return result


def compare_layout(ref_map, test_map, flags: Flag = Flag.CONTINUE, log=None,
                   result: CompareResult | None = None) -> CompareResult:
    """Layer schema equivalence over every reference layer."""
    result = result or CompareResult()
    try:
        for layer in ref_map.layout:
            compare_layout_layer(ref_map, test_map, layer.name,
                                 flags=Flag.ZERO if not (flags & Flag.CONTINUE) else flags,
                                 log=log, result=result)
            if not result.layout_match and not (flags & Flag.CONTINUE):
                break
    except CompareStop:
        pass
    return result


def _compare_layer_arrays(ra, ta, layer_label: str, tolerance, result, emit,
                          count_into_result: bool = True) -> np.ndarray | None:
    """Compare two structured layer arrays member-by-NAME.

    Returns a per-voxel bad mask (any member differing), or None when a
    member is missing/type-mismatched (structural failure; every voxel of
    the layer is counted failed, as compareVoxel returns false outright,
    CompareMaps.cpp:338-346)."""
    any_bad = np.zeros(ra.shape, bool)
    for member in ra.dtype.names:
        a = ra[member]
        if member not in (ta.dtype.names or ()):
            emit(Severity.ERROR, f"{layer_label}: member {member!r} missing from test map")
            return None
        b = ta[member]
        if a.dtype != b.dtype:
            emit(Severity.ERROR, f"{layer_label}: member {member!r} type mismatch: "
                                 f"{b.dtype} expect {a.dtype}")
            return None
        eps = _member_epsilon(tolerance, member, a.dtype)
        bad = _compare_member(a, b, eps)
        n_bad = int(np.count_nonzero(bad))
        if count_into_result:
            result.voxels_compared += a.size
            result.voxels_passed += a.size - n_bad
            result.voxels_failed += n_bad
        if n_bad:
            emit(Severity.ERROR,
                 f"{layer_label}.{member}: {n_bad} voxels differ "
                 f"({_have_expect(a, b, bad)})")
        any_bad |= bad.reshape(ra.shape)
    return any_bad


def compare_voxel(ref_map, test_map, key, layers=None, tolerance=None,
                  flags: Flag = Flag.CONTINUE, log=None) -> bool:
    """Compare ONE voxel across maps
    (reference: CompareMaps::compareVoxel, CompareMaps.h:115-126).

    ``key`` is a ``(region_key, local)`` pair (the repo's Key shape).
    Returns True when every requested layer's members match at that voxel;
    a missing region/member/type mismatch returns False, as the reference
    returns false on invalid buffers or unmatched members.
    """
    result = CompareResult()
    emit = _make_log(result, log, flags, log_limit=16)
    region_key, local = key
    ref_chunk = ref_map.region(tuple(region_key))
    test_chunk = test_map.region(tuple(region_key))
    if ref_chunk is None or test_chunk is None:
        return False
    vidx = int(ref_map.voxel_index(np.asarray(local)))
    layers = layers or [l.name for l in ref_map.layout if test_map.layout.layer(l.name)]
    ok = True
    try:
        for name in layers:
            ri = ref_map.layout.layer_index(name)
            ti = test_map.layout.layer_index(name)
            if ri < 0 or ti < 0:
                ok = False
                continue
            bad = _compare_layer_arrays(
                ref_chunk.layers[ri][vidx:vidx + 1], test_chunk.layers[ti][vidx:vidx + 1],
                f"voxel {tuple(region_key)}:{tuple(local)} layer {name}",
                tolerance, result, emit, count_into_result=False)
            if bad is None or bad.any():
                ok = False
    except CompareStop:
        ok = False
    return ok


def compare_voxels(ref_map, test_map, layers=None, tolerance=None,
                   flags: Flag = Flag.CONTINUE, log=None,
                   result: CompareResult | None = None, log_limit: int = 20) -> CompareResult:
    """Per-voxel comparison over the reference map's regions
    (reference: CompareMaps::compareVoxels, CompareMaps.h:127-141).

    ``tolerance``: None (exact), a scalar (legacy: every float member), or
    a ``{member: epsilon}`` mapping built with ``configure_tolerance`` —
    matching the reference's per-member tolerance layer.
    """
    result = result or CompareResult()
    emit = _make_log(result, log, flags, log_limit)
    layers = layers or [l.name for l in ref_map.layout if test_map.layout.layer(l.name)]
    try:
        for key, ref_chunk in ref_map.chunks.items():
            test_chunk = test_map.region(key)
            if test_chunk is None:
                result.missing_regions += 1
                emit(Severity.ERROR, f"region {key} missing from test map")
                continue
            result.regions_compared += 1
            for name in layers:
                ri = ref_map.layout.layer_index(name)
                ti = test_map.layout.layer_index(name)
                ra = ref_chunk.layers[ri]
                ta = test_chunk.layers[ti]
                bad = _compare_layer_arrays(ra, ta, f"region {key} layer {name}",
                                            tolerance, result, emit)
                if bad is None:
                    # Structural member failure: count the layer as failed.
                    result.voxels_compared += ra.size
                    result.voxels_failed += ra.size
    except CompareStop:
        pass
    return result


def compare_maps(ref_map, test_map, tolerance=None,
                 flags: Flag = Flag.CONTINUE, log=None) -> CompareResult:
    """Full comparison (reference: ohmcmp / CompareMaps usage): layout first,
    voxels only when the layout matches (VoxelsResult.layout_match gate)."""
    result = compare_layout(ref_map, test_map, flags=flags, log=log)
    if result.layout_match:
        compare_voxels(ref_map, test_map, tolerance=tolerance, flags=flags,
                       log=log, result=result)
    return result
