"""SLAM cloud + trajectory ingestion.

Reference parity: slamio/ (SlamCloudLoader, PointCloudReader backends for
PLY / text trajectory / XYZ) and ohmgpu/GpuTransformSamples (timestamped
pose interpolation of local samples into global rays, here vectorised with
searchsorted + lerp/slerp instead of a per-sample GPU binary search).

Supported cloud inputs: .ply (binary LE / ascii, via io.ply), .xyz / .txt
text tables (time x y z [intensity]), .pcd (ascii / binary /
binary_compressed, via io.pcd), .laz/.las when laspy is importable
(gated — not part of the baked environment).
Trajectory inputs: text tables `time x y z [qx qy qz qw]` or a cloud file
with per-point timestamps.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ohm_tpu_torch.io.ply import load_ply


@dataclasses.dataclass
class SamplePoint:
    timestamp: float
    origin: np.ndarray
    sample: np.ndarray
    intensity: float = 0.0
    colour: tuple = ()


def _load_text_table(filename):
    rows = []
    with open(filename) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(("#", "//")):
                continue
            parts = line.replace(",", " ").split()
            try:
                rows.append([float(p) for p in parts])
            except ValueError:
                continue  # header line
    if not rows:
        return np.zeros((0, 0))
    width = min(len(r) for r in rows)
    return np.asarray([r[:width] for r in rows], dtype=np.float64)


def _read_ply_cloud(filename):
    props = load_ply(filename)
    out = {"points": np.column_stack([props["x"], props["y"], props["z"]])}
    for tname in ("time", "timestamp", "gpstime", "gps_time", "t"):
        if tname in props:
            out["timestamps"] = np.asarray(props[tname], np.float64)
            break
    if "intensity" in props:
        out["intensities"] = np.asarray(props["intensity"], np.float32)
    for rname in ("return_number", "returnnumber", "return_num"):
        if rname in props:
            out["return_numbers"] = np.asarray(props[rname], np.uint8)
            break
    if all(k in props for k in ("nx", "ny", "nz")):
        out["normals"] = np.column_stack([props["nx"], props["ny"], props["nz"]]).astype(np.float32)
    return out


def _read_las_cloud(filename):
    from ohm_tpu_torch.io.las import read_las

    return read_las(filename)


def _read_laz_cloud(filename):
    # Native LASzip codec (io.las + native/laszip.cpp) — point formats 0-3.
    # laspy (when importable) is the fallback for layered 1.4 formats.
    from ohm_tpu_torch.io.las import read_las

    try:
        return read_las(filename)
    except NotImplementedError as unsupported:
        try:
            import laspy
        except ImportError:
            # Keep the codec's actionable message (it names the unsupported
            # LASzip compressor / point format and how to convert the file)
            # instead of a context-free "No module named 'laspy'".
            raise NotImplementedError(
                f"{unsupported} (laspy is not installed as a fallback)"
            ) from unsupported
        las = laspy.read(filename)
        out = {"points": np.column_stack([las.x, las.y, las.z])}
        if hasattr(las, "gps_time"):
            out["timestamps"] = np.asarray(las.gps_time, np.float64)
        if hasattr(las, "intensity"):
            out["intensities"] = np.asarray(las.intensity, np.float32)
        if hasattr(las, "return_number"):
            out["return_numbers"] = np.asarray(las.return_number, np.uint8)
        return out


def _read_pcd_cloud(filename):
    from ohm_tpu_torch.io.pcd import read_pcd

    out = read_pcd(filename)
    out.pop("fields", None)
    return out


def _read_text_cloud(filename):
    # Text table: [time] x y z [intensity]
    table = _load_text_table(filename)
    if table.shape[1] >= 4:
        return {"timestamps": table[:, 0], "points": table[:, 1:4],
                **({"intensities": table[:, 4].astype(np.float32)} if table.shape[1] > 4 else {})}
    return {"points": table[:, 0:3]}


#: Extension -> reader registry (reference: slamio/PointCloudReader.h:58-105
#: createPointCloudReader backend dispatch).  register_cloud_reader extends
#: it, mirroring the reference's pluggable reader set.
_CLOUD_READERS = {
    ".ply": _read_ply_cloud,
    ".las": _read_las_cloud,
    ".laz": _read_laz_cloud,
    ".pcd": _read_pcd_cloud,
    ".xyz": _read_text_cloud,
    ".txt": _read_text_cloud,
}


def register_cloud_reader(extension: str, reader) -> None:
    """Register a cloud reader callable(filename) -> dict for an extension."""
    _CLOUD_READERS[extension.lower()] = reader


def load_cloud(filename: str):
    """Load a point cloud: returns dict with 'points' [N,3], optional
    'timestamps' [N], 'intensities' [N], 'return_numbers' [N],
    'normals' [N,3].  Backend chosen by extension via the reader registry."""
    ext = os.path.splitext(filename)[1].lower()
    reader = _CLOUD_READERS.get(ext, _read_text_cloud)
    return reader(filename)


def load_trajectory(filename: str):
    """Load a trajectory: (timestamps [N], positions [N,3], quaternions [N,4] or None).

    Text format: `time x y z [qx qy qz qw]` (reference: slamio text trajectory).
    """
    ext = os.path.splitext(filename)[1].lower()
    if ext == ".ply":
        props = load_ply(filename)
        t = None
        for tname in ("time", "timestamp", "gpstime", "gps_time", "t"):
            if tname in props:
                t = np.asarray(props[tname], np.float64)
                break
        if t is None:
            raise ValueError("trajectory cloud must carry per-point timestamps")
        return t, np.column_stack([props["x"], props["y"], props["z"]]), None
    table = _load_text_table(filename)
    if table.shape[1] < 4:
        raise ValueError("trajectory requires at least `time x y z` columns")
    quats = table[:, 4:8] if table.shape[1] >= 8 else None
    return table[:, 0], table[:, 1:4], quats


def interpolate_positions(traj_times, traj_pos, times):
    """Linear position interpolation at sample times (clamped at the ends)."""
    times = np.asarray(times, np.float64)
    idx = np.clip(np.searchsorted(traj_times, times), 1, len(traj_times) - 1)
    t0 = traj_times[idx - 1]
    t1 = traj_times[idx]
    w = np.where(t1 > t0, (times - t0) / np.maximum(t1 - t0, 1e-12), 0.0)
    w = np.clip(w, 0.0, 1.0)[:, None]
    return traj_pos[idx - 1] * (1 - w) + traj_pos[idx] * w


def _slerp(q0, q1, w):
    d = np.sum(q0 * q1, axis=-1, keepdims=True)
    q1 = np.where(d < 0, -q1, q1)
    d = np.abs(d)
    theta = np.arccos(np.clip(d, -1.0, 1.0))
    sin_t = np.sin(theta)
    near = sin_t[:, 0] < 1e-6
    w0 = np.where(near[:, None], 1 - w, np.sin((1 - w) * theta) / np.maximum(sin_t, 1e-12))
    w1 = np.where(near[:, None], w, np.sin(w * theta) / np.maximum(sin_t, 1e-12))
    q = q0 * w0 + q1 * w1
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _quat_rotate(q, v):
    """Rotate vectors v by quaternions q (x, y, z, w)."""
    u = q[:, :3]
    s = q[:, 3:4]
    return (2 * np.sum(u * v, axis=-1, keepdims=True) * u
            + (s * s - np.sum(u * u, axis=-1, keepdims=True)) * v
            + 2 * s * np.cross(u, v))


def transform_samples(sample_times, local_samples, traj_times, traj_pos, traj_quat=None):
    """Transform sensor-local samples to global rays using timestamped poses.

    TPU-native analogue of ohmgpu/GpuTransformSamples (TransformSamples.cl):
    vectorised searchsorted + lerp/slerp replaces the per-thread binary
    search.  Returns interleaved (2N, 3) rays (origin, global sample).
    """
    sample_times = np.asarray(sample_times, np.float64)
    local = np.asarray(local_samples, np.float64).reshape(-1, 3)
    origins = interpolate_positions(traj_times, traj_pos, sample_times)
    if traj_quat is not None:
        idx = np.clip(np.searchsorted(traj_times, sample_times), 1, len(traj_times) - 1)
        t0 = traj_times[idx - 1]
        t1 = traj_times[idx]
        w = np.clip(np.where(t1 > t0, (sample_times - t0) / np.maximum(t1 - t0, 1e-12), 0.0), 0, 1)[:, None]
        q = _slerp(traj_quat[idx - 1], traj_quat[idx], w)
        global_samples = origins + _quat_rotate(q, local)
    else:
        global_samples = origins + local
    rays = np.empty((2 * len(local), 3))
    rays[0::2] = origins
    rays[1::2] = global_samples
    return rays


def transform_samples_device(sample_times, local_samples, traj_times,
                             traj_pos, traj_quat=None, device="cuda"):
    """Device-side sample transform in PyTorch ops on ``device``: the
    counterpart of ``ohm_tpu.io.slam.transform_samples_device`` (a jitted
    function there) and of the reference's GPU kernel
    (ohmgpu/gpu/TransformSamples.cl:1-219 — per-ray binary search into the
    uploaded trajectory window, lerp + slerp in f32).

    The trajectory window and local samples upload once; searchsorted (left
    side, as jnp.searchsorted's default) + vectorised lerp/slerp replace the
    per-thread binary search, with the JAX version's clips and its 1e-6 /
    1e-12 guards.  f32 throughout, like the reference kernel; the f64 host
    variant (transform_samples) remains the loader default.  Returns a
    tensor on ``device`` of interleaved (2N, 3) f32 rays; "cuda" without a
    CUDA device raises.
    """
    import torch

    from ohm_tpu_torch.device import resolve_device

    dev = resolve_device(device)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    st = f32(sample_times)
    local = f32(np.asarray(local_samples).reshape(-1, 3))
    tt = f32(traj_times)
    tp = f32(traj_pos)
    idx = torch.clamp(torch.searchsorted(tt, st, right=False), 1, tt.shape[0] - 1)
    t0 = tt[idx - 1]
    t1 = tt[idx]
    w = torch.clamp(torch.where(t1 > t0, (st - t0) / torch.clamp(t1 - t0, min=1e-12),
                                torch.zeros_like(st)), 0, 1)[:, None]
    origins = tp[idx - 1] * (1 - w) + tp[idx] * w
    if traj_quat is None:
        samples = origins + local
    else:
        tq = f32(traj_quat)
        q0 = tq[idx - 1]
        q1 = tq[idx]
        d = torch.sum(q0 * q1, dim=-1, keepdim=True)
        q1 = torch.where(d < 0, -q1, q1)
        d = torch.abs(d)
        theta = torch.arccos(torch.clamp(d, -1.0, 1.0))
        sin_t = torch.sin(theta)
        near = sin_t[:, 0] < 1e-6
        w0 = torch.where(near[:, None], 1 - w,
                         torch.sin((1 - w) * theta) / torch.clamp(sin_t, min=1e-12))
        w1 = torch.where(near[:, None], w,
                         torch.sin(w * theta) / torch.clamp(sin_t, min=1e-12))
        q = q0 * w0 + q1 * w1
        q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
        u = q[:, :3]
        s = q[:, 3:4]
        rot = (2 * torch.sum(u * local, dim=-1, keepdim=True) * u
               + (s * s - torch.sum(u * u, dim=-1, keepdim=True)) * local
               + 2 * s * torch.linalg.cross(u, local, dim=-1))
        samples = origins + rot
    rays = torch.empty((2 * local.shape[0], 3), dtype=torch.float32, device=dev)
    rays[0::2] = origins
    rays[1::2] = samples
    return rays


class SlamCloudLoader:
    """Streams (origin, sample) pairs from a cloud + trajectory.

    Reference API: slamio/SlamCloudLoader.h:20-42.  With a ray cloud
    (normals = sample->sensor) the trajectory is implicit; with no
    trajectory, origins default to a fixed sensor position.
    """

    def __init__(self, cloud_file: str, trajectory_file: str | None = None,
                 ray_cloud: bool = False, fixed_origin=(0.0, 0.0, 0.0),
                 return_number_mode: str = "off",
                 sensor_batch_delta: float = 0.0):
        self.cloud = load_cloud(cloud_file)
        self.ray_cloud = ray_cloud
        # Force a batch when the sensor moves more than this from the batch's
        # first origin (reference: ohmapp/SlamIOSource.cpp:28,263,304 — the
        # pending sample starts the next batch).  <= 0 disables.
        self.sensor_batch_delta = float(sensor_batch_delta)
        self.fixed_origin = np.asarray(fixed_origin, np.float64)
        self.trajectory = load_trajectory(trajectory_file) if trajectory_file else None
        self._cursor = 0
        # Dual-return handling (reference: ohmapp/DataSource.h ReturnNumberMode,
        # slamio/SlamCloudLoader.cpp:376-413): "explicit" uses a return_number
        # channel; "auto" additionally infers — consecutive samples sharing a
        # timestamp are marked as second returns.
        self.return_numbers = None
        if return_number_mode != "off":
            self.return_numbers = self.cloud.get("return_numbers")
            times = self.cloud.get("timestamps")
            if self.return_numbers is None and return_number_mode == "auto" and times is not None:
                same = np.zeros(len(times), bool)
                same[1:] = times[1:] == times[:-1]
                self.return_numbers = same.astype(np.uint8)

        pts = self.cloud["points"]
        times = self.cloud.get("timestamps")
        if ray_cloud:
            if "normals" not in self.cloud:
                raise ValueError("ray cloud requires normals (sample->sensor)")
            self.origins = pts + self.cloud["normals"].astype(np.float64)
        elif self.trajectory is not None:
            if times is None:
                raise ValueError("trajectory pairing requires per-point timestamps")
            tt, tp, _ = self.trajectory
            self.origins = interpolate_positions(tt, tp, times)
        else:
            self.origins = np.broadcast_to(self.fixed_origin, pts.shape).copy()

    @property
    def point_count(self) -> int:
        return len(self.cloud["points"])

    def next_batch(self, batch_size: int):
        """Next (rays, timestamps, intensities, return_numbers) batch or None
        when exhausted.  return_numbers is None unless dual-return handling is
        enabled (nonzero = secondary return)."""
        pts = self.cloud["points"]
        if self._cursor >= len(pts):
            return None
        end = min(self._cursor + batch_size, len(pts))
        if self.sensor_batch_delta > 0 and end - self._cursor > 1:
            # Cut the batch at the first sample whose sensor origin moved more
            # than the delta from the batch's first origin
            # (ohmapp/SlamIOSource.cpp:300-304: that sample starts the NEXT
            # batch with a fresh batch_origin).
            window = self.origins[self._cursor:end]
            d2 = np.sum((window - window[0]) ** 2, axis=1)
            exceeded = np.nonzero(d2 > self.sensor_batch_delta ** 2)[0]
            if exceeded.size and exceeded[0] > 0:
                end = self._cursor + int(exceeded[0])
        sl = slice(self._cursor, end)
        self._cursor = end
        n = end - sl.start
        rays = np.empty((2 * n, 3))
        rays[0::2] = self.origins[sl]
        rays[1::2] = pts[sl]
        times = self.cloud.get("timestamps")
        intensities = self.cloud.get("intensities")
        return (rays,
                times[sl] if times is not None else None,
                intensities[sl] if intensities is not None else None,
                self.return_numbers[sl] if self.return_numbers is not None else None)

    def reset(self):
        self._cursor = 0
