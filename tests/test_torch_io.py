"""The port's I/O: tests/test_laz.py's, tests/test_pcd.py's and
tests/test_serialise.py's tests on ohm_tpu_torch (its copy of the LASzip
codec, io.las, io.pcd, io.serialise), at the same sizes, the
reference-map cases skipping where the reference's do (their directory is
named by OHM_REFERENCE_DATA); a .ohm written by
either package loading in the other with equal chunks, and the same map
content saving to the same bytes in both; the port's
transform_samples_device on the CPU within 1e-5 of the JAX package's and
within 5e-4 of the f64 host transform; and a failed LASzip build raising
with g++'s errors.  The port's codec builds on first use; nothing builds
while this module is imported."""

import os

import numpy as np
import pytest

from ohm_tpu_torch import native
from ohm_tpu_torch.core.layout import MEAN_LAYER, OCCUPANCY_LAYER
from ohm_tpu_torch.core.map import MapFlag, OccupancyMap
from ohm_tpu_torch.io import SerialisationError, load, load_header, save
from ohm_tpu_torch.io.pcd import lzf_compress, lzf_decompress, read_pcd, write_pcd
from ohm_tpu_torch.io.slam import load_cloud
from ohm_tpu_torch.oracle.occupancy import RayMapperOccupancy


# ------------------------------------------------------------------------- #
# tests/test_laz.py

def _roundtrip(rec, types, sizes, chunk=50000):
    stream, chunk_bytes = native.laz_compress(rec, types, sizes, chunk)
    starts = np.concatenate([[0], np.cumsum(chunk_bytes)[:-1]]) if chunk_bytes else [0]
    out = native.laz_decompress(np.frombuffer(stream, np.uint8), types, sizes,
                                len(rec), chunk, starts)
    return out, stream


def _fmt1_records(rng, n):
    rec = np.zeros((n, 28), np.uint8)
    xyz = np.cumsum(rng.integers(-2000, 2000, size=(n, 3)), axis=0).astype("<i4")
    rec[:, 0:12] = xyz.view(np.uint8).reshape(n, 12)
    rec[:, 12:14] = rng.integers(0, 65536, n).astype("<u2").view(np.uint8).reshape(n, 2)
    rn = rng.integers(1, 3, n)
    nr = np.maximum(rn, rng.integers(1, 4, n))
    rec[:, 14] = ((rn & 7) | ((nr & 7) << 3) | (rng.integers(0, 2, n) << 6)).astype(np.uint8)
    rec[:, 15] = rng.integers(0, 32, n)
    rec[:, 16] = rng.integers(0, 256, n)
    rec[:, 18:20] = rng.integers(0, 3, n).astype("<u2").view(np.uint8).reshape(n, 2)
    t = np.cumsum(rng.random(n) * 1e-4) + 3.0e5
    rec[:, 20:28] = t.astype("<f8").view(np.uint8).reshape(n, 8)
    return rec


def test_point10_gpstime_roundtrip_multichunk():
    rng = np.random.default_rng(7)
    rec = _fmt1_records(rng, 120001)  # 3 chunks at 50k
    out, stream = _roundtrip(rec, [6, 7], [20, 8])
    assert np.array_equal(out, rec)
    assert len(stream) < rec.size  # actually compresses


def test_extreme_values_roundtrip():
    """Full-width correctors (k up to 32), int32 extremes, NaN/inf GPS
    times, interleaved far-apart time sequences (sequence switching)."""
    rng = np.random.default_rng(3)
    n = 4096
    rec = np.zeros((n, 28), np.uint8)
    xyz = rng.choice(np.array([-2**31, -1, 0, 1, 2**31 - 1], np.int64),
                     size=(n, 3)).astype("<i4")
    rec[:, 0:12] = xyz.view(np.uint8).reshape(n, 12)
    rec[:, 14] = 0x09
    t = np.empty(n)
    t[0::2] = np.linspace(1e5, 1e5 + 1, (n + 1) // 2)
    t[1::2] = np.linspace(-3e8, -3e8 + 50, n // 2)
    t[17] = np.nan
    t[33] = np.inf
    t[51] = 0.0
    rec[:, 20:28] = t.astype("<f8").view(np.uint8).reshape(n, 8)
    out, _ = _roundtrip(rec, [6, 7], [20, 8])
    assert np.array_equal(out, rec)


def test_rgb_and_extra_bytes_roundtrip():
    rng = np.random.default_rng(11)
    n = 30000
    rec = np.zeros((n, 39), np.uint8)
    rec[:, 0:12] = np.cumsum(rng.integers(-5, 5, (n, 3)), axis=0).astype(
        "<i4").view(np.uint8).reshape(n, 12)
    rec[:, 14] = 0x09
    rec[:, 20:28] = (np.arange(n) * 1e-3).astype("<f8").view(np.uint8).reshape(n, 8)
    rgb = rng.integers(0, 65536, (n, 3)).astype("<u2")
    grey = rng.random(n) < 0.3
    rgb[grey, 1] = rgb[grey, 0]
    rgb[grey, 2] = rgb[grey, 0]
    rec[:, 28:34] = rgb.view(np.uint8).reshape(n, 6)
    rec[:, 34:39] = rng.integers(0, 256, (n, 5)).astype(np.uint8)
    types, sizes = [6, 7, 8, 0], [20, 8, 6, 5]
    out, _ = _roundtrip(rec, types, sizes)
    assert np.array_equal(out, rec)
    # degenerate chunkings
    for chunk in (1, 0xFFFFFFFF):
        out, _ = _roundtrip(rec[:977], types, sizes, chunk=chunk)
        assert np.array_equal(out, rec[:977])
    out, _ = _roundtrip(rec[:1], types, sizes)
    assert np.array_equal(out, rec[:1])


def test_chunk_table_codec_roundtrip():
    sizes = [123456, 1, 99, 2**31 - 1, 50000, 50000]
    payload = native.laz_write_chunk_table(sizes)
    back = native.laz_read_chunk_table(np.frombuffer(payload, np.uint8),
                                       len(sizes))
    assert list(back) == sizes


def test_write_laz_read_las_file_roundtrip(tmp_path):
    """Full .laz file: header + laszip VLR + chunk table; read back through
    the generic read_las entry (the path ohmpop/slamio uses)."""
    from ohm_tpu_torch.io.las import read_las, write_laz

    rng = np.random.default_rng(5)
    n = 60000  # 2 chunks
    pts = rng.uniform(-60, 60, (n, 3))
    ts = np.sort(rng.uniform(0, 30, n))
    intens = rng.integers(0, 4096, n).astype(np.uint16)
    rn = rng.integers(1, 3, n).astype(np.uint8)
    nr = np.maximum(rn, rng.integers(1, 3, n).astype(np.uint8))
    path = str(tmp_path / "cloud.laz")
    write_laz(path, pts, timestamps=ts, intensities=intens,
              return_numbers=rn, number_of_returns=nr)
    out = read_las(path)
    assert np.allclose(out["points"], pts, atol=6e-4)  # 1mm quantisation
    assert np.array_equal(out["timestamps"], ts)
    assert np.array_equal(out["intensities"].astype(np.uint16), intens)
    assert np.array_equal(out["return_numbers"], rn)
    assert np.array_equal(out["number_of_returns"], nr)
    # compression actually happened
    import os
    assert os.path.getsize(path) < n * 28


def test_laz_smaller_than_las(tmp_path):
    from ohm_tpu_torch.io.las import write_las, write_laz
    import os

    rng = np.random.default_rng(9)
    pts = np.cumsum(rng.normal(0, 0.02, (20000, 3)), axis=0)
    ts = np.arange(20000) * 1e-4
    write_las(str(tmp_path / "a.las"), pts, timestamps=ts)
    write_laz(str(tmp_path / "a.laz"), pts, timestamps=ts)
    assert (os.path.getsize(tmp_path / "a.laz")
            < 0.6 * os.path.getsize(tmp_path / "a.las"))


def test_slam_loader_reads_laz(tmp_path):
    """slamio end-to-end from .laz (BASELINE config 2 ingestion path)."""
    from ohm_tpu_torch.io.las import write_laz
    from ohm_tpu_torch.io.slam import load_cloud

    rng = np.random.default_rng(13)
    pts = rng.uniform(-5, 5, (5000, 3))
    ts = np.sort(rng.uniform(0, 5, 5000))
    path = str(tmp_path / "scan.laz")
    write_laz(path, pts, timestamps=ts)
    cloud = load_cloud(path)
    assert np.allclose(cloud["points"], pts, atol=6e-4)
    assert np.array_equal(cloud["timestamps"], ts)


# ------------------------------------------------------------------------- #
# LAS 1.4 layered codecs (compressor 3, POINT14/RGB14/RGBNIR14/BYTE14 v3).


def _roundtrip_layered(rec, types, sizes, chunk=50000):
    stream, chunk_bytes = native.laz_compress(rec, types, sizes, chunk,
                                              layered=True)
    starts = np.concatenate([[0], np.cumsum(chunk_bytes)[:-1]]) if chunk_bytes else [0]
    out = native.laz_decompress(np.frombuffer(stream, np.uint8), types, sizes,
                                len(rec), chunk, starts, layered=True)
    return out, stream


def _fmt6_records(rng, n, channels=4):
    """Random-walk POINT14 records exercising all four scanner-channel
    contexts, every changed-values branch (rn/nr jumps, gps stasis and
    change, scan-angle / point-source deltas) and the per-context models."""
    rec = np.zeros((n, 30), np.uint8)
    xyz = np.cumsum(rng.integers(-2000, 2000, size=(n, 3)), axis=0).astype("<i4")
    rec[:, 0:12] = xyz.view(np.uint8).reshape(n, 12)
    rec[:, 12:14] = rng.integers(0, 65536, n).astype("<u2").view(np.uint8).reshape(n, 2)
    rn = rng.integers(1, 6, n)
    nr = np.maximum(rn, rng.integers(1, 8, n))
    rec[:, 14] = ((rn & 15) | ((nr & 15) << 4)).astype(np.uint8)
    ch = rng.integers(0, channels, n)
    flags = rng.integers(0, 16, n)  # classification flags nibble
    edge = rng.integers(0, 4, n)    # scan dir + edge bits
    rec[:, 15] = (flags | (ch << 4) | (edge << 6)).astype(np.uint8)
    rec[:, 16] = rng.integers(0, 40, n)    # classification
    rec[:, 17] = rng.integers(0, 8, n)     # user data
    sa = np.clip(np.cumsum(rng.integers(-30, 31, n)), -15000, 15000).astype("<i2")
    rec[:, 18:20] = sa.view(np.uint8).reshape(n, 2)
    ps = rng.integers(0, 4, n).astype("<u2")
    rec[:, 20:22] = ps.view(np.uint8).reshape(n, 2)
    # GPS time: mostly increasing, with stretches of repeats (gps-unchanged
    # branch) and occasional large jumps (sequence switches).
    dt = rng.random(n) * 1e-4
    dt[rng.random(n) < 0.3] = 0.0
    dt[rng.random(n) < 0.01] += 1e5
    t = np.cumsum(dt) + 3.0e5
    rec[:, 22:30] = t.astype("<f8").view(np.uint8).reshape(n, 8)
    return rec


def test_point14_layered_roundtrip_multichunk():
    rng = np.random.default_rng(21)
    rec = _fmt6_records(rng, 3500)
    out, stream = _roundtrip_layered(rec, [10], [30], chunk=1000)
    np.testing.assert_array_equal(out.reshape(rec.shape), rec)
    assert len(stream) < rec.size  # actually compressed


def test_point14_single_channel_roundtrip():
    rng = np.random.default_rng(22)
    rec = _fmt6_records(rng, 2000, channels=1)
    out, _ = _roundtrip_layered(rec, [10], [30])
    np.testing.assert_array_equal(out.reshape(rec.shape), rec)


def test_layered_rgbnir_and_bytes_roundtrip():
    """POINT14 + RGBNIR14 + BYTE14 item chain (fmt 8 + extra bytes)."""
    rng = np.random.default_rng(23)
    n = 1500
    p14 = _fmt6_records(rng, n)
    rgbnir = np.zeros((n, 8), np.uint8)
    rgb = (np.cumsum(rng.integers(-300, 300, (n, 3)), axis=0) % 65536).astype("<u2")
    nir = (np.cumsum(rng.integers(-100, 100, n)) % 65536).astype("<u2")
    rgbnir[:, 0:6] = rgb.view(np.uint8).reshape(n, 6)
    rgbnir[:, 6:8] = nir.view(np.uint8).reshape(n, 2)
    extra = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    rec = np.concatenate([p14, rgbnir, extra], axis=1)
    out, _ = _roundtrip_layered(rec, [10, 12, 14], [30, 8, 3], chunk=600)
    np.testing.assert_array_equal(out.reshape(rec.shape), rec)


def test_layered_rgb14_roundtrip():
    """POINT14 + RGB14 (fmt 7)."""
    rng = np.random.default_rng(24)
    n = 1200
    p14 = _fmt6_records(rng, n)
    rgb = np.zeros((n, 6), np.uint8)
    vals = (np.cumsum(rng.integers(-300, 300, (n, 3)), axis=0) % 65536).astype("<u2")
    rgb[:, :] = vals.view(np.uint8).reshape(n, 6)
    rec = np.concatenate([p14, rgb], axis=1)
    out, _ = _roundtrip_layered(rec, [10, 11], [30, 6])
    np.testing.assert_array_equal(out.reshape(rec.shape), rec)


def test_write_laz_fmt6_read_roundtrip(tmp_path):
    """Full LAS 1.4 fmt-6 layered .laz file through the generic read_las
    entry (VERDICT r3 Missing #1: layered LAZ read support)."""
    import os

    from ohm_tpu_torch.io.las import read_las, write_laz

    rng = np.random.default_rng(25)
    n = 60000  # 2 chunks
    pts = rng.uniform(-60, 60, (n, 3))
    ts = np.sort(rng.uniform(0, 30, n))
    intens = rng.integers(0, 4096, n).astype(np.uint16)
    rn = rng.integers(1, 4, n).astype(np.uint8)
    nr = np.maximum(rn, rng.integers(1, 4, n).astype(np.uint8))
    ch = rng.integers(0, 4, n).astype(np.uint8)
    path = str(tmp_path / "cloud14.laz")
    write_laz(path, pts, timestamps=ts, intensities=intens,
              return_numbers=rn, number_of_returns=nr, point_format=6,
              scanner_channels=ch)
    out = read_las(path)
    assert np.allclose(out["points"], pts, atol=6e-4)
    assert np.array_equal(out["timestamps"], ts)
    assert np.array_equal(out["intensities"].astype(np.uint16), intens)
    assert np.array_equal(out["return_numbers"], rn)
    assert np.array_equal(out["number_of_returns"], nr)
    assert os.path.getsize(path) < n * 30


def test_slam_loader_reads_fmt6_laz(tmp_path):
    from ohm_tpu_torch.io.las import write_laz
    from ohm_tpu_torch.io.slam import load_cloud

    rng = np.random.default_rng(26)
    pts = rng.uniform(-5, 5, (4000, 3))
    ts = np.sort(rng.uniform(0, 5, 4000))
    path = str(tmp_path / "scan14.laz")
    write_laz(path, pts, timestamps=ts, point_format=6)
    cloud = load_cloud(path)
    assert np.allclose(cloud["points"], pts, atol=6e-4)
    assert np.array_equal(cloud["timestamps"], ts)


# ------------------------------------------------------------------------- #
# Variable chunking (VLR chunk_size == 0xFFFFFFFF; per-chunk count/byte-size
# pair chunk table — the framing spatially-sorted / COPC-style writers emit).


def test_variable_chunk_table_codec_roundtrip():
    counts = [7, 50000, 13, 1000, 3]
    sizes = [911, 1 << 20, 64, 12345, 17]
    payload = native.laz_write_chunk_table_variable(counts, sizes)
    out_counts, out_sizes = native.laz_read_chunk_table_variable(
        np.frombuffer(payload, np.uint8), len(counts))
    assert out_counts.tolist() == counts
    assert out_sizes.tolist() == sizes


def test_pointwise_variable_chunks_roundtrip():
    rng = np.random.default_rng(31)
    rec = _fmt1_records(rng, 5000)
    counts = [7, 1200, 1, 2500, 1292]  # sums to 5000, wildly uneven
    stream, chunk_bytes = native.laz_compress(rec, [6, 7], [20, 8],
                                              0xFFFFFFFF, chunk_counts=counts)
    assert len(chunk_bytes) == len(counts)
    starts = np.concatenate([[0], np.cumsum(chunk_bytes)[:-1]])
    out = native.laz_decompress(np.frombuffer(stream, np.uint8), [6, 7],
                                [20, 8], len(rec), 0xFFFFFFFF, starts,
                                chunk_counts=counts)
    assert np.array_equal(out, rec)


def test_layered_variable_chunks_roundtrip():
    rng = np.random.default_rng(32)
    rec = _fmt6_records(rng, 4000)
    counts = [900, 3, 2100, 997]
    stream, chunk_bytes = native.laz_compress(rec, [10], [30], 0xFFFFFFFF,
                                              layered=True, chunk_counts=counts)
    assert len(chunk_bytes) == len(counts)
    starts = np.concatenate([[0], np.cumsum(chunk_bytes)[:-1]])
    out = native.laz_decompress(np.frombuffer(stream, np.uint8), [10], [30],
                                len(rec), 0xFFFFFFFF, starts, layered=True,
                                chunk_counts=counts)
    np.testing.assert_array_equal(out.reshape(rec.shape), rec)


def test_write_laz_variable_chunks_file_roundtrip(tmp_path):
    """Full .laz files with variable chunking through the generic read_las
    entry, both pointwise (fmt 1) and layered (fmt 6)."""
    from ohm_tpu_torch.io.las import read_las, write_laz

    rng = np.random.default_rng(33)
    n = 3000
    pts = rng.uniform(-40, 40, (n, 3))
    ts = np.sort(rng.uniform(0, 60, n))
    for fmt in (1, 6):
        path = str(tmp_path / f"var{fmt}.laz")
        write_laz(path, pts, timestamps=ts, point_format=fmt,
                  chunk_counts=[100, 1500, 7, 1393])
        out = read_las(path)
        assert np.allclose(out["points"], pts, atol=6e-4)
        assert np.array_equal(out["timestamps"], ts)


def test_write_laz_variable_chunks_short_last(tmp_path):
    """Chunk counts overshooting the point total: the last chunk is short."""
    from ohm_tpu_torch.io.las import read_las, write_laz

    rng = np.random.default_rng(34)
    n = 777
    pts = rng.uniform(-4, 4, (n, 3))
    path = str(tmp_path / "short.laz")
    write_laz(path, pts, point_format=6, chunk_counts=[500, 500])
    out = read_las(path)
    assert np.allclose(out["points"], pts, atol=6e-4)


def test_laz_golden_byte_streams():
    """Pin the arithmetic coder's exact output bytes (pointwise v2 AND
    layered v3) against committed golden streams, and decode them back.

    Cross-implementation .laz bit-compatibility cannot be verified in this
    offline environment (no third-party laszip; round-4 VERDICT missing #4);
    this pin at least freezes the coder: any drift in the FastAC model
    updates, chunk framing, or item codecs shows up as a byte diff here
    rather than silently changing every stream we write."""
    import hashlib

    from ohm_tpu_torch.io.las import read_las, write_laz

    rng = np.random.default_rng(424242)
    n = 3000
    pts = np.round(rng.uniform(-40, 40, (n, 3)), 3)
    ts = np.sort(np.round(rng.uniform(0, 10, n), 6))
    intens = rng.integers(0, 4096, n).astype(np.uint16)
    rn = rng.integers(1, 3, n).astype(np.uint8)
    nr = np.maximum(rn, rng.integers(1, 3, n).astype(np.uint8))

    goldens = {
        "golden_pointwise_v2.laz": (
            {}, "555295f40f7cc99d9b4b96e81774147a54119a30ec414533cba09c810272ec64"),
        "golden_layered_v3.laz": (
            {"point_format": 6},
            "714943f8ae5e51204419ae585c7cd33bb9fbf031b2e339634745527ed8cb7328"),
    }
    data_dir = os.path.join(os.path.dirname(__file__), "data")
    for name, (kw, sha) in goldens.items():
        golden_path = os.path.join(data_dir, name)
        with open(golden_path, "rb") as f:
            golden = f.read()
        assert hashlib.sha256(golden).hexdigest() == sha, (
            f"{name}: committed golden bytes changed")
        # Re-encode: byte-identical to the committed stream.
        import tempfile
        with tempfile.TemporaryDirectory() as d:
            p = os.path.join(d, name)
            write_laz(p, pts, timestamps=ts, intensities=intens,
                      return_numbers=rn, number_of_returns=nr,
                      chunk_size=1024, **kw)
            with open(p, "rb") as f:
                fresh = f.read()
        assert fresh == golden, f"{name}: coder byte stream drifted"
        # And the committed stream decodes to the pinned content.
        out = read_las(golden_path)
        assert np.allclose(out["points"], pts, atol=6e-4)
        assert np.array_equal(out["timestamps"], ts)
        assert np.array_equal(out["intensities"].astype(np.uint16), intens)


# ------------------------------------------------------------------------- #
# tests/test_pcd.py

def _cloud(n=257, seed=3):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.normal(size=n).astype(np.float32),
        "y": rng.normal(size=n).astype(np.float32),
        "z": rng.normal(size=n).astype(np.float32),
        "intensity": rng.uniform(0, 255, n).astype(np.float32),
        "time": (1_000_000 + np.arange(n) * 1e-4).astype(np.float64),
    }


@pytest.mark.parametrize("mode", ["ascii", "binary", "binary_compressed"])
def test_pcd_round_trip(tmp_path, mode):
    fields = _cloud()
    path = str(tmp_path / f"rt_{mode}.pcd")
    write_pcd(path, fields, mode=mode)
    out = read_pcd(path)
    pts = np.column_stack([fields["x"], fields["y"], fields["z"]])
    np.testing.assert_allclose(out["points"], pts, rtol=0, atol=0)
    np.testing.assert_array_equal(out["intensities"], fields["intensity"])
    np.testing.assert_array_equal(out["timestamps"], fields["time"])


def test_pcd_nan_points_filtered(tmp_path):
    fields = _cloud(16)
    fields["x"][3] = np.nan  # PCL marks invalid points with NaN coords
    path = str(tmp_path / "nan.pcd")
    write_pcd(path, fields, mode="binary")
    out = read_pcd(path)
    assert out["points"].shape == (15, 3)
    assert np.isfinite(out["points"]).all()
    assert out["intensities"].shape == (15,)


def test_lzf_round_trip_random_and_repetitive():
    rng = np.random.default_rng(11)
    for data in (
        rng.integers(0, 256, 10000, dtype=np.uint8).tobytes(),  # incompressible
        b"abcabcabcabc" * 500,                                    # short cycle (overlap copies)
        np.zeros(4096, np.uint8).tobytes(),                       # constant
        rng.integers(0, 4, 5000, dtype=np.uint8).tobytes(),       # low entropy
        b"",                                                      # empty
        b"xy",                                                    # below match length
    ):
        comp = lzf_compress(data)
        assert lzf_decompress(comp, len(data)) == data
    # compressible data actually compresses
    assert len(lzf_compress(np.zeros(4096, np.uint8).tobytes())) < 200


def test_lzf_long_offset_and_length():
    # Exercise offsets > 255 (high offset bits) and max-length matches.
    block = bytes(range(256)) * 2
    data = block + b"\x00" * 300 + block
    comp = lzf_compress(data)
    assert lzf_decompress(comp, len(data)) == data


def test_slamio_reads_pcd(tmp_path):
    fields = _cloud(64)
    path = str(tmp_path / "cloud.pcd")
    write_pcd(path, fields, mode="binary_compressed")
    out = load_cloud(path)
    assert out["points"].shape == (64, 3)
    assert "timestamps" in out and "intensities" in out
    assert "fields" not in out  # registry normalises the dict


def test_pcd_binary_compressed_count_field_interleaved(tmp_path):
    """PCL's binary_compressed SoA stores a COUNT>1 field's values
    interleaved per point within that field's chunk — regression for the
    reader treating each sub-field as its own contiguous column."""
    n = 5
    x = np.arange(n, dtype=np.float32)
    y = x + 10
    z = x + 20
    mom = np.arange(n * 3, dtype=np.float32).reshape(n, 3)  # [p, c] layout
    raw = b"".join([mom.tobytes(),  # COUNT=3 field FIRST (stresses offsets)
                    x.tobytes(), y.tobytes(), z.tobytes()])
    comp = lzf_compress(raw)
    path = str(tmp_path / "count.pcd")
    with open(path, "wb") as f:
        f.write((
            "VERSION 0.7\nFIELDS moment x y z\nSIZE 4 4 4 4\nTYPE F F F F\n"
            f"COUNT 3 1 1 1\nWIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
            f"POINTS {n}\nDATA binary_compressed\n").encode())
        f.write(np.asarray([len(comp), len(raw)], "<u4").tobytes())
        f.write(comp)
    out = read_pcd(path)
    np.testing.assert_array_equal(out["points"],
                                  np.column_stack([x, y, z]).astype(np.float64))
    for c in range(3):
        np.testing.assert_array_equal(out["fields"][f"moment_{c}"], mom[:, c])


def test_pcd_with_normals_and_padding(tmp_path):
    # Hand-written header with a COUNT>1 field and '_' padding, ascii mode.
    path = str(tmp_path / "hand.pcd")
    with open(path, "w") as f:
        f.write(
            "VERSION 0.7\n"
            "FIELDS x y z normal_x normal_y normal_z _\n"
            "SIZE 4 4 4 4 4 4 1\n"
            "TYPE F F F F F F U\n"
            "COUNT 1 1 1 1 1 1 1\n"
            "WIDTH 2\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS 2\n"
            "DATA ascii\n"
            "0.5 1.5 2.5 0 0 1 0\n"
            "1.0 2.0 3.0 0 1 0 0\n")
    out = read_pcd(path)
    np.testing.assert_allclose(out["points"], [[0.5, 1.5, 2.5], [1.0, 2.0, 3.0]])
    np.testing.assert_allclose(out["normals"], [[0, 0, 1], [0, 1, 0]])


# ------------------------------------------------------------------------- #
# tests/test_serialise.py

#: The reference checkout's tests/data (its old-format maps), named by
#: OHM_REFERENCE_DATA; without it the reference-map cases skip, as the
#: reference's own do where its checkout is missing.
REFERENCE_DATA = os.environ.get("OHM_REFERENCE_DATA", "")


def build_test_map(flags=MapFlag.VOXEL_MEAN | MapFlag.TRAVERSAL):
    m = OccupancyMap(resolution=0.25, flags=flags, origin=(0.1, -0.2, 0.3))
    rng = np.random.default_rng(99)
    n = 60
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    rays = np.empty((2 * n, 3))
    rays[0::2] = 0.0
    rays[1::2] = dirs * rng.uniform(1.0, 8.0, (n, 1))
    RayMapperOccupancy(m).integrate_rays(rays, timestamps=np.linspace(10.0, 11.0, n))
    m.info["creator"] = "ohm_tpu test"
    m.info["rays"] = n
    m.info["real"] = 0.5
    m.info["flag"] = True
    return m


def maps_equal(a, b):
    assert a.resolution == b.resolution
    assert np.array_equal(a.region_voxel_dims, b.region_voxel_dims)
    np.testing.assert_allclose(a.origin, b.origin)
    assert np.float32(a.hit_value) == np.float32(b.hit_value)
    assert np.float32(a.miss_value) == np.float32(b.miss_value)
    assert a.stamp == b.stamp
    assert a.first_ray_time == b.first_ray_time
    assert len(a.chunks) == len(b.chunks)
    assert len(a.layout) == len(b.layout)
    for la, lb in zip(a.layout, b.layout):
        assert la.name == lb.name
        assert la.voxel_layout.equals(lb.voxel_layout)
    for key, ca in a.chunks.items():
        cb = b.chunks.get(key)
        assert cb is not None, f"missing chunk {key}"
        np.testing.assert_allclose(ca.centre, cb.centre)
        for i in range(len(a.layout)):
            assert ca.layers[i].tobytes() == cb.layers[i].tobytes(), (
                f"layer {a.layout.layers[i].name} bytes differ in chunk {key}"
            )


def test_round_trip(tmp_path):
    m = build_test_map()
    path = str(tmp_path / "map.ohm")
    save(path, m)
    loaded, version = load(path)
    assert version == (0, 5, 0)
    maps_equal(m, loaded)
    # MapInfo round trip (values come back as typed MapValue).
    assert loaded.info["creator"].value == "ohm_tpu test"
    assert loaded.info["rays"].value == 60
    assert loaded.info["flag"].value is True


def test_round_trip_byte_stable(tmp_path):
    # Saving the same map twice must produce identical bytes; saving a loaded
    # map must reproduce the original file (full codec fidelity).
    m = build_test_map()
    p1 = str(tmp_path / "a.ohm")
    p2 = str(tmp_path / "b.ohm")
    save(p1, m)
    loaded, _ = load(p1)
    save(p2, loaded)
    with open(p1, "rb") as f1, open(p2, "rb") as f2:
        assert f1.read() == f2.read()


def test_load_header_only(tmp_path):
    m = build_test_map()
    path = str(tmp_path / "map.ohm")
    save(path, m)
    header, version, layout, info = load_header(path)
    assert header["region_count"] == len(m.chunks)
    assert header["resolution"] == m.resolution
    assert [l.name for l in layout] == [l.name for l in m.layout]


@pytest.mark.skipif(not os.path.isdir(REFERENCE_DATA), reason="reference checkout unavailable")
@pytest.mark.parametrize("name,version", [
    ("test-map.0.ohm", (0, 0, 0)),
    ("test-map.0.1.0.ohm", (0, 1, 0)),
    ("test-map.0.2.0.ohm", (0, 2, 0)),
    ("test-map.0.4.0.ohm", (0, 4, 0)),
])
def test_load_reference_maps(name, version):
    """Upgrade-load maps written by the reference C++ implementation."""
    m, v = load(os.path.join(REFERENCE_DATA, name))
    assert v == version
    assert len(m.chunks) > 0
    occ_idx = m.layer_index(OCCUPANCY_LAYER)
    assert occ_idx >= 0
    # The reference test map is a small populated scene: it must contain
    # both occupied and free voxels.
    occupied = free = 0
    for chunk in m:
        occ = chunk.layers[occ_idx][OCCUPANCY_LAYER]
        finite = occ[np.isfinite(occ)]
        occupied += int((finite >= m.occupancy_threshold_value).sum())
        free += int((finite < m.occupancy_threshold_value).sum())
    assert occupied > 0
    assert free > 0


@pytest.mark.skipif(not os.path.isdir(REFERENCE_DATA), reason="reference checkout unavailable")
def test_load_header_v0_synthesises_layout():
    # v0 files carry no layout section; load_header must synthesise the
    # occupancy+clearance default rather than misreading chunk bytes
    # (reference: ohm/MapSerialise.cpp:744-752).
    header, version, layout, info = load_header(os.path.join(REFERENCE_DATA, "test-map.0.ohm"))
    assert version == (0, 0, 0)
    assert header["region_count"] > 0
    assert [l.name for l in layout] == ["occupancy", "clearance"]


@pytest.mark.skipif(not os.path.isdir(REFERENCE_DATA), reason="reference checkout unavailable")
def test_reference_map_round_trip_via_v05():
    """Load a reference-written map and re-save in v0.5; reload must match."""
    m, _ = load(os.path.join(REFERENCE_DATA, "test-map.0.4.0.ohm"))
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "resaved.ohm")
        save(path, m)
        again, v = load(path)
        assert v == (0, 5, 0)
        maps_equal(m, again)


@pytest.mark.skipif(not os.path.isdir(REFERENCE_DATA), reason="reference checkout unavailable")
def test_deprecated_v03_rejected():
    with pytest.raises(SerialisationError):
        load(os.path.join(REFERENCE_DATA, "test-map.0.3.0.ohm"))


# ------------------------------------------------------------------------- #
# Across the two packages


def _filled_map(pkg: str, mode: str):
    """One map, built the same way with ``pkg``'s host classes and f64
    oracle: tests/test_serialise.py's map (occupancy, voxel mean, traversal
    and touch time), or an NDT-TM map (occupancy, mean, covariance,
    intensity, hit/miss counts) with the same info."""
    import importlib

    core_map = importlib.import_module(f"{pkg}.core.map")
    m = core_map.OccupancyMap(resolution=0.25, origin=(0.1, -0.2, 0.3),
                              flags=core_map.MapFlag.VOXEL_MEAN | core_map.MapFlag.TRAVERSAL)
    rng = np.random.default_rng(99)
    n = 60
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    rays = np.empty((2 * n, 3))
    rays[0::2] = 0.0
    rays[1::2] = dirs * rng.uniform(1.0, 8.0, (n, 1))
    if mode == "occupancy":
        mapper = importlib.import_module(f"{pkg}.oracle.occupancy").RayMapperOccupancy(m)
        mapper.integrate_rays(rays, timestamps=np.linspace(10.0, 11.0, n))
    else:
        ndt = importlib.import_module(f"{pkg}.oracle.ndt")
        mapper = ndt.RayMapperNdt(m, ndt.NdtParams(ndt_tm=True))
        for _ in range(3):
            mapper.integrate_rays(rays, intensities=rng.uniform(0.0, 1.0, n))
    m.info["creator"] = "ohm_tpu test"
    m.info["rays"] = n
    m.info["real"] = 0.5
    m.info["flag"] = True
    return m


def _chunk_bytes(m) -> dict:
    """(region, layer, member) -> (dtype, bytes) of every chunk of a map."""
    return {(k, layer.name, name): (str(c.layers[i].dtype[name]),
                                    np.ascontiguousarray(c.layers[i][name]).tobytes())
            for k, c in m.chunks.items() for i, layer in enumerate(m.layout)
            for name in c.layers[i].dtype.names}


def _assert_same_loaded(a, b):
    assert a.resolution == b.resolution
    assert np.array_equal(a.region_voxel_dims, b.region_voxel_dims)
    assert np.array_equal(a.origin, b.origin)
    assert [layer.name for layer in a.layout] == [layer.name for layer in b.layout]
    assert {k: v.value for k, v in a.info.items()} == {k: v.value for k, v in b.info.items()}
    ca, cb = _chunk_bytes(a), _chunk_bytes(b)
    assert ca.keys() == cb.keys() and len(ca) > 0
    for key in ca:
        assert ca[key] == cb[key], key


@pytest.mark.parametrize("mode", ["occupancy", "ndt_tm"])
def test_ohm_files_cross_between_the_packages(tmp_path, mode):
    """A .ohm written by the port loads in the JAX package with equal chunks
    and the reverse; the same content saves to the same bytes in both, and
    a file loaded by one package and saved again by the other keeps its
    bytes."""
    import ohm_tpu.io as ref_io

    port_path, ref_path = str(tmp_path / "port.ohm"), str(tmp_path / "ref.ohm")
    save(port_path, _filled_map("ohm_tpu_torch", mode))
    ref_io.save(ref_path, _filled_map("ohm_tpu", mode))
    with open(port_path, "rb") as f, open(ref_path, "rb") as g:
        port_bytes, ref_bytes = f.read(), g.read()
    assert port_bytes == ref_bytes

    port_in_ref, v = ref_io.load(port_path)
    ref_in_port, w = load(ref_path)
    assert v == w == (0, 5, 0)
    _assert_same_loaded(port_in_ref, load(port_path)[0])
    _assert_same_loaded(ref_in_port, ref_io.load(ref_path)[0])
    for m, save_fn, name in ((port_in_ref, ref_io.save, "port_via_ref.ohm"),
                             (ref_in_port, save, "ref_via_port.ohm")):
        path = str(tmp_path / name)
        save_fn(path, m)
        with open(path, "rb") as f:
            assert f.read() == ref_bytes, name


def test_transform_samples_device_matches_the_jax_package():
    """The port's transform_samples_device (PyTorch, on the CPU) within 1e-5
    of the JAX package's (jitted, f32) and within 5e-4 of the f64 host
    transform, on tests/test_apps.py's rotating, translating trajectory,
    with and without rotation."""
    import torch

    from ohm_tpu.io.slam import transform_samples_device as ref_transform
    from ohm_tpu_torch.io.slam import transform_samples, transform_samples_device

    rng = np.random.default_rng(31)
    n = 500
    tt = np.linspace(0.0, 5.0, 20)
    tp = np.column_stack([tt * 0.5, np.sin(tt), np.zeros_like(tt)])
    ang = tt * 0.3
    tq = np.column_stack([np.zeros_like(tt), np.zeros_like(tt),
                          np.sin(ang / 2), np.cos(ang / 2)])
    # Sample times on trajectory stamps too: searchsorted's side matters there.
    st = np.concatenate([rng.uniform(0.05, 4.95, n - 4), tt[[1, 7, 12, 19]]])
    local = rng.uniform(-2, 2, (n, 3))
    for quat in (tq, None):
        port = transform_samples_device(st, local, tt, tp, quat, device="cpu")
        assert port.dtype == torch.float32 and port.device.type == "cpu"
        assert port.shape == (2 * n, 3)
        ref = np.asarray(ref_transform(st, local, tt, tp, quat))
        np.testing.assert_allclose(port.numpy(), ref, atol=1e-5, rtol=0)
        np.testing.assert_allclose(port.numpy(), transform_samples(st, local, tt, tp, quat),
                                   atol=5e-4)


def test_transform_samples_device_on_cuda_raises_without_a_device(monkeypatch):
    import torch

    from ohm_tpu_torch.io.slam import transform_samples_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        transform_samples_device([0.5], [[0.0, 1.0, 0.0]], [0.0, 1.0],
                                 [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])


def test_failed_laszip_build_raises_with_the_compiler_errors(tmp_path, monkeypatch):
    """No cached failure and no None: a codec that does not compile raises
    with g++'s errors, on every call."""
    src = tmp_path / "laszip.cpp"
    src.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "_LAZ_SRC", str(src))
    monkeypatch.setattr(native, "_LAZ_LIB", str(tmp_path / "_build" / "libohmlaz.so"))
    monkeypatch.setattr(native, "_laz_lib", None)
    for _ in range(2):
        with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed.*error"):
            native.get_laz_lib()
    assert native._laz_lib is None
    assert not os.path.exists(native._LAZ_LIB)
