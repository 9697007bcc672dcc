#!/usr/bin/env python3
"""Drive the ohm_tpu_torch occupancy (with and without its side layers), NDT
(with and without its side layers) and TSDF paths, on the rayflow and the
segmented wire, sharded over four shards, the queries, the deposit probe,
and ohmpop and the other CLIs from a .laz once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA device
    python3 chip_smoke.py --wrappers-of DIR   # only the wrapper_cost line, of
                                              # the port in the checkout at DIR

Phases, in order; each prints one JSON line, and any failure raises, so the
exit code is not 0 and no result line is printed:

  device       nvidia-smi's name and power limit, torch's device name
  build        nvcc builds ohm_tpu_torch/csrc/*.cu for sm_90a (seconds, ptxas), and
               g++ the LASzip codec (beside nvcc) and the native rayflow host
               pass (ohm_tpu_torch/native)
  k1_expand    the expand kernel against its plain PyTorch version on wires
               of the box, corner and miss scenes and on edge rays (starts
               on voxel walls, zero lengths, denormal direction components
               (which read as zero, as under XLA),
               invalid rays, more than S crossings): keys, missed counts,
               overflow flags and end enter times bit-identical (tolerance
               0), on the card and against the plain version on the CPU;
               the ATen ops its wrapper issues (its outputs' allocations
               only), and which operand ATen's CUDA maximum and clamp
               return for signed zeros and NaN
  k2_deposit   the deposit-and-sweep kernel against its plain version at the
               bench shape (512 slots x 32768 voxels, ~1.1M sorted keys) under
               each exclude flag, and on ohm_tpu_torch.testing's edge
               streams (a run past the 65535 cap, runs across 256- and
               1024-record blocks, empty, all-sentinel, negative keys):
               occupancy bits and touched count identical, and identical
               between two runs
  hardware_differential
               TorchRayMapper on the card, 1024-ray box scan, against the
               f64 oracle under bench.py's gate, and bit-identical to the
               same mapper on the CPU
  occupancy_integrate_rays_per_sec
               bench.py's configuration (box scene, seed 2024, 8192-ray
               batches, a 512-slot arena) timed by bench.py's loop
               (ohm_tpu_torch.bench's timed_integration: the caps primed,
               4 synchronous warm-ups, a pass through the worker, then the
               timed pass through it; 40 batches), the kernels' launches
               counted over it; beside it (sync_rays_per_sec) the same
               batches through synchronous integrate_rays; then host prep,
               device time per batch and per stage,
               each kernel beside its plain version, and (the "profile"
               line) torch.profiler's device time by kernel and the
               device's idle share over 8 batches
  k1_trav      the expand kernel's traversal output (the traversal layer's
               with_trav), alone and beside the voxel planes, against its
               plain version on the box, corner and miss scenes: keys,
               traversal and missed counts bit-identical on every lane
  layers_hardware_differential
               TorchRayMapper with the voxel-mean, traversal, touch-time and
               incident-normal layers on a 1024-ray box scan given twice in
               four timestamped batches: against the f64 oracle (occupancy
               under bench.py's gate; mean counts equal, mean positions
               within 2e-3, traversal within atol 2e-3 / rtol 1e-3 as
               tests/test_tpu_integrate.py; touch times within 0.002 s;
               incident reported as the worst angle), against the port on
               the CPU (occupancy, counts and touch times bit-identical,
               traversal within atol = rtol = 1e-5, mean and normal codes
               identical on >= 99.9% of written voxels and within one
               quantum elsewhere), and bit-identical between two card runs
  occupancy_layers_rays_per_sec
               bench.py's configuration with all four side layers and
               per-ray timestamps (a 512-slot arena of 24 bytes a voxel),
               40 timed synchronous batches after 4 warm-up; host prep,
               device time per batch and per stage, host syncs per batch,
               launches, a profile line and the peak allocation; before it
               (the "layers_kernel_checks" line) K1 with traversal and K2 on
               the arguments this path gave them in one batch, each against
               its plain version bit for bit
  occupancy_mean_outdoor_rays_per_sec
               scripts/bench_modes.py config 2: occupancy + voxel mean at
               0.2 m, a 1024-slot arena, 12 outdoor 8192-ray batches (rng
               seed 7) written to a .laz and read back through
               SlamCloudLoader, timed by timed_integration (6 warm-up),
               sync_rays_per_sec beside it; host prep, device time, host
               syncs, launches, a profile line; the "outdoor_mean_kernel_checks"
               line holds K1 and K2 to their plain versions on a batch the
               worker thread dispatched
  k1_vox       the expand kernel's voxel planes (the NDT path's with_vox)
               against the plain walk's voxels on the box, corner and miss
               scenes, on every lane whose key is not the sentinel, bit for
               bit
  k3_ndt_deposit
               the NDT deposit-and-sweep kernel against its plain version at
               the NDT-OM shape (1024 slots x 32768 voxels, ~1.1M walk keys
               with their bounds or sorted by the wrapper, 8192 end keys),
               with the miss delta as a sparse stream and as a dense plane,
               over an arena mixing +inf, free, occupied and saturated
               voxels, and on the edge streams (K2's, end-only and
               delta-only voxels, +-0.0 deltas, a delta behind zero-valued
               records): occupancy bits and touched count identical, and
               identical between two runs
  k4_gather    the plane-gather kernel against its plain version on a
               sorted stream of ~1.5M ids with sentinel padding, in whole
               16-byte vectors and with a scalar tail: identical; ids off a
               16-byte boundary refused; its time alone
  wrapper_cost the K1 wrapper (keys, traversal, voxel planes), K2, K3, K4
               beside index_select, the flag plane's build + K4 and the fused
               flag gather, and the deposit probe's slot-grid deposit and five
               probes, each on fixed inputs (bench.py's first box batch;
               an NDT-OM arena with 600,000 sorted ids; K2's and K3's
               synthetic streams; the probe's stream and inputs): host us a
               call over calls without a
               synchronize, CUDA-event ms a call, the kernel alone, the device
               time and operations of the whole call (torch.profiler) and the
               device memory a call allocates.  --wrappers-of DIR prints only
               this line, for the port of another checkout on the same inputs
  k4_ndt_flags the fused NDT flag gather (K4 reading occupancy and
               mean_count) against its plain version (the arena-wide flag
               plane, then K4's plain gather) at the NDT-OM arena, with +inf,
               NaN and counts at or above 2^31, thresholds 3, 1, 0: identical
  ndt_hardware_differential
               TorchNdtMap on the card, NDT-OM and NDT-TM (with intensities),
               on tests/test_ndt.py's plane-then-through scene, against the
               f64 oracle under that test's tolerances, against the port on
               the CPU (atol = rtol = 1e-5, counts equal, mean codes equal on
               >= 99.9% of active voxels and within one quantum elsewhere),
               and bit-identical between two card runs
  ndt_om_rays_per_sec
               scripts/bench_modes.py config 3 on the port: box scene, 0.2 m
               voxels, 1024-slot arena, 12 8192-ray batches timed by
               timed_integration (6 warm-up), sync_rays_per_sec beside it;
               host prep, device time, each kernel beside its plain
               version, the launch counts, and a profile line; before it
               (the "ndt_om_kernel_checks" line) K1 with voxel planes, the
               fused flag gather (and K4 on the flag plane) and K3 on the
               arguments this path gave them in one batch, each against its
               plain version bit for bit; then (the "ndt_flag_gather" line)
               the flag plane's build + K4, the build + index_select and the
               fused kernel on those arguments in alternated turns, each
               one's device time alone, and K4 against index_select; K4's
               launches on the path are counted and must be 0
  ndt_tm_integrate_rays_per_sec
               the integrate part of config 5: one 1,048,576-ray box frame
               (half extents 15, 15, 7), intensities uniform in [0, 1) and
               timestamps, miss_k 32768, 8192-ray batches through the worker
               after 6 warm-up batches (bench_modes' integrate_frame); beside
               it the frame through synchronous integrate_rays on a fresh
               map (sync_rays_per_sec); then K3 on the arguments one more
               batch gave it (the sparse delta), against its plain version
               and timed
  ndt_layers_hardware_differential
               TorchNdtMap with the traversal, touch-time and incident-normal
               layers on ndt_hardware_differential's scene with a timestamp
               per ray, NDT-OM and NDT-TM, on the rayflow and the segmented
               wire: against the f64 oracle (that phase's tolerances;
               traversal within rtol 1e-3 / atol 2e-3, touch times within
               2 ms, the incident normal's worst angle reported), against
               the port on the CPU (each batch's K3 walk and bounds keys,
               counts, touch times and stats equal; occupancy, covariance,
               intensity and traversal within PORT_TOL, with the share of
               identical occupancy bits reported; mean and normal codes
               identical on >= 99.9%), and bit-identical between two card
               runs
  ndt_layers_rays_per_sec
               ndt_om_rays_per_sec's configuration (0.2 m, 1024 slots,
               8192-ray box batches) with traversal, touch time and incident
               normal and a timestamp per ray, 12 timed after 6 warm-up,
               fenced; host prep, device time, host syncs, launches, a
               profile line and the peak allocation; before it (the
               "ndt_layers_kernel_checks" line) K1 with voxel planes and
               traversal in one call, the fused flag gather and K3 on the
               arguments this path gave them, each against its plain
               version bit for bit, then each call beside its plain version,
               each kernel alone and each one's bound
  apply_routes the apply routes of the reference's mapper (TorchRayMapper's
               routing, tpu_map.py:570-624) on the box (with the traversal
               layer) and on config 2's outdoor .laz batches, 8 x 8192 rays
               each, four of them sizing the windows: the split apply
               (OHM_FUSED=0), the fused row-local apply (OHM_FUSED=2, twice),
               the delta path (delta_path=True) and the worker (its thread
               with coalesced uploads, then one group of four as a chain)
               under the split and the fused apply; occupancy and mean bits
               against the split run's, traversal within
               testing.fused_traversal_atol (the blocked sums' rounding
               bound: 4.6e-4 at 0.1 m, 9.3e-4 at 0.2 m), the second fused
               run bit for bit; K1 on the fused, delta and chained routes
               against its plain version; each route's host prep, device ms,
               device operations, host syncs and K1/K2 launches a batch (K2
               on the split routes only); NDT-OM with traversal, the fused
               deposit against K3 on 6 box batches; and the route the
               default mapper took on the box, outdoor, side-layer and NDT
               side-layer paths above, batch by batch
  queries      scripts/bench_modes.py's query rows: RaysQuery with 512
               outdoor rays on the outdoor mean map (13 executes, the first
               dropped: rays_query_p50_ms; 16 re-dispatches on a resident
               upload: device_ms_per_query; the device operations of one),
               and LineKeysQuery on the same rays; ClearanceProcess (search
               radius 1.0) on the NDT-TM frame's map, cold, then warm
               (clearance_sec), then after a 16,384-ray delta in one corner
               (clearance_incremental_sec, the dirty regions only); the
               card against the port on the CPU: terminal states, voxels,
               line keys and clearance bit for bit, ranges and volumes
               within rtol 1e-5
  ndt_tm_pipeline_frame_sec
               scripts/bench_modes.py config 5's row: the NDT-TM frame's
               integrate seconds through the worker
               (ndt_tm_integrate_rays_per_sec) + its warm clearance
               (queries) + the layered heightmap (LAYERED_FILL, min
               clearance 0.5) of its map, each printed, and the
               synchronous frame's seconds (sync_integrate_sec)
  k5_gather_f32
               the f32 seed-gather kernel against its plain version on a
               sorted stream of ~1.2M ids with sentinel padding over two
               TSDF-shape planes (1024 slots x 32768 voxels) holding -0.0,
               +-inf, NaN payloads and denormals: bit for bit
  k6_tsdf_deposit
               the TSDF pair-deposit kernel against its plain version on an
               arena of 1024 x 32768 voxels, one depositing record per voxel
               with negative, -0.0, infinite and NaN distances: both planes
               bit for bit
  tsdf_visits  the fused TSDF per-visit kernel (K5+K6 with the blocked scans
               between them) against its plain version on
               ohm_tpu_torch.testing's edge streams (stored pairs holding
               -0.0, +-inf, NaN payloads and denormals, runs across one or
               several 1024-record rows, max_weight saturation in a run,
               near-zero visits, non-uniform weights, a short stream, an
               all-sentinel one) and at full size (~1.2M sorted ids over a
               1024-slot arena, uniform and non-uniform weights): both
               planes bit for bit, and the same bits on a second run
  tsdf_hardware_differential
               TorchTsdfMap on the card on tests/test_tsdf.py's sphere scene,
               against the port's f64 oracle at that test's tolerance
               (compare_tsdf, distances within 5e-3), against the port on the
               CPU (weights equal, distances within atol = rtol = 1e-5), and
               bit-identical between two card runs
  tsdf_rays_per_sec
               scripts/bench_modes.py config 4 on the port: box scene, 0.1 m
               voxels, a 1024-slot arena of occupancy and the two TSDF planes,
               default TsdfOptions, 12 8192-ray batches timed by
               timed_integration (6 warm-up), sync_rays_per_sec beside it;
               host prep, device time, each kernel beside its plain version,
               the launch counts, a profile line and the peak allocation;
               after it (the "tsdf_kernel_checks" line) K1 with voxel planes
               and the fused per-visit kernel on the arguments this path
               gave them in one batch, and K5 and K6 on arguments derived
               from the fused call's (K5 on its ids and planes, K6 on the
               plain chain's deposits), each against its plain version bit
               for bit; the fused kernel against the chain the path ran
               before it (K5, the scans, K6) and K5 against two
               index_selects and K6 against two index_put_s in six
               alternated turns (medians and turns won); the fused kernel's
               launches on the path must be > 0, K5's and K6's 0
  segmented_hardware_differential
               the segmented wire (``rayflow=False``) on the card: a 1024-ray
               box scan against the f64 oracle under bench.py's gate and bit
               for bit against the port on the CPU; then a clearing batch
               under ClearingPattern.DEFAULT_RAY_FLAGS (the
               STOP_ON_FIRST_OCCUPIED monolith; rays past the walls, half
               along the scan's) against the oracle under the same gate, bit
               for bit against the CPU, and with its ends past the walls left
               unobserved; NDT-OM, NDT-TM and TSDF on the existing phases'
               scenes against the CPU at PORT_TOL; each twice on the card,
               bit for bit; K2, K3, the fused flag gather and the fused
               per-visit kernel launched there, K1 never
  segmented_rays_per_sec
               bench.py's configuration on the segmented wire (box scene,
               seed 2024, 0.1 m, 512 slots, 8192-ray batches, 40 timed after
               4 warm-up): host prep, device time per batch and per stage
               (the walk alone, expand, sort, deposit), launches, host syncs,
               a profile line; before it (the "segmented_kernel_checks" line)
               K2 on the arguments this path gave it against its plain
               version bit for bit, with its launches > 0 and K1's 0
  clearing_rays_per_sec
               the monolith at full width: on that box map, 8192-ray
               clearing batches (ClearingPattern.DEFAULT_RAY_FLAGS, rays out
               to 1.1 times the walls' distance), 12 timed after 4 warm-up;
               the ordered walk's and the whole monolith's device time per
               batch, and the "clearing_kernel_checks" line (K2 on the
               monolith's arguments)
  wide_outdoor an outdoor survey past the rayflow wire's envelope
               (outdoor_rays with extent 120 m at 0.1 m: rays over 32
               regions, a bbox over 63), seed 7, occupancy + voxel mean, a
               32767-slot arena (past the rayflow wire's 8191, the largest
               the int32 sort key addresses; it holds the survey's ~24,500
               regions; the upload is the full int32 blocks), 12 batches of
               8192 rays through
               integrate_rays_async + flush: rays/s, arena stats, peak
               allocation, a profile line; the card against the port on the
               CPU on the first two batches, the arena (and any chunk paged
               out) bit for bit
  segmented_ndt_tsdf
               NDT-OM (0.2 m, 1024 slots) and TSDF (0.1 m, 1024 slots) on the
               segmented wire, box batches: rays/s, launches (K1's 0), and
               the fused flag gather, K3 and the fused per-visit kernel on
               the arguments each path gave them, against their plain
               versions bit for bit and timed beside them
  sharded      ohm_tpu_torch.parallel on four shards (one a card where there
               are four cards, else four on the one card): bench.py's box
               (seed 2024, 0.1 m, 8192-ray batches, 512 slots a shard)
               through ShardedRayFlowMapper (the rayflow wire routed on the
               devices) and ShardedRayMapper (segments routed on the host),
               4 warm-up and 12 timed batches each, fenced
               (sharded_rayflow_rays_per_sec, sharded_rays_per_sec), K1-K3,
               the flag gather and the fused TSDF kernel counted (launches
               a batch), routed rays a ray, the last batch's per-shard
               balance, a profile line of the rayflow mapper; occupancy bit
               for bit against TorchRayMapper on the card on the same wire,
               a second card run and, on 2 batches, the sharded run on the
               CPU; NDT-OM (0.2 m) and TSDF through both mappers on 4
               batches against TorchNdtMap and TorchTsdfMap on the card
               (within 1e-5, non-finite values equal); one a2a step (no
               routing drop, bit for bit); the eviction case at capacity 1
               (tests/test_sharded.py's clusters, bit for bit); and
               dryrun_multichip(4); then K1 (keys; voxel planes), K2, the
               fused flag gather, K3 and the fused per-visit kernel against
               their plain versions on one shard's arguments, bit for bit

Each phase's seconds follow it on a "phase_seconds" line.

  p_path       the deposit probe's own path (P), through its entry point
               (ohm_tpu_torch.scripts.probe_deposit main) at full size: the
               five probes, the slot-grid deposit, the one-hot and scatter
               deposits and K3 on one bench-shaped stream (1,250,304 keys,
               512 slots, 320 live), every launch counted
  p_probes     each probe's kernel against its plain version and its expected
               array, bit for bit; the one-hot product on random records (1,
               4 and 8 rows of 128, and 512 records in one cell) against its
               plain version and bincount
  p_slotgrid   the slot-grid kernel against its plain version at full size
               and on the edge streams (and a ragged tail), fused and
               unfused, bit for bit, and against a second run; K3 against
               its plain version on the same streams (and two runs); the
               fused result against the f64 reference (f32 roundings, no
               gate), and bit for bit against scatter_deposit and K3
  p_times      the slot-grid kernel alone and as a call beside its plain
               version, K3, scatter_deposit and onehot_deposit on the same
               stream, its byte bound and its sector design bound; each
               probe alone beside an empty kernel (the launch floor) and its
               library call, and as a call beside its plain version and its
               library call, in alternated turns
  apps         ohmpop and the other CLIs, called in this process: 12 x 8192
               outdoor_rays samples (seed 7, scripts/bench_modes.py config 2)
               through the port's .laz writer with a static trajectory;
               laz_read_s (SlamCloudLoader reading and transforming the file);
               ohmpop --resolution 0.2 --voxel-mean --arena-capacity 1024
               --batch-size 8192 --save-info twice on the card (rays_per_sec
               from the harness's stats, K1 and K2 launches counted) and once
               on the CPU: the same chunks, occupancy bits and mean counts,
               mean codes identical on >= 99.9% (within one quantum
               elsewhere), the two card files byte-identical; --mode ndt,
               ndt-tm and tsdf with --point-limit 16384, card against CPU
               (NDT: compare_port; TSDF: weights equal, distances within
               PORT_TOL), each mode's kernels launched; ohminfo --voxel-stats,
               ohm2ply, ohmheightmap --clearance 0.5, ohmhm2img, ohmcmp (the
               card's file against the CPU's; the mean code within one
               quantum a field, every other member exact) and ohmquery
               rays --device cuda on the card's .ohm, each returning 0; and
               the layered heightmap (LAYERED_FILL, min clearance 0.5) of
               config 4's occupancy map (the box scene, 0.1 m, 1024 slots, 4
               batches of 8192) built on the card and on the CPU: layers
               bit-identical, layered_heightmap_build_sec and source_voxels
  port_bench   the two commands a benchmark's cells run, each in its own
               process: python -m ohm_tpu_torch.bench and python -m
               ohm_tpu_torch.scripts.bench_modes --quick; each must exit 0
               and print all its lines (the reference's keys plus backend
               "cuda" and the card's name), the differential ok, the fused
               differential bit-identical, and
               bench_modes' --out file hold its rows
  api          the reference's call forms, with OHM_RAYFLOW, OHM_RAYFLOW_G,
               OHM_SNAKE and OHM_STREAM_BUDGET unset: TorchRayMapper(m, 512),
               TorchNdtMap(m, None, 1024) and TorchTsdfMap(m, None, 1024),
               positional, take the rayflow wire (one segment a ray) on
               three box batches, K1 and K2 / the flag gather and K3 / the
               fused TSDF kernel counted above 0 and their device rows in
               torch.profiler; OHM_RAYFLOW_G=8 OHM_SNAKE=0 groups 8 rays
               and gives the default mapper's occupancy bits, K1 and K2
               launched; under OHM_RAYFLOW=0 the default constructor takes
               the segmented wire (segments counted, K1 not launched); and
               TorchTsdfMap with per_visit=False under a pinned scatter_cap
               drops and counts the same voxel updates on the card as on
               the CPU, with the same bits, K1 launched ahead of the window

Then one JSON line of the kernels (each with its bound: the bytes it must
move over 3.35 TB/s or its operations over 67 TFLOP/s (bf16 matrix work
over 989 TFLOP/s), whichever is longer, and the time of one PyTorch call
that computes the same function, where there is one), nvidia-smi's line,
and the result line
{"ok": true, "device": {...}}.  The script uses the port alone, with its own
host layer (ohm_tpu_torch.core, .oracle, .native, .io, .heightmap, .app); it
fails if JAX or any module of ohm_tpu was imported.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import gc
import importlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
import warnings

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ohm_tpu_torch import TorchNdtMap, TorchRayMapper, TorchTsdfMap, native
from ohm_tpu_torch.app import harness as app_harness
from ohm_tpu_torch.bench import (box_scene_rays, device_and_host_ms, emit, environ,
                                 fenced_seconds, timed_integration, without_gc_pauses)
from ohm_tpu_torch.app import ohm2ply, ohmcmp, ohmheightmap, ohmhm2img, ohminfo, ohmpop, ohmquery
from ohm_tpu_torch.core import subvoxel
from ohm_tpu_torch.core.layout import (CLEARANCE_LAYER, COVARIANCE_LAYER, HIT_MISS_COUNT_LAYER,
                                       INCIDENT_NORMAL_LAYER, INTENSITY_LAYER, MEAN_LAYER,
                                       OCCUPANCY_LAYER, TOUCH_TIME_LAYER, TRAVERSAL_LAYER,
                                       TSDF_LAYER)
from ohm_tpu_torch.core.map import MapFlag, OccupancyMap
from ohm_tpu_torch.core.rayflags import RayFlag
from ohm_tpu_torch.core.raypattern import ClearingPattern
from ohm_tpu_torch.heightmap import Heightmap, HeightmapMode
from ohm_tpu_torch.heightmap.heightmap import HEIGHTMAP_LAYER
from ohm_tpu_torch.io import load as load_ohm
from ohm_tpu_torch.io.slam import SlamCloudLoader
from ohm_tpu_torch.mapping.batch import prepare_ray_batch, prepare_rayflow
from ohm_tpu_torch.oracle.ndt import NdtParams, RayMapperNdt
from ohm_tpu_torch.oracle.occupancy import RayMapperOccupancy
from ohm_tpu_torch.oracle.tsdf import RayMapperTsdf, TsdfOptions
from ohm_tpu_torch.ops import (_build, deposit_cuda, expand_cuda, gather_cuda, probes_cuda,
                               slotgrid_cuda, tsdf_cuda)
from ohm_tpu_torch.ops import integrate as integrate_ops
from ohm_tpu_torch.ops.ddawalk import walk_rays
from ohm_tpu_torch.ops.integrate import (apply_records, apply_sample_layers, expand_records,
                                         expand_walk)
from ohm_tpu_torch.ops.wire import decode, unpack_batch
from ohm_tpu_torch.parallel import (ResidentShardedArena, ShardedRayFlowMapper,
                                    ShardedRayMapper, ShardMesh, dryrun_multichip,
                                    make_source_batch, region_owner, sharded_integrate_a2a)
from ohm_tpu_torch.parallel.dryrun import compare_maps, map_members
from ohm_tpu_torch.query import ClearanceProcess, LineKeysQuery, RaysQuery
from ohm_tpu_torch.query.rays_query import rays_query_device
from ohm_tpu_torch.scripts import probe_deposit
from ohm_tpu_torch.scripts.bench_modes import (integrate_frame, laz_round_trip, outdoor_rays,
                                               write_laz_cloud)
from ohm_tpu_torch.testing import (DEPOSIT_EDGE_STREAMS, NDT_EDGE_STREAMS, PROBE_LIBRARY_CALLS,
                                   TSDF_SPECIALS, TSDF_VISIT_STREAMS, deposit_edge_stream,
                                   dispatched_ops, edge_rays, fused_traversal_atol,
                                   ndt_edge_streams, ndt_flag_arena,
                                   tsdf_visit_stream)

REPO = os.path.dirname(os.path.abspath(__file__))

SEED = 2024
RESOLUTION = 0.1
CAPACITY = 512
RAYS_PER_BATCH = 8192
N_BATCHES = 40
WARMUP = 4
GATE = {"tolerance": 1e-4, "allowed_ratio": 1e-4, "worst_bound": 2e-3}  # bench.py

# scripts/bench_modes.py configs 3 and 5 (NDT-OM, NDT-TM integrate).
NDT_RESOLUTION = 0.2
NDT_CAPACITY = 1024
NDT_BATCHES = 12
NDT_WARMUP = 6
TM_FRAME_RAYS = 1 << 20
TM_HALF = (15.0, 15.0, 7.0)
TM_MISS_K = 1 << 15
# scripts/bench_modes.py config 4 (TSDF): 12 batches, the first 6 also warm up.
TSDF_CAPACITY = 1024
TSDF_BATCHES = 12
TSDF_WARMUP = 6
# The occupancy mapper's side layers (bench.py's configuration with them).
LAYER_FLAGS = (MapFlag.VOXEL_MEAN | MapFlag.TRAVERSAL | MapFlag.TOUCH_TIME
               | MapFlag.INCIDENT_NORMAL)
# scripts/bench_modes.py config 2 (occupancy + voxel mean, outdoor): rng seed
# 7, 12 batches, warmed up through 6 synchronous batches and one async pass.
OUTDOOR_SEED = 7
OUTDOOR_RESOLUTION = 0.2
OUTDOOR_CAPACITY = 1024
OUTDOOR_BATCHES = 12
OUTDOOR_WARMUP = 6
# The segmented wire: clearing batches under ClearingPattern's flags (the
# monolith), and the wide outdoor survey past the rayflow wire's envelope
# (rays over 32 regions, a region bbox over 63) in an arena past its 8191
# slots.  The survey touches ~24,500 regions: 32767 slots hold it (16384
# paged ~19,000 regions out and back a batch: 307-487 rays/s); 32767 is the
# largest arena of 32^3 regions the int32 sort key addresses, and there the
# segmented upload is the full int32 blocks.
CLEARING_FLAGS = int(ClearingPattern.DEFAULT_RAY_FLAGS)
CLEARING_REACH = 1.1
CLEARING_BATCHES = 12
CLEARING_WARMUP = 4
WIDE_EXTENT = 120.0
WIDE_CAPACITY = 32767
WIDE_BATCHES = 12
WIDE_CHECKED = 2
SEGMENTED_NDT_TSDF_BATCHES = 8
SEGMENTED_NDT_TSDF_WARMUP = 6
# Port on the card against the port on the CPU.
PORT_TOL = {"atol": 1e-5, "rtol": 1e-5, "mean_code_identical": 0.999}
# The NDT side layers (the NDT mapper adds its own voxel mean).
NDT_LAYER_FLAGS = MapFlag.TRAVERSAL | MapFlag.TOUCH_TIME | MapFlag.INCIDENT_NORMAL
NDT_LAYERS_BATCHES = 12
# scripts/bench_modes.py's query rows.
QUERY_SEED = 8
QUERY_RAYS = 512
QUERY_EXECUTES = 13
QUERY_REDISPATCHES = 16
CLEARANCE_RADIUS = 1.0
CLEARANCE_DELTA_RAYS = 1 << 14
# One H100 SXM (NVIDIA's data sheet): HBM rate, the f32 rate outside the
# tensor cores, at which integer ops are counted too, and the dense bf16
# tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12


def corner_scene_rays(n, rng, spread=5.0):
    """Random short rays plus exact-corner and axis-aligned rays, which hit
    the walk's ties (tests/test_expand_pallas.py)."""
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    lengths = rng.uniform(0.25, spread, n)
    origins = rng.uniform(-0.8, 0.8, (n, 3))
    dirs[:64] = np.array([1.0, 1.0, 1.0]) / np.sqrt(3.0)
    origins[:64] = 0.0
    dirs[64:96] = np.eye(3)[np.arange(32) % 3]
    rays = np.zeros((2 * n, 3))
    rays[0::2] = origins
    rays[1::2] = origins + dirs * lengths[:, None]
    return rays


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean ms per call of ``fn`` on the current stream (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with without_gc_pauses():
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def plain_vs_kernel_ms(plain, kernel, reps: int = 20) -> tuple[float, float]:
    """Times in turns (plain, kernel, kernel, plain); returns the means."""
    p1, k1, k2, p2 = (cuda_ms(f, reps) for f in (plain, kernel, kernel, plain))
    return (p1 + p2) / 2, (k1 + k2) / 2


def bound(nbytes: int, ops: int, tensor_ops: int = 0) -> dict:
    """The least time the card could take for a kernel's work: the bytes it
    must move (each input read once, each output written once) over the HBM
    rate, or its operations over the scalar rate (plus its bf16 matrix
    operations over the tensor-core rate), whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (ops / SCALAR_OPS_PER_S + tensor_ops / BF16_TENSOR_OPS_PER_S) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": int(nbytes), "bound_ops": int(ops + tensor_ops)}


def distinct(ids: torch.Tensor, sentinel: int) -> int:
    """Distinct ids below the sentinel: the voxels a call must touch."""
    return int(torch.unique(ids[(ids >= 0) & (ids < sentinel)]).numel())


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def finite_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| where both are finite (0 when none is)."""
    fin = torch.isfinite(a) & torch.isfinite(b)
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def k1_bound(b: dict, cfg, with_vox: bool, with_trav: bool = False) -> dict:
    """K1's bound.  Bytes: per ray the unpacked batch's fields the kernel
    reads, 7 f32 (start_frac, direction, length), 6 i32 (start_abs,
    end_abs), two bool bytes (valid, exclude_start) and K i32 (tcand), and
    its aux outputs, a u8 overflow flag and an f32 end enter time; gmeta's
    three words and the missed count once; per lane (3S a ray) a 4-byte
    key, 12 bytes of voxel planes with ``with_vox`` and 4 bytes of
    traversal with ``with_trav``.  Operations (counted from csrc/expand.cu):
    ~90 + 4K a lane (the event time, two rank probes with their binary
    advance, the packing and the K-way candidate match), 24 more with the
    traversal (three enter times, two compare-and-selects, the subtraction
    and its validity select); and ~150 a ray for the set-up: per axis ~26
    compares, selects, products and sums (init_walk, the crossings and
    n_ax, the last event time, the overflow term) and two IEEE divisions
    at ~10 each, then the enter time's two maxima and its clamp."""
    B, S, K = b["start_abs"].shape[0], cfg.max_steps, b["tcand"].shape[1]
    lanes = B * 3 * S
    per_lane = 4 + (12 if with_vox else 0) + (4 if with_trav else 0)
    per_ray = 7 * 4 + 6 * 4 + 2 + 4 * K + 1 + 4
    return bound(B * per_ray + 12 + 4 + lanes * per_lane,
                 lanes * (90 + 4 * K + (24 if with_trav else 0)) + 150 * B)


def count_host_syncs(fn) -> dict:
    """Synchronizing CUDA calls made while ``fn`` runs, by the innermost
    line of the repository's code that led to each: torch's sync debug mode
    warns on every one (an upload from pageable memory, nonzero, item)."""
    sites = {}

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1] if f.filename.startswith(REPO)]
        at = (os.path.relpath(ours[-1].filename, REPO), ours[-1].lineno) if ours else (
            filename, lineno)
        sites[f"{at[0]}:{at[1]}"] = sites.get(f"{at[0]}:{at[1]}", 0) + 1

    torch.cuda.synchronize()
    # Enabling the mode may itself warn (seen once torch.profiler has run);
    # only what ``fn`` does is recorded.
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return {"count": sum(sites.values()), "sites": sites}


def device_profile(fn, kernel="", reps: int = 10) -> dict:
    """torch.profiler's device rows while ``fn`` runs: the kernel alone,
    without its wrapper's host work (the sum over the CUDA kernels whose
    name holds ``kernel``, or one of a tuple of names, of each one's mean
    device time a launch: a call launches each once), and per call the
    time of every device operation (kernels and memsets: the device time
    of the whole call) and their count.  On the
    H100 with torch 2.11 a short trace at times loses some or all of its
    device rows (a count a call below the call's own shows it): the mean a
    launch does not move with a partial loss, and a trace that saw no
    launch of one of the named kernels (or no row at all) is taken again,
    up to three times."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        names = (kernel,) if isinstance(kernel, str) else kernel
        named = [e for e in rows if any(k and k in e.key for k in names)]
        launches = sum(e.count for e in named)
        if (all(any(k in e.key for e in named) for k in names) if kernel else rows):
            break
    us = lambda es: sum(getattr(e, "self_device_time_total", 0) for e in es)
    return {"kernel_ms": sum(us([e]) / e.count for e in named) / 1e3 if launches else 0.0,
            "device_ms": us(rows) / 1e3 / reps,
            "device_ops": sum(e.count for e in rows) / reps}


def kernel_device_ms(fn, kernel: str = "", reps: int = 10) -> float:
    """device_profile's kernel time for a named ``kernel``; with ``kernel``
    empty, the device time of the whole call."""
    prof = device_profile(fn, kernel, reps)
    return prof["kernel_ms"] if kernel else prof["device_ms"]


def host_us_per_call(fn, calls: int = 1000) -> float:
    """Host time per call of ``fn`` over ``calls`` calls without a
    synchronize (the wrapper's Python and launch cost; the device catches
    up after the clock stops, as long as the launch queue does not fill)."""
    fn()
    torch.cuda.synchronize()
    with without_gc_pauses():
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def device_ops_per_call(fn, tries: int = 4) -> float:
    """device_profile's device operations a call, the most over ``tries``
    traces: a trace that lost rows counts fewer (device_profile's note)."""
    return max(device_profile(fn)["device_ops"] for _ in range(tries))


def device_alone_ms(fn_kernel: tuple) -> float | None:
    """kernel_device_ms of a (fn, kernel) pair; None where the trace lost
    every row it needed (device_profile's note)."""
    return kernel_device_ms(*fn_kernel) or None


def alternated_ms(fns: dict, turns: int = 6, measure=cuda_ms) -> dict:
    """ms per call of each of ``fns`` by ``measure`` (by default CUDA events
    over the call; ``device_alone_ms`` takes (fn, kernel) pairs) in
    alternated turns (the order reversed every other turn); the median and
    every turn's time.  A turn that read None is left out of the median."""
    times = {name: [] for name in fns}
    for t in range(turns):
        for name in (list(fns) if t % 2 == 0 else list(fns)[::-1]):
            times[name].append(measure(fns[name]))
    median = lambda v: float(np.median(v)) if v else None  # noqa: E731
    return {name: {"median_ms": median([x for x in v if x is not None]), "turns_ms": v}
            for name, v in times.items()}


def aten_cuda_max_semantics() -> dict:
    """Which operand ATen's CUDA maximum and clamp(min=0) return for signed
    zeros and NaN, as f32 bit patterns (the expand kernel reproduces them
    for the end voxel's enter time)."""
    a = torch.tensor([-0.0, 0.0, float("nan"), 1.0], device="cuda")
    b = torch.tensor([0.0, -0.0, 1.0, float("nan")], device="cuda")
    hexes = lambda t: [f"{x:08x}" for x in t.view(torch.int32).cpu().numpy().view(np.uint32)]
    return {"maximum(a, b)": hexes(torch.maximum(a, b)), "a": hexes(a), "b": hexes(b),
            "clamp(a, min=0)": hexes(torch.clamp(a, min=0.0))}


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    info = {"phase": "device", "nvidia_smi": smi,
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def _timed_build(build) -> tuple[str, float]:
    t0 = time.perf_counter()
    return build(force=True), time.perf_counter() - t0


def phase_build() -> None:
    # The LASzip codec (g++) builds beside nvcc; the rayflow host pass
    # (g++ -march=native) after it, on this machine.
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        laz = pool.submit(_timed_build, native.build_laz)
        seconds, log = _build.build(force=True, verbose=True)
        laz_lib, laz_seconds = laz.result()
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "Compiling entry" in ln]
    native_lib, native_seconds = _timed_build(native.build)
    emit({"phase": "build", "seconds": seconds,
          "sources": [os.path.relpath(p, REPO) for p in _build.sources()],
          "flags": _build.NVCC_FLAGS, "ptxas": ptxas,
          "native": os.path.relpath(native_lib, REPO), "native_seconds": native_seconds,
          "laszip": os.path.relpath(laz_lib, REPO), "laszip_seconds": laz_seconds})


def _wire_batch(rays, flags=0):
    """A scene's rayflow wire as the main path prepares it, decoded on the card."""
    mapper = TorchRayMapper(OccupancyMap(resolution=RESOLUTION, flags=MapFlag.NONE),
                            capacity=CAPACITY, device="cuda")
    mapper.prime_caps([rays])
    wire, cfg, _ = mapper._rayflow_setup_host(rays, None, None, flags)
    return unpack_batch(torch.from_numpy(wire).cuda(), cfg), cfg


def refuses_misaligned(fn) -> bool:
    """Whether ``fn`` raises the gather wrappers' ValueError for ids that do
    not start on a 16-byte boundary (and launches nothing)."""
    try:
        fn()
    except ValueError as e:
        return "aligned" in str(e)
    return False


def phase_k1() -> dict:
    rng = np.random.default_rng(SEED)
    cases = []
    box_b, box_cfg = _wire_batch(box_scene_rays(RAYS_PER_BATCH, rng))
    cases.append(("box", box_b, box_cfg, 0))
    corner_b, corner_cfg = _wire_batch(corner_scene_rays(2048, rng))
    cases.append(("corner_exclude_origin", corner_b, corner_cfg, int(RayFlag.EXCLUDE_ORIGIN)))
    edge_b, edge_cfg = _wire_batch(box_scene_rays(2048, rng))
    edge_rays(edge_b, edge_cfg)
    cases.append(("box_edge_rays", edge_b, edge_cfg, int(RayFlag.EXCLUDE_ORIGIN)))
    # Miss scene: drop the first candidate of every other ray, so records in
    # that region resolve to no slot and must be counted as missed.
    miss_b = dict(box_b)
    miss_b["tcand"] = box_b["tcand"].clone()
    miss_b["tcand"][::2, 0] = 0
    cases.append(("box_missed", miss_b, box_cfg, 0))
    rows = []
    for name, b, cfg, flags in cases:
        excl = bool(flags & RayFlag.EXCLUDE_ORIGIN)
        row = check_k1_call(((b, cfg), {"exclude_origin": excl}))
        b_cpu = {k: v.cpu() for k, v in b.items()}
        key_c, missed_c = expand_cuda.expand_keys_reference(b_cpu, cfg, exclude_origin=excl)
        key_k, aux = expand_cuda.expand_keys(b, cfg, exclude_origin=excl)
        aux_c = expand_cuda._prelude(b_cpu, cfg)[-1]
        torch.cuda.synchronize()
        # The card against the plain version on the CPU, every ray: a
        # denormal direction component reads as zero on both.
        d = b_cpu["direction"]
        row["equal_cpu"] = bool(
            torch.equal(key_k.cpu(), key_c) and int(aux["missed_n"]) == int(missed_c)
            and torch.equal(aux["overflow"].cpu(), aux_c["overflow"])
            and same_bits(aux["end_enter"].cpu(), aux_c["end_enter"]))
        row["denormal_rays"] = int(
            ((d != 0) & (d.abs() < torch.finfo(torch.float32).tiny)).any(dim=1).sum())
        row.update(scene=name, rays=int(b["valid"].sum()))
        rows.append(row)
        if not (row["bit_identical"] and row["equal_cpu"]):
            raise AssertionError(f"expand kernel differs from its plain version on {name}: {row}")
    if rows[-1]["missed"] == 0:
        raise AssertionError("the miss scene made no record miss")
    edge = rows[2]
    if not (edge["overflow_rays"] >= 8 and edge["denormal_rays"] >= 8
            and edge["nan_end_enter"] == 0):
        raise AssertionError(f"the edge rays did not reach their cases: {edge}")
    ops = sorted(set(dispatched_ops(lambda: expand_cuda.expand_keys(
        box_b, box_cfg, with_trav=True, with_vox=True))))
    if not set(ops) <= {"empty", "empty_strided"}:
        raise AssertionError(f"the expand wrapper issued PyTorch ops besides its outputs: {ops}")
    result = {"phase": "k1_expand", "tolerance": 0, "cases": rows,
              "wrapper_aten_ops": ops, "aten_cuda_max_semantics": aten_cuda_max_semantics()}
    emit(result)
    return {"max_abs_err": max(r["max_abs_err"] for r in rows), "wire": (box_b, box_cfg),
            "cases": cases}


def phase_k1_vox(k1: dict) -> dict:
    """K1's voxel planes against the plain walk's voxels on non-sentinel lanes."""
    rows = []
    for name, b, cfg, flags in k1["cases"]:
        kw = {"exclude_origin": bool(flags & RayFlag.EXCLUDE_ORIGIN), "with_vox": True}
        rows.append({"scene": name, **check_k1_call(((b, cfg), kw))})
        if not rows[-1]["bit_identical"]:
            raise AssertionError(f"expand kernel's voxel planes differ on {name}: {rows[-1]}")
    emit({"phase": "k1_vox", "tolerance": 0, "cases": rows})
    return {"max_abs_err": max(r["max_abs_err"] for r in rows)}


def _bench_arena_and_stream(cfg, rng):
    """A 512-slot arena mixing unobserved (-0.0), free, occupied and
    saturated voxels, and a sorted ~1.1M-key stream over 320 live slots."""
    n_vox = cfg.sentinel
    occ = np.full(n_vox + 1, np.float32(-0.0), np.float32)
    seeded = rng.integers(0, n_vox, n_vox // 4)
    occ[seeded] = rng.normal(0.0, 2.0, seeded.size).astype(np.float32)
    occ[seeded[: seeded.size // 50]] = np.float32(cfg.max_value)  # clamped high
    n = 1_100_000
    slots = rng.integers(0, 320, n)
    flat = slots * cfg.voxels_per_region + rng.integers(0, cfg.voxels_per_region, n)
    hot = rng.random(n) < 0.3
    flat[hot] = (slots[hot] * 7919) % n_vox  # repeated voxels: counts > 1
    hit = (rng.random(n) < 0.1).astype(np.int64)
    sent = rng.random(n) < 0.05
    flat[sent] = n_vox
    hit[sent] = rng.integers(0, 2, int(sent.sum()))
    key = np.sort((flat << 1) | hit).astype(np.int32)
    return torch.from_numpy(occ).cuda(), torch.from_numpy(key).cuda()


def check_k2(occ0, keys, cfg, **row) -> dict:
    """K2 against its plain version on one sorted stream, each on its own
    clone of the arena, and against a second run of itself: occupancy bits
    and touched counts.  Raises on any difference."""
    occ_k, touched_k = deposit_cuda.deposit_and_sweep(occ0.clone(), keys, cfg)
    occ_2, touched_2 = deposit_cuda.deposit_and_sweep(occ0.clone(), keys, cfg)
    occ_p, touched_p = deposit_cuda.deposit_and_sweep_reference(occ0.clone(), keys, cfg)
    torch.cuda.synchronize()
    row.update(keys=keys.numel(), touched=int(touched_k),
               changed=int((occ_k.view(torch.int32) != occ0.view(torch.int32)).sum()),
               max_abs_err=finite_err(occ_k, occ_p),
               bit_identical=bool(same_bits(occ_k, occ_p)
                                  and int(touched_k) == int(touched_p)),
               two_runs_identical=bool(same_bits(occ_k, occ_2)
                                       and int(touched_k) == int(touched_2)))
    if not (row["bit_identical"] and row["two_runs_identical"]):
        raise AssertionError(f"deposit kernel differs from its plain version: {row}")
    return row


def phase_k2() -> dict:
    base = TorchRayMapper(OccupancyMap(resolution=RESOLUTION, flags=MapFlag.NONE),
                          capacity=CAPACITY, device="cuda")._config(0)
    occ0, keys = _bench_arena_and_stream(base, np.random.default_rng(SEED))
    cases = [(int(f), {}) for f in (0, RayFlag.EXCLUDE_FREE, RayFlag.EXCLUDE_OCCUPIED,
                                    RayFlag.EXCLUDE_UNOBSERVED,
                                    RayFlag.EXCLUDE_FREE | RayFlag.EXCLUDE_OCCUPIED)]
    cases.append((0, {"saturation_min": -1.0, "saturation_max": 2.0}))
    rows = [check_k2(occ0, keys, dataclasses.replace(base, ray_flags=flags, **extra),
                     flags=flags, **extra) for flags, extra in cases]
    if min(r["changed"] for r in rows) == 0:
        raise AssertionError(f"a deposit case changed no voxel: {rows}")
    # The streams the run-length design makes risky, on the same arena.
    for name in DEPOSIT_EDGE_STREAMS:
        ek = torch.from_numpy(deposit_edge_stream(name, base.sentinel)).cuda()
        rows.append(check_k2(occ0, ek, base, stream=name))
    emit({"phase": "k2_deposit", "tolerance": 0, "cases": rows})
    return {"max_abs_err": max(r["max_abs_err"] for r in rows)}


def _ndt_config_at_bench_shape():
    """The base config of the NDT-OM configuration (0.2 m, 32^3 regions,
    1024 slots)."""
    return TorchNdtMap(OccupancyMap(resolution=NDT_RESOLUTION, flags=MapFlag.NONE),
                       capacity=NDT_CAPACITY, device="cuda")._config(0)


def _ndt_arena_and_streams(cfg, rng, n_walk: int = 1_100_000):
    """An NDT arena mixing +inf (unobserved), free, occupied and clamped
    voxels; a walk stream of ``n_walk`` misses in sorted order over 320
    live slots with a prefix of half of its voxels' runs masked to the
    sentinel (~20% of the records), as the NDT miss phase masks
    Gaussian-handled records, and the same stream unmasked (bounds); 8192
    end keys (hits and misses, unsorted); and a sparse miss delta over
    32768 records with one value per voxel at its last record, some values
    zero, and its dense plane.  Returns (occupancy, walk, end, (delta keys,
    delta values), plane, bounds) on the card."""
    n_vox = cfg.sentinel
    occ = np.full(n_vox + 1, np.inf, np.float32)
    seeded = rng.integers(0, n_vox, n_vox // 4)
    occ[seeded] = rng.normal(0.0, 2.0, seeded.size).astype(np.float32)
    occ[seeded[: seeded.size // 50]] = np.float32(cfg.max_value)
    occ[seeded[seeded.size // 50: seeded.size // 25]] = np.float32(cfg.min_value)
    live = rng.integers(0, 320, n_walk) * cfg.voxels_per_region
    flat = np.sort(live + rng.integers(0, cfg.voxels_per_region, live.size))
    starts = np.flatnonzero(np.r_[True, flat[1:] != flat[:-1]])
    run = np.cumsum(np.r_[True, flat[1:] != flat[:-1]]) - 1
    lengths = np.diff(np.r_[starts, flat.size])
    prefix = np.where(rng.random(starts.size) < 0.5, rng.integers(0, lengths + 1), 0)
    masked = np.arange(flat.size) - starts[run] < prefix[run]
    walk = np.where(masked, n_vox, flat) << 1
    end_flat = rng.integers(0, n_vox, RAYS_PER_BATCH)
    end_flat[rng.random(RAYS_PER_BATCH) < 0.05] = n_vox
    end = (end_flat << 1) | (rng.random(RAYS_PER_BATCH) < 0.7)
    dk = np.sort(np.concatenate([rng.choice(flat, 30_000), np.full(2768, n_vox)]))
    last = np.concatenate([dk[1:] != dk[:-1], [True]]) & (dk < n_vox)
    dv = np.where(last, rng.normal(0.0, 0.3, dk.size), 0.0).astype(np.float32)
    dv[last & (rng.random(dk.size) < 0.1)] = 0.0  # voxels whose deltas sum to 0
    plane = np.zeros(n_vox + 1, np.float32)
    plane[dk[last]] = dv[last]
    cuda = [torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in (
        occ, walk.astype(np.int32), end.astype(np.int32), (dk << 1).astype(np.int32), dv,
        plane, (flat << 1).astype(np.int32))]
    return cuda[0], cuda[1], cuda[2], (cuda[3], cuda[4]), cuda[5], cuda[6]


def check_k3(occ0, walk, end, miss_delta, cfg, bounds=None, **row) -> tuple[dict, torch.Tensor]:
    """K3 against its plain version on one set of streams (the walk with its
    ``bounds``, or sorted by the wrapper), each on its own clone of the
    arena, and against a second run of itself: occupancy bits and touched
    counts.  Raises on any difference; returns the row and the kernel's
    occupancy."""
    run = lambda: deposit_cuda.deposit_and_sweep_ndt(occ0.clone(), walk, end, miss_delta, cfg,
                                                     bounds_key=bounds)
    (occ_k, touched_k), (occ_2, touched_2) = run(), run()
    occ_p, touched_p = deposit_cuda.deposit_and_sweep_ndt_reference(
        occ0.clone(), walk, end, miss_delta, cfg)
    torch.cuda.synchronize()
    row.update(walk_bounds=bounds is not None, walk_keys=walk.numel(), end_keys=end.numel(),
               touched=int(touched_k),
               changed=int((occ_k.view(torch.int32) != occ0.view(torch.int32)).sum()),
               max_abs_err=finite_err(occ_k, occ_p),
               bit_identical=bool(same_bits(occ_k, occ_p)
                                  and int(touched_k) == int(touched_p)),
               two_runs_identical=bool(same_bits(occ_k, occ_2)
                                       and int(touched_k) == int(touched_2)))
    if not (row["bit_identical"] and row["two_runs_identical"]):
        raise AssertionError(f"NDT deposit kernel differs from its plain version: {row}")
    return row, occ_k


def phase_k3() -> dict:
    base = _ndt_config_at_bench_shape()
    occ0, walk, end, sparse, plane, bounds = _ndt_arena_and_streams(
        base, np.random.default_rng(SEED))
    rows, results = [], {}
    for name, delta, extra, walk_bounds in (
            ("sparse", sparse, {}, bounds), ("dense", plane, {}, bounds),
            ("sparse_sorted_here", sparse, {}, None),
            ("sparse_saturation", sparse, {"saturation_min": -1.0, "saturation_max": 2.0},
             bounds)):
        row, results[name] = check_k3(occ0, walk, end, delta, dataclasses.replace(base, **extra),
                                      walk_bounds, delta=name, **extra)
        rows.append(row)
        if row["changed"] == 0:
            raise AssertionError(f"the NDT deposit changed no voxel: {row}")
    if not (same_bits(results["sparse"], results["dense"])
            and same_bits(results["sparse"], results["sparse_sorted_here"])):
        raise AssertionError("the sparse and dense miss deltas, or the walk with its bounds "
                             "and sorted, deposit differently")
    # The streams the run-length design makes risky, end keys shuffled, on
    # the same arena, with the sparse and the dense delta, the walk with its
    # bounds; and sorted by the wrapper with the sparse delta.
    for name in NDT_EDGE_STREAMS:
        st = {k: torch.from_numpy(v).cuda()
              for k, v in ndt_edge_streams(name, base.sentinel).items()}
        end_e = st["end"][torch.randperm(st["end"].numel(), device=st["end"].device)]
        for form, delta, walk_bounds in (("sparse", (st["dkeys"], st["dvals"]), st["bounds"]),
                                         ("dense", st["plane"], st["bounds"]),
                                         ("sparse_sorted_here", (st["dkeys"], st["dvals"]),
                                          None)):
            rows.append(check_k3(occ0, st["walk"], end_e, delta, base, walk_bounds,
                                 stream=name, delta=form)[0])
    emit({"phase": "k3_ndt_deposit", "tolerance": 0, "cases": rows})
    return {"max_abs_err": max(r["max_abs_err"] for r in rows)}


def phase_k4() -> dict:
    cfg = _ndt_config_at_bench_shape()
    rng = np.random.default_rng(SEED)
    n_vox = cfg.sentinel
    plane = torch.from_numpy((rng.random(n_vox + 1) < 0.3).astype(np.int8)).cuda()
    live = rng.integers(0, 320, 1_400_000) * cfg.voxels_per_region
    ids = np.concatenate([np.sort(live + rng.integers(0, cfg.voxels_per_region, live.size)),
                          np.full(150_000, n_vox)]).astype(np.int32)
    ids = torch.from_numpy(ids).cuda()
    out_k = gather_cuda.gather_plane(plane, ids, n_vox)
    out_p = gather_cuda.gather_plane_reference(plane, ids, n_vox)
    torch.cuda.synchronize()
    err = int((out_k - out_p).abs().max())
    ok = torch.equal(out_k, out_p) and int(out_k[-150_000:].abs().sum()) == 0
    # 16-byte vectors with a scalar tail (n % 4 == 3); ids that do not start
    # on a 16-byte boundary are refused.
    pk = gather_cuda.gather_plane(plane, ids[:-1], n_vox)
    pp = gather_cuda.gather_plane_reference(plane, ids[:-1], n_vox)
    torch.cuda.synchronize()
    err = max(err, int((pk - pp).abs().max()))
    ok = ok and torch.equal(pk, pp)
    row = {"ids": ids.numel(), "sentinel_ids": 150_000, "flagged": int(out_k.sum()),
           "max_abs_err": err, "bit_identical": bool(ok),
           "misaligned_refused": refuses_misaligned(
               lambda: gather_cuda.gather_plane(plane, ids[1:], n_vox)),
           "kernel_alone_ms": kernel_device_ms(
               lambda: gather_cuda.gather_plane(plane, ids, n_vox), "PlaneSource")}
    emit({"phase": "k4_gather", "tolerance": 0, **row})
    if not (ok and row["misaligned_refused"]):
        raise AssertionError(f"gather kernel differs from its plain version: {row}")
    return {"max_abs_err": err, "alone_ms": row["kernel_alone_ms"]}


def phase_k4_flags() -> dict:
    """The fused NDT flag gather against its plain version (the arena-wide
    flag plane, then K4's plain gather) at the NDT-OM arena (1024 slots),
    with +inf, NaN, counts on both sides of each threshold and at or above
    2^31, a sentinel tail, whole vectors and a scalar tail; misaligned ids
    refused."""
    cfg = _ndt_config_at_bench_shape()
    rng = np.random.default_rng(SEED)
    n_vox = cfg.sentinel
    occ, count = ndt_flag_arena(n_vox + 1, n_vox, rng, 100_000, 100_000)
    occ, count = torch.from_numpy(occ).cuda(), torch.from_numpy(count.view(np.int32)).cuda()
    ids = torch.from_numpy(_sorted_ids(rng, cfg, 600_000, 50_001)).cuda()
    rows, ok, err = [], True, 0
    for threshold in (3, 1, 0):
        for part in (ids, ids[:-2], ids[4:-1]):
            out_k = gather_cuda.gather_ndt_flags(occ, count, part, threshold, n_vox)
            out_p = gather_cuda.gather_ndt_flags_reference(occ, count, part, threshold, n_vox)
            torch.cuda.synchronize()
            same = torch.equal(out_k, out_p)
            err = max(err, int((out_k - out_p).abs().max()))
            ok = ok and same and 0 < int(out_k.sum()) < part.numel() - 50_000
        rows.append({"threshold": threshold, "flagged": int(out_k.sum()),
                     "bit_identical": bool(same)})
    real = ids[:600_000].long()
    edge = int(((torch.isnan(occ[real]) | (count[real] < 0)) & ~torch.isposinf(occ[real])).sum())
    refused = refuses_misaligned(
        lambda: gather_cuda.gather_ndt_flags(occ, count, ids[3:], 3, n_vox))
    emit({"phase": "k4_ndt_flags", "tolerance": 0, "ids": ids.numel(), "sentinel_ids": 50_001,
          "nan_or_big_count_ids": edge, "cases": rows, "bit_identical": bool(ok),
          "misaligned_refused": refused})
    if not ok or edge == 0 or not refused:
        raise AssertionError(f"fused flag gather differs from its plain version: {rows}")
    return {"max_abs_err": err}


def _host_occupancy(m) -> dict:
    oi = m.layer_index(OCCUPANCY_LAYER)
    return {k: c.layers[oi][OCCUPANCY_LAYER].copy() for k, c in m.chunks.items()}


def phase_hardware_differential() -> None:
    rays = box_scene_rays(1024, np.random.default_rng(SEED))
    maps = {}
    for device in ("cuda", "cpu"):
        m = OccupancyMap(resolution=RESOLUTION, flags=MapFlag.NONE)
        mapper = TorchRayMapper(m, capacity=CAPACITY, validate=True, device=device)
        mapper.integrate_rays(rays)
        mapper.sync_voxels()
        maps[device] = m
    cpu_map = OccupancyMap(resolution=RESOLUTION, flags=MapFlag.NONE)
    RayMapperOccupancy(cpu_map).integrate_rays(rays)

    dev, port_cpu, ref = (_host_occupancy(m) for m in (maps["cuda"], maps["cpu"], cpu_map))
    bit_identical = dev.keys() == port_cpu.keys() and all(
        np.array_equal(dev[k].view(np.uint32), port_cpu[k].view(np.uint32)) for k in dev)
    gate = occupancy_gate(ref, dev, int(np.prod(cpu_map.region_voxel_dims)))
    ok = gate["ok"] and bit_identical
    emit({"metric": "hardware_differential", **{k: v for k, v in gate.items() if k != "ok"},
          "bit_identical_to_cpu": bool(bit_identical), "ok": bool(ok)})
    if not ok:
        raise AssertionError("GPU-vs-oracle differential failed")


def occupancy_gate(ref: dict, dev: dict, n_vox: int) -> dict:
    """bench.py's gate over region -> occupancy arrays: a voxel fails where
    one side is unobserved (inf) and the other not, or both differ by more
    than the tolerance; the failures' share and the worst difference are
    bounded."""
    worst, failures, compared = 0.0, 0, 0
    full = np.full(n_vox, np.inf, np.float32)
    for key in set(ref) | set(dev):
        a, b = ref.get(key, full), dev.get(key, full)
        inf_a, inf_b = np.isinf(a), np.isinf(b)
        compared += int((~inf_a | ~inf_b).sum())
        failures += int((inf_a != inf_b).sum())
        both = ~inf_a & ~inf_b
        if both.any():
            diff = np.abs(a[both] - b[both])
            worst = max(worst, float(diff.max()))
            failures += int((diff > GATE["tolerance"]).sum())
    ok = (compared > 0 and failures <= GATE["allowed_ratio"] * compared
          and worst <= GATE["worst_bound"])
    return {"compared_voxels": compared, "mismatches": failures, "worst_abs_diff": worst,
            "ok": bool(ok)}


def plane_rays(n, rng, z=0.0, extent=1.0, sensor=(0.0, 0.0, 2.0)):
    """Rays from a fixed sensor to samples on a horizontal plane
    (tests/test_ndt.py)."""
    samples = np.column_stack([rng.uniform(-extent, extent, n), rng.uniform(-extent, extent, n),
                               np.full(n, z) + rng.normal(0, 0.005, n)])
    rays = np.empty((2 * n, 3))
    rays[0::2] = sensor
    rays[1::2] = samples
    return rays


def ndt_scene(tm: bool):
    """tests/test_ndt.py's miss scene: a plane built in 50-ray batches, then
    60 rays through it in 30-ray batches; intensities for NDT-TM."""
    rng = np.random.default_rng(6)
    build = plane_rays(200, rng)
    n = 60
    through = np.empty((2 * n, 3))
    through[0::2] = (0.0, 0.0, 2.0)
    through[1::2] = np.column_stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.8, 0.8, n),
                                     np.full(n, -0.8)])
    batches = [build[i:i + 50] for i in range(0, build.shape[0], 50)]
    batches += [through[i:i + 30] for i in range(0, through.shape[0], 30)]
    intens = [rng.uniform(10.0, 20.0, len(b) // 2).astype(np.float32) if tm else None
              for b in batches]
    return batches, intens


def ndt_map_layers(m) -> dict:
    """region -> {layer name: host array} of an NDT map."""
    idx = {name: m.layer_index(name) for name in (
        OCCUPANCY_LAYER, MEAN_LAYER, COVARIANCE_LAYER, INTENSITY_LAYER, HIT_MISS_COUNT_LAYER)}
    out = {}
    for key, c in m.chunks.items():
        d = {"occupancy": c.layers[idx[OCCUPANCY_LAYER]][OCCUPANCY_LAYER],
             "coord": c.layers[idx[MEAN_LAYER]]["coord"],
             "count": c.layers[idx[MEAN_LAYER]]["count"],
             "cov": np.stack([c.layers[idx[COVARIANCE_LAYER]][f] for f in
                              ("P00", "P01", "P11", "P02", "P12", "P22")], axis=-1)}
        if idx[INTENSITY_LAYER] >= 0:
            d["intensity"] = np.stack([c.layers[idx[INTENSITY_LAYER]]["mean"],
                                       c.layers[idx[INTENSITY_LAYER]]["cov"]], axis=-1)
            d["hit_count"] = c.layers[idx[HIT_MISS_COUNT_LAYER]]["hit_count"]
            d["miss_count"] = c.layers[idx[HIT_MISS_COUNT_LAYER]]["miss_count"]
        out[key] = {k: np.array(v) for k, v in d.items()}
    return out


def run_ndt_port(device, tm: bool, rayflow: bool = True):
    """TorchNdtMap over ndt_scene; returns (map, stats)."""
    batches, intens = ndt_scene(tm)
    m = OccupancyMap(resolution=0.25, flags=MapFlag.NONE)
    mapper = TorchNdtMap(m, NdtParams(ndt_tm=tm), capacity=64, validate=True, device=device,
                         rayflow=rayflow)
    for rays, inten in zip(batches, intens):
        mapper.integrate_rays(rays, intensities=inten)
    mapper.sync_voxels()
    return m, mapper.stats


def compare_to_oracle(oracle_map, dev_map, tm: bool) -> dict:
    """tests/test_ndt.py's tolerances: occupancy within 5e-3 on all but 4%
    of voxels; mean counts equal and covariance within 5e-3 on active
    voxels; for NDT-TM (test_ndt_tm_layers) intensity mean within
    rtol 1e-3 / atol 1e-2, intensity covariance within rtol 0.5 / atol 0.3,
    hit counts within max(2, 10%)."""
    ref, dev = ndt_map_layers(oracle_map), ndt_map_layers(dev_map)
    compared = failures = 0
    worst = 0.0
    full = np.full(int(np.prod(oracle_map.region_voxel_dims)), np.inf, np.float32)
    for key in set(ref) | set(dev):
        a = ref[key]["occupancy"] if key in ref else full
        b = dev[key]["occupancy"] if key in dev else full
        inf_a, inf_b = np.isinf(a), np.isinf(b)
        compared += int((~inf_a | ~inf_b).sum())
        failures += int((inf_a != inf_b).sum())
        both = ~inf_a & ~inf_b
        if both.any():
            diff = np.abs(a[both] - b[both])
            worst = max(worst, float(diff.max()))
            failures += int((diff > 5e-3).sum())
    ok = compared > 0 and failures <= 0.04 * compared
    cov_worst, active_n = 0.0, 0
    for key, a in ref.items():
        b = dev.get(key)
        ok = ok and b is not None and np.array_equal(a["count"], b["count"])
        if b is None:
            continue
        act = a["count"] > 0
        active_n += int(act.sum())
        if act.any():
            cov_worst = max(cov_worst, float(np.abs(
                a["cov"][act].astype(np.float64) - b["cov"][act]).max()))
            if tm:
                ok = ok and np.allclose(b["intensity"][act, 0], a["intensity"][act, 0],
                                        rtol=1e-3, atol=1e-2)
                ok = ok and np.allclose(b["intensity"][act, 1], a["intensity"][act, 1],
                                        rtol=0.5, atol=0.3)
                ha = a["hit_count"][act].astype(np.int64)
                hb = b["hit_count"][act].astype(np.int64)
                ok = ok and np.abs(ha - hb).max() <= max(2, int(0.1 * ha.max()))
    ok = bool(ok and active_n > 0 and cov_worst <= 5e-3)
    return {"compared_voxels": compared, "mismatches": failures, "worst_abs_diff": worst,
            "active_voxels": active_n, "cov_worst_abs_diff": cov_worst, "ok": ok}


def compare_port(a_map, b_map) -> dict:
    """The port on two devices: the same voxels observed; occupancy, cov and
    intensity within PORT_TOL; counts equal; mean codes identical on at
    least 99.9% of active voxels and within one quantum per axis elsewhere."""
    a, b = ndt_map_layers(a_map), ndt_map_layers(b_map)
    ok = a.keys() == b.keys()
    worst = {"occupancy": 0.0, "cov": 0.0, "intensity": 0.0}
    active = code_same = 0
    code_step = 0
    for key in a.keys() & b.keys():
        x, y = a[key], b[key]
        ok = ok and np.array_equal(np.isinf(x["occupancy"]), np.isinf(y["occupancy"]))
        for name in worst:
            if name not in x:
                continue
            p, q = x[name], y[name]
            fin = np.isfinite(p) & np.isfinite(q)
            ok = ok and np.allclose(p[fin], q[fin], atol=PORT_TOL["atol"], rtol=PORT_TOL["rtol"])
            if fin.any():
                worst[name] = max(worst[name], float(np.abs(p[fin] - q[fin]).max()))
        for name in ("count", "hit_count", "miss_count"):
            if name in x:
                ok = ok and np.array_equal(x[name], y[name])
        act = x["count"] > 0
        active += int(act.sum())
        cx, cy = x["coord"][act], y["coord"][act]
        code_same += int((cx == cy).sum())
        for axis in range(3):
            qa = (cx >> (10 * axis)) & 1023
            qb = (cy >> (10 * axis)) & 1023
            code_step = max(code_step, int(np.abs(qa.astype(np.int64) - qb).max(initial=0)))
    share = code_same / max(active, 1)
    ok = bool(ok and active > 0 and share >= PORT_TOL["mean_code_identical"] and code_step <= 1)
    return {"worst_abs_diff": worst, "active_voxels": active, "mean_code_identical": share,
            "mean_code_max_quanta": code_step, "ok": ok}


def maps_bit_identical(a_map, b_map) -> bool:
    a, b = ndt_map_layers(a_map), ndt_map_layers(b_map)
    return a.keys() == b.keys() and all(
        np.array_equal(a[k][n].view(np.uint32), b[k][n].view(np.uint32))
        for k in a for n in a[k])


def phase_ndt_hardware_differential() -> None:
    rows = []
    for tm in (False, True):
        batches, intens = ndt_scene(tm)
        oracle_map = OccupancyMap(resolution=0.25, flags=MapFlag.NONE)
        oracle = RayMapperNdt(oracle_map, NdtParams(ndt_tm=tm))
        for rays, inten in zip(batches, intens):
            oracle.integrate_rays(rays, intensities=inten)
        card, stats = run_ndt_port("cuda", tm)
        card2, _ = run_ndt_port("cuda", tm)
        cpu, cpu_stats = run_ndt_port("cpu", tm)
        row = {"mode": "ndt_tm" if tm else "ndt_om",
               "oracle": compare_to_oracle(oracle_map, card, tm),
               "card_vs_cpu": compare_port(card, cpu),
               "card_runs_bit_identical": maps_bit_identical(card, card2),
               "stats": {k: stats[k] for k in ("ndt_flagged", "ndt_overflow", "missed_updates",
                                               "overflow", "compaction_dropped")},
               "stats_equal_cpu": stats == cpu_stats}
        row["ok"] = bool(row["oracle"]["ok"] and row["card_vs_cpu"]["ok"]
                         and row["card_runs_bit_identical"] and row["stats_equal_cpu"]
                         and stats["ndt_flagged"] > 0 and stats["ndt_overflow"] == 0)
        rows.append(row)
    emit({"metric": "ndt_hardware_differential", "cases": rows,
          "ok": all(r["ok"] for r in rows)})
    if not all(r["ok"] for r in rows):
        raise AssertionError("NDT GPU differential failed")


def profile_main_path(mapper, batches, path: str = "occupancy", intens=None,
                      stamps=None, ray_update_flags: int = 0) -> None:
    """torch.profiler over synchronous integrate_rays calls: device time by
    kernel and the device's idle share of the window."""
    torch.cuda.synchronize()
    with without_gc_pauses(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i, b in enumerate(batches):
            mapper.integrate_rays(b, intensities=None if intens is None else intens[i],
                                  timestamps=None if stamps is None else stamps[i],
                                  ray_update_flags=ray_update_flags)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # Device-side rows only (kernels, copies, memsets): the host-op rows
        # repeat their children's device time.
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append({"name": e.key[:90], "calls": e.count, "ms": us / 1e3})
    rows.sort(key=lambda r: -r["ms"])
    busy = sum(r["ms"] for r in rows)
    launches = sum(r["calls"] for r in rows)
    emit({"phase": "profile", "path": path, "batches": len(batches), "wall_ms": wall_ms,
          "device_busy_ms": busy if rows else "not measured",
          "device_idle_share": 1 - busy / wall_ms if rows else "not measured",
          "device_rows": len(rows), "device_launches_per_batch": launches / len(batches),
          "top_kernels": rows[:14]})


def sync_rays_per_sec(mapper, batches) -> float:
    """Rays/s of ``batches`` through synchronous integrate_rays, fenced by
    a synchronize, with the collector off, beside the reference's loop
    (``timed_integration``) on the same warm mapper: the worker's gain, if
    any, is their ratio."""
    torch.cuda.synchronize()
    elapsed = fenced_seconds(lambda: [mapper.integrate_rays(b) for b in batches], mapper.device)
    return sum(np.asarray(b).reshape(-1, 3).shape[0] // 2 for b in batches) / elapsed


def phase_bench(k1: dict) -> dict:
    rng = np.random.default_rng(SEED)
    m = OccupancyMap(resolution=RESOLUTION, flags=MapFlag.NONE)
    mapper = TorchRayMapper(m, capacity=CAPACITY, device="cuda")
    routes = log_routes(mapper)
    batches = [box_scene_rays(RAYS_PER_BATCH, rng) for _ in range(N_BATCHES)]

    # The main path, counted: every count is 0 just before it.  bench.py's
    # timed region (ohm_tpu_torch.bench), its warm-up included.
    expand_cuda.expand_keys.launches = 0
    deposit_cuda.deposit_and_sweep.launches = 0
    torch.cuda.reset_peak_memory_stats()
    rays_per_sec = timed_integration(mapper, batches, warmup=WARMUP)
    peak = torch.cuda.max_memory_allocated()
    launches = {"expand_keys": expand_cuda.expand_keys.launches,
                "deposit_and_sweep": deposit_cuda.deposit_and_sweep.launches}
    stats = mapper.stats
    for name in ("missed_updates", "overflow", "compaction_dropped", "dropped_updates"):
        if stats[name]:
            raise AssertionError(f"main path reported {name}={stats[name]}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    sync_rps = sync_rays_per_sec(mapper, batches)

    # Host prep alone, the device path on resident wires, then the same
    # with events around each stage.
    host_prep_ms, device_ms, wires, setups = device_and_host_ms(mapper, batches)
    occ = mapper.arena.occupancy
    stage = {"expand": 0.0, "sort": 0.0, "deposit": 0.0}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    for w, (_, cfg, _) in zip(wires, setups):
        ev[0].record()
        records, _ = expand_records(unpack_batch(w, cfg), cfg)
        ev[1].record()
        key_s = torch.sort(records["key"]).values
        ev[2].record()
        deposit_cuda.deposit_and_sweep(occ, key_s, cfg)
        ev[3].record()
        torch.cuda.synchronize()
        for i, name in enumerate(stage):
            stage[name] += ev[i].elapsed_time(ev[i + 1]) / N_BATCHES
    mapper._drain_stats()

    # Each kernel beside its plain version, at the main path's shapes.
    b, cfg = k1["wire"]
    k1_plain, k1_kern = plain_vs_kernel_ms(
        lambda: expand_cuda.expand_keys_reference(b, cfg),
        lambda: expand_cuda.expand_keys(b, cfg))
    # In the same call: the kernel alone.
    k1_alone = kernel_device_ms(lambda: expand_cuda.expand_keys(b, cfg), "expand_keys_kernel")
    cfg0 = setups[0][1]
    records, _ = expand_records(unpack_batch(wires[0], cfg0), cfg0)
    key_s = torch.sort(records["key"]).values
    occ_a, occ_b = occ.clone(), occ.clone()
    k2_plain, k2_kern = plain_vs_kernel_ms(
        lambda: deposit_cuda.deposit_and_sweep_reference(occ_a, key_s, cfg0),
        lambda: deposit_cuda.deposit_and_sweep(occ_b, key_s, cfg0))
    k2_prof = device_profile(lambda: deposit_cuda.deposit_and_sweep(occ_b, key_s, cfg0),
                             K2_KERNELS)
    # K2 must read each key and read and write each touched voxel.
    touched = int(deposit_cuda.deposit_and_sweep(occ.clone(), key_s, cfg0)[1])
    bounds = {"expand_keys": k1_bound(b, cfg, with_vox=False),
              "deposit_and_sweep": bound(4 * key_s.numel() + 8 * touched + 4,
                                         2 * key_s.numel() + 15 * touched)}

    profile_main_path(mapper, batches[:8])

    emit({"metric": "occupancy_integrate_rays_per_sec", "value": rays_per_sec,
          "unit": "rays/s", "sync_rays_per_sec": sync_rps, "batches": N_BATCHES,
          "warmup": WARMUP, "rays_per_batch": RAYS_PER_BATCH,
          "host_prep_ms_per_batch": host_prep_ms, "device_ms_per_batch": device_ms,
          "stage_ms_per_batch": stage, "keys_per_batch": int(records["key"].numel()),
          "wire_bytes_per_ray": setups[0][0].nbytes / RAYS_PER_BATCH,
          "kernel_ms": {"expand_keys": k1_kern, "deposit_and_sweep": k2_kern},
          "plain_ms": {"expand_keys": k1_plain, "deposit_and_sweep": k2_plain},
          "kernel_alone_ms": {"expand_keys": k1_alone, "deposit_and_sweep": k2_prof["kernel_ms"]},
          "deposit_and_sweep_device": k2_prof, "launches": launches,
          "stats": {k: stats[k] for k in ("missed_updates", "overflow", "compaction_dropped")},
          "max_memory_allocated_bytes": peak})
    return {"launches": launches, "ms": {"expand_keys": k1_kern, "deposit_and_sweep": k2_kern},
            "plain_ms": {"expand_keys": k1_plain, "deposit_and_sweep": k2_plain},
            "bound": bounds, "alone_ms": k1_alone, "k2_device": k2_prof, "routes": routes}


def phase_k1_trav(k1: dict) -> dict:
    """K1's traversal output, alone and beside the voxel planes, against its
    plain version on the box, corner and miss scenes: bit for bit."""
    rows = []
    for name, b, cfg, flags in k1["cases"]:
        for with_vox in (False, True):
            kw = {"exclude_origin": bool(flags & RayFlag.EXCLUDE_ORIGIN), "with_trav": True,
                  "with_vox": with_vox}
            rows.append({"scene": name, "with_vox": with_vox, **check_k1_call(((b, cfg), kw))})
            if not rows[-1]["bit_identical"]:
                raise AssertionError(f"expand kernel's traversal differs on {name}: {rows[-1]}")
    emit({"phase": "k1_trav", "tolerance": 0, "cases": rows})
    return {"max_abs_err": max(r["max_abs_err"] for r in rows)}


#: Host layer -> its members, as the side-layer checks read them.
LAYER_MEMBERS = {OCCUPANCY_LAYER: ("occupancy",), MEAN_LAYER: ("coord", "count"),
                 TRAVERSAL_LAYER: ("traversal",), TOUCH_TIME_LAYER: ("touch",),
                 INCIDENT_NORMAL_LAYER: ("packed_normal",)}


def layer_members(m) -> dict:
    """member -> {region: host array} over the occupancy map's layers."""
    out = {member: {} for members in LAYER_MEMBERS.values() for member in members}
    for layer, members in LAYER_MEMBERS.items():
        li = m.layer_index(layer)
        if li < 0:
            continue
        for key, c in m.chunks.items():
            for member in members:
                out[member][key] = np.array(c.layers[li][member])
    return {k: v for k, v in out.items() if v}


def layers_scene():
    """bench.py's 1024-ray box scan (seed 2024) in four 256-ray batches with
    per-ray timestamps.  (Given twice, the scan breaks bench.py's gate by
    one miss on a voxel a batch both hits and misses: the batch merges its
    counts where the oracle goes ray by ray, as tests/test_tpu_integrate.py
    allows for.)"""
    rays = box_scene_rays(1024, np.random.default_rng(SEED))
    batches = [rays[i:i + 512] for i in range(0, 2048, 512)]
    stamps = [100.0 + 10.0 * i + np.arange(256) * 1e-3 for i in range(4)]
    return batches, stamps


def run_layers(mapper):
    """Integrate layers_scene into ``mapper``'s map; returns its stats."""
    for rays, ts in zip(*layers_scene()):
        mapper.integrate_rays(rays, timestamps=ts)
    if hasattr(mapper, "sync_voxels"):
        mapper.sync_voxels()
        return mapper.stats
    return None


def code_agreement(a: dict, b: dict, fields) -> dict:
    """Share of identical codes over voxels either side wrote, and the
    largest difference in quanta of any packed (shift, mask) field."""
    xs = [a[k][(a[k] != 0) | (b[k] != 0)] for k in a]
    ys = [b[k][(a[k] != 0) | (b[k] != 0)] for k in a]
    x, y = np.concatenate(xs).astype(np.int64), np.concatenate(ys).astype(np.int64)
    steps = [int(np.abs(((x >> s) & m) - ((y >> s) & m)).max(initial=0)) for s, m in fields]
    return {"written": int(x.size), "identical": float((x == y).mean()) if x.size else 1.0,
            "max_quanta": max(steps)}


MEAN_FIELDS = [(0, 1023), (10, 1023), (20, 1023), (31, 1)]
NORMAL_FIELDS = [(0, 0x3FFF), (15, 0x3FFF), (30, 1), (31, 1)]


def compare_layers_to_oracle(ref: dict, dev: dict, resolution: float, n_vox: int) -> dict:
    """The port against the f64 oracle: occupancy under bench.py's gate;
    mean counts equal, mean positions within 2e-3 and traversal within
    atol 2e-3 / rtol 1e-3 (tests/test_tpu_integrate.py); touch times within
    0.002 s (tests/test_occupancy_oracle.py); the incident normal reported
    as the worst angle between the two (the reference merges a batch's
    directions in one weighted sum, the oracle sample by sample)."""
    row = {"occupancy": occupancy_gate(ref["occupancy"], dev["occupancy"], n_vox)}
    ok = row["occupancy"]["ok"] and ref["count"].keys() <= dev["count"].keys()
    mean_worst = trav_worst = touch_worst = angle_worst = 0.0
    for key, count in ref["count"].items():
        ok = ok and np.array_equal(count, dev["count"][key])
        act = count > 0
        ca = subvoxel.sub_voxel_to_local_coord(ref["coord"][key][act], resolution)
        cb = subvoxel.sub_voxel_to_local_coord(dev["coord"][key][act], resolution)
        if act.any():
            mean_worst = max(mean_worst, float(np.abs(ca - cb).max()))
        ta, tb = ref["traversal"][key], dev["traversal"][key]
        ok = ok and np.allclose(tb, ta, atol=2e-3, rtol=1e-3)
        trav_worst = max(trav_worst, float(np.abs(ta - tb).max()))
        ua, ub = ref["touch"][key], dev["touch"][key]
        ok = ok and np.array_equal(ua > 0, ub > 0)
        touch_worst = max(touch_worst,
                          float(np.abs(ua.astype(np.float64) - ub.astype(np.float64)).max()) * 1e-3)
        na, nb = ref["packed_normal"][key], dev["packed_normal"][key]
        both = (na != 0) & (nb != 0)
        if both.any():
            cos = np.sum(subvoxel.decode_normal(na[both]) * subvoxel.decode_normal(nb[both]), -1)
            angle_worst = max(angle_worst,
                              float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))).max()))
    ok = ok and mean_worst <= 2e-3 and touch_worst <= 0.002
    row.update(mean_worst_m=mean_worst, traversal_worst_m=trav_worst, touch_worst_s=touch_worst,
               incident_worst_deg=angle_worst,
               active_voxels=int(sum(int((c > 0).sum()) for c in ref["count"].values())),
               ok=bool(ok))
    return row


def compare_layers_to_cpu(dev: dict, cpu: dict) -> dict:
    """The port on the card against the port on the CPU: occupancy, mean
    counts and touch times bit-identical; traversal within PORT_TOL; mean
    and normal codes identical on >= 99.9% of written voxels and within one
    quantum elsewhere."""
    ok = all(dev[m].keys() == cpu[m].keys() for m in dev) and dev.keys() == cpu.keys()
    for member in ("occupancy", "count", "touch"):
        ok = ok and all(np.array_equal(dev[member][k].view(np.uint32), cpu[member][k].view(np.uint32))
                        for k in dev[member])
    trav_worst = max(float(np.abs(dev["traversal"][k] - cpu["traversal"][k]).max())
                     for k in dev["traversal"])
    ok = ok and all(np.allclose(dev["traversal"][k], cpu["traversal"][k], atol=PORT_TOL["atol"],
                                rtol=PORT_TOL["rtol"]) for k in dev["traversal"])
    mean = code_agreement(dev["coord"], cpu["coord"], MEAN_FIELDS)
    normal = code_agreement(dev["packed_normal"], cpu["packed_normal"], NORMAL_FIELDS)
    for codes in (mean, normal):
        ok = ok and codes["identical"] >= PORT_TOL["mean_code_identical"] and codes["max_quanta"] <= 1
    return {"traversal_worst_abs_diff": trav_worst, "mean_codes": mean, "normal_codes": normal,
            "ok": bool(ok)}


def phase_layers_hardware_differential() -> None:
    maps, stats = {}, {}
    for run in ("cuda", "cuda_again", "cpu"):
        m = OccupancyMap(resolution=RESOLUTION, flags=LAYER_FLAGS)
        stats[run] = run_layers(TorchRayMapper(m, capacity=CAPACITY, validate=True,
                                               device=run.split("_")[0]))
        maps[run] = layer_members(m)
    oracle_map = OccupancyMap(resolution=RESOLUTION, flags=LAYER_FLAGS)
    run_layers(RayMapperOccupancy(oracle_map))
    ref = layer_members(oracle_map)
    dev = maps["cuda"]
    bits = dev.keys() == maps["cuda_again"].keys() and all(
        dev[m].keys() == maps["cuda_again"][m].keys()
        and all(np.array_equal(v.view(np.uint32), maps["cuda_again"][m][k].view(np.uint32))
                for k, v in dev[m].items()) for m in dev)
    row = {"oracle": compare_layers_to_oracle(ref, dev, RESOLUTION,
                                              int(np.prod(oracle_map.region_voxel_dims))),
           "card_vs_cpu": compare_layers_to_cpu(dev, maps["cpu"]),
           "card_runs_bit_identical": bool(bits),
           "stats_equal_cpu": stats["cuda"] == stats["cpu"],
           "stats": {k: stats["cuda"][k] for k in ("batches", "missed_updates", "overflow",
                                                   "compaction_dropped")}}
    row["ok"] = bool(row["oracle"]["ok"] and row["card_vs_cpu"]["ok"] and bits
                     and row["stats_equal_cpu"] and dev.keys() == ref.keys())
    emit({"metric": "layers_hardware_differential", **row})
    if not row["ok"]:
        raise AssertionError("side-layer GPU differential failed")


def check_layers_path_calls(k1_call, k2_call, phase: str = "layers_kernel_checks") -> dict:
    """K1 and K2 against their plain versions on the arguments an
    occupancy path gave them: K1's keys, missed count and, where the call
    asked for it, traversal on every lane; K2's occupancy bits and touched
    count, each side on its own clone of the arena.  Bit for bit; prints
    the ``phase`` line and raises on any difference."""
    row = {"expand_keys": check_k1_call(k1_call), "deposit_and_sweep": check_k2_call(k2_call)}
    emit({"phase": phase, "tolerance": 0, **row})
    if not all(r["bit_identical"] for r in row.values()):
        raise AssertionError(f"a kernel differs from its plain version ({phase}): {row}")
    return {name: r["max_abs_err"] for name, r in row.items()}


def check_k2_call(k2_call) -> dict:
    """K2 against its plain version on one recorded call: occupancy bits and
    touched count, each side on its own clone of the arena, and some voxel
    changed."""
    (occ, key_s, cfg), _ = k2_call
    occ_k, touched_k = deposit_cuda.deposit_and_sweep(occ.clone(), key_s, cfg)
    occ_p, touched_p = deposit_cuda.deposit_and_sweep_reference(occ.clone(), key_s, cfg)
    torch.cuda.synchronize()
    changed = int((occ_k.view(torch.int32) != occ.view(torch.int32)).sum())
    ok = same_bits(occ_k, occ_p) and int(touched_k) == int(touched_p) and changed > 0
    return {"keys": key_s.numel(), "touched": int(touched_k), "changed": changed,
            "max_abs_err": finite_err(occ_k, occ_p), "bit_identical": bool(ok)}


def time_k2_call(k2_call) -> dict:
    """K2 beside its plain version on one recorded call's arguments (each
    on its own clone of the arena), alone, and its bound: each key read, each
    touched voxel read and written."""
    (occ, key_s, cfg), _ = k2_call
    occ_a, occ_b = occ.clone(), occ.clone()
    plain, kern = plain_vs_kernel_ms(
        lambda: deposit_cuda.deposit_and_sweep_reference(occ_a, key_s, cfg),
        lambda: deposit_cuda.deposit_and_sweep(occ_b, key_s, cfg))
    alone = kernel_device_ms(lambda: deposit_cuda.deposit_and_sweep(occ_b, key_s, cfg),
                             K2_KERNELS[0])
    touched = int(deposit_cuda.deposit_and_sweep(occ.clone(), key_s, cfg)[1])
    return {"ms": kern, "plain_ms": plain, "kernel_alone_ms": alone, "keys": key_s.numel(),
            "bound": bound(4 * key_s.numel() + 8 * touched + 4,
                           2 * key_s.numel() + 15 * touched)}


def phase_layers_bench() -> dict:
    rng = np.random.default_rng(SEED)
    torch.cuda.reset_peak_memory_stats()
    m = OccupancyMap(resolution=RESOLUTION, flags=LAYER_FLAGS)
    mapper = TorchRayMapper(m, capacity=CAPACITY, device="cuda")
    routes = log_routes(mapper)
    batches = [box_scene_rays(RAYS_PER_BATCH, rng) for _ in range(N_BATCHES)]
    stamps = [1000.0 + 0.1 * i + np.arange(RAYS_PER_BATCH) * 1e-5 for i in range(N_BATCHES)]
    mapper.prime_caps(batches)
    for i in range(WARMUP):
        mapper.integrate_rays(batches[i], timestamps=stamps[i])

    # One more batch, its kernel calls captured and each held against its
    # plain version; then K1 with traversal timed on the same arguments.
    with first_call_args(expand_cuda, "expand_keys") as k1_args, \
            first_call_args(deposit_cuda, "deposit_and_sweep") as k2_args:
        mapper.integrate_rays(batches[WARMUP], timestamps=stamps[WARMUP])
    torch.cuda.synchronize()
    errs = check_layers_path_calls(k1_args[0], k2_args[0])
    (b, cfg0), kw = k1_args[0]
    if not kw.get("with_trav"):
        raise AssertionError("the side-layer path did not ask K1 for the traversal")
    k1_plain, k1_kern = plain_vs_kernel_ms(
        lambda: expand_cuda.expand_keys_reference(b, cfg0, kw["exclude_origin"], with_trav=True),
        lambda: expand_cuda.expand_keys(b, cfg0, **kw))
    # The same arguments without the traversal output, and each kernel alone.
    keys_kw = dict(kw, with_trav=False)
    keys_plain, keys_kern = plain_vs_kernel_ms(
        lambda: expand_cuda.expand_keys_reference(b, cfg0, kw["exclude_origin"]),
        lambda: expand_cuda.expand_keys(b, cfg0, **keys_kw))
    alone = {"with_trav": kernel_device_ms(lambda: expand_cuda.expand_keys(b, cfg0, **kw),
                                           "expand_keys_kernel"),
             "keys_only": kernel_device_ms(lambda: expand_cuda.expand_keys(b, cfg0, **keys_kw),
                                           "expand_keys_kernel")}
    k1_bnd = k1_bound(b, cfg0, with_vox=False, with_trav=True)
    del k1_args, k2_args

    # The side-layer path, counted: every count is 0 just before it.
    counters = {"expand_keys": expand_cuda.expand_keys,
                "deposit_and_sweep": deposit_cuda.deposit_and_sweep}
    for fn in counters.values():
        fn.launches = 0
    batches_before = mapper.stats["batches"]
    torch.cuda.synchronize()
    with without_gc_pauses():
        t0 = time.perf_counter()
        for rays, ts in zip(batches, stamps):
            mapper.integrate_rays(rays, timestamps=ts)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    stats = mapper.stats
    for name in ("missed_updates", "overflow", "compaction_dropped", "dropped_updates"):
        if stats[name]:
            raise AssertionError(f"side-layer path reported {name}={stats[name]}")
    if min(launches.values()) <= 0 or launches["expand_keys"] != stats["batches"] - batches_before:
        raise AssertionError(f"K1 launches {launches} against {stats['batches'] - batches_before} "
                             f"batches on the side-layer path")
    peak = torch.cuda.max_memory_allocated()

    host_prep_ms, device_ms, wires, setups = device_and_host_ms(mapper, batches, stamps)
    # Device timeline per stage (CUDA events: what the device spent between
    # them, its waits on the host's dispatch included).
    layers = mapper.arena.layers
    stage = {"expand": 0.0, "apply": 0.0, "samples": 0.0}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    records_n = 0
    for w, (_, cfg, _) in zip(wires, setups):
        bb = unpack_batch(w, cfg)
        ev[0].record()
        records, _ = expand_records(bb, cfg)
        ev[1].record()
        apply_records(layers["occupancy"], records, cfg, traversal=layers["traversal"])
        ev[2].record()
        apply_sample_layers(layers, records, bb, cfg)
        ev[3].record()
        torch.cuda.synchronize()
        records_n = records["key"].numel()
        for i, name in enumerate(stage):
            stage[name] += ev[i].elapsed_time(ev[i + 1]) / N_BATCHES
    syncs = count_host_syncs(lambda: mapper.integrate_rays(batches[0], timestamps=stamps[0]))
    mapper._drain_stats()
    profile_main_path(mapper, batches[:8], path="occupancy_layers", stamps=stamps[:8])

    # What comes out: every layer written, values finite.
    mapper.sync_voxels()
    lay = layer_members(m)
    hits = sum(int(c.astype(np.int64).sum()) for c in lay["count"].values())
    written = {member: sum(int((v != 0).sum()) for v in lay[member].values())
               for member in ("coord", "traversal", "touch", "packed_normal")}
    finite = all(np.isfinite(v).all() for v in lay["traversal"].values())
    if hits == 0 or min(written.values()) == 0 or not finite:
        raise AssertionError(f"side-layer bench map: hits={hits} written={written} "
                             f"finite={finite}")
    rays_per_sec = RAYS_PER_BATCH * N_BATCHES / elapsed
    emit({"metric": "occupancy_layers_rays_per_sec", "value": rays_per_sec, "unit": "rays/s",
          "batches": N_BATCHES, "warmup": WARMUP, "rays_per_batch": RAYS_PER_BATCH,
          "resolution": RESOLUTION, "capacity": CAPACITY,
          "layers": sorted(mapper.arena.layers), "arena_bytes": sum(
              t.numel() * t.element_size() for t in mapper.arena.layers.values()),
          "host_prep_ms_per_batch": host_prep_ms, "device_ms_per_batch": device_ms,
          "stage_ms_per_batch": stage, "records_per_batch": records_n,
          "host_syncs_per_batch": syncs,
          "kernel_ms": {"expand_keys_with_trav": k1_kern, "expand_keys": keys_kern},
          "plain_ms": {"expand_keys_with_trav": k1_plain, "expand_keys": keys_plain},
          "kernel_alone_ms": alone,
          "bound": {"expand_keys_with_trav": k1_bnd,
                    "expand_keys": k1_bound(b, cfg0, with_vox=False)},
          "launches": launches,
          "written_voxels": written, "mean_hits": hits,
          "stats": {k: stats[k] for k in ("batches", "missed_updates", "overflow",
                                          "compaction_dropped")},
          "max_memory_allocated_bytes": peak})
    return {"launches": launches, "max_abs_err": errs, "ms": k1_kern, "plain_ms": k1_plain,
            "bound": k1_bnd, "alone_ms": alone["with_trav"], "routes": routes}


def phase_outdoor_mean_bench() -> dict:
    # scripts/bench_modes.py config 2: the batches through a .laz and back.
    rng = np.random.default_rng(OUTDOOR_SEED)
    m = OccupancyMap(resolution=OUTDOOR_RESOLUTION, flags=MapFlag.VOXEL_MEAN)
    mapper = TorchRayMapper(m, capacity=OUTDOOR_CAPACITY, device="cuda")
    routes = log_routes(mapper)
    synthetic = [outdoor_rays(RAYS_PER_BATCH, rng) for _ in range(OUTDOOR_BATCHES)]
    batches = laz_round_trip(synthetic, RAYS_PER_BATCH)

    # The reference's loop (timed_integration), counted: every count is 0
    # just before it.
    counters = {"expand_keys": expand_cuda.expand_keys,
                "deposit_and_sweep": deposit_cuda.deposit_and_sweep}
    zero_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    rays_per_sec = timed_integration(mapper, batches, warmup=OUTDOOR_WARMUP)
    peak = torch.cuda.max_memory_allocated()
    launches = read_counts(counters)
    stats = mapper.stats
    for name in ("missed_updates", "overflow", "compaction_dropped", "dropped_updates"):
        if stats[name]:
            raise AssertionError(f"outdoor mean path reported {name}={stats[name]}")
    if min(launches.values()) <= 0 or launches["expand_keys"] != stats["batches"]:
        raise AssertionError(f"outdoor mean path launches {launches} over "
                             f"{stats['batches']} batches")
    sync_rps = sync_rays_per_sec(mapper, batches)

    # One batch through the worker, its kernel calls captured and each held
    # against its plain version on the arguments this path gave it.
    with first_call_args(expand_cuda, "expand_keys") as k1_args, \
            first_call_args(deposit_cuda, "deposit_and_sweep") as k2_args:
        mapper.integrate_rays_async(batches[0])
        mapper.flush()
    torch.cuda.synchronize()
    errs = check_layers_path_calls(k1_args[0], k2_args[0], "outdoor_mean_kernel_checks")
    del k1_args, k2_args

    host_prep_ms, device_ms, _, setups = device_and_host_ms(mapper, batches)
    syncs = count_host_syncs(lambda: mapper.integrate_rays(batches[0]))
    mapper._drain_stats()
    profile_main_path(mapper, batches[:8], path="occupancy_mean_outdoor")
    mapper.sync_voxels()
    lay = layer_members(m)
    hits = sum(int(c.astype(np.int64).sum()) for c in lay["count"].values())
    observed = sum(int(np.isfinite(v).sum()) for v in lay["occupancy"].values())
    if hits == 0 or observed == 0:
        raise AssertionError(f"outdoor mean map: hits={hits} observed={observed}")
    emit({"metric": "occupancy_mean_outdoor_rays_per_sec", "value": rays_per_sec,
          "unit": "rays/s", "sync_rays_per_sec": sync_rps, "batches": len(batches),
          "dispatched_batches": stats["batches"],
          "warmup": OUTDOOR_WARMUP, "rays_per_batch": RAYS_PER_BATCH,
          "resolution": OUTDOOR_RESOLUTION, "capacity": OUTDOOR_CAPACITY,
          "source": "laz", "laz_rays": sum(len(b) // 2 for b in batches),
          "host_prep_ms_per_batch": host_prep_ms, "device_ms_per_batch": device_ms,
          "host_syncs_per_batch": syncs, "launches": launches,
          "max_memory_allocated_bytes": peak,
          "regions": len(m.chunks), "observed_voxels": observed, "mean_hits": hits,
          "wire_bytes_per_ray": setups[0][0].nbytes / RAYS_PER_BATCH,
          "stats": {k: stats[k] for k in ("batches", "missed_updates", "overflow",
                                          "compaction_dropped")}})
    return {"launches": launches, "max_abs_err": errs, "mapper": mapper, "routes": routes}


def _snapshot(x):
    """A copy of a call's argument as it is now: tensors copied with their
    strides (a row-strided view of the wire stays row-strided), through
    tuples and dicts (the NDT deposit updates the arena in place)."""
    if isinstance(x, torch.Tensor):
        if any(st == 0 and n > 1 for st, n in zip(x.stride(), x.shape)):
            return x.clone()
        return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                   device=x.device).copy_(x)
    if isinstance(x, (tuple, list)):
        return type(x)(_snapshot(v) for v in x)
    if isinstance(x, dict):
        return {k: _snapshot(v) for k, v in x.items()}
    return x


@contextlib.contextmanager
def first_call_args(module, name):
    """Within the block, record the (args, kwargs) of the first call of
    ``module.name`` as they were when it was called; the call still runs."""
    fn = getattr(module, name)
    seen = []

    def wrapper(*args, **kwargs):
        if not seen:
            seen.append((_snapshot(args), _snapshot(kwargs)))
        return fn(*args, **kwargs)
    wrapper.launches = 0  # the wrapped function counts under its module name
    setattr(module, name, wrapper)
    try:
        yield seen
    finally:
        setattr(module, name, fn)


def phase_ndt_om_bench() -> dict:
    rng = np.random.default_rng(SEED)
    m = OccupancyMap(resolution=NDT_RESOLUTION, flags=MapFlag.NONE)
    mapper = TorchNdtMap(m, capacity=NDT_CAPACITY, device="cuda")
    batches = [box_scene_rays(RAYS_PER_BATCH, rng) for _ in range(NDT_BATCHES)]

    # The NDT-OM path through the reference's loop (timed_integration),
    # counted: every count is 0 just before it.  K4's count too: the fused
    # flag gather took its place on this path, so its count must stay 0.
    counters = {"expand_keys": expand_cuda.expand_keys,
                "gather_ndt_flags": gather_cuda.gather_ndt_flags,
                "deposit_and_sweep_ndt": deposit_cuda.deposit_and_sweep_ndt,
                "gather_plane": gather_cuda.gather_plane}
    zero_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    rays_per_sec = timed_integration(mapper, batches, warmup=NDT_WARMUP)
    peak = torch.cuda.max_memory_allocated()
    launches = read_counts(counters)
    stats = mapper.stats
    for name in ("missed_updates", "overflow", "compaction_dropped", "dropped_updates"):
        if stats[name]:
            raise AssertionError(f"NDT-OM path reported {name}={stats[name]}")
    if min(n for name, n in launches.items() if name != "gather_plane") <= 0:
        raise AssertionError(f"a kernel of the NDT-OM path never launched: {launches}")
    if launches["gather_plane"]:
        raise AssertionError(f"the NDT-OM path built the flag plane and ran K4: {launches}")
    # Reading the stats drained them: miss_k, sized on the fourth batch,
    # escalated in the warm-up if it overflowed there; the synchronous pass
    # shows whether the sized miss_k holds.
    overflow_before = stats["ndt_overflow"]
    sync_rps = sync_rays_per_sec(mapper, batches)
    stats = mapper.stats
    timed_overflow = stats["ndt_overflow"] - overflow_before

    host_prep_ms, device_ms, wires, setups = device_and_host_ms(mapper, batches)

    # Each kernel beside its plain version on the arguments the path gave
    # it in one more batch.
    with first_call_args(expand_cuda, "expand_keys") as k1_args, \
            first_call_args(gather_cuda, "gather_ndt_flags") as kf_args, \
            first_call_args(deposit_cuda, "deposit_and_sweep_ndt") as k3_args:
        mapper._dispatch(wires[0], setups[0][1], setups[0][2])
    torch.cuda.synchronize()
    (b, cfg0), kw = k1_args[0]
    (occ_f, count, ids, threshold, sentinel), _ = kf_args[0]
    (occ, walk, end, delta, dcfg), k3_kw = k3_args[0]
    errs = check_ndt_path_calls(k1_args[0], kf_args[0], k3_args[0])
    kernel_ms, plain_ms = {}, {}
    plain_ms["expand_keys"], kernel_ms["expand_keys"] = plain_vs_kernel_ms(
        lambda: expand_cuda.expand_keys_reference(b, cfg0, kw["exclude_origin"], with_vox=True),
        lambda: expand_cuda.expand_keys(b, cfg0, **kw))

    # The flag gather three ways on the path's arguments, in one call: the
    # arena-wide flag plane (the plain version's build) and K4, the same
    # plane and index_select, and the fused kernel; each one's wrapper (CUDA
    # events) and device time alone; K4 and the fused kernel beside their
    # plain versions; K4 against index_select on a built plane, in
    # alternated turns.  (Each wrapper's host cost: the wrapper_cost line.)
    def build_plane():
        return (~torch.isposinf(occ_f) & ((count >= threshold) | (count < 0))).to(torch.int8)

    plane = build_plane()
    flags = {
        "plane_build_k4": lambda: gather_cuda.gather_plane(build_plane(), ids, sentinel),
        "plane_build_index_select": lambda: torch.index_select(build_plane(), 0, ids),
        "fused": lambda: gather_cuda.gather_ndt_flags(occ_f, count, ids, threshold, sentinel)}
    # The ids on this path stop at the sentinel, whose plane byte is 0 (+inf
    # occupancy), so index_select computes K4's values (as int8).
    want = gather_cuda.gather_ndt_flags(occ_f, count, ids, threshold, sentinel)
    if not all(same_bits(f().to(torch.int32), want) for f in flags.values()):
        raise AssertionError("the three flag gathers disagree on the NDT-OM path's arguments")
    flag_ms = alternated_ms(flags)
    flag_alone = {name: kernel_device_ms(f) for name, f in flags.items()}
    plain_ms["gather_ndt_flags"], kernel_ms["gather_ndt_flags"] = plain_vs_kernel_ms(
        lambda: gather_cuda.gather_ndt_flags_reference(occ_f, count, ids, threshold, sentinel),
        flags["fused"])
    plain_ms["gather_plane"], kernel_ms["gather_plane"] = plain_vs_kernel_ms(
        lambda: gather_cuda.gather_plane_reference(plane, ids, sentinel),
        lambda: gather_cuda.gather_plane(plane, ids, sentinel))
    k4_vs_lib = alternated_ms({
        "gather_plane": lambda: gather_cuda.gather_plane(plane, ids, sentinel),
        "index_select": lambda: torch.index_select(plane, 0, ids)})
    library_ms = {"gather_plane": k4_vs_lib["index_select"]["median_ms"],
                  "gather_ndt_flags": None}
    alone_ms = {"expand_keys": kernel_device_ms(lambda: expand_cuda.expand_keys(b, cfg0, **kw),
                                                "expand_keys_kernel"),
                "gather_plane": kernel_device_ms(
                    lambda: gather_cuda.gather_plane(plane, ids, sentinel), "PlaneSource"),
                "gather_ndt_flags": kernel_device_ms(flags["fused"], "NdtFlagSource"),
                "index_select": kernel_device_ms(lambda: torch.index_select(plane, 0, ids))}
    occ_a, occ_b = occ.clone(), occ.clone()
    plain_ms["deposit_and_sweep_ndt"], kernel_ms["deposit_and_sweep_ndt"] = plain_vs_kernel_ms(
        lambda: deposit_cuda.deposit_and_sweep_ndt_reference(occ_a, walk, end, delta, dcfg),
        lambda: deposit_cuda.deposit_and_sweep_ndt(occ_b, walk, end, delta, dcfg, **k3_kw))
    k3_prof = device_profile(
        lambda: deposit_cuda.deposit_and_sweep_ndt(occ_b, walk, end, delta, dcfg, **k3_kw),
        K3_KERNELS)
    alone_ms["deposit_and_sweep_ndt"] = k3_prof["kernel_ms"]
    dk, dv = delta
    changed = distinct(torch.cat([walk >> 1, end >> 1, (dk >> 1)[dv != 0]]), dcfg.sentinel)
    n_keys = walk.numel() + end.numel() + dk.numel()
    touched_ids = distinct(ids, sentinel)
    bounds = {"expand_keys": k1_bound(b, cfg0, with_vox=True),
              "gather_plane": bound(8 * ids.numel() + touched_ids, 2 * ids.numel()),
              # Per id: read it, write its flag; per distinct id: one word of
              # occupancy and one of mean_count; ~6 operations an id.
              "gather_ndt_flags": bound(8 * ids.numel() + 8 * touched_ids, 6 * ids.numel()),
              # What the function needs: per walk record, end key and delta
              # record theirs, per changed voxel its occupancy read and written.
              "deposit_and_sweep_ndt": bound(4 * walk.numel() + 4 * end.numel() + 8 * dk.numel()
                                             + 8 * changed + 4, 2 * n_keys + 18 * changed)}
    # What this design reads besides: the walk's bounds stream, 4 bytes a
    # walk record (not part of the bound).
    k3_design = bound(bounds["deposit_and_sweep_ndt"]["bound_bytes"] + 4 * walk.numel(),
                      2 * n_keys + 18 * changed)
    flag_gather = {"ids": ids.numel(), "arena_voxels": occ_f.numel(), "threshold": threshold,
                   "wrapper_ms": flag_ms, "device_ms_alone": flag_alone,
                   "k4_vs_index_select": k4_vs_lib, "kernel_alone_ms": alone_ms}
    emit({"phase": "ndt_flag_gather", **flag_gather})
    mapper._drain_stats()

    profile_main_path(mapper, batches[:8], path="ndt_om")
    emit({"metric": "ndt_om_rays_per_sec", "value": rays_per_sec, "unit": "rays/s",
          "sync_rays_per_sec": sync_rps, "batches": NDT_BATCHES, "warmup": NDT_WARMUP,
          "rays_per_batch": RAYS_PER_BATCH,
          "resolution": NDT_RESOLUTION, "capacity": NDT_CAPACITY, "miss_k": mapper.miss_k,
          "host_prep_ms_per_batch": host_prep_ms, "device_ms_per_batch": device_ms,
          "walk_keys_per_batch": walk.numel(), "k_stream": delta[0].numel(),
          "kernel_ms": kernel_ms, "plain_ms": plain_ms, "kernel_alone_ms": alone_ms,
          "deposit_and_sweep_ndt_device": k3_prof, "launches": launches,
          "timed_ndt_overflow": timed_overflow,
          "stats": {k: stats[k] for k in ("missed_updates", "overflow", "compaction_dropped",
                                          "ndt_overflow", "ndt_flagged")},
          "max_memory_allocated_bytes": peak})
    return {"launches": launches, "ms": kernel_ms, "plain_ms": plain_ms,
            "max_abs_err": errs, "bound": bounds, "library_ms": library_ms,
            "alone_ms": alone_ms, "flag_gather": flag_gather, "k3_device": k3_prof,
            "k3_design_bound": k3_design}


def check_k1_call(k1_call) -> dict:
    """K1 against its plain version on one recorded call, with the outputs
    that call asked for: keys and missed count, the overflow flags and the
    end voxel's enter times (the plain prelude's, NaN and signed zeros
    included); the traversal on every lane; the voxel planes on lanes whose
    key is not the sentinel.  Bit for bit."""
    (b, cfg), kw = k1_call
    excl = kw.get("exclude_origin", False)
    with_vox, with_trav = kw.get("with_vox", False), kw.get("with_trav", False)
    key_k, aux = expand_cuda.expand_keys(b, cfg, **kw)
    ref = expand_cuda.expand_keys_reference(b, cfg, excl, with_vox=with_vox, with_trav=with_trav)
    ref_aux = expand_cuda._prelude(b, cfg)[-1]
    key_p, missed_p = ref[0], ref[1]
    torch.cuda.synchronize()
    live = key_p != cfg.sentinel
    err = float((key_k.long() - key_p.long()).abs().max())
    err = max(err, finite_err(aux["end_enter"], ref_aux["end_enter"]))
    ok = (torch.equal(key_k, key_p) and int(aux["missed_n"]) == int(missed_p)
          and aux["overflow"].dtype == torch.bool
          and torch.equal(aux["overflow"], ref_aux["overflow"])
          and same_bits(aux["end_enter"], ref_aux["end_enter"]))
    row = {"lanes": key_k.numel(), "lanes_compared": int(live.sum()), "missed": int(missed_p),
           "overflow_rays": int(ref_aux["overflow"].sum()),
           "nan_end_enter": int(torch.isnan(ref_aux["end_enter"]).sum())}
    if with_vox:
        vk, vp = aux["vox"][live], ref[2][live]
        err = max(err, float((vk.long() - vp.long()).abs().max()) if vk.numel() else 0.0)
        ok = ok and torch.equal(vk, vp) and vk.numel() > 0
    if with_trav:
        tk, tp = aux["trav"], ref[-1]
        err = max(err, finite_err(tk, tp))
        ok = ok and same_bits(tk, tp) and bool((tp > 0).any())
        row["traversal_sum"] = float(tp.double().sum())
    return {**row, "max_abs_err": err, "bit_identical": bool(ok)}


def check_ndt_path_calls(k1_call, kf_call, k3_call, phase: str = "ndt_om_kernel_checks") -> dict:
    """Each kernel against its plain version on the arguments the NDT-OM
    path gave it (0.2 m voxels, 1024 slots, the intensity wire): K1's keys,
    missed count, overflow and end enter times, and its voxel planes on
    lanes whose key is not the sentinel; the fused flag gather's output, and
    K4 on the flag plane the plain version builds from the same arena; K3's
    occupancy bits and touched count, each run on its own clone of the
    arena.  Bit for bit; raises on any difference."""
    row = {"expand_keys": check_k1_call(k1_call), **check_ndt_kernel_calls(kf_call, k3_call)}
    emit({"phase": phase, "tolerance": 0, **row})
    if not all(r["bit_identical"] for r in row.values()):
        raise AssertionError(f"a kernel differs from its plain version ({phase}): {row}")
    return {name: r["max_abs_err"] for name, r in row.items()}


def check_ndt_kernel_calls(kf_call, k3_call) -> dict:
    """The fused flag gather (and K4 on the flag plane its plain version
    builds) and K3 against their plain versions on one recorded call each:
    rows with ``bit_identical``."""
    (occ_f, count, ids, threshold, sentinel), _ = kf_call
    out_k = gather_cuda.gather_ndt_flags(occ_f, count, ids, threshold, sentinel)
    out_p = gather_cuda.gather_ndt_flags_reference(occ_f, count, ids, threshold, sentinel)
    plane = (~torch.isposinf(occ_f) & ((count >= threshold) | (count < 0))).to(torch.int8)
    out_4 = gather_cuda.gather_plane(plane, ids, sentinel)
    kf_err = int((out_k - out_p).abs().max())
    kf_ok = torch.equal(out_k, out_p) and int(out_k.sum()) > 0
    k4_ok = torch.equal(out_4, out_p)

    (occ, walk, end, delta, dcfg), k3_kw = k3_call
    occ_k, touched_k = deposit_cuda.deposit_and_sweep_ndt(occ.clone(), walk, end, delta, dcfg,
                                                          **k3_kw)
    occ_p, touched_p = deposit_cuda.deposit_and_sweep_ndt_reference(
        occ.clone(), walk, end, delta, dcfg)
    torch.cuda.synchronize()
    fin = torch.isfinite(occ_k) & torch.isfinite(occ_p)
    k3_err = float((occ_k[fin] - occ_p[fin]).abs().max())
    changed = int((occ_k.view(torch.int32) != occ.view(torch.int32)).sum())
    k3_ok = (torch.equal(occ_k.view(torch.int32), occ_p.view(torch.int32))
             and int(touched_k) == int(touched_p) and changed > 0)

    return {"gather_ndt_flags": {"ids": ids.numel(), "threshold": threshold,
                                 "flagged": int(out_k.sum()), "max_abs_err": kf_err,
                                 "bit_identical": bool(kf_ok)},
            "gather_plane": {"ids": ids.numel(),
                             "max_abs_err": int((out_4 - out_p).abs().max()),
                             "bit_identical": bool(k4_ok)},
            "deposit_and_sweep_ndt": {"walk_keys": walk.numel(), "end_keys": end.numel(),
                                      "k_stream": delta[0].numel(), "touched": int(touched_k),
                                      "changed": changed, "max_abs_err": k3_err,
                                      "bit_identical": bool(k3_ok)}}


def phase_ndt_tm_frame() -> tuple[TorchNdtMap, float, float]:
    rng = np.random.default_rng(SEED)
    frame = box_scene_rays(TM_FRAME_RAYS, rng, half=TM_HALF)
    intens = rng.uniform(0.0, 1.0, TM_FRAME_RAYS).astype(np.float32)
    times = np.linspace(0.0, 0.1, TM_FRAME_RAYS)

    def tm_mapper():
        return TorchNdtMap(OccupancyMap(resolution=NDT_RESOLUTION, flags=MapFlag.NONE),
                           params=NdtParams(ndt_tm=True), capacity=NDT_CAPACITY,
                           miss_k=TM_MISS_K, device="cuda")

    # The frame through synchronous integrate_rays on a fresh map; then
    # through the worker on another (scripts/bench_modes.py config 5's
    # loop, integrate_frame).
    step = 2 * RAYS_PER_BATCH
    sync_mapper = tm_mapper()
    torch.cuda.synchronize()
    sync_seconds = fenced_seconds(lambda: [
        sync_mapper.integrate_rays(frame[i:i + step],
                                   intensities=intens[i // 2:i // 2 + RAYS_PER_BATCH],
                                   timestamps=times[i // 2:i // 2 + RAYS_PER_BATCH])
        for i in range(0, frame.shape[0], step)], sync_mapper.device)
    del sync_mapper
    mapper = tm_mapper()
    m = mapper.map
    torch.cuda.reset_peak_memory_stats()
    seconds = integrate_frame(mapper, frame, intens, times, RAYS_PER_BATCH, warmup=NDT_WARMUP)
    peak = torch.cuda.max_memory_allocated()
    stats = mapper.stats
    for name in ("missed_updates", "overflow", "compaction_dropped"):
        if stats[name]:
            raise AssertionError(f"NDT-TM frame reported {name}={stats[name]}")
    t0 = time.perf_counter()
    mapper.sync_voxels()
    sync_s = time.perf_counter() - t0
    lay = ndt_map_layers(m)
    observed = sum(int(np.isfinite(d["occupancy"]).sum()) for d in lay.values())
    finite = all(np.isfinite(d["cov"]).all() and np.isfinite(d["intensity"]).all()
                 for d in lay.values())
    if observed == 0 or not finite or stats["ndt_flagged"] == 0:
        raise AssertionError(f"NDT-TM frame: observed={observed} finite={finite} "
                             f"ndt_flagged={stats['ndt_flagged']}")

    # The frame's deposit: K3 on the arguments one more batch gave it (the
    # sparse delta), against its plain version and timed.
    with first_call_args(deposit_cuda, "deposit_and_sweep_ndt") as k3_args:
        mapper.integrate_rays(frame[:step], intensities=intens[:RAYS_PER_BATCH])
    torch.cuda.synchronize()
    (occ, walk, end, delta, dcfg), kw = k3_args[0]
    if not isinstance(delta, tuple):
        raise AssertionError("the NDT-TM mapper passed a dense delta plane")
    k3_row = check_k3(occ, walk, end, delta, dcfg, kw["bounds_key"])[0]
    occ_a, occ_b = occ.clone(), occ.clone()
    k3_row["plain_ms"], k3_row["ms"] = plain_vs_kernel_ms(
        lambda: deposit_cuda.deposit_and_sweep_ndt_reference(occ_a, walk, end, delta, dcfg),
        lambda: deposit_cuda.deposit_and_sweep_ndt(occ_b, walk, end, delta, dcfg, **kw))
    k3_row["device"] = device_profile(
        lambda: deposit_cuda.deposit_and_sweep_ndt(occ_b, walk, end, delta, dcfg, **kw),
        K3_KERNELS)
    emit({"metric": "ndt_tm_integrate_rays_per_sec", "value": TM_FRAME_RAYS / seconds,
          "unit": "rays/s", "seconds": seconds, "warmup": NDT_WARMUP,
          "sync_rays_per_sec": TM_FRAME_RAYS / sync_seconds, "sync_seconds": sync_seconds,
          "rays": TM_FRAME_RAYS,
          "batches": TM_FRAME_RAYS // RAYS_PER_BATCH, "miss_k": mapper.miss_k,
          "sync_voxels_s": sync_s, "observed_voxels": observed,
          "max_memory_allocated_bytes": peak, "deposit_and_sweep_ndt": k3_row,
          "stats": {k: stats[k] for k in ("ndt_overflow", "ndt_flagged", "missed_updates")}})
    return mapper, seconds, sync_seconds


NDT_SIDE_MEMBERS = {TRAVERSAL_LAYER: "traversal", TOUCH_TIME_LAYER: "touch",
                    INCIDENT_NORMAL_LAYER: "packed_normal"}


def ndt_side_layers(m) -> dict:
    """member -> {region: host array} of an NDT map's side layers."""
    out = {}
    for layer, member in NDT_SIDE_MEMBERS.items():
        li = m.layer_index(layer)
        if li >= 0:
            out[member] = {key: np.array(c.layers[li][member]) for key, c in m.chunks.items()}
    return out


def ndt_layers_scene(tm: bool):
    """ndt_scene with a timestamp per ray: (batches, intensities, stamps)."""
    batches, intens = ndt_scene(tm)
    stamps = [100.0 + i + np.arange(len(b) // 2) * 1e-3 for i, b in enumerate(batches)]
    return batches, intens, stamps


@contextlib.contextmanager
def every_call(module, name, pick):
    """Within the block, ``pick(args, kwargs)`` of every call of
    ``module.name``, in order; the calls still run."""
    fn = getattr(module, name)
    seen = []

    def wrapper(*args, **kwargs):
        seen.append(pick(args, kwargs))
        return fn(*args, **kwargs)
    wrapper.launches = 0  # the wrapped function counts under its module name
    setattr(module, name, wrapper)
    try:
        yield seen
    finally:
        setattr(module, name, fn)


def run_ndt_layers_port(device, tm: bool, rayflow: bool):
    """TorchNdtMap with traversal, touch time and incident normal over
    ndt_layers_scene; returns (map, stats, each batch's K3 walk and bounds
    key streams on the host)."""
    batches, intens, stamps = ndt_layers_scene(tm)
    m = OccupancyMap(resolution=0.25, flags=NDT_LAYER_FLAGS)
    mapper = TorchNdtMap(m, NdtParams(ndt_tm=tm), capacity=64, validate=True, device=device,
                         rayflow=rayflow)
    with every_call(deposit_cuda, "deposit_and_sweep_ndt",
                    lambda a, kw: (a[1].cpu(), kw["bounds_key"].cpu())) as keys:
        for rays, inten, ts in zip(batches, intens, stamps):
            mapper.integrate_rays(rays, intensities=inten, timestamps=ts)
    mapper.sync_voxels()
    return m, mapper.stats, keys


def compare_side_layers(a: dict, b: dict) -> dict:
    """Two runs of the port: touch times equal, traversal within PORT_TOL,
    normal codes identical on >= 99.9% of written voxels and within one
    quantum elsewhere."""
    ok = a.keys() == b.keys() and all(a[m].keys() == b[m].keys() for m in a)
    ok = ok and all(np.array_equal(a["touch"][k], b["touch"][k]) for k in a["touch"])
    trav = max(float(np.abs(a["traversal"][k] - b["traversal"][k]).max())
               for k in a["traversal"])
    ok = ok and all(np.allclose(a["traversal"][k], b["traversal"][k], atol=PORT_TOL["atol"],
                                rtol=PORT_TOL["rtol"]) for k in a["traversal"])
    normal = code_agreement(a["packed_normal"], b["packed_normal"], NORMAL_FIELDS)
    ok = (ok and normal["identical"] >= PORT_TOL["mean_code_identical"]
          and normal["max_quanta"] <= 1 and normal["written"] > 0)
    return {"traversal_worst_abs_diff": trav, "normal_codes": normal, "ok": bool(ok)}


def side_layers_to_oracle(ref: dict, dev: dict) -> dict:
    """The side layers against the f64 oracle: traversal within rtol 1e-3 /
    atol 2e-3 (tests/test_ndt.py's traversal test), touch times within
    2 ms; the incident normal reported as the worst angle."""
    ok = ref.keys() == dev.keys()
    trav = touch = angle = 0.0
    for key, ta in ref["traversal"].items():
        tb = dev["traversal"][key]
        ok = ok and np.allclose(tb, ta, rtol=1e-3, atol=2e-3)
        trav = max(trav, float(np.abs(ta - tb).max()))
        ua, ub = ref["touch"][key].astype(np.int64), dev["touch"][key].astype(np.int64)
        ok = ok and np.array_equal(ua > 0, ub > 0)
        touch = max(touch, float(np.abs(ua - ub).max()))
        na, nb = ref["packed_normal"][key], dev["packed_normal"][key]
        both = (na != 0) & (nb != 0)
        if both.any():
            cos = np.sum(subvoxel.decode_normal(na[both]) * subvoxel.decode_normal(nb[both]), -1)
            angle = max(angle, float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))).max()))
    ok = ok and touch <= 2
    return {"traversal_worst_m": trav, "touch_worst_ms": touch, "incident_worst_deg": angle,
            "ok": bool(ok)}


def phase_ndt_layers_hardware_differential() -> None:
    rows = []
    for tm in (False, True):
        batches, intens, stamps = ndt_layers_scene(tm)
        oracle_map = OccupancyMap(resolution=0.25, flags=NDT_LAYER_FLAGS)
        oracle = RayMapperNdt(oracle_map, NdtParams(ndt_tm=tm))
        for rays, inten, ts in zip(batches, intens, stamps):
            oracle.integrate_rays(rays, intensities=inten, timestamps=ts)
        for rayflow in (True, False):
            card, stats, keys = run_ndt_layers_port("cuda", tm, rayflow)
            card2, _, _ = run_ndt_layers_port("cuda", tm, rayflow)
            cpu, cpu_stats, cpu_keys = run_ndt_layers_port("cpu", tm, rayflow)
            side = ndt_side_layers(card)
            keys_equal = len(keys) == len(cpu_keys) > 0 and all(
                torch.equal(w, cw) and torch.equal(bk, cbk)
                for (w, bk), (cw, cbk) in zip(keys, cpu_keys))
            occ = [(x["occupancy"].view(np.uint32), y["occupancy"].view(np.uint32))
                   for x, y in zip(ndt_map_layers(card).values(), ndt_map_layers(cpu).values())]
            side2 = ndt_side_layers(card2)
            row = {"mode": "ndt_tm" if tm else "ndt_om", "wire": "rayflow" if rayflow
                   else "segmented",
                   "oracle": compare_to_oracle(oracle_map, card, tm),
                   "side_layers_oracle": side_layers_to_oracle(ndt_side_layers(oracle_map), side),
                   "card_vs_cpu": compare_port(card, cpu),
                   "side_layers_card_vs_cpu": compare_side_layers(side, ndt_side_layers(cpu)),
                   "walk_keys_equal_cpu": bool(keys_equal),
                   "occupancy_bits_identical_cpu": float(np.mean(np.concatenate(
                       [x == y for x, y in occ]))),
                   "card_runs_bit_identical": bool(maps_bit_identical(card, card2) and all(
                       np.array_equal(v.view(np.uint32), side2[m][k].view(np.uint32))
                       for m in side for k, v in side[m].items())),
                   "stats": {k: stats[k] for k in ("segments", "ndt_flagged", "ndt_overflow",
                                                   "missed_updates", "overflow",
                                                   "compaction_dropped")},
                   "stats_equal_cpu": stats == cpu_stats}
            row["ok"] = bool(row["oracle"]["ok"] and row["side_layers_oracle"]["ok"]
                             and row["card_vs_cpu"]["ok"] and row["side_layers_card_vs_cpu"]["ok"]
                             and keys_equal and row["card_runs_bit_identical"]
                             and row["stats_equal_cpu"] and stats["ndt_flagged"] > 0)
            rows.append(row)
    emit({"metric": "ndt_layers_hardware_differential", "cases": rows,
          "ok": all(r["ok"] for r in rows)})
    if not all(r["ok"] for r in rows):
        raise AssertionError("NDT side-layer GPU differential failed")


def time_ndt_layers_calls(k1_call, kf_call, k3_call) -> dict:
    """K1 (voxel planes and traversal), the fused flag gather and K3 on the
    arguments the side-layer NDT path gave them: each call beside its plain
    version in turns, each kernel alone, and each one's bound."""
    (b, cfg0), kw = k1_call
    (occ_f, count, ids, threshold, sentinel), _ = kf_call
    (occ, walk, end, delta, dcfg), k3_kw = k3_call
    occ_a, occ_b = occ.clone(), occ.clone()
    calls = {
        "expand_keys": (
            lambda: expand_cuda.expand_keys_reference(b, cfg0, kw["exclude_origin"],
                                                      with_vox=True, with_trav=True),
            lambda: expand_cuda.expand_keys(b, cfg0, **kw), "expand_keys_kernel"),
        "gather_ndt_flags": (
            lambda: gather_cuda.gather_ndt_flags_reference(occ_f, count, ids, threshold,
                                                           sentinel),
            lambda: gather_cuda.gather_ndt_flags(occ_f, count, ids, threshold, sentinel),
            "NdtFlagSource"),
        "deposit_and_sweep_ndt": (
            lambda: deposit_cuda.deposit_and_sweep_ndt_reference(occ_a, walk, end, delta, dcfg),
            lambda: deposit_cuda.deposit_and_sweep_ndt(occ_b, walk, end, delta, dcfg, **k3_kw),
            K3_KERNELS)}
    ms, plain_ms, alone_ms = {}, {}, {}
    for name, (plain, kern, kernel_name) in calls.items():
        plain_ms[name], ms[name] = plain_vs_kernel_ms(plain, kern)
        alone_ms[name] = device_profile(kern, kernel_name)["kernel_ms"]
    dk, dv = delta
    changed = distinct(torch.cat([walk >> 1, end >> 1, (dk >> 1)[dv != 0]]), dcfg.sentinel)
    n_keys = walk.numel() + end.numel() + dk.numel()
    bounds = {"expand_keys": k1_bound(b, cfg0, with_vox=True, with_trav=True),
              "gather_ndt_flags": bound(8 * ids.numel() + 8 * distinct(ids, sentinel),
                                        6 * ids.numel()),
              "deposit_and_sweep_ndt": bound(4 * walk.numel() + 4 * end.numel()
                                             + 8 * dk.numel() + 8 * changed + 4,
                                             2 * n_keys + 18 * changed)}
    return {"ms": ms, "plain_ms": plain_ms, "alone_ms": alone_ms, "bound": bounds,
            "walk_keys": walk.numel(), "k_stream": dk.numel()}


def phase_ndt_layers_bench() -> dict:
    rng = np.random.default_rng(SEED)
    m = OccupancyMap(resolution=NDT_RESOLUTION, flags=NDT_LAYER_FLAGS)
    mapper = TorchNdtMap(m, capacity=NDT_CAPACITY, device="cuda")
    routes = log_routes(mapper)
    n = NDT_LAYERS_BATCHES
    batches = [box_scene_rays(RAYS_PER_BATCH, rng) for _ in range(n)]
    stamps = [1000.0 + 0.1 * i + np.arange(RAYS_PER_BATCH) * 1e-5 for i in range(n)]
    mapper.prime_caps(batches)
    for i in range(NDT_WARMUP):
        mapper.integrate_rays(batches[i % n], timestamps=stamps[i % n])
    overflow_before = mapper.stats["ndt_overflow"]

    # One more batch, its kernel calls captured and each held against its
    # plain version, then timed on the same arguments.
    with first_call_args(expand_cuda, "expand_keys") as k1_args, \
            first_call_args(gather_cuda, "gather_ndt_flags") as kf_args, \
            first_call_args(deposit_cuda, "deposit_and_sweep_ndt") as k3_args:
        mapper.integrate_rays(batches[0], timestamps=stamps[0])
    torch.cuda.synchronize()
    if not (k1_args[0][1].get("with_vox") and k1_args[0][1].get("with_trav")):
        raise AssertionError("the NDT side-layer path did not ask K1 for voxels and traversal")
    errs = check_ndt_path_calls(k1_args[0], kf_args[0], k3_args[0], "ndt_layers_kernel_checks")
    errs.pop("gather_plane")
    timing = time_ndt_layers_calls(k1_args[0], kf_args[0], k3_args[0])
    del k1_args, kf_args, k3_args

    # The side-layer NDT path, counted: every count is 0 just before it.
    counters = {"expand_keys": expand_cuda.expand_keys,
                "gather_ndt_flags": gather_cuda.gather_ndt_flags,
                "deposit_and_sweep_ndt": deposit_cuda.deposit_and_sweep_ndt,
                "gather_plane": gather_cuda.gather_plane}
    for fn in counters.values():
        fn.launches = 0
    batches_before = mapper.stats["batches"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with without_gc_pauses():
        t0 = time.perf_counter()
        for rays, ts in zip(batches, stamps):
            mapper.integrate_rays(rays, timestamps=ts)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {name: fn.launches for name, fn in counters.items()}
    stats = mapper.stats
    for name in ("missed_updates", "overflow", "compaction_dropped", "dropped_updates"):
        if stats[name]:
            raise AssertionError(f"NDT side-layer path reported {name}={stats[name]}")
    dispatched = stats["batches"] - batches_before
    if (min(n for name, n in launches.items() if name != "gather_plane") <= 0
            or launches["expand_keys"] != dispatched or launches["gather_plane"]):
        raise AssertionError(f"NDT side-layer path launches {launches} over {dispatched} batches")

    host_prep_ms, device_ms, _, _ = device_and_host_ms(mapper, batches, stamps)
    syncs = count_host_syncs(lambda: mapper.integrate_rays(batches[0], timestamps=stamps[0]))
    mapper._drain_stats()
    profile_main_path(mapper, batches[:8], path="ndt_layers", stamps=stamps[:8])

    # What comes out: every side layer written, values finite.
    mapper.sync_voxels()
    side = ndt_side_layers(m)
    written = {member: sum(int(np.count_nonzero(v)) for v in side[member].values())
               for member in side}
    lay = ndt_map_layers(m)
    finite = all(np.isfinite(v).all() for v in side["traversal"].values()) and all(
        np.isfinite(d["cov"]).all() for d in lay.values())
    if min(written.values()) == 0 or not finite or stats["ndt_flagged"] == 0:
        raise AssertionError(f"NDT side-layer bench map: written={written} finite={finite}")
    emit({"metric": "ndt_layers_rays_per_sec", "value": RAYS_PER_BATCH * n / elapsed,
          "unit": "rays/s", "batches": n, "warmup": NDT_WARMUP,
          "rays_per_batch": RAYS_PER_BATCH, "resolution": NDT_RESOLUTION,
          "capacity": NDT_CAPACITY, "miss_k": mapper.miss_k,
          "layers": sorted(mapper.arena.layers), "arena_bytes": sum(
              t.numel() * t.element_size() for t in mapper.arena.layers.values()),
          "host_prep_ms_per_batch": host_prep_ms, "device_ms_per_batch": device_ms,
          "host_syncs_per_batch": syncs, "launches": launches,
          "kernel_ms": timing["ms"], "plain_ms": timing["plain_ms"],
          "kernel_alone_ms": timing["alone_ms"], "bound": timing["bound"],
          "walk_keys_per_batch": timing["walk_keys"], "k_stream": timing["k_stream"],
          "timed_ndt_overflow": stats["ndt_overflow"] - overflow_before,
          "written_voxels": written,
          "stats": {k: stats[k] for k in ("missed_updates", "overflow", "compaction_dropped",
                                          "ndt_overflow", "ndt_flagged")},
          "max_memory_allocated_bytes": peak})
    return {"launches": launches, "max_abs_err": errs, "routes": routes, **timing}


def phase_queries(outdoor_mapper, tm_mapper) -> dict:
    """scripts/bench_modes.py's query rows on the port: RaysQuery on the
    outdoor mean map, the clearance field of the NDT-TM frame's map; each
    against the port on the CPU."""
    rng = np.random.default_rng(QUERY_SEED)
    qrays = outdoor_rays(QUERY_RAYS, rng)
    q = RaysQuery(mapper=outdoor_mapper)
    lat = []
    for _ in range(QUERY_EXECUTES):
        q.set_rays(qrays)
        t0 = time.perf_counter()
        q.execute()
        lat.append(time.perf_counter() - t0)
    lat = sorted(lat[1:])  # the first execute builds the upload path's caches
    call = q._prepare_device_call()
    dev_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        with without_gc_pauses():
            t0 = time.perf_counter()
            for _ in range(QUERY_REDISPATCHES):
                rays_query_device(*call)
            torch.cuda.synchronize()
        dev_ms.append((time.perf_counter() - t0) / QUERY_REDISPATCHES * 1e3)
    prof = device_profile(lambda: rays_query_device(*call))
    on_cpu = RaysQuery(outdoor_mapper.map, device="cpu")
    on_cpu.set_rays(qrays)
    on_cpu.execute()
    keys = [LineKeysQuery(outdoor_mapper.map, device=d) for d in ("cuda", "cpu")]
    for k in keys:
        k.set_rays(qrays)
        k.execute()
    rays_ok = (np.array_equal(q.terminal_states, on_cpu.terminal_states)
               and np.array_equal(q.intersected_voxels, on_cpu.intersected_voxels)
               and np.allclose(q.ranges, on_cpu.ranges, rtol=1e-5, atol=0)
               and np.allclose(q.unobserved_volumes, on_cpu.unobserved_volumes, rtol=1e-5, atol=0)
               and len(set(q.terminal_states.tolist())) >= 2)
    keys_ok = (np.array_equal(keys[0].result_counts, keys[1].result_counts)
               and all(np.array_equal(a, b) for a, b in zip(keys[0].result_keys,
                                                            keys[1].result_keys)))

    # The clearance field of the NDT-TM frame's map: cold, warm, then after
    # a 16,384-ray delta in one corner, the dirty regions only (sync_voxels
    # stamps every resident region it writes, as the reference's does).
    m5 = tm_mapper.map
    cp = ClearanceProcess(m5, search_radius=CLEARANCE_RADIUS, device="cuda")
    t0 = time.perf_counter()
    cp.update(force=True)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_full = cp.update(force=True)
    warm = time.perf_counter() - t0
    ci = m5.layer_index(CLEARANCE_LAYER)
    full_card = {k: c.layers[ci][CLEARANCE_LAYER].copy() for k, c in m5.chunks.items()}
    ClearanceProcess(m5, search_radius=CLEARANCE_RADIUS, device="cpu").update(force=True)
    full_ok = all(np.array_equal(v.view(np.uint32),
                                 m5.chunks[k].layers[ci][CLEARANCE_LAYER].view(np.uint32))
                  for k, v in full_card.items())
    within = sum(int((v >= 0).sum()) for v in full_card.values())
    delta = box_scene_rays(CLEARANCE_DELTA_RAYS, rng, half=(3.0, 3.0, 3.0),
                           sensor=(10.0, 10.0, 2.0))
    tm_mapper.integrate_rays(delta, intensities=rng.uniform(0.0, 1.0, CLEARANCE_DELTA_RAYS)
                             .astype(np.float32))
    tm_mapper.sync_voxels()
    dirty = [k for k, c in m5.chunks.items() if cp._processed_stamps.get(k, -1) < c.dirty_stamp]
    t0 = time.perf_counter()
    n_inc = cp.update()
    incremental = time.perf_counter() - t0
    inc_card = {k: m5.chunks[k].layers[ci][CLEARANCE_LAYER].copy() for k in dirty}
    ClearanceProcess(m5, search_radius=CLEARANCE_RADIUS, device="cpu").update(dirty, force=True)
    inc_ok = n_inc == len(dirty) > 0 and all(
        np.array_equal(v.view(np.uint32), m5.chunks[k].layers[ci][CLEARANCE_LAYER].view(np.uint32))
        for k, v in inc_card.items())
    row = {"rays_query_p50_ms": lat[len(lat) // 2] * 1e3, "rays": QUERY_RAYS,
           "executes_ms": [x * 1e3 for x in lat],
           "device_ms_per_query": min(dev_ms), "redispatch_ms": dev_ms,
           "rays_query_device": prof, "segments": int(decode(call[1], call[2])["valid"].sum()),
           "terminal_states": {int(s): int((q.terminal_states == s).sum())
                               for s in set(q.terminal_states.tolist())},
           "rays_query_card_vs_cpu": bool(rays_ok), "line_keys_card_vs_cpu": bool(keys_ok),
           "line_keys": int(keys[0].result_counts.sum()),
           "clearance_sec": warm, "clearance_cold_sec": cold, "clearance_regions": n_full,
           "clearance_within_radius_voxels": within,
           "clearance_card_vs_cpu": bool(full_ok),
           "clearance_incremental_sec": incremental, "clearance_incremental_regions": n_inc,
           "clearance_incremental_card_vs_cpu": bool(inc_ok),
           "search_radius": CLEARANCE_RADIUS, "delta_rays": CLEARANCE_DELTA_RAYS}
    row["ok"] = bool(rays_ok and keys_ok and full_ok and inc_ok and within > 0)
    emit({"metric": "queries", **row})
    if not row["ok"]:
        raise AssertionError("the queries differ between the card and the CPU")
    return row


def _tsdf_config_at_bench_shape():
    """The base config of the TSDF configuration (0.1 m, 32^3 regions,
    1024 slots)."""
    return TorchTsdfMap(OccupancyMap(resolution=RESOLUTION, flags=MapFlag.NONE),
                        capacity=TSDF_CAPACITY, device="cuda")._config(0)


def _special_planes(rng, n_vox):
    """Two f32 planes of n_vox + 1 voxels: normal values with -0.0, +-inf,
    NaN payloads and denormals scattered among them (host arrays)."""
    out = []
    for _ in range(2):
        p = rng.normal(0.0, 2.0, n_vox + 1).astype(np.float32)
        at = rng.choice(n_vox, 200_000, replace=False)
        p[at[:100_000]] = np.array([-0.0, np.inf, -np.inf, 1e-40, -1e-42],
                                   np.float32)[np.arange(100_000) % 5]
        p.view(np.uint32)[at[100_000:]] = np.array(
            [0x7FC00000, 0x7FA00001, 0xFFC12345], np.uint32)[np.arange(100_000) % 3]
        out.append(p)
    return out


def _sorted_ids(rng, cfg, n, n_sentinel):
    """~n ascending ids over 320 live slots, then sentinel padding."""
    live = rng.integers(0, 320, n) * cfg.voxels_per_region
    return np.concatenate([np.sort(live + rng.integers(0, cfg.voxels_per_region, n)),
                           np.full(n_sentinel, cfg.sentinel)]).astype(np.int32)


def phase_k5() -> dict:
    cfg = _tsdf_config_at_bench_shape()
    rng = np.random.default_rng(SEED)
    planes = tuple(torch.from_numpy(p).cuda() for p in _special_planes(rng, cfg.sentinel))
    ids = torch.from_numpy(_sorted_ids(rng, cfg, 1_100_000, 100_000)).cuda()
    out_k = gather_cuda.gather_planes_f32(planes, ids, cfg.sentinel)
    out_p = gather_cuda.gather_planes_f32_reference(planes, ids, cfg.sentinel)
    torch.cuda.synchronize()
    ok = all(same_bits(a, b) for a, b in zip(out_k, out_p))
    ok = ok and all(int((o[-100_000:].view(torch.int32) != 0).sum()) == 0 for o in out_k)
    err = max(finite_err(a, b) for a, b in zip(out_k, out_p))
    row = {"ids": ids.numel(), "sentinel_ids": 100_000, "channels": len(planes),
           "nan": int(torch.isnan(out_k[0]).sum()), "inf": int(torch.isinf(out_k[0]).sum()),
           "negative_zero": int((out_k[0].view(torch.int32) == -2**31).sum()),
           "max_abs_err": err, "bit_identical": bool(ok)}
    emit({"phase": "k5_gather_f32", "tolerance": 0, **row})
    if not ok or row["nan"] == 0 or row["negative_zero"] == 0:
        raise AssertionError(f"f32 gather kernel differs from its plain version: {row}")
    return {"max_abs_err": err}


def phase_k6() -> dict:
    cfg = _tsdf_config_at_bench_shape()
    rng = np.random.default_rng(SEED)
    weight, distance = (torch.from_numpy(p).cuda() for p in _special_planes(rng, cfg.sentinel))
    ids = _sorted_ids(rng, cfg, 1_150_000, 50_000)
    last = np.concatenate([ids[1:] != ids[:-1], [True]]) & (ids < cfg.sentinel)
    dep = last & (rng.random(ids.size) < 0.9)
    w = np.where(dep, rng.uniform(1e-5, 1e4, ids.size), 0.0).astype(np.float32)
    d = np.where(dep, rng.uniform(-0.1, 0.1, ids.size), 0.0).astype(np.float32)
    k = np.flatnonzero(dep)
    d[k[:40_000]] = np.array([-0.0, -0.05, np.inf, np.nan], np.float32)[np.arange(40_000) % 4]
    w[-50_000:] = 1.0  # sentinel records never store
    args = [torch.from_numpy(x).cuda() for x in (ids, w, d)]
    out_k = deposit_cuda.tsdf_set_deposit(weight.clone(), distance.clone(), *args, cfg.sentinel)
    out_p = deposit_cuda.tsdf_set_deposit_reference(weight.clone(), distance.clone(), *args,
                                                    cfg.sentinel)
    torch.cuda.synchronize()
    ok = all(same_bits(a, b) for a, b in zip(out_k, out_p))
    changed = int((out_k[1].view(torch.int32) != distance.view(torch.int32)).sum())
    err = max(finite_err(a, b) for a, b in zip(out_k, out_p))
    row = {"records": ids.size, "depositing": int(dep.sum()), "arena_voxels": cfg.sentinel,
           "negative_distances": int((d[dep] < 0).sum()),
           "negative_zero_distances": int((d[dep].view(np.uint32) == 0x80000000).sum()),
           "changed_distances": changed, "max_abs_err": err, "bit_identical": bool(ok)}
    emit({"phase": "k6_tsdf_deposit", "tolerance": 0, **row})
    if not ok or changed < 0.9 * row["depositing"]:
        raise AssertionError(f"TSDF deposit kernel differs from its plain version: {row}")
    return {"max_abs_err": err}


def tsdf_layers(m) -> dict:
    """region -> (weight, distance) host arrays of a TSDF map."""
    idx = m.layer_index(TSDF_LAYER)
    return {k: (np.array(c.layers[idx]["weight"]), np.array(c.layers[idx]["distance"]))
            for k, c in m.chunks.items()}


def tsdf_card_vs_cpu(dev: dict, host: dict) -> dict:
    """Two tsdf_layers of one scene, the card's and the CPU's: the same
    regions, weights equal, distances within PORT_TOL."""
    ok, worst = dev.keys() == host.keys() and len(dev) > 0, 0.0
    for key in dev.keys() & host.keys():
        (wa, da), (wb, db) = dev[key], host[key]
        ok = ok and np.array_equal(wa, wb) and np.allclose(
            da, db, atol=PORT_TOL["atol"], rtol=PORT_TOL["rtol"])
        worst = max(worst, float(np.abs(da - db).max()))
    return {"worst_abs_diff": worst, "ok": bool(ok)}


def tsdf_sphere_batches():
    """tests/test_tsdf.py's differential scene: 150 rays from the origin to
    a 2 m sphere, in 30-ray batches."""
    rng = np.random.default_rng(12)
    dirs = rng.normal(size=(150, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    rays = np.zeros((300, 3))
    rays[1::2] = dirs * 2.0
    return [rays[i:i + 60] for i in range(0, 300, 60)]


def run_tsdf_port(device, rayflow: bool = True):
    m = OccupancyMap(resolution=0.25, flags=MapFlag.NONE)
    mapper = TorchTsdfMap(m, TsdfOptions(default_truncation_distance=0.3), capacity=64,
                          validate=True, device=device, rayflow=rayflow)
    for rays in tsdf_sphere_batches():
        mapper.integrate_rays(rays)
    mapper.sync_voxels()
    return m, mapper.stats


def phase_tsdf_hardware_differential() -> None:
    oracle_map = OccupancyMap(resolution=0.25, flags=MapFlag.NONE)
    oracle = RayMapperTsdf(oracle_map, TsdfOptions(default_truncation_distance=0.3))
    for rays in tsdf_sphere_batches():
        oracle.integrate_rays(rays)
    card, stats = run_tsdf_port("cuda")
    card2, _ = run_tsdf_port("cuda")
    cpu, cpu_stats = run_tsdf_port("cpu")
    ref, dev, dev2, host = (tsdf_layers(m) for m in (oracle_map, card, card2, cpu))
    # tests/test_tsdf.py compare_tsdf: every oracle region present; on voxels
    # either side touched, weights within rtol 1e-5 / atol 1e-4, distances
    # within 5e-3.
    ok_oracle, checked, worst_oracle = ref.keys() <= dev.keys(), 0, 0.0
    for key, (wa, da) in ref.items():
        wb, db = dev.get(key, (np.zeros_like(wa), np.zeros_like(da)))
        act = (wa > 0) | (wb > 0)
        checked += int(act.sum())
        if act.any():
            worst_oracle = max(worst_oracle, float(np.abs(da[act] - db[act]).max()))
            ok_oracle = ok_oracle and np.allclose(wa[act], wb[act], rtol=1e-5, atol=1e-4)
    ok_oracle = bool(ok_oracle and checked > 0 and worst_oracle <= 5e-3)
    card_vs_cpu = tsdf_card_vs_cpu(dev, host)
    bits = dev.keys() == dev2.keys() and all(
        np.array_equal(a.view(np.uint32), b.view(np.uint32))
        for k in dev for a, b in zip(dev[k], dev2[k]))
    row = {"oracle": {"checked_voxels": checked, "worst_abs_diff": worst_oracle,
                      "ok": ok_oracle},
           "card_vs_cpu": card_vs_cpu,
           "card_runs_bit_identical": bool(bits), "stats_equal_cpu": stats == cpu_stats,
           "stats": {k: stats[k] for k in ("batches", "missed_updates", "overflow",
                                           "compaction_dropped", "dropped_updates")}}
    row["ok"] = bool(ok_oracle and card_vs_cpu["ok"] and bits and row["stats_equal_cpu"])
    emit({"metric": "tsdf_hardware_differential", **row})
    if not row["ok"]:
        raise AssertionError("TSDF GPU differential failed")


def tsdf_visits_bounds(ids, w, sentinel: int, depositing: int) -> tuple[dict, dict]:
    """The fused per-visit call's bound: the bytes the function needs (a
    record's 4-byte id and 4-byte w * sdf, its 4-byte weight where the
    weights are not uniform, (w0, d0) of each distinct voxel, the (w, d)
    each depositing record stores) or TSDF_VISIT_OPS a record, whichever
    is longer; and the same for the bytes this design moves: w0 is read at
    each distinct voxel but d0 only at each depositing record, and each
    1024-record row writes its two columns of the carry table (28 bytes a
    level) and its two ready counts."""
    n, voxels = ids.numel(), distinct(ids, sentinel)
    wb = 0 if w is None else 4
    rows = -(-n // tsdf_cuda.ROW)
    levels = 1 + max(0, (rows - 1).bit_length())
    ops = TSDF_VISIT_OPS * n
    return (bound((8 + wb) * n + 8 * voxels + 8 * depositing, ops),
            bound((8 + wb) * n + 4 * voxels + 12 * depositing + (28 * levels + 8) * rows, ops))


def check_tsdf_visits(weight, distance, ids, w, wsdf, trunc, max_weight, sentinel) -> dict:
    """The fused kernel, its plain version and the kernel again, each on
    clones of the planes: both planes bit for bit, and the same bits on
    the second run."""
    outs = []
    for fn in (tsdf_cuda.tsdf_visits, tsdf_cuda.tsdf_visits_reference, tsdf_cuda.tsdf_visits):
        planes = (weight.clone(), distance.clone())
        fn(*planes, ids, w, wsdf, trunc, max_weight, sentinel)
        outs.append(planes)
    torch.cuda.synchronize()
    (wk, dk), (wp, dp), (wk2, dk2) = outs
    return {"records": ids.numel(), "uniform": w is None,
            "stored_voxels": int((wp.view(torch.int32) != weight.view(torch.int32)).sum()),
            "max_abs_err": max(finite_err(wk, wp), finite_err(dk, dp)),
            "bit_identical": same_bits(wk, wp) and same_bits(dk, dp),
            "runs_bit_identical": same_bits(wk, wk2) and same_bits(dk, dk2)}


def _tsdf_full_size(cfg, rng) -> tuple:
    """The fused call's arguments at full size: ~1.2M ascending ids over 320
    of 1024 slots with a sentinel tail; stored weights in [0, 50) on 70% of
    the arena and distances in the band, TSDF_SPECIALS on 100,000 voxels of
    each plane; sdf beyond the band both ways; non-uniform weights in
    [0, 2) (a tenth 0)."""
    n_vox = cfg.sentinel
    weight = np.where(rng.random(n_vox + 1) < 0.7, rng.uniform(0.0, 50.0, n_vox + 1),
                      0.0).astype(np.float32)
    distance = rng.uniform(-0.1, 0.1, n_vox + 1).astype(np.float32)
    for plane in (weight, distance):
        plane[rng.choice(n_vox, 100_000, replace=False)] = TSDF_SPECIALS[
            np.arange(100_000) % TSDF_SPECIALS.size]
    ids = _sorted_ids(rng, cfg, 1_150_000, 50_000)
    w = rng.uniform(0.0, 2.0, ids.size).astype(np.float32)
    w[(rng.random(ids.size) < 0.1) | (ids == cfg.sentinel)] = 0.0
    sdf = rng.uniform(-0.25, 0.25, ids.size).astype(np.float32)
    return tuple(torch.from_numpy(x).cuda() for x in (weight, distance, ids, w, sdf, w * sdf))


def phase_tsdf_visits() -> dict:
    cfg = _tsdf_config_at_bench_shape()
    rows = {}
    for name in TSDF_VISIT_STREAMS:
        st = tsdf_visit_stream(name, cfg.sentinel, seed=SEED)
        w = None if st["w"] is None else torch.from_numpy(st["w"]).cuda()
        rows[name] = check_tsdf_visits(
            *(torch.from_numpy(st[k]).cuda() for k in ("weight", "distance", "ids")), w,
            torch.from_numpy(st["wsdf"]).cuda(), st["trunc"], st["max_weight"], cfg.sentinel)
    weight, distance, ids, w, sdf, wsdf = _tsdf_full_size(cfg, np.random.default_rng(SEED))
    trunc, max_weight = float(np.float32(0.1)), 1e4
    rows["full_uniform"] = check_tsdf_visits(weight, distance, ids, None, sdf, trunc,
                                             max_weight, cfg.sentinel)
    rows["full_weighted"] = check_tsdf_visits(weight, distance, ids, w, wsdf, trunc,
                                              max_weight, cfg.sentinel)
    ok = all(r["bit_identical"] and r["runs_bit_identical"] for r in rows.values())
    # Uniform weights store every voxel but those whose seed is NaN or -inf.
    ok = ok and rows["full_uniform"]["stored_voxels"] > 0.9 * distinct(ids, cfg.sentinel)
    emit({"phase": "tsdf_visits", "tolerance": 0, "bit_identical": bool(ok), "streams": rows})
    if not ok:
        raise AssertionError(f"the fused TSDF kernel differs from its plain version: {rows}")
    return {"max_abs_err": max(r["max_abs_err"] for r in rows.values())}


def _path_kernel_args(visits_call) -> dict:
    """The fused call's captured arguments, and K5's and K6's derived from
    them: K5 on its ids and planes, K6 on the deposits of the plain chain."""
    (weight, distance, ids, w, wsdf, trunc, max_weight, sentinel), _ = visits_call
    seeds = gather_cuda.gather_planes_f32_reference((weight, distance), ids, sentinel)
    dw, dd = tsdf_cuda.tsdf_visit_deposits(*seeds, ids, w, wsdf, trunc, max_weight, sentinel)
    return {"visits": (weight, distance, ids, w, wsdf, trunc, max_weight, sentinel),
            "k5": ((weight, distance), ids, sentinel),
            "k6": (weight, distance, ids, dw, dd, sentinel)}


def check_tsdf_path_calls(k1_call, visits_call) -> dict:
    """Each kernel against its plain version on the arguments the TSDF path
    gave it (0.1 m voxels, 1024 slots): K1's keys, missed count and voxel
    planes on lanes whose key is not the sentinel; the fused per-visit
    kernel's two planes (and a second run); K5's two planes and K6's two
    planes on the arguments derived from the fused call's, each side run on
    its own clones.  Bit for bit; raises on any difference."""
    k1_row = check_k1_call(k1_call)
    args = _path_kernel_args(visits_call)
    visits_row = check_tsdf_visits(*args["visits"])

    planes, ids, sentinel = args["k5"]
    out_k = gather_cuda.gather_planes_f32(planes, ids, sentinel)
    out_p = gather_cuda.gather_planes_f32_reference(planes, ids, sentinel)
    k5_err = max(finite_err(a, b) for a, b in zip(out_k, out_p))
    k5_ok = all(same_bits(a, b) for a, b in zip(out_k, out_p))

    weight, distance, dids, w, d, dsentinel = args["k6"]
    dep_k = deposit_cuda.tsdf_set_deposit(weight.clone(), distance.clone(), dids, w, d,
                                          dsentinel)
    dep_p = deposit_cuda.tsdf_set_deposit_reference(weight.clone(), distance.clone(), dids,
                                                    w, d, dsentinel)
    torch.cuda.synchronize()
    k6_err = max(finite_err(a, b) for a, b in zip(dep_k, dep_p))
    depositing = int(((dids < dsentinel) & (w > 0)).sum())
    k6_ok = all(same_bits(a, b) for a, b in zip(dep_k, dep_p)) and depositing > 0

    row = {"expand_keys": k1_row, "tsdf_visits": visits_row,
           "gather_planes_f32": {"ids": ids.numel(), "max_abs_err": k5_err,
                                 "bit_identical": bool(k5_ok)},
           "tsdf_set_deposit": {"records": dids.numel(), "depositing": depositing,
                                "max_abs_err": k6_err, "bit_identical": bool(k6_ok)}}
    emit({"phase": "tsdf_kernel_checks", "tolerance": 0, **row})
    if not (k1_row["bit_identical"] and visits_row["bit_identical"]
            and visits_row["runs_bit_identical"] and visits_row["stored_voxels"] > 0
            and k5_ok and k6_ok):
        raise AssertionError(f"a kernel differs from its plain version on the TSDF path: {row}")
    return {name: r["max_abs_err"] for name, r in row.items()}


def time_tsdf_path_calls(k1_call, visits_call) -> dict:
    """Each kernel beside its plain version on the TSDF path's arguments
    (K5's and K6's derived from the fused call's), its bound, and the time
    of the PyTorch calls that compute the same function: K5 = index_select
    of each plane (the ids stop at the sentinel, whose +0.0 the planes
    hold), K6 = index_put_ of each plane at the ids of the depositing
    records (the masking outside the timing); no one call computes the
    fused kernel's function.  The fused kernel also beside the chain the
    path ran before it (K5, the scans between, K6) in alternated turns, and
    alone (its four kernels' device time, its device operations a call)."""
    (b, cfg), kw = k1_call
    args = _path_kernel_args(visits_call)
    planes, ids, sentinel = args["k5"]
    weight, distance, dids, w, d, dsentinel = args["k6"]
    kernel_ms, plain_ms, library_ms = {}, {}, {}
    plain_ms["expand_keys"], kernel_ms["expand_keys"] = plain_vs_kernel_ms(
        lambda: expand_cuda.expand_keys_reference(b, cfg, kw["exclude_origin"], with_vox=True),
        lambda: expand_cuda.expand_keys(b, cfg, **kw))
    k1_alone = kernel_device_ms(lambda: expand_cuda.expand_keys(b, cfg, **kw),
                                "expand_keys_kernel")
    plain_ms["gather_planes_f32"], kernel_ms["gather_planes_f32"] = plain_vs_kernel_ms(
        lambda: gather_cuda.gather_planes_f32_reference(planes, ids, sentinel),
        lambda: gather_cuda.gather_planes_f32(planes, ids, sentinel))
    wa, da, wb, db = weight.clone(), distance.clone(), weight.clone(), distance.clone()
    plain_ms["tsdf_set_deposit"], kernel_ms["tsdf_set_deposit"] = plain_vs_kernel_ms(
        lambda: deposit_cuda.tsdf_set_deposit_reference(wa, da, dids, w, d, dsentinel),
        lambda: deposit_cuda.tsdf_set_deposit(wb, db, dids, w, d, dsentinel))

    # The fused call, each side updating its own clones of the planes in place.
    rest = args["visits"][2:]
    va, vb, vc = ((weight.clone(), distance.clone()) for _ in range(3))
    plain_ms["tsdf_visits"], kernel_ms["tsdf_visits"] = plain_vs_kernel_ms(
        lambda: tsdf_cuda.tsdf_visits_reference(*va, *rest),
        lambda: tsdf_cuda.tsdf_visits(*vb, *rest))

    def k5_scans_k6():
        seeds = gather_cuda.gather_planes_f32(vc, ids, sentinel)
        pair = tsdf_cuda.tsdf_visit_deposits(*seeds, *rest)
        deposit_cuda.tsdf_set_deposit(*vc, ids, *pair, sentinel)

    fused_turns = alternated_ms({"fused": lambda: tsdf_cuda.tsdf_visits(*vb, *rest),
                                 "k5_scans_k6": k5_scans_k6})
    visits_device = device_profile(lambda: tsdf_cuda.tsdf_visits(*vb, *rest),
                                   TSDF_VISITS_KERNELS)

    def select():
        return tuple(torch.index_select(p, 0, ids) for p in planes)

    library_ms["gather_planes_f32"] = None
    if all(same_bits(a, c) for a, c in zip(select(), gather_cuda.gather_planes_f32(
            planes, ids, sentinel))):
        library_ms["gather_planes_f32"] = cuda_ms(select)
    library_ms["tsdf_visits"] = None
    mask = (dids < dsentinel) & (w > 0)
    idx, wv, dv = dids[mask].long(), w[mask], d[mask]
    wl, dl = weight.clone(), distance.clone()

    def put():
        wl.index_put_((idx,), wv)
        dl.index_put_((idx,), dv)

    put()
    library_ms["tsdf_set_deposit"] = (cuda_ms(put) if same_bits(wl, wb) and same_bits(dl, db)
                                      else None)
    # K5 and K6 against their library calls in six alternated turns: the
    # medians, and the turns each side won.
    versus = {}
    for name, kernel, library in (
            ("gather_planes_f32", lambda: gather_cuda.gather_planes_f32(planes, ids, sentinel),
             select),
            ("tsdf_set_deposit",
             lambda: deposit_cuda.tsdf_set_deposit(wb, db, dids, w, d, dsentinel), put)):
        turns = alternated_ms({"kernel": kernel, "library": library})
        versus[name] = {**turns, "kernel_wins": sum(
            k < lib for k, lib in zip(turns["kernel"]["turns_ms"], turns["library"]["turns_ms"]))}
    depositing = int(mask.sum())
    visits_bound, visits_design = tsdf_visits_bounds(ids, rest[1], sentinel, depositing)
    bounds = {"expand_keys": k1_bound(b, cfg, with_vox=True),
              "gather_planes_f32": bound(12 * ids.numel() + 8 * distinct(ids, sentinel),
                                         2 * ids.numel()),
              "tsdf_set_deposit": bound(12 * dids.numel() + 8 * depositing, 2 * dids.numel()),
              "tsdf_visits": visits_bound}
    fused = {"kernel_alone_ms": visits_device["kernel_ms"],
             "device_ms_per_call": visits_device["device_ms"],
             "device_ops_per_call": visits_device["device_ops"],
             "design_bound_ms": visits_design["bound_ms"],
             "design_bound_bytes": visits_design["bound_bytes"],
             "k5_scans_k6_ms": fused_turns["k5_scans_k6"]["median_ms"],
             "versus_k5_scans_k6": {**fused_turns, "fused_wins": sum(
                 f < c for f, c in zip(fused_turns["fused"]["turns_ms"],
                                       fused_turns["k5_scans_k6"]["turns_ms"]))}}
    return {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound": bounds,
            "records": ids.numel(), "depositing": depositing, "k1_alone_ms": k1_alone,
            "versus_library": versus, "fused": fused}


def phase_tsdf_bench() -> dict:
    rng = np.random.default_rng(SEED)
    torch.cuda.reset_peak_memory_stats()
    m = OccupancyMap(resolution=RESOLUTION, flags=MapFlag.NONE)
    mapper = TorchTsdfMap(m, capacity=TSDF_CAPACITY, device="cuda")
    batches = [box_scene_rays(RAYS_PER_BATCH, rng) for _ in range(TSDF_BATCHES)]

    # The TSDF path through the reference's loop (timed_integration),
    # counted: every count is 0 just before it.  The fused kernel took K5's
    # and K6's place there: theirs must stay 0.
    counters = {"expand_keys": expand_cuda.expand_keys,
                "tsdf_visits": tsdf_cuda.tsdf_visits,
                "gather_planes_f32": gather_cuda.gather_planes_f32,
                "tsdf_set_deposit": deposit_cuda.tsdf_set_deposit}
    zero_counts(counters)
    rays_per_sec = timed_integration(mapper, batches, warmup=TSDF_WARMUP)
    launches = read_counts(counters)
    stats = mapper.stats
    for name in ("missed_updates", "overflow", "compaction_dropped", "dropped_updates"):
        if stats[name]:
            raise AssertionError(f"TSDF path reported {name}={stats[name]}")
    if min(launches["expand_keys"], launches["tsdf_visits"]) <= 0:
        raise AssertionError(f"a kernel of the TSDF path never launched: {launches}")
    if launches["gather_planes_f32"] or launches["tsdf_set_deposit"]:
        raise AssertionError(f"K5 or K6 launched on the TSDF path: {launches}")
    peak = torch.cuda.max_memory_allocated()
    sync_rps = sync_rays_per_sec(mapper, batches)

    # One more batch, its kernel calls captured and each held against its
    # plain version; then the same arguments timed.
    with first_call_args(expand_cuda, "expand_keys") as k1_args, \
            first_call_args(tsdf_cuda, "tsdf_visits") as visits_args:
        mapper.integrate_rays(batches[0])
    torch.cuda.synchronize()
    errs = check_tsdf_path_calls(k1_args[0], visits_args[0])
    calls = time_tsdf_path_calls(k1_args[0], visits_args[0])
    del k1_args, visits_args
    torch.cuda.synchronize()

    host_prep_ms, device_ms, _, _ = device_and_host_ms(mapper, batches)
    mapper._drain_stats()
    profile_main_path(mapper, batches[:8], path="tsdf")

    # What comes out: observed voxels with finite, truncated distances.
    mapper.sync_voxels()
    trunc = np.float32(mapper.options.default_truncation_distance)
    lay = tsdf_layers(m)
    observed = sum(int((w > 0).sum()) for w, _ in lay.values())
    sane = all(np.isfinite(d).all() and (np.abs(d) <= trunc).all() and (w >= 0).all()
               and (w <= np.float32(mapper.options.max_weight)).all() for w, d in lay.values())
    if observed == 0 or not sane:
        raise AssertionError(f"TSDF bench map: observed={observed} sane={sane}")
    emit({"metric": "tsdf_rays_per_sec", "value": rays_per_sec, "unit": "rays/s",
          "sync_rays_per_sec": sync_rps, "batches": TSDF_BATCHES, "warmup": TSDF_WARMUP,
          "rays_per_batch": RAYS_PER_BATCH,
          "resolution": RESOLUTION, "capacity": TSDF_CAPACITY,
          "host_prep_ms_per_batch": host_prep_ms, "device_ms_per_batch": device_ms,
          "records_per_batch": calls["records"], "depositing_per_batch": calls["depositing"],
          "kernel_ms": calls["ms"], "plain_ms": calls["plain_ms"],
          "kernel_alone_ms": {"expand_keys": calls["k1_alone_ms"],
                              "tsdf_visits": calls["fused"]["kernel_alone_ms"]},
          "tsdf_visits": calls["fused"],
          "library_ms": calls["library_ms"], "versus_library": calls["versus_library"],
          "launches": launches,
          "observed_voxels": observed,
          "stats": {k: stats[k] for k in ("missed_updates", "overflow", "compaction_dropped",
                                          "dropped_updates")},
          "max_memory_allocated_bytes": peak})
    return {**calls, "launches": launches, "max_abs_err": errs}


def extended_rays(rays, reach: float):
    """The same rays with their ends moved out to ``reach`` times their
    length from the sensor."""
    out = np.array(rays, dtype=np.float64)
    out[1::2] = out[0::2] + (out[1::2] - out[0::2]) * reach
    return out


def clearing_rays(n, rng, scan=None):
    """A clearing batch from the box scene's sensor: rays past the walls
    (CLEARING_REACH times the distance), the first half along ``scan``'s
    rays (through the wall voxels they hit), the rest in new directions."""
    rays = extended_rays(box_scene_rays(n, rng), CLEARING_REACH)
    if scan is not None:
        rays[:n] = extended_rays(scan[:n], CLEARING_REACH)
    return rays


def zero_counts(counters: dict) -> None:
    """Set each kernel wrapper's launch count to 0."""
    for c in counters.values():
        c.launches = 0


def read_counts(counters: dict) -> dict:
    """Each kernel wrapper's launch count, by name."""
    return {name: c.launches for name, c in counters.items()}


def segmented_device_and_host_ms(mapper, batches, flags: int = 0):
    """device_and_host_ms on the segmented wire: host prep alone (segment,
    quantise, allocate, corner slots, pack), then the device path on
    resident uploads, per batch; returns (host_prep_ms, device_ms, uploads,
    setups)."""
    with without_gc_pauses():
        t0 = time.perf_counter()
        setups = [mapper._segmented_setup_host(b, None, None, flags) for b in batches]
        host_prep_ms = (time.perf_counter() - t0) / len(batches) * 1e3
    uploads = [{k: torch.from_numpy(v).cuda() for k, v in u.items()} for u, _, _, _ in setups]
    torch.cuda.synchronize()
    with without_gc_pauses():
        t0 = time.perf_counter()
        for up, (_, cfg, n, n_seg) in zip(uploads, setups):
            mapper._dispatch(up, cfg, n, n_seg)
        torch.cuda.synchronize()
        device_ms = (time.perf_counter() - t0) / len(batches) * 1e3
    return host_prep_ms, device_ms, uploads, setups


def occupancy_maps_identical(a_map, b_map) -> bool:
    a, b = _host_occupancy(a_map), _host_occupancy(b_map)
    return a.keys() == b.keys() and all(
        np.array_equal(a[k].view(np.uint32), b[k].view(np.uint32)) for k in a)


def _segmented_occupancy_run(device, scan, clear):
    """TorchRayMapper on the segmented wire over the scan, then the clearing
    batch; returns (map after the scan, map after the clearing, stats,
    launches of K1 and K2 on the card)."""
    counters = {"expand_keys": expand_cuda.expand_keys,
                "deposit_and_sweep": deposit_cuda.deposit_and_sweep}
    zero_counts(counters)
    m = OccupancyMap(resolution=RESOLUTION, flags=MapFlag.NONE)
    mapper = TorchRayMapper(m, capacity=CAPACITY, validate=True, rayflow=False, device=device)
    mapper.integrate_rays(scan)
    mapper.sync_voxels()
    after_scan = _host_occupancy(m)
    mapper.integrate_rays(clear, ray_update_flags=CLEARING_FLAGS)
    mapper.sync_voxels()
    return after_scan, m, mapper.stats, read_counts(counters)


def phase_segmented_hardware_differential() -> dict:
    """The segmented wire on the card against the f64 oracle and the port
    on the CPU: occupancy (a box scan, then a clearing batch through the
    monolith), NDT-OM, NDT-TM and TSDF on the existing phases' scenes."""
    rng = np.random.default_rng(SEED)
    scan = box_scene_rays(1024, rng)
    clear = clearing_rays(1024, rng, scan=scan[:1024])
    runs = {}
    for name, device in (("card", "cuda"), ("card2", "cuda"), ("cpu", "cpu")):
        runs[name] = _segmented_occupancy_run(device, scan, clear)
    oracle_map = OccupancyMap(resolution=RESOLUTION, flags=MapFlag.NONE)
    oracle = RayMapperOccupancy(oracle_map)
    oracle.integrate_rays(scan)
    oracle_scan = {k: v.copy() for k, v in _host_occupancy(oracle_map).items()}
    oracle.integrate_rays(clear, ray_update_flags=CLEARING_FLAGS)
    n_vox = int(np.prod(oracle_map.region_voxel_dims))
    card_scan, card_map, card_stats, card_launches = runs["card"]
    cpu_scan, cpu_map, cpu_stats, _ = runs["cpu"]
    scan_bits = card_scan.keys() == cpu_scan.keys() and all(
        np.array_equal(card_scan[k].view(np.uint32), cpu_scan[k].view(np.uint32))
        for k in card_scan)
    card_clear = _host_occupancy(card_map)
    changed = sum(int((card_clear[k].view(np.uint32) != card_scan[k].view(np.uint32)).sum())
                  for k in card_scan)
    # Past the walls the clearing rays stop: their ends stay unobserved.
    ends = clear[1::2]
    beyond = sum(np.isfinite(card_map.voxel_value(point=p)) for p in ends[::16])
    occupancy = {
        "scan_oracle": occupancy_gate(oracle_scan, card_scan, n_vox),
        "clearing_oracle": occupancy_gate(_host_occupancy(oracle_map), card_clear, n_vox),
        "scan_bit_identical_to_cpu": bool(scan_bits),
        "clearing_bit_identical_to_cpu": occupancy_maps_identical(card_map, cpu_map),
        "card_runs_bit_identical": occupancy_maps_identical(card_map, runs["card2"][1]),
        "stats_equal_cpu": card_stats == cpu_stats, "clearing_changed_voxels": changed,
        "clearing_ends_observed": int(beyond), "launches": card_launches,
        "segments": card_stats["segments"]}
    occupancy["ok"] = bool(
        occupancy["scan_oracle"]["ok"] and occupancy["clearing_oracle"]["ok"] and scan_bits
        and occupancy["clearing_bit_identical_to_cpu"] and occupancy["card_runs_bit_identical"]
        and occupancy["stats_equal_cpu"] and changed > 0 and beyond == 0
        and card_launches["expand_keys"] == 0 and card_launches["deposit_and_sweep"] == 2)

    ndt_counters = {"expand_keys": expand_cuda.expand_keys,
                    "gather_ndt_flags": gather_cuda.gather_ndt_flags,
                    "deposit_and_sweep_ndt": deposit_cuda.deposit_and_sweep_ndt}
    rows = {"occupancy": occupancy}
    for tm in (False, True):
        zero_counts(ndt_counters)
        card, stats = run_ndt_port("cuda", tm, rayflow=False)
        launches = read_counts(ndt_counters)
        card2, _ = run_ndt_port("cuda", tm, rayflow=False)
        cpu, cpu_stats = run_ndt_port("cpu", tm, rayflow=False)
        row = {"card_vs_cpu": compare_port(card, cpu),
               "card_runs_bit_identical": maps_bit_identical(card, card2),
               "stats_equal_cpu": stats == cpu_stats, "launches": launches,
               "segments": stats["segments"], "ndt_flagged": stats["ndt_flagged"]}
        row["ok"] = bool(row["card_vs_cpu"]["ok"] and row["card_runs_bit_identical"]
                         and row["stats_equal_cpu"] and stats["ndt_flagged"] > 0
                         and launches["expand_keys"] == 0
                         and min(launches["gather_ndt_flags"],
                                 launches["deposit_and_sweep_ndt"]) > 0)
        rows["ndt_tm" if tm else "ndt_om"] = row

    tsdf_counters = {"expand_keys": expand_cuda.expand_keys, "tsdf_visits": tsdf_cuda.tsdf_visits}
    zero_counts(tsdf_counters)
    card, stats = run_tsdf_port("cuda", rayflow=False)
    launches = read_counts(tsdf_counters)
    card2, _ = run_tsdf_port("cuda", rayflow=False)
    cpu, cpu_stats = run_tsdf_port("cpu", rayflow=False)
    dev, dev2, host = tsdf_layers(card), tsdf_layers(card2), tsdf_layers(cpu)
    bits = dev.keys() == dev2.keys() and all(
        np.array_equal(a.view(np.uint32), b.view(np.uint32))
        for k in dev for a, b in zip(dev[k], dev2[k]))
    row = {"card_vs_cpu": tsdf_card_vs_cpu(dev, host),
           "card_runs_bit_identical": bool(bits), "stats_equal_cpu": stats == cpu_stats,
           "launches": launches, "segments": stats["segments"]}
    row["ok"] = bool(row["card_vs_cpu"]["ok"] and bits and row["stats_equal_cpu"]
                     and launches["expand_keys"] == 0 and launches["tsdf_visits"] > 0)
    rows["tsdf"] = row
    ok = all(r["ok"] for r in rows.values())
    emit({"metric": "segmented_hardware_differential", **rows, "ok": ok})
    if not ok:
        raise AssertionError("segmented-wire GPU differential failed")
    return rows


def phase_segmented_bench() -> dict:
    """bench.py's configuration on the segmented wire (rayflow=False)."""
    rng = np.random.default_rng(SEED)
    m = OccupancyMap(resolution=RESOLUTION, flags=MapFlag.NONE)
    mapper = TorchRayMapper(m, capacity=CAPACITY, rayflow=False, device="cuda")
    batches = [box_scene_rays(RAYS_PER_BATCH, rng) for _ in range(N_BATCHES)]
    for i in range(WARMUP):
        mapper.integrate_rays(batches[i])

    # One more batch, K2's call captured and held against its plain version.
    with first_call_args(deposit_cuda, "deposit_and_sweep") as k2_args:
        mapper.integrate_rays(batches[WARMUP])
    torch.cuda.synchronize()
    k2_row = check_k2_call(k2_args[0])
    k2_time = time_k2_call(k2_args[0])
    del k2_args

    # The segmented path, counted: every count is 0 just before it.  K1
    # must not launch: the segmented wire carries no candidate table.
    counters = {"expand_keys": expand_cuda.expand_keys,
                "deposit_and_sweep": deposit_cuda.deposit_and_sweep}
    zero_counts(counters)
    batches_before = mapper.stats["batches"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with without_gc_pauses():
        t0 = time.perf_counter()
        for b in batches:
            mapper.integrate_rays(b)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = read_counts(counters)
    stats = mapper.stats
    dispatched = stats["batches"] - batches_before
    for name in ("missed_updates", "overflow", "compaction_dropped", "dropped_updates"):
        if stats[name]:
            raise AssertionError(f"segmented path reported {name}={stats[name]}")
    k2_row["launches"], k2_row["k1_launches"] = launches["deposit_and_sweep"], launches[
        "expand_keys"]
    emit({"phase": "segmented_kernel_checks", "tolerance": 0, "deposit_and_sweep": k2_row})
    if not (k2_row["bit_identical"] and launches["expand_keys"] == 0
            and launches["deposit_and_sweep"] == dispatched):
        raise AssertionError(f"segmented path's kernel checks failed: {k2_row}")

    host_prep_ms, device_ms, uploads, setups = segmented_device_and_host_ms(mapper, batches)
    # Device time per stage (CUDA events), the walk also alone.
    stage = {"walk": 0.0, "expand": 0.0, "sort": 0.0, "deposit": 0.0}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    occ = mapper.arena.occupancy
    for up, (_, cfg, _, _) in zip(uploads, setups):
        b = decode(up, cfg)
        ev[0].record()
        expand_walk(b, cfg)
        ev[1].record()
        records, _ = expand_records(b, cfg)
        ev[2].record()
        key_s = torch.sort(records["key"]).values
        ev[3].record()
        deposit_cuda.deposit_and_sweep(occ, key_s, cfg)
        ev[4].record()
        torch.cuda.synchronize()
        for i, name in enumerate(stage):
            stage[name] += ev[i].elapsed_time(ev[i + 1]) / len(uploads)
    mapper._drain_stats()
    syncs = count_host_syncs(lambda: mapper.integrate_rays(batches[0]))
    profile_main_path(mapper, batches[:8], path="segmented")
    rays_per_sec = RAYS_PER_BATCH * N_BATCHES / elapsed
    seg_per_batch = int(np.mean([n_seg for _, _, _, n_seg in setups]))
    emit({"metric": "segmented_rays_per_sec", "value": rays_per_sec, "unit": "rays/s",
          "batches": N_BATCHES, "warmup": WARMUP, "rays_per_batch": RAYS_PER_BATCH,
          "resolution": RESOLUTION, "capacity": CAPACITY, "segments_per_batch": seg_per_batch,
          "segment_rows": int(decode(uploads[0], setups[0][1])["valid"].shape[0]),
          "host_prep_ms_per_batch": host_prep_ms, "device_ms_per_batch": device_ms,
          "stage_ms_per_batch": stage, "keys_per_batch": int(records["key"].numel()),
          "wire_bytes_per_ray": setups[0][0]["wire"].nbytes / RAYS_PER_BATCH,
          "kernel_ms": {"deposit_and_sweep": k2_time["ms"]},
          "plain_ms": {"deposit_and_sweep": k2_time["plain_ms"]},
          "kernel_alone_ms": {"deposit_and_sweep": k2_time["kernel_alone_ms"]},
          "bound": {"deposit_and_sweep": k2_time["bound"]}, "launches": launches,
          "host_syncs_per_batch": syncs,
          "stats": {k: stats[k] for k in ("segments", "missed_updates", "overflow",
                                          "compaction_dropped")},
          "max_memory_allocated_bytes": peak})
    return {"mapper": mapper, "launches": launches, "max_abs_err": k2_row["max_abs_err"],
            **k2_time}


def phase_clearing_bench(segmented: dict) -> dict:
    """The monolith at full width: clearing batches on the segmented
    bench's box map."""
    mapper = segmented.pop("mapper")
    rng = np.random.default_rng(SEED + 1)
    batches = [clearing_rays(RAYS_PER_BATCH, rng) for _ in range(CLEARING_BATCHES)]
    for b in batches[:CLEARING_WARMUP]:
        mapper.integrate_rays(b, ray_update_flags=CLEARING_FLAGS)
    with first_call_args(deposit_cuda, "deposit_and_sweep") as k2_args:
        mapper.integrate_rays(batches[0], ray_update_flags=CLEARING_FLAGS)
    torch.cuda.synchronize()
    k2_row = check_k2_call(k2_args[0])
    k2_time = time_k2_call(k2_args[0])
    del k2_args

    counters = {"expand_keys": expand_cuda.expand_keys,
                "deposit_and_sweep": deposit_cuda.deposit_and_sweep}
    zero_counts(counters)
    batches_before = mapper.stats["batches"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with without_gc_pauses():
        t0 = time.perf_counter()
        for b in batches:
            mapper.integrate_rays(b, ray_update_flags=CLEARING_FLAGS)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = read_counts(counters)
    stats = mapper.stats
    dispatched = stats["batches"] - batches_before
    for name in ("missed_updates", "overflow"):
        if stats[name]:
            raise AssertionError(f"clearing path reported {name}={stats[name]}")
    k2_row["launches"], k2_row["k1_launches"] = launches["deposit_and_sweep"], launches[
        "expand_keys"]
    emit({"phase": "clearing_kernel_checks", "tolerance": 0, "deposit_and_sweep": k2_row})
    if not (k2_row["bit_identical"] and launches["expand_keys"] == 0
            and launches["deposit_and_sweep"] == dispatched):
        raise AssertionError(f"clearing path's kernel checks failed: {k2_row}")

    host_prep_ms, device_ms, uploads, setups = segmented_device_and_host_ms(
        mapper, batches, CLEARING_FLAGS)
    # The ordered walk alone, and the whole monolith, per batch (CUDA events).
    stage = {"ordered_walk": 0.0, "monolith": 0.0}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    walk_lanes = 0
    for up, (_, cfg, _, _) in zip(uploads, setups):
        b = decode(up, cfg)
        ev[0].record()
        walk = walk_rays(b["start_abs"], b["end_abs"], b["start_frac"], b["direction"],
                         b["length"], cfg.resolution, cfg.max_steps)
        ev[1].record()
        integrate_ops.integrate_occupancy(mapper.arena.layers, b, cfg)
        ev[2].record()
        torch.cuda.synchronize()
        walk_lanes = walk["valid"].numel()
        for i, name in enumerate(stage):
            stage[name] += ev[i].elapsed_time(ev[i + 1]) / len(uploads)
    mapper._drain_stats()
    profile_main_path(mapper, batches[:8], path="clearing", ray_update_flags=CLEARING_FLAGS)
    rays_per_sec = RAYS_PER_BATCH * CLEARING_BATCHES / elapsed
    emit({"metric": "clearing_rays_per_sec", "value": rays_per_sec, "unit": "rays/s",
          "batches": CLEARING_BATCHES, "warmup": CLEARING_WARMUP,
          "rays_per_batch": RAYS_PER_BATCH, "ray_flags": CLEARING_FLAGS,
          "reach": CLEARING_REACH, "segments_per_batch": int(np.mean(
              [n_seg for _, _, _, n_seg in setups])), "walk_lanes_per_batch": walk_lanes,
          "host_prep_ms_per_batch": host_prep_ms, "device_ms_per_batch": device_ms,
          "stage_ms_per_batch": stage,
          "kernel_ms": {"deposit_and_sweep": k2_time["ms"]},
          "plain_ms": {"deposit_and_sweep": k2_time["plain_ms"]},
          "kernel_alone_ms": {"deposit_and_sweep": k2_time["kernel_alone_ms"]},
          "bound": {"deposit_and_sweep": k2_time["bound"]}, "launches": launches,
          "stats": {k: stats[k] for k in ("segments", "missed_updates", "overflow")},
          "max_memory_allocated_bytes": peak})
    return {"launches": launches, "max_abs_err": k2_row["max_abs_err"], "stage": stage,
            **k2_time}


def arenas_identical(a, b) -> bool:
    """Two arenas' layers bit for bit, compared on the CPU in slices."""
    if a.layers.keys() != b.layers.keys() or a.slot_of != b.slot_of:
        return False
    step = 1 << 26
    for name in a.layers:
        x, y = a.layers[name], b.layers[name]
        for i in range(0, x.numel(), step):
            xs, ys = x[i:i + step].cpu(), y[i:i + step].cpu()
            if not torch.equal(xs.view(torch.int32), ys.view(torch.int32)):
                return False
    return True


def phase_wide_outdoor() -> dict:
    """An outdoor survey past the rayflow wire's envelope, through the
    worker: occupancy + voxel mean at 0.1 m, a 32767-slot arena."""
    rng = np.random.default_rng(OUTDOOR_SEED)
    batches = [outdoor_rays(RAYS_PER_BATCH, rng, extent=WIDE_EXTENT)
               for _ in range(WIDE_BATCHES)]
    envelope = prepare_rayflow(OccupancyMap(resolution=RESOLUTION, flags=MapFlag.VOXEL_MEAN),
                               batches[0]) is None
    counters = {"expand_keys": expand_cuda.expand_keys,
                "deposit_and_sweep": deposit_cuda.deposit_and_sweep}

    def run(device, n):
        m = OccupancyMap(resolution=RESOLUTION, flags=MapFlag.VOXEL_MEAN)
        mapper = TorchRayMapper(m, capacity=WIDE_CAPACITY, device=device)
        for rays in batches[:n]:
            mapper.integrate_rays_async(rays)
        mapper.flush()
        return m, mapper

    # The card against the CPU port on the first batches: the arena, and
    # any chunk the LRU paged out to the host map, bit for bit.
    t0 = time.perf_counter()
    card_map, card = run("cuda", WIDE_CHECKED)
    cpu_map, cpu = run("cpu", WIDE_CHECKED)
    same = (arenas_identical(card.arena, cpu.arena) and card.stats == cpu.stats
            and card.arena.stats == cpu.arena.stats
            and card_map.chunks.keys() == cpu_map.chunks.keys()
            and all(np.array_equal(a.view(np.uint8), b.view(np.uint8))
                    for k in card_map.chunks
                    for a, b in zip(card_map.chunks[k].layers, cpu_map.chunks[k].layers)))
    checked = {"seconds": time.perf_counter() - t0, "batches": WIDE_CHECKED,
               "paged_out_chunks": len(card_map.chunks), "arena": dict(card.arena.stats)}
    del card, cpu, card_map, cpu_map
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # A mapper whose worker ran stays alive with its thread: the checked
    # card mapper's arena is still allocated here.
    held_before = torch.cuda.memory_allocated()
    zero_counts(counters)
    with without_gc_pauses():
        t0 = time.perf_counter()
        _, mapper = run("cuda", WIDE_BATCHES)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = read_counts(counters)
    stats = mapper.stats
    for name in ("missed_updates", "overflow", "compaction_dropped", "dropped_updates"):
        if stats[name]:
            raise AssertionError(f"wide outdoor path reported {name}={stats[name]}")
    profile_main_path(mapper, batches[:2], path="wide_outdoor")
    # What comes out, read on the card: observed voxels and mean samples.
    occ = mapper.arena.occupancy
    observed = int((~((occ == 0) & torch.signbit(occ))).sum())
    hits = int((mapper.arena.layers["mean_count"].long() & 0xFFFFFFFF).sum())
    row = {"metric": "wide_outdoor_rays_per_sec",
           "value": RAYS_PER_BATCH * WIDE_BATCHES / elapsed, "unit": "rays/s",
           "batches": WIDE_BATCHES, "rays_per_batch": RAYS_PER_BATCH, "seed": OUTDOOR_SEED,
           "extent_m": WIDE_EXTENT, "resolution": RESOLUTION, "capacity": WIDE_CAPACITY,
           "arena_bytes": sum(t.numel() * t.element_size()
                              for t in mapper.arena.layers.values()),
           "outside_rayflow_envelope": bool(envelope), "launches": launches,
           "card_bit_identical_to_cpu": bool(same), "checked": checked,
           "arena_stats": dict(mapper.arena.stats), "regions": len(mapper.arena.slot_of),
           "observed_voxels": observed, "mean_hits": hits,
           "stats": {k: stats[k] for k in ("batches", "segments", "missed_updates",
                                           "overflow", "compaction_dropped")},
           "max_memory_allocated_bytes": peak, "allocated_before_bytes": held_before}
    emit(row)
    if not (same and envelope and launches["expand_keys"] == 0
            and launches["deposit_and_sweep"] == stats["batches"] and hits > 0
            and observed > 0):
        raise AssertionError(f"wide outdoor phase failed: {row}")
    return {"launches": launches}


def phase_segmented_ndt_tsdf() -> dict:
    """NDT-OM (scripts/bench_modes.py config 3) and TSDF (config 4) on the
    segmented wire: the fused flag gather, K3 and the fused per-visit kernel
    on the arguments each path gave them, against their plain versions and
    timed beside them, and their launches on the path (K1's 0)."""
    rng = np.random.default_rng(SEED)
    batches = [box_scene_rays(RAYS_PER_BATCH, rng)
               for _ in range(SEGMENTED_NDT_TSDF_WARMUP + SEGMENTED_NDT_TSDF_BATCHES)]
    warm, timed = (batches[:SEGMENTED_NDT_TSDF_WARMUP],
                   batches[SEGMENTED_NDT_TSDF_WARMUP:])
    out = {"launches": {}, "ms": {}, "plain_ms": {}, "max_abs_err": {}, "rays_per_sec": {}}

    ndt = TorchNdtMap(OccupancyMap(resolution=NDT_RESOLUTION, flags=MapFlag.NONE),
                      capacity=NDT_CAPACITY, rayflow=False, device="cuda")
    tsdf = TorchTsdfMap(OccupancyMap(resolution=RESOLUTION, flags=MapFlag.NONE),
                        capacity=TSDF_CAPACITY, rayflow=False, device="cuda")
    counters = {"expand_keys": expand_cuda.expand_keys,
                "gather_ndt_flags": gather_cuda.gather_ndt_flags,
                "deposit_and_sweep_ndt": deposit_cuda.deposit_and_sweep_ndt,
                "tsdf_visits": tsdf_cuda.tsdf_visits}
    for name, mapper in (("ndt_om", ndt), ("tsdf", tsdf)):
        for b in warm:
            mapper.integrate_rays(b)
        torch.cuda.synchronize()
        zero_counts(counters)
        with without_gc_pauses():
            t0 = time.perf_counter()
            for b in timed:
                mapper.integrate_rays(b)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
        out["launches"][name] = read_counts(counters)
        out["rays_per_sec"][name] = RAYS_PER_BATCH * len(timed) / elapsed
        stats = mapper.stats
        for stat in ("missed_updates", "overflow", "compaction_dropped"):
            if stats[stat]:
                raise AssertionError(f"segmented {name} path reported {stat}={stats[stat]}")

    with first_call_args(gather_cuda, "gather_ndt_flags") as kf_args, \
            first_call_args(deposit_cuda, "deposit_and_sweep_ndt") as k3_args:
        ndt.integrate_rays(timed[0])
    with first_call_args(tsdf_cuda, "tsdf_visits") as visits_args:
        tsdf.integrate_rays(timed[0])
    torch.cuda.synchronize()
    rows = check_ndt_kernel_calls(kf_args[0], k3_args[0])
    rows["tsdf_visits"] = check_tsdf_visits(*visits_args[0][0])
    (occ_f, count, ids, threshold, sentinel), _ = kf_args[0]
    (occ, walk, end, delta, dcfg), k3_kw = k3_args[0]
    (weight, distance, *rest), _ = visits_args[0]
    occ_a, occ_b = occ.clone(), occ.clone()
    va, vb = (weight.clone(), distance.clone()), (weight.clone(), distance.clone())
    for name, plain, kernel in (
            ("gather_ndt_flags",
             lambda: gather_cuda.gather_ndt_flags_reference(occ_f, count, ids, threshold,
                                                            sentinel),
             lambda: gather_cuda.gather_ndt_flags(occ_f, count, ids, threshold, sentinel)),
            ("deposit_and_sweep_ndt",
             lambda: deposit_cuda.deposit_and_sweep_ndt_reference(occ_a, walk, end, delta, dcfg),
             lambda: deposit_cuda.deposit_and_sweep_ndt(occ_b, walk, end, delta, dcfg,
                                                        **k3_kw)),
            ("tsdf_visits", lambda: tsdf_cuda.tsdf_visits_reference(*va, *rest),
             lambda: tsdf_cuda.tsdf_visits(*vb, *rest))):
        out["plain_ms"][name], out["ms"][name] = plain_vs_kernel_ms(plain, kernel)
        out["max_abs_err"][name] = rows[name]["max_abs_err"]
    del kf_args, k3_args, visits_args
    emit({"phase": "segmented_ndt_tsdf", "tolerance": 0, "checks": rows,
          "batches": len(timed), "warmup": len(warm), "rays_per_batch": RAYS_PER_BATCH,
          **{k: out[k] for k in ("rays_per_sec", "launches", "ms", "plain_ms")}})
    ok = all(r["bit_identical"] for r in rows.values()) and rows["tsdf_visits"][
        "runs_bit_identical"]
    lz = out["launches"]
    ok = ok and lz["ndt_om"]["expand_keys"] == lz["tsdf"]["expand_keys"] == 0
    ok = ok and min(lz["ndt_om"]["gather_ndt_flags"], lz["ndt_om"]["deposit_and_sweep_ndt"],
                    lz["tsdf"]["tsdf_visits"]) > 0
    if not ok:
        raise AssertionError(f"segmented NDT/TSDF kernel checks failed: {rows} {lz}")
    return out


#: The sharded phase: four shards (one a card where there are four, else
#: all on the one card), bench.py's box at 0.1 m with a 512-slot arena a
#: shard, the single-device mapper's.
SHARDS = 4
SHARDED_BATCHES = 12
SHARDED_WARMUP = 4
SHARDED_NDT_TSDF_BATCHES = 4
SHARDED_CPU_BATCHES = 2
#: Batches before the one whose kernel calls are held to the plain versions.
SHARDED_CHECK_WARMUP = 6
def sharded_mapper(cls, mesh, kind="occupancy", resolution=RESOLUTION, capacity=CAPACITY,
                   validate=True):
    m = OccupancyMap(resolution=resolution, flags=MapFlag.NONE)
    return cls(m, mesh, kind=kind, capacity=capacity, validate=validate)


def single_mapper(kind, rayflow: bool, resolution=RESOLUTION, capacity=CAPACITY):
    m = OccupancyMap(resolution=resolution, flags=MapFlag.NONE)
    cls = {"occupancy": TorchRayMapper, "ndt": TorchNdtMap, "tsdf": TorchTsdfMap}[kind]
    return cls(m, capacity=capacity, validate=True, rayflow=rayflow, device="cuda")


def run_batches(mapper, batches):
    for b in batches:
        mapper.integrate_rays(b)
    mapper.sync_voxels()
    return mapper.map


def sharded_vs_single(a_map, b_map, kind="occupancy") -> dict:
    """parallel.dryrun.compare_maps (occupancy bit for bit; NDT occupancy
    and covariance, TSDF weight and distance within 1e-5, non-finite values
    equal; raises otherwise) and whether every compared bit is equal."""
    worst = compare_maps(a_map, b_map, kind)
    a, b = map_members(a_map, kind), map_members(b_map, kind)
    same = all(np.array_equal(a[k].view(np.uint32), b[k].view(np.uint32)) for k in a)
    return {"worst_abs_diff": worst, "bit_identical": bool(same), "members": len(a)}


def _snapshots(args, kwargs):
    return _snapshot(args), _snapshot(kwargs)


def busiest_shard_calls(calls: dict, primary: str, score) -> dict:
    """Of one batch's calls of each kernel (one a shard, in shard order),
    the busiest shard's: the one whose ``primary`` kernel call scores
    highest (``score(args)``)."""
    s = int(np.argmax([score(args) for args, _ in calls[primary]]))
    return {name: seen[s] for name, seen in calls.items()}


def live_keys(args) -> int:
    """Live records of a K2 call (occ, key_s, cfg) or a K3 call (occ, walk,
    end, delta, cfg)."""
    cfg = args[-1]
    return int(sum(((k >> 1) < cfg.sentinel).sum() for k in args[1:-1]
                   if isinstance(k, torch.Tensor)))


def live_visits(args) -> int:
    ids, sentinel = args[2], args[7]
    return int((ids < sentinel).sum())


def sharded_kernel_checks(calls: dict) -> dict:
    """Each kernel against its plain version on one shard's arguments, as
    the sharded paths gave them (the busiest shard's call in one batch): K1
    (keys; voxel planes for NDT and TSDF), K2, the fused flag gather and
    K3, the fused per-visit kernel.  Bit for bit; rows with max_abs_err."""
    # A kernel launches on the current device; with one shard a card a
    # shard's tensors lie on another.
    with torch.cuda.device(calls["k2"][0][1].device):
        rows = {"expand_keys_occupancy": check_k1_call(calls["k1_occupancy"]),
                "deposit_and_sweep": check_k2_call(calls["k2"])}
    with torch.cuda.device(calls["k3"][0][1].device):
        rows["expand_keys_ndt"] = check_k1_call(calls["k1_ndt"])
        nd = check_ndt_kernel_calls(calls["gather_ndt_flags"], calls["k3"])
    rows["gather_ndt_flags"] = nd["gather_ndt_flags"]
    rows["deposit_and_sweep_ndt"] = nd["deposit_and_sweep_ndt"]
    with torch.cuda.device(calls["tsdf_visits"][0][2].device):
        rows["expand_keys_tsdf"] = check_k1_call(calls["k1_tsdf"])
        visits = check_tsdf_visits(*calls["tsdf_visits"][0])
    visits["bit_identical"] = (visits["bit_identical"] and visits["runs_bit_identical"]
                               and visits["stored_voxels"] > 0)
    rows["tsdf_visits"] = visits
    emit({"phase": "sharded_kernel_checks", "tolerance": 0, **rows})
    if not all(r["bit_identical"] for r in rows.values()):
        raise AssertionError(f"a kernel differs from its plain version on a shard: {rows}")
    return rows


def phase_sharded() -> dict:
    """ohm_tpu_torch.parallel on the card: the occupancy box through both
    sharded mappers (timed, launches counted, against TorchRayMapper, a
    second card run and the CPU), NDT-OM and TSDF through both against
    TorchNdtMap and TorchTsdfMap, one a2a step, the eviction case and
    dryrun_multichip; each kernel against its plain version on one shard's
    arguments."""
    mesh = ShardMesh.over_cards(SHARDS, "cuda")
    names = [torch.cuda.get_device_name(d) for d in mesh.devices]
    rng = np.random.default_rng(SEED)
    batches = [box_scene_rays(RAYS_PER_BATCH, rng)
               for _ in range(SHARDED_WARMUP + SHARDED_BATCHES)]
    warm, timed_b = batches[:SHARDED_WARMUP], batches[SHARDED_WARMUP:]
    counters = {"expand_keys": expand_cuda.expand_keys,
                "deposit_and_sweep": deposit_cuda.deposit_and_sweep,
                "deposit_and_sweep_ndt": deposit_cuda.deposit_and_sweep_ndt,
                "gather_ndt_flags": gather_cuda.gather_ndt_flags,
                "tsdf_visits": tsdf_cuda.tsdf_visits}
    out = {"n_shards": mesh.n_shards, "devices": [str(d) for d in mesh.devices],
           "device_names": names, "launches": {}, "checks": {}, "evictions": {}}
    wires = {"rayflow": (ShardedRayFlowMapper, True), "routed": (ShardedRayMapper, False)}

    # Occupancy: both mappers timed, counted, and held to the single-device
    # mapper, a second card run and the CPU.
    for wire, (cls, rayflow) in wires.items():
        # Validated after the timed batches (a validated batch reads its
        # stats back at once).
        mapper = sharded_mapper(cls, mesh, validate=False)
        for b in warm:
            mapper.integrate_rays(b)
        torch.cuda.synchronize()
        zero_counts(counters)
        with without_gc_pauses():
            t0 = time.perf_counter()
            for b in timed_b:
                mapper.integrate_rays(b)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
        out["launches"][f"{wire}_occupancy"] = read_counts(counters)
        out[f"{wire}_rays_per_sec"] = RAYS_PER_BATCH * len(timed_b) / elapsed
        mapper.sync_voxels()
        st = mapper.stats
        if st["overflow"]:
            raise AssertionError(f"a sharded {wire} batch overflowed its walk: {st}")
        if wire == "rayflow":
            out["routed_rays_per_ray"] = st["routed_rays"] / st["rays"]
            out["last_balance"] = mapper.last_balance
            out["wire_bytes_per_ray"] = st["wire_bytes"] / st["rays"]
            if st["routing_dropped"] or st["compaction_dropped"]:
                raise AssertionError(f"sharded rayflow dropped records: {st}")
        else:
            out["routed_segments_per_segment"] = st["routed_records"] / st["segments"]
        out["arena_stats"] = dict(mapper.arena.stats)
        single = run_batches(single_mapper("occupancy", rayflow), batches)
        again = run_batches(sharded_mapper(cls, mesh), batches)
        card_cut = run_batches(sharded_mapper(cls, mesh), batches[:SHARDED_CPU_BATCHES])
        cpu_cut = run_batches(sharded_mapper(cls, ShardMesh.repeat("cpu", SHARDS)),
                              batches[:SHARDED_CPU_BATCHES])
        out["checks"][f"{wire}_occupancy"] = {
            "vs_single_device": sharded_vs_single(mapper.map, single),
            "two_card_runs": sharded_vs_single(mapper.map, again),
            "vs_cpu_2_batches": sharded_vs_single(card_cut, cpu_cut)}
    rf_mapper = sharded_mapper(ShardedRayFlowMapper, mesh)
    for b in warm:
        rf_mapper.integrate_rays(b)
    profile_main_path(rf_mapper, timed_b[:8], path="sharded_rayflow")

    # NDT-OM (0.2 m) and TSDF (0.1 m) through both mappers.
    nt_batches = batches[:SHARDED_NDT_TSDF_BATCHES]
    for kind, res in (("ndt", NDT_RESOLUTION), ("tsdf", RESOLUTION)):
        for wire, (cls, rayflow) in wires.items():
            zero_counts(counters)
            sh = run_batches(sharded_mapper(cls, mesh, kind, resolution=res), nt_batches)
            out["launches"][f"{wire}_{kind}"] = read_counts(counters)
            ref = single_mapper(kind, rayflow, resolution=res)
            run_batches(ref, nt_batches)
            if kind == "ndt" and ref.stats["ndt_overflow"]:
                raise AssertionError("the single-device NDT reference overflowed its miss_k")
            out["checks"][f"{wire}_{kind}"] = {
                "vs_single_device": sharded_vs_single(sh, ref.map, kind)}

    # One a2a step against the single-device mapper on the segmented wire.
    ref_a = single_mapper("occupancy", False)
    prepared = prepare_ray_batch(ref_a.map, timed_b[0], segment_length=ref_a.segment_length)
    arena_a = ResidentShardedArena(mesh, CAPACITY, ref_a.region_shift, ["occupancy"])
    arena_a.ensure_regions(prepared.region_keys)
    batch_a, max_pairs = make_source_batch(prepared, arena_a, mesh)
    cap_a = max(64, 1 << (max_pairs - 1).bit_length())
    zero_counts(counters)
    stats_a = sharded_integrate_a2a(mesh, ref_a._config(0), cap_a, ref_a.region_shift)(
        arena_a.layers, batch_a)
    out["launches"]["a2a"] = read_counts(counters)
    m_a = OccupancyMap(resolution=RESOLUTION, flags=MapFlag.NONE)
    arena_a.sync_to_host(m_a)
    out["a2a_routing_dropped"] = int(stats_a["routing_dropped"].sum())
    if out["a2a_routing_dropped"]:
        raise AssertionError("the a2a step dropped routed segments")
    out["checks"]["a2a"] = {"vs_single_device": sharded_vs_single(
        m_a, run_batches(ref_a, timed_b[:1]))}

    # Eviction at capacity 1 a shard (tests/test_sharded.py's clusters).
    cand = np.array([[i, 0, 0] for i in range(48)])
    owners = region_owner(cand, SHARDS)
    hot = next(s for s in range(SHARDS) if (owners == s).sum() >= 2)
    r_a, r_b = cand[owners == hot][:2]
    rng_e = np.random.default_rng(13)

    def cluster(region, n=96):
        rays = rng_e.uniform(-1.5, 1.5, (2 * n, 3))
        rays[0::2] *= 0.05
        return rays + np.asarray(region, dtype=float) * 8.0  # 0.25 m x 32: 8 m regions

    evict = [cluster(r_a), cluster(r_b), cluster(r_a), cluster(r_b), cluster(r_a)]
    for wire, (cls, rayflow) in wires.items():
        sh = sharded_mapper(cls, mesh, resolution=0.25, capacity=1)
        run_batches(sh, evict)
        ref = run_batches(single_mapper("occupancy", rayflow, resolution=0.25), evict)
        out["evictions"][wire] = sh.arena.stats["evictions"]
        out["checks"][f"{wire}_eviction"] = {"vs_single_device": sharded_vs_single(sh.map, ref)}
        if sh.arena.stats["evictions"] < len(evict) - 1:
            raise AssertionError(f"the {wire} eviction case evicted too little")

    out["dryrun"] = dryrun_multichip(SHARDS)

    # Each kernel on one shard's arguments: of one batch's calls (one a
    # shard), the busiest shard's (the most live deposit records), after six
    # batches so that some voxels hold samples.
    mappers = {kind: sharded_mapper(ShardedRayFlowMapper, mesh, kind,
                                    resolution=NDT_RESOLUTION if kind == "ndt" else RESOLUTION)
               for kind in ("occupancy", "ndt", "tsdf")}
    check_batch = batches[SHARDED_CHECK_WARMUP]
    for mp in mappers.values():
        run_batches(mp, batches[:SHARDED_CHECK_WARMUP])
    kernels = {"occupancy": {"k1_occupancy": (expand_cuda, "expand_keys"),
                             "k2": (deposit_cuda, "deposit_and_sweep")},
               "ndt": {"k1_ndt": (expand_cuda, "expand_keys"),
                       "gather_ndt_flags": (gather_cuda, "gather_ndt_flags"),
                       "k3": (deposit_cuda, "deposit_and_sweep_ndt")},
               "tsdf": {"k1_tsdf": (expand_cuda, "expand_keys"),
                        "tsdf_visits": (tsdf_cuda, "tsdf_visits")}}
    primary = {"occupancy": ("k2", live_keys), "ndt": ("k3", live_keys),
               "tsdf": ("tsdf_visits", live_visits)}
    calls = {}
    for kind, named in kernels.items():
        with contextlib.ExitStack() as stack:
            seen = {name: stack.enter_context(every_call(mod, fn, _snapshots))
                    for name, (mod, fn) in named.items()}
            mappers[kind].integrate_rays(check_batch)
        calls.update(busiest_shard_calls(seen, *primary[kind]))
    torch.cuda.synchronize()
    rows = sharded_kernel_checks(calls)
    del calls, mappers
    out["max_abs_err"] = {
        "expand_keys": max(rows[f"expand_keys_{k}"]["max_abs_err"]
                           for k in ("occupancy", "ndt", "tsdf")),
        **{k: rows[k]["max_abs_err"] for k in ("deposit_and_sweep", "deposit_and_sweep_ndt",
                                               "gather_ndt_flags", "tsdf_visits")}}

    lz = out["launches"]
    # Where each kernel runs on the sharded paths (K1 only on the rayflow
    # wire: the segmented wire carries no candidate table).
    on_path = {"expand_keys": ("rayflow_occupancy", "rayflow_ndt", "rayflow_tsdf"),
               "deposit_and_sweep": ("rayflow_occupancy", "routed_occupancy", "a2a"),
               "deposit_and_sweep_ndt": ("rayflow_ndt", "routed_ndt"),
               "gather_ndt_flags": ("rayflow_ndt", "routed_ndt"),
               "tsdf_visits": ("rayflow_tsdf", "routed_tsdf")}
    out["sharded_launches"] = {k: {p: lz[p][k] for p in paths} for k, paths in on_path.items()}
    out["launches_per_batch"] = {f"{w}_occupancy": {k: n / len(timed_b) for k, n in
                                                     lz[f"{w}_occupancy"].items()}
                                 for w in wires}
    checks_ok = all(c["vs_single_device"]["members"] > 0 for c in out["checks"].values())
    # Occupancy bit for bit in every comparison of the occupancy paths (NDT
    # and TSDF floats within 1e-5: compare_maps raised otherwise).
    occ_bits = all(r["bit_identical"] for name, c in out["checks"].items()
                   if not name.endswith(("_ndt", "_tsdf")) for r in c.values())
    launches_ok = all(n > 0 for per in out["sharded_launches"].values() for n in per.values())
    k1_off = all(lz[f"routed_{k}"]["expand_keys"] == 0 for k in ("occupancy", "ndt", "tsdf"))
    emit({"phase": "sharded", "metric": "sharded_rayflow_rays_per_sec",
          "sharded_rayflow_rays_per_sec": out["rayflow_rays_per_sec"],
          "sharded_rays_per_sec": out["routed_rays_per_sec"],
          "batches": len(timed_b), "warmup": len(warm), "rays_per_batch": RAYS_PER_BATCH,
          **{k: out[k] for k in ("n_shards", "devices", "device_names", "routed_rays_per_ray",
                                 "routed_segments_per_segment", "last_balance",
                                 "wire_bytes_per_ray", "launches_per_batch",
                                 "sharded_launches", "a2a_routing_dropped", "evictions",
                                 "checks", "max_abs_err")},
          "dryrun": {k: v for k, v in out["dryrun"].items() if k != "devices"}})
    if not (checks_ok and occ_bits and launches_ok and k1_off):
        raise AssertionError(f"sharded phase failed: bits {occ_bits}, launches "
                             f"{out['sharded_launches']}, routed K1 off {k1_off}")
    return out


#: The fused TSDF kernel, for its time alone.
TSDF_VISITS_KERNELS = ("tsdf_visits_kernel",)
#: Operations a record of the per-visit chain: the blocked in-row sum (10
#: adds, a subtraction, 10 maxima, the local sum, the carry's add), the
#: visit map (~7), 11 combines of 11 operations (10 in-row levels and the
#: carry) and the map's application (~6).
TSDF_VISIT_OPS = 160

WRAPPER_CALLS = 1000
#: K2's and K3's kernels by name, for their time alone (the sum of the
#: kernels a call launches).
K2_KERNELS = ("run_deposit_kernel",)
# The deposit probes' kernels (csrc/probes.cu), and the empty kernel timed
# beside them as the launch floor.
PROBE_KERNELS = {"vmem_scatter_add": "scatter_add_probe", "take_along_axis": "take_along_probe",
                 "dynamic_fori": "dynamic_loop_probe", "dyn_offset_dma": "bulk_copy_probe",
                 "onehot_mxu_dot": "onehot_mma_probe"}
EMPTY_KERNEL = "empty_probe"
SLOTGRID_KERNEL = "slotgrid_run_kernel"
K3_KERNELS = ("end_table_kernel", "ndt_run_deposit_kernel")


def call_cost(fn, kernel, calls: int) -> dict:
    """One wrapper call's cost: host us a call over ``calls`` calls without
    a synchronize, CUDA-event ms a call over 20 back-to-back calls, and
    device_profile's kernel-alone ms (the whole call's device ms with
    ``kernel`` empty), device ms and device operations a call; and the
    device memory a call allocates above what was allocated before it
    (its peak)."""
    prof = device_profile(fn, kernel)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return {"host_us_per_call": host_us_per_call(fn, calls), "wrapper_ms": cuda_ms(fn),
            "kernel_alone_ms": prof["kernel_ms"] if kernel else prof["device_ms"],
            "device_ms_per_call": prof["device_ms"],
            "device_ops_per_call": prof["device_ops"],
            "peak_bytes_per_call": torch.cuda.max_memory_allocated() - before}


def wrapper_inputs() -> dict:
    """The wrapper_cost phase's inputs, built by this checkout without a
    kernel launch: bench.py's first box batch decoded on the card (8192
    rays, seed 2024, 0.1 m voxels, 512 slots), and an NDT-OM arena (0.2 m,
    1024 slots; +inf, NaN and counts at or above 2^31) with 600,000 sorted
    ids over 320 live slots and 40,000 sentinels; for K2, the 512-slot
    arena and sorted ~1.1M-key stream of phase_k2; for K3, an NDT-OM arena
    with 600,000 walk keys (a fifth masked), 8192 end keys and a sparse
    delta, as the NDT-OM path gives it; the deposit probe's stream
    (make_stream, 1,250,304 keys over 512 slots) and its probes' inputs."""
    rng = np.random.default_rng(SEED)
    b, cfg = _wire_batch(box_scene_rays(RAYS_PER_BATCH, rng))
    ncfg = _ndt_config_at_bench_shape()
    n = ncfg.sentinel
    occ, count = ndt_flag_arena(n + 1, n, rng, 10_000, 10_000)
    ids = _sorted_ids(rng, ncfg, 600_000, 40_000)
    occ, count, ids = (torch.from_numpy(x).cuda() for x in (occ, count.view(np.int32), ids))
    k2_occ, k2_keys = _bench_arena_and_stream(cfg, rng)
    k3_occ, walk, end, sparse, _, bounds = _ndt_arena_and_streams(ncfg, rng, n_walk=600_000)
    c = probe_deposit.C
    p_keys = torch.from_numpy(probe_deposit.make_stream()).cuda()
    p_occ = torch.from_numpy(probe_deposit.initial_occupancy()[:c * probe_deposit.V]).cuda()
    return {"b": b, "cfg": cfg, "occ": occ, "count": count, "ids": ids, "sentinel": n,
            "threshold": 3, "k2": (k2_occ, k2_keys, cfg),
            "k3": (k3_occ, walk, end, sparse, ncfg, bounds),
            "p": (p_keys, p_occ, c), "probes": probes_cuda.probe_inputs("cuda")}


def p_wrapper_cost(slotgrid_mod, probes_mod, inputs: dict) -> dict:
    """call_cost of the deposit probe's wrappers in ``slotgrid_mod`` and
    ``probes_mod`` (WRAPPER_CALLS / 10 calls): the slot-grid deposit with
    the fused sweep on the probe's stream, on its own copy of the arena,
    and each probe on its inputs."""
    keys, occ, c = inputs["p"]
    occ = occ.clone()
    sweep = probe_deposit.SWEEP
    out = {"slotgrid_deposit": call_cost(
        lambda: slotgrid_mod.slotgrid_deposit(keys, occ, c, **sweep), "slotgrid",
        WRAPPER_CALLS // 10)}
    for name, fn in probes_mod.PROBES.items():
        args = inputs["probes"][name]
        out[f"probe_{name}"] = call_cost(lambda: fn(*args), PROBE_KERNELS[name],
                                         WRAPPER_CALLS // 10)
    return out


def phase_wrapper_cost(expand_mod, gather_mod, deposit_mod, inputs: dict, root: str,
                       p_mods: tuple) -> dict:
    """call_cost of the K1, K2, K3 and K4 wrappers of ``expand_mod``,
    ``deposit_mod`` and ``gather_mod`` (this checkout's, or another's under
    --wrappers-of) on ``inputs``: K1 with keys, traversal and voxel planes
    (WRAPPER_CALLS / 5 calls for the host time, so that their device work
    does not fill the launch queue); K2 and K3 (WRAPPER_CALLS / 10), each
    on its own copy of its arena; K4 on the built flag plane beside
    index_select; the plane build + K4 (WRAPPER_CALLS / 10); and the fused
    flag gather where the module has one; then p_wrapper_cost of
    ``p_mods`` (its slot-grid and probe modules)."""
    b, cfg = inputs["b"], inputs["cfg"]
    occ, count, ids = inputs["occ"], inputs["count"], inputs["ids"]
    n, thr = inputs["sentinel"], inputs["threshold"]
    out = {}
    for name, kw in (("keys", {}), ("traversal", {"with_trav": True}),
                     ("voxel_planes", {"with_vox": True})):
        out[f"expand_keys_{name}"] = call_cost(
            lambda: expand_mod.expand_keys(b, cfg, **kw), "expand_keys_kernel",
            WRAPPER_CALLS // 5)

    k2_occ, k2_keys, k2_cfg = inputs["k2"]
    k2_occ = k2_occ.clone()
    out["deposit_and_sweep"] = call_cost(
        lambda: deposit_mod.deposit_and_sweep(k2_occ, k2_keys, k2_cfg), K2_KERNELS,
        WRAPPER_CALLS // 10)
    k3_occ, walk, end, sparse, k3_cfg, bounds = inputs["k3"]
    k3_occ = k3_occ.clone()
    out["deposit_and_sweep_ndt"] = call_cost(
        lambda: deposit_mod.deposit_and_sweep_ndt(k3_occ, walk, end, sparse, k3_cfg,
                                                  bounds_key=bounds),
        K3_KERNELS, WRAPPER_CALLS // 10)

    def build_plane():
        return (~torch.isposinf(occ) & ((count >= thr) | (count < 0))).to(torch.int8)

    plane = build_plane()
    out["gather_plane"] = call_cost(lambda: gather_mod.gather_plane(plane, ids, n), "gather",
                                    WRAPPER_CALLS)
    # index_select issues one device operation, whatever its kernel's name.
    out["index_select"] = call_cost(lambda: torch.index_select(plane, 0, ids), "",
                                    WRAPPER_CALLS)
    out["plane_build_k4"] = call_cost(lambda: gather_mod.gather_plane(build_plane(), ids, n),
                                      "gather", WRAPPER_CALLS // 10)
    if hasattr(gather_mod, "gather_ndt_flags"):
        out["gather_ndt_flags"] = call_cost(
            lambda: gather_mod.gather_ndt_flags(occ, count, ids, thr, n), "gather",
            WRAPPER_CALLS)
    out.update(p_wrapper_cost(*p_mods, inputs))
    emit({"phase": "wrapper_cost", "root": os.path.abspath(root),
          "package": os.path.dirname(os.path.dirname(os.path.abspath(expand_mod.__file__))),
          **out})
    return out


def wrappers_of(root: str) -> int:
    """``--wrappers-of DIR``: the wrapper_cost line of the port in the
    checkout at DIR (another commit unpacked with ``git archive`` whose
    wrappers take this one's arguments and launch its kernels, or this
    one), on inputs this checkout builds, so that one harness times two
    commits' wrappers in one call.  DIR's kernels are built in DIR."""
    inputs = wrapper_inputs()
    torch.cuda.synchronize()
    for name in [m for m in sys.modules if m == "ohm_tpu_torch" or m.startswith("ohm_tpu_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, os.path.abspath(root))
    expand_mod = importlib.import_module("ohm_tpu_torch.ops.expand_cuda")
    gather_mod = importlib.import_module("ohm_tpu_torch.ops.gather_cuda")
    deposit_mod = importlib.import_module("ohm_tpu_torch.ops.deposit_cuda")
    p_mods = tuple(importlib.import_module(f"ohm_tpu_torch.ops.{m}")
                   for m in ("slotgrid_cuda", "probes_cuda"))
    if not expand_mod.__file__.startswith(os.path.abspath(root)):
        raise AssertionError(f"imported {expand_mod.__file__}, not the port under {root}")
    importlib.import_module("ohm_tpu_torch.ops._build").load()
    phase_wrapper_cost(expand_mod, gather_mod, deposit_mod, inputs, root, p_mods)
    return 0


def probe_work() -> dict:
    """Each probe's work as (bytes, operations, bf16 tensor-core operations):
    its input and output bytes (the bulk copy reads only its four rows), an
    operation an output element (the loop: one a trip), and the one-hot
    product counted densely (2 x 64 x 512 a record)."""
    out = {}
    for name, args in probes_cuda.probe_inputs("cpu").items():
        want = probes_cuda.expected_outputs()[name]
        nbytes = sum(a.numel() * a.element_size() for a in args) + want.nbytes
        ops, tensor_ops = want.size, 0
        if name == "dyn_offset_dma":
            nbytes = 4 + 2 * want.nbytes
        if name == "dynamic_fori":
            ops = int(args[0][0])
        if name == "onehot_mxu_dot":
            ops, tensor_ops = args[0].numel(), 2 * want.size * args[0].numel()
        out[name] = (nbytes, ops, tensor_ops)
    return out


def onehot_cases() -> dict:
    """The one-hot probe's random inputs on the card: 1, 4 and 8 rows of 128
    records in [0, 32768) (seeds 1, 4, 8), and 512 records in one cell."""
    cases = {f"rows_{rows}": np.random.default_rng(rows).integers(0, probe_deposit.V, (rows, 128))
             for rows in (1, 4, 8)}
    cases["one_cell"] = np.full((4, 128), 12_345)
    return {k: torch.from_numpy(v.astype(np.int32)).cuda() for k, v in cases.items()}


def check_probes(found: dict) -> dict:
    """Each probe's kernel against its plain version and its expected array,
    bit for bit, beside what the probe path reported; the one-hot product on
    onehot_cases against its plain version and bincount."""
    inputs = probes_cuda.probe_inputs("cuda")
    expected = probes_cuda.expected_outputs()
    rows = {}
    for name, fn in probes_cuda.PROBES.items():
        out_k = fn(*inputs[name])
        out_p = probes_cuda.PLAIN[name](*inputs[name])
        torch.cuda.synchronize()
        same = torch.equal(out_k.view(torch.int32), out_p.view(torch.int32))
        rows[name] = {"status": found[name][0], "first_values": found[name][1],
                      "max_abs_err": float((out_k.double() - out_p.double()).abs().max()),
                      "bit_identical": bool(same),
                      "equals_expected": bool(np.array_equal(out_k.cpu().numpy(), expected[name]))}
    onehot = {}
    for case, v in onehot_cases().items():
        out_k = probes_cuda.onehot_mma(v)
        out_p = probes_cuda.onehot_mma_reference(v)
        out_l = PROBE_LIBRARY_CALLS["onehot_mxu_dot"](v)
        torch.cuda.synchronize()
        onehot[case] = {"records": v.numel(), "largest_cell": float(out_k.max()),
                        "bit_identical": bool(same_bits(out_k, out_p)),
                        "equals_bincount": bool(same_bits(out_k, out_l))}
        rows["onehot_mxu_dot"]["max_abs_err"] = max(
            rows["onehot_mxu_dot"]["max_abs_err"], float((out_k - out_p).abs().max()))
    emit({"phase": "p_probes", "tolerance": 0, "probes": rows, "onehot_random": onehot})
    bad = {n: r for n, r in rows.items()
           if r["status"] != "OK" or not (r["bit_identical"] and r["equals_expected"])}
    bad.update({c: r for c, r in onehot.items()
                if not (r["bit_identical"] and r["equals_bincount"])})
    if bad:
        raise AssertionError(f"a deposit probe failed or differs from its plain version: {bad}")
    return rows


def k3_on_probe_stream(keys, occ, c: int) -> dict:
    """K3 as the probe calls it (probe_deposit.k3_deposit) on a probe stream
    against its plain version and a second run of itself, bit for bit; the
    arena ``occ`` (f32[c * V]) gains its sentinel element."""
    cfg = probe_deposit.k3_config(c)
    occ = torch.cat([occ, torch.full((1,), float("inf"), device=occ.device)])
    out_k = probe_deposit.k3_deposit(keys, occ.clone(), cfg)
    out_2 = probe_deposit.k3_deposit(keys, occ.clone(), cfg)
    none = torch.empty(0, dtype=torch.int32, device=keys.device)
    out_p = deposit_cuda.deposit_and_sweep_ndt_reference(
        occ.clone(), keys, none, (none, none.float()), cfg)[0]
    torch.cuda.synchronize()
    return {"k3_bit_identical": bool(same_bits(out_k, out_p)),
            "k3_two_runs_identical": bool(same_bits(out_k, out_2)),
            "k3_max_abs_err": finite_err(out_k, out_p)}


def slotgrid_against_plain(keys, occ, c: int) -> tuple[bool, float]:
    """The slot-grid kernel on ``keys`` against its plain version and a
    second run, fused and unfused: (all bit-identical, largest finite
    error)."""
    same, err = True, 0.0
    for fuse in (True, False):
        kw = {"fuse_sweep": fuse, **probe_deposit.SWEEP}
        out_k = slotgrid_cuda.slotgrid_deposit(keys, occ.clone(), c, **kw)
        out_2 = slotgrid_cuda.slotgrid_deposit(keys, occ.clone(), c, **kw)
        out_p = slotgrid_cuda.slotgrid_deposit_reference(keys, occ.clone(), c, **kw)
        torch.cuda.synchronize()
        same = same and same_bits(out_k, out_p) and same_bits(out_k, out_2)
        err = max(err, finite_err(out_k, out_p))
    return bool(same), err


def check_slotgrid(keys, occ_flat, c: int) -> dict:
    """The slot-grid kernel against its plain version on the card and a
    second run of itself, bit for bit, fused and unfused, at full size, on
    the edge streams and on a ragged tail (keys below 0 and past the slots,
    a length no multiple of 4); K3 against its plain version on the same
    streams; the fused result against the f64 reference (f32 roundings, no
    gate), the scatter yardstick and K3 (bit for bit)."""
    n_vox = c * probe_deposit.V
    rows, errs = {}, []
    same, err = slotgrid_against_plain(keys, occ_flat, c)
    rows["bench"] = {"bit_identical": same, "max_abs_err": err}
    errs.append(err)
    for name in probe_deposit.EDGE_STREAMS:
        ek, eo, ec = probe_deposit.edge_stream(name)
        ek, eo = torch.from_numpy(ek).cuda(), torch.from_numpy(eo).cuda()
        same, err = slotgrid_against_plain(ek, eo, ec)
        errs.append(err)
        k3 = k3_on_probe_stream(ek, eo, ec)
        errs.append(k3.pop("k3_max_abs_err"))
        rows[f"edge_{name}"] = {"bit_identical": bool(same and all(k3.values())), **k3}
    ek, eo, ec = probe_deposit.edge_stream("run_across_tiles")
    ragged = np.concatenate([[-9, -2], ek[:-518], np.full(5, 2**31 - 1)]).astype(np.int32)
    eo = np.concatenate([eo, np.full(7, 3.0, np.float32)])
    same, err = slotgrid_against_plain(torch.from_numpy(ragged).cuda(),
                                       torch.from_numpy(eo).cuda(), ec)
    rows["ragged_tail"] = {"keys": int(ragged.size), "bit_identical": same}
    errs.append(err)
    fused = slotgrid_cuda.slotgrid_deposit(keys, occ_flat.clone(), c, **probe_deposit.SWEEP)
    ref = probe_deposit.np_reference(keys.cpu().numpy(), occ_flat[:n_vox].cpu().numpy(), c)
    host = fused[:n_vox].cpu().numpy()
    with np.errstate(invalid="ignore"):
        worst = float(np.max(np.abs(np.nan_to_num(host - ref, posinf=0))))
    yardstick = slotgrid_cuda.scatter_deposit(keys, occ_flat, c, **probe_deposit.SWEEP)[:n_vox]
    k3 = probe_deposit.k3_deposit(keys, occ_flat.clone(), probe_deposit.k3_config(c))[:n_vox]
    k3_full = k3_on_probe_stream(keys, occ_flat[:n_vox], c)
    errs.append(k3_full.pop("k3_max_abs_err"))
    rows["k3"] = {"bit_identical": bool(all(k3_full.values())), **k3_full}
    flat = keys >> 1
    touched = torch.unique(flat[(flat >= 0) & (flat < n_vox)])
    row = {"keys": keys.numel(), "slots": c, "touched_voxels": touched.numel(),
           "touched_sectors": int(torch.unique(touched >> 3).numel()),
           "largest_run_records": probe_deposit.largest_run(keys, c),
           "largest_count": probe_deposit.largest_count(keys, c), **rows,
           "f64_reference": {"mismatches": int(np.sum(host != ref)), "worst": worst},
           "scatter_bit_mismatches": int((fused[:n_vox].view(torch.int32)
                                          != yardstick.view(torch.int32)).sum()),
           "k3_bit_mismatches": int((fused[:n_vox].view(torch.int32)
                                     != k3.view(torch.int32)).sum()),
           "k3_vs_scatter_bit_mismatches": int((k3.view(torch.int32)
                                                != yardstick.view(torch.int32)).sum())}
    emit({"phase": "p_slotgrid", "tolerance": 0, **row})
    ok = (all(r["bit_identical"] for r in rows.values()) and row["scatter_bit_mismatches"] == 0
          and row["k3_bit_mismatches"] == 0 and row["k3_vs_scatter_bit_mismatches"] == 0
          and row["largest_count"] < deposit_cuda.COUNT_CAP)
    if not ok:
        raise AssertionError(f"the slot-grid deposit differs: {row}")
    return {**row, "max_abs_err": max(errs)}


def probe_times() -> dict:
    """Each probe alone beside the empty kernel (the launch floor) and its
    library call's device time, and each probe's wrapper call beside its
    plain version and its library call, in alternated turns."""
    inputs = probes_cuda.probe_inputs("cuda")
    out = {}
    for name, fn in probes_cuda.PROBES.items():
        args = inputs[name]
        lib = PROBE_LIBRARY_CALLS[name]
        alone = {"kernel": (lambda: fn(*args), PROBE_KERNELS[name]),
                 "launch_floor": (probes_cuda.empty_kernel, EMPTY_KERNEL)}
        calls = {"kernel": lambda: fn(*args),
                 "plain": lambda: probes_cuda.PLAIN[name](*args)}
        if callable(lib):
            alone["library"] = (lambda: lib(*args), "")
            calls["library"] = lambda: lib(*args)
        a = alternated_ms(alone, turns=4, measure=device_alone_ms)
        c = alternated_ms(calls, turns=4)
        alone_ms, floor_ms = a["kernel"]["median_ms"], a["launch_floor"]["median_ms"]
        out[name] = {"alone_ms": alone_ms, "launch_floor_alone_ms": floor_ms,
                     "alone_over_floor": alone_ms / floor_ms if alone_ms and floor_ms else None,
                     "library_device_ms": a["library"]["median_ms"] if callable(lib) else None,
                     "ms": c["kernel"]["median_ms"], "plain_ms": c["plain"]["median_ms"],
                     "library_ms": c["library"]["median_ms"] if callable(lib) else None,
                     "library": None if callable(lib) else lib,
                     "alone_turns": a, "call_turns": c}
    return out


def phase_p() -> dict:
    """P: the deposit probe's own path, through its entry point at full
    size, counted; then each probe and the slot-grid kernel against their
    plain versions and the yardsticks, and their times (alone, as calls,
    beside the launch floor, the library calls, K3, scatter_deposit and
    onehot_deposit on the same stream)."""
    counters = {**{f"probe:{n}": fn for n, fn in probes_cuda.PROBES.items()},
                "slotgrid_deposit": slotgrid_cuda.slotgrid_deposit}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    found = probe_deposit.main(["--iters", "5"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    emit({"phase": "p_path", "seconds": seconds, "launches": launches, "ok": found["ok"],
          **{k: found[k] for k in ("slotgrid", "onehot", "scatter")}})
    if not found["ok"] or min(launches.values()) <= 0:
        raise AssertionError(f"the deposit probe failed or a kernel never launched: {launches}")

    probes = check_probes(found["probes"])
    n, c, live = probe_deposit.N, probe_deposit.C, probe_deposit.LIVE
    keys = torch.from_numpy(probe_deposit.make_stream(n, c, live)).cuda()
    occ_flat = torch.from_numpy(probe_deposit.initial_occupancy(n, c)).cuda()
    grid = check_slotgrid(keys, occ_flat, c)

    p_times = probe_times()
    n_vox = c * probe_deposit.V
    occ_k, occ_p = occ_flat.clone(), occ_flat.clone()
    sweep = probe_deposit.SWEEP
    fused_call = lambda: slotgrid_cuda.slotgrid_deposit(keys, occ_k, c, **sweep)  # noqa: E731
    counts_call = lambda: slotgrid_cuda.slotgrid_deposit(  # noqa: E731
        keys, occ_k, c, fuse_sweep=False, **sweep)
    plain_ms, kernel_ms = plain_vs_kernel_ms(
        lambda: slotgrid_cuda.slotgrid_deposit_reference(keys, occ_p, c, **sweep), fused_call)
    counts_ms = cuda_ms(counts_call)
    profs = alternated_ms({"fused": (fused_call, SLOTGRID_KERNEL),
                           "counts": (counts_call, SLOTGRID_KERNEL),
                           "counts_call": (counts_call, "")},
                          turns=4, measure=device_alone_ms)
    cfg = probe_deposit.k3_config(c)
    occ_3 = occ_flat.clone()
    scatter_ms, k3_ms = plain_vs_kernel_ms(
        lambda: slotgrid_cuda.scatter_deposit(keys, occ_flat, c, **sweep),
        lambda: probe_deposit.k3_deposit(keys, occ_3, cfg))
    onehot_ms = cuda_ms(lambda: slotgrid_cuda.onehot_deposit(keys, occ_flat[:n_vox], c, **sweep),
                        reps=5)
    touched = grid["touched_voxels"]
    work = probe_work()
    times = {"slotgrid_ms": kernel_ms, "slotgrid_plain_ms": plain_ms,
             "slotgrid_counts_ms": counts_ms,
             "slotgrid_kernel_alone_ms": profs["fused"]["median_ms"],
             "slotgrid_device_ops_per_call": device_ops_per_call(fused_call),
             "slotgrid_counts_kernel_alone_ms": profs["counts"]["median_ms"],
             "slotgrid_counts_device_ms_per_call": profs["counts_call"]["median_ms"],
             "slotgrid_counts_device_ops_per_call": device_ops_per_call(counts_call),
             "slotgrid_alone_turns": profs,
             "k3_ms": k3_ms, "scatter_deposit_ms": scatter_ms, "onehot_deposit_ms": onehot_ms,
             "probe_ms": {k: v["ms"] for k, v in p_times.items()},
             "probe_plain_ms": {k: v["plain_ms"] for k, v in p_times.items()}}
    # The function's work: each key read once, each touched voxel read and
    # written once; ~5 operations a key, ~12 a touched voxel's sweep.
    slot_bound = bound(4 * keys.numel() + 8 * touched, 5 * keys.numel() + 12 * touched)
    # What this design can reach: the keys, and the distinct 32-byte sectors
    # of the touched voxels read and written (scattered accesses move whole
    # sectors).
    design = bound(4 * keys.numel() + 2 * 32 * grid["touched_sectors"], 0)
    probe_bound = bound(*(sum(w[i] for w in work.values()) for i in range(3)))
    emit({"phase": "p_times", **times, "slotgrid_bound": slot_bound,
          "slotgrid_design_bound": {**design, "touched_sectors": grid["touched_sectors"]},
          "design_bound_ms": design["bound_ms"],
          "largest_run_records": grid["largest_run_records"],
          "probes": p_times, "probe_bounds": {name: bound(*w) for name, w in work.items()}})
    return {"launches": {"deposit_probes": sum(v for k, v in launches.items()
                                               if k.startswith("probe:")),
                         "slotgrid_deposit": launches["slotgrid_deposit"]},
            "probe_launches": {k.split(":", 1)[1]: v for k, v in launches.items()
                               if k.startswith("probe:")},
            "ms": {"deposit_probes": sum(times["probe_ms"].values()),
                   "slotgrid_deposit": kernel_ms},
            "plain_ms": {"deposit_probes": sum(times["probe_plain_ms"].values()),
                         "slotgrid_deposit": plain_ms},
            "bound": {"deposit_probes": probe_bound, "slotgrid_deposit": slot_bound},
            # No one call computes all five probes, nor the deposit and its
            # sweep; each probe's library call is in the probes' entries.
            "library_ms": {"deposit_probes": None, "slotgrid_deposit": None},
            "max_abs_err": {"deposit_probes": max(r["max_abs_err"] for r in probes.values()),
                            "slotgrid_deposit": grid["max_abs_err"]},
            "times": times, "probes": p_times, "design": design,
            "probe_bounds": {name: bound(*w) for name, w in work.items()},
            "largest_run_records": grid["largest_run_records"]}


APPS_MODE_POINTS = 16384
#: ohmcmp's integer epsilon for the packed mean code (the "coord" member):
#: one quantum in each of its three 10-bit fields; every other member exact.
#: The card and the CPU may differ by one quantum on a few mean codes
#: (PORT_TOL), and occupancy_files_agree holds them to that rule.
MEAN_CODE_EPSILON = 1 + (1 << 10) + (1 << 20)
HEIGHTMAP_CLEARANCE = 0.5
HEIGHTMAP_RESOLUTION = 0.1
HEIGHTMAP_CAPACITY = 1024
HEIGHTMAP_BATCHES = 4
#: The kernels each ohmpop mode launches on the card.
APP_KERNELS = {
    "occupancy": {"expand_keys": expand_cuda.expand_keys,
                  "deposit_and_sweep": deposit_cuda.deposit_and_sweep},
    "ndt": {"expand_keys": expand_cuda.expand_keys,
            "gather_ndt_flags": gather_cuda.gather_ndt_flags,
            "deposit_and_sweep_ndt": deposit_cuda.deposit_and_sweep_ndt},
    "tsdf": {"expand_keys": expand_cuda.expand_keys, "tsdf_visits": tsdf_cuda.tsdf_visits},
}
APP_KERNELS["ndt-tm"] = APP_KERNELS["ndt"]


def layered_heightmap(m) -> tuple[float, int, dict]:
    """Build the layered heightmap (LAYERED_FILL, min clearance 0.5) of
    ``m``; returns its seconds, its voxel count and (region, member) -> bytes
    of its heightmap layer."""
    hm = Heightmap(min_clearance=HEIGHTMAP_CLEARANCE)
    hm.mode = HeightmapMode.LAYERED_FILL
    t0 = time.perf_counter()
    n = hm.build_heightmap(m)
    seconds = time.perf_counter() - t0
    out = hm.heightmap()
    li = out.layer_index(HEIGHTMAP_LAYER)
    layer = {(k, name): np.ascontiguousarray(c.layers[li][name]).tobytes()
             for k, c in out.chunks.items() for name in c.layers[li].dtype.names}
    return seconds, n, layer


def phase_ndt_tm_pipeline(tm_mapper, integrate_sec: float, sync_integrate_sec: float,
                          queries: dict) -> dict:
    """scripts/bench_modes.py's config 5 row: the NDT-TM frame's integrate
    through the worker (ndt_tm_integrate_rays_per_sec), its warm clearance
    field (queries) and the layered heightmap of its map, built here; the
    synchronous frame's seconds beside them."""
    hm_sec, n, _ = layered_heightmap(tm_mapper.map)
    if n <= 0:
        raise AssertionError("the NDT-TM frame's layered heightmap is empty")
    row = {"metric": "ndt_tm_pipeline_frame_sec",
           "value": integrate_sec + queries["clearance_sec"] + hm_sec, "unit": "s",
           "rays": TM_FRAME_RAYS, "integrate_sec": integrate_sec,
           "sync_integrate_sec": sync_integrate_sec,
           "clearance_sec": queries["clearance_sec"],
           "clearance_incremental_sec": queries["clearance_incremental_sec"],
           "clearance_incremental_regions": queries["clearance_incremental_regions"],
           "heightmap_sec": hm_sec, "heightmap_voxels": n,
           "rays_per_sec": TM_FRAME_RAYS / integrate_sec}
    emit(row)
    return row


@contextlib.contextmanager
def harness_runs():
    """Within the block, every MapHarness that runs, in order (ohmpop builds
    one a call), so its stats can be read after ohmpop returns."""
    run = app_harness.MapHarness.run
    runs = []

    def recording(self):
        runs.append(self)
        return run(self)
    app_harness.MapHarness.run = recording
    try:
        yield runs
    finally:
        app_harness.MapHarness.run = run


def write_outdoor_laz(directory: str) -> tuple[str, str]:
    """scripts/bench_modes.py config 2's .laz: 12 x 8192 outdoor_rays
    samples (seed 7) through the port's LASzip writer, with a timestamp a
    point and the two-line static trajectory of the sensor."""
    rng = np.random.default_rng(OUTDOOR_SEED)
    return write_laz_cloud([outdoor_rays(RAYS_PER_BATCH, rng) for _ in range(OUTDOOR_BATCHES)],
                           directory)


def ohmpop_run(laz, traj, base, device, mode="occupancy", *extra):
    """ohmpop.main on the .laz; returns its harness's stats and, on the
    card, the launches of the mode's kernels (every count 0 just before the
    call)."""
    counters = APP_KERNELS[mode]
    zero_counts(counters)
    with harness_runs() as runs:
        rc = ohmpop.main([laz, traj, "-o", base, "--resolution", str(OUTDOOR_RESOLUTION),
                          "--arena-capacity", str(OUTDOOR_CAPACITY),
                          "--batch-size", str(RAYS_PER_BATCH), "--mode", mode, "-q",
                          "--device", device, *extra])
    launches = read_counts(counters)
    if rc != 0 or len(runs) != 1:
        raise AssertionError(f"ohmpop --device {device} --mode {mode} returned {rc}")
    if device == "cuda" and min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of ohmpop's {mode} path never launched: {launches}")
    return runs[0].stats, launches


def same_file_bytes(a_path: str, b_path: str) -> bool:
    with open(a_path, "rb") as f, open(b_path, "rb") as g:
        return f.read() == g.read()


def occupancy_files_agree(a_path: str, b_path: str) -> dict:
    """Two occupancy + voxel-mean .ohm files, loaded with the port: the same
    chunks, occupancy and mean counts bit-identical, mean codes identical on
    >= 99.9% of written voxels and within one quantum elsewhere."""
    a, b = (layer_members(load_ohm(p)[0]) for p in (a_path, b_path))
    ok = a.keys() == b.keys() and all(a[m].keys() == b[m].keys() for m in a)
    for member in ("occupancy", "count"):
        ok = ok and all(np.array_equal(a[member][k].view(np.uint32), b[member][k].view(np.uint32))
                        for k in a[member])
    mean = code_agreement(a["coord"], b["coord"], MEAN_FIELDS)
    ok = ok and mean["identical"] >= PORT_TOL["mean_code_identical"] and mean["max_quanta"] <= 1
    observed = sum(int(np.isfinite(v).sum()) for v in a["occupancy"].values())
    return {"regions": len(a["occupancy"]), "observed_voxels": observed, "mean_codes": mean,
            "file_bytes_equal": same_file_bytes(a_path, b_path), "ok": bool(ok and observed > 0)}


def run_cli(main_fn, argv) -> dict:
    """One CLI's main in this process, its standard output kept aside."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main_fn(argv)
    lines = out.getvalue().splitlines()
    return {"rc": rc, "lines": len(lines), "last": lines[-1] if lines else ""}


def phase_apps() -> dict:
    """ohmpop and the other CLIs on a .laz, on the card and on the CPU, and
    the layered heightmap at scripts/bench_modes.py config 4's size."""
    row = {}
    with tempfile.TemporaryDirectory() as d:
        laz, traj = write_outdoor_laz(d)
        t0 = time.perf_counter()
        loader = SlamCloudLoader(laz, traj)
        n_points = 0
        while (batch := loader.next_batch(RAYS_PER_BATCH)) is not None:
            n_points += len(batch[0]) // 2
        row["laz_read_s"] = time.perf_counter() - t0
        row["points"] = n_points
        row["laz_bytes"] = os.path.getsize(laz)

        # 1. The .laz round trip: twice on the card, once on the CPU.
        paths, stats, launches = {}, {}, {}
        for run in ("cuda", "cuda_again", "cpu"):
            paths[run] = os.path.join(d, run)
            stats[run], launches[run] = ohmpop_run(laz, traj, paths[run], run.split("_")[0],
                                                   "occupancy", "--voxel-mean", "--save-info")
        row["ohmpop"] = {
            "rays_per_sec": stats["cuda"]["rays_per_sec"],
            "rays_per_sec_again": stats["cuda_again"]["rays_per_sec"],
            "cpu_rays_per_sec": stats["cpu"]["rays_per_sec"],
            "rays": stats["cuda"]["rays"], "regions": stats["cuda"]["regions"],
            "launches": launches["cuda"],
            "card_vs_cpu": occupancy_files_agree(paths["cuda"] + ".ohm", paths["cpu"] + ".ohm"),
            "card_runs_file_bytes_equal": same_file_bytes(paths["cuda"] + ".ohm",
                                                          paths["cuda_again"] + ".ohm")}
        ok = (row["ohmpop"]["card_vs_cpu"]["ok"] and row["ohmpop"]["card_runs_file_bytes_equal"]
              and stats["cuda"]["rays"] == n_points)

        # 2. The other mapper modes, not timed.
        row["modes"] = {}
        for mode in ("ndt", "ndt-tm", "tsdf"):
            base = {dev: os.path.join(d, f"{mode}-{dev}") for dev in ("cuda", "cpu")}
            _, mode_launches = ohmpop_run(laz, traj, base["cuda"], "cuda", mode, "--point-limit",
                                          str(APPS_MODE_POINTS), "--no-cloud")
            ohmpop_run(laz, traj, base["cpu"], "cpu", mode, "--point-limit",
                       str(APPS_MODE_POINTS), "--no-cloud")
            maps = [load_ohm(base[dev] + ".ohm")[0] for dev in ("cuda", "cpu")]
            agree = (tsdf_card_vs_cpu(*map(tsdf_layers, maps)) if mode == "tsdf"
                     else compare_port(*maps))
            row["modes"][mode] = {"card_vs_cpu": agree, "launches": mode_launches}
            ok = ok and agree["ok"]

        # 3. The CLIs on the card's .ohm.
        card_ohm, hm_ohm = paths["cuda"] + ".ohm", os.path.join(d, "hm.ohm")
        row["clis"] = {
            "ohminfo": run_cli(ohminfo.main, [card_ohm, "--voxel-stats"]),
            "ohm2ply": run_cli(ohm2ply.main, [card_ohm, os.path.join(d, "occ.ply")]),
            "ohmheightmap": run_cli(ohmheightmap.main, [card_ohm, hm_ohm, "--clearance",
                                                        str(HEIGHTMAP_CLEARANCE)]),
            "ohmhm2img": run_cli(ohmhm2img.main, [hm_ohm, os.path.join(d, "hm.png")]),
            "ohmcmp": run_cli(ohmcmp.main, [card_ohm, paths["cpu"] + ".ohm", "--member-tolerance",
                                            f"coord={MEAN_CODE_EPSILON}"]),
            "ohmquery": run_cli(ohmquery.main, [card_ohm, "rays", "--device", "cuda",
                                                "--ray", "0", "0", "1.5", "30", "0", "0",
                                                "--ray", "0", "0", "1.5", "0", "30", "-1"]),
        }
        ok = ok and all(c["rc"] == 0 for c in row["clis"].values())

    # 4. The layered heightmap on config 4's occupancy map, built on the
    # card and on the CPU.
    rng = np.random.default_rng(SEED)
    batches = [box_scene_rays(RAYS_PER_BATCH, rng) for _ in range(HEIGHTMAP_BATCHES)]
    built = {}
    for device in ("cuda", "cpu"):
        m = OccupancyMap(resolution=HEIGHTMAP_RESOLUTION, flags=MapFlag.NONE)
        mapper = TorchRayMapper(m, capacity=HEIGHTMAP_CAPACITY, device=device)
        for rays in batches:
            mapper.integrate_rays(rays)
        mapper.sync_voxels()
        built[device] = (m, *layered_heightmap(m))
    m, seconds, n, layer = built["cuda"]
    source = sum(int(np.isfinite(v).sum()) for v in _host_occupancy(m).values())
    same = layer == built["cpu"][3]
    row["layered_heightmap"] = {"layered_heightmap_build_sec": seconds,
                                "cpu_map_build_sec": built["cpu"][1], "heightmap_voxels": n,
                                "source_voxels": source, "card_vs_cpu_bit_identical": same}
    ok = ok and same and n > 0
    row["ok"] = bool(ok)
    emit({"metric": "apps", **row})
    if not ok:
        raise AssertionError("the apps phase failed")
    return row


#: The lines each of the port's two bench commands must print, by metric.
ROUTES_BATCHES = 8  # 4 sizing batches (row_cap, the delta window), then 4 more
ROUTES_NDT_BATCHES = 6


def log_routes(mapper) -> list:
    """The route of every batch ``mapper`` integrates from now on, in order
    (its ``last_route`` after each device step; a chained group's once a
    batch)."""
    routes = []
    step, chain = mapper._integrate_device, mapper._dispatch_chain

    def stepped(*args):
        out = step(*args)
        routes.append(mapper.last_route)
        return out

    def chained(stacked, pending, cfg):
        chain(stacked, pending, cfg)
        routes.extend([mapper.last_route] * len(pending))

    mapper._integrate_device = stepped
    mapper._dispatch_chain = chained
    return routes


def runs_of(routes: list) -> list:
    """A route sequence as [route, batches in a row] pairs, in order."""
    out = []
    for r in routes:
        if out and out[-1][0] == r:
            out[-1][1] += 1
        else:
            out.append([r, 1])
    return out


def route_mapper(kind: str, fused: str, scene: str, **kw):
    """A mapper of the apply_routes phase: the box (bench.py's, 0.1 m, 512
    slots; with the traversal layer unless ``kind`` is "delta") or the
    outdoor .laz batches (config 2's, 0.2 m, 1024 slots, voxel mean), or
    NDT-OM with traversal (0.2 m, 1024 slots)."""
    with environ("OHM_FUSED", fused):
        if scene == "ndt":
            return TorchNdtMap(OccupancyMap(resolution=NDT_RESOLUTION, flags=MapFlag.TRAVERSAL),
                               capacity=NDT_CAPACITY, device="cuda", **kw)
        if scene == "box":
            flags = MapFlag.NONE if kind == "delta" else MapFlag.TRAVERSAL
            m = OccupancyMap(resolution=RESOLUTION, flags=flags)
            return TorchRayMapper(m, capacity=CAPACITY, device="cuda", **kw)
        m = OccupancyMap(resolution=OUTDOOR_RESOLUTION, flags=MapFlag.VOXEL_MEAN)
        return TorchRayMapper(m, capacity=OUTDOOR_CAPACITY, device="cuda", **kw)


def route_layers(m) -> dict:
    """The host map's occupancy, traversal and mean members, by (region,
    member), after sync_voxels."""
    out = {}
    for layer, members in ((OCCUPANCY_LAYER, ("occupancy",)), (TRAVERSAL_LAYER, ("traversal",)),
                           (MEAN_LAYER, ("coord", "count"))):
        i = m.layer_index(layer)
        if i < 0:
            continue
        for key, c in m.chunks.items():
            for name in members:
                out[(key, name)] = np.array(c.layers[i][name])
    return out


def compare_route(a: dict, b: dict) -> dict:
    """Two route runs' host layers (the members both have): the same
    regions, occupancy (and mean) bits, traversal's largest difference."""
    regions = lambda d: {k[0] for k in d if k[1] == "occupancy"}  # noqa: E731
    if regions(a) != regions(b):
        return {"same_regions": False, "occupancy_bits": False}
    both = a.keys() & b.keys()
    bits = all(np.array_equal(a[k].view(np.uint32), b[k].view(np.uint32))
               for k in both if k[1] != "traversal")
    trav = max((float(np.abs(a[k] - b[k]).max()) for k in both if k[1] == "traversal"),
               default=None)
    return {"same_regions": True, "occupancy_bits": bool(bits),
            "traversal_max_abs_diff": trav}


def run_route(mapper, batches, worker: bool = False) -> dict:
    """``batches`` through ``mapper``, its shape caches primed, then
    sync_voxels: the routes taken, rays/s and the host layers.  With
    ``worker`` the sizing half goes through the worker thread (coalesced
    uploads) and the rest as one group of the worker's (_integrate_group:
    one upload, a chain)."""
    routes = log_routes(mapper)
    mapper.prime_caps(batches)
    half = len(batches) // 2
    t0 = time.perf_counter()
    if worker:
        for b in batches[:half]:
            mapper.integrate_rays_async(b)
        mapper.flush()
        mapper._integrate_group([(b, None, None, 0) for b in batches[half:]])
    else:
        for b in batches:
            mapper.integrate_rays(b)
    torch.cuda.synchronize()
    rps = sum(len(b) // 2 for b in batches) / (time.perf_counter() - t0)
    mapper.sync_voxels()
    stats = mapper.stats
    for name in ("missed_updates", "overflow", "compaction_dropped", "dropped_updates"):
        if stats[name]:
            raise AssertionError(f"a route reported {name}={stats[name]}")
    return {"routes": routes, "rays_per_sec": rps, "layers": route_layers(mapper.map)}


def route_costs(mapper, batches) -> dict:
    """One route's costs a batch on resident wires (the arena holds every
    region): host prep ms, device ms (host clock to a synchronize) and
    K1's and K2's launches over one pass, then device operations
    (torch.profiler) and host syncs (torch's sync debug mode) of one
    batch, each over the route ``mapper`` takes now."""
    counters = {"expand_keys": expand_cuda.expand_keys,
                "deposit_and_sweep": deposit_cuda.deposit_and_sweep}
    zero_counts(counters)
    host_prep_ms, device_ms, wires, setups = device_and_host_ms(mapper, batches)
    launches = {k: v / len(wires) for k, v in read_counts(counters).items()}
    w, (_, cfg, n) = wires[0], setups[0]
    ops = device_profile(lambda: mapper._dispatch(w, cfg, n), reps=4)["device_ops"]
    syncs = count_host_syncs(lambda: mapper._dispatch(w, cfg, n))
    mapper._drain_stats()
    return {"route": mapper.last_route, "host_prep_ms_per_batch": host_prep_ms,
            "device_ms_per_batch": device_ms, "device_ops_per_batch": ops,
            "host_syncs_per_batch": syncs, "launches_per_batch": launches}


def chain_costs(mapper, batches) -> tuple[dict, tuple]:
    """The chained group's costs a batch: one stacked upload of four wires
    (pinned, one copy) and one chain, its device ms by the host clock to a
    synchronize and its K1/K2 launches, then device operations and host
    syncs of another.  Returns them and K1's first call in the chain."""
    setups = [mapper._rayflow_setup_host(b, None, None, 0) for b in batches[:mapper._coalesce]]
    pending = [(w, cfg, n, 0) for w, cfg, n in setups]
    cfg = mapper._chain_cfg(pending)
    if cfg is None:
        raise AssertionError("the chained group is not eligible")
    k = len(pending)
    stacked = mapper._upload([p[0] for p in pending])
    counters = {"expand_keys": expand_cuda.expand_keys,
                "deposit_and_sweep": deposit_cuda.deposit_and_sweep}
    torch.cuda.synchronize()
    zero_counts(counters)
    device_ms = fenced_seconds(lambda: mapper._dispatch_chain(stacked, pending, cfg),
                               "cuda") * 1e3 / k
    launches = {n: v / k for n, v in read_counts(counters).items()}
    ops = device_profile(lambda: mapper._dispatch_chain(stacked, pending, cfg),
                         reps=2)["device_ops"] / k
    # (A wrapped kernel counts its launches under the wrapper: this call's
    # are not counted.)
    with first_call_args(expand_cuda, "expand_keys") as k1_args:
        syncs = count_host_syncs(lambda: mapper._dispatch_chain(
            mapper._upload([p[0] for p in pending]), pending, cfg))
    mapper._drain_stats()
    return {"route": mapper.last_route, "device_ms_per_batch": device_ms,
            "device_ops_per_batch": ops, "host_syncs_per_group": syncs, "group": k,
            "launches_per_batch": launches}, k1_args[0]


def phase_apply_routes(default_routes: dict) -> dict:
    """The apply routes on the card (TorchRayMapper._integrate_device's
    routing, the reference's _dispatch order): on the box and on config 2's
    outdoor .laz batches, each route's mapper over the same batches, four
    to size the windows and four more: the split apply (OHM_FUSED=0), the
    fused row-local apply (OHM_FUSED=2), the delta path (delta_path=True),
    and the worker's coalesced and chained submission under each apply;
    occupancy (and mean) bits against the split run's, traversal within
    testing.fused_traversal_atol, the fused run again bit for bit; K1 on the fused,
    delta and chained routes against its plain version; each route's host
    and device ms, device operations, host syncs and launches a batch;
    NDT-OM with traversal, fused against K3; and the route the default
    mapper took on the box, outdoor, side-layer and NDT side-layer paths,
    batch by batch."""
    rng = np.random.default_rng(SEED)
    scenes = {"box": [box_scene_rays(RAYS_PER_BATCH, rng) for _ in range(ROUTES_BATCHES)],
              "outdoor": laz_round_trip([outdoor_rays(RAYS_PER_BATCH, np.random.default_rng(
                  OUTDOOR_SEED)) for _ in range(ROUTES_BATCHES)], RAYS_PER_BATCH)}
    out = {"phase": "apply_routes", "default_routes": {k: runs_of(v)
                                                      for k, v in default_routes.items()},
           "traversal_atol": {"box": fused_traversal_atol(RESOLUTION),
                              "ndt": fused_traversal_atol(NDT_RESOLUTION)}}
    k1_errs, ok = [], True
    for scene, batches in scenes.items():
        runs = {"split": run_route(route_mapper("split", "0", scene), batches),
                "fused": run_route(route_mapper("fused", "2", scene), batches),
                "fused_again": run_route(route_mapper("fused", "2", scene), batches),
                "delta": run_route(route_mapper("delta", "0", scene, delta_path=True), batches),
                "worker_split": run_route(route_mapper("split", "0", scene), batches, True),
                "worker_fused": run_route(route_mapper("fused", "2", scene), batches, True)}
        want = {"split": "split", "fused": "fused", "fused_again": "fused", "delta": "delta",
                "worker_split": "chain_split", "worker_fused": "chain_fused"}
        row = {}
        for name, r in runs.items():
            cmp = compare_route(runs["fused" if name == "fused_again" else "split"]["layers"],
                                r["layers"])
            took = want[name] in r["routes"]
            trav = cmp.get("traversal_max_abs_diff")
            good = cmp["occupancy_bits"] and took and (
                trav is None or trav <= fused_traversal_atol(RESOLUTION))
            if name == "fused_again":
                good = good and trav in (None, 0.0)
            ok = ok and good
            row[name] = {"routes": runs_of(r["routes"]), "rays_per_sec": r["rays_per_sec"],
                         **cmp, "ok": bool(good)}
        # Each route's costs a batch on resident wires, and K1 on the fused,
        # delta and chained routes against its plain version.
        costs, k1_calls = {}, {}
        for kind, fused, kw in (("split", "0", {}), ("fused", "2", {}),
                                ("delta", "0", {"delta_path": True})):
            mapper = route_mapper(kind, fused, scene, **kw)
            mapper.prime_caps(batches)
            for b in batches[:4]:
                mapper.integrate_rays(b)
            if kind != "split":
                with first_call_args(expand_cuda, "expand_keys") as k1_args:
                    mapper.integrate_rays(batches[4])
                k1_calls[kind] = k1_args[0]
            costs[kind] = route_costs(mapper, batches[4:])
            if kind != "delta":
                costs[f"chain_{kind}"], k1_call = chain_costs(mapper, batches[4:])
                if kind == "fused":
                    k1_calls["chain_fused"] = k1_call
        torch.cuda.synchronize()
        for name, call in k1_calls.items():
            check = check_k1_call(call)
            row[f"k1_{name}"] = check
            k1_errs.append(check["max_abs_err"])
            ok = ok and check["bit_identical"]
        del k1_calls
        row["costs"] = costs
        # K1 launches on every route, K2 on the split ones only.
        for name, c in costs.items():
            n = c["launches_per_batch"]
            split = name in ("split", "chain_split")
            ok = ok and c["route"] == name and n["expand_keys"] == 1 and (
                n["deposit_and_sweep"] == 1 if split else n["deposit_and_sweep"] == 0)
        out[scene] = row
    # NDT-OM with traversal: the fused std-count deposit against K3.
    ndt_batches = [box_scene_rays(RAYS_PER_BATCH, rng) for _ in range(ROUTES_NDT_BATCHES)]
    ndt = {name: run_route(route_mapper(name, fused, "ndt"), ndt_batches)
           for name, fused in (("k3", "0"), ("fused", "2"))}
    cmp = compare_route(ndt["k3"]["layers"], ndt["fused"]["layers"])
    ndt_ok = (cmp["occupancy_bits"] and "fused" in ndt["fused"]["routes"]
              and cmp["traversal_max_abs_diff"] <= fused_traversal_atol(NDT_RESOLUTION))
    out["ndt"] = {name: runs_of(r["routes"]) for name, r in ndt.items()} | cmp | {"ok": ndt_ok}
    out["ok"] = bool(ok and ndt_ok)
    emit(out)
    if not out["ok"]:
        raise AssertionError("an apply route differs from the split apply or never ran")
    return {"max_abs_err": max(k1_errs),
            "launches_per_batch": {f"{scene}_{name}": c["launches_per_batch"]
                                   for scene in scenes for name, c in out[scene]["costs"].items()}}


PORT_BENCH_METRICS = {
    "bench": ("hardware_differential", "hardware_fused_differential",
              "occupancy_integrate_rays_per_sec", "bench_attribution"),
    "bench_modes": ("hardware_differential_worst_abs_err", "occupancy_mean_outdoor_rays_per_sec",
                    "rays_query_p50_ms", "sharded_n1_overhead", "ndt_om_rays_per_sec",
                    "tsdf_rays_per_sec", "layered_heightmap_build_sec"),
}
PORT_BENCH_TIMEOUT_S = 300


def run_port_bench(module: str, *args) -> dict:
    """``python -m module args`` from the repository root, in its own
    process: its exit code, seconds, JSON lines by metric and, on failure,
    the end of its standard error."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO, capture_output=True,
                          text=True, timeout=PORT_BENCH_TIMEOUT_S)
    lines = {}
    for ln in proc.stdout.splitlines():
        if ln.startswith("{"):
            row = json.loads(ln)
            lines[row["metric"]] = row
    out = {"rc": proc.returncode, "seconds": time.perf_counter() - t0, "lines": lines}
    if proc.returncode:
        out["stderr"] = proc.stderr[-2000:]
    return out


#: The api phase: three bench-shape box batches per mapper; the pinned
#: TSDF window and its batches (run on the card and on the CPU).
API_BATCHES = 3
API_KNOBS = ("OHM_RAYFLOW", "OHM_RAYFLOW_G", "OHM_SNAKE", "OHM_STREAM_BUDGET")
API_TSDF_RAYS = 2048
API_TSDF_CAP = 4096


def api_kernel_run(mapper, batches, counters: dict, kernel_names: tuple) -> dict:
    """``batches`` through ``mapper`` with the counts set to 0 just before
    and read just after; the stats; and torch.profiler's device rows of one
    more batch (device_profile: the named kernels' time alone, the device
    operations a batch)."""
    zero_counts(counters)
    for b in batches:
        mapper.integrate_rays(b)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    stats = mapper.stats
    for name in ("missed_updates", "overflow", "compaction_dropped", "dropped_updates"):
        if stats[name]:
            raise AssertionError(f"api: {type(mapper).__name__} reported {name}={stats[name]}")
    prof = device_profile(lambda: mapper.integrate_rays(batches[0]), kernel_names, reps=2)
    return {"launches": launches, "rays": stats["rays"], "segments": stats["segments"],
            "rayflow": mapper.rayflow, "stream_budget": mapper.stream_budget,
            "profiled_kernel_ms": prof["kernel_ms"], "device_ops_per_batch": prof["device_ops"]}


def api_tsdf_window(device, batches) -> tuple:
    """TorchTsdfMap, per_visit=False, under the pinned window: (its
    tsdf_layers, stats, scatter_cap)."""
    m = OccupancyMap(resolution=RESOLUTION, flags=MapFlag.NONE)
    mapper = TorchTsdfMap(m, TsdfOptions(per_visit=False), TSDF_CAPACITY, None, False,
                          API_TSDF_CAP, device)
    for b in batches:
        mapper.integrate_rays(b)
    mapper.sync_voxels()
    return tsdf_layers(m), mapper.stats, mapper.scatter_cap


def phase_api() -> dict:
    """The mappers as the reference's callers build them: positional, with
    no rayflow or stream_budget, and the knobs the port reads since it
    takes the reference's None defaults."""
    saved = {k: os.environ.pop(k) for k in API_KNOBS if k in os.environ}
    try:
        return _phase_api()
    finally:
        os.environ.update(saved)


def _phase_api() -> dict:
    rng = np.random.default_rng(SEED)
    batches = [box_scene_rays(RAYS_PER_BATCH, rng) for _ in range(API_BATCHES)]
    occ_counters = {"expand_keys": expand_cuda.expand_keys,
                    "deposit_and_sweep": deposit_cuda.deposit_and_sweep}
    runs = {}
    occ = TorchRayMapper(OccupancyMap(resolution=RESOLUTION, flags=MapFlag.NONE), CAPACITY)
    runs["occupancy"] = api_kernel_run(occ, batches, occ_counters,
                                       ("expand_keys_kernel",) + K2_KERNELS)
    ndt = TorchNdtMap(OccupancyMap(resolution=NDT_RESOLUTION, flags=MapFlag.NONE), None,
                      NDT_CAPACITY)
    runs["ndt"] = api_kernel_run(
        ndt, batches, {"expand_keys": expand_cuda.expand_keys,
                       "gather_ndt_flags": gather_cuda.gather_ndt_flags,
                       "deposit_and_sweep_ndt": deposit_cuda.deposit_and_sweep_ndt},
        ("expand_keys_kernel", "NdtFlagSource") + K3_KERNELS)
    tsdf = TorchTsdfMap(OccupancyMap(resolution=RESOLUTION, flags=MapFlag.NONE), None,
                        TSDF_CAPACITY)
    runs["tsdf"] = api_kernel_run(
        tsdf, batches, {"expand_keys": expand_cuda.expand_keys,
                        "tsdf_visits": tsdf_cuda.tsdf_visits},
        ("expand_keys_kernel",) + TSDF_VISITS_KERNELS)
    ok = all(r["rayflow"] and r["segments"] == r["rays"] == API_BATCHES * RAYS_PER_BATCH
             and r["stream_budget"] == 1 << 21 and min(r["launches"].values()) > 0
             and r["profiled_kernel_ms"] > 0 for r in runs.values())

    # The compaction grouping's knobs (G = 8 rays, no snake order) against
    # the defaults, each on a new map over the same batches.
    maps, sizes = [], []
    for knobs in ({}, {"OHM_RAYFLOW_G": "8", "OHM_SNAKE": "0"}):
        m = OccupancyMap(resolution=RESOLUTION, flags=MapFlag.NONE)
        mapper = TorchRayMapper(m, CAPACITY)
        seen, inner = [], mapper._dispatch

        def dispatch(upload, cfg, n_rays, n_segments=None, inner=inner, seen=seen):
            seen.append(cfg.group_size)
            return inner(upload, cfg, n_rays, n_segments)

        mapper._dispatch = dispatch
        zero_counts(occ_counters)
        with contextlib.ExitStack() as stack:
            for name, value in knobs.items():
                stack.enter_context(environ(name, value))
            for b in batches:
                mapper.integrate_rays(b)
        mapper.sync_voxels()
        maps.append(m)
        sizes.append(sorted(set(seen)))
    grouping = {"group_sizes": sizes[1], "default_group_sizes": sizes[0],
                "launches": read_counts(occ_counters),
                "compaction_dropped": mapper.stats["compaction_dropped"],
                "occupancy_bit_identical": occupancy_maps_identical(*maps)}
    ok = ok and grouping["group_sizes"] == [8] and grouping["default_group_sizes"] == [64] and (
        grouping["occupancy_bit_identical"]) and min(
        grouping["launches"].values()) > 0 and grouping["compaction_dropped"] == 0

    # OHM_RAYFLOW=0: the default constructor counts segments, as the
    # reference's does; the segmented wire has no candidate table for K1.
    with environ("OHM_RAYFLOW", "0"):
        seg = TorchRayMapper(OccupancyMap(resolution=RESOLUTION, flags=MapFlag.NONE), CAPACITY)
    zero_counts(occ_counters)
    seg.integrate_rays(batches[0])
    torch.cuda.synchronize()
    segmented = {"rayflow": seg.rayflow, "rays": seg.stats["rays"],
                 "segments": seg.stats["segments"], "launches": read_counts(occ_counters)}
    ok = ok and not seg.rayflow and segmented["segments"] > segmented["rays"] and segmented[
        "launches"]["expand_keys"] == 0 and segmented["launches"]["deposit_and_sweep"] > 0

    # The per-batch TSDF route's scatter_cap window, card against CPU.
    tsdf_batches = [box_scene_rays(API_TSDF_RAYS, rng) for _ in range(API_BATCHES)]
    window_counters = {"expand_keys": expand_cuda.expand_keys,
                       "tsdf_visits": tsdf_cuda.tsdf_visits}
    zero_counts(window_counters)
    card_layers, card_stats, card_cap = api_tsdf_window("cuda", tsdf_batches)
    window_launches = read_counts(window_counters)
    cpu_layers, cpu_stats, cpu_cap = api_tsdf_window("cpu", tsdf_batches)
    same_bits = card_layers.keys() == cpu_layers.keys() and len(card_layers) > 0 and all(
        np.array_equal(a.view(np.uint32), b.view(np.uint32))
        for k in card_layers for a, b in zip(card_layers[k], cpu_layers[k]))
    window = {"scatter_cap": card_cap, "rays_per_batch": API_TSDF_RAYS,
              "dropped_updates": card_stats["dropped_updates"],
              "cpu_dropped_updates": cpu_stats["dropped_updates"], "bit_identical": same_bits,
              "launches": window_launches}
    ok = ok and card_cap == cpu_cap == API_TSDF_CAP and window["dropped_updates"] > 0 and (
        window["dropped_updates"] == window["cpu_dropped_updates"]) and same_bits and (
        window_launches["expand_keys"] > 0 and window_launches["tsdf_visits"] == 0)

    row = emit({"phase": "api", "reference_forms": runs, "grouping_g8_no_snake": grouping,
                "rayflow_0": segmented, "tsdf_window": window, "ok": bool(ok)})
    if not ok:
        raise AssertionError(f"api phase failed: {row}")
    return row


def phase_port_bench() -> dict:
    """The two commands a benchmark's cells run, each in its own process on
    the card: python -m ohm_tpu_torch.bench, and
    python -m ohm_tpu_torch.scripts.bench_modes --quick (its rows to a
    temporary --out).  Each must exit 0 and print its lines, each line on
    this card (backend cuda, the card's name), the differential ok, and
    bench_modes' file must hold the rows it printed, each with its SHA."""
    name = torch.cuda.get_device_name(0)
    torch.cuda.empty_cache()  # this process's cached blocks, for the child's arenas
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "BENCH_extra.json")
        runs = {"bench": run_port_bench("ohm_tpu_torch.bench"),
                "bench_modes": run_port_bench("ohm_tpu_torch.scripts.bench_modes", "--quick",
                                              "--out", out)}
        written = []
        if os.path.exists(out):
            with open(out) as f:
                written = json.load(f)
    ok = all(r["rc"] == 0 and sorted(r["lines"]) == sorted(PORT_BENCH_METRICS[cmd])
             and all(ln["backend"] == "cuda" and ln["device"] == name
                     for ln in r["lines"].values())
             for cmd, r in runs.items())
    ok = ok and runs["bench"]["lines"]["hardware_differential"]["ok"]
    ok = ok and runs["bench"]["lines"]["hardware_fused_differential"]["bit_identical"]
    ok = ok and [r["metric"] for r in written] == list(PORT_BENCH_METRICS["bench_modes"]) and all(
        "sha" in r for r in written)
    row = {"phase": "port_bench", **runs, "written_rows": len(written), "ok": bool(ok)}
    emit(row)
    if not ok:
        raise AssertionError("a port bench command failed or missed a line")
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--wrappers-of", metavar="DIR",
                    help="print only the wrapper_cost line of the port in the checkout at DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one NVIDIA GPU",
              file=sys.stderr)
        return 1
    info = phase_device()
    if args.wrappers_of:
        return wrappers_of(args.wrappers_of)
    seconds = {}

    def timed(name, fn, *args):
        """Run one phase; print its seconds on a line of its own."""
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        emit({"phase_seconds": name, "seconds": seconds[name]})
        return out

    timed("build", phase_build)
    # The occupancy path first: the NDT kernel checks allocate arena-sized
    # host and device buffers, and ahead of its timed run they slowed it.
    k1 = timed("k1_expand", phase_k1)
    k2 = timed("k2_deposit", phase_k2)
    timed("hardware_differential", phase_hardware_differential)
    bench = timed("occupancy_integrate_rays_per_sec", phase_bench, k1)
    k1_trav = timed("k1_trav", phase_k1_trav, k1)
    timed("layers_hardware_differential", phase_layers_hardware_differential)
    layers = timed("occupancy_layers_rays_per_sec", phase_layers_bench)
    outdoor = timed("occupancy_mean_outdoor_rays_per_sec", phase_outdoor_mean_bench)
    k1_vox = timed("k1_vox", phase_k1_vox, k1)
    k3 = timed("k3_ndt_deposit", phase_k3)
    k4 = timed("k4_gather", phase_k4)
    wrappers = timed("wrapper_cost", phase_wrapper_cost, expand_cuda, gather_cuda, deposit_cuda,
                     wrapper_inputs(), REPO, (slotgrid_cuda, probes_cuda))
    k4_flags = timed("k4_ndt_flags", phase_k4_flags)
    timed("ndt_hardware_differential", phase_ndt_hardware_differential)
    ndt = timed("ndt_om_rays_per_sec", phase_ndt_om_bench)
    tm_mapper, tm_seconds, tm_sync_seconds = timed("ndt_tm_integrate_rays_per_sec",
                                                   phase_ndt_tm_frame)
    timed("ndt_layers_hardware_differential", phase_ndt_layers_hardware_differential)
    ndt_layers = timed("ndt_layers_rays_per_sec", phase_ndt_layers_bench)
    routes = timed("apply_routes", phase_apply_routes,
                   {"box": bench["routes"], "outdoor": outdoor["routes"],
                    "side_layers": layers["routes"], "ndt_side_layers": ndt_layers["routes"]})
    queries = timed("queries", phase_queries, outdoor["mapper"], tm_mapper)
    timed("ndt_tm_pipeline_frame_sec", phase_ndt_tm_pipeline, tm_mapper, tm_seconds,
          tm_sync_seconds, queries)
    del tm_mapper
    k5 = timed("k5_gather_f32", phase_k5)
    k6 = timed("k6_tsdf_deposit", phase_k6)
    visits = timed("tsdf_visits", phase_tsdf_visits)
    timed("tsdf_hardware_differential", phase_tsdf_hardware_differential)
    tsdf = timed("tsdf_rays_per_sec", phase_tsdf_bench)
    seg_diff = timed("segmented_hardware_differential", phase_segmented_hardware_differential)
    seg = timed("segmented_rays_per_sec", phase_segmented_bench)
    clearing = timed("clearing_rays_per_sec", phase_clearing_bench, seg)
    wide = timed("wide_outdoor", phase_wide_outdoor)
    seg_nt = timed("segmented_ndt_tsdf", phase_segmented_ndt_tsdf)
    sharded = timed("sharded", phase_sharded)
    p = timed("p", phase_p)
    apps = timed("apps", phase_apps)
    timed("port_bench", phase_port_bench)
    timed("api", phase_api)
    ohmpop_launches = {mode: apps["modes"][mode]["launches"] for mode in ("ndt", "ndt-tm", "tsdf")}
    ohmpop_launches["occupancy"] = apps["ohmpop"]["launches"]
    foreign = sorted(n for n in sys.modules if n in ("jax", "ohm_tpu")
                     or n.startswith(("jax.", "ohm_tpu.")))
    if foreign:
        raise AssertionError(f"JAX or the JAX package was imported: {foreign[:5]}")

    def row(name, source, replaces, path, err, **extra):
        """One kernel's entry: launches from its main path's counted run;
        ms, plain_ms, bound and library_ms on that path's arguments; on the
        kernels of the sharded paths, their launches there (by path, and
        summed) and the largest difference on one shard's arguments."""
        lib = path.get("library_ms", {}).get(name)
        shard = {}
        if name in sharded["sharded_launches"]:
            by_path = sharded["sharded_launches"][name]
            shard = {"sharded_launches": sum(by_path.values()),
                     "sharded_launches_by_path": by_path,
                     "sharded_max_abs_err": sharded["max_abs_err"][name]}
            err = max(err, shard["sharded_max_abs_err"])
        return {"name": name, "route": "cuda", "source": f"ohm_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": path["launches"][name],
                "max_abs_err": err, "ms": path["ms"][name], "plain_ms": path["plain_ms"][name],
                **path["bound"][name], "library_ms": lib, **extra, **shard}

    # K1's main path here is the occupancy path's (keys only); it also runs
    # on the side-layer path with its traversal output, on the outdoor mean
    # path, and on the NDT-OM and TSDF paths with voxel planes.
    emit({"kernels": [
        row("expand_keys", "expand.cu", "ohm_tpu/ops/expand_pallas.py:185", bench,
            max(k1["max_abs_err"], k1_trav["max_abs_err"], k1_vox["max_abs_err"],
                routes["max_abs_err"],
                layers["max_abs_err"]["expand_keys"], outdoor["max_abs_err"]["expand_keys"],
                ndt["max_abs_err"]["expand_keys"], tsdf["max_abs_err"]["expand_keys"],
                ndt_layers["max_abs_err"]["expand_keys"]),
            layers_launches=layers["launches"]["expand_keys"],
            outdoor_mean_launches=outdoor["launches"]["expand_keys"],
            apply_routes_launches_per_batch={k: v["expand_keys"] for k, v in
                                             routes["launches_per_batch"].items()},
            ndt_om_launches=ndt["launches"]["expand_keys"],
            tsdf_launches=tsdf["launches"]["expand_keys"],
            with_trav_ms=layers["ms"], with_trav_plain_ms=layers["plain_ms"],
            with_trav_bound_ms=layers["bound"]["bound_ms"],
            with_trav_bound_by=layers["bound"]["bound_by"],
            with_trav_kernel_alone_ms=layers["alone_ms"],
            with_vox_ms=tsdf["ms"]["expand_keys"],
            with_vox_plain_ms=tsdf["plain_ms"]["expand_keys"],
            with_vox_bound_ms=tsdf["bound"]["expand_keys"]["bound_ms"],
            kernel_alone_ms=bench["alone_ms"],
            host_us_per_call=wrappers["expand_keys_keys"]["host_us_per_call"],
            wrapper_cost={k: wrappers[f"expand_keys_{k}"]
                          for k in ("keys", "traversal", "voxel_planes")},
            with_vox_kernel_alone_ms=tsdf["k1_alone_ms"],
            ndt_om_with_vox_kernel_alone_ms=ndt["alone_ms"]["expand_keys"],
            # Voxel planes and traversal in one call: the NDT side-layer path.
            ndt_layers_launches=ndt_layers["launches"]["expand_keys"],
            with_vox_trav_ms=ndt_layers["ms"]["expand_keys"],
            with_vox_trav_plain_ms=ndt_layers["plain_ms"]["expand_keys"],
            with_vox_trav_bound_ms=ndt_layers["bound"]["expand_keys"]["bound_ms"],
            with_vox_trav_bound_by=ndt_layers["bound"]["expand_keys"]["bound_by"],
            with_vox_trav_kernel_alone_ms=ndt_layers["alone_ms"]["expand_keys"],
            # The segmented wire carries no candidate table: K1 never runs there.
            segmented_launches=seg["launches"]["expand_keys"],
            clearing_launches=clearing["launches"]["expand_keys"],
            wide_outdoor_launches=wide["launches"]["expand_keys"],
            segmented_ndt_om_launches=seg_nt["launches"]["ndt_om"]["expand_keys"],
            segmented_tsdf_launches=seg_nt["launches"]["tsdf"]["expand_keys"],
            segmented_differential_launches=seg_diff["occupancy"]["launches"]["expand_keys"],
            ohmpop_launches={mode: n["expand_keys"] for mode, n in ohmpop_launches.items()}),
        row("deposit_and_sweep", "deposit.cu", "ohm_tpu/ops/deposit_pallas.py:439", bench,
            max(k2["max_abs_err"], layers["max_abs_err"]["deposit_and_sweep"],
                outdoor["max_abs_err"]["deposit_and_sweep"], seg["max_abs_err"],
                clearing["max_abs_err"]),
            layers_launches=layers["launches"]["deposit_and_sweep"],
            outdoor_mean_launches=outdoor["launches"]["deposit_and_sweep"],
            apply_routes_launches_per_batch={k: v["deposit_and_sweep"] for k, v in
                                             routes["launches_per_batch"].items()},
            segmented_launches=seg["launches"]["deposit_and_sweep"],
            segmented_ms=seg["ms"], segmented_plain_ms=seg["plain_ms"],
            segmented_bound_ms=seg["bound"]["bound_ms"],
            segmented_kernel_alone_ms=seg["kernel_alone_ms"],
            clearing_launches=clearing["launches"]["deposit_and_sweep"],
            clearing_ms=clearing["ms"], clearing_plain_ms=clearing["plain_ms"],
            clearing_bound_ms=clearing["bound"]["bound_ms"],
            clearing_kernel_alone_ms=clearing["kernel_alone_ms"],
            wide_outdoor_launches=wide["launches"]["deposit_and_sweep"],
            kernel_alone_ms=bench["k2_device"]["kernel_ms"],
            device_ops_per_call=bench["k2_device"]["device_ops"],
            wrapper_cost=wrappers["deposit_and_sweep"],
            ohmpop_launches=ohmpop_launches["occupancy"]["deposit_and_sweep"]),
        row("deposit_and_sweep_ndt", "deposit.cu", "ohm_tpu/ops/deposit_pallas.py:449", ndt,
            max(k3["max_abs_err"], ndt["max_abs_err"]["deposit_and_sweep_ndt"],
                seg_nt["max_abs_err"]["deposit_and_sweep_ndt"],
                ndt_layers["max_abs_err"]["deposit_and_sweep_ndt"]),
            ndt_layers_launches=ndt_layers["launches"]["deposit_and_sweep_ndt"],
            ohmpop_launches={mode: ohmpop_launches[mode]["deposit_and_sweep_ndt"]
                             for mode in ("ndt", "ndt-tm")},
            ndt_layers_ms=ndt_layers["ms"]["deposit_and_sweep_ndt"],
            ndt_layers_plain_ms=ndt_layers["plain_ms"]["deposit_and_sweep_ndt"],
            ndt_layers_kernel_alone_ms=ndt_layers["alone_ms"]["deposit_and_sweep_ndt"],
            ndt_layers_bound_ms=ndt_layers["bound"]["deposit_and_sweep_ndt"]["bound_ms"],
            segmented_ndt_om_launches=seg_nt["launches"]["ndt_om"]["deposit_and_sweep_ndt"],
            segmented_ndt_om_ms=seg_nt["ms"]["deposit_and_sweep_ndt"],
            segmented_ndt_om_plain_ms=seg_nt["plain_ms"]["deposit_and_sweep_ndt"],
            kernel_alone_ms=ndt["k3_device"]["kernel_ms"],
            device_ms_per_call=ndt["k3_device"]["device_ms"],
            device_ops_per_call=ndt["k3_device"]["device_ops"],
            design_bound_ms=ndt["k3_design_bound"]["bound_ms"],
            design_bound_bytes=ndt["k3_design_bound"]["bound_bytes"],
            wrapper_cost=wrappers["deposit_and_sweep_ndt"]),
        # K4 on the NDT-OM path's arguments (the flag plane built from the
        # arena it captured); no mapper path launches it since the fused
        # flag gather below took its place.
        row("gather_plane", "gather.cu", "ohm_tpu/ops/deposit_pallas.py:479", ndt,
            max(k4["max_abs_err"], ndt["max_abs_err"]["gather_plane"]),
            on_path="none: the NDT-OM path runs gather_ndt_flags",
            kernel_alone_ms=ndt["alone_ms"]["gather_plane"],
            host_us_per_call=wrappers["gather_plane"]["host_us_per_call"],
            index_select_host_us_per_call=wrappers["index_select"]["host_us_per_call"],
            index_select_alone_ms=ndt["alone_ms"]["index_select"],
            k4_vs_index_select=ndt["flag_gather"]["k4_vs_index_select"],
            synthetic_kernel_alone_ms=k4["alone_ms"]),
        row("gather_ndt_flags", "gather.cu",
            "ohm_tpu/ops/integrate_ndt.py:195 + ohm_tpu/ops/deposit_pallas.py:479", ndt,
            max(k4_flags["max_abs_err"], ndt["max_abs_err"]["gather_ndt_flags"],
                seg_nt["max_abs_err"]["gather_ndt_flags"],
                ndt_layers["max_abs_err"]["gather_ndt_flags"]),
            ndt_layers_launches=ndt_layers["launches"]["gather_ndt_flags"],
            ohmpop_launches={mode: ohmpop_launches[mode]["gather_ndt_flags"]
                             for mode in ("ndt", "ndt-tm")},
            ndt_layers_ms=ndt_layers["ms"]["gather_ndt_flags"],
            ndt_layers_plain_ms=ndt_layers["plain_ms"]["gather_ndt_flags"],
            ndt_layers_kernel_alone_ms=ndt_layers["alone_ms"]["gather_ndt_flags"],
            ndt_layers_bound_ms=ndt_layers["bound"]["gather_ndt_flags"]["bound_ms"],
            segmented_ndt_om_launches=seg_nt["launches"]["ndt_om"]["gather_ndt_flags"],
            segmented_ndt_om_ms=seg_nt["ms"]["gather_ndt_flags"],
            segmented_ndt_om_plain_ms=seg_nt["plain_ms"]["gather_ndt_flags"],
            kernel_alone_ms=ndt["alone_ms"]["gather_ndt_flags"],
            host_us_per_call=wrappers["gather_ndt_flags"]["host_us_per_call"],
            plane_build_k4_host_us_per_call=wrappers["plane_build_k4"]["host_us_per_call"],
            flag_gathers_ms=ndt["flag_gather"]["wrapper_ms"],
            flag_gathers_device_ms_alone=ndt["flag_gather"]["device_ms_alone"]),
        # K5 and K6 on arguments derived from the fused call's; no mapper
        # path launches them since the fused kernel below took their place.
        row("gather_planes_f32", "gather.cu", "ohm_tpu/ops/deposit_pallas.py:598", tsdf,
            max(k5["max_abs_err"], tsdf["max_abs_err"]["gather_planes_f32"]),
            on_path="none: the TSDF path runs tsdf_visits",
            versus_library=tsdf["versus_library"]["gather_planes_f32"]),
        row("tsdf_set_deposit", "deposit.cu", "ohm_tpu/ops/deposit_pallas.py:726", tsdf,
            max(k6["max_abs_err"], tsdf["max_abs_err"]["tsdf_set_deposit"]),
            on_path="none: the TSDF path runs tsdf_visits",
            versus_library=tsdf["versus_library"]["tsdf_set_deposit"]),
        row("tsdf_visits", "tsdf.cu",
            "ohm_tpu/ops/deposit_pallas.py:598 + ohm_tpu/ops/blocked.py:77,218 + "
            "ohm_tpu/ops/deposit_pallas.py:726", tsdf,
            max(visits["max_abs_err"], tsdf["max_abs_err"]["tsdf_visits"],
                seg_nt["max_abs_err"]["tsdf_visits"]),
            segmented_tsdf_launches=seg_nt["launches"]["tsdf"]["tsdf_visits"],
            ohmpop_launches=ohmpop_launches["tsdf"]["tsdf_visits"],
            segmented_tsdf_ms=seg_nt["ms"]["tsdf_visits"],
            segmented_tsdf_plain_ms=seg_nt["plain_ms"]["tsdf_visits"],
            **tsdf["fused"]),
        # P's path is the deposit probe's own entry point.
        row("deposit_probes", "probes.cu", "scripts/probe_deposit.py:114", p,
            p["max_abs_err"]["deposit_probes"], probe_launches=p["probe_launches"],
            probe_ms=p["times"]["probe_ms"], probe_plain_ms=p["times"]["probe_plain_ms"],
            probe_alone_ms={k: v["alone_ms"] for k, v in p["probes"].items()},
            launch_floor_alone_ms={k: v["launch_floor_alone_ms"]
                                   for k, v in p["probes"].items()},
            probe_library_ms={k: v["library_ms"] for k, v in p["probes"].items()},
            probe_library_device_ms={k: v["library_device_ms"]
                                     for k, v in p["probes"].items()},
            probe_library={k: v["library"] for k, v in p["probes"].items() if v["library"]},
            probe_bound_ms={k: v["bound_ms"] for k, v in p["probe_bounds"].items()},
            library="per probe: bincount (scatter-add, one-hot), gather (take-along)"),
        row("slotgrid_deposit", "slotgrid.cu", "scripts/probe_deposit.py:218", p,
            p["max_abs_err"]["slotgrid_deposit"],
            kernel_alone_ms=p["times"]["slotgrid_kernel_alone_ms"],
            device_ops_per_call=p["times"]["slotgrid_device_ops_per_call"],
            counts_device_ops_per_call=p["times"]["slotgrid_counts_device_ops_per_call"],
            counts_kernel_alone_ms=p["times"]["slotgrid_counts_kernel_alone_ms"],
            design_bound_ms=p["design"]["bound_ms"],
            design_bound_bytes=p["design"]["bound_bytes"],
            largest_run_records=p["largest_run_records"],
            library="none: no one PyTorch call computes the deposit and its sweep",
            **{k: p["times"][k] for k in ("slotgrid_counts_ms", "k3_ms", "scatter_deposit_ms",
                                          "onehot_deposit_ms")}),
    ]})
    emit({"phase_seconds": "total", "seconds": sum(seconds.values())})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
