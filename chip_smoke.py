#!/usr/bin/env python3
"""Chip smoke test of ``la3dm_tpu_torch`` on one CUDA GPU (built for H100).

Run from the repository root on a machine with one card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``la3dm_tpu_torch/csrc`` (and the host
library from ``native/host_preprocess.cpp``) on first use, then:

1. prints the card's name and power limit and the build times;
2. makes seeded synthetic range scans at the demo scale (3500 beams per
   scan, max_range 8 m, a moving sensor in a 12 × 12 × 4.3 m box room with
   box obstacles) and writes them as PCDs to a temporary directory.

BGK (``bgkoctomap.yaml``), first on the host-ingest path (``device_ingest:
off``):

3. holds K1 (heavy pass, points) against its plain PyTorch version on the
   argument tuple of a real 16-scan dispatch: bit for bit (and so within
   |Δ| ≤ 1e-5 + 1e-5·|plain|); T, R, the warp work units and the culled
   (warp, entry) pairs printed, the kernel's own cull count equal to that
   of the plain predicate ``bgk_heavy_cull``, a second launch bit-equal;
   its bound counts the work left after the culling, the bound on every
   evaluation beside it;
4. holds K2 (light pass + prune) against its plain version on the same
   accumulator and pool state: A, B, touched and eff bit for bit, timed
   with and without the prune, its bound on the distinct accumulator rows
   the voxels' eff levels need (every voxel's own row beside it); then
   from the same blocks made collapsible and near-collapsible (every level
   reached, bit for bit); the same with ``predict`` (G = 27);
5. runs the main path — ``pipeline.run_static`` on 12 and on 60 scans and
   ``OnlineIntegrator`` on 12 scans one by one — with ``BGKOctoMap(cfg)``
   on the card, asserting each kernel's launch count, and counts the host
   syncs of one 16-scan dispatch (PyTorch's sync debug mode);
6. profiles the 60-scan run once more (torch.profiler): device time by
   kernel, device busy share and host time;
7. runs the first scan on the card and on the CPU and compares the maps
   voxel by voxel (A/B within 5e-3; eff and touched equal except where the
   voxel's added mass is ≤ 1e-5, the k̄ > 0 gate's clamp boundary);

then on the device-ingest path, the default of a CUDA map:

8. records the device-ingest kernels' calls of a real 16-scan dispatch and
   holds each against its plain version: K7a (outlier mask and voxel keys
   of the raw points; range filter and the beam samples that exist, with
   their count on the card) — keys, count and in-range flags equal, the
   samples the dense layout's kept rows in order (the control, the samples
   in f64, must differ), each launch timed alone, its bound on the samples
   kept and the dense layout's beside it; K7b (compensated centroids, hits and frees) —
   bit for bit, and so within 2^-23·(|plain| + leaf) (the control, the
   uncompensated mean, must fail it); K7c (closed-box memberships, the
   compact layout) — keys, entry rows and count equal, the keys the dense
   layout's valid ones, its bound on the bytes the data needs and the dense
   layout's beside it, and its time with the membership sort's; K7s (the stable sort and run cut on compact codes) on each of the
   dispatch's four sorts — sort index, runs and each row's run bit for bit
   (the control, a tie swapped in the sort index, must fail), timed beside
   torch.sort(stable=True) + unique_consecutive on the same keys, and its
   fixed cost a sort on 64 keys through each of its paths (one CTA, and
   multi-CTA) beside the library's; K7t (the
   bucket tail: rows in block order, nb_row, tb_u read off the candidate
   sort's runs) — bit for bit against both plain versions (read off the
   runs, and by torch.searchsorted), timed with the candidate sort beside
   torch.unique + searchsorted + the gathers, its bound and the
   search-based one beside it; K7w (the test blocks' world keys and
   per-scan counts, the world-key sort, the slot gather) — bit for bit
   against the plain versions, and the resolution the host's (np.unique's
   distinct blocks in its order, slots, counts; the control, two slots
   swapped, must fail), timed with the sort beside torch.unique + the
   slots' index; K1′ (the aligned
   heavy pass) — bit for bit, and so within |Δ| ≤ 1e-5 + 1e-5·|plain| (the
   control, the plain version on TF32-rounded coordinates, must fail it);
   its warp work units and culled (warp, entry) pairs printed, its own cull
   count equal to that of the plain predicate ``bgk_aligned_heavy_cull``, a
   repeat launch bit-equal; its bound on the work the culling leaves, the
   bound on every evaluation beside it;
9. runs the main path as in 5 with ``BGKOctoMap(cfg)`` on its default,
   asserting per dispatch two K7a, two K7b, one K7c, five K7s (the fifth
   of the world keys), one K7t, two K7w and one K1′ launches, one K2 per scan, no K1 and no chunk on the host path;
   counts the host syncs as in 5 (at most 5 a dispatch required); profiles
   the 60-scan run as in 6, the device time outside the named kernels
   ("other") broken down by op; compares card and CPU
   (both ``device_ingest: on``) on 3 scans within 1e-5 + 1e-5·|CPU|, eff and
   touched as in 7.

BGKLV (``bgklvoctomap.yaml``, the demo, and ``bgklvoctomap_large_map.yaml``
with ``original_size``; LV reads no ``device_ingest`` flag):

10. holds K3 (tile row engine) against its plain version on the argument
    tuple of a real 12-scan dispatch and of one large-map scan's dispatch
    (block_depth 6, ℓ 0.6): A/B within 1e-5 + 1e-5·|plain| and touched
    equal, except at voxels whose plain k̄ lies within 1e-5 of the 0.001
    gate (counted and printed); a second launch bit-equal to the first;
    T, R, the warp work units, the member pairs, the culled (warp, entry)
    pairs and the row-sum scratch printed, the kernel's own cull count equal
    to that of the plain predicate ``lv_rows_cull``; its bound counts the
    work left after the culling, the bound on every evaluation beside it;
11. holds K8 (tile-major prune) against its plain version on the pool state
    of a real large-map prune, on the same blocks made collapsible at
    every level (16³ and 32³ groups included, which the real scene does not
    collapse) and on them made near-collapsible (each group one change
    away from collapsing, ``kernels/group_prune.py::near_collapsible_rows``):
    A, B, touched and eff equal, every level reached on the last two;
12. runs the main path — ``run_static`` on 12 and 60 demo scans,
    ``OnlineIntegrator`` on 12 scans, ``run_static`` on 12 large-map scans
    (one K3 and one K8 per scan) — asserting every launch count;
13. compares the first demo scan on the card and on the CPU, as in 7 with
    the gate at 0.001 (one scan: the CPU's LV pass takes about 10 s a scan);
14. profiles the 60-scan demo run as in 6.

GP (``gpoctomap.yaml``, the demo, and ``gpoctomap_large_map.yaml``, depth 4
with ``original_size``, ``max_range`` cut to the scene's 8 m), first on the
host-ingest path:

15. holds K4 (GP heavy pass) against its plain version (``torch.linalg``,
    i.e. cuSOLVER/cuBLAS, on the JAX step's batch padded to the tier's
    largest count) on every size tier of a real 16-scan demo dispatch (base
    tier), of a 12-scan large-map dispatch (base tier at 4095 queries a
    model, overflow tier) and of a forced 300-point block
    (``insert_training_data``): |Δ|/(1+|plain|) within 1e-3 (base) or 4e-3
    (overflow) on means and 1e-5 on variances, ``present`` equal, no failed
    factorisation; each limit must fail the control, the plain version on
    TF32-rounded coordinates; each tier timed (``launch_ms``) beside its
    plain version and its bound (operations of the served (block, slot)
    rows), the tables after those launches bit-equal to the first's;
16. holds K5 (BCM light pass + prune) against its plain version on the
    demo dispatch's tables and pool (V 64, 2 prune levels) and on the
    large-map dispatch's (V 512, 3 levels), scan by scan from the plain
    pool: m_ivar/ivar, eff and touched bit for bit, except in blocks holding a
    voxel whose plain pre-prune p lies within 1e-5 of a threshold or whose
    ivar lies within 1e-5·min_known_ivar of the chop (counted and printed);
    then on both dispatches' blocks made collapsible and near-collapsible,
    over the scans in order: bit for bit, every level reached; both
    dispatches timed;
17. runs the main path — ``run_static`` on 12 and 60 demo scans,
    ``OnlineIntegrator`` on 12 scans, ``run_static`` on 12 large-map scans —
    asserting K4 = the (dispatch, size tier) pairs the map built (an
    overflow tier on the large map), K5 = the scans, no failed
    factorisation, finite leaves, occupied and free leaves; counts the host
    syncs of a 16-scan dispatch as in 5; profiles the 60-scan demo run as
    in 6;
18. compares 3 demo scans on the card and on the CPU: m_ivar/ivar within
    5e-2 + 5e-3·|CPU| (f32 factors in another rounding order, amplified by
    the BCM weights 1/σ²; the control, the card's map with the heavy pass on
    TF32-rounded coordinates, must fail it), touched equal, state equal
    except within 1e-3 of a threshold or the chop, eff equal in blocks
    without such a voxel;

then on the device-ingest path:

19. holds K7a, K7b, K7c, K7s, K7t and K7w (with the centres) against their
    plain versions on a real 16-scan GP dispatch (81 free samples a beam),
    as in 8;
20. runs the main path as in 9 (K4 = the map's size tiers, K5 per scan, no
    failed factorisation), counts the host syncs, profiles, and compares
    card and CPU (both on) as in 18.

BGKL (``bgkloctomap.yaml``: gate 0.001, free_resolution 0.3, 27 backward
samples a beam), first on the host-ingest path, after the BGK phases:

21. holds K1's segment branch against its plain version on the argument
    tuple of a real 16-scan dispatch: |Δ| ≤ 1e-5 + 1e-5·|plain| (the
    control, the plain version on TF32-rounded coordinates, must fail it),
    the (block, node, slot) k̄ within 1e-5 of the 0.001 gate counted and
    none decided apart; T, R, the warp work units and the culled (warp,
    entry) pairs printed, the kernel's own cull count equal to that of the
    plain predicate ``bgk_heavy_cull``, a second launch bit-equal; its bound
    counts the work left after the culling, the bound on every evaluation
    beside it;
22. runs the main path as in 5 (``BGKLOctoMap(cfg)``), counts the host
    syncs, profiles the 60-scan run and compares card and CPU on 1 scan as
    in 7, A/B within 1e-5 + 1e-5·|CPU| (the control, the card's map with K1
    on TF32-rounded coordinates, must fail it);

then on device ingest, its default on the card:

23. holds K7d (the ray pass: occ, ray segments, proxy samples, their block
    keys, the per-ray dedup by contiguity along the ray) against its plain
    version on a real 16-scan dispatch — every output equal and the (ray,
    block) pair list identical (the control, the samples in f64, must move
    a membership; without the dedup the list must be longer), timed by
    torch.profiler and with its wait —, K7b (the
    hits), K7c (the hits' dense layout, 8 slots a hit, and their rows),
    K7s (three sorts), K7t and K7w as in 8, and K1′'s segment branch as in 8,
    with the gate count of 21;
24. runs the main path as in 9 (per dispatch one K7a, one K7b, the two
    launches of K7d, one K7c, four K7s, one K7t, two K7w, one K1′; K2 per
    scan),
    counts the host syncs,
    profiles, and compares card and CPU (both on) on 2 scans within
    1e-5 + 1e-5·|CPU| (the control, with K1′ on TF32-rounded coordinates,
    must fail it).

Raycast, last:

25. ``raycast_snapshot`` and ``raycast_device`` over 1,000,000 rays cast from
    the 60 scan origins into the 60-scan BGK demo map (device ingest) at
    max_range 8 m, and over 100,000 rays into the 60-scan BGKL and BGKLV
    maps: snapshot and ray times apart, one K6 launch a call; K6 against its
    plain version on the same call (hit and steps equal, dist bit-equal, a
    repeat launch too; the control, the plain version in f64, must differ
    on a ray) and, on the first rays, against its plain version on the CPU
    (bit-equal); K6's own count of the lookups that probe under its block
    cache and of their probes equal to the plain version's block mode,
    printed beside the probes of every lookup; its bound on the lookups
    and probes the cache leaves, the bound with every lookup probing
    beside it; the host stepper ``raycast`` replays those rays, and each
    ray where it parts from K6 must show a tie (its first voxel, an axis
    choice, a voxel read at a face, or the range limit, within f32
    rounding).

The large maps, after raycast (the BGK-family ones at their YAML's own
``max_range`` of 30 m; every hit of the room lies within about 17.5 m):

26. BGKL large map (``bgkloctomap_large_map.yaml``, block_depth 5: 16³ =
    4096 voxels and 4681 nodes a block): K1's segment branch on a captured
    12-scan host-ingest dispatch as in 21 (the accumulator's bytes printed,
    and what a 16-scan dispatch would hold); K2 against its plain version
    over the dispatch's scans in order, bit for bit (one CTA per 8³ tile,
    the 16³ level in each block's last CTA), then twice more from the same
    pool with its blocks made collapsible at every level (raster, Beta
    templates) and near-collapsible, bit for bit each time, every level
    reached, the 16³ groups collapsed counted and required; K1′'s segment branch on a captured 12-scan device-ingest
    dispatch as in 23 (bit for bit, its cull count, both bounds) and K7d,
    K7b, K7c, K7s and K7t on that dispatch as in 23 (K7d's f64 and index-order
    controls printed only: at 3.2 m blocks they move no pair; the list
    without the dedup must still be longer); run_static
    on 12 scans and
    OnlineIntegrator on 12 on both
    ingest paths with their launch counts; card vs CPU within 1e-5 +
    1e-5·|CPU| on the host path (1 scan) and device ingest (2 scans), each
    failing its TF32 control;
27. BGK large map (``bgkoctomap_large_map.yaml``, block_depth 3): K7a, K7b,
    K7c, K7s and K7t on a 12-scan device-ingest dispatch as in 8; the same
    main paths, card vs CPU within 5e-3 (host, 1 scan) and 1e-5 +
    1e-5·|CPU| (device ingest, 2 scans); every OnlineIntegrator on device
    ingest takes the server's pre-downsample on the card (K7v: two launches
    and one K7s sort a scan, counted);
27b. K7v (:func:`check_k7v`) on 24 raw clouds of the benchmark's city
    block at the 0.5 m leaf: bit-equal (uint32) to ``voxel_downsample`` and
    to its plain version, and on cells of 1 to 4,096 points whose bits show
    numpy's sum order (a running sum must fail them); its launches, the
    call with the upload and the wait, the plain version, numpy's and the
    host library's voxel grids timed, its bound 12 bytes a point in and a
    centroid out;
28. GP at block_depth 5 (``gpoctomap_large_map`` with ``block_depth=5``,
    8 m, host ingest): K4 on every size tier of a 12-scan dispatch at 4681
    nodes a block as in 15 — its overflow tier holds models of about 2,100
    points, four times the largest that 15's limits were measured on, so
    that tier is held to the plain version in f64: the kernel's largest
    |Δ|/(1+|f64|) at most twice the f32 plain version's, the control's
    above that; K5 scan by scan as in 16 (bit for
    bit away from the thresholds) and on collapsible and near-collapsible
    blocks as in 16 (groups collapsed across tiles required);
    run_static on 12 scans; card vs CPU on 1 scan as in 18,
    the m_ivar/ivar limit held against the map with f64 factors (the CPU's
    f32 factors part from it by more than the limit at these models; its
    deviation and the card-vs-CPU ratio are printed).

The command line, last (``la3dm_tpu_torch.cli.main`` in process, on the 60
scans, :func:`cli_phase`):

29. ``static`` for each family, BGK and BGKL on both ingest paths, every
    export written (PLY, CSV, NPZ, ``.bt``, HTML), the family's kernels
    launched once a scan on the card and its checkpoint bit-equal to an
    in-process ``run_static(..., progress=...)``; ``static --profile-dir``
    (BGK, 12 scans), its trace holding 12 K1′ and 12 K2 launches;
    ``query``, ``raycast`` (one K6 launch) and ``frontier`` on the BGK
    checkpoint, equal to ``search``, ``raycast_device`` and
    ``frontier_leaves``; ``server --once`` and ``bag`` on 12 scans with a
    repeated pose (the bag from :func:`write_bag`), each bit-equal to an
    in-process ``OnlineIntegrator`` with the same gated count; ``eval``
    against the scene's geometry as a ``.bt`` (:func:`scene_truth`) on 60
    scans, and on 3 on the card and on the CPU; ``python -m
    la3dm_tpu_torch.cli static --method bgklv`` in a subprocess;
    ``entry()``'s step.  A ``{"cli": ...}`` JSON line gives each command's
    seconds and the scans/s that ``static`` printed.

Sharding (``la3dm_tpu_torch/parallel/``, :func:`sharded_phase`), after the
command line:

30. (a) each family's YAML on ``block_mesh(4)`` on cuda:0, on each ingest
    path it has (BGK 60 scans, the others 12), and BGKLV's large-map YAML
    (``original_size``, 12 scans), through ``run_static``: the map
    bit-equal, keyed by block coordinates, to the unsharded map's (every
    field, ``touched``, ``eff_level``); the heavy kernel (K1, K1 seg, K1′,
    K3) and K8 launched once per (dispatch, shard with a block), K2 or K5
    once per (scan, shard with a block), and K4 once per (dispatch, shard
    with a block, size tier, models counted there or on a lower shard)
    holding a model that serves the shard, counted from the unsharded map's
    own dispatches, by the wrappers' counters and (but K4) again by
    torch.profiler; timed unsharded, sharded, sharded, unsharded; (b) BGK
    and GP on the host path from ``capacity=16`` in one batched insert (the
    pool grows inside it), then ``rebalance()`` before each of 4 more scans:
    bit-equal, the generation moved, the shards' touched voxels within the
    LPT bound; (c) a one-rank NCCL group (a file store) over 4 shards, BGK
    as (b) on device ingest, so that the relayouts, the load gathers and the
    checkpoint's reads run on NCCL: bit-equal; (d) two ``gloo`` ranks of 2
    shards on cuda:0 in subprocesses (``chip_smoke.py --sharded-worker``),
    BGK and GP as (c): rank 0's checkpoints bit-equal to the unsharded
    maps'; (e) the same on NCCL, one card a rank, where the machine has two
    cards (else printed as not run); (f) ``entry.dryrun_multichip(4)`` with
    its skew lines.  A ``{"sharded": ...}`` JSON line, before the
    ``kernels`` line, gives each case's seconds, scans/s beside the
    unsharded map's and launch counts, with the card's name and power limit.

Last, a ``kernels`` JSON line (K2's and K5's entries carry a ``large_block``
record for 16³-voxel blocks beside their 4³ figures) and the device JSON
line.  Every kernel time
(``ms``) is the device time of the work named in its ``work`` key, by a pair
of CUDA events around its launches queued back to back behind a spin of the
stream (:func:`launch_ms`); the same window without the spin (``event_ms``)
also holds the host's launch gaps.  Any
failure exits non-zero.  Without a CUDA card it exits 2 at once.
"""

from __future__ import annotations

import bz2
import contextlib
import dataclasses
import io
import json
import math
import os
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from la3dm_tpu_torch import cli, pipeline  # noqa: E402
from la3dm_tpu_torch.geometry import blocks as geo, native  # noqa: E402
from la3dm_tpu_torch.entry import entry, tiny_scan  # noqa: E402
from la3dm_tpu_torch.io import octomap_bt, rosbag  # noqa: E402
from la3dm_tpu_torch.io.pcd import load_pcd, load_pcd_full, save_pcd  # noqa: E402
from la3dm_tpu_torch.kernels import (_build, bgk_aligned_heavy, bgk_heavy,  # noqa: E402
                                     bgk_light, gp_heavy, gp_light, group_prune, ingest_beams,
                                     ingest_bucket, ingest_downsample, ingest_keys,
                                     ingest_members, ingest_rays, ingest_slots, ingest_sort,
                                     ingest_voxel_grid, lv_prune, lv_rows, math as km,
                                     raycast as k6)
from la3dm_tpu_torch.models import gp as gp_model, posterior, raycast as rc  # noqa: E402
from la3dm_tpu_torch.models.bgklv import BGKLVOctoMap  # noqa: E402
from la3dm_tpu_torch.models.gp import GPOctoMap  # noqa: E402
from la3dm_tpu_torch.utils.config import (DatasetConfig, load_dataset_config,  # noqa: E402
                                          load_method_config)
from la3dm_tpu_torch.viz import markers  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): FP32 on the CUDA cores, HBM3 rate
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

BEAMS_AZ, BEAMS_EL = 175, 20            # 3500 beams per scan
ELEVATION = np.deg2rad(15.0)            # ±15°
MAX_RANGE = 8.0
ROOM = (np.array([-6.0, -6.0, 0.0]), np.array([6.0, 6.0, 4.3]))
OBSTACLES = [                           # (lo, hi) boxes off the sensor's path
    (np.array([-0.5, -0.5, 0.0]), np.array([0.5, 0.5, 4.3])),    # pillar
    (np.array([3.5, -1.0, 0.0]), np.array([5.0, 1.0, 0.8])),     # table
    (np.array([-5.5, -3.0, 0.0]), np.array([-4.5, 3.0, 2.0])),   # shelf
    (np.array([-1.0, 4.0, 0.0]), np.array([1.0, 5.0, 1.2])),     # crate
]


# ----------------------------------------------------------------- scenes

def _ray_box_exit(o, d, lo, hi):
    """Distance along unit rays d [N,3] from o (inside the box) to its wall."""
    with np.errstate(divide="ignore"):
        t = np.where(d > 0, (hi - o) / d, np.where(d < 0, (lo - o) / d, np.inf))
    return t.min(axis=1)


def _ray_box_entry(o, d, lo, hi):
    """Entry distance of rays into a box outside them (inf where missed)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (lo - o) / d
        t2 = (hi - o) / d
    tmin = np.nanmax(np.minimum(t1, t2), axis=1)
    tmax = np.nanmin(np.maximum(t1, t2), axis=1)
    hit = (tmax >= tmin) & (tmin > 0)
    return np.where(hit, tmin, np.inf)


def synthetic_scans(n_scans: int, seed: int = 0):
    """Seeded range scans: ``n_scans`` (cloud [3500,3] f32, origin [3] f32)
    from a sensor circling the room at 1 m height (≈ 0.26 m per scan)."""
    rng = np.random.default_rng(seed)
    el = np.linspace(-ELEVATION, ELEVATION, BEAMS_EL)
    scans = []
    for i in range(n_scans):
        a = 2 * np.pi * i / 60
        origin = np.array([2.5 * np.cos(a), 2.5 * np.sin(a), 1.0])
        origin = origin + rng.normal(0.0, 0.02, 3)
        az = np.linspace(0, 2 * np.pi, BEAMS_AZ, endpoint=False) + rng.uniform(0, 0.03)
        azg, elg = np.meshgrid(az, el, indexing="ij")
        d = np.stack([np.cos(elg) * np.cos(azg), np.cos(elg) * np.sin(azg),
                      np.sin(elg)], -1).reshape(-1, 3)
        t = _ray_box_exit(origin, d, *ROOM)
        for lo, hi in OBSTACLES:
            t = np.minimum(t, _ray_box_entry(origin, d, lo, hi))
        t = t + rng.normal(0.0, 0.01, t.shape)
        cloud = origin + d * t[:, None]
        scans.append((cloud.astype(np.float32), origin.astype(np.float32)))
    return scans


def write_pcds(scans, directory: str, prefix: str = "synth") -> None:
    for i, (cloud, origin) in enumerate(scans, start=1):
        save_pcd(os.path.join(directory, f"{prefix}_{i}.pcd"), cloud, origin)


def _bag_record(fields: dict, data: bytes) -> bytes:
    """One ROS bag v2.0 record: header fields (name=value), then data."""
    head = b"".join(struct.pack("<I", len(k) + 1 + len(v)) + k.encode() + b"=" + v
                    for k, v in fields.items())
    return struct.pack("<I", len(head)) + head + struct.pack("<I", len(data)) + data


def _ros_string(s: str) -> bytes:
    return struct.pack("<I", len(s)) + s.encode()


def _ros_header(seq: int, stamp_ns: int, frame: str) -> bytes:
    return struct.pack("<III", seq, stamp_ns // 10**9, stamp_ns % 10**9) + _ros_string(frame)


def _pointcloud2(cloud: np.ndarray, seq: int, stamp_ns: int) -> bytes:
    """sensor_msgs/PointCloud2 of ``cloud`` [N,3] as x, y, z float32 and an
    intensity float32 (16 bytes a point, one row)."""
    n = len(cloud)
    rec = np.zeros((n, 4), "<f4")
    rec[:, :3] = cloud
    rec[:, 3] = np.arange(n, dtype=np.float32)
    fields = b"".join(_ros_string(name) + struct.pack("<IBI", 4 * k, 7, 1)
                      for k, name in enumerate(("x", "y", "z", "intensity")))
    body = rec.tobytes()
    return (_ros_header(seq, stamp_ns, "map") + struct.pack("<II", 1, n)
            + struct.pack("<I", 4) + fields + struct.pack("<B", 0)
            + struct.pack("<II", 16, 16 * n) + struct.pack("<I", len(body)) + body
            + struct.pack("<B", 1))


def _pose_stamped(origin, quat_xyzw, seq: int, stamp_ns: int) -> bytes:
    """geometry_msgs/PoseStamped: position, then orientation (x, y, z, w)."""
    return (_ros_header(seq, stamp_ns, "map")
            + struct.pack("<3d", *(float(v) for v in origin))
            + struct.pack("<4d", *(float(v) for v in quat_xyzw)))


def write_bag(path: str, scans, cloud_topic: str = "/selected_pc2_map",
              pose_topic: str = "/robot_pose", per_chunk: int = 6) -> None:
    """A ROS bag v2.0 of ``scans`` ((cloud, origin) pairs): a PoseStamped
    (identity orientation) and a PointCloud2 each, 0.1 s apart, the pose
    first, in chunks of ``per_chunk`` scans alternately uncompressed and
    bz2, the connections written in the first chunk and again after the
    chunks, as a recorder lays them out."""
    conns = [(0, cloud_topic, "sensor_msgs/PointCloud2"),
             (1, pose_topic, "geometry_msgs/PoseStamped")]

    def conn_record(conn, topic, mtype):
        data = b"".join(struct.pack("<I", len(f)) + f for f in (
            f"topic={topic}".encode(), f"type={mtype}".encode(), b"md5sum=*"))
        return _bag_record({"op": b"\x07", "conn": struct.pack("<I", conn),
                            "topic": topic.encode()}, data)

    chunks = []
    for c0 in range(0, len(scans), per_chunk):
        body = b"".join(conn_record(*c) for c in conns) if c0 == 0 else b""
        for i in range(c0, min(c0 + per_chunk, len(scans))):
            cloud, origin = scans[i]
            t = (i + 1) * 100_000_000
            body += _bag_record({"op": b"\x02", "conn": struct.pack("<I", 1),
                                 "time": struct.pack("<Q", t)},
                                _pose_stamped(origin, (0.0, 0.0, 0.0, 1.0), i, t))
            body += _bag_record({"op": b"\x02", "conn": struct.pack("<I", 0),
                                 "time": struct.pack("<Q", t + 1000)},
                                _pointcloud2(cloud, i, t + 1000))
        comp = "bz2" if (c0 // per_chunk) % 2 else "none"
        data = bz2.compress(body) if comp == "bz2" else body
        chunks.append(_bag_record({"op": b"\x05", "compression": comp.encode(),
                                   "size": struct.pack("<I", len(body))}, data))
    header = _bag_record({"op": b"\x03", "index_pos": struct.pack("<Q", 0),
                          "conn_count": struct.pack("<I", len(conns)),
                          "chunk_count": struct.pack("<I", len(chunks))}, b" " * 4000)
    with open(path, "wb") as f:
        f.write(b"#ROSBAG V2.0\n" + header + b"".join(chunks)
                + b"".join(conn_record(*c) for c in conns))


# ----------------------------------------------------------------- timing

def cuda_ms(fn, reps: int, warmup: int = 1, setup=None) -> float:
    """Mean device time of ``fn`` (ms) over ``reps`` runs, by CUDA events.
    ``setup`` (untimed) runs before each call and its result is passed in."""
    for _ in range(warmup):
        fn(setup() if setup else None)
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        arg = setup() if setup else None
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(arg)
        e1.record()
        torch.cuda.synchronize()
        total += e0.elapsed_time(e1)
    return total / reps


#: pause at the start of a profiler session (``profile_main_path``): on an
#: H100 80GB HBM3, short sessions recorded none or only some of their
#: kernels unless they lasted a second or more; every session is checked
#: against the launches it must hold and retried with a longer pause
PROFILE_PAUSE_S = 1.0


def profiled(fn, launches: dict):
    """Run ``fn`` under torch.profiler until the session holds exactly
    ``launches`` (part of a CUDA kernel's name → launch count); returns
    (the profiler, fn's result)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(4):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAUSE_S * (1 + 2 * attempt))
            out = fn()
            torch.cuda.synchronize()
        seen = {k: 0 for k in launches}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                for k in launches:
                    if k in e.key:
                        seen[k] += e.count
        if seen == launches:
            return prof, out
        print(f"profiler session {attempt + 1} held launches {seen}, not {launches}; "
              "retried", flush=True)
    raise RuntimeError(f"the profiler did not record the launches {launches}")


def device_ms(fn, reps: int, kernel: str, per_call: int) -> float:
    """Device time (ms) of one call of ``fn``: every kernel, copy and memset
    of ``reps`` calls under torch.profiler (a session holding ``per_call``
    launches a call of kernels named ``kernel``), over ``reps``; the host's
    gaps and waits are left out."""
    from torch.autograd import DeviceType

    prof, _ = profiled(lambda: [fn() for _ in range(reps)], {kernel: per_call * reps})
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / reps


_CYCLES_PER_MS = None


def spin(ms: float) -> None:
    """Hold the current stream for about ``ms`` ms (``torch.cuda._sleep``),
    so that the work the host queues behind it runs back to back."""
    global _CYCLES_PER_MS
    if _CYCLES_PER_MS is None:
        cycles = 20_000_000
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)  # warm-up
        e0.record()
        torch.cuda._sleep(cycles)
        e1.record()
        torch.cuda.synchronize()
        _CYCLES_PER_MS = cycles / e0.elapsed_time(e1)
    torch.cuda._sleep(int(ms * _CYCLES_PER_MS))


def launch_ms(calls, reps: int = 3, setup=None) -> float:
    """Mean device time (ms) of one pass of ``calls``, each of which launches
    one kernel and gets ``setup()``'s result (made untimed before the pass).
    The pass is queued behind a spin of the stream, so its launches run back
    to back, and one pair of CUDA events brackets it: the host's gaps between
    launches are left out.  A pass whose queueing outlasted its spin runs
    again with a longer one; if that is outlasted too, a wrapper waits on the
    device (K3 sizes its grid from the data), and the passes run without a
    spin: the window then also holds that wrapper's device work before its
    launch.  The caller has run the kernels once before (build and
    first-call costs)."""
    total, spin_ms, longer = 0.0, 10.0, True
    done = 0
    while done < reps:
        arg = setup() if setup else None
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if spin_ms:
            spin(spin_ms)
        e0.record()
        for call in calls:
            call(arg)
        e1.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if spin_ms and host_ms > 0.8 * spin_ms:
            if longer:
                spin_ms, longer = min(3 * host_ms, 1000.0), False
                continue
            print("launch_ms: a wrapper waits on the device; timed without a spin",
                  flush=True)
            spin_ms = 0.0
        total += e0.elapsed_time(e1)
        done += 1
    return total / reps


_T_START = time.perf_counter()


def stamp(what: str) -> None:
    """Print the seconds since the script started, before a phase."""
    print(f"[{time.perf_counter() - _T_START:.1f} s] {what}", flush=True)


def require(ok: bool, what: str) -> None:
    """Fail the run (also under ``python -O``, which drops asserts)."""
    if not ok:
        raise RuntimeError(what)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(flops: float, nbyte: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbyte / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def warp_work(culled_per_warp: torch.Tensor, n_entries: int, n_points: int) -> tuple[int, int]:
    """(evaluations, pairs) of a warp-culling kernel on this run's data:
    warps of 32 of ``n_points`` points (the last one partly live), each
    walking ``n_entries`` entries and skipping ``culled_per_warp`` [warps]
    of them; the evaluations count the live lanes of every (warp, entry)
    pair kept, the pairs every (warp, entry) pair, each of which takes the
    cull test (``km.FLOP_CULL_TEST``, ``FLOP_CULL_TEST_POINT`` for points)."""
    w = culled_per_warp.numel()
    lanes = (n_points - 32 * torch.arange(w)).clamp(max=32)
    return int(((n_entries - culled_per_warp.cpu()) * lanes).sum()), n_entries * w


# ----------------------------------------------------------------- phases

def capture_dispatch(cfg, scans, device):
    """Argument tuple and statics of the first dispatch of ``scans``
    (≤ 16 scans) of a BGK or BGKL map, as the main path builds it."""
    m = pipeline.MAP_CLASSES[cfg.method](cfg, device=device)
    m._capture_step_args = True
    m.insert_pointclouds([c for c, _ in scans], [o for _, o in scans],
                         ds_resolution=cfg.resolution,
                         free_resolution=cfg.free_resolution, max_range=cfg.max_range)
    return m._last_step_call


def gate_apart(acc_k, acc_p, G: int, gate: float, what: str) -> dict:
    """The per-slot update gate k̄_g > gate on a heavy pass's accumulator
    [T, Vall, 2G], kernel against plain: the (block, node, slot) k̄ within
    GATE_MARGIN of the gate are counted, and none may be decided apart."""
    kk, kp = acc_k[..., G:], acc_p[..., G:]
    near = int(((kp - gate).abs() <= GATE_MARGIN).sum())
    apart = int(((kk > gate) != (kp > gate)).sum())
    print(f"{what}: {near} (block, node, slot) k-bar within {GATE_MARGIN} of the "
          f"{gate} gate, {apart} decided apart")
    require(apart == 0, f"{what}: the kernel and its plain version decide the gate apart")
    return {"gate_boundary": near, "decided_apart": apart}


def check_k1(args, statics, reps: int = 5, gate: float | None = None) -> dict:
    """K1 against its plain version on one dispatch's arguments: point
    entries (BGK; bit for bit) or segments (BGKL).  With ``gate`` (BGKL's
    0.001), the limit must also fail the control (the plain version on
    TF32-rounded coordinates), and no k̄ may be decided apart at the gate.
    Both branches: the work units and culled pairs (:func:`k1_culling`), the
    bound on the pairs the culling keeps and the bound on every
    evaluation."""
    (_, _, _, _, all_nodes, _, ent, lab, ids, gs, rb, rs, rn, _, ctr, _, _) = args
    hargs = (ent, lab, ids, gs, rb, rs, rn, ctr, all_nodes)
    kw = dict(G=statics["G"], sf2=statics["sf2"], ell=statics["ell"])
    seg = ent.shape[1] == 6
    name = "K1 (segments)" if seg else "K1 (points)"
    acc_k = bgk_heavy.bgk_heavy(*hargs, **kw)
    acc_p, plain_ms = _timed(lambda: bgk_heavy.bgk_heavy_plain(*hargs, **kw))
    torch.cuda.synchronize()
    lim = 1e-5 + 1e-5 * acc_p.abs()
    err = (acc_k - acc_p).abs()
    bad = int((err > lim).sum())
    max_err = float(err.max())
    out = {}
    msg = ""
    if gate is not None:
        ctl = bgk_heavy.bgk_heavy_plain(tf32_round(ent), lab, ids, gs, rb, rs, rn,
                                        tf32_round(ctr), tf32_round(all_nodes), **kw)
        out["outside_control"] = bad_ctl = int(((ctl - acc_p).abs() > lim).sum())
        msg = f"; control, the plain version on TF32-rounded coordinates: {bad_ctl} outside"
    same = bool(torch.equal(acc_k, acc_p))
    print(f"{name}: acc {tuple(acc_k.shape)}, max |kernel - plain| = {max_err:.3e}, "
          f"{bad} elements outside 1e-5 + 1e-5*|plain|, bit-equal {same}{msg}")
    require(bool(torch.isfinite(acc_k).all()), f"{name} gave non-finite values")
    require(bad == 0, f"{name} disagrees with its plain version")
    require(seg or same, f"{name} is not bit-equal to its plain version")
    if gate is not None:
        require(out["outside_control"] > 0, f"the {name} limit passes the TF32 control")
        out.update(gate_apart(acc_k, acc_p, statics["G"], gate, name))
    event_ms = cuda_ms(lambda _: bgk_heavy.bgk_heavy(*hargs, **kw), reps)
    ms = launch_ms([lambda _: bgk_heavy.bgk_heavy(*hargs, **kw)], reps)
    evals = int(rn.sum()) * all_nodes.shape[0]
    per_eval = bgk_heavy.FLOP_PER_EVAL_SEGMENT if seg else bgk_heavy.FLOP_PER_EVAL
    nbyte = nbytes(ent, lab, ids, gs, rb, rs, rn, ctr, all_nodes, acc_k)
    # the bound on the work the culled kernel must do, and beside it the
    # earlier yardstick: every evaluation of the plain algorithm
    b_all_ms, _ = bound(per_eval * evals, nbyte)
    out.update(k1_culling(hargs, acc_k, kw, name))
    out["bound_ms_every_pair"] = b_all_ms
    per_test = km.FLOP_CULL_TEST if seg else km.FLOP_CULL_TEST_POINT
    b_ms, b_by = bound(per_eval * out["needed_evaluations"]
                       + per_test * out["warp_entry_pairs"], nbyte)
    print(f"{name}: {ms:.3f} ms device time (event window {event_ms:.3f} ms; plain "
          f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}; {evals} kernel "
          f"evaluations; bound on every evaluation {b_all_ms:.4f} ms)")
    return {"acc": acc_k, "max_abs_err": max_err, "bit_equal": same, "ms": ms,
            "event_ms": event_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "evaluations": evals, **out}


def k1_culling(hargs, acc, kw, name: str, row_chunk: int = 2048) -> dict:
    """K1 on one dispatch: its work units, and the (warp, entry) pairs its
    warps skip — its own count, which must equal that of the plain
    predicate ``bgk_heavy_cull`` — with the launch bit-equal to ``acc``."""
    ent, lab, ids, gs, rb, rs, rn, ctr, all_nodes = hargs
    culled = torch.zeros(1, dtype=torch.int64, device=ent.device)
    again = bgk_heavy.bgk_heavy(*hargs, **kw, culled=culled)
    Vall, Tp, R = all_nodes.shape[0], ctr.shape[0], rb.shape[0]
    wpb = (Vall + 31) // 32
    per_warp = sum(bgk_heavy.bgk_heavy_cull(ent, ids, rb[c:c + row_chunk],
                                            rs[c:c + row_chunk], rn[c:c + row_chunk],
                                            ctr, all_nodes, ell=kw["ell"]).sum((0, 2))
                   for c in range(0, R, row_chunk))
    plain = int(per_warp.sum())
    needed, pairs = warp_work(per_warp, int(rn.sum()), Vall)
    frac = int(culled) / max(pairs, 1)
    print(f"{name}: T {Tp} blocks, R {R} rows, {Tp * wpb} work units (warps of 32 "
          f"of {Vall} nodes), {int(culled)} of {pairs} (warp, entry) pairs culled "
          f"({100 * frac:.2f} %; the plain predicate: {plain}), {needed} evaluations "
          f"in the pairs kept")
    require(int(culled) == plain, f"{name}: its warps cull other pairs than bgk_heavy_cull")
    require(bool(torch.equal(again, acc)), f"{name}: a repeat launch differs")
    return {"T": Tp, "R": R, "work_units": Tp * wpb, "culled_pairs": int(culled),
            "warp_entry_pairs": pairs, "culled_fraction": frac,
            "needed_evaluations": needed}


def check_k2(args, statics, acc, reps: int = 5, what: str = "16-scan demo dispatch") -> dict:
    """K2 against its plain version on the same accumulator and pool state,
    over every scan of the dispatch in order: A, B, touched and eff equal
    bit for bit.  Bound: the bytes the data needs — each block's distinct
    eff-level node rows of the accumulator (voxels whose eff level shares a
    node read one row), the pool rows read and written — and beside it
    every voxel's own row (``bound_ms_every_voxel``)."""
    (A, B, T, E, _, node_idx, _, _, _, _, _, _, _, slots, _, ss, sc) = args
    kw = {k: statics[k] for k in ("G", "gate", "n", "max_level", "state_fn",
                                  "do_prune")}

    def pool():
        return A.clone(), B.clone(), T.clone(), E.clone()

    def run(fn, st, rows=None):
        for s, c in zip(ss, sc):
            if rows is not None:  # the scan's distinct (block, node) rows
                sl = slots[s:s + c].long()
                sl = sl[sl < A.shape[0]]
                nodes = node_idx.long()[st[3][sl].long(),
                                        torch.arange(A.shape[1], device=A.device)]
                nodes = torch.sort(nodes, dim=1).values
                rows.append(int(sl.numel() + (nodes[:, 1:] != nodes[:, :-1]).sum()))
            fn(acc, *st, node_idx, slots, s, c, **kw)
        return st

    k = run(bgk_light.bgk_light, pool())
    distinct = []
    p = run(bgk_light.bgk_light_plain, pool(), distinct)
    torch.cuda.synchronize()
    max_err = max(float((k[0] - p[0]).abs().max()), float((k[1] - p[1]).abs().max()))
    same = [bool(torch.equal(x, y)) for x, y in zip(k, p)]
    V = A.shape[1]
    print(f"K2, {what}: {len(ss)} scans, blocks of {V} voxels, max |A/B kernel - plain| "
          f"= {max_err:.3e}, A, B, touched, eff equal {same}, voxels by eff level "
          f"{light_levels(k[3], slots, statics['max_level'])}")
    require(all(same), f"K2 disagrees with its plain version ({what})")
    event_ms = cuda_ms(lambda st: run(bgk_light.bgk_light, st), reps, setup=pool)
    count = len(ss)

    def launches(prune: bool) -> list:
        return [lambda st, s=s, c=c: bgk_light.bgk_light(acc, *st, node_idx, slots, s, c,
                                                         **{**kw, "do_prune": prune})
                for s, c in zip(ss, sc)]

    ms = launch_ms(launches(kw["do_prune"]), reps, setup=pool)
    ms_fold = launch_ms(launches(False), reps, setup=pool)
    plain_ms = cuda_ms(lambda st: run(bgk_light.bgk_light_plain, st), 2, setup=pool)
    G = statics["G"]
    blocks = int(sum(sc))
    # per block: each voxel's 2G accumulator values read, the pool row
    # (A, B f32; touched, eff 1 byte) read and written, its slot read
    per_block = V * 2 * G * 4 + 2 * V * (4 + 4 + 1 + 1) + 4
    b_all_ms, _ = bound(0, blocks * per_block + nbytes(node_idx))
    n_rows = sum(distinct)
    b_ms, b_by = bound(0, n_rows * 2 * G * 4 + blocks * (2 * V * (4 + 4 + 1 + 1) + 4)
                       + nbytes(node_idx))
    print(f"K2, {what}: {ms:.4f} ms device time over {count} launches "
          f"({1e3 * ms / count:.2f} us each; without the prune {ms_fold:.4f} ms; the event "
          f"window, which holds the host's launch gaps, {event_ms:.3f} ms); plain "
          f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by} ({n_rows} distinct accumulator "
          f"rows of {blocks * V} voxels; every voxel's own row: {b_all_ms:.4f} ms); {blocks} "
          f"blocks, G {G}")
    return {"max_abs_err": max_err, "ms": ms, "ms_without_prune": ms_fold,
            "event_ms": event_ms, "ms_per_launch": ms / count, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bound_ms_every_voxel": b_all_ms,
            "accumulator_rows": n_rows, "voxels_per_block": V, "blocks": blocks, "G": G}


def check_k2_pools(args, statics, acc, what: str) -> dict:
    """K2 on one dispatch's accumulator from its blocks made collapsible and
    near-collapsible (:func:`check_light_collapsible`), every prune level
    reached on each."""
    kw = {k: statics[k] for k in ("G", "gate", "n", "max_level", "state_fn", "do_prune")}
    pool0, n, slots = args[:4], statics["n"], args[13]
    starts = {"collapsible": collapsible_pool(pool0, slots, n, templates=BETA_TEMPLATES,
                                              raster=True),
              "near": near_collapsible_pool(pool0, slots, n, BGK_NEAR_VALUES, raster=True)}
    return {k: check_light_collapsible(
        "K2", bgk_light.bgk_light, bgk_light.bgk_light_plain, (acc,), start, args[5], slots,
        args[15], args[16], kw, what=f"{k} blocks, {what}", every_level=True)
        for k, start in starts.items()}


def light_levels(eff, slots, max_level: int) -> list:
    """Voxels of the pool rows ``slots`` (padding dropped) by eff level."""
    sl = slots.long()
    sl = torch.unique(sl[sl < eff.shape[0]])
    return [int((eff[sl] == L).sum()) for L in range(max_level + 1)]


def reset_counts() -> None:
    ingest_sort.launches = ingest_sort.kernel_launches = 0
    ingest_bucket.launches = 0
    ingest_slots.launches = 0
    ingest_rays.launches = 0
    k6.launches = 0
    ingest_beams.launches = 0
    ingest_downsample.launches = 0
    ingest_members.launches = 0
    ingest_voxel_grid.launches = 0
    bgk_aligned_heavy.launches = 0
    bgk_heavy.launches = 0
    bgk_light.launches = 0
    lv_rows.launches = 0
    lv_prune.launches = 0
    gp_heavy.launches = 0
    gp_light.launches = 0


def main_path(cfg, pcd_dir: str, scans, runs=(12, 60)) -> dict:
    """The host-ingest path of a BGK or BGKL map: run_static on each of
    ``runs`` scans, then OnlineIntegrator on 12 scans."""
    cls = pipeline.MAP_CLASSES[cfg.method]
    out = {}
    for n_scans in runs:
        ds = DatasetConfig(name="synth", dir=pcd_dir, prefix="synth",
                           scan_num=n_scans, max_range=cfg.max_range)
        reset_counts()
        res = pipeline.run_static(cfg, ds)
        k1, k2 = bgk_heavy.launches, bgk_light.launches
        dispatches = -(-n_scans // cls.SCAN_BATCH)
        ex = pipeline.export_leaves(res.map)
        n_occ, n_free = len(ex["occupied"]["x"]), len(ex["free"]["x"])
        print(f"{cfg.method} (block_depth {cfg.block_depth}, max_range {cfg.max_range:g}) "
              f"run_static {n_scans} scans: {res.scans_per_second:.2f} scans/s "
              f"({res.total_seconds:.3f} s), {res.map.pool.n_blocks} blocks, "
              f"{n_occ} occupied / {n_free} free leaves; launches K1 {k1} "
              f"K2 {k2}")
        require(k1 == dispatches, f"K1 launched {k1} times, expected {dispatches}")
        require(k2 == n_scans, f"K2 launched {k2} times, expected {n_scans}")
        require(n_occ > 0 and n_free > 0, "no occupied or no free leaves")
        leaves = ex["all"]
        require(all(np.isfinite(leaves[k]).all() for k in ("prob", "var", "x")),
                "non-finite leaves")
        out[f"static{n_scans}"] = {"scans_per_s": res.scans_per_second,
                                   "seconds": res.total_seconds,
                                   "launches": {"bgk_heavy": k1, "bgk_light": k2}}

    m = cls(cfg)
    online = pipeline.OnlineIntegrator(m)
    lat = []
    reset_counts()
    for cloud, origin in scans[:12]:
        t0 = time.perf_counter()
        online.offer(cloud, origin)
        m.synchronize()
        lat.append(time.perf_counter() - t0)
    k1, k2 = bgk_heavy.launches, bgk_light.launches
    med = float(np.median(lat)) * 1e3
    print(f"{cfg.method} OnlineIntegrator 12 scans: {online.n_integrated} integrated, median "
          f"latency {med:.2f} ms (min {min(lat) * 1e3:.2f}, max "
          f"{max(lat) * 1e3:.2f}); launches K1 {k1} K2 {k2}")
    require(online.n_integrated == 12 and k1 == k2 == online.n_integrated,
            "online launches do not match the integrated scans")
    out["online12"] = {"median_ms": med, "integrated": online.n_integrated,
                       "launches": {"bgk_heavy": k1, "bgk_light": k2}}
    return out


def profile_main_path(cfg, pcd_dir: str, kernels: dict, launches: dict) -> dict:
    """Where the time goes: the 60-scan run_static once more under
    torch.profiler — device time by kernel (``kernels``: label → part of
    the CUDA kernel's name, ``launches``: label → the launches the run
    makes) against the wall clock."""
    from torch.autograd import DeviceType

    ds = DatasetConfig(name="synth", dir=pcd_dir, prefix="synth", scan_num=60,
                       max_range=cfg.max_range)

    def run():
        t0 = time.perf_counter()
        res = pipeline.run_static(cfg, ds)
        return res, (time.perf_counter() - t0) * 1e3

    prof, (res, wall_ms) = profiled(run, {kernels[k]: n for k, n in launches.items()})
    dev, other = {}, {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:   # kernels and copies on the card
            name = next((k for k, v in kernels.items() if v in e.key),
                        "memcpy_h2d" if "HtoD" in e.key else "other")
            dev[name] = dev.get(name, 0.0) + e.self_device_time_total / 1e3
            if name == "other":
                ms, n = other.get(e.key, (0.0, 0))
                other[e.key] = (ms + e.self_device_time_total / 1e3, n + e.count)
    other = dict(sorted(other.items(), key=lambda kv: -kv[1][0]))
    busy = sum(dev.values())
    host_ms = res.map.stats["host_s"] * 1e3
    print(f"profile, {cfg.method} run_static 60 scans: wall {wall_ms:.1f} ms (profiled), "
          f"device busy {busy:.3f} ms = {100 * busy / wall_ms:.2f}% "
          f"(idle {100 - 100 * busy / wall_ms:.2f}%), host main thread "
          f"{host_ms:.1f} ms; device ms by kind "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(dev.items())))
    print("profile, other by op (ms, launches): " + "; ".join(
        f"{k[:90]} {ms:.3f} ({n})" for k, (ms, n) in list(other.items())[:12]))
    require(all(dev.get(k, 0) > 0 for k in kernels), "the profiler saw no kernel time")
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "host_ms": host_ms,
            "device_ms": dev,
            "other_by_op": {k[:120]: {"ms": ms, "launches": n} for k, (ms, n) in other.items()}}


def card_vs_cpu(cfg, pcd_dir: str, n_scans: int = 3, tol=(5e-3, 0.0),
                control=None) -> float:
    """The first ``n_scans`` scans on the card and on the CPU, voxel by voxel:
    A/B within tol[0] + tol[1]·|CPU|.  The voxels whose added mass is ≤ 1e-5
    sit on the update gate's boundary (k̄ > 0 for BGK: the clamp; k̄ > 0.001
    for BGKL and BGKLV), where the card's and the CPU's last ulp may decide
    apart; eff and touched must agree elsewhere.  ``control`` = (module,
    wrapper name, stand-in): the card's map once more with the wrapper
    replaced (the heavy pass on TF32-rounded coordinates), which must fail
    the limit."""
    ds = DatasetConfig(name="synth", dir=pcd_dir, prefix="synth", scan_num=n_scans,
                       max_range=cfg.max_range)
    gpu = pipeline.run_static(cfg, ds, device="cuda").map
    ctl = None
    if control is not None:
        mod, name, stand_in = control
        kernel = getattr(mod, name)
        setattr(mod, name, stand_in)
        try:
            ctl = pipeline.run_static(cfg, ds, device="cuda").map
        finally:
            setattr(mod, name, kernel)
    # the CPU reference on one thread: its sums then do not depend on how
    # PyTorch splits the work
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cpu = pipeline.run_static(cfg, ds, device="cpu").map
    finally:
        torch.set_num_threads(threads)
    nb = gpu.pool.n_blocks
    require(nb == cpu.pool.n_blocks and np.array_equal(
        gpu.pool.coords[:nb], cpu.pool.coords[:nb]), "block sets differ")
    rows = np.arange(nb)
    g = {k: gpu._gather_rows(v, rows) for k, v in gpu.pool.fields.items()}
    c = {k: cpu._gather_rows(v, rows) for k, v in cpu.pool.fields.items()}
    dev = max(float(np.abs(g[k] - c[k]).max()) for k in g)

    def ratio_of(f):
        return max(float((np.abs(f[k] - c[k]) / (tol[0] + tol[1] * np.abs(c[k]))).max())
                   for k in c)

    ratio = ratio_of(g)
    msg = ""
    if ctl is not None:
        require(ctl.pool.n_blocks == nb and np.array_equal(ctl.pool.coords[:nb],
                                                           cpu.pool.coords[:nb]),
                "the control's block set differs")
        ratio_ctl = ratio_of({k: ctl._gather_rows(v, rows) for k, v in ctl.pool.fields.items()})
        msg = f" (control, the heavy pass on TF32-rounded coordinates: {ratio_ctl:.3f})"
    prior = np.array([cfg.prior_A, cfg.prior_B], np.float32)
    mass = np.maximum(
        np.maximum(np.abs(g["A"] - prior[0]), np.abs(g["B"] - prior[1])),
        np.maximum(np.abs(c["A"] - prior[0]), np.abs(c["B"] - prior[1])))
    away = mass > 1e-5
    eff_g = gpu._gather_rows(gpu.pool.eff_level, rows)
    eff_c = cpu._gather_rows(cpu.pool.eff_level, rows)
    t_g = gpu._gather_rows(gpu.pool.touched, rows)
    t_c = cpu._gather_rows(cpu.pool.touched, rows)
    n_eff = int((eff_g != eff_c).sum())
    n_eff_away = int(((eff_g != eff_c) & away).sum())
    n_t_away = int(((t_g != t_c) & away).sum())
    print(f"card vs CPU, {cfg.method} {n_scans} scans (device ingest "
          f"{cfg.device_ingest}): {nb} blocks, max |A/B| deviation {dev:.3e}, "
          f"largest deviation / ({tol[0]:g} + {tol[1]:g}*|CPU|) = {ratio:.3f}{msg}, "
          f"eff differs at {n_eff} voxels ({n_eff_away} with mass > 1e-5), "
          f"touched differs at {n_t_away} voxels with mass > 1e-5")
    require(ratio <= 1.0, f"card and CPU maps differ beyond {tol[0]:g} + {tol[1]:g}*|CPU|")
    if ctl is not None:
        require(ratio_ctl > 1.0, "the card-vs-CPU limit passes the TF32 control")
    require(n_eff_away == 0 and n_t_away == 0,
            "eff/touched differ off the gate boundary")
    return dev


# ------------------------------------------------------------ BGKLV phases

#: plain k̄ this close to the LV gate may be decided the other way by the
#: kernel's own last ulp (its sums are the plain version's, in its order)
GATE_MARGIN = 1e-5


def capture_lv(cfg, scans):
    """An LV map on the card that keeps copies of the arguments of its first
    row-engine dispatch (and of its last prune) over ``scans``."""
    m = BGKLVOctoMap(cfg, device="cuda")
    m._capture_step_args = True
    m.insert_pointclouds([c for c, _ in scans], [o for _, o in scans],
                         ds_resolution=cfg.resolution,
                         free_resolution=cfg.free_resolution, max_range=MAX_RANGE)
    return m


def check_k3(args, statics, reps: int = 5) -> dict:
    """K3 against its plain version on one dispatch's arguments and pool."""
    pool0, rest = args[:4], args[4:]
    vbt, ent, lab, ids, rt, rs, rn, slots, pos, ctr = rest

    def pool():
        return [x.clone() for x in pool0]

    def plain(st):
        acc_y, acc_k, members = lv_rows.lv_rows_acc_plain(
            vbt, ent, lab, ids, rt, rs, rn, pos, ctr, sf2=statics["sf2"],
            ell=statics["ell"], free_res=statics["free_res"])
        lv_rows.lv_rows_apply_plain(*st, acc_y, acc_k, slots, pos, gate=statics["gate"])
        return acc_k, members

    k = pool()
    lv_rows.lv_rows(*k, *rest, **statics)
    p = pool()
    acc_k, members = plain(p)
    torch.cuda.synchronize()
    cap, V = pool0[0].shape
    Vt = vbt.shape[1]
    tpb = V // Vt
    row = slots.long() * tpb + pos.long()
    near = ((acc_k - statics["gate"]).abs() <= GATE_MARGIN).to(torch.int32)
    excused = torch.zeros((cap * tpb, Vt), dtype=torch.int32, device=near.device)
    excused.index_add_(0, row, near)
    excused = excused.view(cap, V) > 0
    errA, errB = (k[0] - p[0]).abs(), (k[1] - p[1]).abs()
    off = ((errA > 1e-5 + 1e-5 * p[0].abs()) | (errB > 1e-5 + 1e-5 * p[1].abs())
           | (k[2] != p[2]))
    bad = int((off & ~excused).sum())
    n_near, n_moved = int(excused.sum()), int((off & excused).sum())
    max_err = max(float(errA[~excused].max()), float(errB[~excused].max()))
    updated = int((k[0] != pool0[0]).sum())
    print(f"K3: {len(slots)} (scan, tile) entries, {len(rt)} rows, {updated} voxels "
          f"updated; max |A/B kernel - plain| = {max_err:.3e}, {bad} voxels outside "
          f"1e-5 + 1e-5*|plain| or with touched differing; {n_near} voxels within "
          f"{GATE_MARGIN} of the gate, {n_moved} of them decided apart")
    require(bool(torch.isfinite(k[0]).all() and torch.isfinite(k[1]).all()),
            "K3 gave non-finite values")
    require(bad == 0 and torch.equal(k[3], pool0[3]), "K3 disagrees with its plain version")
    # the kernel's own count of culled (warp, entry) pairs, in a launch that
    # must repeat the first bit for bit, against the plain predicate's
    again, culled = pool(), torch.zeros(1, dtype=torch.int64, device=ent.device)
    lv_rows.lv_rows(*again, *rest, **statics, culled=culled)
    real = slots[rt.long()] < cap
    cull = lv_rows.lv_rows_cull(vbt, ent, ids, rt, rs, rn, pos, ctr, ell=statics["ell"])
    per_warp = cull[real].sum((0, 2))
    plain_culled = int(per_warp.sum())
    wpt = (Vt + 31) // 32
    needed, pairs = warp_work(per_warp, int(rn[real].sum()), Vt)
    T_real, units = int((slots < cap).sum()), int(real.sum()) * wpt
    scratch = max(r1 - r0 for _, _, r0, r1, _ in lv_rows.lv_rows_plan(
        rt, slots, pos, tpb=tpb, Vt=Vt)[1]) * Vt * 8
    print(f"K3: T {len(slots)} (scan, tile) entries ({T_real} real), R {len(rt)} rows, "
          f"{units} work units (warps of 32 voxels of a row), {int(members)} member pairs "
          f"({100 * int(members) / max(int(rn.sum()) * Vt, 1):.2f} % of the (voxel, entry) "
          f"pairs), {int(culled)} of {pairs} (warp, entry) pairs culled "
          f"({100 * int(culled) / max(pairs, 1):.2f} %; the plain predicate: {plain_culled}), "
          f"{needed} memberships in the pairs kept; row-sum scratch {scratch} bytes "
          f"(cap {lv_rows.SCRATCH_BYTES})")
    require(all(torch.equal(x, y) for x, y in zip(again, k)), "K3: a repeat launch differs")
    require(int(culled) == plain_culled, "K3's warps cull other pairs than lv_rows_cull")
    event_ms = cuda_ms(lambda st: lv_rows.lv_rows(*st, *rest, **statics), reps, setup=pool)
    ms = launch_ms([lambda st: lv_rows.lv_rows(*st, *rest, **statics)], reps, setup=pool)
    plain_ms = cuda_ms(plain, 1, warmup=0, setup=pool)  # warmed up by the check
    evals = int(rn.sum()) * Vt
    n_rows = int(torch.unique(row).numel())
    flops_all = lv_rows.FLOP_MEMBERSHIP * evals + lv_rows.FLOP_MEMBER * int(members)
    # the work the culled kernel must do: memberships in the (warp, entry)
    # pairs kept, the members' sums, the cull test of every pair
    flops = (lv_rows.FLOP_MEMBERSHIP * needed + lv_rows.FLOP_MEMBER * int(members)
             + km.FLOP_CULL_TEST * pairs)
    # inputs read once; each pool row updated: A, B, touched, eff read and
    # A, B, touched written
    nbyte = nbytes(*rest) + n_rows * Vt * (10 + 9)
    b_ms, b_by = bound(flops, nbyte)
    b_all_ms = bound(flops_all, nbyte)[0]
    print(f"K3: {ms:.3f} ms device time (event window {event_ms:.3f} ms; plain "
          f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}; {evals} evaluations, "
          f"{int(members)} members, {flops:.4g} operations; bound on every evaluation "
          f"{b_all_ms:.4f} ms, {flops_all:.4g} operations)")
    return {"max_abs_err": max_err, "ms": ms, "event_ms": event_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bound_ms_every_pair": b_all_ms, "needed_evaluations": needed,
            "scratch_bytes": scratch,
            "evaluations": evals, "members": int(members),
            "gate_boundary_voxels": n_near, "decided_apart": n_moved, "T": len(slots),
            "R": len(rt), "work_units": units, "culled_pairs": int(culled),
            "warp_entry_pairs": pairs, "culled_fraction": int(culled) / max(pairs, 1)}


#: (f0, f1) templates of :func:`collapsible_pool`, one state each: LV (A, B)
#: occupied, free, uncertain under the BGKLV large-map thresholds; Beta
#: (A, B) occupied, free; GP (m_ivar, ivar) occupied, free — far enough from
#: every threshold that a scan's update leaves each voxel's state
LV_TEMPLATES = ((100.0, 0.001), (0.001, 100.0), (1.0, 1.0))
BETA_TEMPLATES = ((1000.0, 0.001), (0.001, 1000.0))
GP_TEMPLATES = ((1e4, 500.0), (-1e4, 500.0))


def collapsible_pool(pool0, slots, n: int, seed: int = 0, templates=LV_TEMPLATES,
                     raster: bool = False):
    """A copy of the pool whose blocks ``slots`` collapse at every level,
    the levels across tiles included: block i holds one (f0, f1) template
    per cube of edge min((n, 16, 8, 4)[i % 4], n) (one state per cube), ±5 % noise
    so that collapse copies show, every voxel touched at eff 0; edge-4
    blocks also get 3 % stray voxels, so that their tiles are not uniform.
    The pool is BGKLV's tile-major one, or with ``raster`` K2's and K5's
    raster one."""
    rng = np.random.default_rng(seed)
    tmpl = np.array(templates, np.float32)
    sl = pool_blocks(pool0, slots)
    S = len(sl)
    vox = np.empty((S, n ** 3), np.int64)
    for i in range(S):
        edge = min((n, 16, 8, 4)[i % 4], n)
        g = n // edge
        k = len(tmpl)
        t = rng.integers(0, k, (g, g, g)).repeat(edge, 0).repeat(edge, 1).repeat(edge, 2)
        vox[i] = t.reshape(-1)
        if edge == 4:
            stray = rng.uniform(size=n ** 3) < 0.03
            vox[i] = np.where(stray, rng.integers(0, k, n ** 3), vox[i])
    AB = tmpl[vox] * rng.uniform(0.95, 1.05, (S, n ** 3, 2)).astype(np.float32)
    return fill_blocks(pool0, sl, (AB[..., 0], AB[..., 1], True, 0), n, raster)


def pool_blocks(pool0, slots) -> np.ndarray:
    """The pool rows of ``slots``, padding dropped, each once, in order."""
    sl = slots.long()
    sl = sl[sl < pool0[0].shape[0]].cpu().numpy()
    return sl[np.sort(np.unique(sl, return_index=True)[1])]


def fill_blocks(pool0, sl, raster_rows, n: int, raster: bool):
    """A copy of the pool with rows ``sl`` set to ``raster_rows`` (f0, f1,
    touched, eff: [len(sl), n³] arrays in raster order, or scalars), on
    BGKLV's tile-major columns, or with ``raster`` on K2's and K5's raster
    ones."""
    # stored column → raster voxel
    perm = np.arange(n ** 3) if raster else geo.tile_vox_map(n).reshape(-1)
    dev = pool0[0].device
    pool = [x.clone() for x in pool0]
    rows = torch.as_tensor(sl, device=dev)
    for x, r in zip(pool, raster_rows):
        x[rows] = torch.as_tensor(r[:, perm], device=dev) if isinstance(r, np.ndarray) else r
    return pool


#: LV near-collapsible templates, state → (A, B, touched), far from every
#: threshold of the BGKLV large map; an UNKNOWN voxel is untouched.  Not the
#: CPU tests' templates (``tests/torch_cases.py::LV_NEAR_VALUES``): the large
#: map's var_thresh of 0.001 makes their OCCUPIED and FREE voxels UNCERTAIN
LV_NEAR_VALUES = {posterior.OCCUPIED: (100.0, 0.001, True),
                  posterior.FREE: (0.001, 100.0, True),
                  posterior.UNCERTAIN: (1.0, 1.0, True),
                  posterior.UNKNOWN: (100.0, 0.001, False)}
#: GP near-collapsible templates (the GP configs share their thresholds)
GP_NEAR_VALUES = group_prune.GP_NEAR_VALUES
#: Beta near-collapsible templates (the BGK and BGKL configs share theirs)
BGK_NEAR_VALUES = group_prune.BGK_NEAR_VALUES


def near_collapsible_pool(pool0, slots, n: int, values, raster: bool = False, seed: int = 0):
    """A copy of the pool whose blocks ``slots`` are each one change away
    from collapsing at one level, the levels cycling over the blocks and
    every kind of change over each level's groups
    (``kernels/group_prune.py::near_collapsible_rows``; the collapsible states
    are those of ``values`` but UNKNOWN), with the templates ``values``.
    The pool is BGKLV's tile-major one, or with ``raster`` K5's raster one."""
    sl = pool_blocks(pool0, slots)
    states = tuple(k for k in values if k != posterior.UNKNOWN)
    st, eff = group_prune.near_collapsible_rows(n, len(sl), states, seed=seed)
    f0, f1, touched = group_prune.near_pool_values(st, values, seed=seed + 1)
    return fill_blocks(pool0, sl, (f0, f1, touched, eff), n, raster)


def check_k8(args, statics, reps: int = 10) -> dict:
    """K8 against its plain version on the pool state of one real prune,
    and on the same blocks made collapsible at every level (the real scene
    collapses no 16³ or 32³ group, and those levels run in the kernel's
    second, cross-tile half) and near-collapsible (each group one change
    away from collapsing), every level reached on both."""
    pool0, slots = args[:4], args[4]
    n, max_level = statics["n"], statics["max_level"]
    sl = slots.long()

    def compare(start, what):
        k = [x.clone() for x in start]
        lv_prune.lv_prune(*k, slots, **statics)
        p = [x.clone() for x in start]
        lv_prune.lv_prune_plain(*p, slots, **statics)
        torch.cuda.synchronize()
        same = [torch.equal(x, y) for x, y in zip(k, p)]
        levels = [int((k[3][sl] == L).sum()) for L in range(max_level + 1)]
        print(f"K8, {what}: {len(slots)} blocks of {start[0].shape[1]} voxels; A, B, "
              f"touched, eff equal to the plain version: {same}; voxels by eff level "
              f"{levels}")
        require(all(same), f"K8 disagrees with its plain version ({what})")
        return levels, k

    levels, out = compare(pool0, "the real pool")
    levels_all, _ = compare(collapsible_pool(pool0, slots, n), "collapsible blocks")
    levels_near, _ = compare(near_collapsible_pool(pool0, slots, n, LV_NEAR_VALUES),
                             "near-collapsible blocks")
    require(max_level >= 5 and all(lv[L] > 0 for lv in (levels_all, levels_near)
                                   for L in range(1, max_level + 1)),
            "the collapsible or near-collapsible blocks did not reach every level, the "
            "cross-tile levels 4 and 5 included")

    def pool():
        return [x.clone() for x in pool0]

    event_ms = cuda_ms(lambda st: lv_prune.lv_prune(*st, slots, **statics), reps,
                       setup=pool)
    ms = launch_ms([lambda st: lv_prune.lv_prune(*st, slots, **statics)], reps,
                   setup=pool)
    plain_ms = cuda_ms(lambda st: lv_prune.lv_prune_plain(*st, slots, **statics), 2,
                       setup=pool)
    V = pool0[0].shape[1]
    # what the prune must move: every voxel's touched byte; A, B (f32) and eff
    # of each touched voxel (an untouched one is UNKNOWN: no group holding
    # it collapses, and it is never copied); A, B, touched, eff of each
    # voxel that collapsed, written once
    Vt = min(8, n) ** 3
    live = torch.unique(sl[sl < pool0[0].shape[0]])
    tiles_touched = int(pool0[2][live].view(len(live), -1, Vt).any(dim=2).sum())
    voxels_touched = int(pool0[2][live].sum())
    written = int((out[3][live] != pool0[3][live]).sum())
    need = len(live) * V + voxels_touched * 9 + written * 10 + nbytes(slots)
    b_ms, b_by = bound(0, need)
    # every voxel's A, B, touched and eff read and written once
    b_all_ms, _ = bound(0, len(slots) * V * 2 * (4 + 4 + 1 + 1) + nbytes(slots))
    print(f"K8: {ms:.4f} ms device time on the real pool (event window "
          f"{event_ms:.3f} ms; plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by} on "
          f"{need} bytes: {voxels_touched} touched voxels in {tiles_touched} of "
          f"{len(live) * V // Vt} tiles, {written} voxels collapsed; every byte read and "
          f"written "
          f"{b_all_ms:.4f} ms)")
    return {"max_abs_err": 0.0, "ms": ms, "event_ms": event_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bound_ms_every_byte": b_all_ms,
            "tiles_touched": tiles_touched, "voxels_touched": voxels_touched,
            "voxels_collapsed": written, "levels": levels,
            "levels_collapsible": levels_all, "levels_near_collapsible": levels_near}


def main_path_lv(cfg, cfg_large, pcd_dir: str, scans) -> dict:
    """BGKLV: run_static on 12 and 60 demo scans, OnlineIntegrator on 12
    scans, run_static on 12 large-map scans."""
    out = {}
    runs = [(cfg, 12), (cfg, 60), (cfg_large, 12)]
    for c, n_scans in runs:
        ds = DatasetConfig(name="synth", dir=pcd_dir, prefix="synth",
                           scan_num=n_scans, max_range=MAX_RANGE)
        reset_counts()
        res = pipeline.run_static(c, ds)
        k3, k8 = lv_rows.launches, lv_prune.launches
        m = res.map
        large = c.original_size
        want3 = n_scans if large else -(-n_scans // BGKLVOctoMap.SCAN_BATCH)
        want8 = n_scans if large else 0
        ex = pipeline.export_leaves(m, original_size=large)
        leaves = ex["all"]
        n_occ, n_free = len(ex["occupied"]["x"]), len(ex["free"]["x"])
        n_touched = int(m.pool.touched.sum())
        n_pruned = int((m.pool.eff_level > 0).sum())
        name = f"{'large' if large else 'static'}{n_scans}"
        print(f"BGKLV run_static {n_scans} scans ({'large map' if large else 'demo'}): "
              f"{res.scans_per_second:.2f} scans/s ({res.total_seconds:.3f} s), "
              f"{m.pool.n_blocks} blocks, {n_touched} touched voxels, {n_pruned} "
              f"pruned, {n_occ} occupied / {n_free} free leaves; launches K3 {k3} "
              f"K8 {k8}")
        require(k3 == want3, f"K3 launched {k3} times, expected {want3}")
        require(k8 == want8, f"K8 launched {k8} times, expected {want8}")
        # the large-map config's var_thresh of 0.001 leaves most touched
        # voxels UNCERTAIN, and UNCERTAIN groups collapse
        require(n_touched > 0 and (n_pruned > 0 if large else n_occ > 0),
                "no touched voxels, or no occupied (demo) / pruned (large map) ones")
        require(all(np.isfinite(leaves[k]).all() for k in ("prob", "var", "x")),
                "non-finite leaves")
        out[name] = {"scans_per_s": res.scans_per_second, "seconds": res.total_seconds,
                     "launches": {"lv_rows": k3, "lv_prune": k8}}

    m = BGKLVOctoMap(cfg)
    online = pipeline.OnlineIntegrator(m)
    lat = []
    reset_counts()
    for cloud, origin in scans[:12]:
        t0 = time.perf_counter()
        online.offer(cloud, origin)
        m.synchronize()
        lat.append(time.perf_counter() - t0)
    k3, k8 = lv_rows.launches, lv_prune.launches
    med = float(np.median(lat)) * 1e3
    print(f"BGKLV OnlineIntegrator 12 scans: {online.n_integrated} integrated, median "
          f"latency {med:.2f} ms (min {min(lat) * 1e3:.2f}, max "
          f"{max(lat) * 1e3:.2f}); launches K3 {k3} K8 {k8}")
    require(online.n_integrated == 12 and k3 == online.n_integrated and k8 == 0,
            "online launches do not match the integrated scans")
    out["online12"] = {"median_ms": med, "integrated": online.n_integrated,
                       "launches": {"lv_rows": k3, "lv_prune": k8}}
    return out


# --------------------------------------------------------------- GP phases

#: K4 against its plain version, (mean, var) limit on |Δ|/(1+|plain|) by
#: tier: α = K⁻¹y carries the Gram's conditioning into the factor's rounding
#: order, so means get 1e-3 in the base tier (≤ 128 points; 6.3e-4 seen on
#: the card) and 4e-3 in the overflow tier (up to 512 points; 1.9e-3 seen),
#: variances 1e-5 (3.4e-6 seen).  Each limit must fail the control, the
#: plain version on TF32-rounded coordinates (PERF.md has both readings).
K4_TOL = {"base": (1e-3, 1e-5), "overflow": (4e-3, 1e-5)}
#: the largest model those limits were measured on; a tier of larger models
#: (block_depth 5: up to about 2100 points) is held to the plain version in
#: f64 instead — |Δ|/(1+|f64|) of the kernel at most K4_F64_FACTOR times the
#: f32 plain version's (cuSOLVER/cuBLAS), and the control's above that
K4_CALIBRATED_MAX_C = 512
K4_F64_FACTOR = 2.0
#: plain pre-prune p this close to a threshold, or ivar this close (relative)
#: to the chop, may be decided apart by the kernel's own division
STATE_MARGIN = 1e-5


def k4_vs_f64(ins, cmax, kw, rows, k, p, ctl, G, Vall, T, what) -> dict:
    """One tier of K4 (tables ``k``), its f32 plain version (``p``) and the
    control (``ctl``) against the plain version in f64: per field the
    largest |Δ|/(1+|f64|); the kernel's may be at most K4_F64_FACTOR times
    the f32 plain version's, the control's must exceed that."""
    dev = ins[0].device
    r64 = {"acc_mean": torch.zeros((T * G, Vall), dtype=torch.float64, device=dev),
           "acc_var": torch.ones((T * G, Vall), dtype=torch.float64, device=dev),
           "present": torch.zeros(T * G, dtype=torch.bool, device=dev),
           "failed": torch.zeros(1, dtype=torch.int32, device=dev)}
    pts, lab, st, ct, nb, centers, all_nodes = ins
    gp_heavy.gp_heavy_plain(pts.double(), lab.double(), st, ct, nb, centers.double(),
                            all_nodes.double(), **r64, cmax=cmax, **kw)
    out = {}
    for name in ("acc_mean", "acc_var"):
        ref = r64[name][rows]
        scale = 1.0 + ref.abs()
        out[name] = {who: float(((t[name][rows].double() - ref).abs() / scale).max())
                     for who, t in (("kernel", k), ("plain", p), ("control", ctl))}
    print(f"K4, {what}: models of up to {cmax} points against the plain version in "
          f"f64, largest |Δ|/(1+|f64|): " + "; ".join(
              f"{n[4:]} kernel {e['kernel']:.3e}, f32 plain {e['plain']:.3e}, control "
              f"{e['control']:.3e}" for n, e in out.items())
          + f" (the kernel's limit: {K4_F64_FACTOR:g} times the f32 plain version's)")
    require(int(r64["failed"]) == 0, f"K4 ({what}): an f64 factorisation failed")
    for n, e in out.items():
        require(e["kernel"] <= K4_F64_FACTOR * e["plain"],
                f"K4 ({what}): {n} further from f64 than {K4_F64_FACTOR:g} times the "
                "f32 plain version")
        require(e["control"] > K4_F64_FACTOR * e["plain"],
                f"the K4 f64 limit passes the TF32 control ({what}, {n})")
    return out


def capture_gp(cfg, scans=None, training=None, run_step: bool = True):
    """A GP map on the card that keeps copies of the arguments of its last
    dispatch: of ``scans`` (≤ 16: one dispatch) or of ``training`` points.
    Without ``run_step`` the dispatch is captured and not run: the checks
    run its kernels on the copies."""
    m = GPOctoMap(cfg, device="cuda")
    m._capture_step_args = True
    step = gp_model._gp_seq_step
    if not run_step:
        gp_model._gp_seq_step = lambda *a, **kw: None
    try:
        if training is not None:
            m.insert_training_data(*training)
        else:
            m.insert_pointclouds([c for c, _ in scans], [o for _, o in scans],
                                 ds_resolution=cfg.resolution,
                                 free_resolution=cfg.free_resolution,
                                 max_range=cfg.max_range)
    finally:
        gp_model._gp_seq_step = step
    return m._last_step_call


def dense_block(n_dense: int = 300, half: float = 0.75, seed: int = 0):
    """Training points with ``n_dense`` of them in the large-map block
    (0, 0, 0), labels ±1: one model of the overflow tier."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-half, half, (n_dense, 3)),
                          rng.uniform(-4 * half, 4 * half, (60, 3))]).astype(np.float32)
    lab = np.where(rng.uniform(size=len(pts)) < 0.5, 1.0, -1.0).astype(np.float32)
    return pts, lab


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32's 10 mantissa bits, as a tensor-core
    operand is: the control that shows a limit fails a lower precision."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def check_k4(args, statics, what: str, reps: int = 3) -> dict:
    """K4 against its plain version on every size tier of one dispatch, into
    one pair of tables as the main path fills them.  Each tier is held on
    the rows its models serve at its tier's tolerance, beside the control:
    the plain version on TF32-rounded coordinates.  Each tier is timed
    alone; returns the kernel's tables and one result per tier."""
    all_nodes, pts, lab, tiers, centers = args[4], args[6], args[7], args[8], args[10]
    G, Vall, T = statics["G"], all_nodes.shape[0], centers.shape[0]
    kw = {k: statics[k] for k in ("sf2", "ell", "noise")}
    dev = pts.device
    gcol = torch.arange(G, device=dev)

    def tables():
        return {"acc_mean": torch.zeros((T * G, Vall), device=dev),
                "acc_var": torch.ones((T * G, Vall), device=dev),
                "present": torch.zeros(T * G, dtype=torch.bool, device=dev),
                "failed": torch.zeros(1, dtype=torch.int32, device=dev)}

    k, p, ctl = tables(), tables(), tables()
    rounded = (tf32_round(pts), lab, tf32_round(centers), tf32_round(all_nodes))
    results = []
    for st, ct, nb, hc in tiers:
        ins = (pts, lab, st, ct, nb, centers, all_nodes)
        cmax = int(hc.max())

        def kernel(_):
            gp_heavy.gp_heavy(*ins, **k, host_counts=hc, **kw)

        _, first_ms = _timed(lambda: kernel(None))
        first = {n: k[n].clone() for n in ("acc_mean", "acc_var")}
        # the control first: it also warms the plain version up for its timing
        gp_heavy.gp_heavy_plain(*rounded[:2], st, ct, nb, *rounded[2:], **ctl,
                                cmax=cmax, **kw)
        plain_ms = cuda_ms(lambda _: gp_heavy.gp_heavy_plain(*ins, **p, cmax=cmax, **kw),
                           1, warmup=0)
        nbl = nb.long()
        rows = (nbl * G + gcol)[(nbl >= 0) & (nbl < T)]
        tier_name = "base" if cmax <= gp_heavy.BASE_MAX_C else "overflow"
        tols = K4_TOL[tier_name]
        calibrated = cmax <= K4_CALIBRATED_MAX_C
        errs, need, need_ctl, bad, bad_ctl = {}, {}, {}, 0, 0
        for name, tol in zip(("acc_mean", "acc_var"), tols):
            ref = p[name][rows]
            scale = 1.0 + ref.abs()
            d = (k[name][rows] - ref).abs()
            dc = (ctl[name][rows] - ref).abs()
            errs[name] = float(d.max())
            need[name] = float((d / scale).max())
            need_ctl[name] = float((dc / scale).max())
            bad += int((d > tol * scale).sum())
            bad_ctl += int((dc > tol * scale).sum())
        finite = bool(torch.isfinite(k["acc_mean"][rows]).all()
                      and torch.isfinite(k["acc_var"][rows]).all())
        print(f"K4, {what}: {tier_name} tier, {ct.numel()} models (largest {cmax} "
              f"points), {rows.numel()} (block, slot) rows; max |kernel - plain| mean "
              f"{errs['acc_mean']:.3e}, var {errs['acc_var']:.3e}; largest |Δ|/(1+|plain|)"
              f" mean {need['acc_mean']:.3e}, var {need['acc_var']:.3e} (control, the "
              f"plain version on TF32-rounded coordinates: mean "
              f"{need_ctl['acc_mean']:.3e}, var {need_ctl['acc_var']:.3e}); limit "
              f"{tols[0]:g} (mean) / {tols[1]:g} (var) times 1+|plain|"
              + (f": {bad} elements outside, control {bad_ctl}" if calibrated else
                 f" (measured up to {K4_CALIBRATED_MAX_C} points; not applied)"))
        require(finite, f"K4 ({what}, {tier_name} tier) gave non-finite values")
        f64 = None
        if calibrated:
            require(bad == 0, f"K4 disagrees with its plain version ({what}, "
                              f"{tier_name} tier)")
            require(bad_ctl > 0, f"the K4 limit passes the TF32 control ({what}, "
                                 f"{tier_name} tier)")
        else:
            f64 = k4_vs_f64(ins, cmax, kw, rows, k, p, ctl, G, Vall, T, what)
        event_ms = cuda_ms(kernel, reps, warmup=0)
        ms = launch_ms([kernel], reps)
        # the same rows of every table after 2 * reps more launches: the
        # summation order is fixed, so bit for bit
        repeat = all(bool(torch.equal(k[n][rows], first[n][rows])) for n in first)
        served = gp_heavy.served_rows(nb.cpu().numpy(), T)
        flops = gp_heavy.flops(hc, served, Vall)
        b_ms, b_by = bound(flops, nbytes(*ins) + rows.numel() * Vall * 8 + T * G)
        print(f"K4, {what}, {tier_name} tier: {ms:.3f} ms device time (event window "
              f"{event_ms:.3f} ms, first launch {first_ms:.3f} ms; plain {plain_ms:.3f} ms, "
              f"bound {b_ms:.4f} ms by {b_by} = {100 * b_ms / ms:.2f}% of the time; "
              f"{flops:.4g} operations on {int(served.sum())} served rows); "
              f"{2 * reps} more launches bit-equal {repeat}")
        require(repeat, f"K4 ({what}, {tier_name} tier): launches on the same inputs "
                        "differ")
        results.append({"tier": tier_name, "models": int(ct.numel()), "cmax": int(cmax),
                        "max_abs_err": max(errs.values()), "rel_err": need,
                        "rel_err_control": need_ctl, "ms": ms, "event_ms": event_ms,
                        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                        **({"vs_f64": f64} if f64 else {})})
    torch.cuda.synchronize()
    failed, failed_p = int(k["failed"]), int(p["failed"])
    same_present = bool(torch.equal(k["present"], p["present"]))
    print(f"K4, {what}: present equal {same_present}; failed factorisations {failed} "
          f"(plain {failed_p})")
    require(same_present and failed == 0 and failed_p == 0,
            f"K4 ({what}): present differs or a factorisation failed")
    return {"tables": k, "tiers": results, "failed": failed}


def check_k5(args, statics, tables, what: str, timed: bool = True,
             reps: int = 5) -> dict:
    """K5 against its plain version on one dispatch's tables and pool, scan
    by scan: each scan starts both versions from the plain pool.  Timed
    (kernel, event window, plain) only if ``timed``."""
    pool0, node_idx, slots, ss, sc = args[:4], args[5], args[9], args[11], args[12]
    am, av, pr = tables["acc_mean"], tables["acc_var"], tables["present"]
    kw = {k: statics[k] for k in ("G", "sf2", "min_known_ivar", "max_ivar", "n",
                                  "max_level", "state_fn", "do_prune")}
    sf = statics["state_fn"]
    p = [x.clone() for x in pool0]
    n_near = n_blocks_excused = bad = 0
    max_err = 0.0
    for s, c in zip(ss, sc):
        k = [x.clone() for x in p]
        pre = [x.clone() for x in p]
        gp_light.gp_light(am, av, pr, *k, node_idx, slots, s, c, **kw)
        gp_light.gp_light_plain(am, av, pr, *pre, node_idx, slots, s, c,
                                **{**kw, "do_prune": False})
        gp_light.gp_light_plain(am, av, pr, *p, node_idx, slots, s, c, **kw)
        sl = slots[s:s + c].long()
        prob = posterior.gp_prob(pre[0][sl], sf.l, sf.max_ivar)
        near = (((prob - sf.free_thresh).abs() <= STATE_MARGIN)
                | ((prob - sf.occupied_thresh).abs() <= STATE_MARGIN)
                | ((pre[1][sl] - sf.min_known_ivar).abs()
                   <= STATE_MARGIN * sf.min_known_ivar)) & pre[2][sl]
        calm = ~near.any(dim=1)
        n_near += int(near.sum())
        n_blocks_excused += int((~calm).sum())
        rows = sl[calm]
        for x, y in zip(k[:2], p[:2]):
            d = (x[rows] - y[rows]).abs()
            max_err = max(max_err, float(d.max()) if d.numel() else 0.0)
            bad += int((d != 0).sum())
        bad += int((k[2][rows] != p[2][rows]).sum() + (k[3][rows] != p[3][rows]).sum())
    torch.cuda.synchronize()
    V = pool0[0].shape[1]
    levels = [int((p[3][slots.long()] == L).sum()) for L in range(kw["max_level"] + 1)]
    print(f"K5, {what}: {len(ss)} scans, {int(sum(sc))} blocks of {V} voxels; max "
          f"|m_ivar/ivar kernel - plain| "
          f"= {max_err:.3e}, {bad} voxels with m_ivar, ivar, eff or touched not bit-equal "
          f"(blocks not excused); {n_near} voxels near a threshold or the chop, {n_blocks_excused} "
          f"blocks excused; voxels by eff level {levels}")
    require(bad == 0, f"K5 disagrees with its plain version ({what})")
    checked = {"max_abs_err": max_err, "near_threshold_voxels": n_near,
               "blocks_excused": n_blocks_excused, "levels": levels}
    if not timed:
        return checked

    def pool():
        return [x.clone() for x in pool0]

    def run(fn, st):
        for s, c in zip(ss, sc):
            fn(am, av, pr, *st, node_idx, slots, s, c, **kw)
        return st

    event_ms = cuda_ms(lambda st: run(gp_light.gp_light, st), reps, setup=pool)
    count = len(ss)
    ms = launch_ms([lambda st, s=s, c=c: gp_light.gp_light(am, av, pr, *st, node_idx, slots,
                                                           s, c, **kw)
                    for s, c in zip(ss, sc)], reps, setup=pool)
    plain_ms = cuda_ms(lambda st: run(gp_light.gp_light_plain, st), 2, setup=pool)
    G, blocks = statics["G"], int(sum(sc))
    # per block: each voxel's (mean, var) at its node of each present slot
    # (the kernel loads no absent slot's), the G present flags, the pool row
    # (m_ivar, ivar f32; touched, eff 1 byte) read and written, its slot
    rows = torch.cat([torch.arange(s, s + c) for s, c in zip(ss, sc)]).to(slots.device)
    live = slots[rows] < pool0[0].shape[0]
    present = int(pr.view(-1, G)[rows[live]].sum())
    need = (V * present * 8 + int(live.sum()) * (G + 2 * V * (4 + 4 + 1 + 1))
            + blocks * 4 + nbytes(node_idx))
    b_ms, b_by = bound(0, need)
    per_block = V * G * 8 + G + 2 * V * (4 + 4 + 1 + 1) + 4
    b_all_ms, _ = bound(0, blocks * per_block + nbytes(node_idx))
    print(f"K5, {what}: {ms:.4f} ms device time over {count} launches "
          f"({1e3 * ms / count:.2f} us each; event window {event_ms:.3f} ms); plain "
          f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by} ({present} present slots of "
          f"{int(live.sum()) * G}; every slot's: {b_all_ms:.4f} ms)")
    return {**checked, "ms": ms, "event_ms": event_ms, "ms_per_launch": ms / count,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bound_ms_every_slot": b_all_ms, "present_slots": present}


def gp_static(c, pcd_dir: str, n_scans: int, overflow: bool | None = None) -> dict:
    """GP run_static on ``n_scans`` scans: K4 launched once per (dispatch,
    size tier) the map built (with ``overflow``, more or no more often than
    once per dispatch: an overflow tier is or is not required), K5 once per
    scan, no failed factorisation, finite leaves, occupied and free ones."""
    ds = DatasetConfig(name="synth", dir=pcd_dir, prefix="synth", scan_num=n_scans,
                       max_range=c.max_range)
    reset_counts()
    res = pipeline.run_static(c, ds)
    k4, k5 = gp_heavy.launches, gp_light.launches
    m = res.map
    want4 = m.stats["heavy_tiers"]
    dispatches = -(-n_scans // GPOctoMap.SCAN_BATCH)
    failed = int(m.failed_models)
    ex = pipeline.export_leaves(m, original_size=c.original_size)
    leaves = ex["all"]
    n_occ, n_free = len(ex["occupied"]["x"]), len(ex["free"]["x"])
    n_pruned = int((m.pool.eff_level > 0).sum())
    print(f"GP run_static {n_scans} scans (block_depth {c.block_depth}"
          f"{', large map' if c.original_size else ', demo'}): "
          f"{res.scans_per_second:.2f} scans/s ({res.total_seconds:.3f} s), "
          f"{m.pool.n_blocks} blocks, {int(m.pool.touched.sum())} touched voxels, "
          f"{n_pruned} pruned, {n_occ} occupied / {n_free} free leaves, "
          f"{failed} failed factorisations; launches K4 {k4} (expected {want4}) "
          f"K5 {k5}")
    tiers_ok = {None: want4 >= dispatches, True: want4 > dispatches,
                False: want4 == dispatches}[overflow]
    require(k4 == want4 and tiers_ok,
            f"K4 launched {k4} times for {want4} (dispatch, tier) pairs over "
            f"{dispatches} dispatches")
    require(k5 == n_scans, f"K5 launched {k5} times, expected {n_scans}")
    require(failed == 0, "a GP factorisation failed on real scans")
    require(n_occ > 0 and n_free > 0, "no occupied or no free leaves")
    require(all(np.isfinite(leaves[k]).all() for k in ("prob", "var", "x")),
            "non-finite leaves")
    return {"scans_per_s": res.scans_per_second, "seconds": res.total_seconds,
            "launches": {"gp_heavy": k4, "gp_light": k5}, "pruned_voxels": n_pruned}


def main_path_gp(cfg, cfg_large, pcd_dir: str, scans) -> dict:
    """GP: run_static on 12 and 60 demo scans and 12 large-map scans (the
    large map's dispatch holds an overflow tier), then OnlineIntegrator on
    12 demo scans."""
    out = {"static12": gp_static(cfg, pcd_dir, 12), "static60": gp_static(cfg, pcd_dir, 60),
           "large12": gp_static(cfg_large, pcd_dir, 12, overflow=True)}

    m = GPOctoMap(cfg)
    online = pipeline.OnlineIntegrator(m)
    lat = []
    reset_counts()
    for cloud, origin in scans[:12]:
        t0 = time.perf_counter()
        online.offer(cloud, origin)
        m.synchronize()
        lat.append(time.perf_counter() - t0)
    k4, k5 = gp_heavy.launches, gp_light.launches
    want4 = m.stats["heavy_tiers"]
    med = float(np.median(lat)) * 1e3
    print(f"GP OnlineIntegrator 12 scans: {online.n_integrated} integrated, median "
          f"latency {med:.2f} ms (min {min(lat) * 1e3:.2f}, max "
          f"{max(lat) * 1e3:.2f}); launches K4 {k4} (expected {want4}) K5 {k5}")
    require(online.n_integrated == 12 and k5 == 12 and k4 == want4 >= 12,
            "online launches do not match the integrated scans")
    out["online12"] = {"median_ms": med, "integrated": online.n_integrated,
                       "launches": {"gp_heavy": k4, "gp_light": k5}}
    return out


#: card vs CPU on the GP map: |Δ| ≤ ABS + REL·|CPU| on m_ivar and ivar.  At
#: ABS 5e-2 (the JAX package's one-scan GP tolerance against its oracle) the
#: card's map needs REL 1.4e-3 and the TF32 control 110 (PERF.md)
GP_CPU_TOL = (5e-2, 5e-3)


def tf32_k1(entries, labels, ids, gslot, row_block, row_start, row_count, centers,
            all_nodes, **kw):
    """The control's K1: its plain version on TF32-rounded coordinates."""
    return bgk_heavy.bgk_heavy_plain(tf32_round(entries), labels, ids, gslot, row_block,
                                     row_start, row_count, tf32_round(centers),
                                     tf32_round(all_nodes), **kw)


def tf32_k1p(ent_rel, labels, ustart, ucount, tb_u, ext, **kw):
    """The control's K1′: its plain version on TF32-rounded coordinates."""
    return bgk_aligned_heavy.bgk_aligned_heavy_plain(tf32_round(ent_rel), labels, ustart,
                                                     ucount, tb_u, tf32_round(ext), **kw)


def tf32_heavy(pts, lab, st, ct, nb, centers, all_nodes, *rest, host_counts,
               **kw) -> None:
    """The control's heavy pass: K4's plain version on TF32-rounded
    coordinates."""
    gp_heavy.gp_heavy_plain(tf32_round(pts), lab, st, ct, nb, tf32_round(centers),
                            tf32_round(all_nodes), *rest, cmax=int(host_counts.max()), **kw)


def f64_heavy(pts, lab, st, ct, nb, centers, all_nodes, acc_mean, acc_var, *rest,
              host_counts, **kw) -> None:
    """The reference map's heavy pass: K4's plain version in f64, rounded
    once into the f32 tables."""
    m64, v64 = acc_mean.double(), acc_var.double()
    gp_heavy.gp_heavy_plain(pts.double(), lab.double(), st, ct, nb, centers.double(),
                            all_nodes.double(), m64, v64, *rest,
                            cmax=int(host_counts.max()), **kw)
    acc_mean.copy_(m64)
    acc_var.copy_(v64)


def card_vs_cpu_gp(cfg, pcd_dir: str, n_scans: int = 3, f64_ref: bool = False) -> dict:
    """The first ``n_scans`` scans on the card and on the CPU, voxel by voxel:
    m_ivar/ivar within GP_CPU_TOL (f32 factors in another rounding order,
    amplified by the BCM weights 1/σ²), touched equal, state equal except
    where either p lies within 1e-3 of a threshold or ivar within
    1e-3·min_known_ivar of the chop, eff equal in blocks without such a
    voxel.  The control, the card's map with the heavy pass on TF32-rounded
    coordinates (:func:`tf32_heavy`), is held to the same limit.  With
    ``f64_ref`` (models far larger than GP_CPU_TOL was measured on, whose
    f32 factors on the CPU part from f64 by more than it) the m_ivar/ivar
    limit is held against the map whose heavy pass runs in f64
    (:func:`f64_heavy`) in place of the CPU's map, for the card and the
    control; the CPU's own deviation from it and the card-vs-CPU ratio are
    printed.  Returns the largest deviation over the limit, for the card and
    for the control."""
    ds = DatasetConfig(name="synth", dir=pcd_dir, prefix="synth", scan_num=n_scans,
                       max_range=cfg.max_range)
    gpu = pipeline.run_static(cfg, ds, device="cuda").map
    kernel = gp_heavy.gp_heavy
    gp_heavy.gp_heavy = tf32_heavy
    try:
        ctl = pipeline.run_static(cfg, ds, device="cuda").map
        if f64_ref:
            gp_heavy.gp_heavy = f64_heavy
            ref = pipeline.run_static(cfg, ds, device="cuda").map
    finally:
        gp_heavy.gp_heavy = kernel
    # on all CPU threads: the tolerance is far above a sum-order change
    cpu = pipeline.run_static(cfg, ds, device="cpu").map
    nb = gpu.pool.n_blocks
    require(nb == cpu.pool.n_blocks == ctl.pool.n_blocks and np.array_equal(
        gpu.pool.coords[:nb], cpu.pool.coords[:nb]), "block sets differ")
    rows = np.arange(nb)
    g = {k: gpu._gather_rows(v, rows) for k, v in gpu.pool.fields.items()}
    c = {k: cpu._gather_rows(v, rows) for k, v in cpu.pool.fields.items()}
    x = {k: ctl._gather_rows(v, rows) for k, v in ctl.pool.fields.items()}
    t_g = gpu._gather_rows(gpu.pool.touched, rows)
    t_c = cpu._gather_rows(cpu.pool.touched, rows)
    dev = {k: float(np.abs(g[k] - c[k]).max()) for k in g}
    tol_a, tol_r = GP_CPU_TOL

    def ratio(f, base=c, a=tol_a, r=tol_r):
        return max(float((np.abs(f[k] - base[k]) / (a + r * np.abs(base[k]))).max())
                   for k in base)

    def rel_need(f, a):
        """The least REL that passes f at ABS = a."""
        with np.errstate(divide="ignore", invalid="ignore"):
            return max(float(np.where(np.abs(f[k] - c[k]) > a,
                                      (np.abs(f[k] - c[k]) - a) / np.abs(c[k]), 0).max())
                       for k in c)

    def near(m, f):
        post = m._posterior({**f, "touched": np.ones_like(f["ivar"], bool)})
        return ((np.abs(post["prob"] - cfg.free_thresh) <= 1e-3)
                | (np.abs(post["prob"] - cfg.occupied_thresh) <= 1e-3)
                | (np.abs(f["ivar"] - m.min_known_ivar) <= 1e-3 * m.min_known_ivar))

    excused = t_c & (near(gpu, g) | near(cpu, c))
    s_g = gpu._posterior({**g, "touched": t_g})["state"]
    s_c = cpu._posterior({**c, "touched": t_c})["state"]
    calm = ~excused.any(axis=1)
    eff_g = gpu._gather_rows(gpu.pool.eff_level, rows)
    eff_c = cpu._gather_rows(cpu.pool.eff_level, rows)
    n_state = int(((s_g != s_c) & ~excused).sum())
    n_eff = int((eff_g[calm] != eff_c[calm]).sum())
    out = {"ratio": ratio(g), "ratio_control": ratio(x)}
    msg = ""
    if f64_ref:
        require(ref.pool.n_blocks == nb, "the f64 map's block set differs")
        r64 = {k: ref._gather_rows(v, rows) for k, v in ref.pool.fields.items()}
        out["vs_f64"] = {who: ratio(f, r64) for who, f in (("card", g), ("cpu", c),
                                                            ("control", x))}
        v = out["vs_f64"]
        msg = (f"; against the map with f64 factors, largest deviation / ({tol_a:g} + "
               f"{tol_r:g}*|f64|): card {v['card']:.3f}, CPU {v['cpu']:.3f}, control "
               f"{v['control']:.3f}")
    needs = {f"{a:g}": (rel_need(g, a), rel_need(x, a)) for a in (1e-2, 2e-2, 5e-2)}
    print(f"card vs CPU, gp (block_depth {cfg.block_depth}) {n_scans} scans (device "
          f"ingest {cfg.device_ingest}): {nb} blocks, "
          f"max |m_ivar| deviation "
          f"{dev['m_ivar']:.3e}, max |ivar| deviation {dev['ivar']:.3e}, largest "
          f"deviation / ({tol_a:g} + {tol_r:g}*|CPU|) = {out['ratio']:.3f} (control, "
          f"the heavy pass on TF32-rounded coordinates: {out['ratio_control']:.3f}); "
          f"least REL that passes at ABS = " + ", ".join(
              f"{a}: {n[0]:.3e} (control {n[1]:.3e})" for a, n in needs.items())
          + f"; touched equal {bool(np.array_equal(t_g, t_c))}; {int(excused.sum())} "
          f"voxels near a threshold ({int((~calm).sum())} blocks); state differs at "
          f"{n_state} other voxels, eff at {n_eff} voxels of the other blocks{msg}")
    if f64_ref:
        v = out["vs_f64"]
        require(v["card"] <= 1.0, f"the card's GP map differs from the f64 map beyond "
                                  f"{tol_a:g} + {tol_r:g}*|f64|")
        require(v["control"] > 1.0, "the f64-map limit passes the TF32 control")
    else:
        require(out["ratio"] <= 1.0,
                f"card and CPU GP maps differ beyond {tol_a:g} + {tol_r:g}*|CPU|")
    require(out["ratio_control"] > 1.0, "the card-vs-CPU limit passes the TF32 control")
    require(np.array_equal(t_g, t_c) and n_state == 0 and n_eff == 0,
            "touched, state or eff differ away from the thresholds")
    return out



# ---------------------------------------------------- device-ingest phases

#: the device-ingest kernels: label → (wrapper module, wrapper name); K7a is
#: two launches a dispatch (the raw points, then the beams)
INGEST_WRAPPERS = {
    "ingest_points": (ingest_beams, "point_keys"),
    "ingest_beams": (ingest_beams, "beam_samples"),
    "ingest_downsample": (ingest_downsample, "centroids"),
    "ingest_members": (ingest_members, "memberships"),
    "ingest_rays": (ingest_rays, "ray_pairs"),
    "ingest_sort": (ingest_sort, "sort_runs"),
    "ingest_bucket": (ingest_bucket, "bucket"),
    "bgk_aligned_heavy": (bgk_aligned_heavy, "bgk_aligned_heavy"),
    "ingest_slots_world": (ingest_slots, "world_keys"),
    "ingest_slots_sort": (ingest_slots, "sort_world"),
    "ingest_slots_gather": (ingest_slots, "gather"),
}
#: f32 relative spacing: K7b's limit is one ulp of the plain centroid
F32_EPS = 2.0 ** -23


def record_ingest(cfg, scans) -> dict:
    """Insert ``scans`` (one dispatch) into a map of ``cfg`` on the card and
    record every device-ingest kernel call: label → [(args, kwargs, out)],
    the tensor arguments copied."""
    calls = {k: [] for k in INGEST_WRAPPERS}
    saved = {}
    for label, (mod, name) in INGEST_WRAPPERS.items():
        orig = saved[label] = getattr(mod, name)

        def rec(*a, _orig=orig, _label=label, **kw):
            args = tuple(x.clone() if torch.is_tensor(x) else x for x in a)
            out = _orig(*a, **kw)
            calls[_label].append((args, kw, out))
            return out

        setattr(mod, name, rec)
    try:
        m = pipeline.MAP_CLASSES[cfg.method](cfg, device="cuda")
        require(m._ingest_enabled(), "device ingest is off on a CUDA map")
        m.insert_pointclouds([c for c, _ in scans], [o for _, o in scans],
                             ds_resolution=cfg.resolution,
                             free_resolution=cfg.free_resolution, max_range=cfg.max_range)
        torch.cuda.synchronize()
    finally:
        for label, (mod, name) in INGEST_WRAPPERS.items():
            setattr(mod, name, saved[label])
    return calls


def _timed(fn) -> tuple[object, float]:
    """fn()'s result and its device time (ms) by one CUDA event pair."""
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


def check_k7(calls, what: str, reps: int = 5) -> dict:
    """K7a, K7b, K7c, K7s and K7t against their plain versions on one
    dispatch's recorded calls: integer tables (keys, in-range flags) equal;
    K7a's sample coordinates equal (control: the samples in f64 must
    differ); K7b as :func:`check_k7b`, K7s as :func:`check_k7s`, K7t as
    :func:`check_k7t`."""
    SENT = ingest_keys.SENT
    (pa, pkw, pout), = calls["ingest_points"]
    (ba, bkw, bout), = calls["ingest_beams"]
    (ma, mkw, mout), = calls["ingest_members"]
    require(len(calls["ingest_downsample"]) == 2, "K7b did not run twice (hits, frees)")
    out = {}

    # K7a: the raw points' keys; the beam samples that exist, in the dense
    # layout's order, and their count, against the dense layout's kept rows
    pref, pplain_ms = _timed(lambda: ingest_beams.point_keys_plain(*pa, **pkw))
    bref, bplain_ms = _timed(lambda: ingest_beams.compact_beam_samples_plain(*ba, **bkw))
    dense = ingest_beams.beam_samples_plain(*ba, **bkw)
    keep = dense[1] != SENT
    n = int(bout[3])
    ctl = ingest_beams.beam_samples_plain(ba[0].double(), ba[1], ba[2].double(), ba[3],
                                          **bkw)[0].float()[keep]
    err = float((bout[0][:n] - bref[0]).abs().max())
    err_ctl = float((ctl - bref[0]).abs().max())
    n_ctl = int(((ctl - bref[0]) != 0).any(1).sum())
    same = (torch.equal(pout, pref), n == int(bref[3]) == int(keep.sum()),
            torch.equal(bout[1][:n], bref[1]), torch.equal(bout[2], bref[2]))
    N, R, S = pa[0].shape[0], ba[0].shape[0], bkw["kf"] + 2
    print(f"K7a, {what}: {N} raw points, {R} hit voxels x {S} slots, {n} samples kept "
          f"({n / (R * S):.1%} of the slots); point keys, the count, sample keys, in-range "
          f"flags equal to the plain version {same}; max |sample kernel - plain| = "
          f"{err:.3e} (limit 0; control, the samples in f64: {err_ctl:.3e} at {n_ctl} "
          f"samples)")
    require(all(same), f"K7a disagrees with its plain version ({what})")
    require(err == 0.0, f"K7a samples differ from the plain version ({what})")
    require(err_ctl > 0.0, f"the K7a limit passes the f64 control ({what})")
    launches = [lambda _: ingest_beams.point_keys(*pa, **pkw),
                lambda _: ingest_beams.beam_samples(*ba, **bkw)]
    ms = launch_ms(launches, reps)
    ms_points, ms_beams = (launch_ms([f], reps) for f in launches)
    # each input read once, each output written once: the raw points (12 + 4
    # bytes in, a key out), the hits (12 + 8 in, the flag out), the kept
    # samples (12 + 8 out) and the count; about 20 operations a point or a
    # sample, 40 a hit.  The dense layout's bound writes every slot.
    points = nbytes(*pa) + nbytes(pout)
    b_ms, b_by = bound(20 * (N + n) + 40 * R, points + nbytes(*ba) + R + 20 * n + 4)
    bd_ms, _ = bound(20 * (N + R * S), points + nbytes(*ba[:2]) + R * S * 20 + R)
    out["ingest_beams"] = {"max_abs_err": err, "control_err": err_ctl, "ms": ms,
                           "ms_points": ms_points, "ms_beams": ms_beams,
                           "plain_ms": pplain_ms + bplain_ms, "bound_ms": b_ms,
                           "bound_by": b_by, "bound_ms_dense": bd_ms, "samples": n,
                           "slots": R * S}
    print(f"K7a, {what}: {ms:.4f} ms device time for its 2 launches (alone: the raw points "
          f"{ms_points:.4f}, the beams {ms_beams:.4f}; plain {pplain_ms + bplain_ms:.3f} ms), "
          f"bound {b_ms:.4f} ms by {b_by} on the samples kept (the dense layout's, every "
          f"slot written: {bd_ms:.4f} ms)")

    out["ingest_downsample"] = check_k7b(calls, what, reps)

    out["ingest_members"] = check_k7c(calls, what, reps)
    out["ingest_sort"] = check_k7s(calls, what, reps)
    (keys, window), _, _ = calls["ingest_sort"][0]
    out["ingest_sort"]["fixed_cost"] = k7s_fixed_cost(keys, window, reps)
    out["ingest_bucket"] = check_k7t(calls, what, out["ingest_sort"], reps)
    # the membership sort (the third of the point family's four) beside K7c
    mem = out["ingest_sort"]["sorts"][2]
    out["ingest_members"].update(membership_sort_ms=mem["ms"],
                                 with_membership_sort_ms=out["ingest_members"]["ms"]
                                 + mem["ms"])
    print(f"K7c + the membership sort, {what}: {out['ingest_members']['ms']:.4f} + "
          f"{mem['ms']:.4f} = {out['ingest_members']['with_membership_sort_ms']:.4f} ms "
          f"device time")
    return out


def check_k7w(calls, what: str, reps: int = 5) -> dict:
    """K7w on one dispatch's recorded calls (the slot resolution of a fresh
    map's first dispatch): the world keys and scan counts, the world-key
    sort (K7s with ``want_rid``) and the gather (GP: with centres) bit-equal
    to their plain versions on the same card inputs; and the resolution the
    host's: the distinct blocks np.unique's of the packed test-block
    coordinates in its order, the slots uslots[inverse], the counts
    bincount's, the centres block_center's.  Control: the gather from D
    slots with two swapped must fail that check.  Times: ``ms`` K7w's two
    launches behind a spin, ``ms_with_sort`` with the world-key sort's
    launches between them, ``ms_sort_gather`` the sort and the gather;
    ``library_ms`` torch.unique(world keys, return_inverse=True) and the
    slots' index (GP: and the centres from the distinct keys) with their
    sync, equal to the gather's slots, beside ``ms_sort_gather``;
    ``plain_ms`` the two plain versions.  Bound: every input read once,
    every output written once (the keys, anchors, sort index, runs, the D
    slots and, GP, the D run keys in; world keys, counts, slots and centres
    out)."""
    (wa, wkw, (wkey, count)), = calls["ingest_slots_world"]
    (sa, skw, (perm, ukey, rid, status)), = calls["ingest_slots_sort"]
    (ga, gkw, (slots, ctr)), = calls["ingest_slots_gather"]
    tkey, anchors, base, K = wa
    window, T = sa[1], tkey.shape[0]
    V, D, flag, _ = status.tolist()
    ref_w = ingest_slots.world_keys_plain(*wa, **wkw)
    runs = ingest_sort.sort_runs_plain(wkey, window, want_rid=True)
    ref_g = ingest_slots.gather_plain(*ga, **gkw)
    same = {"world_keys": torch.equal(wkey, ref_w[0]), "counts": torch.equal(count, ref_w[1]),
            "sort": (V, D, flag) == (T, runs.ukey.shape[0], 0)
            and torch.equal(perm[:V], runs.perm) and torch.equal(rid[:V], runs.rid)
            and torch.equal(ukey[:D], runs.ukey),
            "slots": torch.equal(slots, ref_g[0]),
            "centres": (ctr is None) == (ref_g[1] is None)
            and (ctr is None or torch.equal(ctr, ref_g[1]))}
    require(all(same.values()), f"K7w disagrees with its plain versions ({what}): {same}")
    uslots, bs = ga[2], gkw.get("block_size")
    tscan, coords = ingest_keys.unpack_np(tkey.cpu().numpy(), anchors.cpu().numpy())
    uniq, inv = np.unique(geo.pack_key(coords), return_inverse=True)
    want_slots = uslots.cpu().numpy()[inv.reshape(-1)]
    host = {"blocks": np.array_equal(
                ingest_slots.unpack_world_np(ukey[:D].cpu().numpy(), base),
                geo.unpack_key(uniq)),
            "slots": np.array_equal(slots.cpu().numpy(), want_slots),
            "counts": np.array_equal(count.cpu().numpy(), np.bincount(tscan, minlength=K)),
            "centres": ctr is None or np.array_equal(ctr.cpu().numpy(),
                                                     geo.block_center(coords, bs))}
    require(all(host.values()), f"K7w's resolution is not the host's ({what}): {host}")
    swapped = uslots.clone()
    swapped[[0, 1]] = swapped[[1, 0]]
    ctl = ingest_slots.gather(ga[0], ga[1], swapped, *ga[3:], **gkw)[0]
    ctl_fails = not np.array_equal(ctl.cpu().numpy(), want_slots)
    require(ctl_fails, f"the K7w check passes two swapped slots ({what})")

    def world(_):
        ingest_slots.world_keys(*wa, **wkw)

    def sort(_):
        ingest_slots.sort_world(wkey, window)

    def gather(_):
        ingest_slots.gather(*ga, **gkw)

    ms = launch_ms([world, gather], reps)
    ms_world, ms_gather = launch_ms([world], reps), launch_ms([gather], reps)
    ms_with_sort = launch_ms([world, sort, gather], reps)
    ms_sort_gather = launch_ms([sort, gather], reps)
    _, plain_ms = _timed(lambda: (ingest_slots.world_keys_plain(*wa, **wkw),
                                  ingest_slots.gather_plain(*ga, **gkw)))
    b = torch.as_tensor(np.asarray(base, np.int64), device=wkey.device)

    def library():
        u, i = torch.unique(wkey, return_inverse=True)
        s = uslots[i]
        if bs is not None:
            f = torch.stack([(u >> 32) & 0xFFFF, (u >> 16) & 0xFFFF, u & 0xFFFF], -1)
            c = ((f - ingest_keys.FIELD_BIAS + b).double() * float(np.float32(bs))).float()[i]
            return s, c
        return s, None

    lib = library()
    require(torch.equal(lib[0], slots) and (ctr is None or torch.equal(lib[1], ctr)),
            f"torch.unique's resolution differs from K7w's ({what})")
    lib_ms = cuda_ms(lambda _: library(), reps)
    nbyte = (8 * T + 12 * K + 8 * T + 4 * K                    # world: tkey, anchors in; out
             + 8 * T + 4 * T + 4 * D + 4 * T                   # gather: perm, rid, uslots; slots
             + (8 * D + 12 * T if ctr is not None else 0))     # GP: run keys in, centres out
    b_ms, b_by = bound(0, nbyte)
    print(f"K7w, {what}: T {T} test blocks, D {D} distinct ({D / T:.1%}), K {K} scans; world "
          f"keys, counts, sort, slots{', centres' if ctr is not None else ''} bit-equal to the "
          f"plain versions {same}; the host's resolution {host}; control (two slots swapped) "
          f"fails {ctl_fails}; {ms:.4f} ms device time for its 2 launches (world {ms_world:.4f}, "
          f"gather {ms_gather:.4f}; with the world-key sort {ms_with_sort:.4f}; sort + gather "
          f"{ms_sort_gather:.4f}, torch.unique + index {lib_ms:.4f} with its sync), plain "
          f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}")
    return {"max_abs_err": 0.0, "bit_equal": True, "host_equal": True,
            "control_fails": ctl_fails, "ms": ms, "ms_world": ms_world, "ms_gather": ms_gather,
            "ms_with_sort": ms_with_sort, "ms_sort_gather": ms_sort_gather,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
            "T": T, "D": D, "K": K, "centres": ctr is not None}


def check_k7c(calls, what: str, reps: int = 5) -> dict:
    """K7c on one dispatch's recorded call against its plain version: the
    compact layout's keys and rows on the first M rows and M itself (the
    point family), or the dense layout's keys and rows (BGKL's hits).
    Bounds: the bytes the data needs (the entries read, the M keys and rows
    written) and, beside it, the dense layout's (8 keys an entry written)."""
    (ma, mkw, (keys, rows, count)), = calls["ingest_members"]
    dense = mkw.get("dense", False)
    E = ma[0].shape[0]
    bs = mkw["block_size"]
    dref = ingest_members.memberships_plain(*ma, block_size=bs)
    if dense:
        _, m_plain = _timed(lambda: ingest_members.memberships_plain(*ma, block_size=bs))
        same = {"keys": torch.equal(keys, dref),
                "rows": torch.equal(rows, torch.arange(8 * E, dtype=torch.int32,
                                                       device=rows.device) // 8)}
        M = int((dref != ingest_keys.SENT).sum())
    else:
        ref, m_plain = _timed(lambda: ingest_members.compact_memberships_plain(
            *ma, block_size=bs))
        M = int(count.item())
        same = {"count": M == ref[0].shape[0],
                "keys": torch.equal(keys[:M], ref[0]),
                "rows": torch.equal(rows[:M], ref[1]),
                "keys_are_the_dense_ones": torch.equal(
                    keys[:M], dref[dref != ingest_keys.SENT])}
    print(f"K7c, {what}: {E} entries, {M} memberships of {8 * E} slots "
          f"({'dense' if dense else 'compact'} layout); equal to the plain version {same}")
    require(all(same.values()), f"K7c disagrees with its plain version ({what}): {same}")
    ms = launch_ms([lambda _: ingest_members.memberships(*ma, **mkw)], reps)
    ent_bytes = nbytes(*ma)
    b_dense, b_by = bound(40 * E, ent_bytes + 8 * 8 * E)
    b_need, b_by = bound(40 * E, ent_bytes + (8 * 8 * E + 4 * 8 * E if dense
                                              else 12 * M + 4))
    print(f"K7c, {what}: {ms:.4f} ms device time (plain {m_plain:.3f} ms), bound "
          f"{b_need:.4f} ms by {b_by} (the bytes the data needs: "
          f"{ent_bytes} of entries, {'8E' if dense else 'M'} keys and rows); the dense "
          f"layout's keys: {b_dense:.4f} ms")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": m_plain, "bound_ms": b_need,
            "bound_by": b_by, "bound_ms_dense_layout": b_dense, "entries": E,
            "memberships": M, "layout": "dense" if dense else "compact"}


def check_k7b(calls, what: str, reps: int = 5) -> dict:
    """K7b on one dispatch's recorded calls (the hit and the free downsample;
    BGKL: the hits): bit-equal to its plain version (control: each run
    summed in reverse order must differ), and so within one ulp, |Δ| ≤
    2^-23·(|plain| + leaf) (control, where the free samples' runs are: the
    uncompensated mean must fail that limit); its runs above the warp
    threshold counted."""
    ds_calls = calls["ingest_downsample"]
    err = worst = 0.0
    bad = bad_ctl = n_rev = 0
    plain_ms = 0.0
    nbyte = 0
    pts_total = longest = warp_runs = 0
    same = []
    for a, kw, cent in ds_calls:
        ref, t_ms = _timed(lambda a=a, kw=kw: ingest_downsample.centroids_plain(*a, **kw))
        plain_ms += t_ms
        pts, perm, starts, counts, run_keys, _ = a
        same.append(bool(torch.equal(cent, ref)))
        lim = F32_EPS * (ref.abs() + kw["leaf"])
        d = (cent - ref).abs()
        rid = torch.repeat_interleave(torch.arange(len(counts), device=pts.device), counts)
        n_in = int(counts.sum())
        naive = torch.zeros_like(ref).index_add_(0, rid, pts[perm[:n_in]]) \
            / counts.to(torch.float32)[:, None]
        dc = (naive - ref).abs()
        st, n = starts[rid], counts[rid]
        rev = perm[2 * st + n - 1 - torch.arange(n_in, device=pts.device)]
        n_rev += int((ingest_downsample.centroids_plain(pts, rev, *a[2:], **kw) != ref).sum())
        err, worst = max(err, float(d.max())), max(worst, float((d / lim).max()))
        bad += int((d > lim).sum())
        bad_ctl += int((dc > lim).sum())
        pts_total += n_in
        longest = max(longest, int(counts.max()))
        warp_runs += int((counts > ingest_downsample.LONG_RUN).sum())
        nbyte += n_in * (12 + 8) + nbytes(starts, counts, run_keys, cent)
    print(f"K7b, {what}: {[len(c[2]) for c in ds_calls]} voxels from {pts_total} points, "
          f"the longest run {longest} members, {warp_runs} runs above "
          f"{ingest_downsample.LONG_RUN} taken by a warp; bit-equal to the plain version "
          f"{same} (control, each run summed in reverse order: {n_rev} coordinates differ), "
          f"max |kernel - plain| = {err:.3e}, {bad} coordinates outside 2^-23*(|plain| + "
          f"leaf) (largest ratio {worst:.3f}); control, the uncompensated mean: {bad_ctl} "
          f"outside")
    require(bad == 0 and all(same), f"K7b disagrees with its plain version ({what})")
    require(n_rev > 0, f"the K7b bit-equality passes the reverse-order control ({what})")
    require(bad_ctl > 0 or len(ds_calls) == 1,
            f"the K7b limit passes the uncompensated control ({what})")
    ms = launch_ms([lambda _, a=a, kw=kw: ingest_downsample.centroids(*a, **kw)
                    for a, kw, _ in ds_calls], reps)
    b_ms, b_by = bound(6 * pts_total, nbyte)
    # the other design: K7s carrying the points in sorted order as a payload
    # of its last pass, K7b reading them contiguously — the same kernel on
    # the points gathered in sorted order with the identity as sort index
    # (the same sums, bit for bit), beside the gather that payload adds
    sorted_calls = []
    for a, kw, cent in ds_calls:
        pts, perm = a[0], a[1]
        seq = torch.arange(perm.shape[0], device=pts.device)
        sorted_calls.append(((pts[perm], seq, *a[2:]), kw, cent, pts, perm))
    require(all(torch.equal(ingest_downsample.centroids(*a, **kw), cent)
                for a, kw, cent, _, _ in sorted_calls),
            f"K7b on sorted points differs ({what})")
    ms_sorted = launch_ms([lambda _, a=a, kw=kw: ingest_downsample.centroids(*a, **kw)
                           for a, kw, _, _, _ in sorted_calls], reps)
    gather_ms = launch_ms([lambda _, p=p, q=q: p.index_select(0, q)
                           for _, _, _, p, q in sorted_calls], reps)
    # the library's segmented sum: torch.segment_reduce over each run's
    # members gathered in sorted order, compensated by the run's corner (the
    # kernel's sums), one call a launch; its centroids beside the kernel's
    lib_calls, lib_err = [], 0.0
    for a, kw, cent in ds_calls:
        pts, perm, starts, counts, run_keys, anchors = a
        n_in = int(counts.sum())
        corner = ingest_keys.unpack(run_keys, anchors).to(torch.float32) * kw["leaf"]
        rid = torch.repeat_interleave(torch.arange(len(counts), device=pts.device), counts)
        offs = (pts[perm[:n_in]] - corner[rid]).contiguous()
        lengths = counts.to(torch.int64)
        lib = corner + torch.segment_reduce(offs, "sum", lengths=lengths, axis=0) \
            / counts.to(torch.float32)[:, None]
        lib_err = max(lib_err, float((lib - cent).abs().max()))
        lib_calls.append((offs, lengths))
    library_ms = launch_ms([lambda _, o=o, n=n: torch.segment_reduce(o, "sum", lengths=n, axis=0)
                            for o, n in lib_calls], reps)
    print(f"K7b, {what}: {ms:.4f} ms device time for its {len(ds_calls)} launch(es) (plain "
          f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}); on points in sorted order "
          f"{ms_sorted:.4f} ms, beside {gather_ms:.4f} ms for the gather that payload adds; "
          f"library (torch.segment_reduce sum over the gathered, compensated offsets) "
          f"{library_ms:.4f} ms, its centroids within {lib_err:.3e} of the kernel's")
    return {"max_abs_err": err, "bit_equal": all(same), "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_max_abs_diff": lib_err,
            "bound_ms": b_ms, "bound_by": b_by, "outside_control": bad_ctl,
            "reverse_order_control_differs": n_rev,
            "launches_timed": len(ds_calls), "longest_run": longest, "warp_runs": warp_runs,
            "sorted_points_ms": ms_sorted, "payload_gather_ms": gather_ms}


def _library_sort(keys):
    """PyTorch's stable sort and run cut of ``keys``, the library's K7s."""
    skey, perm = torch.sort(keys, stable=True)
    return perm, torch.unique_consecutive(skey, return_counts=True)


def check_k7s(calls, what: str, reps: int = 5) -> dict:
    """K7s on every sort of one dispatch's recorded calls: the sort index,
    the runs and the rows' runs bit-equal to the plain version on the same
    card inputs; the control, the kernel's sort index with one tie swapped,
    must fail that check.  Times per sort: ``ms`` the device time of its
    launches queued behind a spin (``ingest_sort.launch``, no sync),
    ``ms_call`` the whole call with its one sync, ``library_ms``
    torch.sort(stable=True) + unique_consecutive on the same keys (its own
    sync inside, as ``ms_call``), ``library_sort_ms`` torch.sort alone behind
    a spin (as ``ms``).  Bound: the keys read once, the sort index, the runs
    (and the rows' runs) written once."""
    sorts = []
    for (keys, window), kw, runs in calls["ingest_sort"]:
        ref = ingest_sort.sort_runs_plain(keys, window, **kw)
        count = kw.get("count")
        same = {n: bool((x is None and y is None) or torch.equal(x, y))
                for n, x, y in zip(runs._fields, runs, ref)}
        require(all(same.values()), f"K7s disagrees with its plain version ({what}): {same}")
        tie = torch.nonzero(ref.counts > 1)
        ctl_fails = None
        if len(tie):
            a = int(ref.starts[int(tie[0])])
            perm = runs.perm.clone()
            perm[[a, a + 1]] = perm[[a + 1, a]]
            ctl_fails = not torch.equal(perm, ref.perm)
            require(ctl_fails, f"the K7s check passes a swapped tie ({what})")
        # the keys the sort reads: with K7c's count on the card, its first M
        N = keys.shape[0] if count is None else min(int(count.item()), keys.shape[0])
        V, R = runs.perm.shape[0], runs.ukey.shape[0]
        rid = kw.get("want_rid", False)
        ms = launch_ms([lambda _, k=keys, w=window, kw=kw: ingest_sort.launch(k, w, **kw)],
                       reps)
        ms_call = cuda_ms(lambda _: ingest_sort.sort_runs(keys, window, **kw), reps)
        lib_keys = keys[:N]
        lib_ms = cuda_ms(lambda _: _library_sort(lib_keys), reps)
        lib_sort_ms = launch_ms([lambda _: torch.sort(lib_keys, stable=True)], reps)
        _, plain_ms = _timed(lambda: ingest_sort.sort_runs_plain(keys, window, **kw))
        b_ms, b_by = bound(0, 8 * N + 8 * V + 24 * R + (4 * V if rid else 0))
        bp_ms, _ = bound(0, ingest_sort.passes_bytes(N, V, R, window, rid))
        rec = {"keys": N, "keys_allocated": keys.shape[0], "device_count": count is not None,
               "valid": V, "runs": R, "longest_run": int(ref.counts.max()) if R
               else 0, "bits": window.bits, "passes": window.passes,
               "path": "one CTA" if ingest_sort.small_sort(keys.shape[0]) else "multi-CTA",
               "kernels": ingest_sort.kernels_per_sort(window, keys.shape[0]),
               "key_bytes": window.key_bytes, "bit_equal": True,
               "control_fails": ctl_fails, "ms": ms, "ms_call": ms_call, "library_ms": lib_ms,
               "library_sort_ms": lib_sort_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
               "bound_by": b_by, "bound_ms_passes": bp_ms,
               "beats_library": ms_call < lib_ms, "beats_torch_sort": ms < lib_sort_ms}
        sorts.append(rec)
        print(f"K7s, {what}: {N} keys{' (a count on the card)' if count is not None else ''}"
              f", {V} valid, {R} runs (longest {rec['longest_run']}), "
              f"{window.bits}-bit codes in {window.passes} passes of u{8 * window.key_bytes}, "
              f"the {rec['path']} path ({rec['kernels']} kernels); "
              f"bit-equal to the plain version, control (a tie swapped) fails {ctl_fails}; "
              f"{ms:.4f} ms device time ({ms_call:.4f} ms with its sync; torch.sort + "
              f"unique_consecutive {lib_ms:.4f} ms with theirs, torch.sort alone {lib_sort_ms:.4f} "
              f"ms; plain {plain_ms:.3f} ms), bound {b_ms:.4f} ms by {b_by} (the passes' bytes: "
              f"{bp_ms:.4f} ms)")
    keys_ = ("ms", "ms_call", "library_ms", "library_sort_ms", "plain_ms", "bound_ms",
             "bound_ms_passes")
    out = {k: sum(r[k] for r in sorts) for k in keys_}
    print(f"K7s, {what}: {len(sorts)} sorts, {out['ms']:.4f} ms device time in all "
          f"({out['ms_call']:.4f} with their syncs; the library {out['library_ms']:.4f}, "
          f"torch.sort alone {out['library_sort_ms']:.4f}), bound {out['bound_ms']:.4f} ms; "
          f"faster than the library on every sort {all(r['beats_library'] for r in sorts)}, "
          f"than torch.sort alone {all(r['beats_torch_sort'] for r in sorts)}")
    return {"max_abs_err": 0.0, **out, "bound_by": "bytes", "sorts": sorts,
            "launches_timed": len(sorts)}


def k7s_fixed_cost(keys, window, reps: int = 5) -> dict:
    """K7s's fixed cost a sort, on the first 64 of ``keys``: the device time
    of the one-CTA path and of the multi-CTA path (the threshold moved to 0)
    behind a spin, and the one-CTA call with its sync; beside
    torch.sort(stable=True) + unique_consecutive with their syncs and
    torch.sort alone behind a spin."""
    k = keys[:64].contiguous()
    small = launch_ms([lambda _: ingest_sort.launch(k, window)], reps)
    call = cuda_ms(lambda _: ingest_sort.sort_runs(k, window), reps)
    saved = ingest_sort.SMALL_SORT_KEYS
    ingest_sort.SMALL_SORT_KEYS = 0
    try:
        large = launch_ms([lambda _: ingest_sort.launch(k, window)], reps)
        large_call = cuda_ms(lambda _: ingest_sort.sort_runs(k, window), reps)
    finally:
        ingest_sort.SMALL_SORT_KEYS = saved
    lib = cuda_ms(lambda _: _library_sort(k), reps)
    lib_sort = launch_ms([lambda _: torch.sort(k, stable=True)], reps)
    print(f"K7s fixed cost a sort (64 keys): one-CTA path {small:.4f} ms device time "
          f"({call:.4f} with its sync), multi-CTA path {large:.4f} ({large_call:.4f} with its "
          f"sync); torch.sort + unique_consecutive {lib:.4f} ms with their syncs, torch.sort "
          f"alone {lib_sort:.4f} ms")
    return {"one_cta_ms": small, "one_cta_ms_call": call, "multi_cta_ms": large,
            "multi_cta_ms_call": large_call, "library_ms": lib, "library_sort_ms": lib_sort}


def check_k7t(calls, what: str, k7s: dict, reps: int = 5) -> dict:
    """K7t on one dispatch's recorded call: every output bit-equal to both
    plain versions on the same card inputs (the slot maps read off the
    candidate runs, the kernel's rule; and gathers with torch.searchsorted).
    ``library_ms``: torch.unique of the candidate keys, both searchsorted
    and the gathers (what the parent of PR 11 ran after its membership
    sort), to be read beside K7t's time plus the candidate sort's
    (``ms_with_candidates``, the last of ``k7s``'s sorts).  Bound: the bytes
    the data needs (the sorted rows' indices, their entries and labels, the
    block keys, the candidate sort's index and runs in; the slabs and both
    maps out); ``bound_ms_searches`` beside it, the search-based bound
    (each row's block key, and ⌈log₂⌉ probes a slot-map entry)."""
    (a, kw, out), = calls["ingest_bucket"]
    perm, rid, mrow, ent, lab, ukey, tkey, cperm, cstart, ccount, off, anchors = a
    ref, plain_ms = _timed(lambda: ingest_bucket.bucket_runs_plain(*a, **kw))
    search = ingest_bucket.bucket_plain(*a, **kw)
    names = ("ent", "ent_rel", "lab", "nb_row", "tb_u")
    same = {n: bool(torch.equal(x, y) and torch.equal(x, z))
            for n, x, y, z in zip(names, out, ref, search)}
    require(all(same.values()), f"K7t disagrees with its plain versions ({what}): {same}")
    ms = launch_ms([lambda _: ingest_bucket.bucket(*a, **kw)], reps)

    def library(_):
        torch.unique((ukey[:, None] + off[None, :]).reshape(-1))
        ingest_bucket.bucket_plain(*a, **kw)

    lib_ms = cuda_ms(library, reps)
    M, D, U, T, G = perm.shape[0], ent.shape[1], ukey.shape[0], tkey.shape[0], off.shape[0]
    nbyte = M * (8 + 4 + 4 + 4 * D + 4) + 8 * U + 8 * U * G + 16 * T + 4 * G \
        + M * (8 * D + 4) + 8 * G * (U + T)
    b_ms, b_by = bound(0, nbyte)
    nbyte_s = M * (8 + 4 + 8 + 4 * D + 4) + 8 * (U + T + G) + M * (8 * D + 4) + 8 * G * (U + T)
    ops_s = 3 * G * (U * math.ceil(math.log2(T + 1)) + T * math.ceil(math.log2(U + 1)))
    bs_ms, _ = bound(ops_s, nbyte_s)
    with_cand = ms + k7s["sorts"][-1]["ms"]
    print(f"K7t, {what}: {M} rows (D {D}), U {U} entry blocks, T {T} test blocks, G {G} "
          f"(longest run {int(ccount.max())} candidates); equal to both plain versions "
          f"{same}; {ms:.4f} ms device time ({with_cand:.4f} with the candidate sort; "
          f"torch.unique + searchsorted + gathers {lib_ms:.4f} ms), plain {plain_ms:.3f} ms, "
          f"bound {b_ms:.4f} ms by {b_by} (the search-based bound: {bs_ms:.4f} ms)")
    return {"max_abs_err": 0.0, "bit_equal": True, "ms": ms, "ms_with_candidates": with_cand,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bound_ms_searches": bs_ms, "rows": M, "U": U, "T": T}


def check_k7_segments(calls, what: str, reps: int = 5) -> dict:
    """BGKL's device-ingest dispatch: K7b (the hits), K7c (the hits' dense
    layout), K7s (its three sorts) and K7t, as in :func:`check_k7`."""
    out = {"ingest_downsample": check_k7b(calls, what, reps),
           "ingest_members": check_k7c(calls, what, reps),
           "ingest_sort": check_k7s(calls, what, reps)}
    out["ingest_bucket"] = check_k7t(calls, what, out["ingest_sort"], reps)
    return out


def check_k1p(calls, reps: int = 5, gate: float | None = None) -> dict:
    """K1′ against its plain version on one dispatch's recorded call (point
    or segment entries): bit for bit, and so within K1's limit 1e-5 +
    1e-5·|plain|, which the control (the plain version on TF32-rounded
    coordinates) must fail.  With ``gate`` (BGKL), no k̄ may be decided apart
    at the gate.  Its warp culling as ``k1p_culling``; ``bound_ms`` counts
    the work the culling leaves, ``bound_ms_every_pair`` every evaluation of
    the plain algorithm."""
    (a, kw, acc), = calls["bgk_aligned_heavy"]
    ent_rel, labels, ustart, ucount, tb_u, ext = a
    seg = ent_rel.shape[1] == 6
    name = "K1' (segments)" if seg else "K1'"
    ref, plain_ms = _timed(lambda: bgk_aligned_heavy.bgk_aligned_heavy_plain(*a, **kw))
    ctl = bgk_aligned_heavy.bgk_aligned_heavy_plain(
        tf32_round(ent_rel), labels, ustart, ucount, tb_u, tf32_round(ext), **kw)
    lim = 1e-5 + 1e-5 * ref.abs()
    d, dc = (acc - ref).abs(), (ctl - ref).abs()
    bad, bad_ctl = int((d > lim).sum()), int((dc > lim).sum())
    err = float(d.max())
    same = bool(torch.equal(acc, ref))
    G, U = kw["G"], ucount.shape[0]
    Vall = ext.shape[0] // G
    u = tb_u.reshape(-1)
    evals = int(ucount[u[u < U]].sum()) * Vall
    print(f"{name}, {tuple(acc.shape)}: bit-equal to the plain version {same}, max |kernel "
          f"- plain| = {err:.3e}, {bad} elements outside 1e-5 + 1e-5*|plain|; control, the "
          f"plain version on TF32-rounded coordinates: {bad_ctl} outside (max |Δ| "
          f"{float(dc.max()):.3e})")
    require(bool(torch.isfinite(acc).all()), f"{name} gave non-finite values")
    require(bad == 0, f"{name} disagrees with its plain version")
    require(same, f"{name} is not bit-equal to its plain version")
    require(bad_ctl > 0, f"the {name} limit passes the TF32 control")
    gates = gate_apart(acc, ref, G, gate, name) if gate is not None else {}
    ms = launch_ms([lambda _: bgk_aligned_heavy.bgk_aligned_heavy(*a, **kw)], reps)
    per_eval = bgk_heavy.FLOP_PER_EVAL_SEGMENT if seg else bgk_heavy.FLOP_PER_EVAL
    per_test = km.FLOP_CULL_TEST if seg else km.FLOP_CULL_TEST_POINT
    nbyte = nbytes(*a, acc)
    b_all_ms, _ = bound(per_eval * evals, nbyte)
    cull = k1p_culling(a, kw, acc, name)
    b_ms, b_by = bound(per_eval * cull["needed_evaluations"]
                       + per_test * cull["warp_entry_pairs"], nbyte)
    print(f"{name}: {ms:.3f} ms device time (plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
          f"by {b_by}; {evals} kernel evaluations, bound on every evaluation "
          f"{b_all_ms:.4f} ms)")
    return {"max_abs_err": err, "bit_equal": same, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bound_ms_every_pair": b_all_ms,
            "evaluations": evals, "outside_control": bad_ctl, **cull, **gates}


def k1p_culling(a, kw, acc, name: str) -> dict:
    """K1′ on one dispatch: its work units, and the (warp, entry) pairs its
    warps skip — its own count, which must equal that of the plain predicate
    ``bgk_aligned_heavy_cull`` — with a repeat launch bit-equal to ``acc``;
    the evaluations in the pairs kept (``warp_work``)."""
    ent_rel, _, ustart, ucount, tb_u, ext = a
    G, U, T = kw["G"], ucount.shape[0], tb_u.shape[0]
    Vall = ext.shape[0] // G
    culled = torch.zeros(1, dtype=torch.int64, device=ent_rel.device)
    again = bgk_aligned_heavy.bgk_aligned_heavy(*a, **kw, culled=culled)
    per_warp = bgk_aligned_heavy.bgk_aligned_heavy_cull(ent_rel, ustart, ucount, tb_u, ext,
                                                        G=G, ell=kw["ell"], per_warp=True)
    plain = int(per_warp.sum())
    u = tb_u.reshape(-1)
    needed, pairs = warp_work(per_warp, int(ucount[u[u < U]].sum()), Vall)
    units = T * ((Vall + 31) // 32)
    frac = int(culled) / max(pairs, 1)
    print(f"{name}: T {T} blocks, {units} work units (warps of 32 of {Vall} nodes), "
          f"{int(culled)} of {pairs} (warp, entry) pairs culled ({100 * frac:.2f} %; the "
          f"plain predicate: {plain}), {needed} evaluations in the pairs kept")
    require(int(culled) == plain, f"{name}: the warps cull other pairs than "
                                  "bgk_aligned_heavy_cull")
    require(bool(torch.equal(again, acc)), f"{name}: a repeat launch differs")
    return {"T": T, "work_units": units, "culled_pairs": int(culled),
            "warp_entry_pairs": pairs, "culled_fraction": frac, "needed_evaluations": needed}


def check_k7d(calls, what: str, reps: int = 5, data_controls: bool = True) -> dict:
    """K7d against its plain version on one dispatch's recorded call: occ,
    the ray segments, inr and the samples equal, the (ray, block key) pair
    list identical (the main path's call, without samples, too).  Controls:
    the kernel's list with two keys of a ray swapped must fail the check,
    and the plain list without the dedup (every membership of every kept
    sample) must be longer, so the rays hold blocks that two samples share;
    where ``data_controls``, also the dedup rule walked in index order with
    the origin first (``first_in_ray_plain``) must give another list, and
    the plain version on the samples in f64 must move at least one
    membership, so the equality of the samples is not met by chance.  On
    the large map's 3.2 m blocks (rows of at most 2 pairs) neither of those
    two moves a pair, so there they are printed only.  ``ms``: the device
    time of one call (every kernel, copy and memset of ``reps`` calls under
    torch.profiler, over ``reps``; the host's wait between its launches left
    out); ``ms_call``: the whole call with its one wait, by CUDA events."""
    (a, kw, main), = calls["ingest_rays"]
    hits, hkey, origins, anchors = a
    ks = ingest_rays.ray_pairs(*a, **kw, want_samples=True)
    ref, plain_ms = _timed(lambda: ingest_rays.ray_pairs_plain(*a, **kw, want_samples=True))
    names = ("occ", "seg", "inr", "pair_ray", "pair_key", "samples")
    same = {n: bool(x.shape == y.shape and torch.equal(x, y)) for n, x, y in zip(names, ks, ref)}
    same_main = all(torch.equal(x, y) for x, y in zip(main[:5], ref[:5]))
    ctl = ingest_rays.ray_pairs_plain(hits.double(), hkey, origins.double(), anchors, **kw)
    pairs = torch.cat([torch.stack([ref[3], ref[4]], 1), torch.stack([ctl[3], ctl[4]], 1)])
    _, cnt = torch.unique(pairs, dim=0, return_counts=True)
    n_ctl = int((cnt == 1).sum())
    *_, keys, kept = ingest_rays.ray_keys_plain(*a, **kw)
    bad_ray, bad_key = ingest_rays.first_in_ray_plain(keys, kept, torch.arange(kw["kf"] + 1))
    order_differs = not (torch.equal(bad_ray, ref[3]) and torch.equal(bad_key, ref[4]))
    n_undeduped = int(((keys != ingest_keys.SENT) & kept[:, :, None]).sum())
    row = torch.bincount(ref[3], minlength=hits.shape[0])
    first = int((torch.cumsum(row, 0) - row)[int(torch.nonzero(row >= 2)[0])])
    swapped = ks[4].clone()
    swapped[[first, first + 1]] = swapped[[first + 1, first]]
    swap_fails = not torch.equal(swapped, ref[4])
    err = max(float((x - y).abs().max()) for x, y in ((ks[0], ref[0]), (ks[1], ref[1]),
                                                       (ks[5], ref[5])))
    R, S, L = hits.shape[0], kw["kf"] + 1, ingest_rays.lanes_per_ray(kw["kf"])
    n_pairs = ref[3].numel()
    longest = int(torch.bincount(ref[3]).max()) if n_pairs else 0
    print(f"K7d, {what}: {R} rays x {S} samples ({L} lanes a ray), {n_pairs} (ray, block) "
          f"pairs ({n_pairs / max(R, 1):.2f} a ray, the longest row {longest}); equal to the "
          f"plain version {same}, the main path's call {same_main}; controls: without the "
          f"dedup {n_undeduped} pairs, the samples in f64 move {n_ctl} pairs, the dedup in "
          f"index order gives {bad_ray.numel()} pairs (differs {order_differs}), two keys of "
          f"a ray swapped fail {swap_fails}")
    require(all(same.values()) and same_main, f"K7d disagrees with its plain version ({what})")
    require(swap_fails, f"the K7d check passes two swapped keys ({what})")
    require(n_undeduped > n_pairs, f"no two samples of a ray share a block ({what})")
    require(order_differs or not data_controls,
            f"the K7d check passes the index-order dedup ({what})")
    require(n_ctl > 0 or not data_controls, f"the K7d limit passes the f64 control ({what})")
    ms = device_ms(lambda: ingest_rays.ray_pairs(*a, **kw), reps, "ingest_rays", 2)
    ms_call = cuda_ms(lambda _: ingest_rays.ray_pairs(*a, **kw), reps)
    # what these rays need: each proxy sample in range ≈ 60 operations (its
    # position, its memberships), and the dedup of a ray's m memberships a
    # comparison sort's m·⌈log2 m⌉ comparisons, 3 operations each
    n_smp, n_mem = ingest_rays.ray_work(hits, hkey, origins, kf=kw["kf"], mr=kw["mr"],
                                        fr=kw["fr"], block_size=kw["block_size"])
    mem = n_mem.double()
    ops = 60 * float(n_smp.sum()) + 3 * float((mem * torch.ceil(torch.log2(
        torch.clamp_min(mem, 1)))).sum())
    b_ms, b_by = bound(ops, nbytes(hits, hkey, origins, anchors) + R * (12 + 24 + 1)
                       + 16 * n_pairs)
    print(f"K7d, {what}: {ms:.4f} ms device time a call, by torch.profiler ({ms_call:.4f} ms "
          f"with its wait for the sizes; plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}; "
          f"{int(n_smp.sum())} samples in range, {int(n_mem.sum())} memberships)")
    return {"max_abs_err": err, "ms": ms, "ms_call": ms_call, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "rays": R, "pairs": n_pairs,
            "longest_row": longest, "samples": int(n_smp.sum()),
            "memberships": int(n_mem.sum()), "control_pairs_differ": n_ctl,
            "index_order_control_pairs": bad_ray.numel(), "swap_control_fails": swap_fails,
            "undeduped_control_pairs": n_undeduped}


def ingest_counts() -> dict:
    return {"ingest_sort": ingest_sort.launches, "ingest_bucket": ingest_bucket.launches,
            "ingest_beams": ingest_beams.launches,
            "ingest_downsample": ingest_downsample.launches,
            "ingest_members": ingest_members.launches, "ingest_rays": ingest_rays.launches,
            "ingest_slots": ingest_slots.launches,
            "ingest_voxel_grid": ingest_voxel_grid.launches,
            "bgk_aligned_heavy": bgk_aligned_heavy.launches, "bgk_heavy": bgk_heavy.launches,
            "bgk_light": bgk_light.launches, "gp_heavy": gp_heavy.launches,
            "gp_light": gp_light.launches}


def host_syncs(cfg, scans) -> dict:
    """Host syncs of one dispatch of ``scans`` on ``cfg``'s ingest path, as
    PyTorch's sync debug mode reports them (the explicit wait for the key and
    count copy included), by the line that made them."""
    import warnings

    m = pipeline.MAP_CLASSES[cfg.method](cfg, device="cuda")
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            m.insert_pointclouds([c for c, _ in scans], [o for _, o in scans],
                                 ds_resolution=cfg.resolution,
                                 free_resolution=cfg.free_resolution, max_range=cfg.max_range)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    sites = {}
    for w in seen:
        # the sync debug mode's own first warning, that it is a prototype
        # which "does not yet detect all synchronizing operations", is no sync
        if "synchroniz" in str(w.message) and "prototype" not in str(w.message):
            parent, name = os.path.split(w.filename)
            site = f"{os.path.basename(parent)}/{name}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
    return {"total": sum(sites.values()), "by_line": sites}


#: host syncs of one device-ingest dispatch before K7s (PERF.md §5); a
#: dispatch may not take more
INGEST_SYNCS = 5


def ingest_syncs(cfg, scans, name: str) -> dict:
    """``host_syncs`` of a device-ingest dispatch, required ≤ INGEST_SYNCS."""
    got = host_syncs(cfg, scans)
    print(f"{name} device ingest: host syncs in a {len(scans)}-scan dispatch {got}")
    require(got["total"] <= INGEST_SYNCS,
            f"{name} device ingest: {got['total']} host syncs a dispatch, more than "
            f"{INGEST_SYNCS}")
    return got


def main_path_ingest(cfg, pcd_dir: str, scans, runs=(12, 60)) -> dict:
    """run_static on each of ``runs`` scans and OnlineIntegrator on 12 scans
    on the default path of a CUDA map, device ingest: per dispatch two K7a, two K7b,
    one K7c launches (BGKL: one K7a, one K7b, the two of K7d, one K7c), K7w's
    world keys and gather around one more K7s sort, then K1′ once and K2 per
    scan (BGK, BGKL) or K4 per size tier and K5 per scan
    (GP); online, per scan K7v's two launches round one more K7s sort (the
    server's pre-downsample on the card); no chunk on the host path."""
    gp, seg = cfg.method == "gp", cfg.method == "bgkl"
    cls = pipeline.MAP_CLASSES[cfg.method]
    out = {}

    def expect(m, dispatches, n_scans, what, online=0):
        got = ingest_counts()
        per = 1 if seg else 2
        want = {"ingest_sort": (4 if seg else 5) * dispatches + online,
                "ingest_voxel_grid": 2 * online, "ingest_bucket": dispatches,
                "ingest_slots": 2 * dispatches,
                "ingest_beams": per * dispatches, "ingest_downsample": per * dispatches,
                "ingest_members": dispatches, "ingest_rays": 2 * dispatches if seg else 0,
                "bgk_heavy": 0,
                "bgk_aligned_heavy": 0 if gp else dispatches,
                "bgk_light": 0 if gp else n_scans, "gp_light": n_scans if gp else 0,
                "gp_heavy": m.stats["heavy_tiers"] if gp else 0}
        print(f"{cfg.method} {what}: launches {got}")
        require(got == want, f"{what}: launches {got}, expected {want}")
        require(m.stats["ingest_host_chunks"] == 0, f"{what}: a chunk took the host path")
        if gp:
            require(m.stats["heavy_tiers"] >= dispatches and int(m.failed_models) == 0,
                    f"{what}: K4 tiers or a failed factorisation")
        return got

    for n_scans in runs:
        ds = DatasetConfig(name="synth", dir=pcd_dir, prefix="synth", scan_num=n_scans,
                           max_range=cfg.max_range)
        reset_counts()
        res = pipeline.run_static(cfg, ds)
        m = res.map
        ex = pipeline.export_leaves(m)
        n_occ, n_free = len(ex["occupied"]["x"]), len(ex["free"]["x"])
        print(f"{cfg.method} (block_depth {cfg.block_depth}, max_range {cfg.max_range:g}) "
              f"device ingest, run_static {n_scans} scans: "
              f"{res.scans_per_second:.2f} scans/s ({res.total_seconds:.3f} s), "
              f"{m.pool.n_blocks} blocks, {n_occ} occupied / {n_free} free leaves, "
              f"host_s {m.stats['host_s'] * 1e3:.1f} ms")
        got = expect(m, -(-n_scans // cls.SCAN_BATCH), n_scans, f"run_static {n_scans}")
        require(n_occ > 0 and n_free > 0, "no occupied or no free leaves")
        require(all(np.isfinite(ex["all"][k]).all() for k in ("prob", "var", "x")),
                "non-finite leaves")
        out[f"static{n_scans}"] = {"scans_per_s": res.scans_per_second,
                                   "seconds": res.total_seconds,
                                   "host_s": m.stats["host_s"], "launches": got,
                                   "ingest_sort_kernels": ingest_sort.kernel_launches}

    m = cls(cfg)
    online = pipeline.OnlineIntegrator(m)
    lat = []
    reset_counts()
    for cloud, origin in scans[:12]:
        t0 = time.perf_counter()
        online.offer(cloud, origin)
        m.synchronize()
        lat.append(time.perf_counter() - t0)
    med = float(np.median(lat)) * 1e3
    print(f"{cfg.method} device ingest, OnlineIntegrator 12 scans: {online.n_integrated} "
          f"integrated, median latency {med:.2f} ms (min {min(lat) * 1e3:.2f}, max "
          f"{max(lat) * 1e3:.2f})")
    require(online.n_integrated == 12, "the online gate skipped scans")
    got = expect(m, 12, 12, "OnlineIntegrator 12", online=12)
    out["online12"] = {"median_ms": med, "integrated": online.n_integrated,
                       "launches": got}
    return out


# ------------------------------------------------------------- raycast phases

#: rays of the raycast phase: one million over the BGK demo map (the load
#: the JAX package sizes its device raycast for), 100,000 over the BGKL and
#: BGKLV maps
RAYS_MAIN, RAYS_OTHER = 1_000_000, 100_000


def ray_set(scans, n: int, seed: int):
    """``n`` rays from the scans' origins (an equal share each) in seeded
    uniform directions (not normalised: raycast_device normalises)."""
    rng = np.random.default_rng(seed)
    origins = np.stack([o for _, o in scans]).astype(np.float32)
    return origins[np.arange(n) % len(origins)], rng.normal(size=(n, 3))


def dda_path(o, d, res: float, n_steps: int, dt):
    """The voxels [n_steps+1, 3], the t at each and the t_max before each
    step [n_steps, 3] of one ray's DDA in the dtype ``dt``: K6's f32
    expressions, or the host stepper's in f64."""
    r, o, d = dt(res), o.astype(dt), d.astype(dt)
    idx = np.floor(o / r + dt(0.5)).astype(np.int64)
    step = np.where(d > 0, 1, -1)
    tiny = np.abs(d) < dt(1e-12)
    safe = np.where(tiny, dt(1e-12), d).astype(dt)
    bnd = (idx + (step > 0)).astype(dt) * r - r / dt(2)
    with np.errstate(divide="ignore"):
        t_max = np.where(tiny, dt(np.inf), (bnd - o) / safe).astype(dt)
    t_delta = np.abs(r / safe).astype(dt)
    path, ts, tms = [idx.copy()], [dt(0)], []
    for _ in range(n_steps):
        tms.append(t_max.copy())
        ax = int(np.argmin(t_max))
        ts.append(t_max[ax])
        idx[ax] += step[ax]
        t_max[ax] = t_max[ax] + t_delta[ax]
        path.append(idx.copy())
    return np.stack(path), np.array(ts, np.float64), np.array(tms, np.float64).reshape(-1, 3)


def host_stepper_ties(m, snap, o, d, k6_out, host, max_range: float) -> dict:
    """Every ray on which the host stepper ``raycast`` (f64 steps, the map's
    ``search`` on f32 voxel centres) and K6 (f32 steps, the snapshot) part in
    hit or steps must show a tie, one of:

    * ``start``: the first voxel differs, o/res + 1/2 within f32 rounding
      of an integer;
    * ``path``: the two steppers step along different axes first, where the
      two axes' f64 t_max lie within the f32 error of the steps so far;
    * ``voxel``: on the common path a voxel's state differs, and wherever
      one does, ``search`` and K6 read different voxels (block or local
      index): every DDA voxel centre lies on a face of the blocks' voxel
      grid, where the last ulp picks the voxel;
    * ``range``: the paths and states agree, and the last t lies within
      f32 rounding of ``max_range``.

    A ray that shows none fails the run: the two read the same voxel and
    disagree, or part without a tie.  Returns the count of each kind."""
    res, bs, n = snap.res, snap.bs, snap.n
    eps = 2.0 ** -23
    dn32 = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    dn64 = d / np.linalg.norm(d, axis=1, keepdims=True)
    parted = np.nonzero((host["hit"] != k6_out["hit"]) | (host["steps"] != k6_out["steps"]))[0]
    tabs = tuple(x.cpu() for x in (snap.state_tab, snap.tab_hi, snap.tab_lo, snap.tab_slot))
    r32, b32 = np.float32(res), np.float32(bs)
    kinds = {"start": 0, "path": 0, "voxel": 0, "range": 0}
    for i in parted:
        sk, sh = int(k6_out["steps"][i]), int(host["steps"][i])
        L, m0 = max(sk, sh) + 1, min(sk, sh)
        p32, t32, tm32 = dda_path(o[i], dn32[i], res, L, np.float32)
        p64, t64, tm64 = dda_path(o[i].astype(np.float64), dn64[i], res, L, np.float64)
        split = np.nonzero((p32 != p64).any(1))[0]
        j = int(split[0]) if len(split) else L + 1
        if j == 0:
            x = o[i].astype(np.float64) / res + 0.5
            ok = bool((np.abs(x - np.round(x)) <= 4 * eps * (np.abs(x) + 1)).any())
            kind = "start"
        elif j <= m0:
            a, b = int(np.argmin(tm32[j - 1])), int(np.argmin(tm64[j - 1]))
            ta, tb = tm64[j - 1, a], tm64[j - 1, b]
            # f32 t_max: (bound - o) / d rounded, then j additions
            lever = (np.abs(p64[j - 1, [a, b]]).max() * res + np.abs(o[i]).max()) / min(
                abs(dn64[i, a]), abs(dn64[i, b]))
            ok = a != b and abs(ta - tb) <= 4 * eps * (8 * lever + (j + 2) * max(ta, tb))
            kind = "path"
        else:
            vox = p32[:m0 + 1]
            st_k = k6.lookup_plain(*tabs, torch.as_tensor(vox, dtype=torch.int32),
                                   res=torch.tensor(r32), bs=torch.tensor(b32), n=n,
                                   max_probes=snap.max_probes)[0]
            ctr_h = (vox * res).astype(np.float32)               # the host stepper's
            st_h = m.search(ctr_h)["state"]
            apart = np.nonzero((st_k.numpy() == posterior.OCCUPIED)
                               != (st_h == posterior.OCCUPIED))[0]
            if len(apart):
                pk = vox[apart].astype(np.float32) * r32
                blk_k = np.floor(pk / b32 + np.float32(0.5)).astype(np.int64)
                v = np.clip(((pk - blk_k.astype(np.float32) * b32) / r32
                             + np.float32(n) / np.float32(2)).astype(np.int32), 0, n - 1)
                vi_k = v[:, 0] + v[:, 1] * n + v[:, 2] * n * n
                c_h = ctr_h[apart]
                blk_h = geo.point_to_block_coord(c_h, bs)
                vi_h = geo.point_to_voxel_index(c_h, m.block_centers(blk_h), res, n)
                ok = bool(((blk_k != blk_h).any(1) | (vi_k != vi_h)).all())
                kind = "voxel"
            else:
                tl = t64[max(m0 - 1, 0):m0 + 2]
                ok = bool((np.abs(tl - max_range) <= 4 * eps * (m0 + 8) * max_range).any())
                kind = "range"
        require(ok, f"ray {i}: the host stepper and K6 part without a tie ({kind}: "
                    f"steps {sh} and {sk})")
        kinds[kind] += 1
    return kinds


def check_k6(m, scans, n: int, what: str, host_subset: int, seed: int,
             reps: int = 3) -> dict:
    """Raycast over the map ``m`` through its entry points: the snapshot,
    then ``raycast_device`` on ``n`` rays at MAX_RANGE (one K6 launch,
    counted), each timed on the host clock to its synchronised end; then K6
    against its plain version on the same call: hit and steps equal, dist
    bit-equal (control: the plain version in f64 must differ on a ray); the
    first ``host_subset`` rays on the CPU (the plain version, which the CPU
    tests hold against the JAX package's DDA) bit-equal to the card's.  The
    host stepper ``raycast`` (f64 steps) replays those rays; every ray where
    it parts from K6 must show a tie (:func:`host_stepper_ties`)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = rc.raycast_snapshot(m)
    torch.cuda.synchronize()
    snap_ms = (time.perf_counter() - t0) * 1e3
    o, d = ray_set(scans, n, seed)
    reset_counts()
    t0 = time.perf_counter()
    res = rc.raycast_device(m, o, d, MAX_RANGE, snapshot=snap)
    ray_ms = (time.perf_counter() - t0) * 1e3
    launches = k6.launches
    require(launches == 1, f"raycast_device launched K6 {launches} times, not once")
    dn = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    args = (snap.state_tab, snap.tab_hi, snap.tab_lo, snap.tab_slot,
            torch.as_tensor(o, device="cuda"), torch.as_tensor(dn, device="cuda"))
    kw = dict(res=snap.res, bs=snap.bs, n=snap.n,
              max_steps=int(np.ceil(MAX_RANGE / snap.res) * 3 + 8),
              target=posterior.OCCUPIED, max_range=MAX_RANGE, max_probes=snap.max_probes)
    hk, dk, sk = k6.raycast(*args, **kw)
    (hp, dp, sp, probes, probes_b, probed_b), plain_ms = _timed(
        lambda: k6.raycast_plain(*args, **kw, count_probes=True))
    counts = torch.zeros(2, dtype=torch.int64, device="cuda")
    again = k6.raycast(*args, **kw, counts=counts)
    hc, dc, sc = k6.raycast_plain(*args[:4], args[4].double(), args[5].double(), **kw)
    same = (torch.equal(hk, hp), torch.equal(sk, sp), torch.equal(dk, dp))
    same_again = all(torch.equal(x, y) for x, y in zip(again, (hk, dk, sk)))
    same_main = (np.array_equal(res["hit"], hk.cpu().numpy())
                 and np.array_equal(res["steps"], sk.cpu().numpy())
                 and np.array_equal(res["distance"], dk.cpu().numpy()))
    n_ctl = int(((hc != hp) | (sc != sp) | (dc.float() != dp)).sum())
    nh = int(hk.sum())
    err = float((dk[hk] - dp[hk]).abs().max()) if nh else 0.0
    finite = bool(torch.isfinite(dk[hk]).all() and (dk[hk] <= MAX_RANGE).all())
    steps_total, lookups, n_probes = int(sk.sum()), int(sk.sum()) + nh, int(probes.sum())
    probed, n_probes_b = int(probed_b.sum()), int(probes_b.sum())
    k_probed, k_probes = (int(x) for x in counts.tolist())
    cpu = k6.raycast_plain(*(x.cpu() for x in args[:4]),
                           *(x[:host_subset].cpu() for x in args[4:]), **kw)
    same_cpu = all(torch.equal(x, y[:host_subset].cpu()) for x, y in zip(cpu, (hk, dk, sk)))
    hs = rc.raycast(m, o[:host_subset], d[:host_subset], MAX_RANGE)
    agree = float(np.mean((hs["hit"] == res["hit"][:host_subset])
                          & (hs["steps"] == res["steps"][:host_subset])))
    print(f"raycast, {what}: {m.pool.n_blocks} blocks, {n} rays, snapshot {snap_ms:.2f} ms "
          f"(hash of {snap.tab_hi.numel()} entries, {snap.max_probes} probes), rays "
          f"{ray_ms:.2f} ms ({n / ray_ms * 1e3:.4g} rays/s, copies included); {nh} hits, "
          f"{steps_total} steps ({steps_total / n:.1f} a ray), {lookups} lookups taking "
          f"{n_probes} hash probes ({n_probes / max(lookups, 1):.2f} a lookup); with K6's "
          f"block cache {k_probed} lookups probed ({k_probed / n:.2f} a ray), taking "
          f"{k_probes} probes ({k_probes / max(lookups, 1):.2f} a lookup, "
          f"{n_probes / max(k_probes, 1):.2f}x fewer; the plain block mode: {probed} and "
          f"{n_probes_b}); K6 launches {launches}; hit, steps, dist equal to the plain "
          f"version {same}, to raycast_device's {same_main}, a repeat launch {same_again}; "
          f"control, the plain version in f64: {n_ctl} rays differ; the first {host_subset} "
          f"rays equal on the CPU {same_cpu}; the host stepper agrees in hit and steps on "
          f"{100 * agree:.2f}% of them")
    require(all(same) and same_main and same_again,
            f"K6 disagrees with its plain version ({what})")
    require((k_probed, k_probes) == (probed, n_probes_b),
            f"K6's probe counts differ from the plain block mode's ({what})")
    require(n_ctl > 0, f"the K6 limit passes the f64 control ({what})")
    require(finite and 0 < nh < n, f"raycast ({what}): no hits, all hits or bad distances")
    require(same_cpu, f"K6 on the card and its plain version on the CPU differ ({what})")
    ties = host_stepper_ties(m, snap, o[:host_subset], d[:host_subset],
                             {"hit": hk[:host_subset].cpu().numpy(),
                              "steps": sk[:host_subset].cpu().numpy()}, hs, MAX_RANGE)
    print(f"raycast, {what}: the host stepper parts from K6 on "
          f"{sum(ties.values())} of {host_subset} rays, each at a tie: {ties}")
    ms = launch_ms([lambda _: k6.raycast(*args, **kw)], reps)
    # bytes: the tables (state, hash) once, each ray's 24 bytes in and 9 out;
    # operations: those of the lookups and steps the rays took, a voxel's
    # three axes at a ray's first lookup and the stepped axis alone at each
    # later one, the key split and hash only at the lookups that probe under
    # the block cache, and their probes; beside it the bound with every
    # lookup computing all three axes, hashing and probing
    nbyte = nbytes(*args[:4]) + n * (24 + 9)
    axes = lookups + 2 * n
    b_ms, b_by = bound(k6.OPS_PER_STEP * lookups + k6.OPS_PER_AXIS * axes
                       + k6.OPS_PER_HASH * probed + k6.OPS_PER_PROBE * n_probes_b, nbyte)
    b_all_ms, _ = bound(k6.OPS_PER_LOOKUP * lookups + k6.OPS_PER_PROBE * n_probes, nbyte)
    print(f"K6, {what}: {ms:.3f} ms device time (plain {plain_ms:.3f} ms, bound "
          f"{b_ms:.4f} ms by {b_by}, with every lookup computing every axis and probing "
          f"{b_all_ms:.4f} ms; {lookups} state lookups, {axes} axes computed, {probed} "
          f"lookups probing {n_probes_b} probes)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "bound_ms_every_lookup": b_all_ms, "launches": launches,
            "rays": n, "snapshot_ms": snap_ms, "rays_ms": ray_ms,
            "rays_per_s": n / ray_ms * 1e3, "hits": nh, "steps": steps_total,
            "lookups": lookups, "probes": n_probes, "probed_lookups": probed,
            "probes_block_cache": n_probes_b,
            "probes_block_cache_per_lookup": n_probes_b / max(lookups, 1),
            "control_rays_differ": n_ctl, "host_agreement": agree, "host_ties": ties}


# ------------------------------------------------------------- large-map phases

def table_bytes(what: str, rows: int, row_bytes: int, scans: int) -> dict:
    """Print and return the size of a dispatch's heavy-pass tables: ``rows``
    test blocks of ``row_bytes`` each over ``scans`` scans, and what a
    16-scan dispatch of the same scene holds at the same blocks a scan."""
    total = rows * row_bytes
    per16 = total * 16 / scans
    print(f"{what}: {rows} test blocks x {row_bytes / 1e3:.1f} KB a block row = "
          f"{total / 1e6:.1f} MB over {scans} scans; a 16-scan dispatch holds about "
          f"{per16 / 1e6:.1f} MB of the card's "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB")
    return {"bytes": total, "row_bytes": row_bytes, "rows": rows,
            "bytes_16_scans": per16}


def check_light_collapsible(name: str, fn, plain, lead, start, node_idx, slots, ss, sc,
                            kw, what: str = "collapsible blocks",
                            every_level: bool = False) -> dict:
    """A light pass (K2 or K5, ``fn``) against its plain version over the
    dispatch's scans in order, from ``start``: the dispatch's pool with its
    blocks made collapsible at every level (:func:`collapsible_pool`, raster;
    the real scene collapses no 16³ group) or near-collapsible
    (:func:`near_collapsible_pool`): twice, each run bit for bit equal to the
    plain one; prints the groups collapsed at each level across tiles (edge >
    8), which must be some, and with ``every_level`` requires every level
    reached."""
    n, max_level = kw["n"], kw["max_level"]

    def run(f):
        st = [x.clone() for x in start]
        for s, c in zip(ss, sc):
            f(*lead, *st, node_idx, slots, s, c, **kw)
        return st

    runs = [run(fn), run(fn)]
    ref = run(plain)
    torch.cuda.synchronize()
    same = [all(torch.equal(x, y) for x, y in zip(k, ref)) for k in runs]
    levels = light_levels(ref[3], slots, max_level)
    across = {L: levels[L] // 8 ** L for L in range(4, max_level + 1)}
    print(f"{name}, {what}: {len(ss)} scans, pool rows equal to the plain "
          f"version's in both runs {same}; voxels by eff level {levels}; groups "
          f"collapsed across tiles by level {across}")
    require(all(same), f"{name} disagrees with its plain version ({what})")
    require(max_level <= 3 or sum(across.values()) > 0,
            f"{name}: no group collapsed across tiles ({what})")
    require(not every_level or all(levels[L] > 0 for L in range(1, max_level + 1)),
            f"{name}: a prune level was not reached ({what})")
    return {"levels": levels, "cross_tile_groups": across, "runs_equal": same}


def check_k5_pools(args, statics, tables, what: str) -> dict:
    """K5 on one dispatch's tables from its blocks made collapsible and
    near-collapsible (:func:`check_light_collapsible`), every prune level
    reached on each."""
    kw = {k: statics[k] for k in ("G", "sf2", "min_known_ivar", "max_ivar", "n",
                                  "max_level", "state_fn", "do_prune")}
    pool0, n, slots = args[:4], statics["n"], args[9]
    starts = {"collapsible": collapsible_pool(pool0, slots, n, templates=GP_TEMPLATES,
                                              raster=True),
              "near": near_collapsible_pool(pool0, slots, n, GP_NEAR_VALUES, raster=True)}
    return {k: check_light_collapsible(
        "K5", gp_light.gp_light, gp_light.gp_light_plain,
        (tables["acc_mean"], tables["acc_var"], tables["present"]), start, args[5], slots,
        args[11], args[12], kw, what=f"{k} blocks, {what}", every_level=True)
        for k, start in starts.items()}


def large_bgk_family(cfg_off, cfg_on, pcd_dir: str, scans, heavy: bool) -> dict:
    """A BGK-family large map on both ingest paths: run_static on 12 scans
    and OnlineIntegrator on 12 (launch counts asserted), card vs CPU on the
    host path (1 scan) and on device ingest (2 scans), at PERF.md §2's
    limits (BGK's host path 5e-3; BGKL's and device ingest 1e-5 +
    1e-5·|CPU|, with the TF32 control where ``heavy``)."""
    seg = cfg_off.method == "bgkl"
    out = {"host": main_path(cfg_off, pcd_dir, scans, runs=(12,)),
           "device": main_path_ingest(cfg_on, pcd_dir, scans, runs=(12,))}
    host_tol = (1e-5, 1e-5) if seg else (5e-3, 0.0)
    out["card_vs_cpu_host"] = card_vs_cpu(
        cfg_off, pcd_dir, n_scans=1, tol=host_tol,
        control=(bgk_heavy, "bgk_heavy", tf32_k1) if heavy else None)
    forced = dataclasses.replace(cfg_on, device_ingest="on")
    out["card_vs_cpu_device"] = card_vs_cpu(
        forced, pcd_dir, n_scans=2, tol=(1e-5, 1e-5),
        control=(bgk_aligned_heavy, "bgk_aligned_heavy", tf32_k1p) if heavy else None)
    return out


def k7v_scans(n: int, seed: int):
    """``n`` raw clouds and origins of the benchmark's city block
    (``benchmark/scene.py``, the BGK-L large map's configuration: a VLP-16
    of 28,800 beams, 0.5 m a scan) and that configuration's MapConfig."""
    from benchmark import scene

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "benchmark", "configs", "bgkl_large_vlp16.json")) as f:
        conf = json.load(f)
    clouds, origins = scene.scans(conf, n, seed, "cuda")
    from la3dm_tpu_torch.utils.config import MapConfig
    return clouds, origins, MapConfig(**conf["method"])


def _median_ms(fn, reps: int) -> float:
    """The median host time (ms) of ``reps`` calls of ``fn`` after one."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def check_k7v(n_scans: int = 24, seed: int = 2147500002, reps: int = 20) -> dict:
    """K7v, the server's pre-downsample on the card, on ``n_scans`` raw
    clouds of the benchmark's city block at the BGK-L large map's 0.5 m
    leaf: its centroids bit-equal (as uint32) to ``voxel_downsample``'s and
    to its plain version's on every scan, and on ``sum_order_cells``-like
    cells whose bits show numpy's sum order (cells of 4 … 4096 points: the
    lane's running sum, its eight sums, the pairwise tree above 129), which a
    running sum must fail.  Times on the first scan: ``ms`` K7v's launches
    (the keys, K7s's, the reduce) behind a spin; ``call_ms`` the call as
    ``OnlineIntegrator`` pays it, from the host cloud (the pinned upload,
    the launches and the wait), median host time; ``plain_ms`` the plain
    version on the CPU; ``numpy_ms`` ``preprocess.voxel_downsample``, the
    yardstick; ``native_ms`` the host library's hash-grid
    ``voxel_downsample`` (``native/host_preprocess.cpp``, which the port
    does not call).  Bound: 12 bytes a point in, 12 a centroid out."""
    import ctypes

    from la3dm_tpu_torch.geometry.preprocess import voxel_downsample

    clouds, origins, mcfg = k7v_scans(n_scans, seed)
    leaf = mcfg.ds_resolution
    bits = lambda x: np.ascontiguousarray(x).view(np.uint32)  # noqa: E731
    before = (ingest_voxel_grid.launches, ingest_sort.launches)
    cells = []
    for cloud, origin in zip(clouds, origins):
        ref = voxel_downsample(cloud, leaf)
        got = ingest_voxel_grid.voxel_grid(torch.from_numpy(cloud).cuda(), leaf, origin)
        plain = ingest_voxel_grid.voxel_grid_plain(torch.from_numpy(cloud), leaf, origin)
        require(np.array_equal(bits(got.cpu().numpy()), bits(ref))
                and np.array_equal(bits(plain.numpy()), bits(ref)),
                "K7v's centroids are not voxel_downsample's")
        cells.append(len(ref))
    require((ingest_voxel_grid.launches - before[0], ingest_sort.launches - before[1])
            == (2 * n_scans, n_scans), "K7v's launches do not match the scans")

    # cells whose float32 bits show numpy's order of summation
    rng = np.random.default_rng(seed)
    sizes = (1, 4, 8, 16, 64, 128, 256, 1024, 4096)
    rows = []
    for k, n in enumerate(sizes):
        c = np.empty((n, 3), np.float32)
        c[:, 0] = 2.0 ** -55
        c[:2, 0] = (0.25, 2.0 ** -26)[:n]
        c[:, 1:] = rng.uniform(0.0, 0.5, (n, 2))
        c[:, 1] += np.float32(2 * k)
        rows.append(c)
    label = rng.permutation(np.repeat(np.arange(len(rows)), sizes))
    order_pts = np.empty((len(label), 3), np.float32)
    for k, c in enumerate(rows):
        order_pts[label == k] = c
    ref = voxel_downsample(order_pts, 0.5)
    got = ingest_voxel_grid.voxel_grid(torch.from_numpy(order_pts).cuda(), 0.5, np.zeros(3))
    require(np.array_equal(bits(got.cpu().numpy()), bits(ref)),
            "K7v's sums are not added in numpy's order")
    # the control: each cell's running sum from its first point (np.cumsum adds in order)
    running = np.stack([np.cumsum(c.astype(np.float64), axis=0)[-1] / len(c) for c in rows])
    order_control_fails = not np.array_equal(bits(running.astype(np.float32)), bits(ref))
    require(order_control_fails, "a running sum passes the sum-order cells")

    cloud, origin = clouds[0], origins[0]
    pts = torch.from_numpy(cloud).cuda()
    N, R = len(cloud), cells[0]

    def queue(_):
        ingest_voxel_grid.launch(pts, leaf, origin)

    ms = launch_ms([queue], reps)

    def call():
        host = torch.from_numpy(cloud).pin_memory().to("cuda", non_blocking=True)
        return ingest_voxel_grid.voxel_grid(host, leaf, origin)

    call_ms = _median_ms(call, reps)
    cpu = torch.from_numpy(cloud)
    plain_ms = _median_ms(lambda: ingest_voxel_grid.voxel_grid_plain(cpu, leaf, origin), 5)
    numpy_ms = _median_ms(lambda: voxel_downsample(cloud, leaf), reps)
    lib = native._load()
    lib.voxel_downsample.restype = ctypes.c_int
    lib.voxel_downsample.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                                     ctypes.c_void_p, ctypes.c_int]
    out = np.empty_like(cloud)
    native_ms = _median_ms(lambda: lib.voxel_downsample(cloud.ctypes.data, N, leaf,
                                                        out.ctypes.data, N), reps)
    b_ms, b_by = bound(0, 12 * N + 12 * R)
    print(f"K7v, city-block scans (seed {seed}, leaf {leaf:g}): {n_scans} scans bit-equal to "
          f"voxel_downsample and the plain version ({N} points, {min(cells)}-{max(cells)} "
          f"cells a scan); the sum-order cells {sizes} bit-equal (a running sum fails: "
          f"{order_control_fails}); {ms:.4f} ms device time for its launches (keys, "
          f"{ingest_sort.kernels_per_sort(ingest_voxel_grid.WINDOW, N)} of K7s, reduce), the "
          f"call with the upload and the wait {call_ms:.4f} ms, plain {plain_ms:.2f} ms, "
          f"numpy {numpy_ms:.3f} ms, native {native_ms:.3f} ms, bound {b_ms:.5f} ms by {b_by}",
          flush=True)
    return {"max_abs_err": 0.0, "bit_equal": True, "order_control_fails": order_control_fails,
            "scans": n_scans, "points": N, "cells": R, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "numpy_ms": numpy_ms, "native_ms": native_ms,
            "bound_ms": b_ms, "bound_by": b_by}


# ------------------------------------------------------------- the command line

def all_counts() -> dict:
    """Every kernel wrapper's launch count (``ingest_sort``: its calls)."""
    return {**ingest_counts(), "lv_rows": lv_rows.launches, "lv_prune": lv_prune.launches,
            "raycast": k6.launches}


def run_cli(argv) -> tuple[str, float]:
    """``la3dm_tpu_torch.cli.main(argv)`` in this process, its standard
    output captured; prints that output but for the per-scan lines, and
    fails the run unless the command returns 0.  Returns (output, seconds)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        code = cli.main(list(argv))
    dt = time.perf_counter() - t0
    text = buf.getvalue()
    shown = [ln for ln in text.splitlines() if not ln.startswith(("Scan ", "One cloud"))]
    print(f"cli {' '.join(argv[:3])} ... ({dt:.2f} s, rc {code}): " + " | ".join(shown)[:600],
          flush=True)
    require(code == 0, f"la3dm_tpu_torch.cli {argv[0]} returned {code}")
    return text, dt


def npz_arrays(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def require_same_npz(a: str, b: str, what: str) -> None:
    """Two map checkpoints hold the same arrays, bit for bit."""
    x, y = npz_arrays(a), npz_arrays(b)
    require(sorted(x) == sorted(y) and all(
        x[k].dtype == y[k].dtype and x[k].shape == y[k].shape and np.array_equal(x[k], y[k])
        for k in x), f"{what}: the checkpoints differ")


#: each static run of the CLI phase: (label, method, --set overrides, the
#: kernels its main path must launch on the card)
CLI_STATIC = (
    ("bgk_host", "bgk", ['device_ingest="off"'], ("bgk_heavy", "bgk_light")),
    ("bgk_device", "bgk", [], ("ingest_beams", "ingest_downsample", "ingest_members",
                               "ingest_sort", "ingest_bucket", "ingest_slots",
                               "bgk_aligned_heavy", "bgk_light")),
    ("bgkl_host", "bgkl", ['device_ingest="off"'], ("bgk_heavy", "bgk_light")),
    ("bgkl_device", "bgkl", [], ("ingest_beams", "ingest_downsample", "ingest_rays",
                                 "ingest_members", "ingest_sort", "ingest_bucket",
                                 "ingest_slots", "bgk_aligned_heavy", "bgk_light")),
    ("bgklv", "bgklv", [], ("lv_rows",)),
    ("gp", "gp", [], ("ingest_beams", "ingest_downsample", "ingest_members", "ingest_sort",
                      "ingest_bucket", "ingest_slots", "gp_heavy", "gp_light")),
)
#: the exports of ``static --out``
CLI_EXPORTS = ("_occupied.ply", "_free.ply", "_occupied.csv", "_map.npz", "_map.bt",
               "_map.html")


def write_dataset_yaml(path: str, pcd_dir: str, n_scans: int) -> str:
    """The dataset YAML of the synthetic scans (``max_range`` 8 m, the room's
    height as the colour range)."""
    with open(path, "w") as f:
        f.write(f"name: synth\ndir: {pcd_dir}\nprefix: synth\nscan_num: {n_scans}\n"
                f"max_range: {MAX_RANGE}\nmin_z: 0.0\nmax_z: {ROOM[1][2]}\n")
    return path


def scene_truth(path: str, z_lo: float = 0.7, z_hi: float = 1.3, res: float = 0.1) -> int:
    """The scene's known geometry as an OctoMap ``.bt`` at ``res``, the base
    voxels of the band z_lo < z < z_hi over the room and one layer beyond its
    walls: occupied where the voxel meets a wall (the last layer inside and
    the first outside) or an obstacle, free elsewhere.  Returns the voxels."""
    g = (np.arange(-61, 61) + 0.5) * res                         # -6.05 .. 6.05
    z = (np.arange(int(round(z_lo / res)), int(round(z_hi / res))) + 0.5) * res
    X, Y, Z = np.meshgrid(g, g, z, indexing="ij")
    c = np.stack([X, Y, Z], -1).reshape(-1, 3)
    lo, hi = ROOM
    occ = ((c[:, :2] < lo[:2] + res) | (c[:, :2] > hi[:2] - res)).any(axis=1)
    for blo, bhi in OBSTACLES:
        occ |= np.all((c >= blo - res / 2) & (c <= bhi + res / 2), axis=1)
    octomap_bt.write_bt(path, np.round(c, 6), np.full(len(c), res), occ, res)
    return len(c)


def cli_phase(tmp: str, scans) -> dict:
    """The command line, ``la3dm_tpu_torch.cli.main`` in this process (so
    that the kernels' launch counts can be read), over the synthetic scans
    (60): ``static`` for each family (BGK and BGKL on both ingest paths),
    every export written, the family's kernels launched on the card, its
    checkpoint bit-equal to an in-process ``run_static(..., progress=...)``;
    ``static --profile-dir`` (BGK, 12 scans), whose trace must name K1′ and
    K2; ``query``, ``raycast`` (one K6 launch) and ``frontier`` on the BGK
    checkpoint, each equal to ``search``, ``raycast_device`` and
    ``frontier_leaves`` in process; ``server --once`` and ``bag`` on 12
    scans with a repeated pose, each equal to an in-process
    ``OnlineIntegrator`` with the same gated count; ``eval`` on 60 scans
    against the scene's truth (``auc`` > 0.6, 0 < ``coverage`` < 1) and at 3
    scans on the card and on the CPU (``gt_voxels`` equal, ``auc`` within
    1e-3, ``known`` equal but for voxels on the update gate's boundary,
    each shown with its added mass ≤ 1e-5); one subprocess, ``python -m
    la3dm_tpu_torch.cli static --method bgklv`` on 12 scans; ``entry()``'s
    step on the card, bit-equal to the pool its insert produced."""
    root = os.path.join(tmp, "cli")
    os.makedirs(root)
    n = len(scans)
    ds60 = write_dataset_yaml(os.path.join(root, "synth60.yaml"), tmp, n)
    ds = load_dataset_config(ds60)
    out = {"static": {}}

    for label, method, sets, kernels in CLI_STATIC:
        pre = os.path.join(root, label, "map")
        argv = ["static", "--method", method, "--dataset", ds60, "--out", pre]
        for s in sets:
            argv += ["--set", s]
        reset_counts()
        text, dt = run_cli(argv)
        got = all_counts()
        rate = float(next(ln for ln in text.splitlines()
                          if ln.startswith("Mapping finished")).split("(")[1].split()[0])
        require(text.count("Scan ") == n, f"static {label}: not {n} scans one by one")
        for suffix in CLI_EXPORTS:
            require(os.path.getsize(pre + suffix) > 0, f"static {label}: no {suffix}")
        # the same run in process, on the per-scan path the CLI takes
        cfg = load_method_config(method, **cli._parse_overrides(sets))
        reset_counts()
        res = pipeline.run_static(cfg, ds, progress=lambda i, dt: None)
        want = all_counts()
        res.map.save(pre + "_inproc.npz")
        require_same_npz(pre + "_map.npz", pre + "_inproc.npz", f"static {label}")
        once_a_scan = [k for k in ("bgk_heavy", "bgk_aligned_heavy", "bgk_light", "lv_rows",
                                   "gp_light") if k in kernels]
        require(got == want and all(got[k] > 0 for k in kernels)
                and all(got[k] == n for k in once_a_scan)
                and not any(v for k, v in got.items() if k not in kernels),
                f"static {label}: launches {got}, in process {want}")
        print(f"cli static {label}: {rate:.2f} scans/s (printed), launches {got}, "
              "checkpoint bit-equal to the in-process run", flush=True)
        out["static"][label] = {"seconds": dt, "scans_per_s": rate, "launches": got}

    n12 = min(n, 12)
    ds12 = write_dataset_yaml(os.path.join(root, "synth12.yaml"), tmp, n12)
    text, dt = run_cli(["static", "--method", "bgk", "--dataset", ds12,
                        "--profile-dir", os.path.join(root, "profile")])
    path = text.split("Chrome trace: ")[1].split(")")[0]
    with open(path) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"]
    seen = {k: sum(k in name for name in names)
            for k in ("bgk_aligned_heavy_kernel", "bgk_light_kernel")}
    print(f"cli static --profile-dir: {len(names)} kernels in {path}, {seen}", flush=True)
    require(seen == {"bgk_aligned_heavy_kernel": n12, "bgk_light_kernel": n12},
            f"the CLI's trace does not hold {n12} K1' and {n12} K2 launches: {seen}")
    out["profile"] = {"seconds": dt, "kernels_in_trace": len(names),
                      "trace_bytes": os.path.getsize(path)}

    # query, raycast and frontier on the BGK device-ingest checkpoint
    ckpt = os.path.join(root, "bgk_device", "map_map.npz")
    m = pipeline.build_map(load_method_config("bgk"))
    m.load(ckpt)
    rng = np.random.default_rng(5)
    hits = np.concatenate([c[rng.integers(0, len(c), 4)] for c, _ in scans[::6]])
    origins = np.stack([o for _, o in scans[::6]]).repeat(4, axis=0)
    words = [",".join(repr(float(v)) for v in p)
             for p in np.concatenate([hits, 0.5 * (hits + origins)])]
    pts = np.array([[float(x) for x in w.split(",")] for w in words])   # as the CLI reads
    text, dt = run_cli(["query", "--method", "bgk", "--checkpoint", ckpt, "--", *words])
    require(text.splitlines() == cli.query_lines(m, pts), "query differs from search()")
    out["query"] = {"seconds": dt, "points": len(pts)}

    n_rays = 400
    ri = rng.integers(0, len(scans), n_rays)
    r_o = np.stack([scans[i][1] for i in ri]).astype(np.float64)
    r_t = np.stack([scans[i][0][rng.integers(0, len(scans[i][0]))] for i in ri]).astype(np.float64)
    rays = np.concatenate([r_o, r_t], axis=1)
    reset_counts()
    text, dt = run_cli(["raycast", "--method", "bgk", "--checkpoint", ckpt, "--max-range",
                        str(MAX_RANGE), "--", *(",".join(repr(float(v)) for v in r) for r in rays)])
    launches = k6.launches
    ref = rc.raycast_device(m, r_o, r_t - r_o, max_range=MAX_RANGE)
    n_hit = int(ref["hit"].sum())
    require(launches == 1, f"raycast launched K6 {launches} times")
    require(text.splitlines() == cli.raycast_lines(ref) and n_hit > n_rays // 2,
            f"raycast differs from raycast_device ({n_hit} hits)")
    out["raycast"] = {"seconds": dt, "rays": n_rays, "hits": n_hit, "launches": launches}

    fpath = os.path.join(root, "frontier.csv")
    text, dt = run_cli(["frontier", "--method", "bgk", "--checkpoint", ckpt, "--out", fpath])
    f = pipeline.frontier_leaves(m, var_min=0.02, prob_max=0.3, z_min=0.3, z_max=1.0)
    markers.export_csv(fpath + ".inproc", f)
    with open(fpath, "rb") as a, open(fpath + ".inproc", "rb") as b:
        same = a.read() == b.read()
    count = json.loads(text.splitlines()[0])["frontier_voxels"]
    require(count == len(f["x"]) and same, "frontier differs from frontier_leaves()")
    out["frontier"] = {"seconds": dt, "frontier_voxels": count}
    del m

    # server and bag: 12 scans, the seventh at the sixth's pose
    online_scans = list(scans[:6]) + [scans[5]] + list(scans[6:n12 - 1])
    watch = os.path.join(root, "watch")
    os.makedirs(watch)
    for i, (cloud, origin) in enumerate(online_scans):
        save_pcd(os.path.join(watch, f"scan_{i:02d}.pcd"), cloud, origin)
    cfg = load_method_config("bgk")
    pre = os.path.join(root, "server", "map")
    os.makedirs(os.path.dirname(pre))
    reset_counts()
    text, dt = run_cli(["server", "--method", "bgk", "--watch", watch, "--once", "--out", pre])
    got = all_counts()
    online = pipeline.OnlineIntegrator(pipeline.build_map(cfg))
    for name in sorted(os.listdir(watch)):
        online.offer(*load_pcd_full(os.path.join(watch, name)))
    online.map.save(pre + "_inproc.npz")
    require_same_npz(pre + "_map.npz", pre + "_inproc.npz", "server")
    skipped = text.count("(motion gate)")
    require(skipped == online.n_skipped == 1 and got["bgk_light"] == online.n_integrated,
            f"server gated {skipped}, in process {online.n_skipped}; launches {got}")
    out["server"] = {"seconds": dt, "integrated": online.n_integrated, "gated": skipped,
                     "launches": got}

    bag = os.path.join(root, "scans.bag")
    write_bag(bag, online_scans)
    pre = os.path.join(root, "bag", "map")
    os.makedirs(os.path.dirname(pre))
    text, dt = run_cli(["bag", "--method", "bgk", "--bag", bag, "--out", pre])
    online = pipeline.OnlineIntegrator(pipeline.build_map(cfg))
    for cloud, origin, quat in rosbag.replay(bag, with_orientation=True):
        online.offer(cloud, origin, quat)
    online.map.save(pre + "_inproc.npz")
    require_same_npz(pre + "_map.npz", pre + "_inproc.npz", "bag")
    summary = next(ln for ln in text.splitlines() if "clouds integrated" in ln)
    require(summary.startswith(f"{online.n_integrated} clouds integrated "
                               f"({online.n_skipped} gated)") and online.n_skipped == 1,
            f"bag: {summary!r}, in process {online.n_integrated} / {online.n_skipped}")
    out["bag"] = {"seconds": dt, "integrated": online.n_integrated,
                  "gated": online.n_skipped}

    truth = os.path.join(root, "truth.bt")
    t0 = time.perf_counter()
    n_truth = scene_truth(truth)
    t_truth = time.perf_counter() - t0
    text, dt = run_cli(["eval", "--method", "bgk", "--dataset", ds60, "--ground-truth", truth])
    rep = json.loads(text.splitlines()[-1])
    require(rep["gt_voxels"] == n_truth and rep["auc"] > 0.6 and 0 < rep["coverage"] < 1,
            f"eval on 60 scans: {rep}")
    reps = {}
    for device in ("cuda", "cpu"):
        text, dt3 = run_cli(["eval", "--method", "bgk", "--dataset", ds60, "--scan-num", "3",
                             "--ground-truth", truth, "--device", device])
        reps[device] = {**json.loads(text.splitlines()[-1]), "seconds": dt3}
    card, host = reps["cuda"], reps["cpu"]
    # the same maps in process, read at the truth's voxels: a voxel known on
    # one side only must sit on the update gate's boundary, its added mass
    # ≤ 1e-5 on both (k̄ > 0 on the sparse kernel's clamp, where the card's
    # and the CPU's last ulp may decide apart; card_vs_cpu's rule)
    centers = octomap_bt.expand_to_voxels(octomap_bt.read_bt(truth))["centers"]
    ds3 = dataclasses.replace(ds, scan_num=3)
    cfg = load_method_config("bgk")
    at = {d: pipeline.run_static(cfg, ds3, device=d).map.search(centers.astype(np.float32))
          for d in ("cuda", "cpu")}
    apart = at["cuda"]["touched"] != at["cpu"]["touched"]
    mass = np.max([np.abs(at[d][k] - p)[apart] for d in at
                   for k, p in (("A", cfg.prior_A), ("B", cfg.prior_B))], axis=0,
                  initial=0.0)
    ties = {"voxels": int(apart.sum()), "card_only": int((apart & at["cuda"]["touched"]).sum()),
            "largest_mass": float(mass.max(initial=0.0))}
    print(f"cli eval, 3 scans: card {card}, cpu {host}; known on one side only "
          f"{ties}", flush=True)
    require(all(int(at[d]["touched"].sum()) == reps[d]["known"] for d in at),
            "eval: the in-process maps do not reproduce the reports")
    require(card["gt_voxels"] == host["gt_voxels"] and abs(card["auc"] - host["auc"]) <= 1e-3
            and card["known"] - host["known"] == 2 * ties["card_only"] - ties["voxels"]
            and ties["largest_mass"] <= 1e-5,
            "eval: card and CPU differ beyond the gate boundary")
    out["eval"] = {"seconds": dt, "truth_seconds": t_truth, "report": rep, "scans3": reps,
                   "known_apart_at_gate": ties}

    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "la3dm_tpu_torch.cli", "static", "--method",
                        "bgklv", "--dataset", ds12],
                       capture_output=True, text=True, timeout=300,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    dt = time.perf_counter() - t0
    line = next((ln for ln in r.stdout.splitlines() if ln.startswith("Mapping finished")), "")
    print(f"cli subprocess static --method bgklv, 12 scans: exit {r.returncode} in {dt:.2f} s; "
          f"{line}; stderr {r.stderr[-300:]!r}", flush=True)
    require(r.returncode == 0 and line, "python -m la3dm_tpu_torch.cli static failed")
    out["subprocess"] = {"seconds": dt, "scans_per_s": float(line.split("(")[1].split()[0])}

    # the single-card entry: the BGK step (K1, K2) on its captured arguments
    # gives the pool its insert produced
    step, args = entry()
    reset_counts()
    got = step(*args)
    torch.cuda.synchronize()
    launches = {"bgk_heavy": bgk_heavy.launches, "bgk_light": bgk_light.launches}
    m = pipeline.build_map(load_method_config("bgk", max_range=8.0, device_ingest="off"))
    m.insert_pointcloud(*tiny_scan(400))
    pool = (m.pool.fields["A"], m.pool.fields["B"], m.pool.touched, m.pool.eff_level)
    same = all(torch.equal(a, b) for a, b in zip(got, pool))
    print(f"entry(): step launches {launches}, its pool bit-equal to the insert's {same} "
          f"({m.pool.n_blocks} blocks)", flush=True)
    require(same and launches == {"bgk_heavy": 1, "bgk_light": 1}, "entry() step differs")
    out["entry"] = {"launches": launches, "blocks": m.pool.n_blocks}
    return out



# ---------------------------------------------------------------- sharding

#: shards of phase 30's one-process meshes (``block_mesh(SHARDS)`` on cuda:0)
SHARDS = 4


def keyed_state(m) -> dict:
    """A map's blocks in coordinate order: coords, every field, touched and
    eff_level as host arrays (raster voxel order)."""
    slots = np.asarray(m.pool.active_slots())
    coords = m.pool.coords[slots]
    order = np.lexsort((coords[:, 2], coords[:, 1], coords[:, 0]))
    slots = slots[order]
    out = {"coords": coords[order], "touched": m._gather_rows(m.pool.touched, slots),
           "eff_level": m._gather_rows(m.pool.eff_level, slots)}
    for k, v in m.pool.fields.items():
        out[f"field_{k}"] = m._gather_rows(v, slots)
    return out


def keyed_npz(path: str) -> dict:
    """A checkpoint's arrays, its blocks in coordinate order."""
    data = npz_arrays(path)
    c = data["coords"]
    order = np.lexsort((c[:, 2], c[:, 1], c[:, 0]))
    return {k: v[order] for k, v in data.items() if k != "config"}


def require_same_state(a: dict, b: dict, what: str) -> int:
    """Two keyed states hold the same blocks and the same bits in every
    array; returns the block count."""
    require(sorted(a) == sorted(b), f"{what}: the arrays differ")
    for k in a:
        x, y = np.ascontiguousarray(a[k]), np.ascontiguousarray(b[k])
        same = (x.shape == y.shape and x.dtype == y.dtype
                and np.array_equal(x.view(np.uint8), y.view(np.uint8)))
        require(same, f"{what}: {k} differs from the unsharded map's")
    return len(a["coords"])


def step_log(m) -> list:
    """Record each engine dispatch of the unsharded map ``m`` as a dict of
    its test blocks' (or tiles') ``coords``, scan starts ``ss`` and counts
    ``sc``, and for GP its models' target rows ``nb`` and point ``counts``,
    by wrapping the family's step on the instance."""
    log = []

    def wrap(name, pick):
        step = getattr(m, name)

        def recorded(*a, **kw):
            slots, ss, sc, *models = pick(*a)
            if torch.is_tensor(slots):  # device ingest's slots: copied back here
                slots = slots.cpu().numpy()
            rec = {"coords": m.pool.coords[np.asarray(slots, np.int64)].copy(),
                   "ss": list(ss), "sc": list(sc)}
            if models:  # the device's nb is copied on the device: no sync
                nb, counts = models
                rec["nb"] = nb.clone() if torch.is_tensor(nb) else np.array(nb)
                rec["counts"] = np.array(counts)
            log.append(rec)
            return step(*a, **kw)

        setattr(m, name, recorded)

    if isinstance(m, BGKLVOctoMap):
        wrap("_lv_step", lambda e, lab, ids, tiles: (tiles["slots"], [0],
                                                     [len(tiles["slots"])]))
    elif isinstance(m, GPOctoMap):
        wrap("_gp_step", lambda *a: (a[6], a[8], a[9], a[4], a[5]))
    else:
        wrap("_host_step", lambda cat, ss, sc: (cat["slots"], ss, sc))
        wrap("_ingest_step", lambda tabs, slots, ss, sc: (slots, ss, sc))
    return log


def gp_tier_launches(nb, counts, shard: np.ndarray) -> int:
    """K4's launches on a sharded GP map for one dispatch: for each shard
    with a test block, one per size tier and per counted / uncounted half
    that holds a model serving it (a model is counted on the lowest shard it
    serves).  ``nb`` [M, G] indexes the dispatch's test blocks (their
    ``shard``; an index past them serves none), ``counts`` [M] the models'
    points."""
    nb = nb.cpu().numpy() if torch.is_tensor(nb) else np.asarray(nb)
    T = len(shard)
    owner = np.append(shard, np.iinfo(np.int64).max)[np.minimum(nb.astype(np.int64), T)]
    home = owner.min(axis=1)
    base = counts <= gp_heavy.BASE_MAX_C
    n = 0
    for d in np.unique(shard):
        serves = (owner == d).any(axis=1)
        for tier in (base, ~base):
            for half in (home == d, home != d):
                n += int((serves & tier & half).any())
    return n


def expected_launches(log, sm, rule: str) -> int:
    """The launches a sharded map ``sm`` (no relayout since its first
    block) owes for the dispatches of ``log`` of a kernel whose ``rule`` is
    "dispatch" (once per dispatch and shard with a block), "scan" (once per
    scan and shard with a block of it) or "tier" (GP's K4,
    :func:`gp_tier_launches`)."""
    n = 0
    for rec in log:
        slots = sm.pool.lookup(rec["coords"])
        require((slots >= 0).all(), "a block of the unsharded map is not in the sharded map")
        shard = slots // sm.pool.chunk
        if rule == "dispatch":
            n += len(np.unique(shard))
        elif rule == "scan":
            n += sum(len(np.unique(shard[a:a + c])) for a, c in zip(rec["ss"], rec["sc"]))
        else:
            n += gp_tier_launches(rec["nb"], rec["counts"], shard)
    return n


#: phase 30's cases: (label, method YAML, device_ingest, scans, the kernels
#: counted as (counter module, CUDA name for torch.profiler or None, launch
#: rule of :func:`expected_launches`))
SHARD_CASES = (
    ("bgk_host", "bgk", "off", 60, ((bgk_heavy, "bgk_heavy_kernel", "dispatch"),
                                    (bgk_light, "bgk_light_kernel", "scan"))),
    ("bgk_device", "bgk", "auto", 60,
     ((bgk_aligned_heavy, "bgk_aligned_heavy_kernel", "dispatch"),
      (bgk_light, "bgk_light_kernel", "scan"))),
    ("bgkl_host", "bgkl", "off", 12, ((bgk_heavy, "bgk_heavy_seg_kernel", "dispatch"),
                                      (bgk_light, "bgk_light_kernel", "scan"))),
    ("bgkl_device", "bgkl", "auto", 12,
     ((bgk_aligned_heavy, "bgk_aligned_heavy_kernel", "dispatch"),
      (bgk_light, "bgk_light_kernel", "scan"))),
    # K4 is one launch a call of its wrapper but a factorisation kernel and
    # a prediction kernel a chunk of models: counted by the wrapper alone
    ("gp_host", "gp", "off", 12, ((gp_heavy, None, "tier"),
                                  (gp_light, "gp_light_kernel", "scan"))),
    ("gp_device", "gp", "auto", 12, ((gp_heavy, None, "tier"),
                                     (gp_light, "gp_light_kernel", "scan"))),
    ("bgklv_host", "bgklv", "auto", 12, ((lv_rows, "lv_rows_acc_kernel", "dispatch"),)),
    # original_size: one scan a dispatch, and K8 after each K3
    ("bgklv_large", "bgklvoctomap_large_map", "auto", 12,
     ((lv_rows, "lv_rows_acc_kernel", "dispatch"),
      (lv_prune, "lv_prune_kernel", "dispatch"))),
)


def sharded_case(label, yaml, ingest, n_scans, kernels, pcd_dir: str) -> dict:
    """(a): ``run_static`` of the family's YAML on the unsharded map and on
    a ``block_mesh(SHARDS)`` map of ample capacity; bit-equal maps; each of
    ``kernels`` launched as its rule says for the unsharded map's
    dispatches, by the wrappers' counters and (where it has a CUDA name)
    again by torch.profiler on a last sharded run.  Timed runs in the order
    unsharded, sharded, sharded, unsharded, each on a fresh map."""
    from la3dm_tpu_torch.parallel import mesh as pm, sharded_map as smod

    cfg = load_method_config(yaml, max_range=MAX_RANGE, device_ingest=ingest)
    method = cfg.method
    cls = {"bgk": smod.ShardedBGKOctoMap, "bgkl": smod.ShardedBGKLOctoMap,
           "gp": smod.ShardedGPOctoMap, "bgklv": smod.ShardedBGKLVOctoMap}[method]
    ds = DatasetConfig(name="synth", dir=pcd_dir, prefix="synth", scan_num=n_scans,
                       max_range=cfg.max_range)
    um = pipeline.MAP_CLASSES[method](cfg)
    log = step_log(um)
    ures = [pipeline.run_static(cfg, ds, map_obj=um)]
    cap = 4 * um.pool.n_blocks

    def sharded_run():
        return pipeline.run_static(cfg, ds, map_obj=cls(cfg, mesh=pm.block_mesh(SHARDS),
                                                        capacity=cap))

    reset_counts()
    res = [sharded_run()]
    sm = res[0].map
    counted = {mod.__name__.rsplit(".", 1)[1]: mod.launches for mod, _, _ in kernels}
    require(sm.pool.generation == 0, f"{label}: the sharded pool was re-laid out")
    want, prof_want = {}, {}
    for mod, cuda_name, rule in kernels:
        name = mod.__name__.rsplit(".", 1)[1]
        want[name] = expected_launches(log, sm, rule)
        require(counted[name] == want[name] > 0,
                f"{label}: {name} launched {counted[name]} times, expected {want[name]}")
        if cuda_name:
            prof_want[cuda_name] = want[name]
    n_blocks = require_same_state(keyed_state(sm), keyed_state(um), f"sharded {label}")
    per_shard = np.bincount(sm.pool.active_slots() // sm.pool.chunk, minlength=SHARDS)
    res.append(sharded_run())
    ures.append(pipeline.run_static(cfg, ds, map_obj=pipeline.MAP_CLASSES[method](cfg)))
    profiled(sharded_run, prof_want)
    if method == "gp":
        require(int(sm.failed_models) == int(um.failed_models) == 0,
                f"{label}: failed factorisations")
    out = {"scans": n_scans, "seconds": [r.total_seconds for r in res],
           "scans_per_s": [r.scans_per_second for r in res],
           "unsharded_seconds": [r.total_seconds for r in ures],
           "unsharded_scans_per_s": [r.scans_per_second for r in ures],
           "blocks": n_blocks, "blocks_per_shard": per_shard.tolist(),
           "dispatches": len(log), "launches": counted, "expected": want,
           "profiler": prof_want}
    print(f"sharded {label} ({SHARDS} shards, {n_scans} scans): bit-equal over {n_blocks} "
          f"blocks {per_shard.tolist()}; scans/s {out['scans_per_s']} (unsharded, first and "
          f"last {out['unsharded_scans_per_s']}); launches {counted}, expected {want} over "
          f"{len(log)} dispatches; profiler {prof_want}", flush=True)
    return out


def grow_and_rebalance(m, scans, sharded: bool) -> list:
    """Scans 0-11 in one batched insert, then 12-15 one at a time, each
    after a ``rebalance()`` of a sharded map; returns each rebalance's
    (max, mean + heaviest block) of the shards' touched voxels."""
    m.insert_pointclouds([c for c, _ in scans[:12]], [o for _, o in scans[:12]])
    bounds = []
    for cloud, origin in scans[12:16]:
        if sharded:
            m.rebalance()
            block = m.pool.whole_rows(m.pool.touched).sum(dim=1, dtype=torch.float64)
            block = block.cpu().numpy()
            per = block.reshape(m.pool.n_shards, -1).sum(axis=1)
            bounds.append((float(per.max()), float(per.mean() + block.max())))
        m.insert_pointcloud(cloud, origin)
    return bounds


def pcd_scans(pcd_dir: str, n: int) -> list:
    return [load_pcd(os.path.join(pcd_dir, f"synth_{i}.pcd")) for i in range(1, n + 1)]


def growth_case(method: str, pcd_dir: str) -> dict:
    """(b): from ``capacity=16`` on the host path (growth inside a batched
    insert re-resolves the earlier scans' slots), then ``rebalance()``
    between scans: bit-equal, generation moved, the LPT bound held."""
    from la3dm_tpu_torch.parallel import mesh as pm, sharded_map as smod

    cfg = load_method_config(method, max_range=MAX_RANGE, device_ingest="off")
    cls = {"bgk": smod.ShardedBGKOctoMap, "gp": smod.ShardedGPOctoMap}[method]
    scans = pcd_scans(pcd_dir, 16)
    um = pipeline.MAP_CLASSES[method](cfg)
    t0 = time.perf_counter()
    grow_and_rebalance(um, scans, False)
    um.synchronize()
    t_u = time.perf_counter() - t0
    sm = cls(cfg, mesh=pm.block_mesh(SHARDS), capacity=16)
    t0 = time.perf_counter()
    bounds = grow_and_rebalance(sm, scans, True)
    sm.synchronize()
    t_s = time.perf_counter() - t0
    n_blocks = require_same_state(keyed_state(sm), keyed_state(um), f"growth {method}")
    require(sm.pool.capacity > 16 and sm.pool.generation >= 5,
            f"growth {method}: capacity {sm.pool.capacity}, generation {sm.pool.generation}")
    require(all(mx <= lim + 1e-9 for mx, lim in bounds), f"growth {method}: LPT bound {bounds}")
    print(f"sharded growth {method}: bit-equal over {n_blocks} blocks, capacity 16 -> "
          f"{sm.pool.capacity}, generation {sm.pool.generation}; shard loads (max, bound) "
          f"{bounds}; {t_s:.3f} s (unsharded {t_u:.3f} s) for 16 scans", flush=True)
    return {"scans": 16, "seconds": t_s, "unsharded_seconds": t_u, "blocks": n_blocks,
            "capacity": sm.pool.capacity, "generation": sm.pool.generation,
            "lpt_max_and_bound": bounds}


def sharded_worker(argv) -> int:
    """One rank of (d) or (e), run as ``chip_smoke.py --sharded-worker
    <init_method> <world> <rank> <backend> <pcd_dir> <out_dir>``: 2 shards
    on cuda:0 (gloo) or cuda:<rank> (nccl), BGK and GP on their YAML (device
    ingest) from ``capacity=16`` as :func:`grow_and_rebalance`; process 0
    saves each map."""
    from la3dm_tpu_torch.parallel import distributed, sharded_map as smod

    init, world, rank, backend, pcd_dir, out = argv
    world, rank = int(world), int(rank)
    device = "cuda:0" if backend == "gloo" else f"cuda:{rank}"
    distributed.initialize(backend=backend, init_method=init, rank=rank, world_size=world,
                           device=device)
    mesh = distributed.global_mesh(shards_per_rank=2, device=device)
    scans = pcd_scans(pcd_dir, 16)
    for method, cls in (("bgk", smod.ShardedBGKOctoMap), ("gp", smod.ShardedGPOctoMap)):
        m = cls(load_method_config(method, max_range=MAX_RANGE), mesh=mesh, capacity=16)
        t0 = time.perf_counter()
        bounds = grow_and_rebalance(m, scans, True)
        m.synchronize()
        dt = time.perf_counter() - t0
        require(all(mx <= lim + 1e-9 for mx, lim in bounds), f"rank {rank}: LPT bound")
        m.save(os.path.join(out, f"{method}_{backend}.npz"))
        print(json.dumps({"rank": rank, "method": method, "seconds": dt,
                          "capacity": m.pool.capacity, "generation": m.pool.generation}),
              flush=True)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def ranks_case(backend: str, pcd_dir: str, out: str) -> dict:
    """(d) gloo, two ranks on cuda:0, or (e) nccl, one card each: two
    subprocesses of :func:`sharded_worker`; process 0's checkpoints bit-equal
    to the unsharded maps of the same inserts."""
    init = f"tcp://localhost:{free_port()}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--sharded-worker",
                               init, "2", str(r), backend, pcd_dir, out],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    for p, (o, e) in zip(procs, outs):
        require(p.returncode == 0, f"a {backend} rank failed:\n{o[-2000:]}\n{e[-4000:]}")
    rows = [json.loads(line) for o, _ in outs for line in o.splitlines()
            if line.startswith("{")]
    scans = pcd_scans(pcd_dir, 16)
    res = {"wall_s": wall, "ranks": rows}
    for method in ("bgk", "gp"):
        um = pipeline.MAP_CLASSES[method](load_method_config(method, max_range=MAX_RANGE))
        grow_and_rebalance(um, scans, False)
        path = os.path.join(out, f"{method}_unsharded.npz")
        um.save(path)
        n = require_same_state(keyed_npz(os.path.join(out, f"{method}_{backend}.npz")),
                               keyed_npz(path), f"{backend} ranks {method}")
        res[f"{method}_blocks"] = n
    print(f"sharded {backend}: 2 ranks x 2 shards, BGK and GP (device ingest, 16 scans, "
          f"growth and rebalance) bit-equal to the unsharded maps; {wall:.1f} s with the "
          f"ranks' start; ranks {rows}", flush=True)
    return res


def nccl_one_rank(pcd_dir: str, tmp: str) -> dict:
    """(c): a one-rank NCCL group (file store) over 4 shards on cuda:0, BGK
    on its YAML (device ingest) as :func:`grow_and_rebalance`, so that the
    relayouts, the load gathers and the checkpoint's reads run on NCCL."""
    from la3dm_tpu_torch.parallel import distributed, sharded_map as smod

    distributed.initialize(backend="nccl", init_method=f"file://{tmp}/nccl_store", rank=0,
                           world_size=1, device="cuda:0")
    try:
        mesh = distributed.global_mesh(shards_per_rank=SHARDS, device="cuda:0")
        require(torch.distributed.get_backend() == "nccl" and mesh.distributed,
                "the one-rank group is not on NCCL")
        cfg = load_method_config("bgk", max_range=MAX_RANGE)
        scans = pcd_scans(pcd_dir, 16)
        sm = smod.ShardedBGKOctoMap(cfg, mesh=mesh, capacity=16)
        t0 = time.perf_counter()
        grow_and_rebalance(sm, scans, True)
        sm.synchronize()
        dt = time.perf_counter() - t0
        um = pipeline.MAP_CLASSES["bgk"](cfg)
        grow_and_rebalance(um, scans, False)
        a, b = os.path.join(tmp, "nccl_sharded.npz"), os.path.join(tmp, "nccl_unsharded.npz")
        sm.save(a)
        um.save(b)
        n = require_same_state(keyed_npz(a), keyed_npz(b), "one-rank NCCL BGK")
    finally:
        torch.distributed.destroy_process_group()
    print(f"sharded nccl (one rank, {SHARDS} shards): BGK 16 scans bit-equal over {n} "
          f"blocks, generation {sm.pool.generation}; {dt:.3f} s", flush=True)
    return {"scans": 16, "seconds": dt, "blocks": n, "generation": sm.pool.generation}


def sharded_phase(pcd_dir: str, tmp: str, smi: str) -> dict:
    """Phase 30 (module docstring)."""
    from la3dm_tpu_torch.entry import dryrun_multichip

    t0 = time.perf_counter()
    out = {"card": smi, "shards": SHARDS, "cases": {}}
    for label, yaml, ingest, n, kernels in SHARD_CASES:
        out["cases"][label] = sharded_case(label, yaml, ingest, n, kernels, pcd_dir)
    out["growth"] = {m: growth_case(m, pcd_dir) for m in ("bgk", "gp")}
    out["nccl_one_rank"] = nccl_one_rank(pcd_dir, tmp)
    out["gloo_two_ranks"] = ranks_case("gloo", pcd_dir, tmp)
    if torch.cuda.device_count() >= 2:
        out["nccl_two_cards"] = ranks_case("nccl", pcd_dir, tmp)
    else:
        out["nccl_two_cards"] = None
        print("sharded: NCCL across cards did not run (one card)", flush=True)
    out["dryrun_multichip"] = dryrun_multichip(SHARDS)
    out["seconds"] = time.perf_counter() - t0
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.lib()
    t_kern = time.perf_counter() - t0
    t0 = time.perf_counter()
    native._load()
    t_host = time.perf_counter() - t0
    print(f"build: kernels {t_kern:.1f} s, host library {t_host:.1f} s")
    if _build.build_log:
        print(_build.build_log.strip())

    # the host-ingest phases name ``device_ingest: off``; the default on a
    # CUDA map is device ingest, whose phases follow each family's
    cfg = load_method_config("bgk", max_range=MAX_RANGE, device_ingest="off")
    cfg_on = load_method_config("bgk", max_range=MAX_RANGE)
    with tempfile.TemporaryDirectory(prefix="la3dm_smoke_") as tmp:
        t0 = time.perf_counter()
        scans = synthetic_scans(60)
        write_pcds(scans, tmp)
        print(f"scenes: 60 scans × {len(scans[0][0])} beams "
              f"({time.perf_counter() - t0:.1f} s)")

        stamp("BGK host ingest: K1, K2")
        args, statics = capture_dispatch(cfg, scans[:16], "cuda")
        k1 = check_k1(args, statics)
        acc = k1.pop("acc")
        k2 = check_k2(args, statics, acc)
        k2.update(check_k2_pools(args, statics, acc, "16-scan demo dispatch"))
        del args, acc
        stamp("BGK host ingest with predict (G = 27): K2")
        args, statics = capture_dispatch(
            load_method_config("bgk", max_range=MAX_RANGE, device_ingest="off", predict=True),
            scans[:16], "cuda")
        require(statics["G"] == 27, "predict: true does not give 27 slots a block")
        (_, _, _, _, all_nodes, _, ent, lab, ids, gs, rb, rs, rn, _, ctr, _, _) = args
        acc = bgk_heavy.bgk_heavy(ent, lab, ids, gs, rb, rs, rn, ctr, all_nodes,
                                  G=statics["G"], sf2=statics["sf2"], ell=statics["ell"])
        k2_27 = check_k2(args, statics, acc, reps=2,
                         what="16-scan demo dispatch, predict (G = 27)")
        k2_27.update(check_k2_pools(args, statics, acc,
                                    "16-scan demo dispatch, predict (G = 27)"))
        del args, acc

        stamp("BGK host ingest: main path, profile, card vs CPU")
        path = main_path(cfg, tmp, scans)
        path["host_syncs_per_dispatch"] = host_syncs(cfg, scans[:16])
        print(f"bgk host ingest: host syncs in a 16-scan dispatch "
              f"{path['host_syncs_per_dispatch']}")
        path["profile60"] = profile_main_path(
            cfg, tmp, {"bgk_heavy": "bgk_heavy_kernel", "bgk_light": "bgk_light_kernel"},
            path["static60"]["launches"])
        # one scan (three before device ingest joined the script): the CPU's
        # K1 pass takes about 5 s a scan; the device-ingest comparison below
        # keeps three
        dev = card_vs_cpu(cfg, tmp, n_scans=1)

        stamp("BGK device ingest: K7a, K7b, K7c, K7s, K7t, K7w, K1'")
        calls = record_ingest(cfg_on, scans[:16])
        k7 = check_k7(calls, "16-scan BGK demo dispatch")
        k7w = check_k7w(calls, "16-scan BGK demo dispatch")
        k1p = check_k1p(calls)
        del calls
        stamp("BGK device ingest: main path, host syncs, profile, card vs CPU")
        path_on = main_path_ingest(cfg_on, tmp, scans)
        path_on["host_syncs_per_dispatch"] = ingest_syncs(cfg_on, scans[:16], "bgk")
        ingest_names = {"ingest_points": "ingest_points_kernel",
                        "ingest_beams": "ingest_beams_kernel",
                        "ingest_downsample": "ingest_downsample_kernel",
                        "ingest_members": "ingest_members_kernel",
                        "ingest_sort": "ingest_sort_", "ingest_bucket": "ingest_bucket_kernel",
                        "ingest_slots": "ingest_slots_"}
        d60 = path_on["static60"]["launches"]["ingest_members"]
        path_on["profile60"] = profile_main_path(
            cfg_on, tmp, {**ingest_names, "bgk_aligned_heavy": "bgk_aligned_heavy_kernel",
                          "bgk_light": "bgk_light_kernel"},
            {"ingest_points": d60, "ingest_beams": d60, "ingest_downsample": 2 * d60,
             "ingest_members": d60, "ingest_sort": path_on["static60"]["ingest_sort_kernels"],
             "ingest_bucket": d60, "ingest_slots": 2 * d60, "bgk_aligned_heavy": d60,
             "bgk_light": 60})
        dev_on = card_vs_cpu(load_method_config("bgk", max_range=MAX_RANGE,
                                                device_ingest="on"), tmp, tol=(1e-5, 1e-5))

        cfg_l = load_method_config("bgkl", max_range=MAX_RANGE, device_ingest="off")
        cfg_l_on = load_method_config("bgkl", max_range=MAX_RANGE)
        stamp("BGKL host ingest: K1 (segments)")
        args, statics = capture_dispatch(cfg_l, scans[:16], "cuda")
        k1s = check_k1(args, statics, gate=statics["gate"])
        k1s.pop("acc")
        del args
        stamp("BGKL host ingest: main path, host syncs, profile, card vs CPU")
        path_l = main_path(cfg_l, tmp, scans)
        path_l["host_syncs_per_dispatch"] = host_syncs(cfg_l, scans[:16])
        print(f"bgkl host ingest: host syncs in a 16-scan dispatch "
              f"{path_l['host_syncs_per_dispatch']}")
        path_l["profile60"] = profile_main_path(
            cfg_l, tmp,
            {"bgk_heavy": "bgk_heavy_seg_kernel", "bgk_light": "bgk_light_kernel"},
            path_l["static60"]["launches"])
        # one scan: the CPU's segment heavy pass takes about 6 s a scan
        dev_l = card_vs_cpu(cfg_l, tmp, n_scans=1, tol=(1e-5, 1e-5),
                            control=(bgk_heavy, "bgk_heavy", tf32_k1))

        stamp("BGKL device ingest: K7d, K7b, K7s, K7t, K7w, K1' (segments)")
        calls = record_ingest(cfg_l_on, scans[:16])
        k7d = check_k7d(calls, "16-scan BGKL demo dispatch")
        k7_l = check_k7_segments(calls, "16-scan BGKL demo dispatch")
        k7w_l = check_k7w(calls, "16-scan BGKL demo dispatch")
        k1ps = check_k1p(calls, gate=statics["gate"])
        del calls
        stamp("BGKL device ingest: main path, host syncs, profile, card vs CPU")
        path_l_on = main_path_ingest(cfg_l_on, tmp, scans)
        path_l_on["host_syncs_per_dispatch"] = ingest_syncs(cfg_l_on, scans[:16], "bgkl")
        d60 = path_l_on["static60"]["launches"]["ingest_members"]
        path_l_on["profile60"] = profile_main_path(
            cfg_l_on, tmp, {"ingest_points": "ingest_points_kernel",
                            "ingest_downsample": "ingest_downsample_kernel",
                            "ingest_rays": "ingest_rays_",
                            "ingest_members": "ingest_members_kernel",
                            "ingest_sort": "ingest_sort_",
                            "ingest_bucket": "ingest_bucket_kernel",
                            "ingest_slots": "ingest_slots_",
                            "bgk_aligned_heavy": "bgk_aligned_heavy_kernel",
                            "bgk_light": "bgk_light_kernel"},
            {"ingest_points": d60, "ingest_downsample": d60, "ingest_rays": 2 * d60,
             "ingest_members": d60,
             "ingest_sort": path_l_on["static60"]["ingest_sort_kernels"],
             "ingest_bucket": d60, "ingest_slots": 2 * d60, "bgk_aligned_heavy": d60,
             "bgk_light": 60})
        dev_l_on = card_vs_cpu(load_method_config("bgkl", max_range=MAX_RANGE,
                                                  device_ingest="on"), tmp, n_scans=2,
                               tol=(1e-5, 1e-5),
                               control=(bgk_aligned_heavy, "bgk_aligned_heavy", tf32_k1p))

        cfg_lv = load_method_config("bgklv", max_range=MAX_RANGE)
        cfg_large = load_method_config("bgklvoctomap_large_map", max_range=MAX_RANGE)
        stamp("BGKLV: K3, K8")
        m = capture_lv(cfg_lv, scans[:12])
        k3 = check_k3(*m._last_step_call)
        m = capture_lv(cfg_large, scans[:4])
        stamp("BGKLV large map (block_depth 6): K3 on one scan's dispatch, K8")
        k3_l = check_k3(*m._last_step_call)
        k8 = check_k8(*m._last_prune_call)
        del m

        stamp("BGKLV: main path, profile, card vs CPU")
        path_lv = main_path_lv(cfg_lv, cfg_large, tmp, scans)
        path_lv["profile60"] = profile_main_path(
            cfg_lv, tmp,
            {"lv_rows": "lv_rows_acc_kernel", "lv_rows_apply": "lv_rows_apply_kernel"},
            {"lv_rows": path_lv["static60"]["launches"]["lv_rows"],
             "lv_rows_apply": path_lv["static60"]["launches"]["lv_rows"]})
        # one scan (three before GP joined the script): the CPU's LV pass
        # takes about 10 s a scan
        dev_lv = card_vs_cpu(cfg_lv, tmp, n_scans=1)

        cfg_gp = load_method_config("gp", max_range=MAX_RANGE, device_ingest="off")
        cfg_gp_on = load_method_config("gp", max_range=MAX_RANGE)
        cfg_gp_large = load_method_config("gpoctomap_large_map", max_range=MAX_RANGE,
                                          device_ingest="off")
        stamp("GP host ingest: K4 (base and overflow tiers), K5")
        args, statics = capture_gp(cfg_gp, scans[:16])
        k4 = check_k4(args, statics, "16-scan demo dispatch")
        tables = k4.pop("tables")
        k5 = check_k5(args, statics, tables, "16-scan demo dispatch")
        k5.update(check_k5_pools(args, statics, tables, "16-scan demo dispatch"))
        args, statics = capture_gp(cfg_gp_large, scans[:12])
        require(len(args[8]) == 2, "the large-map dispatch has no overflow tier")
        k4_l = check_k4(args, statics, "12-scan large-map dispatch", reps=1)
        tables = k4_l.pop("tables")
        k5_l = check_k5(args, statics, tables, "12-scan large-map dispatch")
        k5_l.update(check_k5_pools(args, statics, tables, "12-scan large-map dispatch"))
        del tables
        args, statics = capture_gp(cfg_gp_large, training=dense_block())
        k4_d = check_k4(args, statics, "a forced 300-point block", reps=1)
        k4_d.pop("tables")
        del args

        stamp("GP host ingest: main path")
        path_gp = main_path_gp(cfg_gp, cfg_gp_large, tmp, scans)
        path_gp["host_syncs_per_dispatch"] = host_syncs(cfg_gp, scans[:16])
        print(f"gp host ingest: host syncs in a 16-scan dispatch "
              f"{path_gp['host_syncs_per_dispatch']}")
        path_gp["profile60"] = profile_main_path(
            cfg_gp, tmp, {"gp_heavy": "gp_heavy_kernel", "gp_heavy_factor": "gp_factor",
                          "gp_light": "gp_light_kernel"},
            path_gp["static60"]["launches"])
        stamp("GP host ingest: card vs CPU")
        dev_gp = card_vs_cpu_gp(cfg_gp, tmp)

        stamp("GP device ingest: K7a, K7b, K7c, K7s, K7t, K7w")
        calls = record_ingest(cfg_gp_on, scans[:16])
        k7_gp = check_k7(calls, "16-scan GP demo dispatch")
        k7w_gp = check_k7w(calls, "16-scan GP demo dispatch")
        del calls
        stamp("GP device ingest: main path, host syncs, profile, card vs CPU")
        path_gp_on = main_path_ingest(cfg_gp_on, tmp, scans)
        path_gp_on["host_syncs_per_dispatch"] = ingest_syncs(cfg_gp_on, scans[:16], "gp")
        d60 = path_gp_on["static60"]["launches"]["ingest_members"]
        path_gp_on["profile60"] = profile_main_path(
            cfg_gp_on, tmp, {**ingest_names, "gp_heavy": "gp_heavy_kernel",
                             "gp_heavy_factor": "gp_factor",
                             "gp_light": "gp_light_kernel"},
            {"ingest_points": d60, "ingest_beams": d60, "ingest_downsample": 2 * d60,
             "ingest_members": d60,
             "ingest_sort": path_gp_on["static60"]["ingest_sort_kernels"],
             "ingest_bucket": d60, "ingest_slots": 2 * d60,
             "gp_heavy": path_gp_on["static60"]["launches"]["gp_heavy"], "gp_light": 60})
        dev_gp_on = card_vs_cpu_gp(load_method_config("gp", max_range=MAX_RANGE,
                                                      device_ingest="on"), tmp)

        stamp("raycast: K6 over 1,000,000 rays on the BGK demo map, 100,000 on the BGKL "
              "and BGKLV maps")
        ds60 = DatasetConfig(name="synth", dir=tmp, prefix="synth", scan_num=60,
                             max_range=MAX_RANGE)
        rays = {"bgk": check_k6(pipeline.run_static(cfg_on, ds60).map, scans, RAYS_MAIN,
                                "BGK demo map, 60 scans", host_subset=2000, seed=1),
                "bgkl": check_k6(pipeline.run_static(cfg_l_on, ds60).map, scans, RAYS_OTHER,
                                 "BGKL demo map, 60 scans", host_subset=500, seed=2),
                "bgklv": check_k6(pipeline.run_static(cfg_lv, ds60).map, scans, RAYS_OTHER,
                                  "BGKLV demo map, 60 scans", host_subset=500, seed=3)}

        # the large maps at their YAML's own max_range (30 m; every hit of the
        # room lies within about 17.5 m), GP at block_depth 5 at the GP large
        # map's 8 m
        cfg_ll = load_method_config("bgkloctomap_large_map", device_ingest="off")
        cfg_ll_on = load_method_config("bgkloctomap_large_map")
        stamp("BGKL large map (block_depth 5, 16^3 voxels a block): K1 (segments), K2")
        args, statics = capture_dispatch(cfg_ll, scans[:12], "cuda")
        k1_ll = check_k1(args, statics, reps=2, gate=statics["gate"])
        acc = k1_ll.pop("acc")
        mem_ll = table_bytes("K1 accumulator [T, Vall, 2G] f32, 12-scan BGKL large-map "
                             "dispatch", acc.shape[0], acc.shape[1] * acc.shape[2] * 4, 12)
        k2_ll = check_k2(args, statics, acc, what="12-scan BGKL large-map dispatch")
        k2_ll.update(check_k2_pools(args, statics, acc, "12-scan BGKL large-map dispatch"))
        del args, acc
        stamp("BGKL large map: K1' (segments), K7d, K7b, K7s, K7t on a 12-scan "
              "device-ingest dispatch")
        calls = record_ingest(cfg_ll_on, scans[:12])
        k1p_ll = check_k1p(calls, reps=2, gate=statics["gate"])
        k7d_ll = check_k7d(calls, "12-scan BGKL large-map dispatch", reps=2,
                           data_controls=False)
        k7_ll = check_k7_segments(calls, "12-scan BGKL large-map dispatch", reps=2)
        del calls
        stamp("BGKL large map: main path on both ingest paths, card vs CPU")
        path_ll = large_bgk_family(cfg_ll, cfg_ll_on, tmp, scans, heavy=True)
        stamp("BGK large map (block_depth 3): K7a, K7b, K7c, K7s, K7t on a 12-scan "
              "device-ingest dispatch")
        k7_bl = check_k7(record_ingest(load_method_config("bgkoctomap_large_map"),
                                       scans[:12]), "12-scan BGK large-map dispatch", reps=2)
        stamp("BGK large map (block_depth 3): main path on both ingest paths, card vs CPU")
        path_bl = large_bgk_family(
            load_method_config("bgkoctomap_large_map", device_ingest="off"),
            load_method_config("bgkoctomap_large_map"), tmp, scans, heavy=False)

        stamp("K7v: the server's pre-downsample on the card, city-block scans")
        k7v = check_k7v()

        stamp("GP at block_depth 5 (host ingest): K4, K5, main path, card vs CPU")
        cfg_gp5 = load_method_config("gpoctomap_large_map", block_depth=5,
                                     max_range=MAX_RANGE, device_ingest="off")
        args, statics = capture_gp(cfg_gp5, scans[:12], run_step=False)
        k4_5 = check_k4(args, statics, "12-scan GP depth-5 dispatch", reps=1)
        tables = k4_5.pop("tables")
        G5 = statics["G"]
        mem_gp5 = table_bytes("K4 tables (mean, var) f32, 12-scan GP depth-5 dispatch",
                              tables["acc_mean"].shape[0] // G5,
                              G5 * tables["acc_mean"].shape[1] * 8, 12)
        k5_5 = check_k5(args, statics, tables, "12-scan GP depth-5 dispatch")
        k5_5.update(check_k5_pools(args, statics, tables, "12-scan GP depth-5 dispatch"))
        del args, tables
        path_gp5 = {"static12": gp_static(cfg_gp5, tmp, 12)}
        # one scan: the CPU factors models of up to about 2100 points, whose
        # f32 factors part from f64 by more than GP_CPU_TOL
        dev_gp5 = card_vs_cpu_gp(cfg_gp5, tmp, n_scans=1, f64_ref=True)

        stamp("the command line: static (every family), profile, query, raycast, frontier, "
              "server, bag, eval, python -m")
        cli_out = cli_phase(tmp, scans)

        stamp("sharding: 4 shards on the card (every family, both ingest paths), growth and "
              "rebalance, a one-rank NCCL group, two gloo ranks, dryrun_multichip")
        sharded_out = sharded_phase(tmp, tmp, smi)

    launches = path["static60"]["launches"]
    launches_on = path_on["static60"]["launches"]
    kernels = [
        {"name": "bgk_heavy", "route": "cuda",
         "source": "la3dm_tpu_torch/csrc/bgk_heavy.cu",
         "replaces": "la3dm_tpu/models/bgk.py:106", "launches": launches["bgk_heavy"],
         "work": "one 16-scan dispatch", **k1, "library_ms": None},
        {"name": "bgk_light", "route": "cuda",
         "source": "la3dm_tpu_torch/csrc/bgk_light.cu",
         "replaces": "la3dm_tpu/models/bgk.py:140", "launches": launches["bgk_light"],
         "work": "the 16 per-scan launches of one 16-scan dispatch", **k2,
         "library_ms": None, "predict_g27": k2_27,
         "large_block": {
             "work": "the 12 per-scan launches of one 12-scan BGKL large-map dispatch "
                     "(16^3 voxels a block)",
             "launches": path_ll["host"]["static12"]["launches"]["bgk_light"], **k2_ll}},
        {"name": "lv_rows", "route": "cuda",
         "source": "la3dm_tpu_torch/csrc/lv_rows.cu",
         "replaces": "la3dm_tpu/models/bgklv.py:127",
         "launches": path_lv["static60"]["launches"]["lv_rows"],
         "work": "one 12-scan demo dispatch", **k3, "library_ms": None,
         "large_map": {"work": "one BGKLV large-map scan's dispatch (block_depth 6)",
                       "launches": path_lv["large12"]["launches"]["lv_rows"], **k3_l}},
        {"name": "lv_prune", "route": "cuda",
         "source": "la3dm_tpu_torch/csrc/lv_prune.cu",
         "replaces": "la3dm_tpu/models/bgklv.py:216",
         "launches": path_lv["large12"]["launches"]["lv_prune"],
         "work": "the prune of one large-map scan's blocks", **k8, "library_ms": None},
        {"name": "gp_heavy", "route": "cuda",
         "source": "la3dm_tpu_torch/csrc/gp_heavy.cu",
         "replaces": "la3dm_tpu/models/gp.py:66",
         "launches": path_gp["static60"]["launches"]["gp_heavy"],
         "work": "the base tier of one 16-scan demo dispatch", **k4["tiers"][0],
         "library_ms": None, "large_map_tiers": k4_l["tiers"],
         "forced_block_tiers": k4_d["tiers"], "depth5_tiers": k4_5["tiers"]},
        {"name": "gp_light", "route": "cuda",
         "source": "la3dm_tpu_torch/csrc/gp_light.cu",
         "replaces": "la3dm_tpu/models/gp.py:128",
         "launches": path_gp["static60"]["launches"]["gp_light"],
         "work": "the 16 per-scan launches of one 16-scan demo dispatch", **k5,
         "library_ms": None, "large_map": k5_l,
         "large_block": {
             "work": "the 12 per-scan launches of one 12-scan GP depth-5 dispatch "
                     "(16^3 voxels a block)",
             "launches": path_gp5["static12"]["launches"]["gp_light"], **k5_5}},
        {"name": "ingest_beams", "route": "cuda",
         "source": "la3dm_tpu_torch/csrc/ingest_beams.cu",
         "replaces": "la3dm_tpu/geometry/device_ingest.py:390",
         "launches": launches_on["ingest_beams"],
         "work": "the 2 launches (raw points, beams) of one 16-scan BGK demo dispatch; "
                 "bound_ms on the samples kept, bound_ms_dense with every slot written",
         **k7["ingest_beams"], "library_ms": None, "gp": k7_gp["ingest_beams"],
         "bgk_large_map": k7_bl["ingest_beams"]},
        {"name": "ingest_downsample", "route": "cuda",
         "source": "la3dm_tpu_torch/csrc/ingest_downsample.cu",
         "replaces": "la3dm_tpu/geometry/device_ingest.py:192",
         "launches": launches_on["ingest_downsample"],
         "work": "the 2 launches (hits, frees) of one 16-scan BGK demo dispatch; "
                 "library_ms: torch.segment_reduce sum over the gathered, compensated "
                 "offsets, one call a launch",
         **k7["ingest_downsample"], "gp": k7_gp["ingest_downsample"],
         "bgkl": k7_l["ingest_downsample"], "bgkl_large_map": k7_ll["ingest_downsample"],
         "bgk_large_map": k7_bl["ingest_downsample"]},
        {"name": "ingest_sort", "route": "cuda",
         "source": "la3dm_tpu_torch/csrc/ingest_sort.cu",
         "replaces": "la3dm_tpu/geometry/device_ingest.py:315",
         "launches": launches_on["ingest_sort"],
         "work": "the 4 sorts (hits, frees, memberships, test blocks) of one 16-scan BGK "
                 "demo dispatch; library_ms: torch.sort(stable=True) + unique_consecutive "
                 "on the same keys, both with their syncs (ms_call beside it)",
         **k7["ingest_sort"], "gp": k7_gp["ingest_sort"], "bgkl": k7_l["ingest_sort"],
         "bgkl_large_map": k7_ll["ingest_sort"], "bgk_large_map": k7_bl["ingest_sort"]},
        {"name": "ingest_bucket", "route": "cuda",
         "source": "la3dm_tpu_torch/csrc/ingest_bucket.cu",
         "replaces": "la3dm_tpu/geometry/device_ingest.py:357",
         "launches": launches_on["ingest_bucket"],
         "work": "one 16-scan BGK demo dispatch; library_ms: torch.unique of the candidate "
                 "keys + both searchsorted + the gathers (ms_with_candidates beside it); "
                 "bound_ms_searches: the search-based bound",
         **k7["ingest_bucket"], "gp": k7_gp["ingest_bucket"], "bgkl": k7_l["ingest_bucket"],
         "bgkl_large_map": k7_ll["ingest_bucket"], "bgk_large_map": k7_bl["ingest_bucket"]},
        {"name": "ingest_members", "route": "cuda",
         "source": "la3dm_tpu_torch/csrc/ingest_members.cu",
         "replaces": "la3dm_tpu/geometry/device_ingest.py:256",
         "launches": launches_on["ingest_members"],
         "work": "one 16-scan BGK demo dispatch", **k7["ingest_members"],
         "library_ms": None, "gp": k7_gp["ingest_members"],
         "bgkl": k7_l["ingest_members"], "bgkl_large_map": k7_ll["ingest_members"],
         "bgk_large_map": k7_bl["ingest_members"]},
        {"name": "ingest_slots", "route": "cuda",
         "source": "la3dm_tpu_torch/csrc/ingest_slots.cu",
         "replaces": "la3dm_tpu/models/ingest.py:202",
         "launches": launches_on["ingest_slots"],
         "work": "the 2 launches (world keys, gather) of one 16-scan BGK demo dispatch; "
                 "ms_with_sort with the world-key sort (K7s) between them; library_ms: "
                 "torch.unique(world keys, return_inverse=True) + the slots' index with its "
                 "sync, beside ms_sort_gather",
         **k7w, "gp": k7w_gp, "bgkl": k7w_l},
        {"name": "ingest_voxel_grid", "route": "cuda",
         "source": "la3dm_tpu_torch/csrc/ingest_voxel_grid.cu",
         "replaces": "none: the JAX OnlineIntegrator downsamples on the host "
                     "(la3dm_tpu/geometry/preprocess.py::voxel_downsample)",
         "launches": path_bl["device"]["online12"]["launches"]["ingest_voxel_grid"],
         "work": "one raw city-block scan (28,800 points) at the 0.5 m leaf: the keys, one "
                 "K7s sort and the reduce; call_ms with the pinned upload and the wait; "
                 "numpy_ms voxel_downsample, native_ms the host library's, as yardsticks",
         **k7v, "library_ms": None},
        {"name": "bgk_aligned_heavy", "route": "cuda",
         "source": "la3dm_tpu_torch/csrc/bgk_aligned_heavy.cu",
         "replaces": "la3dm_tpu/models/bgk.py:204",
         "launches": launches_on["bgk_aligned_heavy"],
         "work": "one 16-scan BGK demo dispatch", **k1p, "library_ms": None},
        {"name": "bgk_heavy_segment", "route": "cuda",
         "source": "la3dm_tpu_torch/csrc/bgk_heavy.cu",
         "replaces": "la3dm_tpu/models/bgk.py:121",
         "launches": path_l["static60"]["launches"]["bgk_heavy"],
         "work": "one 16-scan BGKL demo dispatch", **k1s, "library_ms": None,
         "large_map": {"work": "one 12-scan BGKL large-map dispatch (block_depth 5)",
                       "launches": path_ll["host"]["static12"]["launches"]["bgk_heavy"],
                       **k1_ll}},
        {"name": "bgk_aligned_heavy_segment", "route": "cuda",
         "source": "la3dm_tpu_torch/csrc/bgk_aligned_heavy.cu",
         "replaces": "la3dm_tpu/models/bgk.py:229",
         "launches": path_l_on["static60"]["launches"]["bgk_aligned_heavy"],
         "work": "one 16-scan BGKL demo dispatch", **k1ps, "library_ms": None,
         "large_map": {"work": "one 12-scan BGKL large-map device-ingest dispatch "
                               "(block_depth 5)",
                       "launches": path_ll["device"]["static12"]["launches"][
                           "bgk_aligned_heavy"], **k1p_ll}},
        {"name": "ingest_rays", "route": "cuda",
         "source": "la3dm_tpu_torch/csrc/ingest_rays.cu",
         "replaces": "la3dm_tpu/geometry/device_ingest.py:497",
         "launches": path_l_on["static60"]["launches"]["ingest_rays"],
         "work": "the 2 launches (count, write) of one 16-scan BGKL demo dispatch: ms the "
                 "device time of the call by torch.profiler, ms_call the call with its wait "
                 "for the list's size by CUDA events",
         **k7d, "library_ms": None,
         "large_map": {"work": "one 12-scan BGKL large-map device-ingest dispatch",
                       "launches": path_ll["device"]["static12"]["launches"]["ingest_rays"],
                       **k7d_ll}},
        {"name": "raycast", "route": "cuda", "source": "la3dm_tpu_torch/csrc/raycast.cu",
         "replaces": "la3dm_tpu/models/raycast.py:145", **rays["bgk"],
         "work": "1,000,000 rays over the 60-scan BGK demo map", "library_ms": None,
         "bgkl": rays["bgkl"], "bgklv": rays["bgklv"]},
    ]
    summary = {"card": smi, "main_path": path, "card_vs_cpu_max_dev": dev,
               "main_path_ingest": path_on, "card_vs_cpu_max_dev_ingest": dev_on,
               "main_path_lv": path_lv, "card_vs_cpu_max_dev_lv": dev_lv,
               "main_path_gp": path_gp, "card_vs_cpu_gp": dev_gp,
               "main_path_gp_ingest": path_gp_on, "card_vs_cpu_gp_ingest": dev_gp_on,
               "main_path_bgkl": path_l, "card_vs_cpu_max_dev_bgkl": dev_l,
               "main_path_bgkl_ingest": path_l_on, "card_vs_cpu_max_dev_bgkl_ingest": dev_l_on,
               "raycast": rays,
               "bgkl_large_map": {**path_ll, "k1_segments": k1_ll, "accumulator": mem_ll,
                                  "k1p_segments": k1p_ll},
               "bgk_large_map": path_bl, "bgk_large_map_k7": k7_bl,
               "bgkl_large_map_k7": k7_ll,
               "gp_depth5": {**path_gp5, "card_vs_cpu": dev_gp5, "tables": mem_gp5}}
    print(f"main path on {smi}: BGK {path_on['static60']['scans_per_s']:.2f} scans/s "
          f"(60 scans, device ingest; host ingest {path['static60']['scans_per_s']:.2f}), "
          f"median online latency {path_on['online12']['median_ms']:.2f} ms (host ingest "
          f"{path['online12']['median_ms']:.2f}); "
          f"BGKLV {path_lv['static60']['scans_per_s']:.2f} scans/s (60 scans), "
          f"median online latency {path_lv['online12']['median_ms']:.2f} ms, large "
          f"map {path_lv['large12']['scans_per_s']:.2f} scans/s (12 scans); GP "
          f"{path_gp_on['static60']['scans_per_s']:.2f} scans/s (60 scans, device ingest; "
          f"host ingest {path_gp['static60']['scans_per_s']:.2f}), median online "
          f"latency {path_gp_on['online12']['median_ms']:.2f} ms (host ingest "
          f"{path_gp['online12']['median_ms']:.2f}), large map "
          f"{path_gp['large12']['scans_per_s']:.2f} scans/s (12 scans); BGKL "
          f"{path_l_on['static60']['scans_per_s']:.2f} scans/s (60 scans, device ingest; "
          f"host ingest {path_l['static60']['scans_per_s']:.2f}), median online latency "
          f"{path_l_on['online12']['median_ms']:.2f} ms (host ingest "
          f"{path_l['online12']['median_ms']:.2f}); raycast "
          f"{rays['bgk']['rays_per_s']:.4g} rays/s over 1,000,000 rays (snapshot "
          f"{rays['bgk']['snapshot_ms']:.2f} ms); large maps (12 scans): BGKL "
          f"{path_ll['device']['static12']['scans_per_s']:.2f} scans/s on device ingest "
          f"(host ingest {path_ll['host']['static12']['scans_per_s']:.2f}), median online "
          f"latency {path_ll['device']['online12']['median_ms']:.2f} ms (host ingest "
          f"{path_ll['host']['online12']['median_ms']:.2f}), BGK "
          f"{path_bl['device']['static12']['scans_per_s']:.2f} (host ingest "
          f"{path_bl['host']['static12']['scans_per_s']:.2f}), GP at block_depth 5 "
          f"{path_gp5['static12']['scans_per_s']:.2f} (host ingest); K2 "
          f"{1e3 * k2_ll['ms_per_launch']:.2f} us a launch at 16^3 voxels a block, "
          f"{1e3 * k2['ms_per_launch']:.2f} us at 4^3")
    stamp("done")
    print(json.dumps(summary))
    print(json.dumps({"cli": cli_out}))
    print(json.dumps({"sharded": sharded_out}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-worker"]:
        sys.exit(sharded_worker(sys.argv[2:]))
    sys.exit(main())
