#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one GPU: ``python3 chip_smoke.py``.

Run from the repository root on a machine with one CUDA GPU and ``nvcc``.
It imports ``perf_tpu_torch`` only (never JAX) and works through:

1. build: compiles every kernel under ``perf_tpu_torch/kernels/csrc`` with
   ``nvcc`` for ``sm_90a``, one process per source, all started together;
   gather: the row-gather benchmark entry point
   (``python -m perf_tpu_torch.tools.bench_pallas_encode``, 2^19 rows of a
   bf16 [4096, 128] table) through the take and one-hot tensor-core
   kernels at every block of the JAX sweep, each output bitwise
   ``table[rows]``;
2. train: writes the synthetic cube room as the input pano at the config's
   2048x1024 (PNG plus the cached distance and normal maps; the camera sits
   off-centre so that the wall shell has grazing rays, as real rooms do),
   then runs the port's CLI (``mode=train``, no anchors) at the full width
   of ``configs/nerf.yaml`` with 300 geometry and 150 appearance steps:
   occupancy grid, budget and bucket plan, guarded Adam steps through the
   brick-encode, march and composite kernels, the snapshot render and the
   checkpoint. Checks: finite losses, no skipped step, the depth loss of
   the last 20 steps below half that of the first 20, a non-flat ``1.png``,
   a checkpoint that loads back; then warm steps timed and traced;
3. scene: the ``configs/nerf.yaml`` brick field at full width with
   parameters drawn with NumPy from ``--seed``, and the cube room's
   occupancy (256^3) as seen from the origin by a 512x1024 pano, written as
   ``checkpoints/ckpt.npz`` in the run layout;
4. serve: starts the port's CLI entry (``mode=serve is_continue=true``)
   from that checkpoint, which bakes the 384^3 snapshot, and answers
   health, pano, perspective, distance and displaced-pose renders over
   HTTP; each decoded PNG must be non-flat and equal a direct render;
5. anchor: writes the cube room seen from its centre at 2048x1024 without
   a geometry cache and runs the CLI's ``mode=train`` at the full width of
   ``configs/nerf.yaml`` with 2 anchors, then ``mode=render_dense``: the
   bootstrap through the joint predictor (100 + 100 distillation steps),
   the raw fit (300 + 150 steps), per anchor the snapshot render, the
   visibility mask, the 20-view fusion inpainting, the geometry, the
   geo-check, the registration and a re-fit with the occupancy prune (one
   field-path preview fires), then 12 dense frames at 512x1024. Checks:
   the bootstrapped distance against the room's (median relative error
   < 0.15), finite registered maps, a checkpoint at phase 2 with 3 panos,
   the preview and non-flat frames;
6. hash: the NGP field on the hash grid (``scene.field.kind=hash``, 16
   levels x 2^18 rows x 2 features, 64-neuron heads) through the CLI on
   the off-centre room with its cache: ``mode=train`` (300 + 150 steps, one
   anchor whose re-fit prunes with the hash field, one preview), then
   ``mode=serve`` from its checkpoint (a pano and a perspective request).
   Checks: the training phase's, a prune and a preview on the hash field,
   PNGs equal to a direct render, no brick-field kernel launched;
7. sphere: the joint predictor's reference-parity sphere field
   (``priors.joint.field.encoding=hash priors.joint.field.grad_mode=ad``,
   the published PeRF's: 16 smoothstep levels of 2^19 rows, fine_res 2048)
   through the CLI's ``mode=train`` on the centred room without a cache
   (the bootstrap, 100 + 100 distillation steps, the raw fit, one anchor,
   no dense frames); then the non-Wild geometry API on the same room: the
   dataset's ``get_ref_distance`` / ``get_ref_normal`` through the fusion
   predictors (100 steps each) and ``refine_geometry`` through the geometry
   refiner at its full width (fine_res 4096, 32,768 directions a step,
   weight norm, raw head; 100 steps) with ``encoding=hash grad_mode=fd``
   and with its default (brick + analytic). Checks: the bootstrap's median
   relative distance error < 0.15, finite registered maps, the hash encode
   with derivatives launched and the brick one not; finite fused maps,
   unit refined normals, the refined distance within the JAX test's bar
   (median relative difference < 0.15) of its input;
8. prop: the proposal estimator (``scene.estimator_type=prop``: the brick
   final field at full width, two hash proposal fields [5, 2, 2^17], 8192
   rays, 128 -> 64 -> 64 samples) on the off-centre room with its cache:
   ``mode=train`` (300 + 150 steps, one anchor), ``mode=render_dense`` (4
   frames at 512x1024), then ``mode=serve`` from its checkpoint (a pano and
   a perspective request, ``/info``). Checks: the training phase's (the
   proposal loss of the first and last 20 geometry steps is printed, not
   checked), finite registered maps, the five K11 kernels launched and no
   occupancy-path kernel;
9. dedup: the run-dedup encode and composite (K12) on the train cell's
   room (brick field at full width): ``mode=train`` with
   ``scene.train_conf.dedup_runs=true snapshot.dedup_ratio=0.5`` (300 +
   150 steps, one anchor whose re-fit probes the caps again), then
   ``mode=render_dense`` (4 frames) and ``mode=serve`` (a pano and a
   perspective request) with the same ratio, recorded (``DedupRecorder``:
   each episode's caps, each encode call's route, each composite chunk's S
   and K and the rays whose runs K clips). Checks: the raw fit's, finite
   registered maps, every episode with a cap above 0, a chunk with K < S,
   the three K12 kernels launched, and the standard encode and composite
   launched exactly on the calls and chunks JAX routes there;
10. kernels: holds each kernel against its plain PyTorch version on the
   same inputs at the shapes of its path (and the training kernels also at
   the pinned 8192 rays x 128 samples), and times both, with
   ``F.grid_sample`` beside the resampler and ``table[rows]`` beside the
   gathers. The resampler's forward is also held bitwise and timed at the
   visibility core's own coordinates and at the distillation's view-stack
   call (``F.grid_sample`` beside it at both), the brick encode forward
   and backward also at the prop path's final field (8192 rays x 64
   samples, stride 1 on every level), the hash encode forward and backward
   also in the point form at the level-0 proposal field's points
   (1,048,576 points on 5 levels: the row stores of an odd level count);
   the encodes' forwards write the lerped, level-concatenated features,
   the hash backward reads their cotangent, and the PyTorch glue they
   absorbed (each level's lerp and the concatenation, or the point form's
   permute, and their transposes) is timed beside them. A log line gives
   each redesigned kernel's time beside the one ``PERF.md`` recorded
   before its redesign. The step profiles give the watched kernels'
   (the encodes' and the resampler's) time and share of a step's device
   time, and, for the encodes, the shapes of their launches inside the
   steps (recorded by wrapping the encode wrappers in the smoke) and the
   bound at those shapes beside the time. The NGP MLP kernels (K2 forward
   and backward with trunc_exp / sigmoid and the AABB select,
   ``kernels/ngp_mlp.py``) are held against their plain versions for the
   density head at the brick and hash steps' shapes on their trained
   fields, the colour head at the steps' window gather, and the proposal
   head at level 0's points of a prop step, the colour head at a prop app
   step's points (forward: at most 0.1% of the outputs off by > 1e-4
   relative; backward: dx, dW0, dW1 bf16-valued, dx within one bf16 ulp
   or within the span that the moves the float32 sums' order can carry
   to it allow (a hidden output or cotangent rounded the other way on a
   bf16 tie, a ReLU decided the other way within its pre-activation's
   reach of zero: ``fields/mlp.py`` ``bf16_head_reach``), an entry of dW0
   or dW1 past one ulp no farther from its float64 sum than the plain
   version is, plus one ulp and its terms' reach, the last layer within
   1e-5 relative norm plus its terms' reach; on the points no tie
   reaches, one ulp and the float64 sums, the last layer by its norm
   within 1e-5 plus the epilogue's reach and each block's partial row of
   it within gamma_D of its float64 sums; three controls that must fail; the proposal head's gradients within 1e-5; a second
   launch bitwise), each timed beside its plain version and the
   PyTorch route it replaced (the plain forward under autograd and its
   autograd backward); the step profiles give the MLP's launches, bound
   and time a step (recorded by wrapping its wrappers), the hash bake's
   MLP launches are counted and the prop path's are checked per head.
   The K12 kernels are held at the dedup path's shapes with its probed
   caps (forward within 1e-6; backward within 1e-5 relative norm, at
   most 0.1% of its entries moved by a second bf16 rounding on a tie,
   each by at most one bf16 ulp of its |g| sum; the composite at K5's
   tolerances), each timed beside its plain version and
   the standard kernel on the same inputs (``standard_ms``); with caps
   covering every run the dedup forward equals K1's bitwise, and a pano's
   chunks at one K covering every run of the frame equal the standard
   composite bitwise. The dedup path's warm steps are also timed with
   ``dedup_runs`` off on the same episode (``standard_steps``). The
   training composite (K4, a group of lanes a ray) is held and timed at
   the scene's geometry batch, the pinned shape and the two buckets of a
   geometry step (the batch sorted by occupied windows and cut at the
   episode's ``bucket_plan``), forward within 1e-5, backward within 1e-4
   of its largest entry and bitwise on a second launch, each beside its
   bound by the function's bytes and the bound that counted the design
   before's ``trans`` and scratch (``was_bound_ms``); the step profiles
   give its launches, shapes, bound and time a step (``composite``).

Launch counts are zeroed just before each path (gather, train, serve,
anchor, hash, sphere: its CLI run and its API run, prop, dedup) and read
just after it; every kernel of a path must have launched there. It prints
a ``gather``, a ``train``, a ``serve``, an ``anchor``, a ``hash``, a
``sphere``, a ``prop`` and a ``dedup`` summary, the ``kernels``
line (each kernel with its launches on its path, error, ms, plain ms,
library ms and the card's bound for the same work), the card's name and
power limit, and, last, ``{"ok": true, "device": {...}}``. Any failed check exits non-zero; without
a CUDA device it exits non-zero before doing anything.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request
from urllib.parse import parse_qs, urlparse

REPO = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(REPO, "build", "smoke")
FRAME_H, FRAME_W = 512, 1024
ROOM_H, ROOM_W = 1024, 2048            # configs/nerf.yaml image_resize
ROOM_CAMERA = (0.5, 0.3, -0.2)         # off-centre in the 0.8 half-extent room
TRAIN_STEPS = (300, 150)               # geometry, appearance
PINNED = (8192, 128)                   # rays x samples
# the anchor phase's cuts of configs/nerf.yaml: distillation steps per
# phase, anchors on one loop, the preview period (one preview fires: geo
# iteration 500 of 3 x 300), the dense traverse's frames
JOINT_ITERS = 100
ANCHORS = 2
VIS_FREQ = 500
DENSE_POSES = 12
CSRC = "perf_tpu_torch/kernels/csrc/"
# the TPU kernel each entry replaces (file:line of the JAX function; the
# encodes' forwards: the ray form with its lerp and stack, or the point
# form)
REPLACES = {
    "field_eval": "perf_tpu/kernels/brickgrid.py:152",
    "bake_scatter_pack": "perf_tpu/render/snapshot.py:118",
    "march_windows": "perf_tpu/render/renderer.py:255",
    "snapshot_composite": "perf_tpu/render/snapshot.py:311",
    "brick_encode": "perf_tpu/kernels/brickgrid.py:228",
    "brick_encode_bwd": "perf_tpu/kernels/brickgrid.py:181",
    "march_windows_stratified": "perf_tpu/render/renderer.py:255",
    "count_windows": "perf_tpu/render/renderer.py:163",
    "shade_composite": "perf_tpu/render/renderer.py:384",
    "shade_composite_bwd": "perf_tpu/render/renderer.py:384",
    "occ_grid": "perf_tpu/render/occgrid.py:38",
    "occ_prune": "perf_tpu/train/scene.py:347",
    "brick_encode_grad": "perf_tpu/kernels/brickgrid.py:320",
    "brick_encode_grad_bwd": "perf_tpu/kernels/brickgrid.py:361",
    "bilinear_sample": "perf_tpu/core/resample.py:28",
    "bilinear_sample_bwd": "perf_tpu/core/resample.py:28",
    "take_gather": "tools/bench_pallas_encode.py:53",
    "onehot_gather": "tools/bench_pallas_encode.py:80",
    "hash_encode": "perf_tpu/kernels/hashgrid.py:180",
    "hash_encode_bwd": "perf_tpu/kernels/hashgrid.py:104, :168",
    "hash_encode_smooth": "perf_tpu/kernels/hashgrid.py:128",
    "hash_encode_smooth_bwd": "perf_tpu/kernels/hashgrid.py:104, :168",
    "hash_encode_grad": "perf_tpu/fields/sphere_field.py:144",
    "hash_encode_grad_bwd": "perf_tpu/fields/sphere_field.py:144",
    "prop_resample": "perf_tpu/render/prop.py:42",
    "prop_weights": "perf_tpu/render/prop.py:66",
    "prop_weights_bwd": "perf_tpu/render/prop.py:66",
    "prop_loss": "perf_tpu/render/prop.py:142",
    "prop_loss_bwd": "perf_tpu/render/prop.py:142",
    "ngp_mlp": "perf_tpu/fields/mlp.py:57, :44",
    "ngp_mlp_bwd": "perf_tpu/fields/mlp.py:57, :44",
    "brick_encode_dedup": "perf_tpu/kernels/brickgrid.py:547, :452",
    "brick_encode_dedup_bwd": "perf_tpu/kernels/brickgrid.py:486",
    "snapshot_composite_dedup": "perf_tpu/render/snapshot.py:325",
}
SERVE_KERNELS = ("field_eval", "bake_scatter_pack", "march_windows",
                 "snapshot_composite")
# the NGP MLP's kernels (K2: the density, colour and proposal heads)
MLP_KERNELS = ("ngp_mlp", "ngp_mlp_bwd")
TRAIN_KERNELS = ("brick_encode", "brick_encode_bwd",
                 "march_windows_stratified", "count_windows",
                 "shade_composite", "shade_composite_bwd",
                 "occ_grid") + MLP_KERNELS
# the anchor path (bootstrap, raw fit, anchors, render_dense) runs these and
# every training and snapshot kernel
ANCHOR_KERNELS = ("occ_prune", "brick_encode_grad", "brick_encode_grad_bwd",
                  "bilinear_sample", "bilinear_sample_bwd")
ANCHOR_PATH = (ANCHOR_KERNELS + TRAIN_KERNELS
               + ("field_eval", "bake_scatter_pack", "march_windows",
                  "snapshot_composite"))
# the gather path: the benchmark entry point at the JAX script's size
GATHER_KERNELS = ("take_gather", "onehot_gather")
GATHER_SAMPLES = 524288
# the hash path (mode=train with one anchor, then mode=serve) runs the hash
# kernels and the training and snapshot kernels, and none of the brick
# field's
HASH_KERNELS = ("hash_encode", "hash_encode_bwd")
HASH_ANCHORS = 1
HASH_PATH = HASH_KERNELS + MLP_KERNELS + (
    "march_windows_stratified", "count_windows", "shade_composite",
    "shade_composite_bwd", "occ_grid", "bake_scatter_pack", "march_windows",
    "snapshot_composite")
BRICK_FIELD_KERNELS = ("field_eval", "brick_encode", "brick_encode_bwd",
                       "occ_prune")
# the sphere path's CLI run: the anchor path's kernels with the joint
# predictor's hash field (hash + ad) in place of its brick one
SPHERE_KERNELS = ("hash_encode_grad", "hash_encode_grad_bwd")
SPHERE_PATH = SPHERE_KERNELS + tuple(
    k for k in ANCHOR_PATH
    if k not in ("brick_encode_grad", "brick_encode_grad_bwd"))
SPHERE_ANCHORS = 1
# its API run: the fusion predictors' resampling, the refiner's hash fd
# field (smoothstep point encodes) and its default brick + analytic one
SMOOTH_KERNELS = ("hash_encode_smooth", "hash_encode_smooth_bwd")
SPHERE_API_PATH = SMOOTH_KERNELS + (
    "bilinear_sample", "bilinear_sample_bwd", "brick_encode_grad",
    "brick_encode_grad_bwd")
# the proposal estimator (scene.estimator_type=prop) on the train cell's
# room: the K11 kernels, the proposal fields' hash encode and the brick
# final field's encode, and none of the occupancy path's kernels
PROP_KERNELS = ("prop_resample", "prop_weights", "prop_weights_bwd",
                "prop_loss", "prop_loss_bwd")
PROP_PATH = PROP_KERNELS + MLP_KERNELS + (
    "hash_encode", "hash_encode_bwd", "brick_encode", "brick_encode_bwd")
OCC_KERNELS = ("march_windows", "march_windows_stratified", "count_windows",
               "shade_composite", "shade_composite_bwd", "occ_grid",
               "occ_prune", "bake_scatter_pack", "snapshot_composite",
               "field_eval")
PROP_ANCHORS = 1
PROP_DENSE = 4
# the run-dedup path (K12: scene.train_conf.dedup_runs=true,
# snapshot.dedup_ratio) on the train cell's room: mode=train with one anchor,
# render_dense, mode=serve
DEDUP_KERNELS = ("brick_encode_dedup", "brick_encode_dedup_bwd",
                 "snapshot_composite_dedup")
# the dedup backward against its plain version (index_add_ on the card,
# each run summed in any order): where a run's float32 sum lands on the
# other side of its second bf16 rounding, the entry moves by one bf16 ulp of
# the run's sum; at most this share of the entries may move so, and the
# relative norm stays within the CPU test's bar against JAX (read: 1.5e-8
# with no move, 1.99e-6 with one move, H100)
DEDUP_TIE_SHARE = 1e-3
DEDUP_BWD_REL = 1e-5
# every kernel of this path but the standard encode and composite, which
# launch only on the calls (and chunks) where no level (no K < S) takes the
# dedup form: the smoke counts those calls and checks the launches equal them
DEDUP_PATH = DEDUP_KERNELS + MLP_KERNELS + (
    "march_windows_stratified", "count_windows", "shade_composite",
    "shade_composite_bwd", "occ_grid", "field_eval", "bake_scatter_pack",
    "march_windows")
DEDUP_RATIO = 0.5
DEDUP_ANCHORS = 1
DEDUP_DENSE = 4
REFINER_ITERS = 100          # of the refiner's 5000
FUSION_ITERS = 100           # of the fusion predictors' 1000
# the times PERF.md recorded at each redesigned kernel's row before its
# redesign (H100 80GB HBM3, 700.00 W): printed beside each new time
WAS_MS = {"bilinear_sample": 0.1929, "brick_encode_bwd": 0.8666,
          "hash_encode": 0.4809, "hash_encode_smooth": 0.3809,
          "brick_encode": 0.08582, "hash_encode_bwd": 1.307,
          "hash_encode_smooth_bwd": 0.8235, "shade_composite": 0.03483,
          "shade_composite_bwd": 0.06082}
# the encode wrappers whose launches the step profiles record, and the
# labels of the kernels each launches in a trace (the first names it)
ENCODE_WRAPPERS = {
    ("hashgrid", "hash_encode_ray_cuda"): ("hash_ray_fwd_kernel",),
    ("hashgrid", "hash_encode_ray_bwd_cuda"): ("hash_ray_bwd_kernel",
                                               "hash_grad_zero_kernel",
                                               "hash_grad_transpose_kernel"),
    ("brickgrid", "brick_encode_ray_cuda"): ("brick_ray_fwd_kernel",),
    ("brickgrid", "brick_points_grad_cuda"): ("brick_bwd_kernel",),
    ("brickgrid", "brick_encode_ray_dedup_cuda"): ("brick_dedup_fwd_kernel",),
    ("brickgrid", "brick_points_dedup_grad_cuda"): ("brick_dedup_bwd_kernel",)}
# the MLP kernels' labels in a trace: the forward, the backward (its tiles
# and the sum of its blocks' partials); the bf16 heads' tensor-core
# kernels, then the proposal head's float32 ones
MLP_LABELS = {"fwd": ("mlp_fwd_kernel", "mlp_f32_fwd_kernel"),
              "bwd": ("mlp_bwd_kernel", "mlp_f32_bwd_kernel",
                      "mlp_grad_reduce_kernel")}
# the composite kernels' labels in a trace (K4, a template of two load
# widths each)
COMPOSITE_LABELS = {"fwd": "shade_fwd_kernel", "bwd": "shade_bwd_kernel"}
# the MLP against its plain version: float32 sums in another order than
# cuBLAS's put a hidden unit on the other side of a bf16 rounding tie now
# and then (field_eval's forward reads 0.042% of outputs off by > 1e-4); at
# most this share of the forward's outputs may be off by > 1e-4 relative
MLP_LOOSE_SHARE = 1e-3
# the hash backward against its plain version and a second launch,
# relative norm of the table gradient: the same float32 contributions,
# summed in another order (the lerp transpose's rotated sums, a cell's run
# of lanes, float atomics in both). On an H100 the smoke's shapes read
# 2.8e-7 to 1.16e-6 over three runs (the most at the proposal field's point
# form, whose level-0 rows take ~200 contributions each),
# tools/encode_probe.py --backward up to 9.9e-7 there (the design before:
# 9.4e-7): held to 2e-6
HASH_BWD_TOL = 2e-6
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, float32 FLOP/s off
# the tensor cores, bf16 FLOP/s on them
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12


def check(cond: bool, msg: str):
    if not cond:
        raise AssertionError(msg)


def log(msg: str):
    print(f"[chip_smoke] {msg}", flush=True)


def bound(nbytes: float, flops: float, bf16_flops: float = 0) -> dict:
    """The least time the card could take: bytes over the HBM rate, float32
    operations over their peak, or bf16 products (f32 accumulation) over
    the tensor cores' peak, whichever is largest."""
    t_b = nbytes / HBM_BPS * 1e3
    t_f = max(flops / F32_FLOPS, bf16_flops / BF16_FLOPS) * 1e3
    return {"bound_ms": max(t_b, t_f),
            "bound_by": "bytes" if t_b >= t_f else "operations"}


def encode_bound(grid, n: int, s: int, strides: tuple,
                 backward: bool = False) -> dict:
    """The bound of a ray-form encode of [n, s] samples on a brick or hash
    grid (``grid.fused_field``: brick). Forward: the coordinates once, each
    level's corner rows once up to the rows the level holds, the finished
    [n, s, L * F] float32 features out; per coarse point the operations to
    locate it and weight and sum its corners, per strided output value 3
    for its lerp. Backward: the coordinates in, the float32 table gradient
    out (the hash backward's fill of its accumulator, timed with it in the
    row and in the steps, is that write), and
    the cotangents in: the brick's coarse points' [points, 2], the hash's
    features' [n, s, L * F], whose lerp transpose adds per strided value 2
    products and 2 sums."""
    from perf_tpu_torch.kernels.hashgrid import level_plan
    plan, total = level_plan(grid, strides, n, s)
    coords = 3 * n * s * 4
    brick = grid.fused_field
    if backward:
        if brick:
            return bound(coords + total * 8
                         + grid.n_levels * grid.n_bricks * 128 * 4, total * 64)
        lerped = sum(n * s * 2 * 4 for *_, k, _, _ in plan if k > 1)
        return bound(coords + n * s * grid.out_dim * 4
                     + grid.n_levels * 2 * grid.table_size * 4,
                     total * (62 if grid.interpolation == "smoothstep"
                              else 50) + lerped)
    if brick:
        # a point reads 8 corners x 2 float32 features (64 B) of one 512 B
        # row of the parameter
        read = sum(min(n * npts * 64, min(look ** 3, grid.n_bricks) * 512)
                   for _, look, _, _, npts, _ in plan)
        ops = total * 52
    else:
        # 8 corners of 2 float32 features a point, at most the rows a level
        # can address: (res + 1)^3 dense, T hashed
        read = sum(min(n * npts * 8, grid.table_size if hashed
                       else look ** 3) * 8
                   for _, look, hashed, _, npts, _ in plan)
        ops = total * (78 if grid.interpolation == "smoothstep" else 66)
    lerped = sum(n * s * 2 * 3 for *_, k, _, _ in plan if k > 1)
    return bound(coords + read + n * s * grid.out_dim * 4, ops + lerped)


def glue_ms(plan, n: int, s: int, dev) -> float:
    """Device time of the PyTorch glue the forward kernels absorbed, on
    random coarse features [points, 2] of ``plan``: the lerp of each level
    and the concatenation (the ray form), or the level-major to
    point-major permute (the point form, s = 1)."""
    import torch
    from perf_tpu_torch.kernels.hashgrid import lerp_levels
    flat = torch.randn((n * sum(row[4] for row in plan), 2), device=dev)
    if s == 1:
        return cuda_ms(lambda: flat.reshape(len(plan), n, 2).permute(
            1, 0, 2).reshape(n, 2 * len(plan)), 20)
    return cuda_ms(lambda: lerp_levels(flat, plan, n, s), 20)


class EncodeRecorder:
    """Records, inside ``with``, the shapes of every call of the encode
    wrappers of ENCODE_WRAPPERS (the smoke swaps the module attributes the
    autograd Functions call; the package has no knob for it): per kernel
    label, its launches and the sum of their bounds."""

    def __enter__(self):
        import importlib
        self.calls, self._saved = {}, []
        for (mod_name, fn_name), (label, *_) in ENCODE_WRAPPERS.items():
            mod = importlib.import_module(f"perf_tpu_torch.kernels.{mod_name}")
            orig = getattr(mod, fn_name)
            self._saved.append((mod, fn_name, orig))

            def wrapped(*args, orig=orig, label=label):
                nx, grid, strides = args[1], args[4], args[5]
                key = (label, tuple(nx.shape), tuple(strides), grid)
                self.calls[key] = self.calls.get(key, 0) + 1
                return orig(*args)
            setattr(mod, fn_name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, fn_name, orig in self._saved:
            setattr(mod, fn_name, orig)

    def per_label(self, steps: int) -> dict:
        """label -> launches a step, bound ms a step and the shapes
        ([n, s], strides, launches a step) it launched at."""
        out = {}
        for (label, (n, s), strides, grid), count in self.calls.items():
            b = encode_bound(grid, n, s, strides,
                             backward=label.endswith("bwd_kernel"))["bound_ms"]
            rec = out.setdefault(label, {"launches_per_step": 0.0,
                                         "bound_ms_per_step": 0.0,
                                         "shapes": []})
            rec["launches_per_step"] += count / steps
            rec["bound_ms_per_step"] += b * count / steps
            rec["shapes"].append([[n, s], list(strides), count / steps])
        return out


def mlp_bound(head, m: int, din: int, backward: bool = False) -> dict:
    """The bound of a head's MLP at m points of din inputs. Bytes: x, sel
    and the weights in; forward the activated channels and the raw outputs
    out; backward the raw outputs and their cotangents in, dx and the
    weights' gradients out. Operations: the hidden layers' products (bf16 x
    bf16 with float32 sums in the bf16 heads: the tensor cores' work; the
    proposal head's float32) once forward and three times backward (their
    recompute, the cotangents of each hidden layer's input, the weights'
    gradients), the last layer's float32 products once forward and twice
    backward, and 4 float32 operations an output for the epilogue."""
    c = head.channels
    n_w = din * 64 + (head.hidden - 1) * 64 * 64 + 64 * c
    hidden = 2 * m * (din * 64 + (head.hidden - 1) * 64 * 64)
    last = 2 * m * 64 * c
    nbytes = m * din * 4 + m + n_w * 4 + 2 * c * m * 4
    if backward:
        nbytes += m * din * 4 + n_w * 4
        hidden, last = 3 * hidden, 2 * last
    f32 = last + 4 * c * m
    return bound(nbytes, f32 if head.bf16 else f32 + hidden,
                 hidden if head.bf16 else 0)


class MlpRecorder:
    """Records, inside ``with``, every call of the MLP kernels' wrappers
    (``ngp_mlp_fwd_cuda`` / ``ngp_mlp_bwd_cuda``; the smoke swaps the
    module attributes ``ngp_head`` and the autograd Function call, as
    ``EncodeRecorder`` does): per direction, head and input shape, its
    launches."""

    NAMES = {"fwd": "ngp_mlp_fwd_cuda", "bwd": "ngp_mlp_bwd_cuda"}

    def __enter__(self):
        from perf_tpu_torch.kernels import ngp_mlp
        self.calls, self._mod = {}, ngp_mlp
        self._saved = {d: getattr(ngp_mlp, n) for d, n in self.NAMES.items()}
        for direction, orig in self._saved.items():
            def wrapped(ws, x, sel, *rest, orig=orig, direction=direction,
                        **kw):
                head = rest[0] if direction == "fwd" else rest[2]
                key = (direction, head, tuple(x.shape))
                self.calls[key] = self.calls.get(key, 0) + 1
                return orig(ws, x, sel, *rest, **kw)
            setattr(ngp_mlp, self.NAMES[direction], wrapped)
        return self

    def __exit__(self, *exc):
        for direction, orig in self._saved.items():
            setattr(self._mod, self.NAMES[direction], orig)

    def launches(self) -> dict:
        """"direction/head" -> launches."""
        out = {}
        for (direction, head, _), count in self.calls.items():
            key = f"{direction}/{head.name}"
            out[key] = out.get(key, 0) + count
        return out

    def per_direction(self, steps: int) -> dict:
        """direction -> launches a step, bound ms a step and the shapes
        (head, [m, din], launches a step) it launched at."""
        out = {d: {"launches_per_step": 0.0, "bound_ms_per_step": 0.0,
                   "shapes": []} for d in self.NAMES}
        for (direction, head, (m, din)), count in self.calls.items():
            rec = out[direction]
            rec["launches_per_step"] += count / steps
            rec["bound_ms_per_step"] += mlp_bound(
                head, m, din, backward=direction == "bwd")["bound_ms"] \
                * count / steps
            rec["shapes"].append([head.name, [m, din], count / steps])
        return out


class CompositeRecorder:
    """Records, inside ``with``, every call of the composite kernels'
    wrappers (``shade_composite_cuda`` / ``shade_composite_grad_cuda``, the
    module attributes ``_ShadeComposite`` calls, swapped as
    ``EncodeRecorder`` does): per direction and shape, its launches."""

    NAMES = {"fwd": "shade_composite_cuda", "bwd": "shade_composite_grad_cuda"}

    def __enter__(self):
        from perf_tpu_torch.render import renderer
        self.calls, self._mod = {}, renderer
        self._saved = {d: getattr(renderer, n) for d, n in self.NAMES.items()}
        for direction, orig in self._saved.items():
            def wrapped(sigma, *rest, orig=orig, direction=direction, **kw):
                key = (direction, tuple(sigma.shape))
                self.calls[key] = self.calls.get(key, 0) + 1
                return orig(sigma, *rest, **kw)
            setattr(renderer, self.NAMES[direction], wrapped)
        return self

    def __exit__(self, *exc):
        for direction, orig in self._saved.items():
            setattr(self._mod, self.NAMES[direction], orig)

    def per_direction(self, steps: int) -> dict:
        """direction -> launches a step, bound ms a step and the shapes
        ([n, s], launches a step) it launched at."""
        out = {d: {"launches_per_step": 0.0, "bound_ms_per_step": 0.0,
                   "shapes": []} for d in self.NAMES}
        for (direction, (n, s)), count in self.calls.items():
            rec = out[direction]
            rec["launches_per_step"] += count / steps
            rec["bound_ms_per_step"] += composite_bound(
                n, s, backward=direction == "bwd")["bound_ms"] * count / steps
            rec["shapes"].append([[n, s], count / steps])
        return out


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches after one warm-up,
    from CUDA events. A ~10 ms spin kernel ahead of the start event lets
    the host queue the launches before the card reaches them, so a kernel
    shorter than its Python dispatch is timed on the card, not the host
    (a ``fn`` that synchronises inside is still timed with its host gaps)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Median wall time of ``fn`` (synchronised) over ``reps`` calls."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def kernel_label(name: str) -> str:
    """A readable label for a profiler kernel name: the kernel's own name
    and, for PyTorch's templated element-wise and reduce kernels, the
    innermost functor they apply."""
    import re
    base = re.sub(r"^void |\(anonymous namespace\)::|at::native::", "",
                  name).split("(")[0].split("<")[0]
    ops = re.findall(r"(\w*Functor\w*|\w+_functor|\w+Ops\b|"
                     r"\w+_kernel_cuda)", name)
    return f"{base}[{ops[-1]}]" if ops else base


def profile_device(fn, reps: int, host_ms_each: float,
                   unit: str = "frame", watch: tuple = ()) -> dict:
    """Trace ``reps`` warm calls of ``fn`` with ``torch.profiler``: the
    card's busy time per call (union of its kernel and copy intervals), the
    number of device operations (kernels and copies) per call, the busiest
    kernels, the time per call and share of the busy time of each kernel
    label in ``watch``, the device's idle share of an untraced warm call of
    ``host_ms_each``, and the PyTorch operators per call that took a
    tensor of 64 columns and at least 2^16 rows (the MLP's hidden width:
    what the MLP kernels replaced shows there). Returns nulls when the
    trace holds no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans, by_name, n_kernels, wide = [], {}, 0, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            if e.name.startswith("aten::") and any(
                    len(sh) >= 2 and sh[-1] == 64
                    and math.prod(sh[:-1]) >= 1 << 16
                    for sh in (e.input_shapes or ())):
                wide[e.name] = wide.get(e.name, 0) + 1 / reps
            continue
        n_kernels += 1
        s, t = e.time_range.start, e.time_range.end
        spans.append((s, t))
        label = kernel_label(e.name)
        by_name[label] = by_name.get(label, 0.0) + (t - s)
    if not spans:
        log("profile: the trace holds no device events; idle share not "
            "measured")
        return {f"{unit}s": reps, f"device_ms_per_{unit}": None,
                "idle_share": None}
    spans.sort()
    busy_us, (cur_s, cur_t) = 0.0, spans[0]
    for s, t in spans[1:]:
        if s > cur_t:
            busy_us += cur_t - cur_s
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    busy_us += cur_t - cur_s
    device_ms = busy_us / 1e3 / reps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    watched = {k: by_name.get(k, 0.0) / 1e3 / reps for k in watch}
    return {f"{unit}s": reps, f"device_ms_per_{unit}": device_ms,
            "idle_share": 1.0 - device_ms / host_ms_each,
            f"device_ops_per_{unit}": n_kernels / reps,
            f"ops_on_64_columns_per_{unit}": wide,
            "device_ms_by_kernel": {k: v / 1e3 / reps for k, v in top},
            **({"watched_ms": watched,
                "watched_share": {k: v / device_ms
                                  for k, v in watched.items()}}
               if watch else {})}


def fetch(url: str):
    with urllib.request.urlopen(url, timeout=600) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def write_scene(seed: int, conf, device) -> dict:
    """Phase 2: the seeded full-width scene as a run checkpoint."""
    import numpy as np
    import torch
    from perf_tpu_torch.__main__ import exp_dir_of, scene_configs
    from perf_tpu_torch.train import save_checkpoint
    from perf_tpu_torch.utils import cube_room_occ_grid, random_field_params

    field_cfg, render_cfg, _ = scene_configs(conf)
    params = random_field_params(seed, field_cfg)
    occ = cube_room_occ_grid(render_cfg.occ_res, FRAME_H, FRAME_W,
                             device=device)
    torch.cuda.synchronize()
    state = {"params": params, "occ_grid": occ.cpu().numpy(),
             "global_iter_geo": 0, "global_iter_app": 0, "sample_budget": 0}
    ckpt = os.path.join(exp_dir_of(conf), "checkpoints", "ckpt.npz")
    save_checkpoint(ckpt, {"scene": state, "phase": 0})
    check(int(np.count_nonzero(state["occ_grid"])) > 0, "empty occupancy")
    return {"ckpt": ckpt, "occ_voxels": int(np.count_nonzero(occ.cpu()))}


SERVE_REQUESTS = {
    "pano": "/render?cam=pano",
    "pers": "/render?cam=pers&yaw=0.6&pitch=-0.2",
    "distance": "/render?q=distance",
    "displaced": "/render?px=0.25&py=-0.15&pz=0.1&yaw=0.4&cam=pano",
}


def serve_phase(overrides: list, names=tuple(SERVE_REQUESTS),
                baked: bool = True) -> tuple:
    """Start the CLI's server from the checkpoint and answer the requests
    ``names`` of SERVE_REQUESTS; ``/health`` reports a baked snapshot iff
    ``baked`` (a prop scene has none). Returns (httpd, responses, seconds
    to ready)."""
    from perf_tpu_torch.__main__ import main as cli_main
    t0 = time.perf_counter()
    httpd = cli_main(["--device", "cuda", "--config-name", "nerf",
                      *overrides], block=False)
    ready_s = time.perf_counter() - t0
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    code, ctype, body = fetch(base + "/health")
    health = json.loads(body)
    check(code == 200 and health["status"] == "ok"
          and health["snapshot_baked"] is baked, f"bad /health {health}")
    responses = {}
    for name in names:
        path = SERVE_REQUESTS[name]
        t1 = time.perf_counter()
        code, ctype, body = fetch(base + path)
        ms = (time.perf_counter() - t1) * 1e3
        check(code == 200 and ctype == "image/png", f"{path}: {code} {ctype}")
        responses[name] = (path, body, ms)
    try:
        fetch(base + "/render?cam=nope")
        raise AssertionError("bad cam was not refused")
    except urllib.error.HTTPError as e:
        check(e.code == 400, f"bad cam answered {e.code}")
    return httpd, responses, ready_s


def check_responses(httpd, responses: dict):
    """Each decoded PNG must equal a direct render of its request and be
    non-flat."""
    import numpy as np
    from perf_tpu_torch.app.serve import _pose_from_query
    from perf_tpu_torch.utils.io import decode_png
    srv = httpd.scene_server
    for name, (path, body, ms) in responses.items():
        q = parse_qs(urlparse(path).query)
        img = decode_png(body)
        want = srv.render(_pose_from_query(q), q.get("cam", ["pano"])[0],
                          q.get("q", ["rgb"])[0])
        check(img.shape == want.shape and np.array_equal(img, want),
              f"{name}: PNG differs from a direct render")
        check(float(img.std()) > 5.0, f"{name}: flat image")
        log(f"{name}: {img.shape} std {img.std():.2f} in {ms:.1f} ms")


def compare_field_eval(scene, idx, chunk: int) -> dict:
    import torch
    from perf_tpu_torch.fields.ngp import field_eval, field_eval_plain
    from perf_tpu_torch.render.snapshot import corner_points
    pts = corner_points(idx[:chunk], scene.snap_cfg.res, scene.field_cfg)
    got = field_eval(scene.params, pts, scene.field_cfg)
    ref = field_eval_plain(scene.params, pts, scene.field_cfg)
    torch.cuda.synchronize()
    err = (got - ref).abs()
    scale = ref.abs()
    # Both round to bf16 at the same points, but the MLP's float32 sums run
    # in another order (one thread's FMA chain vs cuBLAS). Away from bf16
    # rounding ties that is ~1e-6 relative; at a tie a hidden unit lands on
    # the neighbouring bf16 value, moving the output by up to a few percent.
    loose = (err > 1e-4 * scale + 1e-6).float().mean().item()
    check(loose <= 2e-3, f"field_eval: {loose:.2e} of outputs off > 1e-4")
    check(bool((err <= 0.05 * scale + 1e-6).all()),
          "field_eval: an output is off by more than 5%")
    g, n = scene.field_cfg.grid, int(pts.shape[0])
    # per point: 12 B in, 16 B out, both bf16 tables once; 8192 MLP
    # multiply-adds of bf16 inputs and weights (geo W0, app W0, app W1),
    # and in float32 the 256 of the last layers plus 2 heads x 16 levels x
    # 8 corners x 2 features of interpolation
    nbytes = n * 28 + 2 * g.n_levels * g.n_bricks * 128 * 2
    bf16_flops = n * 2 * (32 * 64 + 32 * 64 + 64 * 64)
    flops = n * (2 * (64 + 64 * 3) + 2 * g.n_levels * 8 * 2 * 2)
    return {"max_abs_err": err.max().item(), "n": n,
            **bound(nbytes, flops, bf16_flops),
            "max_rel_err": (err / (scale + 1e-6)).max().item(),
            "loose_share": loose,
            "ms": cuda_ms(lambda: field_eval(scene.params, pts,
                                             scene.field_cfg), 10),
            "plain_ms": cuda_ms(lambda: field_eval_plain(
                scene.params, pts, scene.field_cfg), 3)}


def compare_scatter(scene, idx) -> dict:
    import torch
    from perf_tpu_torch.fields.ngp import field_eval
    from perf_tpu_torch.render.snapshot import (
        bake_scatter_pack, bake_scatter_pack_plain, corner_points)
    snap = scene.snap_cfg
    vals = torch.cat([
        field_eval(scene.params,
                   corner_points(idx[s:s + snap.bake_chunk], snap.res,
                                 scene.field_cfg), scene.field_cfg)
        for s in range(0, idx.shape[0], snap.bake_chunk)])
    got = torch.zeros_like(scene.snapshot)
    ref = torch.zeros_like(scene.snapshot)
    bake_scatter_pack(got, idx, vals, snap.res)
    bake_scatter_pack_plain(ref, idx, vals, snap.res)
    torch.cuda.synchronize()
    # the same float32 values rounded to bf16 into the same lanes: bitwise
    check(torch.equal(got, ref), "bake_scatter_pack differs from plain")
    check(torch.equal(got, scene.snapshot), "served table is not the bake")
    err = (got.float() - ref.float()).abs().max().item()
    # per corner: 8 B index and 16 B values in; 8 B (4 bf16) out into each
    # packed row that holds it (up to 2 bricks per axis)
    rp1 = snap.res + 1
    copies = torch.ones_like(idx)
    for a in (idx // (rp1 * rp1), (idx // rp1) % rp1, idx % rp1):
        copies = copies * (1 + ((a % 3 == 0) & (a > 0)).long())
    nbytes = idx.shape[0] * 24 + int(copies.sum()) * 8
    return {"max_abs_err": err, "n": int(idx.shape[0]), **bound(nbytes, 0),
            "ms": cuda_ms(lambda: bake_scatter_pack(got, idx, vals,
                                                    snap.res), 10),
            "plain_ms": cuda_ms(lambda: bake_scatter_pack_plain(
                ref, idx, vals, snap.res), 3)}


def _masked_equal(idx_a, valid_a, idx_b, valid_b) -> bool:
    import torch
    va, vb = valid_a > 0, valid_b > 0
    return bool(torch.equal(va, vb) and torch.equal(
        torch.where(va, idx_a.long(), -1), torch.where(vb, idx_b.long(), -1)))


def compare_march_and_composite(scene, rays, chunk: int) -> tuple:
    """The beam plan of a frame and its busiest chunk's fine stage, then
    that chunk's composite, kernel vs plain."""
    import dataclasses
    import torch
    from perf_tpu_torch.render.renderer import (
        beam_dilation, block_mean_dirs, coarse_occ_grid, march_windows,
        march_windows_plain)
    from perf_tpu_torch.render.snapshot import (
        chunk_budgets, composite_snapshot, composite_snapshot_plain,
        snapshot_render_cfg)
    cfg = snapshot_render_cfg(scene.render_cfg, scene.snap_cfg)
    occ = scene.occ_grid
    dil = beam_dilation(rays.d, cfg)
    ob = rays.o[::4, ::4].reshape(-1, 3).contiguous()
    db = block_mean_dirs(rays.d).contiguous()
    coarse = coarse_occ_grid(occ, cfg.occ_res, dilate=1 + dil)
    plan = march_windows(occ, ob, db, cfg, coarse)
    plan_ref = march_windows_plain(occ, ob, db, cfg, coarse)
    torch.cuda.synchronize()
    # integers: exactly equal (padding slots carry weight 0 and any index)
    check(_masked_equal(plan[3], plan[4], plan_ref[3], plan_ref[4]),
          "march plan: segments differ")
    check(_masked_equal(plan[0], plan[1], plan_ref[0], plan_ref[1]),
          "march plan: windows differ")
    check(torch.equal(plan[2], plan_ref[2]), "march plan: counts differ")

    # per-pixel segments of the plan, as render_snapshot_image expands them
    h4, w4 = FRAME_H // 4, FRAME_W // 4

    def expand(x):
        s = x.shape[1]
        x = x.reshape(h4, w4, s).repeat_interleave(4, 0)
        return x.repeat_interleave(4, 1).reshape(-1, s).contiguous()

    sidx_px, svalid_px = expand(plan[3]), expand(plan[4])
    o, d = rays.o.reshape(-1, 3), rays.d.reshape(-1, 3)
    counts = plan[2].reshape(1, 1, h4, w4).float()
    counts = torch.nn.functional.max_pool2d(counts, 3, 1, padding=1)[0, 0]
    counts = counts.to(torch.int32).repeat_interleave(4, 0)
    counts = counts.repeat_interleave(4, 1).reshape(-1)
    budgets = chunk_budgets(counts, chunk, 2, cfg)
    ci = max(range(len(budgets)), key=lambda i: budgets[i])
    cfg_c = dataclasses.replace(cfg, max_samples=budgets[ci])
    sl = slice(ci * chunk, (ci + 1) * chunk)
    oc, dc = o[sl].contiguous(), d[sl].contiguous()
    seg = (sidx_px[sl], svalid_px[sl])
    fine = march_windows(occ, oc, dc, cfg_c, segments=seg)
    fine_ref = march_windows_plain(occ, oc, dc, cfg_c, segments=seg)
    torch.cuda.synchronize()
    check(_masked_equal(fine[0], fine[1], fine_ref[0], fine_ref[1]),
          "planned chunk: windows differ")
    check(torch.equal(fine[2], fine_ref[2]), "planned chunk: counts differ")
    check(int(fine[2].max()) > 0, "planned chunk marched no window")
    # dense in / out only: rays and segments in, windows and counts out;
    # the one-byte occupancy probes (L2-resident grids) are not counted
    k, s_sel = fine[0].shape[1], seg[0].shape[1]
    march = {
        "max_abs_err": float((torch.where(fine[1] > 0, fine[0], 0)
                              - torch.where(fine_ref[1] > 0, fine_ref[0], 0)
                              ).abs().max().item()),
        "n": int(oc.shape[0]), "budget": budgets[ci],
        **bound(oc.shape[0] * (24 + 5 * s_sel + 8 * k + 4), 0),
        "plan_ms": cuda_ms(lambda: march_windows(occ, ob, db, cfg, coarse),
                           20),
        "plan_plain_ms": cuda_ms(lambda: march_windows_plain(
            occ, ob, db, cfg, coarse), 5),
        "ms": cuda_ms(lambda: march_windows(occ, oc, dc, cfg_c,
                                            segments=seg), 20),
        "plain_ms": cuda_ms(lambda: march_windows_plain(
            occ, oc, dc, cfg_c, segments=seg), 5)}

    widx, wvalid = fine[0], fine[1]
    args = (scene.snapshot, oc, dc, widx, wvalid, scene.field_cfg, cfg_c,
            scene.snap_cfg.res)
    got = composite_snapshot(*args)
    ref = composite_snapshot_plain(*args)
    torch.cuda.synchronize()
    errs = {k: (got[k] - ref[k]).abs().max().item() for k in got}
    # the same table rows and samples; float32 interpolation sums and the
    # transmittance scan in another order: ~1e-6 of values <= 1 (rgb,
    # opacity) and <= 5 (distance)
    check(errs["rgb"] <= 2e-5 and errs["opacity"] <= 2e-5
          and errs["distance"] <= 1e-4, f"composite: {errs}")
    check(float(ref["opacity"].mean()) > 0.1, "composite chunk is empty")
    # rays and windows in, 20 B out per ray; per valid sample 8 corners of
    # 4 bf16 (at most the whole table); ~90 operations per valid sample
    n_smp = int(fine[1].sum().item()) * cfg_c.samples_per_window
    comp_bytes = (oc.shape[0] * (24 + 8 * k + 20)
                  + min(scene.snapshot.numel() * 2, n_smp * 8 * 8))
    comp = {"max_abs_err": max(errs.values()), "n": int(oc.shape[0]),
            **bound(comp_bytes, n_smp * 90),
            "ms": cuda_ms(lambda: composite_snapshot(*args), 20),
            "plain_ms": cuda_ms(lambda: composite_snapshot_plain(*args), 5)}
    return march, comp


def write_room(device) -> str:
    """Phase 2 input: the cube room pano at 2048x1024 as PNG, with the
    cached distance and normal maps beside it (the cache-hit path)."""
    import numpy as np
    import torch
    from perf_tpu_torch.utils import render_cube_room_pano
    from perf_tpu_torch.utils.io import png_bytes
    pose = torch.eye(4, device=device)
    pose[:3, 3] = torch.tensor(ROOM_CAMERA, device=device)
    pano = render_cube_room_pano(pose, ROOM_H, ROOM_W)
    room = os.path.join(RUN_DIR, "room")
    os.makedirs(room, exist_ok=True)
    rgb = torch.round(pano["rgb"].clamp(0, 1) * 255).to(torch.uint8)
    path = os.path.join(room, "image.png")
    with open(path, "wb") as f:
        f.write(png_bytes(rgb.cpu().numpy()))
    np.save(os.path.join(room, "image_ref_distance.npy"),
            pano["distance"].cpu().numpy())
    np.save(os.path.join(room, "image_ref_normal.npy"),
            pano["normal"].cpu().numpy())
    return path


def check_raw_fit(runner) -> dict:
    """The raw fit's checks: finite losses, no skipped step, the depth loss
    of the last 20 geometry steps below half that of the first 20, a
    non-flat ``1.png``. Returns the losses' summary."""
    import numpy as np
    from perf_tpu_torch.utils.io import decode_png
    geo, app = runner.losses["geo_losses"], runner.losses["app_losses"]
    check(np.isfinite(geo).all() and np.isfinite(app).all(),
          "non-finite training loss")
    check((geo[:, -1] == 1).all() and (app[:, -1] == 1).all(),
          f"skipped steps: geo {int((geo[:, -1] == 0).sum())}, "
          f"app {int((app[:, -1] == 0).sum())}")
    d_first, d_last = float(geo[:20, 1].mean()), float(geo[-20:, 1].mean())
    check(d_last < 0.5 * d_first,
          f"depth loss did not fall: {d_first} -> {d_last}")
    with open(os.path.join(runner.exp_dir, "1.png"), "rb") as f:
        img = decode_png(f.read())
    check(img.shape == (512, 1024, 3) and float(img.std()) > 5.0,
          f"1.png flat or misshapen: {img.shape} std {img.std()}")
    return {"depth_loss_first20": d_first, "depth_loss_last20": d_last,
            "color_loss_first20": float(app[:20, 1].mean()),
            "color_loss_last20": float(app[-20:, 1].mean()),
            "skipped_steps": 0, "png_std": float(img.std())}


def train_phase(overrides: list):
    """Phase 2: the CLI's raw fit, checked. Returns (runner, summary)."""
    import torch
    from perf_tpu_torch.__main__ import main as cli_main
    from perf_tpu_torch.train import NeRFScene, SupInfoPool, load_checkpoint
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = cli_main(["--device", "cuda", "--config-name", "nerf",
                       *overrides])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    fit = check_raw_fit(runner)
    scene = runner.scene
    state = load_checkpoint(os.path.join(runner.exp_dir, "checkpoints",
                                         "ckpt.npz"))
    back = NeRFScene(scene.field_cfg, scene.render_cfg,
                     torch.Generator().manual_seed(1), scene.device,
                     scene.snap_cfg, scene.train_cfg)
    back.load_state_dict(state["scene"])
    pool = SupInfoPool()
    pool.load_state_dict(state["sup_pool"])
    check(int(state["phase"]) == 0 and pool.n_valid == runner.sup_pool.n_valid
          and torch.equal(back.params["geo"]["table"],
                          scene.params["geo"]["table"])
          and torch.equal(back.occ_grid, scene.occ_grid),
          "the checkpoint does not load back")
    metrics = {}
    with open(os.path.join(runner.exp_dir, "ts_log", "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            metrics[rec["tag"]] = rec["value"]
    plans = {}
    for phase in ("geo", "app"):
        rc, plan = scene.phase_render_cfg(phase)
        plans[phase] = {"samples": rc.max_samples, "stride": rc.sample_stride,
                        "bucket": list(plan) if plan else None}
    summary = {
        "run_s": run_s, "steps": list(TRAIN_STEPS),
        "batch": scene.train_cfg.pixel_loss_batch_size,
        "episode_geo_s": metrics["time/fit_geo_sec"],
        "episode_app_s": metrics["time/fit_app_sec"],
        "rays_per_s": {"geo": metrics["throughput/fit_geo_rays_per_sec"],
                       "app": metrics["throughput/fit_app_rays_per_sec"]},
        "budget": scene.sample_budget,
        "bucket_plan": list(scene.bucket_plan) if scene.bucket_plan else None,
        "phases": plans, "pool_rays": runner.sup_pool.n_valid,
        "occ_voxels": int(scene.occ_grid.sum()), **fit,
        "max_memory_allocated": peak}
    return runner, summary


def warm_steps(runner) -> dict:
    """Warm single steps of each phase, timed (synchronised, median of 10),
    traced (5 steps) and counted (launches per step over 5 steps)."""
    from perf_tpu_torch.kernels import cuda
    scene = runner.scene
    arrs = runner.sup_pool.device_arrays(scene.device)
    out = {}
    for phase, n_iters in zip(("geo", "app"), TRAIN_STEPS):
        with scene.phase_steps(phase, arrs, n_iters) as steps:
            it = iter(range(1 << 30))

            def step():
                steps.step(next(it) % n_iters)
            step_ms = host_ms(step, 10)
            before = cuda.counts()
            with EncodeRecorder() as rec, MlpRecorder() as mlp_rec, \
                    CompositeRecorder() as comp_rec:
                for _ in range(5):
                    step()
            after = cuda.counts()
            encodes = rec.per_label(5)
            mlp = mlp_rec.per_direction(5)
            composite = comp_rec.per_direction(5)
            parts = {labels[0]: labels for labels in ENCODE_WRAPPERS.values()}
            profile = profile_device(
                step, 5, step_ms, unit="step",
                watch=sum(parts.values(), ()) + sum(MLP_LABELS.values(), ())
                + tuple(COMPOSITE_LABELS.values()))
            watched = profile.get("watched_ms")
            for direction, r in composite.items():
                r["ms_per_step"] = (watched[COMPOSITE_LABELS[direction]]
                                    if watched else None)
                log(f"{phase} step, shade_composite {direction}: "
                    f"{r['ms_per_step']} ms a step over "
                    f"{r['launches_per_step']} launches at {r['shapes']}, "
                    f"in-step bound {r['bound_ms_per_step']:.6f} ms")
            for direction, r in mlp.items():
                r["ms_per_step"] = (sum(watched[k]
                                        for k in MLP_LABELS[direction])
                                    if watched else None)
                log(f"{phase} step, ngp_mlp {direction}: {r['ms_per_step']} "
                    f"ms a step over {r['launches_per_step']} launches, "
                    f"in-step bound {r['bound_ms_per_step']:.6f} ms")
            for label, r in encodes.items():
                # the hash backward's time holds its fill and its
                # transpose pass
                r["ms_per_step"] = (sum(watched[k] for k in parts[label])
                                    if watched else None)
                log(f"{phase} step, {label}: {r['ms_per_step']} ms a step "
                    f"over {r['launches_per_step']} launches, in-step bound "
                    f"{r['bound_ms_per_step']:.6f} ms")
            out[phase] = {
                "step_ms": step_ms,
                "launches_per_step": {k: (after[k] - before[k]) / 5
                                      for k in after
                                      if after[k] != before[k]},
                "profile": profile, "encodes": encodes, "mlp": mlp,
                "composite": composite}
    return out


def _train_inputs(runner, samples: int | None, seed: int,
                  phase: str = "geo"):
    """A batch of 8192 pool rays marched (stratified) at the ``phase``'s
    config (the geometry phase's by default), or at ``samples`` samples of
    stride 1 (the pinned shape): (cfg, coarse, o, d, jitter, march outputs,
    t_mid, valid, nx, ny, nz, strides)."""
    import torch
    from perf_tpu_torch.fields import normalize_coords
    from perf_tpu_torch.kernels.hashgrid import level_strides
    from perf_tpu_torch.render.renderer import (coarse_occ_grid,
                                                march_windows,
                                                windows_to_samples)
    scene = runner.scene
    arrs = runner.sup_pool.device_arrays(scene.device)
    g = torch.Generator(device=scene.device).manual_seed(seed)
    b = PINNED[0]
    o, d, _, _ = scene._sample_batch(
        arrs, torch.rand(b, generator=g, device=scene.device))
    jitter = torch.rand((b, 1), generator=g, device=scene.device)
    cfg = scene.phase_render_cfg(phase)[0]
    if samples:
        cfg = dataclasses.replace(cfg, max_samples=samples, sample_stride=1)
    coarse = coarse_occ_grid(scene.occ_grid, cfg.occ_res)
    march = march_windows(scene.occ_grid, o, d, cfg, coarse, jitter=jitter)
    t_mid, valid = windows_to_samples(march[0], march[1], cfg, jitter)
    px, py, pz = (o[:, a:a + 1] + d[:, a:a + 1] * t_mid for a in range(3))
    nx, ny, nz, _ = normalize_coords(scene.field_cfg, px, py, pz)
    strides = level_strides(scene.field_cfg.grid, cfg.step, t_mid.shape[1])
    return (cfg, coarse, o, d, jitter, march, t_mid, valid,
            nx.contiguous(), ny.contiguous(), nz.contiguous(), strides)


def _brick_bwd_row(table, grid, nx, ny, nz, strides, seed: int) -> dict:
    """``brick_encode_bwd`` against its plain version (within 1e-6 relative
    norm) on cotangents from ``seed``, timed."""
    import torch
    from perf_tpu_torch.kernels.brickgrid import (brick_points_grad_cuda,
                                                  brick_points_grad_plain)
    from perf_tpu_torch.kernels.hashgrid import level_plan
    n, s = nx.shape
    total = level_plan(grid, strides, n, s)[1]
    gen = torch.Generator(device=nx.device).manual_seed(seed)
    g = torch.randn((total, 2), generator=gen, device=nx.device)
    b_got = brick_points_grad_cuda(table.shape, nx, ny, nz, grid, strides, g)
    b_ref = brick_points_grad_plain(table.shape, nx, ny, nz, grid, strides, g)
    torch.cuda.synchronize()
    rel = ((b_got - b_ref).norm() / b_ref.norm()).item()
    return {
        "shape": [n, s], "strides": list(strides), "points": total,
        "max_abs_err": (b_got - b_ref).abs().max().item(),
        "rel_norm_err": rel,
        "ms": cuda_ms(lambda: brick_points_grad_cuda(
            table.shape, nx, ny, nz, grid, strides, g), 20),
        "plain_ms": cuda_ms(lambda: brick_points_grad_plain(
            table.shape, nx, ny, nz, grid, strides, g), 3),
        # coordinates and cotangents in, the float32 gradient out; per
        # point 8 weights of 2 products, 16 products and 16 sums
        **bound(3 * n * s * 4 + total * 8 + table.numel() * 4,
                total * 64)}


def _brick_fwd_row(table, grid, nx, ny, nz, strides) -> dict:
    """``brick_encode``'s forward, the lerped, level-concatenated [N, S,
    L * F] features, against its plain version (within 1e-6), timed, with
    the glue it absorbed timed beside it."""
    import torch
    from perf_tpu_torch.kernels.brickgrid import (brick_encode_ray_cuda,
                                                  brick_encode_ray_plain)
    from perf_tpu_torch.kernels.hashgrid import level_plan
    n, s = nx.shape
    plan, total = level_plan(grid, strides, n, s)
    got = brick_encode_ray_cuda(table, nx, ny, nz, grid, strides)
    ref = brick_encode_ray_plain(table, nx, ny, nz, grid, strides)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    check(err <= 1e-6 * max(1.0, ref.abs().max().item()),
          f"brick_encode ({n} x {s}): {err}")
    return {
        "shape": [n, s], "strides": list(strides), "points": total,
        "max_abs_err": err,
        "ms": cuda_ms(lambda: brick_encode_ray_cuda(table, nx, ny, nz, grid,
                                                    strides), 20),
        "plain_ms": cuda_ms(lambda: brick_encode_ray_plain(
            table, nx, ny, nz, grid, strides), 3),
        "glue_ms": glue_ms(plan, n, s, nx.device),
        **encode_bound(grid, n, s, strides)}


def _hash_fwd_row(table, grid, nx, ny, nz, strides) -> dict:
    """``hash_encode``'s forward (linear), the lerped, level-concatenated
    [N, S, L * F] features, against its plain version bitwise (the same
    corners, weights, sums and lerp in the same order), timed, with the
    glue it absorbed timed beside it."""
    import torch
    from perf_tpu_torch.kernels.hashgrid import (hash_encode_ray_cuda,
                                                 hash_encode_ray_plain,
                                                 level_plan)
    n, s = nx.shape
    plan, total = level_plan(grid, strides, n, s)
    got = hash_encode_ray_cuda(table, nx, ny, nz, grid, strides)
    ref = hash_encode_ray_plain(table, nx, ny, nz, grid, strides)
    torch.cuda.synchronize()
    check(torch.equal(got, ref), f"hash_encode ({n} x {s}): "
          f"{(got - ref).abs().max().item()}")
    return {
        "shape": [n, s], "strides": list(strides), "points": total,
        "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: hash_encode_ray_cuda(table, nx, ny, nz, grid,
                                                   strides), 20),
        "plain_ms": cuda_ms(lambda: hash_encode_ray_plain(
            table, nx, ny, nz, grid, strides), 3),
        "glue_ms": glue_ms(plan, n, s, nx.device),
        **encode_bound(grid, n, s, strides)}


def _hash_bwd_row(grid, nx, ny, nz, strides, gen) -> dict:
    """``hash_encode_bwd`` (or its smoothstep instance) on the features'
    bf16-valued cotangent [N, S, L * F], as the fields deliver it, against
    its plain version (``lerp_levels_transpose``, then the scatter) and
    against a second run of itself, within HASH_BWD_TOL; timed, with the
    glue it absorbed (the lerp's and the concatenation's transpose) timed
    beside it."""
    import torch
    from perf_tpu_torch.kernels.hashgrid import (hash_encode_ray_bwd_cuda,
                                                 hash_encode_ray_bwd_plain,
                                                 lerp_levels_transpose,
                                                 level_plan)
    n, s = nx.shape
    plan, total = level_plan(grid, strides, n, s)
    shape = grid.table_shape
    g = torch.randn((n, s, grid.out_dim), generator=gen, device=nx.device)
    g = g.to(torch.bfloat16).float()
    got = hash_encode_ray_bwd_cuda(shape, nx, ny, nz, grid, strides, g)
    again = hash_encode_ray_bwd_cuda(shape, nx, ny, nz, grid, strides, g)
    ref = hash_encode_ray_bwd_plain(shape, nx, ny, nz, grid, strides, g)
    torch.cuda.synchronize()
    rel = ((got - ref).norm() / ref.norm()).item()
    rerun = ((again - got).norm() / got.norm()).item()
    check(rel <= HASH_BWD_TOL and rerun <= HASH_BWD_TOL,
          f"hash backward ({n} x {s}): rel {rel}, rerun {rerun}")
    return {
        "shape": [n, s], "strides": list(strides), "points": total,
        "max_abs_err": (got - ref).abs().max().item(),
        "rel_norm_err": rel, "rerun_rel_norm": rerun,
        "ms": cuda_ms(lambda: hash_encode_ray_bwd_cuda(
            shape, nx, ny, nz, grid, strides, g), 20),
        "plain_ms": cuda_ms(lambda: hash_encode_ray_bwd_plain(
            shape, nx, ny, nz, grid, strides, g), 3),
        "glue_ms": cuda_ms(lambda: lerp_levels_transpose(
            g, plan, n, s, total), 20),
        **encode_bound(grid, n, s, strides, backward=True)}


def _exact_hidden_last(ws, x, sel, raw, g, head):
    """The bf16 head's last-layer gradient over hidden outputs whose own sums
    ran in float64 (each rounded to float32 once, then to bf16): no float32
    sum order decides which way they round. Float64 [64, C]."""
    import torch
    from perf_tpu_torch.fields.mlp import _bf16, head_epilogue_grad
    h = _bf16(x)
    for w in ws[:-1]:
        h = _bf16(torch.relu((h.double() @ _bf16(w).double()).float()))
    return h.double().T @ head_epilogue_grad(raw, sel, g, head).T.double()


def _mlp_bwd_part(ws, x, sel, raw, g, head) -> tuple:
    """The backward kernel launched as ``ngp_mlp_bwd_cuda`` launches it, its
    blocks' partial rows kept: (the weights' gradients, the last layer's
    partial rows [blocks, 64, C] float32)."""
    import torch
    from perf_tpu_torch.kernels import ngp_mlp
    index, din = ngp_mlp._check_args(ws, x, sel, head)
    m, hid = x.shape[0], ngp_mlp.HIDDEN
    sizes = ([din * hid] + [hid * hid] * (head.hidden - 1)
             + [hid * head.channels])
    blocks = ngp_mlp.bwd_blocks(head, m, x.device)
    part = torch.empty((blocks, sum(sizes)), dtype=torch.float32,
                       device=x.device)
    grad = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    ngp_mlp._BWD.launch(index, x.data_ptr(), sel.data_ptr(), raw.data_ptr(),
                        g.data_ptr(), m, din, *ngp_mlp._layer_ptrs(ws),
                        dx.data_ptr(), part.data_ptr(), blocks,
                        grad.data_ptr())
    torch.cuda.synchronize()
    return ([v.view(w.shape) for v, w in zip(grad.split(sizes), ws)],
            part[:, sum(sizes[:-1]):].view(blocks, hid, head.channels))


def _last_rows_within(rows, h, d, d_move, tile: int, drop=None) -> float:
    """The largest |row - sum| / bound over the entries of a bf16 head's
    last-layer partial rows ``rows`` [blocks, 64, C] (block b sums the
    tiles b, b + blocks, ... of ``tile`` points), against the float64 sums
    of the plain version's terms h^T d over each block's points (h [M, 64]
    the bf16 hidden values, d [M, C] the epilogue's cotangent; each product
    exact in float64). The bound: the kernel's float32 FMA chain over half
    a tile, then the block's tiles, then the two halves' sum pass a term
    through D = tile / 2 + tiles + 1 roundings at most, so gamma_D = D u /
    (1 - D u) (u = 2^-24) of the terms' magnitudes; the kernel's own
    cotangent lies within ``d_move`` of d, in those magnitudes and as a
    move; 2^-40 of the magnitudes covers the float64 sums. ``drop``: the
    control, the rows with that tile's terms left out of its block's."""
    import torch
    blocks = rows.shape[0]
    pad = -h.shape[0] % tile
    h64, d64, m64 = (torch.nn.functional.pad(t.double(), (0, 0, 0, pad))
                     .view(-1, tile, t.shape[1]) for t in (h, d, d_move))
    blk = torch.arange(h64.shape[0], device=h.device) % blocks
    exact_t = torch.einsum("tpk,tpc->tkc", h64, d64)
    sums = {}
    for key, per_tile in (
            ("exact", exact_t),
            ("mag", torch.einsum("tpk,tpc->tkc", h64.abs(), d64.abs())),
            ("move", torch.einsum("tpk,tpc->tkc", h64.abs(), m64))):
        sums[key] = torch.zeros((blocks,) + per_tile.shape[1:],
                                dtype=torch.float64,
                                device=h.device).index_add_(0, blk, per_tile)
    depth = (tile // 2 + torch.bincount(blk, minlength=blocks) + 1).double()
    gamma = (depth * 2.0 ** -24 / (1.0 - depth * 2.0 ** -24))[:, None, None]
    bound = (gamma * (sums["mag"] + sums["move"]) + sums["move"]
             + 2.0 ** -40 * sums["mag"])
    got = rows.double().clone()
    if drop is not None:
        got[drop % blocks] -= exact_t[drop]
    off = (got - sums["exact"]).abs()
    ratio = torch.where(bound > 0, off / bound.clamp_min(1e-300),
                        torch.where(off > 0, math.inf, 0.0))
    return ratio.max().item()


def _mlp_bf16_checks(ws, x, sel, raw, g, head, got, want) -> dict:
    """A bf16 head's backward ``got`` against the plain version's ``want``
    by ``fields/mlp.py`` ``bf16_grads_within`` on the full cotangent (dx
    within one bf16 ulp or the span of the moves the sums' order can carry
    to it, ``bf16_head_reach``; the weight gradients by their float64 sums
    plus the reach of their terms; the last layer within 1e-5 plus its
    terms' reach), then on the points no tie reaches (``tie_free``, the
    cotangent zero elsewhere: one ulp, the float64 sums, 1e-5, as for any
    two float32 sums of the same terms; the last layer also block row by
    block row, ``_last_rows_within``), with three controls that must fail:
    dx with five of its nonzero rows zeroed, the tie-free last layer with
    the 64-point tile of the cotangent whose terms weigh most dropped, the
    forward with its hidden outputs left unrounded."""
    import torch
    from perf_tpu_torch.fields.mlp import (_bf16, _epilogue_reach,
                                           bf16_grad_sums_f64,
                                           bf16_grads_within, bf16_head_reach,
                                           head_epilogue, ngp_head_bwd_plain,
                                           ngp_head_bwd_terms, ngp_head_plain)
    from perf_tpu_torch.kernels.ngp_mlp import KERNEL_HEADS, ngp_mlp_bwd_cuda

    def flat(t):
        return [t[0], *t[1]]

    def judge(g_, got_, want_):
        reach = bf16_head_reach(ws, x, sel, raw, g_, head)
        sums = bf16_grad_sums_f64(ws, x, sel, raw, g_, head)
        return reach, sums, bf16_grads_within(got_, want_, sums, reach)

    name = f"ngp_mlp_bwd ({head.name}, {x.shape[0]})"
    reach, sums, full = judge(g, got, want)
    check(all(full["ok"].values()), f"{name}: {full}")
    bad = [t.clone() for t in got]
    rows = torch.nonzero(want[0].abs().sum(dim=1) > 0).flatten()[-5:]
    bad[0][rows] = 0.0
    ctrl_dx = bf16_grads_within(bad, want, sums, reach)
    check(not ctrl_dx["ok"]["dx"], f"{name}: dx with five rows zeroed "
          f"passes: {ctrl_dx}")
    tie_free = reach["tie_free"]
    g2 = g * tie_free
    got2 = flat(ngp_mlp_bwd_cuda(ws, x, sel, raw, g2, head))
    want2 = flat(ngp_head_bwd_plain(ws, x, sel, raw, g2, head))
    reach2, sums2, free = judge(g2, got2, want2)
    check(all(free["ok"].values())
          and all(bool((t == 0).all()) for t in reach2["terms"]),
          f"{name}, tie-free points: {free}")
    # the tie-free last layer, also block row by block row: the kernel's
    # partial rows against the float64 sums of the plain version's terms
    # over each block's points. Its norm's bar (1e-5 plus the epilogue's
    # reach, about 1e-3 of the norm at 2^20 points) cannot see a 64-point
    # tile left out; a block's row can
    tiles = KERNEL_HEADS[head][2]
    grads_p, rows2 = _mlp_bwd_part(ws, x, sel, raw, g2, head)
    check(torch.equal(grads_p[-1], got2[-1]), f"{name}: the partial rows' "
          "launch differs from the wrapper's")
    acts, _, d, _ = ngp_head_bwd_terms(ws, x, sel, raw, g2, head,
                                       need_dx=False)
    d_move = _epilogue_reach(raw, sel, g2, head).T
    rows_ratio = _last_rows_within(rows2, acts[-1], d, d_move, tiles)
    check(rows_ratio <= 1.0, f"{name}, tie-free points: a block's row of "
          f"the last layer is off by {rows_ratio} of its bound")
    # the 64-point tile of the cotangent whose terms weigh most, dropped
    weight = acts[-1].abs().sum(dim=1) * d.abs().sum(dim=1)
    weight = torch.nn.functional.pad(weight, (0, -weight.shape[0] % tiles))
    tile = int(weight.view(-1, tiles).sum(dim=1).argmax())
    g3 = g2.clone()
    g3[:, tiles * tile:tiles * tile + tiles] = 0.0
    drop = flat(ngp_head_bwd_plain(ws, x, sel, raw, g3, head))
    ctrl_tile = bf16_grads_within(drop, want2, sums2, reach2)
    ctrl_rows = _last_rows_within(rows2, acts[-1], d, d_move, tiles,
                                  drop=tile)
    del acts, d, d_move
    check(not (ctrl_tile["ok"]["last"] and ctrl_rows <= 1.0),
          f"{name}: a dropped tile passes: {ctrl_tile}, its block's row "
          f"off by {ctrl_rows} of its bound")
    h = _bf16(x)
    for w in ws[:-1]:
        h = torch.relu(h @ _bf16(w))
    unrounded = head_epilogue((h @ ws[-1]).T, sel, head)
    ref = ngp_head_plain(ws, x, sel, head)[0]
    ctrl_fwd = ((unrounded - ref).abs() > 1e-4 * ref.abs()).float().mean()
    check(ctrl_fwd.item() > MLP_LOOSE_SHARE, f"{name}: the forward with its "
          f"hidden outputs unrounded passes ({ctrl_fwd.item()})")
    exact = _exact_hidden_last(ws, x, sel, raw, g, head)
    return {"max_ulps": full["max_ulps"], "past_one_ulp": full["past_ulp"],
            "last_rel": full["last_rel"],
            "tie_free_share": tie_free.float().mean().item(),
            "tie_free": {**{k: free[k] for k in ("max_ulps", "past_ulp",
                                                 "last_rel")},
                         "last_row_over_bound": rows_ratio},
            "last_rel_to_exact_hidden": {
                k: ((v.double() - exact).norm() / exact.norm()).item()
                for k, v in (("kernel", got[-1]), ("plain", want[-1]))},
            "controls": {"dx_rows_zeroed_past_bound":
                         ctrl_dx["past_reach"]["dx"],
                         "tile_dropped_last_rel": ctrl_tile["last_rel"],
                         "tile_dropped_row_over_bound": ctrl_rows,
                         "fwd_unrounded_loose_share": ctrl_fwd.item()}}


def _mlp_rows(head, ws, x, sel, gen) -> tuple:
    """``ngp_mlp`` and ``ngp_mlp_bwd`` rows of one head at inputs x [M, din]
    inside sel: the forward against ``ngp_head_plain`` (at most
    MLP_LOOSE_SHARE of the outputs off by > 1e-4 relative: bf16 ties), the
    backward on the kernel's raw outputs and cotangents from ``gen``
    against ``ngp_head_bwd_plain`` (the bf16 heads by ``_mlp_bf16_checks``;
    the float32 proposal head's gradients all within 1e-5 relative norm)
    and against a second launch (bitwise); each timed beside its plain
    version and the PyTorch route (the plain forward under autograd, its
    backward by autograd)."""
    import torch
    from perf_tpu_torch.fields.mlp import ngp_head_bwd_plain, ngp_head_plain
    from perf_tpu_torch.kernels.ngp_mlp import (bwd_blocks, ngp_mlp_bwd_cuda,
                                                ngp_mlp_fwd_cuda)
    from perf_tpu_torch.tools.mlp_probe import grad_reduce_cuda, kernel_facts
    m, din = x.shape
    out, raw = ngp_mlp_fwd_cuda(ws, x, sel, head, save_raw=True)
    ref, _ = ngp_head_plain(ws, x, sel, head)
    loose = ((out - ref).abs() > 1e-4 * ref.abs()).float().mean().item()
    check(bool(torch.isfinite(out).all()) and loose <= MLP_LOOSE_SHARE,
          f"ngp_mlp ({head.name}, {m}): {loose} of the outputs off")
    g = torch.randn((head.channels, m), generator=gen, device=x.device)
    got = ngp_mlp_bwd_cuda(ws, x, sel, raw, g, head)
    again = ngp_mlp_bwd_cuda(ws, x, sel, raw, g, head)
    want = ngp_head_bwd_plain(ws, x, sel, raw, g, head)
    got, again, want = ([t[0], *t[1]] for t in (got, again, want))
    rerun = all(torch.equal(a, b) for a, b in zip(got, again))
    check(rerun, f"ngp_mlp_bwd ({head.name}, {m}): a second launch differs")
    if head.bf16:
        checks = _mlp_bf16_checks(ws, x, sel, raw, g, head, got, want)
    else:
        rel = max(((a - b).norm() / b.norm()).item() for a, b in
                  zip(got, want))
        check(rel <= 1e-5, f"ngp_mlp_bwd ({head.name}, {m}): rel {rel}")
        checks = {"rel_norm_err": rel}
    lx = x.clone().requires_grad_(True)
    lws = [w.detach().clone().requires_grad_(True) for w in ws]
    route = [ngp_head_plain(lws, lx, sel, head)[0]]

    def route_fwd():
        route[0] = ngp_head_plain(lws, lx, sel, head)[0]
    common = {"head": head.name, "shape": [m, din]}
    # the backward's second kernel alone: the sum of the blocks' partial
    # rows at this call's grid
    n_w = sum(w.numel() for w in ws)
    part = torch.randn((bwd_blocks(head, m, x.device), n_w), generator=gen,
                       device=x.device)
    n_round = n_w - ws[-1].numel() if head.bf16 else 0
    fwd = {**common, "max_abs_err": (out - ref).abs().max().item(),
           "loose_share": loose,
           "ms": cuda_ms(lambda: ngp_mlp_fwd_cuda(ws, x, sel, head,
                                                  save_raw=True), 20),
           "plain_ms": cuda_ms(lambda: ngp_head_plain(ws, x, sel, head), 5),
           "pytorch_route_ms": cuda_ms(route_fwd, 5),
           "build": kernel_facts(head, backward=False),
           **mlp_bound(head, m, din)}
    bwd = {**common, "max_abs_err": max((a - b).abs().max().item()
                                        for a, b in zip(got, want)),
           **checks, "rerun_equal": rerun,
           "ms": cuda_ms(lambda: ngp_mlp_bwd_cuda(ws, x, sel, raw, g,
                                                  head), 20),
           "plain_ms": cuda_ms(lambda: ngp_head_bwd_plain(ws, x, sel, raw,
                                                          g, head), 5),
           "pytorch_route_ms": cuda_ms(lambda: torch.autograd.grad(
               route[0], [lx, *lws], g, retain_graph=True), 5),
           "reduce_ms": cuda_ms(lambda: grad_reduce_cuda(part, n_round), 20),
           "build": kernel_facts(head, backward=True),
           **mlp_bound(head, m, din, backward=True)}
    return fwd, bwd


def dedup_grad_moves(got, want, g_abs) -> tuple:
    """(share of the entries of the dedup table gradient ``got`` that moved
    off ``want`` by more than float32 sums in another order can, whether
    each entry lies within one bf16 ulp of ``g_abs`` of it): ``g_abs`` is
    the plain backward of the cotangents' magnitudes, which bounds every
    run's sum that reaches the entry."""
    import torch
    diff = (got - want).abs().double()
    mag = g_abs.double()
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-38))) - 7)
    moved = diff > 1e-6 * mag
    return (moved.double().mean().item(),
            bool((diff <= ulp + 1e-6 * mag).all()))


def _mlp_step_inputs(runner, head, seed: int) -> tuple:
    """A step's MLP inputs on a trained field: the head's encoded features
    [M, 32] and select [M] at 8192 pool rays marched at the head's phase
    config, all samples for the density head, the first train_rgb_windows x
    samples_per_window samples a ray for the colour head (the shape of the
    step's window gather)."""
    import torch
    from perf_tpu_torch.fields import normalize_coords
    from perf_tpu_torch.render.renderer import _strides
    scene = runner.scene
    fc = scene.field_cfg
    cfg, _, o, d, _, _, t_mid, _, *_, strides = _train_inputs(
        runner, None, seed, head.name)
    if head.name == "app":
        kw, c = cfg.train_rgb_windows, cfg.samples_per_window
        if kw and kw * c < t_mid.shape[1]:
            t_mid = t_mid[:, :kw * c]
            strides = _strides(fc, cfg, kw * c)
    nx, ny, nz, sel = normalize_coords(fc, *(o[:, a:a + 1] + d[:, a:a + 1]
                                             * t_mid for a in range(3)))
    with torch.no_grad():
        feats = fc.grid.encode_ray(scene.params[head.name]["table"],
                                   nx.contiguous(), ny.contiguous(),
                                   nz.contiguous(), strides)
    return feats.reshape(-1, feats.shape[-1]), sel.reshape(-1).contiguous()


def compare_mlp_kernels(runner, hash_runner, prop_runner, seed: int) -> dict:
    """The MLP kernels (every head, forward and backward) against their
    plain versions at the brick and hash steps' shapes on their trained
    fields, the colour head at the step's window gather, the proposal head
    at level 0's points of a prop step's cascade (8192 x 128) and the
    colour head at the prop step's final points (8192 x 64, the largest
    MLP launch of any step)."""
    import torch
    from perf_tpu_torch.fields import normalize_coords
    from perf_tpu_torch.fields.mlp import APP_HEAD, GEO_HEAD, PROP_HEAD
    from perf_tpu_torch.kernels.hashgrid import hash_encode
    from perf_tpu_torch.train.prop_scene import PROP_FIELD_CFGS
    gen = torch.Generator(device=runner.scene.device).manual_seed(seed + 6)
    res = {"ngp_mlp": {}, "ngp_mlp_bwd": {}}

    def measure(tag, head, ws, x, sel):
        res["ngp_mlp"][tag], res["ngp_mlp_bwd"][tag] = _mlp_rows(
            head, ws, x, sel, gen)

    for tag, r, head in (("scene", runner, GEO_HEAD),
                         ("geo_hash", hash_runner, GEO_HEAD),
                         ("app_windows", runner, APP_HEAD),
                         ("app_hash", hash_runner, APP_HEAD)):
        measure(tag, head, r.scene.params[head.name]["mlp"]["w"],
                *_mlp_step_inputs(r, head, seed))
    levels, final = _prop_inputs(prop_runner, seed)
    pc, pp = PROP_FIELD_CFGS[0], prop_runner.scene.prop_params[0]
    x01 = ((levels[0]["pts"].reshape(-1, 3) - pc.aabb_min)
           / (pc.aabb_max - pc.aabb_min)).contiguous()
    with torch.no_grad():
        feats = hash_encode(pp["table"], x01, pc.grid)
    measure("prop_points", PROP_HEAD, pp["mlp"]["w"], feats,
            ((x01 > 0.0) & (x01 < 1.0)).all(dim=-1))
    # the prop app step's colour head: the final field's 8192 x 64 points
    # at stride 1, as render_rays_prop queries them
    ps = prop_runner.scene
    fc = ps.field_cfg
    nx, ny, nz, sel = normalize_coords(fc, *final["xyz"])
    with torch.no_grad():
        feats = fc.grid.encode_ray(ps.params["app"]["table"], nx.contiguous(),
                                   ny.contiguous(), nz.contiguous(),
                                   (1,) * fc.grid.n_levels)
    measure("prop_app", APP_HEAD, ps.params["app"]["mlp"]["w"],
            feats.reshape(-1, feats.shape[-1]), sel.reshape(-1).contiguous())
    return {name: {**r["scene"], **{t: v for t, v in r.items()
                                    if t != "scene"}}
            for name, r in res.items()}


def _composite_sigma(scene, cfg, o, d, t_mid, valid):
    """sigma of the trained density field at [n, s] samples, where-masked
    to 0 at invalid ones (as ``shade_rays`` gives the composite)."""
    import torch
    from perf_tpu_torch.fields import query_density_ray
    from perf_tpu_torch.kernels.hashgrid import level_strides
    strides = level_strides(scene.field_cfg.grid, cfg.step, t_mid.shape[1])
    with torch.no_grad():
        sigma = query_density_ray(scene.params["geo"], *(
            o[:, a:a + 1] + d[:, a:a + 1] * t_mid for a in range(3)),
            scene.field_cfg, strides)
    return torch.where(valid > 0, sigma, torch.zeros_like(sigma)).contiguous()


def _bucket_inputs(scene, cfg, o, d, jitter, march) -> dict:
    """The geometry step's two buckets of this batch (``render_rays_bucketed``:
    the rays sorted by occupied windows, the n - n_high lowest at s_low
    samples, the rest at the budget): {"bucket_low": (sigma, t, valid),
    "bucket_high": ...}. The episode must have a bucket plan."""
    import torch
    from perf_tpu_torch.render.renderer import windows_to_samples
    plan = scene.phase_render_cfg("geo")[1]
    check(bool(plan), "composite: the episode's geometry step has no bucket "
          "plan, so the bucket shapes cannot be held")
    s_low, n_high = plan
    widx, wvalid, counts = march[:3]
    order = torch.argsort(counts, stable=True)
    n_low, spw = o.shape[0] - n_high, cfg.samples_per_window
    out = {}
    for name, rows, windows in (("bucket_low", order[:n_low], s_low // spw),
                                ("bucket_high", order[n_low:],
                                 widx.shape[1])):
        t_b, v_b = windows_to_samples(widx[rows, :windows],
                                      wvalid[rows, :windows], cfg,
                                      jitter[rows])
        out[name] = (_composite_sigma(scene, cfg, o[rows], d[rows], t_b, v_b),
                     t_b.contiguous(), v_b.contiguous())
    return out


def composite_bound(n: int, s: int, backward: bool = False) -> dict:
    """The composite's bound by the function's bytes: sigma, t and valid
    read and one [n, s] output written (the weights forward, dsigma
    backward), 12 bytes a ray (the three per-ray outputs forward, their
    cotangents backward); ~30 float32 operations a sample forward, ~40
    backward."""
    return bound(n * s * 16 + n * 12, n * s * (40 if backward else 30))


def _composite_rows(sigma, t_mid, valid, delta: float, gen, tag: str):
    """The K4 rows at one shape: both kernels against the plain version
    (forward within 1e-5 of the outputs; backward within 1e-4 relative to
    its largest entry), a second backward launch bitwise, both again on
    the same rays with their densities scaled to a total tau of 3, and the
    times."""
    import torch
    from perf_tpu_torch.render.renderer import (
        composite_lanes, shade_composite_cuda, shade_composite_grad_cuda,
        shade_composite_plain)
    n, s = t_mid.shape
    c_got = shade_composite_cuda(sigma, t_mid, valid, delta)
    c_ref = shade_composite_plain(sigma, t_mid, valid, delta)
    torch.cuda.synchronize()
    errs = [(a - b).abs().max().item() for a, b in zip(c_got, c_ref)]
    # float32 lane runs and shuffle scans against cumsum / sum: ~1e-6 of
    # values <= 1 (weights, opacity), <= 1.5 (distance)
    check(max(errs) <= 1e-5, f"shade_composite ({tag}): {errs}")
    check(bool(all(torch.isfinite(x).all() for x in c_got)),
          f"shade_composite ({tag}): not finite")
    if tag == "scene":
        check(float(c_ref[1].mean()) > 0.2, f"composite ({tag}) transparent")
    lanes = list(composite_lanes(s))
    fwd = {"shape": [n, s], "lanes": lanes, "max_abs_err": max(errs),
           "ms": cuda_ms(lambda: shade_composite_cuda(sigma, t_mid, valid,
                                                      delta), 20),
           "plain_ms": cuda_ms(lambda: shade_composite_plain(
               sigma, t_mid, valid, delta), 5),
           "was_bound_ms": bound(n * s * 20 + n * 12, n * s * 30)["bound_ms"],
           **composite_bound(n, s)}
    cots = [torch.randn(sh, generator=gen, device=sigma.device)
            for sh in ((n, 1), (n, 1), (n,))]
    g_got = shade_composite_grad_cuda(sigma, t_mid, valid, delta, *cots)
    again = shade_composite_grad_cuda(sigma, t_mid, valid, delta, *cots)
    sig_req = sigma.clone().requires_grad_(True)
    outs = shade_composite_plain(sig_req, t_mid, valid, delta)[1:]
    lin = sum((a * c).sum() for a, c in zip(outs, cots))
    (g_ref,) = torch.autograd.grad(lin, sig_req, retain_graph=True)
    torch.cuda.synchronize()
    # a reverse scan against autograd's: relative to the largest entry. A
    # batch whose rays all saturate at their first sample (T and exp(-tau)
    # underflow to 0 past it) has dsigma exactly 0 in both; then the kernel
    # must give exactly 0 too
    diff, ref_max = ((g_got - g_ref).abs().max().item(),
                     g_ref.abs().max().item())
    gerr = diff / ref_max if ref_max > 0 else (0.0 if diff == 0 else math.inf)
    check(bool(torch.isfinite(g_got).all()) and gerr <= 1e-4,
          f"shade_composite_bwd ({tag}): {gerr}")
    check(torch.equal(g_got, again),
          f"shade_composite_bwd ({tag}): a second launch differs")
    if ref_max == 0:
        log(f"shade_composite_bwd ({tag}): dsigma is 0 on every sample "
            f"(kernel and plain): every ray saturates at its first sample")
    # the trained field saturates most rays within a few samples (dsigma 0
    # past them; at the high bucket on every sample), so both kernels are
    # held again on the same rays with each ray's densities scaled to a
    # total tau of 3: the field's shape along the ray, every sample's
    # dsigma nonzero
    tot = sigma.sum(1, keepdim=True) * delta
    soft = torch.where(tot > 0, sigma * (3.0 / tot.clamp_min(1e-30)),
                       torch.zeros_like(sigma))
    s_got = shade_composite_cuda(soft, t_mid, valid, delta)
    soft_req = soft.clone().requires_grad_(True)
    s_ref = shade_composite_plain(soft_req, t_mid, valid, delta)
    s_lin = sum((a * c).sum() for a, c in zip(s_ref[1:], cots))
    (s_gref,) = torch.autograd.grad(s_lin, soft_req)
    s_g = shade_composite_grad_cuda(soft, t_mid, valid, delta, *cots)
    torch.cuda.synchronize()
    s_errs = [(a - b.detach()).abs().max().item()
              for a, b in zip(s_got, s_ref)]
    check(max(s_errs) <= 1e-5, f"shade_composite ({tag}, scaled): {s_errs}")
    s_gmax = s_gref.abs().max().item()
    s_gerr = (s_g - s_gref).abs().max().item() / s_gmax if s_gmax else 0.0
    check(bool(torch.isfinite(s_g).all()) and s_gmax > 0 and s_gerr <= 1e-4,
          f"shade_composite_bwd ({tag}, scaled): {s_gerr}")
    fwd["scaled_max_abs_err"] = max(s_errs)
    bwd = {"shape": [n, s], "lanes": lanes, "max_abs_err": diff,
           "max_rel_err": gerr, "rerun_equal": True,
           "dsigma_nonzero_share": (g_ref != 0).float().mean().item(),
           "scaled_max_rel_err": s_gerr,
           "scaled_dsigma_nonzero_share":
               (s_gref != 0).float().mean().item(),
           "ms": cuda_ms(lambda: shade_composite_grad_cuda(
               sigma, t_mid, valid, delta, *cots), 20),
           "plain_ms": cuda_ms(lambda: torch.autograd.grad(
               lin, sig_req, retain_graph=True), 5),
           "was_bound_ms": bound(n * s * 24 + n * 12, n * s * 40)["bound_ms"],
           **composite_bound(n, s, backward=True)}
    return fwd, bwd


def compare_train_kernels(runner, seed: int) -> dict:
    """Each training kernel against its plain version at the smoke scene's
    geometry-phase shape (8192 rays at the phase budget) and at the pinned
    8192 x 128, the composite also at the geometry step's two buckets of
    the scene's batch; the pool-sized kernels (occupancy grid, window
    counts) at their path's shapes."""
    import numpy as np
    import torch
    from perf_tpu_torch.render.occgrid import (occ_grid_from_points_cuda,
                                               occ_grid_from_points_plain)
    from perf_tpu_torch.render.renderer import (
        count_occupied_windows_cuda, count_occupied_windows_plain,
        march_windows_cuda, march_windows_plain)
    scene = runner.scene
    grid = scene.field_cfg.grid
    table = scene.params["geo"]["table"]
    res = {k: {} for k in ("brick_encode", "brick_encode_bwd",
                           "march_windows_stratified", "shade_composite",
                           "shade_composite_bwd")}
    for tag, samples in (("scene", None), ("pinned", PINNED[1])):
        (cfg, coarse, o, d, jitter, march, t_mid, valid, nx, ny, nz,
         strides) = _train_inputs(runner, samples, seed)
        n, s = t_mid.shape
        occ = scene.occ_grid

        # the stratified march: integers, every slot exactly
        got = march_windows_cuda(occ, o, d, cfg, coarse, jitter=jitter)
        ref = march_windows_plain(occ, o, d, cfg, coarse, jitter=jitter)
        torch.cuda.synchronize()
        for a, b_ in zip(got, ref):
            check(torch.equal(a, b_), f"stratified march ({tag}) differs")
        k, ms = got[0].shape[1], got[3].shape[1]
        res["march_windows_stratified"][tag] = {
            "shape": [n, s], "max_abs_err": 0.0,
            "ms": cuda_ms(lambda: march_windows_cuda(
                occ, o, d, cfg, coarse, jitter=jitter), 20),
            "plain_ms": cuda_ms(lambda: march_windows_plain(
                occ, o, d, cfg, coarse, jitter=jitter), 5),
            **bound(n * (28 + 5 * ms + 8 * k + 4), 0)}

        # brick encode forward: the same 8 bf16 corners, float32 sums in
        # another order, the same lerp
        res["brick_encode"][tag] = _brick_fwd_row(table, grid, nx, ny, nz,
                                                  strides)

        # its backward: the same bf16-rounded contributions, summed per run
        # and added by float atomics in an order that changes from run to
        # run
        row = _brick_bwd_row(table, grid, nx, ny, nz, strides, seed + 1)
        check(row["rel_norm_err"] <= 1e-6,
              f"brick_encode_bwd ({tag}): rel {row['rel_norm_err']}")
        res["brick_encode_bwd"][tag] = row
        gen = torch.Generator(device=scene.device).manual_seed(seed + 2)

        # the composite: sigma of the trained field at these samples
        sigma = _composite_sigma(scene, cfg, o, d, t_mid, valid)
        delta = cfg.step * cfg.sample_stride
        shapes = {tag: (sigma, t_mid, valid)}
        if tag == "scene":
            # the two-budget geometry step's buckets, as the step forms them
            shapes.update(_bucket_inputs(scene, cfg, o, d, jitter, march))
        for name, (sig_b, t_b, v_b) in shapes.items():
            fwd, bwd = _composite_rows(sig_b, t_b, v_b, delta, gen, name)
            res["shade_composite"][name] = fwd
            res["shade_composite_bwd"][name] = bwd

    # the pool-sized kernels, at the episode's shapes
    arrs = runner.sup_pool.device_arrays(scene.device)
    nv = arrs["n_valid"]
    pts = (arrs["rays_o"][:nv] + arrs["rays_d"][:nv]
           * arrs["distances"][:nv]).contiguous()
    rc = scene.render_cfg
    o_got = occ_grid_from_points_cuda(pts, rc.occ_res, rc.occ_dilation)
    o_ref = occ_grid_from_points_plain(pts, rc.occ_res, rc.occ_dilation)
    torch.cuda.synchronize()
    check(torch.equal(o_got, o_ref), "occ_grid differs from plain")
    check(torch.equal(o_got, scene.occ_grid), "the episode's grid differs")
    res["occ_grid"] = {
        "points": int(nv), "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: occ_grid_from_points_cuda(
            pts, rc.occ_res, rc.occ_dilation), 10),
        "plain_ms": cuda_ms(lambda: occ_grid_from_points_plain(
            pts, rc.occ_res, rc.occ_dilation), 2),
        **bound(nv * 12 + rc.occ_res ** 3, nv * 27 * 12)}
    idx = torch.from_numpy(np.linspace(0, nv - 1, min(16384, nv)).astype(
        np.int64)).to(scene.device)
    po, pd = arrs["rays_o"][idx].contiguous(), arrs["rays_d"][idx].contiguous()
    c_got = count_occupied_windows_cuda(scene.occ_grid, po, pd, rc)
    c_ref = count_occupied_windows_plain(scene.occ_grid, po, pd, rc)
    torch.cuda.synchronize()
    check(torch.equal(c_got, c_ref), "count_windows differs from plain")
    res["count_windows"] = {
        "rays": int(idx.shape[0]), "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: count_occupied_windows_cuda(
            scene.occ_grid, po, pd, rc), 20),
        "plain_ms": cuda_ms(lambda: count_occupied_windows_plain(
            scene.occ_grid, po, pd, rc), 5),
        **bound(idx.shape[0] * 28, 0)}
    return res


def write_anchor_room(name: str = "anchor_room") -> str:
    """The anchor phase's input: the cube room seen from its centre at
    2048x1024 as a PNG, without a geometry cache (the dataset bootstraps
    it through the joint predictor)."""
    import torch
    from perf_tpu_torch.utils import render_cube_room_pano
    from perf_tpu_torch.utils.io import png_bytes
    room = os.path.join(RUN_DIR, name)
    if os.path.isdir(room):
        for name in os.listdir(room):
            os.remove(os.path.join(room, name))
    os.makedirs(room, exist_ok=True)
    pano = render_cube_room_pano(torch.eye(4), ROOM_H, ROOM_W)
    rgb = torch.round(pano["rgb"].clamp(0, 1) * 255).to(torch.uint8)
    path = os.path.join(room, "image.png")
    with open(path, "wb") as f:
        f.write(png_bytes(rgb.numpy()))
    return path


def _metrics(exp_dir: str) -> list:
    with open(os.path.join(exp_dir, "ts_log", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def anchor_phase(overrides: list):
    """The anchor path through the CLI: the geometry bootstrap, the raw fit,
    ANCHORS anchor cycles (render, visibility, inpaint, geometry, geo-check,
    register, re-fit with the prune), then mode=render_dense; checked.
    Returns (train runner, summary)."""
    import numpy as np
    import torch
    from perf_tpu_torch.__main__ import main as cli_main
    from perf_tpu_torch.train import SupInfoPool, load_checkpoint
    from perf_tpu_torch.utils import render_cube_room_pano
    from perf_tpu_torch.utils.io import decode_png
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = cli_main(["--device", "cuda", "--config-name", "nerf",
                       *overrides, "mode=train"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    dense = cli_main(["--device", "cuda", "--config-name", "nerf",
                      *overrides, "mode=render_dense", "is_continue=true"])
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated()

    # the bootstrapped geometry against the room's true distances (the
    # joint predictor's golden bar, tests/test_sphere_analytic.py)
    gt = render_cube_room_pano(torch.eye(4), ROOM_H, ROOM_W)["distance"]
    rel = _median_rel(runner.dataset.ref_distance[..., 0], gt.numpy()[..., 0])
    check(rel < 0.15, f"bootstrap geometry: median relative error {rel}")
    check(np.isfinite(runner.dataset.ref_normal).all(), "bootstrap normals")

    state = load_checkpoint(os.path.join(runner.exp_dir, "checkpoints",
                                         "ckpt.npz"))
    pool = SupInfoPool()
    pool.load_state_dict(state["sup_pool"])
    check(runner.phase == ANCHORS and int(state["phase"]) == ANCHORS
          and len(pool.sup_infos) == ANCHORS + 1,
          f"phase {runner.phase}, {len(pool.sup_infos)} panos")
    for info in runner.sup_pool.sup_infos[1:]:
        for name in ("color_map", "distance_map", "normal_map"):
            check(np.isfinite(getattr(info, name)).all(), f"anchor {name}")
        share = float(info.mask.mean())
        check(0.0 < share < 1.0, f"anchor supervision share {share}")
    with open(os.path.join(runner.exp_dir, "fit_vis",
                           f"geo_{VIS_FREQ:06d}.png"), "rb") as f:
        preview = decode_png(f.read())
    check(preview.shape == (128, 256, 3), "preview misshapen")
    out_dir = os.path.join(runner.exp_dir, "dense_images_new_pano")
    frames = sorted(f for f in os.listdir(out_dir) if f.startswith("image_"))
    check(len(frames) >= DENSE_POSES, f"{len(frames)} dense frames")
    with open(os.path.join(out_dir, frames[len(frames) // 2]), "rb") as f:
        frame = decode_png(f.read())
    check(frame.shape == (FRAME_H, FRAME_W, 3) and float(frame.std()) > 5.0,
          f"dense frame flat or misshapen: {frame.shape} {frame.std()}")

    recs = _metrics(runner.exp_dir)
    anchors = [{} for _ in range(ANCHORS)]
    k = 0                      # the joint timers carry no anchor: in order
    for r in recs:
        tag = r["tag"]
        if tag.startswith("time/anchor_"):
            anchors[r["step"]][tag[5:-4]] = r["value"]
        elif tag.startswith("time/joint_"):
            anchors[k][tag[5:-4]] = r["value"]
            k += tag == "time/joint_readback_sec"
    prunes = _prunes(recs)
    check(len(prunes) == ANCHORS and all(p["shell"] > 0 for p in prunes),
          f"prunes {prunes}")
    fms = dense.frame_ms
    summary = {
        "image": [ROOM_H, ROOM_W], "anchors": ANCHORS,
        "joint_iters_per_phase": JOINT_ITERS,
        "steps": list(TRAIN_STEPS), "train_s": train_s,
        "bootstrap_s": runner.dataset_s,
        "bootstrap_median_rel_err": rel,
        "raw_fit_s": sum(r["value"] for r in recs
                         if r["tag"] in ("time/fit_geo_sec",
                                         "time/fit_app_sec")
                         and r["step"] == 0),
        "anchor_timers_s": anchors, "prune": prunes,
        "pool_rays": runner.sup_pool.n_valid,
        "occ_voxels": int(runner.scene.occ_grid.sum()),
        "render_dense_s": dense_s, "dense_frames": len(frames),
        "dense_frame_ms": sorted(fms)[len(fms) // 2],
        "dense_frame_ms_all": fms, "max_memory_allocated": peak}
    return runner, summary


def compare_anchor_kernels(runner, seed: int) -> dict:
    """The anchor path's kernels against their plain versions at the
    path's shapes: the prune at the next episode's grids, the sphere encode
    at a distillation step's 60 views x 256 directions (and a readback
    chunk of 2^16), the resampler at the visibility core's 4 padded panos
    (forward) and at the distillation's local depth-bias maps (backward)."""
    import torch
    import torch.nn.functional as F
    from perf_tpu_torch.core.resample import (bilinear_sample_cuda,
                                              bilinear_sample_grad_cuda,
                                              bilinear_sample_plain)
    from perf_tpu_torch.convert import params_from_jax
    from perf_tpu_torch.fields.ngp import query_density_coords
    from perf_tpu_torch.kernels.brickgrid import (
        brick_encode_grad_cuda, brick_encode_grad_grad_cuda,
        brick_encode_grad_grad_plain, brick_encode_grad_plain)
    from perf_tpu_torch.train.scene import (PRUNE_CHUNK, _prune_points,
                                            field_prune_occ_cuda,
                                            field_prune_occ_plain)
    from perf_tpu_torch.utils import random_field_params
    scene, dev = runner.scene, runner.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    res = {}

    # the prune: the pool's grid against the last episode's, that field
    rc, fc = scene.render_cfg, scene.field_cfg
    occ = runner.sup_pool.gen_occ_grid(rc.occ_res, rc.occ_dilation, dev)
    prev = scene.occ_grid
    geo = scene.params["geo"]
    r = rc.occ_res
    jitter = torch.rand((2, min(PRUNE_CHUNK, r ** 3), 3), generator=gen,
                        device=dev)

    def prune_diff(geo):
        """(kernel grid, plain grid, differing voxel indices); a flip is
        allowed only where the density sits at the threshold (bf16 ties of
        the MLP move it by up to ~1%)."""
        got = field_prune_occ_cuda(geo, fc, occ, prev, r, jitter)
        ref = field_prune_occ_plain(geo, fc, occ, prev, r, jitter)
        torch.cuda.synchronize()
        diff = torch.nonzero(got != ref)[:, 0]
        if diff.numel():
            pts = _prune_points(diff, r)
            dens = query_density_coords(geo, pts[:, 0], pts[:, 1], pts[:, 2],
                                        fc)
            for j in range(2):
                q = pts + (jitter[j, diff % jitter.shape[1]] - 0.5) * (2.0 / r)
                dens = torch.maximum(dens, query_density_coords(
                    geo, q[:, 0], q[:, 1], q[:, 2], fc))
            check(bool(((dens * 5e-3 / 1e-2 - 1.0).abs() < 0.02).all()),
                  "occ_prune: a voxel away from the threshold differs")
        kept = int(((ref != 0) & (prev != 0)).sum())
        return got, ref, diff, kept

    shell = int(((occ != 0) & (prev != 0)).sum())
    got, ref, diff, kept = prune_diff(geo)
    # the path's field may keep its whole surface shell, so the same grids
    # and jitter also go through a seeded random geometry head of the path's
    # width, whose density crosses the threshold inside the shell
    rnd = params_from_jax(random_field_params(seed, fc, density_gain=0.9),
                          dev)["geo"]
    got_r, ref_r, diff_r, kept_r = prune_diff(rnd)
    check(0 < kept_r < shell,
          f"occ_prune: the random head kept {kept_r} of {shell}")
    g = fc.grid
    res["occ_prune"] = {
        "voxels": r ** 3, "shell": shell, "differing_voxels": int(diff.numel()),
        "dropped": shell - kept,
        "random_head_check": {"dropped": shell - kept_r,
                              "differing_voxels": int(diff_r.numel())},
        # the largest difference of a grid value (bytes of 0 or 1) over both
        # comparisons
        "max_abs_err": max(
            (a.int() - b.int()).abs().max().item()
            for a, b in ((got, ref), (got_r, ref_r))),
        "ms": cuda_ms(lambda: field_prune_occ_cuda(geo, fc, occ, prev, r,
                                                   jitter), 10),
        "plain_ms": cuda_ms(lambda: field_prune_occ_plain(
            geo, fc, occ, prev, r, jitter), 2),
        # 3 grids of a byte, the shell's jitter rows and 3 points' table
        # rows (at most the table); per shell point 2 x 32 x 64 bf16
        # multiply-adds, 128 float32 ones and the 16-level interpolation
        **bound(3 * r ** 3 + shell * 24
                + min(g.n_levels * g.n_bricks * 256, shell * 3 * 16 * 32),
                shell * 3 * (128 + g.n_levels * 8 * 2 * 2),
                shell * 3 * 2 * 32 * 64)}

    # the sphere encode with derivatives, forward and backward
    sp = runner.geo_predictor.cfg.field.grid
    table = torch.randn((sp.n_levels, sp.n_bricks, 128), generator=gen,
                        device=dev) * 0.1
    for tag, n in (("step", 60 * 256), ("readback", 1 << 16)):
        d = torch.randn((n, 3), generator=gen, device=dev)
        x = (d / d.norm(dim=-1, keepdim=True) * 0.49 + 0.49).contiguous()
        f, df = brick_encode_grad_cuda(table, x, sp)
        f_ref, df_ref = brick_encode_grad_plain(table, x, sp)
        gf = torch.randn(f.shape, generator=gen, device=dev)
        gd = torch.randn(df.shape, generator=gen, device=dev)
        gt = brick_encode_grad_grad_cuda(table.shape, x, sp, gf, gd)
        gt_ref = brick_encode_grad_grad_plain(table.shape, x, sp, gf, gd)
        torch.cuda.synchronize()
        ef = max((f - f_ref).abs().max().item(),
                 ((df - df_ref).abs().max() / df_ref.abs().max()).item())
        # the same 8 bf16 corners, float32 sums in another order
        check(ef <= 1e-6, f"brick_encode_grad ({tag}): {ef}")
        eb = ((gt - gt_ref).norm() / gt_ref.norm()).item()
        # the same bf16-rounded combined rows, added by float atomics
        check(eb <= 1e-5, f"brick_encode_grad_bwd ({tag}): rel {eb}")
        pts = n * sp.n_levels
        tb = table.numel() * 2
        res.setdefault("brick_encode_grad", {})[tag] = {
            "points": n, "max_abs_err": ef,
            "ms": cuda_ms(lambda: brick_encode_grad_cuda(table, x, sp), 20),
            "plain_ms": cuda_ms(lambda: brick_encode_grad_plain(table, x,
                                                                sp), 3),
            # 12 B in and 4 x 32 floats out per direction; 8 corners of 2
            # bf16 per (direction, level), at most the table; per corner 4
            # weights of 3 products and 8 multiply-adds, 3 x 8 chain ops
            **bound(n * (12 + 512) + min(tb, pts * 32), pts * (8 * 28 + 24))}
        res.setdefault("brick_encode_grad_bwd", {})[tag] = {
            "points": n, "max_abs_err": (gt - gt_ref).abs().max().item(),
            "rel_norm_err": eb,
            "ms": cuda_ms(lambda: brick_encode_grad_grad_cuda(
                table.shape, x, sp, gf, gd), 20),
            "plain_ms": cuda_ms(lambda: brick_encode_grad_grad_plain(
                table.shape, x, sp, gf, gd), 3),
            # directions and 4 x 32 cotangents in, the float32 table
            # gradient out; per corner and feature 4 multiply-adds
            **bound(n * (12 + 512) + table.numel() * 4, pts * 8 * 2 * 8)}

    # the resampler: forward at the visibility core's padded pano stack
    h, w = runner.dataset.height, runner.dataset.width
    imgs = torch.rand((4, h, w, 1), generator=gen, device=dev)
    coords = torch.rand((4, h * w, 2), generator=gen, device=dev)
    got = bilinear_sample_cuda(imgs, coords, "border")
    ref = bilinear_sample_plain(imgs, coords, "border")
    grid = (coords.flip(-1) * 2.0 - 1.0)[:, :, None, :]
    lib = F.grid_sample(imgs.permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode="border", align_corners=False)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    # the same taps, products and sums in JAX's order: bitwise
    check(err == 0.0, f"bilinear_sample: {err}")
    lib_err = (lib[..., 0].permute(0, 2, 1) - ref).abs().max().item()
    # the yardstick computes the same function, but its pixel coordinate
    # ((2c - 1 + 1) * W - 1) / 2 rounds otherwise at W = 2048: ~1e-4 of a
    # pixel, ~1e-4 of a value in [0, 1]
    check(lib_err <= 1e-4, f"grid_sample border disagrees: {lib_err}")
    n = coords.shape[0] * coords.shape[1]
    res["bilinear_sample"] = {
        "shape": list(imgs.shape), "samples": n, "max_abs_err": err,
        "grid_sample_max_abs_diff": lib_err,
        "ms": cuda_ms(lambda: bilinear_sample_cuda(imgs, coords, "border"),
                      20),
        "plain_ms": cuda_ms(lambda: bilinear_sample_plain(imgs, coords,
                                                          "border"), 5),
        "library_ms": cuda_ms(lambda: F.grid_sample(
            imgs.permute(0, 3, 1, 2), grid, mode="bilinear",
            padding_mode="border", align_corners=False), 20),
        # coords in, samples out, the images once; 4 taps x 2 products and
        # 3 sums, plus 8 coordinate operations
        **bound(imgs.numel() * 4 + n * 12, n * 19),
        **_bilinear_path_rows(runner, gen)}
    del imgs, coords, grid, got, ref, lib
    # backward at the distillation's local depth-bias maps
    jc = runner.geo_predictor.cfg
    n_views = 20 * len(jc.ratios)
    bimg = (n_views, jc.gen_res, jc.gen_res, 1)
    bco = torch.rand((n_views, jc.local_batch, 2), generator=gen, device=dev)
    cot = torch.randn((n_views, jc.local_batch, 1), generator=gen,
                      device=dev)
    gb = bilinear_sample_grad_cuda(bimg, bco, "border", cot)
    leaf = torch.zeros(bimg, device=dev, requires_grad=True)
    (gb_ref,) = torch.autograd.grad(bilinear_sample_plain(leaf, bco,
                                                          "border"),
                                    leaf, cot)
    torch.cuda.synchronize()
    eb = ((gb - gb_ref).abs().max() / gb_ref.abs().max()).item()
    check(eb <= 1e-6, f"bilinear_sample_bwd: {eb}")
    # the yardstick: grid_sample's image gradient (border), NCHW
    bgrid = (bco.flip(-1) * 2.0 - 1.0)[:, :, None, :]
    bcot = cot.permute(0, 2, 1)[..., None]
    bin_ = torch.zeros(bimg, device=dev).permute(0, 3, 1, 2)

    def lib_bwd():
        return torch.ops.aten.grid_sampler_2d_backward(
            bcot, bin_, bgrid, 0, 1, False, [True, False])[0]

    lib_gb = lib_bwd().permute(0, 2, 3, 1)
    torch.cuda.synchronize()
    lib_eb = ((lib_gb - gb_ref).abs().max() / gb_ref.abs().max()).item()
    # the same coordinate rounding gap as the forward's, at W = gen_res
    check(lib_eb <= 1e-4, f"grid_sample backward disagrees: {lib_eb}")
    m = n_views * jc.local_batch
    res["bilinear_sample_bwd"] = {
        "shape": list(bimg), "samples": m, "max_abs_err": eb,
        "grid_sample_max_rel_diff": lib_eb,
        "library_ms": cuda_ms(lib_bwd, 20),
        "ms": cuda_ms(lambda: bilinear_sample_grad_cuda(bimg, bco, "border",
                                                        cot), 20),
        # the route the wrapper takes at more samples an image, here
        "fixed_point_route_ms": cuda_ms(lambda: bilinear_sample_grad_cuda(
            bimg, bco, "border", cot, "fixed_point"), 20),
        "plain_ms": cuda_ms(lambda: torch.autograd.grad(
            bilinear_sample_plain(leaf, bco, "border"), leaf, cot), 5),
        # coords and cotangents in, the image gradient out; 4 taps x 2
        # products
        **bound(m * 12 + leaf.numel() * 4, m * 16)}
    return res


def _bilinear_path_rows(runner, gen) -> dict:
    """``bilinear_sample`` forward at two shapes of the anchor path, each
    bitwise its plain version and timed: ``vis_core``, the visibility
    core's resample of the registered panos' padded distance stack at the
    last registered pano's points (``train/sup_pool.py``
    ``_pano_proj_depths``), and ``views``, the distillation's resample of
    its view stack [views, gen_res, gen_res, 7] at a step's local batch
    (``priors/pano_joint.py`` ``_Distill.loss``)."""
    import torch
    import torch.nn.functional as F
    from perf_tpu_torch.core import direction_to_img_coord, gen_pano_rays
    from perf_tpu_torch.core.resample import (bilinear_sample_cuda,
                                              bilinear_sample_plain)
    dev = runner.device
    pool = runner.sup_pool
    poses, dmaps = pool.device_pano_maps(dev)
    info = pool.sup_infos[-1]
    h, w = info.distance_map.shape[:2]
    rays = gen_pano_rays(poses[len(pool.sup_infos) - 1], h, w)
    pts = rays.o + rays.d * torch.from_numpy(
        info.distance_map.reshape(h, w, 1)).to(dev)
    # _pano_proj_depths' coordinates
    rel = pts[None] - poses[:, None, None, :3, 3]
    local = torch.einsum("pji,phwj->phwi", poses[:, :3, :3], rel)
    local = local / torch.linalg.norm(local, dim=-1, keepdim=True)
    coords = direction_to_img_coord(local).reshape(poses.shape[0], -1, 2)
    jc = runner.geo_predictor.cfg
    n_views = 20 * len(jc.ratios)
    views = torch.rand((n_views, jc.gen_res, jc.gen_res, 7), generator=gen,
                       device=dev)
    vco = torch.rand((n_views, jc.local_batch, 2), generator=gen, device=dev)
    out = {}
    for tag, img, co in (("vis_core", dmaps.contiguous(), coords.contiguous()),
                         ("views", views, vco)):
        got = bilinear_sample_cuda(img, co, "border")
        ref = bilinear_sample_plain(img, co, "border")
        grid = (co.flip(-1) * 2.0 - 1.0)[:, :, None, :]
        lib = F.grid_sample(img.permute(0, 3, 1, 2), grid, mode="bilinear",
                            padding_mode="border", align_corners=False)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        check(err == 0.0, f"bilinear_sample ({tag}): {err}")
        lib_err = (lib[..., 0].permute(0, 2, 1) - ref).abs().max().item()
        m = co.shape[0] * co.shape[1]
        row = {"shape": list(img.shape), "samples": m, "max_abs_err": err,
               "ms": cuda_ms(lambda: bilinear_sample_cuda(img, co, "border"),
                             20),
               "plain_ms": cuda_ms(lambda: bilinear_sample_plain(
                   img, co, "border"), 5),
               # coords in and samples out; the images' pixels once, at
               # most the 4 taps a sample reads
               **bound(min(img.numel(), m * 4 * img.shape[-1]) * 4
                       + m * (8 + 4 * img.shape[-1]),
                       m * (8 + 11 * img.shape[-1]))}
        # the yardstick computes the same function (its pixel coordinate
        # rounds otherwise: ~1e-4 of a pixel at W = 2048); the distance
        # maps' values reach past 1, so only the view stack's [0, 1]
        # values are held to 1e-4
        row["grid_sample_max_abs_diff"] = lib_err
        if tag == "views":
            check(lib_err <= 1e-4, f"grid_sample ({tag}) disagrees: {lib_err}")
        row["library_ms"] = cuda_ms(lambda: F.grid_sample(
            img.permute(0, 3, 1, 2), grid, mode="bilinear",
            padding_mode="border", align_corners=False), 20)
        out[tag] = row
    return out


def _prunes(recs: list) -> list:
    """Each prune's voxel counts (prune/* metrics), in order."""
    steps = sorted({r["step"] for r in recs if r["tag"].startswith("prune/")})
    prunes = [{r["tag"][6:]: r["value"] for r in recs
               if r["tag"].startswith("prune/") and r["step"] == step}
              for step in steps]
    for p in prunes:
        p["shell_kept_share"] = p["shell_kept"] / max(p["shell"], 1)
    return prunes


def hash_phase(train_overrides: list, serve_overrides: list):
    """The hash field through the CLI: ``mode=train`` (the raw fit, then
    HASH_ANCHORS anchor whose re-fit prunes with the hash field, and one
    preview), then ``mode=serve`` from its checkpoint with a pano and a
    perspective request; checked. Returns (train runner, served scene,
    summary)."""
    import torch
    from perf_tpu_torch.__main__ import main as cli_main
    from perf_tpu_torch.kernels.hashgrid import HashGridConfig
    from perf_tpu_torch.utils.io import decode_png
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = cli_main(["--device", "cuda", "--config-name", "nerf",
                       *train_overrides, "mode=train"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    grid = runner.scene.field_cfg.grid
    check(grid == HashGridConfig(), f"not the full-width hash grid: {grid}")
    fit = check_raw_fit(runner)
    check(runner.phase == HASH_ANCHORS, f"phase {runner.phase}")
    recs = _metrics(runner.exp_dir)
    prunes = _prunes(recs)
    check(len(prunes) == HASH_ANCHORS and all(p["shell"] > 0 for p in prunes),
          f"prunes {prunes}")
    with open(os.path.join(runner.exp_dir, "fit_vis",
                           f"geo_{VIS_FREQ:06d}.png"), "rb") as f:
        check(decode_png(f.read()).shape == (128, 256, 3), "preview")
    metric = {(r["tag"], r["step"]): r["value"] for r in recs}
    httpd, responses, ready_s = serve_phase(serve_overrides, ("pano", "pers"))
    try:
        scene = httpd.scene_server.scene
        check(scene.field_cfg == runner.scene.field_cfg, "served field")
        check_responses(httpd, responses)
    finally:
        httpd.shutdown()
        httpd.server_close()
    summary = {
        "grid": dataclasses.asdict(grid), "steps": list(TRAIN_STEPS),
        "anchors": HASH_ANCHORS, "train_s": train_s,
        "raw_fit_geo_s": metric[("time/fit_geo_sec", 0)],
        "raw_fit_app_s": metric[("time/fit_app_sec", 0)],
        "rays_per_s": {
            "geo": metric[("throughput/fit_geo_rays_per_sec", 0)],
            "app": metric[("throughput/fit_app_rays_per_sec", 0)]},
        "anchor_timers_s": {r["tag"][5:-4]: r["value"] for r in recs
                            if r["tag"].startswith("time/anchor_")},
        "prune": prunes, **fit, "budget": runner.scene.sample_budget,
        "bucket_plan": (list(runner.scene.bucket_plan)
                        if runner.scene.bucket_plan else None),
        "pool_rays": runner.sup_pool.n_valid,
        "max_memory_allocated": peak, "serve_ready_s": ready_s,
        "request_ms": {k: v[2] for k, v in responses.items()}}
    return runner, scene, summary


def compare_hash_kernels(runner, served, seed: int) -> dict:
    """The hash encode forward (the lerped, level-concatenated features)
    and backward (from the features' cotangent) against their plain
    versions at the hash path's geometry-phase shape (8192 rays at the
    phase budget), at the pinned 8192 x 128, and the forward in the point
    form at a bake chunk of the served scene's corners."""
    import torch
    from perf_tpu_torch.fields import normalize_coords
    from perf_tpu_torch.render.snapshot import bake_corners, corner_points
    scene = runner.scene
    grid = scene.field_cfg.grid
    table = scene.params["geo"]["table"]
    gen = torch.Generator(device=scene.device).manual_seed(seed + 2)
    res = {"hash_encode": {}, "hash_encode_bwd": {}}

    def measure(tag, nx, ny, nz, strides, backward: bool):
        res["hash_encode"][tag] = _hash_fwd_row(table, grid, nx, ny, nz,
                                                strides)
        if backward:
            res["hash_encode_bwd"][tag] = _hash_bwd_row(grid, nx, ny, nz,
                                                        strides, gen)

    for tag, samples in (("scene", None), ("pinned", PINNED[1])):
        *_, nx, ny, nz, strides = _train_inputs(runner, samples, seed)
        measure(tag, nx, ny, nz, strides, backward=True)
    snap = served.snap_cfg
    idx = bake_corners(served.occ_grid, served.render_cfg.occ_res, snap.res)
    pts = corner_points(idx[:snap.bake_chunk], snap.res, served.field_cfg)
    nx, ny, nz, _ = normalize_coords(served.field_cfg, pts[:, :1],
                                     pts[:, 1:2], pts[:, 2:])
    measure("bake", nx.contiguous(), ny.contiguous(), nz.contiguous(),
            (1,) * grid.n_levels, backward=False)
    return res


def _median_rel(est, ref) -> float:
    """Median relative difference of two distance maps, both scaled to mean
    1 (the priors' distances are up to scale)."""
    import numpy as np
    est, ref = np.asarray(est, np.float64), np.asarray(ref, np.float64)
    return float(np.median(np.abs(est / est.mean() - ref / ref.mean())
                           / (ref / ref.mean())))


def sphere_phase(overrides: list):
    """The joint predictor's reference-parity field (hash + ad) through the
    CLI's mode=train: the bootstrap without a cache, the raw fit and
    SPHERE_ANCHORS anchor; checked. Returns (runner, summary, the last
    distillation, the anchor's, for ``distill_steps``)."""
    import numpy as np
    import torch
    from perf_tpu_torch.__main__ import main as cli_main
    from perf_tpu_torch.kernels.hashgrid import HashGridConfig
    from perf_tpu_torch.priors import pano_joint
    from perf_tpu_torch.utils import render_cube_room_pano
    made = []                     # each distillation, for the step timing
    init = pano_joint._Distill.__init__

    def keep(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made[:] = [self]
    pano_joint._Distill.__init__ = keep
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        runner = cli_main(["--device", "cuda", "--config-name", "nerf",
                           *overrides, "mode=train"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    finally:
        pano_joint._Distill.__init__ = init
    peak = torch.cuda.max_memory_allocated()
    field = runner.geo_predictor.cfg.field
    check((field.encoding, field.grad_mode) == ("hash", "ad")
          and field.grid == HashGridConfig.sphere_field(fine_res=2048,
                                                        log2_table_size=19),
          f"not the full-width reference-parity sphere field: {field}")
    gt = render_cube_room_pano(torch.eye(4), ROOM_H, ROOM_W)["distance"]
    rel = _median_rel(runner.dataset.ref_distance[..., 0], gt.numpy()[..., 0])
    check(rel < 0.15, f"bootstrap geometry: median relative error {rel}")
    check(np.isfinite(runner.dataset.ref_normal).all(), "bootstrap normals")
    check(runner.phase == SPHERE_ANCHORS, f"phase {runner.phase}")
    for info in runner.sup_pool.sup_infos[1:]:
        for name in ("color_map", "distance_map", "normal_map"):
            check(np.isfinite(getattr(info, name)).all(), f"anchor {name}")
    # the anchor's phase timers, its distillation's among them (the
    # bootstrap runs before the metrics writer exists: bootstrap_s)
    timers = {r["tag"][5:-4]: r["value"] for r in _metrics(runner.exp_dir)
              if r["tag"].startswith(("time/joint_", "time/anchor_"))}
    recs = _metrics(runner.exp_dir)
    iters = runner.geo_predictor.cfg.iters_per_phase
    summary = {
        "field": dataclasses.asdict(field), "anchors": SPHERE_ANCHORS,
        "joint_iters_per_phase": iters, "steps": list(TRAIN_STEPS),
        "train_s": train_s, "bootstrap_s": runner.dataset_s,
        "bootstrap_median_rel_err": rel,
        "readback_s": timers.get("joint_readback"),
        "raw_fit_s": sum(r["value"] for r in recs
                         if r["tag"] in ("time/fit_geo_sec",
                                         "time/fit_app_sec")
                         and r["step"] == 0),
        "anchor_timers_s": timers, "max_memory_allocated": peak}
    (distill,) = made
    return runner, summary, distill


def distill_steps(distill, iters: int) -> dict:
    """Warm distillation steps of the second phase, timed (synchronised,
    median of 10) and traced (5 steps)."""
    from perf_tpu_torch.kernels import cuda
    it = iter(range(1 << 30))

    def step():
        distill.step(iters + next(it) % iters, True)
    step_ms = host_ms(step, 10)
    before = cuda.counts()
    for _ in range(5):
        step()
    after = cuda.counts()
    return {"distill_step_ms": step_ms,
            "distill_launches_per_step": {k: (after[k] - before[k]) / 5
                                          for k in after
                                          if after[k] != before[k]},
            "distill_profile": profile_device(
                step, 5, step_ms, unit="step",
                # the resampler's backward (the distillation's 256
                # samples a view take its sorted route)
                watch=("bilinear_fwd_kernel", "bwd_sorted_kernel"))}


def sphere_api_phase(seed: int):
    """The non-Wild geometry API on the centred room: the dataset's
    get_ref_distance and get_ref_normal through the fusion predictors,
    then refine_geometry through the refiner at full width with the hash
    fd field and with the refiner's default (brick + analytic); checked.
    Returns a summary."""
    import numpy as np
    import torch
    from perf_tpu_torch.data import Dataset
    from perf_tpu_torch.priors import (
        FakeCubeRoomDepthPredictor, FakeCubeRoomNormalPredictor,
        PanoFusionConfig, PanoFusionInvPredictor, PanoFusionNormalPredictor,
        PanoGeoRefiner, RefinerConfig)
    from perf_tpu_torch.utils import render_cube_room_pano
    dev = torch.device("cuda")
    pano = render_cube_room_pano(torch.eye(4, device=dev), ROOM_H, ROOM_W)
    ds = Dataset()
    ds.image, ds.height, ds.width = pano["rgb"], ROOM_H, ROOM_W
    fusion = PanoFusionConfig(iters=FUSION_ITERS)
    torch.cuda.reset_peak_memory_stats()
    out = {"image": [ROOM_H, ROOM_W], "fusion_iters": FUSION_ITERS,
           "refiner_iters": REFINER_ITERS}
    t0 = time.perf_counter()
    dist = ds.get_ref_distance(PanoFusionInvPredictor(
        FakeCubeRoomDepthPredictor(), fusion, device=dev))
    torch.cuda.synchronize()
    out["ref_distance_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    normal = ds.get_ref_normal(PanoFusionNormalPredictor(
        FakeCubeRoomNormalPredictor(), fusion, device=dev))
    torch.cuda.synchronize()
    out["ref_normal_s"] = time.perf_counter() - t0
    check(bool(torch.isfinite(dist).all()) and bool((dist > 0).all()),
          "fused distance not finite and positive")
    check(bool(torch.isfinite(normal).all()), "fused normals not finite")
    gt = pano["distance"][..., 0].cpu().numpy()
    out["fused_distance_median_rel_err"] = _median_rel(dist.cpu().numpy(), gt)
    for tag, kw in (("hash_fd", dict(encoding="hash", grad_mode="fd")),
                    ("default", {})):
        cfg = RefinerConfig(n_iters=REFINER_ITERS)
        cfg = dataclasses.replace(cfg, field=dataclasses.replace(cfg.field,
                                                                 **kw))
        t0 = time.perf_counter()
        r_dist, r_normal = ds.refine_geometry(dist, normal, PanoGeoRefiner(
            cfg, seed=seed, device=dev))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(bool(torch.isfinite(r_dist).all())
              and bool(torch.isfinite(r_normal).all()),
              f"refined maps ({tag}) not finite")
        norm_err = (r_normal.norm(dim=-1) - 1.0).abs().max().item()
        check(norm_err < 1e-4, f"refined normals ({tag}) not unit: {norm_err}")
        d_in = dist.reshape(ROOM_H, ROOM_W).cpu().numpy()
        d_out = r_dist[..., 0].cpu().numpy()
        rel = float(np.median(np.abs(d_out - d_in) / d_in))
        check(rel < 0.15, f"refined distance ({tag}) off its input: {rel}")
        out[f"refine_{tag}"] = {"field": dataclasses.asdict(cfg.field),
                                "s": secs, "median_rel_to_input": rel,
                                "refined_distance_std": float(d_out.std()),
                                "input_distance_std": float(d_in.std())}
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return out, dist, normal


def refiner_step_check(dist, normal, seed: int) -> dict:
    """The refiner's distillation step on the card against its plain
    version on the CPU, at full width, in both field variants of the API
    run: the same parameters and draws (host-made) in both, two steps (the
    table's gradient is 0 at the first, whose Adam step gives the second a
    field with features in use); the loss to 1e-5 and each field tensor's
    gradient to 1e-3 relative (float atomics, float sums in another
    order). This holds what the refiner computes; its refined map alone
    cannot, since at 100 steps it is a constant (PERF.md section 7)."""
    import numpy as np
    import torch
    from perf_tpu_torch.core import GuardedAdam
    from perf_tpu_torch.priors import PanoGeoRefiner, RefinerConfig
    from perf_tpu_torch.priors.pano_joint import _sp_leaves
    dev = torch.device("cuda")
    maps = {"cuda": (dist.reshape(ROOM_H, ROOM_W, 1).contiguous(),
                     normal.contiguous())}
    maps["cpu"] = tuple(t.cpu() for t in maps["cuda"])
    out = {}
    for tag, kw in (("hash_fd", dict(encoding="hash", grad_mode="fd")),
                    ("default", {})):
        cfg = RefinerConfig(n_iters=REFINER_ITERS)
        cfg = dataclasses.replace(cfg, field=dataclasses.replace(cfg.field,
                                                                 **kw))
        card = PanoGeoRefiner(cfg, seed=seed, device=dev)
        plain = PanoGeoRefiner(cfg, seed=seed, device="cpu")
        params = card.draws.sphere_init(cfg.field, dev)
        leaves = _sp_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        adam = GuardedAdam(leaves)
        gen = torch.Generator().manual_seed(seed)
        errs = []
        for i in range(2):
            dirs = torch.randn((cfg.batch_size, 3), generator=gen)
            dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
            ortho = torch.randn((cfg.batch_size, 3), generator=gen)
            p_cpu = {"table": params["table"].detach().cpu(),
                     "mlp": {k: [t.detach().cpu() for t in v]
                             for k, v in params["mlp"].items()}}
            l_cpu = _sp_leaves(p_cpu)
            for t in l_cpu:
                t.requires_grad_(True)
            loss = card.step_loss(params, *maps["cuda"], dirs.to(dev),
                                  ortho.to(dev))
            grads = torch.autograd.grad(loss, leaves)
            loss_ref = plain.step_loss(p_cpu, *maps["cpu"], dirs, ortho)
            grads_ref = torch.autograd.grad(loss_ref, l_cpu)
            loss_err = abs(loss.item() - loss_ref.item()) / abs(loss_ref.item())
            rel = [float((g.cpu() - r).norm() / max(r.norm().item(), 1e-30))
                   for g, r in zip(grads, grads_ref)]
            check(loss_err <= 1e-5,
                  f"refiner step {i} ({tag}): loss off its plain version "
                  f"by {loss_err}")
            check(max(rel) <= 1e-3,
                  f"refiner step {i} ({tag}): gradients off their plain "
                  f"version: {rel}")
            errs.append({"loss_rel_err": loss_err, "grad_rel_norm_err": rel,
                         "table_grad_norm": float(grads_ref[0].norm())})
            with torch.no_grad():
                adam.step(leaves, list(grads), cfg.init_lr)
        out[tag] = errs
    return out


def compare_sphere_kernels(joint_field, seed: int) -> dict:
    """The sphere field's hash kernels against their plain versions: the
    smoothstep encode and its backward at the refiner's 7 x 32,768 points
    (the fd field's seven directions a step, fine_res 4096), the encode
    with derivatives and its backward at a distillation step's 60 views x
    256 directions and a readback chunk of 2^16 (the joint predictor's
    fine_res 2048)."""
    import torch
    from perf_tpu_torch.kernels.hashgrid import (
        HashGridConfig, hash_encode_grad_cuda, hash_encode_grad_grad_cuda,
        hash_encode_grad_grad_plain, hash_encode_grad_plain,
        hash_encode_ray_cuda, hash_encode_ray_plain, level_plan)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 3)

    def directions(n):
        d = torch.randn((n, 3), generator=gen, device=dev)
        return d / d.norm(dim=-1, keepdim=True)

    def table_for(grid):
        return (torch.rand(grid.table_shape, generator=gen, device=dev)
                - 0.5).contiguous()

    def table_read(grid, n):
        # per level its 8 corners' rows of 2 float32 a point, at most the
        # rows it can address: (res + 1)^3 dense, T hashed
        return sum(min(n * 8, grid.table_size if hashed else look ** 3) * 8
                   for _, look, hashed in map(grid.level_lookup,
                                              range(grid.n_levels)))
    res = {}

    # the refiner's fd field: the direction and its six neighbours at
    # eps = 1 / fine_res, one point-form encode
    grid = HashGridConfig.sphere_field(fine_res=4096)
    table = table_for(grid)
    d = directions(32768)
    eps = 1.0 / 4096
    e = torch.eye(3, device=dev) * eps
    pts = torch.cat([d] + [d + s * e[a] for a in range(3) for s in (1.0, -1.0)])
    x = pts * 0.49 + 0.49
    coords = [x[:, a:a + 1].contiguous() for a in range(3)]
    strides = (1,) * grid.n_levels
    n = x.shape[0]
    got = hash_encode_ray_cuda(table, *coords, grid, strides)
    ref = hash_encode_ray_plain(table, *coords, grid, strides)
    torch.cuda.synchronize()
    # the same corners, smoothstep weights and sums in the same order
    check(torch.equal(got, ref), f"hash_encode_smooth: "
          f"{(got - ref).abs().max().item()}")
    res["hash_encode_smooth"] = {
        "points": n, "levels": grid.n_levels, "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: hash_encode_ray_cuda(table, *coords, grid,
                                                   strides), 20),
        "plain_ms": cuda_ms(lambda: hash_encode_ray_plain(
            table, *coords, grid, strides), 3),
        "glue_ms": glue_ms(level_plan(grid, strides, n, 1)[0], n, 1, dev),
        **encode_bound(grid, n, 1, strides)}
    # the point form's cotangent [n, 1, 32]; the bound counts it in, the
    # float32 gradient out
    res["hash_encode_smooth_bwd"] = {
        "levels": grid.n_levels,
        **_hash_bwd_row(grid, *coords, strides, gen)}

    # the joint predictor's ad field: the encode with derivatives
    grid = joint_field.grid
    table = table_for(grid)
    res["hash_encode_grad"], res["hash_encode_grad_bwd"] = {}, {}
    for tag, n in (("step", 60 * 256), ("readback", 1 << 16)):
        x = (directions(n) * 0.49 + 0.49).contiguous()
        total = n * grid.n_levels
        f, df = hash_encode_grad_cuda(table, x, grid)
        f_ref, df_ref = hash_encode_grad_plain(table, x, grid)
        gf = torch.randn(f.shape, generator=gen, device=dev)
        gd = torch.randn(df.shape, generator=gen, device=dev)
        gt = hash_encode_grad_grad_cuda(table.shape, x, grid, gf, gd)
        gt_ref = hash_encode_grad_grad_plain(table.shape, x, grid, gf, gd)
        torch.cuda.synchronize()
        ef = max((f - f_ref).abs().max().item(),
                 ((df - df_ref).abs().max() / df_ref.abs().max()).item())
        # the same corners, weights, derivative weights and sums in the
        # same order (no contraction)
        check(ef <= 1e-6, f"hash_encode_grad ({tag}): {ef}")
        eb = ((gt - gt_ref).norm() / gt_ref.norm()).item()
        # the same float32 contributions, added by float atomics
        check(eb <= 1e-5, f"hash_encode_grad_bwd ({tag}): rel {eb}")
        res["hash_encode_grad"][tag] = {
            "points": n, "levels": grid.n_levels, "max_abs_err": ef,
            "ms": cuda_ms(lambda: hash_encode_grad_cuda(table, x, grid), 20),
            "plain_ms": cuda_ms(lambda: hash_encode_grad_plain(table, x,
                                                               grid), 3),
            # 12 B a point in; the corners' rows; per (point, level) 8 B of
            # features and 24 B of derivatives out; per (point, level) ~40
            # operations to locate it, per corner 7 weight products and
            # 2 x 4 multiply-adds
            **bound(n * 12 + table_read(grid, n) + total * 32,
                    total * (40 + 8 * 23))}
        res["hash_encode_grad_bwd"][tag] = {
            "points": n, "levels": grid.n_levels,
            "max_abs_err": (gt - gt_ref).abs().max().item(),
            "rel_norm_err": eb,
            "ms": cuda_ms(lambda: hash_encode_grad_grad_cuda(
                table.shape, x, grid, gf, gd), 20),
            "plain_ms": cuda_ms(lambda: hash_encode_grad_grad_plain(
                table.shape, x, grid, gf, gd), 3),
            # points and both cotangents in, the float32 table gradient
            # out; per (point, level) ~40 operations to locate it, per
            # corner 7 weight products and 2 x 4 multiply-adds
            **bound(n * 12 + total * 32 + table.numel() * 4,
                    total * (40 + 8 * 23))}
    return res


def compare_gather_kernels(sweep: dict, seed: int) -> dict:
    """Both gathers' rows of the kernels line from the benchmark's ``sweep``
    (every block checked bitwise against ``table[rows]`` and timed there,
    ``table[rows]`` timed beside them), with their plain versions checked
    bitwise and timed on the same inputs, and the bound."""
    import torch
    from perf_tpu_torch.kernels.gather import (
        W, onehot_gather_plain, take_gather_plain)
    from perf_tpu_torch.tools.bench_pallas_encode import make_inputs
    table, rows = make_inputs(GATHER_SAMPLES, seed, torch.device("cuda"))
    ref = table[rows.long()]
    n, r = GATHER_SAMPLES, table.shape[0]
    # the function table[rows]: the rows' indices in, their rows out, the
    # table read once
    function_bound = bound(n * (4 + W * 2) + table.numel() * 2, 0)
    out = {}
    for name, key, plain, bf16_flops in (
            ("take_gather", "take", take_gather_plain, 0),
            # the one-hot product's own work on the tensor cores
            ("onehot_gather", "onehot", onehot_gather_plain, 2 * n * r * W)):
        check(torch.equal(plain(table, rows).view(torch.int16),
                          ref.view(torch.int16)), f"{name} plain differs")
        by_block = sweep[key]
        best = min(by_block, key=lambda b: by_block[b]["ms"])
        out[name] = {
            "samples": n, "block": best,
            "ms_by_block": {b: v["ms"] for b, v in by_block.items()},
            "max_abs_err": max(v["max_abs_err"] for v in by_block.values()),
            "ms": by_block[best]["ms"],
            "plain_ms": cuda_ms(lambda: plain(table, rows), 3),
            "library_ms": sweep["gather"]["ms"], **function_bound}
        if bf16_flops:
            out[name]["formulation_bound_ms"] = bound(0, 0,
                                                      bf16_flops)["bound_ms"]
    return out


def prop_phase(train_overrides: list, serve_overrides: list):
    """The proposal estimator through the CLI: ``mode=train`` (the raw fit,
    then PROP_ANCHORS anchor), ``mode=render_dense`` (PROP_DENSE frames),
    then ``mode=serve`` from its checkpoint with a pano and a perspective
    request and ``/info``; checked. Returns (train runner, served scene,
    summary)."""
    import numpy as np
    import torch
    from perf_tpu_torch.__main__ import main as cli_main
    from perf_tpu_torch.train import PropNeRFScene
    from perf_tpu_torch.train.prop_scene import PROP_FIELD_CFGS
    from perf_tpu_torch.utils.io import decode_png
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = cli_main(["--device", "cuda", "--config-name", "nerf",
                       *train_overrides, "mode=train"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    scene = runner.scene
    check(isinstance(scene, PropNeRFScene), f"not a prop scene: {scene}")
    check([tuple(p["table"].shape) for p in scene.prop_params]
          == [(5, 2, 1 << 17)] * 2 and scene.prop_cfg.n_samples_per_prop
          == (128, 64) and scene.prop_cfg.n_samples == 64,
          "not the production cascade")
    fit = check_raw_fit(runner)
    geo = runner.losses["geo_losses"]
    fit["prop_loss_first20"] = float(geo[:20, 2].mean())
    fit["prop_loss_last20"] = float(geo[-20:, 2].mean())
    log(f"prop: proposal loss of the first / last 20 geo steps "
        f"{fit['prop_loss_first20']} / {fit['prop_loss_last20']}")
    check(runner.phase == PROP_ANCHORS, f"phase {runner.phase}")
    for info in runner.sup_pool.sup_infos[1:]:
        for name in ("color_map", "distance_map", "normal_map"):
            check(np.isfinite(getattr(info, name)).all(), f"anchor {name}")
    t1 = time.perf_counter()
    dense = cli_main(["--device", "cuda", "--config-name", "nerf",
                      *train_overrides, "mode=render_dense",
                      "is_continue=true"])
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t1
    out_dir = os.path.join(runner.exp_dir, "dense_images_new_pano")
    frames = sorted(f for f in os.listdir(out_dir) if f.startswith("image_"))
    check(len(frames) >= PROP_DENSE, f"{len(frames)} dense frames")
    with open(os.path.join(out_dir, frames[-1]), "rb") as f:
        frame = decode_png(f.read())
    check(frame.shape == (FRAME_H, FRAME_W, 3) and float(frame.std()) > 5.0,
          f"dense frame flat or misshapen: {frame.shape} {frame.std()}")
    httpd, responses, ready_s = serve_phase(serve_overrides, ("pano", "pers"),
                                            baked=False)
    try:
        served = httpd.scene_server.scene
        check(isinstance(served, PropNeRFScene)
              and served.field_cfg == scene.field_cfg, "served scene")
        check_responses(httpd, responses)
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        code, _, body = fetch(base + "/info")
        info = json.loads(body)
        check(code == 200 and info["snapshot_baked"] is False
              and info["n_rendered"] >= 4, f"bad /info {info}")
    finally:
        httpd.shutdown()
        httpd.server_close()
    peak = torch.cuda.max_memory_allocated()
    recs = _metrics(runner.exp_dir)
    metric = {(r["tag"], r["step"]): r["value"] for r in recs}
    fms = dense.frame_ms
    summary = {
        "cascade": [list(scene.prop_cfg.n_samples_per_prop),
                    scene.prop_cfg.n_samples],
        "prop_fields": [dataclasses.asdict(c) for c in PROP_FIELD_CFGS],
        "steps": list(TRAIN_STEPS), "anchors": PROP_ANCHORS,
        "batch": scene.train_cfg.pixel_loss_batch_size, "train_s": train_s,
        "episode_geo_s": metric[("time/fit_geo_prop_sec", 0)],
        "episode_app_s": metric[("time/fit_app_prop_sec", 0)],
        "rays_per_s": {
            "geo": metric[("throughput/fit_geo_prop_rays_per_sec", 0)],
            "app": metric[("throughput/fit_app_prop_rays_per_sec", 0)]},
        "anchor_timers_s": {r["tag"][5:-4]: r["value"] for r in recs
                            if r["tag"].startswith("time/anchor_")},
        **fit, "pool_rays": runner.sup_pool.n_valid,
        "render_dense_s": dense_s, "dense_frames": len(frames),
        "dense_frame_ms": sorted(fms)[len(fms) // 2],
        "dense_frame_ms_all": fms, "serve_ready_s": ready_s,
        "request_ms": {k: v[2] for k, v in responses.items()},
        "info": info, "max_memory_allocated": peak}
    return runner, served, summary


def _prop_inputs(runner, seed: int) -> tuple:
    """A training step's cascade at the path's shapes (8192 pool rays,
    128 -> 64 -> 64), through the kernels, without gradients: per proposal
    level its edges, world points, densities, weights and u; the final
    edges, densities and weights."""
    import numpy as np
    import torch
    from perf_tpu_torch.fields.ngp import query_density_field, query_density_ray
    from perf_tpu_torch.render import prop as P
    from perf_tpu_torch.train.prop_scene import PROP_FIELD_CFGS, pool_batch
    scene = runner.scene
    dev, cfg = scene.device, scene.prop_cfg
    arrs = runner.sup_pool.device_arrays(dev)
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    b = scene.train_cfg.pixel_loss_batch_size
    o, d, _, _ = pool_batch(arrs, torch.rand(b, generator=g, device=dev))
    draws = P.prop_draws(g, b, cfg, dev)
    n0 = cfg.n_samples_per_prop[0]
    counts = list(cfg.n_samples_per_prop[1:]) + [cfg.n_samples]
    with torch.no_grad():
        edges = (P.linspace_f32(cfg.near, cfg.far, n0 + 1, dev).expand(
            b, n0 + 1) + draws["jitter"] * float(np.float32(
                (cfg.far - cfg.near) / n0))).contiguous()
        levels = []
        for lvl, (pp, pc) in enumerate(zip(scene.prop_params,
                                           PROP_FIELD_CFGS)):
            mids = 0.5 * (edges[:, 1:] + edges[:, :-1])
            pts = o[:, None] + d[:, None] * mids[..., None]
            sigma = query_density_field(pp, pts, pc)[..., 0].contiguous()
            w = P.weights_from_density(sigma, edges, override_last=True)
            u = P.stratified_u(draws["u"][lvl], counts[lvl]).contiguous()
            levels.append({"edges": edges, "sigma": sigma, "w": w, "u": u,
                           "pts": pts})
            edges = P.sample_from_weights(edges, w, u)
        mids = 0.5 * (edges[:, 1:] + edges[:, :-1])
        px, py, pz = (o[:, a:a + 1] + d[:, a:a + 1] * mids for a in range(3))
        sigma = query_density_ray(scene.params["geo"], px, py, pz,
                                  scene.field_cfg,
                                  (1,) * scene.field_cfg.grid.n_levels)
        final = {"edges": edges, "sigma": sigma.contiguous(),
                 "w": P.weights_from_density(sigma, edges),
                 "xyz": (px, py, pz)}
    return levels, final


def compare_prop_kernels(runner, seed: int) -> dict:
    """The five K11 entry points against their plain versions on the
    cascade of a training step at the path's shapes (``_prop_inputs``):
    the resampling of both levels (indices equal, edges within 1e-6), the
    weights of level 0 (the 1e10 override) and of the final field (within
    1e-5 relative + 2e-7: expf against torch's exp; the rays whose last
    bin took float32 cancellation are counted), their gradients and both
    levels' loss and gradient (per-ray sums within 1e-5 relative,
    gradients within 1e-5 relative norm); each timed at level 0's shapes
    (the first two at the final field's too), with its bound."""
    import numpy as np
    import torch
    from perf_tpu_torch.render import prop as P
    levels, final = _prop_inputs(runner, seed)
    gen = torch.Generator(device=final["w"].device).manual_seed(seed + 4)
    res = {k: {} for k in ("prop_resample", "prop_weights",
                           "prop_weights_bwd", "prop_loss", "prop_loss_bwd")}

    def rel_norm(a, b):
        return ((a - b).norm() / b.norm()).item()

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    for tag, lv in (("level0", levels[0]), ("level1", levels[1])):
        e, w, u = lv["edges"], lv["w"], lv["u"]
        n, m = w.shape
        k = u.shape[1]
        got, idx = P.sample_from_weights_cuda(e, w, u, return_idx=True)
        ref, ref_idx = P.sample_from_weights_plain(e, w, u)
        torch.cuda.synchronize()
        check(torch.equal(idx.long(), ref_idx), f"prop_resample ({tag}): "
              f"{int((idx.long() != ref_idx).sum())} indices differ")
        err = (got - ref).abs().max().item()
        check(err <= 1e-6, f"prop_resample ({tag}): edges off by {err}")
        # edges, weights and u in, new edges out; per output a search of
        # ceil(log2(M + 2)) steps and ~10 operations, per bin ~3
        res["prop_resample"][tag] = {
            "shape": [n, m, k - 1], "max_abs_err": err,
            "ms": cuda_ms(lambda: P.sample_from_weights_cuda(e, w, u), 50),
            "plain_ms": cuda_ms(lambda: P.sample_from_weights_plain(e, w, u),
                                5),
            **bound(nbytes(e, w, u, got),
                    n * (3 * m + k * (int(np.ceil(np.log2(m + 2))) + 10)))}

    for tag, lv, override in (("level0", levels[0], True),
                              ("final", final, False)):
        s, e = lv["sigma"], lv["edges"]
        n, m = s.shape
        got = P.weights_from_density_cuda(s, e, override)
        ref = P.weights_from_density_plain(s, e, override)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        check(bool((err <= 1e-5 * ref.abs() + 2e-7).all()),
              f"prop_weights ({tag}): {err.max().item()}")
        tau = P._tau(s, e, override)[0]
        prefix = (P.xla_cumsum(tau) - tau)[:, -1]
        true_prefix = (torch.cumsum(tau.double(), -1) - tau.double())[:, -1]
        g = torch.randn((n, m), generator=gen, device=s.device)
        ds = P.weights_from_density_bwd_cuda(s, e, g, override)
        ds_ref = P.weights_from_density_bwd_plain(s, e, g, override)
        torch.cuda.synchronize()
        rel = rel_norm(ds, ds_ref)
        check(rel <= 1e-5, f"prop_weights_bwd ({tag}): rel {rel}")
        check(not override or bool((ds[:, -1] == 0).all()),
              "prop_weights_bwd: an overridden last sigma got a gradient")
        res["prop_weights"][tag] = {
            "shape": [n, m], "max_abs_err": err.max().item(),
            "max_rel_err": (err / (ref.abs() + 1e-30))[ref.abs() > 1e-6]
            .max().item(),
            "last_bin_equal": bool(torch.equal(got[:, -1], ref[:, -1])),
            # rays whose last-bin transmittance, from JAX's rounded prefix,
            # is off the true exclusive scan's by more than 1e-6
            "last_bin_rounded_rays": int(((-prefix.double()).exp()
                                          - (-true_prefix).exp()).abs()
                                         .gt(1e-6).sum()),
            # what the rounding does to the resampling: the true prefix
            # before the last bin, the rays whose rounded prefix is 0 and
            # the share of each ray's weight that sits in its last bin
            "last_bin_true_prefix_median": true_prefix.median().item(),
            "last_bin_prefix_zero_share": (prefix == 0).float().mean().item(),
            "last_bin_weight_share": (got[:, -1] / got.sum(-1).clamp_min(
                1e-30)).mean().item(),
            # the final samples that fall in level 0's last bin
            "final_samples_in_last_bin": (0.5 * (final["edges"][:, 1:]
                                                 + final["edges"][:, :-1])
                                          >= levels[0]["edges"][:, -2:-1])
            .float().mean().item(),
            "ms": cuda_ms(lambda: P.weights_from_density_cuda(s, e, override),
                          50),
            "plain_ms": cuda_ms(lambda: P.weights_from_density_plain(
                s, e, override), 5),
            # sigma and edges in, w out; ~10 operations and two exp a bin
            **bound(nbytes(s, e, got), n * m * 12)}
        res["prop_weights_bwd"][tag] = {
            "shape": [n, m], "max_abs_err": (ds - ds_ref).abs().max().item(),
            "rel_norm_err": rel,
            "ms": cuda_ms(lambda: P.weights_from_density_bwd_cuda(
                s, e, g, override), 50),
            "plain_ms": cuda_ms(lambda: P.weights_from_density_bwd_plain(
                s, e, g, override), 5),
            # sigma, edges and dw in, dsigma out; ~20 operations a bin
            **bound(nbytes(s, e, g, ds), n * m * 20)}

    tf, wf = final["edges"], final["w"]
    for tag, lv in (("level0", levels[0]), ("level1", levels[1])):
        te, wp = lv["edges"], lv["w"]
        n, m = wp.shape
        k = wf.shape[1]
        got = P.prop_loss_cuda(te, wp, tf, wf)
        ref = P.prop_loss_plain(te, wp, tf, wf)
        g = torch.full((n,), 1.0 / wf.numel(), device=wp.device)
        dw = P.prop_loss_bwd_cuda(te, wp, tf, wf, g)
        dw_ref = P.prop_loss_bwd_plain(te, wp, tf, wf, g)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        check(bool((err <= 1e-5 * ref.abs() + 1e-12).all()),
              f"prop_loss ({tag}): {err.max().item()}")
        check(ref.sum().item() > 0, f"prop_loss ({tag}) is 0")
        rel = rel_norm(dw, dw_ref)
        check(rel <= 1e-5, f"prop_loss_bwd ({tag}): rel {rel}")
        searches = n * k * 2 * int(np.ceil(np.log2(m + 2)))
        res["prop_loss"][tag] = {
            "shape": [n, m, k], "max_abs_err": err.max().item(),
            "loss": (ref.sum() / wf.numel()).item(),
            "ms": cuda_ms(lambda: P.prop_loss_cuda(te, wp, tf, wf), 50),
            "plain_ms": cuda_ms(lambda: P.prop_loss_plain(te, wp, tf, wf),
                                5),
            # both levels' edges and weights in, a sum per ray out
            **bound(nbytes(te, wp, tf, wf, got), n * m + searches + n * k * 8)}
        res["prop_loss_bwd"][tag] = {
            "shape": [n, m, k], "max_abs_err": (dw - dw_ref).abs().max().item(),
            "rel_norm_err": rel,
            "ms": cuda_ms(lambda: P.prop_loss_bwd_cuda(te, wp, tf, wf, g), 50),
            "plain_ms": cuda_ms(lambda: P.prop_loss_bwd_plain(
                te, wp, tf, wf, g), 5),
            **bound(nbytes(te, wp, tf, wf, g, dw),
                    n * 2 * m + searches + n * k * 12)}
    # the brick encode's backward at the final field's samples: 8192 rays x
    # 64, stride 1 on every level
    from perf_tpu_torch.fields import normalize_coords
    scene = runner.scene
    fc = scene.field_cfg
    nx, ny, nz, _ = normalize_coords(fc, *final["xyz"])
    row = _brick_bwd_row(scene.params["geo"]["table"], fc.grid,
                         nx.contiguous(), ny.contiguous(), nz.contiguous(),
                         (1,) * fc.grid.n_levels, seed + 5)
    check(row["rel_norm_err"] <= 1e-6,
          f"brick_encode_bwd (prop_final): rel {row['rel_norm_err']}")
    fwd_row = _brick_fwd_row(scene.params["geo"]["table"], fc.grid,
                             nx.contiguous(), ny.contiguous(), nz.contiguous(),
                             (1,) * fc.grid.n_levels)
    # the hash encode's point form at level 0's proposal field (its most
    # frequent launch on the path: 5 levels, so the float2 row stores),
    # normalised as query_density_field does
    from perf_tpu_torch.train.prop_scene import PROP_FIELD_CFGS
    pc = PROP_FIELD_CFGS[0]
    x01 = ((levels[0]["pts"].reshape(-1, 3) - pc.aabb_min)
           / (pc.aabb_max - pc.aabb_min))
    p_coords = [x01[:, a:a + 1].contiguous() for a in range(3)]
    points_row = _hash_fwd_row(scene.prop_params[0]["table"], pc.grid,
                               *p_coords, (1,) * pc.grid.n_levels)
    points_bwd_row = _hash_bwd_row(pc.grid, *p_coords,
                                   (1,) * pc.grid.n_levels, gen)
    # the rows of the kernels line: level 0's shapes (the largest)
    out = {name: {**r["level0"], **{t: v for t, v in r.items()
                                    if t != "level0"}}
           for name, r in res.items()}
    out["brick_encode_bwd_prop_final"] = row
    out["brick_encode_prop_final"] = fwd_row
    out["hash_encode_prop_points"] = points_row
    out["hash_encode_bwd_prop_points"] = points_bwd_row
    return out


class DedupRecorder:
    """Records, inside ``with``, what the run-dedup path decided (the smoke
    swaps module attributes the package calls; it has no knob for it):
    each episode's probed caps (``NeRFScene.probe_run_caps``); each brick
    ray-form encode call (``brick_encode_ray``), by whether ``dedup_caps``
    engages a level and whether it runs with the table's gradient; each
    snapshot composite chunk's budget S and run candidates K, and where
    0 < K < S the rays whose run count (over all S slots) exceeds K."""

    def __enter__(self):
        import torch
        from perf_tpu_torch.kernels import brickgrid
        from perf_tpu_torch.render import snapshot
        from perf_tpu_torch.render.renderer import windows_to_samples
        from perf_tpu_torch.train.scene import NeRFScene
        self.caps, self.encodes, self.chunks = [], {}, []
        self._saved = [
            (brickgrid, "brick_encode_ray", brickgrid.brick_encode_ray),
            (snapshot, "composite_snapshot", snapshot.composite_snapshot),
            (NeRFScene, "probe_run_caps", NeRFScene.probe_run_caps)]
        encode_fn, composite_fn, probe_fn = (x[2] for x in self._saved)

        def encode(table, nx, ny, nz, cfg, strides, run_caps=None):
            caps = brickgrid.dedup_caps(tuple(strides), nx.shape[1], run_caps)
            grad = torch.is_grad_enabled() and table.requires_grad
            key = ("dedup" if caps else "standard") + ("_grad" if grad else "")
            self.encodes[key] = self.encodes.get(key, 0) + 1
            return encode_fn(table, nx, ny, nz, cfg, strides, run_caps)

        def composite(table, rays_o, rays_d, widx, wvalid, field_cfg, cfg,
                      res, dedup_k=0):
            s = widx.shape[1] * cfg.samples_per_window
            rec = {"rays": int(rays_o.shape[0]), "S": s, "K": dedup_k}
            if 0 < dedup_k < s:
                t_mid, _ = windows_to_samples(widx, wvalid, cfg)
                rows = snapshot.snapshot_rows(rays_o, rays_d, t_mid,
                                              field_cfg, res)
                runs = (rows[:, 1:] != rows[:, :-1]).sum(1) + 1
                # device tensors: read once the path has run
                rec["clipped"] = (runs > dedup_k).sum()
                rec["most_runs"] = runs.max()
            self.chunks.append(rec)
            return composite_fn(table, rays_o, rays_d, widx, wvalid,
                                field_cfg, cfg, res, dedup_k)

        def probe(scene, *args, **kw):
            caps = probe_fn(scene, *args, **kw)
            self.caps.append(list(caps) if caps else None)
            return caps

        for (owner, name, _), fn in zip(self._saved,
                                        (encode, composite, probe)):
            setattr(owner, name, fn)
        return self

    def __exit__(self, *exc):
        for owner, name, orig in self._saved:
            setattr(owner, name, orig)

    def chunk_summary(self) -> dict:
        engaged = [c for c in self.chunks if 0 < c["K"] < c["S"]]
        rays = sum(c["rays"] for c in engaged)
        clipped = sum(int(c["clipped"]) for c in engaged)
        by_budget = {}
        for c in self.chunks:
            key = f"S{c['S']}_K{c['K']}"
            by_budget[key] = by_budget.get(key, 0) + 1
        return {"chunks": len(self.chunks), "engaged": len(engaged),
                "chunks_by_budget": by_budget,
                "clipped_ray_share": clipped / rays if rays else None,
                "most_runs_engaged": max((int(c["most_runs"])
                                          for c in engaged), default=None)}


def dedup_phase(train_overrides: list, serve_overrides: list):
    """The run-dedup path through the CLI: ``mode=train`` (the raw fit,
    then DEDUP_ANCHORS anchor, whose re-fit probes again),
    ``mode=render_dense`` (DEDUP_DENSE frames), then ``mode=serve`` from
    its checkpoint (a pano and a perspective request), recorded by a
    DedupRecorder; checked. Returns (train runner, served scene, summary,
    recorder)."""
    import numpy as np
    import torch
    from perf_tpu_torch.__main__ import main as cli_main
    from perf_tpu_torch.utils.io import decode_png
    torch.cuda.reset_peak_memory_stats()
    with DedupRecorder() as rec:
        t0 = time.perf_counter()
        runner = cli_main(["--device", "cuda", "--config-name", "nerf",
                           *train_overrides, "mode=train"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        fit = check_raw_fit(runner)
        check(runner.phase == DEDUP_ANCHORS, f"phase {runner.phase}")
        for info in runner.sup_pool.sup_infos[1:]:
            for name in ("color_map", "distance_map", "normal_map"):
                check(np.isfinite(getattr(info, name)).all(),
                      f"anchor {name}")
        t1 = time.perf_counter()
        dense = cli_main(["--device", "cuda", "--config-name", "nerf",
                          *train_overrides, "mode=render_dense",
                          "is_continue=true"])
        torch.cuda.synchronize()
        dense_s = time.perf_counter() - t1
        out_dir = os.path.join(runner.exp_dir, "dense_images_new_pano")
        frames = sorted(f for f in os.listdir(out_dir)
                        if f.startswith("image_"))
        check(len(frames) >= DEDUP_DENSE, f"{len(frames)} dense frames")
        with open(os.path.join(out_dir, frames[-1]), "rb") as f:
            frame = decode_png(f.read())
        check(frame.shape == (FRAME_H, FRAME_W, 3)
              and float(frame.std()) > 5.0,
              f"dense frame flat or misshapen: {frame.shape} {frame.std()}")
        httpd, responses, ready_s = serve_phase(serve_overrides,
                                                ("pano", "pers"))
        try:
            served = httpd.scene_server.scene
            check_responses(httpd, responses)
        finally:
            httpd.shutdown()
            httpd.server_close()
    peak = torch.cuda.max_memory_allocated()
    scene = runner.scene
    check(scene.train_cfg.dedup_runs and served.snap_cfg.dedup_ratio
          == DEDUP_RATIO, "the dedup knobs did not reach the scenes")
    for i, caps in enumerate(rec.caps):
        log(f"dedup: episode {i} run caps {caps}")
    check(len(rec.caps) == 1 + DEDUP_ANCHORS
          and all(c and max(c) > 0 for c in rec.caps),
          f"an episode probed no cap above 0: {rec.caps}")
    chunks = rec.chunk_summary()
    log(f"dedup: composite chunks {json.dumps(chunks)}")
    check(chunks["engaged"] > 0, "no snapshot chunk had K < S")
    log(f"dedup: encode calls {rec.encodes}")
    check(rec.encodes.get("dedup_grad", 0) > 0,
          f"no training encode took the dedup form: {rec.encodes}")
    metric = {(r["tag"], r["step"]): r["value"]
              for r in _metrics(runner.exp_dir)}
    fms = dense.frame_ms
    summary = {
        "ratio": DEDUP_RATIO, "steps": list(TRAIN_STEPS),
        "anchors": DEDUP_ANCHORS, "train_s": train_s,
        "episode_geo_s": metric[("time/fit_geo_sec", 0)],
        "episode_app_s": metric[("time/fit_app_sec", 0)],
        "rays_per_s": {"geo": metric[("throughput/fit_geo_rays_per_sec", 0)],
                       "app": metric[("throughput/fit_app_rays_per_sec", 0)]},
        "budget": scene.sample_budget, "run_caps_by_episode": rec.caps,
        "encode_calls": rec.encodes, "composite": chunks, **fit,
        "pool_rays": runner.sup_pool.n_valid,
        "render_dense_s": dense_s, "dense_frames": len(frames),
        "dense_frame_ms": sorted(fms)[len(fms) // 2],
        "dense_frame_ms_all": fms, "serve_ready_s": ready_s,
        "request_ms": {k: v[2] for k, v in responses.items()},
        "max_memory_allocated": peak}
    return runner, served, summary, rec


def _ray_runs(nx, ny, nz, grid, strides):
    """[levels, rays]: each ray's brick runs (changes of the encode's row,
    hashed where the level hashes, + 1) of its coarse points, level by
    level."""
    import torch
    from perf_tpu_torch.kernels.brickgrid import axis_split, brick_index
    from perf_tpu_torch.kernels.hashgrid import coarse_coords
    out = []
    for lvl, k in enumerate(strides):
        res, nb = grid.level_res(lvl), grid.level_bricks(lvl)
        b = [axis_split(coarse_coords(a, k), res)[0] for a in (nx, ny, nz)]
        rows = brick_index(*b, nb, grid.n_bricks)
        out.append((rows[:, 1:] != rows[:, :-1]).sum(1) + 1)
    return torch.stack(out)


def _frame_chunks(scene, rays, chunk: int) -> list:
    """The snapshot render's chunks of a frame, as ``render_snapshot_image``
    marches them (the beam plan): [(chunk config, o, d, widx, wvalid)]."""
    import dataclasses
    import torch
    from perf_tpu_torch.render.renderer import (beam_dilation,
                                                frame_march_plan,
                                                march_windows)
    from perf_tpu_torch.render.snapshot import (chunk_budgets,
                                                snapshot_render_cfg)
    cfg = snapshot_render_cfg(scene.render_cfg, scene.snap_cfg)
    h, w = rays.o.shape[:2]
    check((h * w) % chunk == 0 and h % 4 == 0 and w % 4 == 0,
          "frame must split into whole chunks and 4x4 blocks")
    dil = beam_dilation(rays.d, cfg)
    check(dil <= 3, f"beam dilation {dil}: the frame marches per ray")
    sidx, svalid, counts = frame_march_plan(scene.occ_grid, rays.o, rays.d,
                                            cfg, dil)

    def expand(x):
        s = x.shape[1]
        x = x.reshape(h // 4, w // 4, s).repeat_interleave(4, 0)
        return x.repeat_interleave(4, 1).reshape(-1, s).contiguous()

    sidx, svalid = expand(sidx), expand(svalid)
    budgets = chunk_budgets(counts.reshape(-1), chunk, 2, cfg)
    o, d = rays.o.reshape(-1, 3), rays.d.reshape(-1, 3)
    out = []
    for ci, budget in enumerate(budgets):
        cfg_c = dataclasses.replace(cfg, max_samples=budget)
        sl = slice(ci * chunk, (ci + 1) * chunk)
        oc, dc = o[sl].contiguous(), d[sl].contiguous()
        widx, wvalid = march_windows(scene.occ_grid, oc, dc, cfg_c,
                                     segments=(sidx[sl], svalid[sl]))[:2]
        out.append((cfg_c, oc, dc, widx, wvalid))
    torch.cuda.synchronize()
    return out


def compare_dedup_kernels(runner, scene, seed: int) -> dict:
    """The K12 kernels against their plain versions at the dedup path's
    shapes and probed caps, each timed beside the standard kernel on the
    same inputs: the encode's forward and backward at a geometry step's
    batch (8192 pool rays at the phase's samples; the pinned 8192 x 128
    rides along), with the dedup forward at caps covering every run held
    bitwise against the standard forward; the composite at the busiest
    chunk of a 512 x 1024 pano of the served snapshot with the path's K,
    and the frame's chunks at one K covering every run of the frame held
    bitwise against the standard composite."""
    import torch
    from perf_tpu_torch.core import gen_pano_rays
    from perf_tpu_torch.kernels.brickgrid import (
        brick_encode_ray_cuda, brick_encode_ray_dedup_cuda,
        brick_encode_ray_plain, brick_points_dedup_grad_cuda,
        brick_points_grad_cuda, brick_points_grad_plain, dedup_caps)
    from perf_tpu_torch.kernels.hashgrid import level_plan
    from perf_tpu_torch.render.renderer import windows_to_samples
    from perf_tpu_torch.render.snapshot import (
        composite_snapshot, composite_snapshot_plain, dedup_k_for,
        snapshot_rows)
    from perf_tpu_torch.kernels import cuda
    rs = runner.scene
    grid, table = rs.field_cfg.grid, rs.params["geo"]["table"]
    fwd, bwd = {}, {}
    covered = 0
    for tag, samples in (("scene", None), ("pinned", PINNED[1])):
        *_, nx, ny, nz, strides = _train_inputs(runner, samples, seed)
        n, s = nx.shape
        caps = dedup_caps(strides, s, rs.run_caps)
        check(caps is not None, f"dedup ({tag}): no level takes the dedup "
              f"encode at {s} samples with caps {rs.run_caps}")
        total = level_plan(grid, strides, n, s)[1]
        runs = _ray_runs(nx, ny, nz, grid, strides)
        clipped = [float((runs[lvl] > c).float().mean()) if c else None
                   for lvl, c in enumerate(caps)]
        got = brick_encode_ray_dedup_cuda(table, nx, ny, nz, grid, strides,
                                          caps)
        ref = brick_encode_ray_plain(table, nx, ny, nz, grid, strides, caps)
        std = brick_encode_ray_cuda(table, nx, ny, nz, grid, strides)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        check(err <= 1e-6 * max(1.0, ref.abs().max().item()),
              f"brick_encode_dedup ({tag}): {err}")
        cover = dedup_caps(strides, s, tuple(int(r) for r in
                                             runs.amax(dim=1)))
        equal = None
        if cover:
            equal = torch.equal(brick_encode_ray_dedup_cuda(
                table, nx, ny, nz, grid, strides, cover), std)
            check(equal, f"brick_encode_dedup ({tag}): caps {cover} cover "
                  "every run, yet the forward differs from the standard")
            covered += 1
        fwd[tag] = {
            "shape": [n, s], "strides": list(strides), "caps": list(caps),
            "points": total, "clipped_ray_share_by_level": clipped,
            "max_abs_err": err, "covering_caps": list(cover) if cover
            else None, "covering_equals_standard_bitwise": equal,
            "ms": cuda_ms(lambda: brick_encode_ray_dedup_cuda(
                table, nx, ny, nz, grid, strides, caps), 20),
            "plain_ms": cuda_ms(lambda: brick_encode_ray_plain(
                table, nx, ny, nz, grid, strides, caps), 3),
            "standard_ms": cuda_ms(lambda: brick_encode_ray_cuda(
                table, nx, ny, nz, grid, strides), 20),
            **encode_bound(grid, n, s, strides)}
        gen = torch.Generator(device=nx.device).manual_seed(seed)
        g = torch.randn((total, 2), generator=gen, device=nx.device)
        b_got = brick_points_dedup_grad_cuda(table.shape, nx, ny, nz, grid,
                                             strides, g, caps)
        b_again = brick_points_dedup_grad_cuda(table.shape, nx, ny, nz, grid,
                                               strides, g, caps)
        b_ref = brick_points_grad_plain(table.shape, nx, ny, nz, grid,
                                        strides, g, caps)
        g_abs = brick_points_grad_plain(table.shape, nx, ny, nz, grid,
                                        strides, g.abs(), caps)
        torch.cuda.synchronize()
        rel = ((b_got - b_ref).norm() / b_ref.norm()).item()
        rerun = ((b_again - b_got).norm() / b_got.norm()).item()
        moved, ties_ok = dedup_grad_moves(b_got, b_ref, g_abs)
        check(rel <= DEDUP_BWD_REL and rerun <= 1e-6 and ties_ok
              and moved <= DEDUP_TIE_SHARE,
              f"brick_encode_dedup_bwd ({tag}): {rel} vs plain, {rerun} "
              f"rerun, {moved} of the entries moved, each within one bf16 "
              f"ulp of its |g| sum: {ties_ok}")
        bwd[tag] = {
            "shape": [n, s], "strides": list(strides), "caps": list(caps),
            "points": total, "max_abs_err": (b_got - b_ref).abs().max().item(),
            "rel_norm_err": rel, "rerun_rel_norm": rerun,
            "tie_moved_share": moved,
            "ms": cuda_ms(lambda: brick_points_dedup_grad_cuda(
                table.shape, nx, ny, nz, grid, strides, g, caps), 20),
            "plain_ms": cuda_ms(lambda: brick_points_grad_plain(
                table.shape, nx, ny, nz, grid, strides, g, caps), 3),
            "standard_ms": cuda_ms(lambda: brick_points_grad_cuda(
                table.shape, nx, ny, nz, grid, strides, g), 20),
            **encode_bound(grid, n, s, strides, backward=True)}
    check(covered > 0, "no shape had caps covering every run below the "
          "point counts")

    # the composite: the busiest chunk of a pano of the served snapshot
    rays = gen_pano_rays(torch.eye(4, device=scene.device), FRAME_H, FRAME_W)
    chunks = _frame_chunks(scene, rays, 32768)
    sizes = [c[3].shape[1] * c[0].samples_per_window for c in chunks]
    ci = max(range(len(chunks)), key=lambda i: sizes[i])
    cfg_c, oc, dc, widx, wvalid = chunks[ci]
    k = dedup_k_for(DEDUP_RATIO, sizes[ci])
    check(k < sizes[ci], f"the busiest chunk ({sizes[ci]} samples) takes "
          f"no dedup at K = {k}")
    args = (scene.snapshot, oc, dc, widx, wvalid, scene.field_cfg, cfg_c,
            scene.snap_cfg.res)
    got = composite_snapshot(*args, dedup_k=k)
    ref = composite_snapshot_plain(*args, dedup_k=k)
    torch.cuda.synchronize()
    errs = {q: (got[q] - ref[q]).abs().max().item() for q in got}
    check(errs["rgb"] <= 2e-5 and errs["opacity"] <= 2e-5
          and errs["distance"] <= 1e-4, f"composite dedup: {errs}")
    t_mid, _ = windows_to_samples(widx, wvalid, cfg_c)
    rows = snapshot_rows(oc, dc, t_mid, scene.field_cfg, scene.snap_cfg.res)
    runs = (rows[:, 1:] != rows[:, :-1]).sum(1) + 1
    n_smp = int(wvalid.sum().item()) * cfg_c.samples_per_window
    n_win = widx.shape[1]
    comp = {
        "max_abs_err": max(errs.values()), "n": int(oc.shape[0]),
        "S": sizes[ci], "K": k, "most_runs": int(runs.max()),
        "clipped_ray_share": float((runs > k).float().mean()),
        # as the standard composite's row, and the run scan's compare and
        # count over every slot
        **bound(oc.shape[0] * (24 + 8 * n_win + 20)
                + min(scene.snapshot.numel() * 2, n_smp * 8 * 8),
                n_smp * 90 + oc.shape[0] * sizes[ci] * 4),
        "ms": cuda_ms(lambda: composite_snapshot(*args, dedup_k=k), 20),
        "plain_ms": cuda_ms(lambda: composite_snapshot_plain(
            *args, dedup_k=k), 5),
        "standard_ms": cuda_ms(lambda: composite_snapshot(*args), 20)}

    # K covering every run of the frame: every chunk at one K, the most runs
    # of any ray of the frame (the dedup kernel where K < S, the standard
    # elsewhere), bitwise the standard frame
    most = []
    for cfg_i, o_i, d_i, w_i, v_i in chunks:
        t_i, _ = windows_to_samples(w_i, v_i, cfg_i)
        r_i = snapshot_rows(o_i, d_i, t_i, scene.field_cfg,
                            scene.snap_cfg.res)
        most.append(int(((r_i[:, 1:] != r_i[:, :-1]).sum(1) + 1).max()))
    k_frame = max(most)
    engaged_chunks = 0
    for (cfg_i, o_i, d_i, w_i, v_i), s_i in zip(chunks, sizes):
        a_i = (scene.snapshot, o_i, d_i, w_i, v_i, scene.field_cfg, cfg_i,
               scene.snap_cfg.res)
        before = cuda.counts()["snapshot_composite_dedup"]
        dd = composite_snapshot(*a_i, dedup_k=k_frame)
        engaged_chunks += cuda.counts()["snapshot_composite_dedup"] - before
        st = composite_snapshot(*a_i)
        check(all(torch.equal(dd[q], st[q]) for q in dd),
              f"a chunk at K = {k_frame} (every run) differs from standard")
    check(engaged_chunks > 0, f"K = {k_frame} covers every run but no "
          f"chunk has more samples: {sizes}")
    comp["covering"] = {"chunk_most_runs": most, "chunk_samples": sizes,
                        "frame_k": k_frame,
                        "frame_dedup_chunks": engaged_chunks,
                        "frame_equals_standard_bitwise": True}
    log(f"dedup covering: {json.dumps(comp['covering'])}")
    return {"brick_encode_dedup": {**fwd["scene"], "pinned": fwd["pinned"]},
            "brick_encode_dedup_bwd": {**bwd["scene"],
                                       "pinned": bwd["pinned"]},
            "snapshot_composite_dedup": comp}


def run(seed: int):
    import numpy as np
    import torch

    from perf_tpu_torch.config import load_config
    from perf_tpu_torch.core import gen_pano_rays
    from perf_tpu_torch.kernels import cuda
    from perf_tpu_torch.render.snapshot import bake_corners
    from perf_tpu_torch.utils.io import colorize_single_channel_image, png_bytes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    # 1. build
    t0 = time.perf_counter()
    logs = cuda.build_all()
    build_s = time.perf_counter() - t0
    log(f"built {len(logs)} kernels in {build_s:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"{name}: {line.strip()}")

    # the gather benchmark's entry point, counted
    from perf_tpu_torch.tools import bench_pallas_encode
    cuda.reset_counts()
    gather = bench_pallas_encode.main(["--samples", str(GATHER_SAMPLES),
                                       "--seed", str(seed)])
    launches_gather = cuda.counts()
    log(f"launches on the gather path: {launches_gather}")
    check(all(launches_gather[k] > 0 for k in GATHER_KERNELS),
          f"a kernel never launched on the gather path: {launches_gather}")
    gather["launches"] = {k: v for k, v in launches_gather.items() if v}

    # 2. train: the main path of mode=train, counted
    image = write_room(device)
    train_overrides = [
        f"device.base_exp_dir={os.path.join(RUN_DIR, 'train_exp')}",
        f"dataset.image_path={image}", "mode=train",
        "pose_sampler.n_anchors_per_ratio=[0,0,0]",
        f"scene.train_conf.raw_phase_iter_geo={TRAIN_STEPS[0]}",
        f"scene.train_conf.raw_phase_iter_app={TRAIN_STEPS[1]}"]
    cuda.reset_counts()
    runner, train = train_phase(train_overrides)
    launches_train = cuda.counts()
    log(f"launches on the training path: {launches_train}")
    check(all(launches_train[k] > 0 for k in TRAIN_KERNELS),
          f"a kernel never launched on the training path: {launches_train}")
    train["launches"] = {k: v for k, v in launches_train.items() if v}
    train.update(warm_steps(runner))
    log(f"train: {json.dumps(train)}")

    # 3. scene
    overrides = [f"device.base_exp_dir={os.path.join(RUN_DIR, 'exp')}",
                 f"dataset.image_path={image}",
                 "mode=serve", "is_continue=true", "serve.port=0",
                 f"serve.height={FRAME_H}", f"serve.width={FRAME_W}"]
    conf = load_config(os.path.join(REPO, "configs"), "nerf", overrides)
    scene_info = write_scene(seed, conf, device)
    log(f"scene: {scene_info}")

    # 4. serve: the main path of mode=serve, counted
    cuda.reset_counts()
    httpd, responses, ready_s = serve_phase(overrides)
    launches = cuda.counts()
    log(f"launches on the serving path: {launches}")
    check(all(launches[k] > 0 for k in SERVE_KERNELS),
          f"a kernel never launched on the serving path: {launches}")
    try:
        scene = httpd.scene_server.scene
        check_responses(httpd, responses)
    finally:
        httpd.shutdown()
        httpd.server_close()

    rays = gen_pano_rays(torch.eye(4, device=device), FRAME_H, FRAME_W)
    frame = scene.render_snapshot(rays)
    frame_plain = scene.render_snapshot(rays, plain=True)
    for k in ("rgb", "distance"):
        check(bool(torch.isfinite(frame[k]).all()), f"frame {k} not finite")
        err = (frame[k] - frame_plain[k]).abs().max().item()
        check(err <= (1e-4 if k == "rgb" else 5e-4),
              f"frame {k}: kernel vs plain path {err}")
    check(float(frame["rgb"].std()) > 0.02, "flat frame")

    # three more bakes of the loaded scene (kernels loaded); the first bake
    # is inside ready_s, with the checkpoint load and warm-up
    table_served = scene.snapshot
    rebake_s = [host_ms(scene.bake_snapshot, 1) / 1e3 for _ in range(3)]
    check(torch.equal(scene.snapshot, table_served), "bake not repeatable")
    del table_served
    # host-side work of a request beside the frame: PNG and JET colouring
    img = (frame["rgb"].clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
    dist = frame["distance"].cpu().numpy()
    frame_ms = host_ms(lambda: scene.render_snapshot(rays), 5)
    serve = {"build_s": build_s, "ready_s": ready_s,
             "warm_bake_s": sorted(rebake_s)[1], "rebake_runs_s": rebake_s,
             "png_ms": host_ms(lambda: png_bytes(img), 3),
             "jet_ms": host_ms(lambda: colorize_single_channel_image(
                 1.0 / np.maximum(dist, 1e-6)), 3),
             "frame_ms": frame_ms,
             "plain_frame_ms": host_ms(
                 lambda: scene.render_snapshot(rays, plain=True), 3),
             "profile": profile_device(lambda: scene.render_snapshot(rays),
                                       5, frame_ms),
             "frame": [FRAME_H, FRAME_W],
             "request_ms": {k: v[2] for k, v in responses.items()},
             **scene_info}
    serve.pop("ckpt")

    # 5. the anchor path (mode=train with anchors, then render_dense),
    # counted
    anchor_image = write_anchor_room()
    anchor_overrides = [
        f"device.base_exp_dir={os.path.join(RUN_DIR, 'anchor_exp')}",
        f"dataset.image_path={anchor_image}",
        f"priors.joint.iters_per_phase={JOINT_ITERS}",
        f"scene.train_conf.raw_phase_iter_geo={TRAIN_STEPS[0]}",
        f"scene.train_conf.raw_phase_iter_app={TRAIN_STEPS[1]}",
        f"scene.train_conf.vis_freq={VIS_FREQ}",
        "pose_sampler.traverse_ratios=[0.4]",
        f"pose_sampler.n_anchors_per_ratio=[{ANCHORS}]",
        f"render_dense.n_poses={DENSE_POSES}",
        f"render_dense.height={FRAME_H}", f"render_dense.width={FRAME_W}"]
    cuda.reset_counts()
    anchor_runner, anchor = anchor_phase(anchor_overrides)
    launches_anchor = cuda.counts()
    log(f"launches on the anchor path: {launches_anchor}")
    check(all(launches_anchor[k] > 0 for k in ANCHOR_PATH),
          f"a kernel never launched on the anchor path: {launches_anchor}")
    anchor["launches"] = {k: v for k, v in launches_anchor.items() if v}

    # 6. the hash field: mode=train with one anchor, then mode=serve from
    # its checkpoint, counted together
    hash_common = [
        f"device.base_exp_dir={os.path.join(RUN_DIR, 'hash_exp')}",
        f"dataset.image_path={image}", "scene.field.kind=hash"]
    cuda.reset_counts()
    hash_runner, hash_scene, hashp = hash_phase(
        hash_common + [
            f"priors.joint.iters_per_phase={JOINT_ITERS}",
            f"scene.train_conf.raw_phase_iter_geo={TRAIN_STEPS[0]}",
            f"scene.train_conf.raw_phase_iter_app={TRAIN_STEPS[1]}",
            f"scene.train_conf.vis_freq={VIS_FREQ}",
            "pose_sampler.traverse_ratios=[0.4]",
            f"pose_sampler.n_anchors_per_ratio=[{HASH_ANCHORS}]"],
        hash_common + ["mode=serve", "is_continue=true", "serve.port=0",
                       f"serve.height={FRAME_H}", f"serve.width={FRAME_W}"])
    launches_hash = cuda.counts()
    log(f"launches on the hash path: {launches_hash}")
    check(all(launches_hash[k] > 0 for k in HASH_PATH),
          f"a kernel never launched on the hash path: {launches_hash}")
    check(all(launches_hash[k] == 0 for k in BRICK_FIELD_KERNELS),
          f"a brick-field kernel launched on the hash path: {launches_hash}")
    hashp["launches"] = {k: v for k, v in launches_hash.items() if v}
    hashp.update(warm_steps(hash_runner))
    # three more bakes of the served hash scene (the first is in ready_s),
    # each through the MLP kernel's forward
    table_served = hash_scene.snapshot
    before = cuda.counts()
    rebake_s = [host_ms(hash_scene.bake_snapshot, 1) / 1e3 for _ in range(3)]
    after = cuda.counts()
    bake_mlp = {k: (after[k] - before[k]) / 3 for k in MLP_KERNELS}
    log(f"hash bake: MLP launches a bake {bake_mlp}")
    check(bake_mlp["ngp_mlp"] > 0 and bake_mlp["ngp_mlp_bwd"] == 0,
          f"the hash bake did not go through the MLP kernel: {bake_mlp}")
    hashp["bake_mlp_launches"] = bake_mlp
    check(torch.equal(hash_scene.snapshot, table_served),
          "hash bake not repeatable")
    del table_served
    hashp.update(warm_bake_s=sorted(rebake_s)[1], rebake_runs_s=rebake_s)

    # 7. the sphere field's reference-parity variant: mode=train through
    # the CLI (counted), then the non-Wild geometry API (counted)
    sphere_image = write_anchor_room("sphere_room")
    for cut in (f"priors.joint.iters_per_phase 1500 -> {JOINT_ITERS}",
                f"fit steps 3000 + 1500 -> {TRAIN_STEPS[0]} + "
                f"{TRAIN_STEPS[1]}",
                f"anchors 24 -> {SPHERE_ANCHORS}", "no dense frames",
                f"fusion predictors 1000 -> {FUSION_ITERS} steps",
                f"refiner 5000 -> {REFINER_ITERS} steps"):
        log(f"sphere path cut: {cut}")
    cuda.reset_counts()
    sphere_runner, sphere, distill = sphere_phase([
        f"device.base_exp_dir={os.path.join(RUN_DIR, 'sphere_exp')}",
        f"dataset.image_path={sphere_image}",
        f"priors.joint.iters_per_phase={JOINT_ITERS}",
        "priors.joint.field.encoding=hash",
        "priors.joint.field.grad_mode=ad",
        f"scene.train_conf.raw_phase_iter_geo={TRAIN_STEPS[0]}",
        f"scene.train_conf.raw_phase_iter_app={TRAIN_STEPS[1]}",
        "pose_sampler.traverse_ratios=[0.4]",
        f"pose_sampler.n_anchors_per_ratio=[{SPHERE_ANCHORS}]"])
    launches_sphere = cuda.counts()
    log(f"launches on the sphere path (CLI): {launches_sphere}")
    check(all(launches_sphere[k] > 0 for k in SPHERE_PATH),
          f"a kernel never launched on the sphere path: {launches_sphere}")
    check(all(launches_sphere[k] == 0
              for k in ("brick_encode_grad", "brick_encode_grad_bwd")),
          f"the brick sphere encode launched on the hash path: "
          f"{launches_sphere}")
    cuda.reset_counts()
    sphere["api"], api_dist, api_normal = sphere_api_phase(seed)
    launches_api = cuda.counts()
    log(f"launches on the sphere path (API): {launches_api}")
    check(all(launches_api[k] > 0 for k in SPHERE_API_PATH),
          f"a kernel never launched on the sphere API path: {launches_api}")
    sphere["api"]["refiner_step_vs_plain"] = refiner_step_check(
        api_dist, api_normal, seed)
    del api_dist, api_normal
    sphere["launches"] = {k: v for k, v in launches_sphere.items() if v}
    sphere["api"]["launches"] = {k: v for k, v in launches_api.items() if v}
    sphere.update(distill_steps(distill, JOINT_ITERS))
    del distill

    # 8. the proposal estimator: mode=train with one anchor, render_dense,
    # then mode=serve from its checkpoint, counted together
    prop_common = [
        f"device.base_exp_dir={os.path.join(RUN_DIR, 'prop_exp')}",
        f"dataset.image_path={image}", "scene.estimator_type=prop"]
    for cut in (f"fit steps 3000 + 1500 -> {TRAIN_STEPS[0]} + "
                f"{TRAIN_STEPS[1]}", f"anchors 24 -> {PROP_ANCHORS}",
                f"priors.joint.iters_per_phase 1500 -> {JOINT_ITERS}",
                f"dense frames 180 -> {PROP_DENSE}"):
        log(f"prop path cut: {cut}")
    prop_train = prop_common + [
        f"priors.joint.iters_per_phase={JOINT_ITERS}",
        f"scene.train_conf.raw_phase_iter_geo={TRAIN_STEPS[0]}",
        f"scene.train_conf.raw_phase_iter_app={TRAIN_STEPS[1]}",
        "pose_sampler.traverse_ratios=[0.4]",
        f"pose_sampler.n_anchors_per_ratio=[{PROP_ANCHORS}]",
        f"render_dense.n_poses={PROP_DENSE}",
        f"render_dense.height={FRAME_H}", f"render_dense.width={FRAME_W}"]
    prop_serve = prop_common + ["mode=serve", "is_continue=true",
                                "serve.port=0", f"serve.height={FRAME_H}",
                                f"serve.width={FRAME_W}"]
    cuda.reset_counts()
    with MlpRecorder() as prop_mlp:
        prop_runner, prop_scene, prop = prop_phase(prop_train, prop_serve)
    launches_prop = cuda.counts()
    log(f"launches on the prop path: {launches_prop}")
    check(all(launches_prop[k] > 0 for k in PROP_PATH),
          f"a kernel never launched on the prop path: {launches_prop}")
    check(all(launches_prop[k] == 0 for k in OCC_KERNELS),
          f"an occupancy-path kernel launched on the prop path: "
          f"{launches_prop}")
    prop["launches"] = {k: v for k, v in launches_prop.items() if v}
    prop["mlp_launches_by_head"] = prop_mlp.launches()
    log(f"prop: MLP launches by head {prop['mlp_launches_by_head']}")
    check(all(prop["mlp_launches_by_head"].get(f"{d}/{h}", 0) > 0
              for d in ("fwd", "bwd") for h in ("geo", "app", "prop")),
          f"a head's MLP kernel never launched on the prop path: "
          f"{prop['mlp_launches_by_head']}")
    prop.update(warm_steps(prop_runner))
    log(f"prop: {json.dumps(prop)}")
    del prop_scene

    # 9. the run-dedup path (K12): mode=train with one anchor, render_dense,
    # then mode=serve from its checkpoint, counted together
    dedup_common = [
        f"device.base_exp_dir={os.path.join(RUN_DIR, 'dedup_exp')}",
        f"dataset.image_path={image}", "scene.train_conf.dedup_runs=true",
        f"snapshot.dedup_ratio={DEDUP_RATIO}"]
    for cut in (f"fit steps 3000 + 1500 -> {TRAIN_STEPS[0]} + "
                f"{TRAIN_STEPS[1]}", f"anchors 24 -> {DEDUP_ANCHORS}",
                f"priors.joint.iters_per_phase 1500 -> {JOINT_ITERS}",
                f"dense frames 180 -> {DEDUP_DENSE}"):
        log(f"dedup path cut: {cut}")
    cuda.reset_counts()
    dedup_runner, dedup_scene, dedup, dedup_rec = dedup_phase(
        dedup_common + [
            f"priors.joint.iters_per_phase={JOINT_ITERS}",
            f"scene.train_conf.raw_phase_iter_geo={TRAIN_STEPS[0]}",
            f"scene.train_conf.raw_phase_iter_app={TRAIN_STEPS[1]}",
            "pose_sampler.traverse_ratios=[0.4]",
            f"pose_sampler.n_anchors_per_ratio=[{DEDUP_ANCHORS}]",
            f"render_dense.n_poses={DEDUP_DENSE}",
            f"render_dense.height={FRAME_H}", f"render_dense.width={FRAME_W}"],
        dedup_common + ["mode=serve", "is_continue=true", "serve.port=0",
                        f"serve.height={FRAME_H}", f"serve.width={FRAME_W}"])
    launches_dedup = cuda.counts()
    log(f"launches on the dedup path: {launches_dedup}")
    check(all(launches_dedup[k] > 0 for k in DEDUP_PATH),
          f"a kernel never launched on the dedup path: {launches_dedup}")
    # the standard encode and composite launch exactly on the calls and
    # chunks where JAX routes there (no level engaged; K = 0 or K >= S)
    enc = dedup_rec.encodes
    chunks = dedup_rec.chunk_summary()
    routed = {
        "brick_encode": enc.get("standard", 0) + enc.get("standard_grad", 0),
        "brick_encode_bwd": enc.get("standard_grad", 0),
        "brick_encode_dedup": enc.get("dedup", 0) + enc.get("dedup_grad", 0),
        "brick_encode_dedup_bwd": enc.get("dedup_grad", 0),
        "snapshot_composite": chunks["chunks"] - chunks["engaged"],
        "snapshot_composite_dedup": chunks["engaged"]}
    check(all(launches_dedup[k] == v for k, v in routed.items()),
          f"dedup path routing: launches {launches_dedup}, calls {routed}")
    dedup["launches"] = {k: v for k, v in launches_dedup.items() if v}
    dedup.update(warm_steps(dedup_runner))
    # the same episode's steps with the standard encode, for the side by side
    tc = dedup_runner.scene.train_cfg
    dedup_runner.scene.train_cfg = dataclasses.replace(tc, dedup_runs=False)
    dedup["standard_steps"] = warm_steps(dedup_runner)
    dedup_runner.scene.train_cfg = tc
    for phase in ("geo", "app"):
        a, b = dedup[phase]["profile"], dedup["standard_steps"][phase]["profile"]
        log(f"dedup {phase} step: device {a['device_ms_per_step']} ms with "
            f"dedup, {b['device_ms_per_step']} without (the same episode)")
    log(f"dedup: {json.dumps(dedup)}")

    # 10. kernels vs their plain versions at the path's shapes
    idx = bake_corners(scene.occ_grid, scene.render_cfg.occ_res,
                       scene.snap_cfg.res)
    serve["bake_corners"] = int(idx.shape[0])
    results = {
        "field_eval": compare_field_eval(scene, idx,
                                         scene.snap_cfg.bake_chunk),
        "bake_scatter_pack": compare_scatter(scene, idx),
    }
    results["march_windows"], results["snapshot_composite"] = \
        compare_march_and_composite(scene, rays, 32768)
    results.update(compare_train_kernels(runner, seed))
    results.update(compare_anchor_kernels(anchor_runner, seed))
    results.update(compare_hash_kernels(hash_runner, hash_scene, seed))
    results.update(compare_gather_kernels(gather, seed))
    results.update(compare_sphere_kernels(sphere_runner.geo_predictor.cfg.field,
                                          seed))
    results.update(compare_prop_kernels(prop_runner, seed))
    results.update(compare_mlp_kernels(runner, hash_runner, prop_runner,
                                       seed))
    results.update(compare_dedup_kernels(dedup_runner, dedup_scene, seed))
    for name in ("brick_encode", "brick_encode_bwd"):
        results[name]["prop_final"] = results.pop(f"{name}_prop_final")
    for name in ("hash_encode", "hash_encode_bwd"):
        results[name]["prop_points"] = results.pop(f"{name}_prop_points")
    for name, r in results.items():
        log(f"{name}: {json.dumps(r)}")
    # the redesigned kernels, beside the times PERF.md recorded before their
    # redesign, with the glue the encodes absorbed
    for name, tags in (("bilinear_sample", (None, "vis_core", "views")),
                       ("brick_encode_bwd", ("scene", "pinned",
                                             "prop_final")),
                       ("hash_encode", ("scene", "pinned", "bake",
                                        "prop_points")),
                       ("hash_encode_smooth", (None,)),
                       ("brick_encode", ("scene", "pinned", "prop_final")),
                       ("hash_encode_bwd", ("scene", "pinned",
                                            "prop_points")),
                       ("hash_encode_smooth_bwd", (None,)),
                       ("shade_composite", ("scene", "pinned", "bucket_low",
                                            "bucket_high")),
                       ("shade_composite_bwd", ("scene", "pinned",
                                                "bucket_low",
                                                "bucket_high"))):
        for tag in tags:
            r = results[name] if tag is None else results[name].get(tag)
            if r is None:
                continue
            glue = (f", glue absorbed {r['glue_ms']:.5f}" if "glue_ms" in r
                    else "")
            log(f"{name}[{tag or 'row'}]: {r['ms']:.5f} ms (was "
                f"{WAS_MS[name]} at the table's row{glue}), bound "
                f"{r['bound_ms']:.5f}, plain {r['plain_ms']:.5f}, library "
                f"{r.get('library_ms')}")
    # the MLP kernels beside the PyTorch route they replace
    for name in MLP_KERNELS:
        for tag in (None, "geo_hash", "app_windows", "app_hash",
                    "prop_points", "prop_app"):
            r = results[name] if tag is None else results[name][tag]
            log(f"{name}[{tag or 'scene'}] {r['head']} {r['shape']}: "
                f"{r['ms']:.5f} ms (PyTorch route {r['pytorch_route_ms']:.5f}"
                f"), bound {r['bound_ms']:.5f}, plain {r['plain_ms']:.5f}, "
                f"build {r['build']}"
                + (f", reduce {r['reduce_ms']:.5f} ms" if "reduce_ms" in r
                   else ""))
    kernels = []
    for name in REPLACES:
        r = results[name]
        if name in SERVE_KERNELS:
            counted, path = launches[name], "serve"
        elif name in ANCHOR_KERNELS:
            counted, path = launches_anchor[name], "anchor"
        elif name in GATHER_KERNELS:
            counted, path = launches_gather[name], "gather"
        elif name in HASH_KERNELS:
            counted, path = launches_hash[name], "hash"
        elif name in SPHERE_KERNELS:
            counted, path = launches_sphere[name], "sphere"
        elif name in SMOOTH_KERNELS:
            counted, path = launches_api[name], "sphere_api"
        elif name in PROP_KERNELS:
            counted, path = launches_prop[name], "prop"
        elif name in DEDUP_KERNELS:
            counted, path = launches_dedup[name], "dedup"
        else:
            counted, path = launches_train[name], "train"
        # the training kernels at the smoke scene's shape (the pinned
        # 8192 x 128 shape and the hash encode's bake chunk ride along), the
        # sphere encodes with derivatives at a distillation step's (a
        # readback chunk rides along), the gathers at their fastest block
        # (every block rides along)
        top = r.get("scene", r.get("step", r))
        kernels.append({
            "name": name, "route": "cuda",
            "source": CSRC + cuda.KERNELS[name].source,
            "replaces": REPLACES[name], "path": path, "launches": counted,
            "max_abs_err": top["max_abs_err"],
            **{k: top[k] for k in ("head", "max_ulps", "rerun_equal",
                                   "pytorch_route_ms", "past_one_ulp",
                                   "last_rel", "tie_free_share",
                                   "tie_free", "last_rel_to_exact_hidden",
                                   "controls", "build", "reduce_ms",
                                   "tie_moved_share", "fixed_point_route_ms",
                                   "max_rel_err", "loose_share",
                                   "rel_norm_err", "rerun_rel_norm",
                                   "points", "strides",
                                   "glue_ms", "lanes", "was_bound_ms",
                                   "dsigma_nonzero_share",
                                   "scaled_max_abs_err", "scaled_max_rel_err",
                                   "scaled_dsigma_nonzero_share",
                                   "last_bin_equal",
                                   "last_bin_rounded_rays",
                                   "last_bin_true_prefix_median",
                                   "last_bin_prefix_zero_share",
                                   "last_bin_weight_share",
                                   "final_samples_in_last_bin", "shape",
                                   "differing_voxels", "dropped",
                                   "random_head_check", "block", "ms_by_block",
                                   "formulation_bound_ms", "caps",
                                   "clipped_ray_share_by_level",
                                   "covering_equals_standard_bitwise",
                                   "standard_ms", "S", "K", "most_runs",
                                   "clipped_ray_share", "covering")
               if k in top},
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top.get("library_ms"),
            **{k: r[k] for k in ("pinned", "bucket_low", "bucket_high",
                                 "readback", "bake", "level1",
                                 "final", "prop_final", "prop_points",
                                 "vis_core", "views", "geo_hash",
                                 "app_windows", "app_hash", "prop_app")
               if k in r}})
    return {"gather": gather, "train": train, "serve": serve,
            "anchor": anchor, "hash": hashp, "sphere": sphere, "prop": prop,
            "dedup": dedup, "kernels": kernels}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible to torch", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, REPO)
    for key, value in run(args.seed).items():
        print(json.dumps({key: value}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
