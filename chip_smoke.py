#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one GPU: ``python3 chip_smoke.py``.

Run from the repository root on a machine with one CUDA GPU and ``nvcc``.
It imports ``perf_tpu_torch`` only (never JAX) and works through:

1. build: compiles every kernel under ``perf_tpu_torch/kernels/csrc`` with
   ``nvcc`` for ``sm_90a``, one process per source, all started together;
2. scene: the ``configs/nerf.yaml`` brick field at full width (16 levels,
   2^12 rows, 64 neurons) with parameters drawn with NumPy from ``--seed``,
   and the cube room's occupancy (256^3) as seen from the origin by a
   512x1024 pano, written as ``checkpoints/ckpt.npz`` in the run layout;
3. serve: starts the port's CLI entry (``mode=serve is_continue=true``)
   from that checkpoint, which bakes the 384^3 snapshot, and answers
   health, pano, perspective, distance and displaced-pose renders over
   HTTP; each decoded PNG must be non-flat and equal a direct render;
4. kernels: holds each kernel against its plain PyTorch version on the
   same inputs at the shapes of the serving path, and times both.

Launch counts are zeroed just before phase 3 and read just after it, and
every kernel must have launched there. It prints a ``serve`` summary
(seconds from CLI start to serving, a warm re-bake, warm frame ms of the
kernel and the plain path, and a ``torch.profiler`` trace of warm frames:
device ms per frame and the device's idle share), the
``kernels`` line, the card's name and power limit, and, last,
``{"ok": true, "device": {...}}``. Any failed check exits non-zero; without
a CUDA device it exits non-zero before doing anything.
"""

from __future__ import annotations

import argparse
import json
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
CSRC = "perf_tpu_torch/kernels/csrc/"
REPLACES = {
    "field_eval": "perf_tpu/kernels/brickgrid.py:152",
    "bake_scatter_pack": "perf_tpu/render/snapshot.py:118",
    "march_windows": "perf_tpu/render/renderer.py:255",
    "snapshot_composite": "perf_tpu/render/snapshot.py:311",
}


def check(cond: bool, msg: str):
    if not cond:
        raise AssertionError(msg)


def log(msg: str):
    print(f"[chip_smoke] {msg}", flush=True)


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


def profile_frames(render, reps: int, frame_ms: float) -> dict:
    """Trace ``reps`` warm frames with ``torch.profiler``: the card's busy
    time per frame (union of its kernel and copy intervals), the busiest
    kernels, and the device's idle share of an untraced warm frame of
    ``frame_ms``. Returns nulls when the trace holds no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    render()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            render()
        torch.cuda.synchronize()
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        s, t = e.time_range.start, e.time_range.end
        spans.append((s, t))
        by_name[e.name] = by_name.get(e.name, 0.0) + (t - s)
    if not spans:
        log("profile: the trace holds no device events; idle share not "
            "measured")
        return {"frames": reps, "device_ms_per_frame": None,
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"frames": reps, "device_ms_per_frame": device_ms,
            "idle_share": 1.0 - device_ms / frame_ms,
            "device_ms_by_kernel": {k: v / 1e3 / reps for k, v in top}}


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


def serve_phase(overrides: list) -> tuple:
    """Phase 3: start the CLI's server from the checkpoint and answer
    requests. Returns (httpd, responses, seconds to ready)."""
    from perf_tpu_torch.__main__ import main as cli_main
    t0 = time.perf_counter()
    httpd = cli_main(["--device", "cuda", "--config-name", "nerf",
                      *overrides], block=False)
    ready_s = time.perf_counter() - t0
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    code, ctype, body = fetch(base + "/health")
    health = json.loads(body)
    check(code == 200 and health["status"] == "ok"
          and health["snapshot_baked"], f"bad /health {health}")
    reqs = {
        "pano": "/render?cam=pano",
        "pers": "/render?cam=pers&yaw=0.6&pitch=-0.2",
        "distance": "/render?q=distance",
        "displaced": "/render?px=0.25&py=-0.15&pz=0.1&yaw=0.4&cam=pano",
    }
    responses = {}
    for name, path in reqs.items():
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
    return {"max_abs_err": err.max().item(), "n": int(pts.shape[0]),
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
    return {"max_abs_err": err, "n": int(idx.shape[0]),
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
    march = {
        "max_abs_err": float((torch.where(fine[1] > 0, fine[0], 0)
                              - torch.where(fine_ref[1] > 0, fine_ref[0], 0)
                              ).abs().max().item()),
        "n": int(oc.shape[0]), "budget": budgets[ci],
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
    comp = {"max_abs_err": max(errs.values()), "n": int(oc.shape[0]),
            "ms": cuda_ms(lambda: composite_snapshot(*args), 20),
            "plain_ms": cuda_ms(lambda: composite_snapshot_plain(*args), 5)}
    return march, comp


def run(seed: int):
    import numpy as np
    import torch

    from perf_tpu_torch.app.serve import _pose_from_query
    from perf_tpu_torch.config import load_config
    from perf_tpu_torch.core import gen_pano_rays
    from perf_tpu_torch.kernels import cuda
    from perf_tpu_torch.render.snapshot import bake_corners
    from perf_tpu_torch.utils.io import (colorize_single_channel_image,
                                         decode_png, png_bytes)

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

    # 2. scene
    overrides = [f"device.base_exp_dir={os.path.join(RUN_DIR, 'exp')}",
                 f"dataset.image_path={os.path.join(RUN_DIR, 'room', 'image.png')}",
                 "mode=serve", "is_continue=true", "serve.port=0",
                 f"serve.height={FRAME_H}", f"serve.width={FRAME_W}"]
    conf = load_config(os.path.join(REPO, "configs"), "nerf", overrides)
    scene_info = write_scene(seed, conf, device)
    log(f"scene: {scene_info}")

    # 3. serve: the main path, counted
    cuda.reset_counts()
    httpd, responses, ready_s = serve_phase(overrides)
    launches = cuda.counts()
    log(f"launches on the serving path: {launches}")
    check(all(v > 0 for v in launches.values()) and len(launches) == 4,
          f"a kernel never launched on the serving path: {launches}")
    try:
        srv = httpd.scene_server
        scene = srv.scene
        for name, (path, body, ms) in responses.items():
            q = parse_qs(urlparse(path).query)
            img = decode_png(body)
            want = srv.render(_pose_from_query(q), q.get("cam", ["pano"])[0],
                              q.get("q", ["rgb"])[0])
            check(img.shape == want.shape and np.array_equal(img, want),
                  f"{name}: PNG differs from a direct render")
            check(float(img.std()) > 5.0, f"{name}: flat image")
            log(f"{name}: {img.shape} std {img.std():.2f} in {ms:.1f} ms")
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
             "profile": profile_frames(lambda: scene.render_snapshot(rays),
                                       5, frame_ms),
             "frame": [FRAME_H, FRAME_W],
             "request_ms": {k: v[2] for k, v in responses.items()},
             **scene_info}
    serve.pop("ckpt")

    # 4. kernels vs their plain versions at the path's shapes
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
    for name, r in results.items():
        log(f"{name}: {json.dumps(r)}")
    # field_eval's check is relative (sigma spans many decades), so its
    # entry also carries the relative error and the share past 1e-4
    kernels = [{"name": name, "route": "cuda",
                "source": CSRC + cuda.KERNELS[name].source,
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": results[name]["max_abs_err"],
                **{k: results[name][k] for k in ("max_rel_err", "loose_share")
                   if k in results[name]},
                "ms": results[name]["ms"],
                "plain_ms": results[name]["plain_ms"]}
               for name in REPLACES]
    return serve, kernels


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible to torch", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, REPO)
    serve, kernels = run(args.seed)
    print(json.dumps({"serve": serve}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
