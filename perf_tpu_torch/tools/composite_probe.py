"""Times the training composite's kernels (K4) against those of an earlier
commit, on one CUDA GPU.

    git archive <commit> | tar -x -C build/parent
    python -m perf_tpu_torch.tools.composite_probe --parent build/parent \
        [--shapes 8192x80,...]

At each shape [n, s] (rays x samples; by default the smoke scene's geometry
batch 8192 x 80, the pinned 8192 x 128, and the two buckets of the smoke's
brick geometry step, 7168 x 48 and 1024 x 80, and of its hash and dedup
steps, 7168 x 80 and 1024 x 128) it builds inputs from ``--seed`` (a run
of valid samples at a random place on each ray, densities from clear to
opaque, t ascending) and times ``shade_composite_cuda`` and
``shade_composite_grad_cuda`` with CUDA events over 50 launches queued
behind a spin kernel. The two trees run in turns, parent, change, change,
parent, each turn a process of its own that imports that tree's
``perf_tpu_torch`` (and builds its kernels into that tree's ``build/``),
so the earlier design runs through its own wrappers. Each turn holds its
kernels to its tree's ``shade_composite_plain`` first: the forward within
1e-5 of the largest value, the backward within 1e-4 relative to the
largest entry of autograd's (the smoke's bars).

Prints one JSON line a shape: the turns' times beside the bound by the
function's bytes (σ, t, valid and the output a sample; three values a
ray) and the plan of ``composite_lanes``. It runs on CUDA only and exits
non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

HBM_BPS = 3.35e12           # H100 SXM, NVIDIA data sheet
REPS = 50
SHAPES = "8192x80,8192x128,7168x48,1024x80,7168x80,1024x128"


def composite_inputs(n: int, s: int, seed: int, device) -> tuple:
    """sigma, t_mid, valid [n, s] and the three cotangents, from ``seed``."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    start = torch.randint(0, s, (n, 1), generator=g)
    length = torch.randint(1, s + 1, (n, 1), generator=g)
    idx = torch.arange(s)[None, :]
    valid = ((idx >= start) & (idx < start + length)).float()
    scale = 10.0 ** (torch.rand((n, 1), generator=g) * 3.5 - 3.0)
    tau = -torch.log1p(-torch.rand((n, s), generator=g) * 0.999) * scale
    delta = 1e-3
    sigma = tau / delta * valid
    t_mid = torch.sort(0.05 + 1.45 * torch.rand((n, s), generator=g),
                       dim=1).values
    cots = [torch.randn(sh, generator=g) for sh in ((n, 1), (n, 1), (n,))]
    return ([x.contiguous().to(device) for x in (sigma, t_mid, valid)],
            [c.to(device) for c in cots], delta)


def _ms(fn, reps: int = REPS) -> float:
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


def _kernels(renderer) -> tuple:
    """(forward, backward) of the imported tree's wrappers as functions of
    (sigma, t_mid, valid, delta[, cotangents]): the forward's outputs as
    the plain version's (weights, opacity, distance, dist_loss). The design
    before the redesign also wrote T [n, s], which its backward read with
    the weights."""
    fwd, bwd = renderer.shade_composite_cuda, renderer.shade_composite_grad_cuda
    if "trans" not in inspect.signature(bwd).parameters:
        return fwd, bwd
    saved = {}

    def fwd_old(sigma, t_mid, valid, delta):
        w, trans, op, dist, dl = fwd(sigma, t_mid, valid, delta)
        saved["w"], saved["trans"] = w, trans
        return w, op, dist, dl

    def bwd_old(sigma, t_mid, valid, delta, *cots):
        return bwd(sigma, t_mid, valid, saved["w"], saved["trans"], delta,
                   *cots)
    return fwd_old, bwd_old


def turn(shapes: list, seed: int) -> dict:
    """This process's tree (the ``perf_tpu_torch`` on its path): each
    shape's kernels held to the plain version, then timed."""
    from perf_tpu_torch.render import renderer
    fwd, bwd = _kernels(renderer)
    dev = torch.device("cuda")
    out = {"tree": str(Path(renderer.__file__).resolve().parents[2]),
           "shapes": {}}
    for i, (n, s) in enumerate(shapes):
        (sigma, t_mid, valid), cots, delta = composite_inputs(
            n, s, seed + i, dev)
        got = fwd(sigma, t_mid, valid, delta)
        g_got = bwd(sigma, t_mid, valid, delta, *cots)
        sig = sigma.clone().requires_grad_(True)
        want = renderer.shade_composite_plain(sig, t_mid, valid, delta)
        lin = sum((o * c).sum() for o, c in zip(want[1:], cots))
        (g_ref,) = torch.autograd.grad(lin, sig)
        fe = max(((a - b.detach()).abs().max()
                  / max(1.0, b.abs().max().item())).item()
                 for a, b in zip(got, want))
        be = ((g_got - g_ref).abs().max() / g_ref.abs().max()).item()
        if fe > 1e-5 or be > 1e-4:
            raise AssertionError(f"composite_probe {n}x{s} ({out['tree']}): "
                                 f"forward {fe}, backward {be}")
        out["shapes"][f"{n}x{s}"] = {
            "fwd_err": fe, "bwd_err": be,
            "fwd_ms": _ms(lambda: fwd(sigma, t_mid, valid, delta)),
            "bwd_ms": _ms(lambda: bwd(sigma, t_mid, valid, delta, *cots))}
    return out


def _run_turn(root: Path, shapes: str, seed: int) -> dict:
    """One turn in a process of its own, importing ``root``'s package."""
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--turn",
         "--shapes", shapes, "--seed", str(seed)],
        cwd=root, env=env, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"composite_probe: the turn in {root} failed:\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path,
                    help="an unpacked tree of the earlier commit")
    ap.add_argument("--shapes", default=SHAPES)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--turn", action="store_true",
                    help="time this process's tree alone (one JSON line)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("composite_probe: no CUDA device", file=sys.stderr)
        return 1
    shapes = [tuple(int(x) for x in sh.split("x"))
              for sh in args.shapes.split(",")]
    if args.turn:
        print(json.dumps(turn(shapes, args.seed)), flush=True)
        return 0
    if args.parent is None:
        ap.error("--parent is required")
    roots = {"parent": args.parent.resolve(),
             "change": Path(__file__).resolve().parents[2]}
    turns = [(who, _run_turn(roots[who], args.shapes, args.seed))
             for who in ("parent", "change", "change", "parent")]
    from perf_tpu_torch.render.renderer import composite_lanes
    for n, s in shapes:
        key = f"{n}x{s}"
        print(json.dumps({
            "shape": [n, s], "plan": list(composite_lanes(s)),
            "bound_ms": (n * s * 16 + n * 12) / HBM_BPS * 1e3,
            "trees": {who: str(roots[who]) for who in roots},
            "turns": {d: [[who, t["shapes"][key][f"{d}_ms"]]
                          for who, t in turns] for d in ("fwd", "bwd")},
            "errs": {who: {d: t["shapes"][key][f"{d}_err"]
                           for d in ("fwd", "bwd")}
                     for who, t in turns[:2]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
