"""Probe of the NGP MLP kernels (K2) against the PyTorch route, on one CUDA GPU.

Builds ``kernels/csrc/ngp_mlp.cu`` and prints its ``-Xptxas -v`` register
and spill lines, then for each head at a step-sized batch (the density head
and the proposal head at 2^20 points, the colour head at 2^19; He-init
weights, inputs N(0, 0.5), 80% of the points inside the select, from a
seed) one JSON line: the kernels' forward and backward against their plain
versions (the share of outputs off by > 1e-4 relative, dx's largest
difference, each weight gradient's relative norm) and their times beside
the PyTorch route they replaced (the plain forward under autograd and its
autograd backward, forward and backward together). Times are CUDA events
over 20 launches (10 for the pairs), queued behind a spin kernel. It runs on
CUDA only and exits non-zero without a GPU.

    python -m perf_tpu_torch.tools.mlp_probe
"""

from __future__ import annotations

import json
import sys
import time

import torch

from ..fields.mlp import (APP_HEAD, GEO_HEAD, PROP_HEAD, ngp_head_bwd_plain,
                          ngp_head_plain)
from ..kernels import ngp_mlp

# (head, points, input width)
CASES = ((GEO_HEAD, 1 << 20, 32), (APP_HEAD, 1 << 19, 32),
         (PROP_HEAD, 1 << 20, 10))


def _ms(fn, reps: int = 20) -> float:
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


def probe(head, m: int, din: int, gen: torch.Generator) -> dict:
    dev = torch.device("cuda")
    dims = [din] + [64] * head.hidden + [head.channels]
    ws = [torch.randn((a, b), generator=gen, device=dev) * (2.0 / a) ** 0.5
          for a, b in zip(dims[:-1], dims[1:])]
    x = torch.randn((m, din), generator=gen, device=dev) * 0.5
    sel = torch.rand(m, generator=gen, device=dev) < 0.8
    g = torch.randn((head.channels, m), generator=gen, device=dev)
    out, raw = ngp_mlp.ngp_mlp_fwd_cuda(ws, x, sel, head, save_raw=True)
    dx, grads = ngp_mlp.ngp_mlp_bwd_cuda(ws, x, sel, raw, g, head)
    ref, _ = ngp_head_plain(ws, x, sel, head)
    rdx, rgrads = ngp_head_bwd_plain(ws, x, sel, raw, g, head)
    lx = x.clone().requires_grad_(True)
    lws = [w.clone().requires_grad_(True) for w in ws]

    def kernels():
        torch.autograd.grad(ngp_mlp.ngp_head(lws, lx, sel, head),
                            [lx, *lws], g)

    def route():
        torch.autograd.grad(ngp_head_plain(lws, lx, sel, head)[0],
                            [lx, *lws], g)
    return {
        "head": head.name, "shape": [m, din],
        "fwd_loose_share": ((out - ref).abs() > 1e-4 * ref.abs())
        .float().mean().item(),
        "dx_max_abs_err": (dx - rdx).abs().max().item(),
        "grad_rel_norm": [((a - b).norm() / b.norm()).item()
                          for a, b in zip(grads, rgrads)],
        "fwd_ms": _ms(lambda: ngp_mlp.ngp_mlp_fwd_cuda(ws, x, sel, head,
                                                       save_raw=True)),
        "bwd_ms": _ms(lambda: ngp_mlp.ngp_mlp_bwd_cuda(ws, x, sel, raw, g,
                                                       head)),
        "kernels_fwd_bwd_ms": _ms(kernels, 10),
        "pytorch_route_fwd_bwd_ms": _ms(route, 10)}


def main() -> int:
    if not torch.cuda.is_available():
        print("mlp_probe: no CUDA device is visible to torch", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    ngp_mlp._FWD._load()
    print(f"build s {time.perf_counter() - t0:.1f}", flush=True)
    for line in ngp_mlp._FWD.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(line.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for head, m, din in CASES:
        print(json.dumps(probe(head, m, din, gen)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
