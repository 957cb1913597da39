"""Probe of the NGP MLP kernels (K2) against the PyTorch route, on one CUDA GPU.

Builds ``kernels/csrc/ngp_mlp.cu`` and prints, for each head's forward
and backward kernel, one JSON line of build facts (``kernel_facts``:
registers, stack and spills a thread and shared memory a block from the
``-Xptxas -v`` log, blocks a SM, and the count of ``HMMA`` tensor-core
instructions in its SASS, which is above 0 for the bf16 heads), then for
each head at a step-sized batch (the density head
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

import functools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

from ..fields.mlp import (APP_HEAD, GEO_HEAD, PROP_HEAD, NGPHead,
                          ngp_head_bwd_plain, ngp_head_plain)
from ..kernels import cuda, ngp_mlp

# (head, points, input width)
CASES = ((GEO_HEAD, 1 << 20, 32), (APP_HEAD, 1 << 19, 32),
         (PROP_HEAD, 1 << 20, 10))


def ptxas_usage(log: str) -> dict:
    """{mangled kernel name: registers, stack bytes, spill stores and loads,
    static shared memory bytes} from an ``nvcc -Xptxas -v`` log."""
    out, entry, props = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            out[entry] = {}
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props in out:
            out[props].update(stack_bytes=int(m.group(1)),
                              spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            smem = re.search(r"(\d+) bytes smem", line)
            out[entry].update(registers=int(m.group(1)),
                              smem_bytes=int(smem.group(1)) if smem else 0)
    return out


def sass_counts(sass: str, opcode: str) -> dict:
    """{function: instructions whose opcode is ``opcode`` (any modifiers)}
    in ``cuobjdump -sass`` output."""
    out, fn = {}, None
    pat = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     + re.escape(opcode) + r"[.\s]")
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = 0
        elif fn is not None and pat.search(line):
            out[fn] += 1
    return out


def kernel_symbol(head: NGPHead, backward: bool) -> str:
    """The part of the head's forward or backward kernel's mangled name
    that tells it from the others: the bf16 heads' instances carry their
    head index as template argument."""
    d = "bwd" if backward else "fwd"
    if head.bf16:
        return f"mlp_{d}_kernelILi{ngp_mlp.KERNEL_HEADS[head][0]}E"
    return f"mlp_f32_{d}_kernelE"


@functools.lru_cache(maxsize=1)
def _hmma_by_function() -> dict:
    """HMMA instructions a function in ``cuobjdump -sass`` of the built
    library."""
    lib = ngp_mlp._FWD.library()
    tool = Path(cuda._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", lib._name], check=True,
                          capture_output=True, text=True).stdout
    return sass_counts(sass, "HMMA")


def kernel_facts(head: NGPHead, backward: bool = False) -> dict:
    """Build facts of the head's forward or backward kernel on the current
    CUDA device: registers, stack and spill bytes a thread and static shared
    memory a block from the build's ``-Xptxas -v`` log; dynamic shared
    memory a block and blocks a SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    at the launch's block size); the tensor-core instructions (``HMMA``) in
    its SASS."""
    occ = ngp_mlp._occupancy(head, backward)
    key = kernel_symbol(head, backward)
    usage = [v for k, v in ptxas_usage(ngp_mlp._FWD.build_log).items()
             if key in k]
    if len(usage) != 1:
        raise RuntimeError(f"ngp_mlp: no single -Xptxas -v entry for {key}")
    hmma = sum(n for k, n in _hmma_by_function().items() if key in k)
    return {**usage[0], "blocks_per_sm": occ[0],
            "dynamic_smem_bytes": occ[1], "hmma": hmma}


def grad_reduce_cuda(part: torch.Tensor, n_round: int) -> torch.Tensor:
    """The backward's second kernel alone (``ngp_mlp_reduce_launch``), on
    the blocks' partial rows ``part`` [blocks, n_w]: their sum in block
    order [n_w], the first ``n_round`` entries rounded to bf16. Uncounted:
    ``ngp_mlp_bwd_cuda`` launches it itself; this times it apart."""
    cuda.check(part, "part", torch.float32, (None, None))
    grad = torch.empty(part.shape[1], dtype=torch.float32, device=part.device)
    fn = ngp_mlp._FWD.library().ngp_mlp_reduce_launch
    fn.argtypes = [cuda.P, cuda.I32, cuda.I32, cuda.I32, cuda.P, cuda.P]
    fn.restype = cuda.I32
    err = fn(part.data_ptr(), part.shape[0], part.shape[1], n_round,
             grad.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ngp_mlp_reduce_launch: cudaError {err}")
    return grad


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
    for head, _, _ in CASES:
        for backward in (False, True):
            facts = kernel_facts(head, backward)
            print(json.dumps({"head": head.name,
                              "kernel": "bwd" if backward else "fwd",
                              **facts}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for head, m, din in CASES:
        print(json.dumps(probe(head, m, din, gen)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
