"""Row-gather microbenchmark of the brick-encode design, on one CUDA GPU.

Counterpart of ``tools/bench_pallas_encode.py``: a bf16 table of R = 4096
rows x W = 128 lanes (one brick level), n random int32 rows, and
``table[rows]`` computed three ways:

1. ``table[rows]`` (PyTorch's gather), the yardstick;
2. the take kernel (``kernels/gather.py``, ``csrc/row_gather.cu``) at
   blocks of 512, 1024, 2048 and 4096 rows;
3. the one-hot tensor-core kernel at blocks of 512, 1024 and 2048 rows.

Table and rows come from a seeded ``torch.Generator``. Every output row of
every kernel and block is checked bitwise against ``table[rows]`` (the JAX
script checks the first 128). Times are CUDA events over ``--iters``
launches after one warm-up, queued behind a spin kernel, per call, with
M rows/s. It runs on CUDA only and exits non-zero without a GPU or on a
mismatch.

    python -m perf_tpu_torch.tools.bench_pallas_encode [--samples 524288]
"""

from __future__ import annotations

import argparse
import sys

import torch

R = 4096    # brick rows per level
W = 128     # lanes per row
TAKE_BLOCKS = (512, 1024, 2048, 4096)
ONEHOT_BLOCKS = (512, 1024, 2048)


def timed(fn, iters: int) -> float:
    """Device ms per call of ``fn`` over ``iters`` calls after a warm-up. A
    ~10 ms spin kernel ahead of the start event lets the host queue the
    calls before the card reaches them, so the host's dispatch is not
    timed."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_inputs(n: int, seed: int, device) -> tuple:
    """A bf16 [R, W] table (normal) and int32 rows [n] in [0, R)."""
    g = torch.Generator(device=device).manual_seed(seed)
    table = torch.randn((R, W), generator=g, device=device).to(torch.bfloat16)
    rows = torch.randint(0, R, (n,), generator=g, device=device,
                         dtype=torch.int32)
    return table, rows


def run(samples: int, iters: int, seed: int = 0) -> dict:
    """The sweep: {"gather": {"ms", "mrows_s"}, "take": {block: {"ms",
    "mrows_s", "max_abs_err"}}, "onehot": {block: {...}}}; raises on a
    mismatch."""
    from ..kernels.gather import onehot_gather, take_gather
    dev = torch.device("cuda")
    table, rows = make_inputs(samples, seed, dev)
    ref = table[rows.long()]

    def line(label: str, ms: float) -> dict:
        rate = samples / ms * 1e3 / 1e6
        print(f"{label:22s}: {ms:8.4f} ms  ({rate:7.0f}M rows/s)", flush=True)
        return {"ms": ms, "mrows_s": rate}

    out = {"samples": samples, "iters": iters,
           "gather": line("table[rows]", timed(lambda: table[rows.long()],
                                               iters))}
    for name, fn, blocks in (("take", take_gather, TAKE_BLOCKS),
                             ("onehot", onehot_gather, ONEHOT_BLOCKS)):
        out[name] = {}
        for block in blocks:
            got = fn(table, rows, block)
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int16), ref.view(torch.int16)):
                bad = int((got.view(torch.int16) != ref.view(torch.int16))
                          .any(dim=1).sum())
                raise AssertionError(f"{name} b={block}: {bad} rows differ "
                                     "from table[rows]")
            out[name][block] = line(
                f"{name} b={block:5d}",
                timed(lambda: fn(table, rows, block), iters))
            out[name][block]["max_abs_err"] = (
                got.float() - ref.float()).abs().max().item()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--samples", type=int, default=524288)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_pallas_encode: no CUDA device is visible to torch",
              file=sys.stderr)
        sys.exit(1)
    return run(args.samples, args.iters, args.seed)


if __name__ == "__main__":
    main()
