"""Run-to-run spread of the resampler's backward on one CUDA GPU (K9,
``bilinear_sample_bwd``), at the inputs of the card test
``tests/test_torch_kernels.py::test_bilinear_kernels_match_plain``.

Autograd's gradient of the plain version (``torch.gather``'s backward, a
scatter-add by float atomics) changes from launch to launch; the kernel's
two routes (fixed-point sums; products sorted by pixel) should repeat
bitwise. Per case (channels x padding x route, the test's
``bilinear_case`` inputs: images [3, 37, 61, C], 3 x 4173 coordinates
reaching past the image, normal cotangents; the sorted route at the first
``SORTED_MAX_SAMPLES`` of them, as the test takes it) this launches each
``--launches`` times and prints, as the test reads a pair (the largest
absolute difference over the largest absolute value of the second):

- ``kernel_self``: the kernel against its own first launch, the largest;
- ``plain_self``: autograd's gradient on the card against its own first;
- ``kernel_vs_plain``: launch i of the kernel against launch i of
  autograd's, the largest (the test's reading, 1e-6 its bar);
- ``kernel_vs_cpu``: the kernel against autograd's gradient on the CPU
  (float32, summed in one fixed order), the largest.

One JSON line a case and a summary line with the card's name and power
limit; exits non-zero without a GPU.

    python -m perf_tpu_torch.tools.bilinear_spread [--launches 200]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

CHANNELS = (1, 2, 3, 7, 5)
PADDINGS = ("border", "wrap_x", "zeros")


def case(c: int, padding: str, seed: int = 11):
    """The card test's ``bilinear_case``: (img [3, 37, 61, c], coords [3,
    4173, 2], cotangents [3, 4173, c]) float32."""
    rng = np.random.default_rng(seed + 7 * c + len(padding))
    img = rng.standard_normal((3, 37, 61, c)).astype(np.float32)
    coords = rng.uniform(-0.2, 1.2, (3, 4173, 2)).astype(np.float32)
    cot = rng.standard_normal((3, 4173, c)).astype(np.float32)
    return img, coords, cot


def _rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    return ((a - ref).abs().max() / ref.abs().max()).item()


def spread(c: int, padding: str, route: str, launches: int, dev) -> dict:
    from perf_tpu_torch.core.resample import (SORTED_MAX_SAMPLES,
                                              bilinear_sample_grad_cuda,
                                              bilinear_sample_plain)
    img_np, coords_np, cot_np = case(c, padding)
    m = coords_np.shape[1] if route == "fixed_point" else SORTED_MAX_SAMPLES
    coords = torch.from_numpy(coords_np[:, :m].copy()).to(dev)
    cot = torch.from_numpy(cot_np[:, :m].copy()).to(dev)

    def plain(device):
        leaf = torch.from_numpy(img_np).to(device).requires_grad_(True)
        (g,) = torch.autograd.grad(
            bilinear_sample_plain(leaf, coords.to(device), padding), leaf,
            cot.to(device))
        return g

    kern = [bilinear_sample_grad_cuda(tuple(img_np.shape), coords, padding,
                                      cot, route) for _ in range(launches)]
    ref = [plain(dev) for _ in range(launches)]
    cpu = plain("cpu").to(dev)
    return {"channels": c, "padding": padding, "route": route,
            "samples_per_image": m, "launches": launches,
            "kernel_self": max(_rel(k, kern[0]) for k in kern),
            "plain_self": max(_rel(r, ref[0]) for r in ref),
            "kernel_vs_plain": max(_rel(k, r) for k, r in zip(kern, ref)),
            "kernel_vs_cpu": max(_rel(k, cpu) for k in kern),
            "kernel_repeats_bitwise": all(torch.equal(k, kern[0])
                                          for k in kern)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--launches", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bilinear_spread: no CUDA device is visible to torch",
              file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda")
    rows = []
    for route in ("fixed_point", "sorted"):
        for c in CHANNELS:
            for padding in PADDINGS:
                rows.append(spread(c, padding, route, args.launches, dev))
                print(json.dumps(rows[-1]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    summary = {key: max(r[key] for r in rows)
               for key in ("kernel_self", "plain_self", "kernel_vs_plain",
                           "kernel_vs_cpu")}
    summary["kernel_repeats_bitwise"] = all(r["kernel_repeats_bitwise"]
                                            for r in rows)
    summary["card"] = smi.splitlines()[0]
    print(json.dumps({"summary": summary}), flush=True)
    return summary


if __name__ == "__main__":
    main()
