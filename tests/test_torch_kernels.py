"""The port's CUDA kernel wrappers.

Everywhere: a wrapper refuses tensors its kernel does not take before it
builds anything, and the plain path (CPU tensors) counts no launch.

On a CUDA GPU only (marker ``cuda``; skipped elsewhere): each kernel against
its plain version on the same inputs, at small and odd sizes, with a tiny
field that hashes some levels. This file imports no JAX, so it also runs on
a machine without it, without the JAX suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from perf_tpu_torch.convert import params_from_jax
from perf_tpu_torch.fields import NGPFieldConfig, field_eval, field_eval_plain
from perf_tpu_torch.fields.ngp import field_eval_cuda
from perf_tpu_torch.kernels import BrickGridConfig, cuda
from perf_tpu_torch.render import (RenderConfig, SnapshotConfig,
                                   coarse_occ_grid, snapshot_render_cfg)
from perf_tpu_torch.render.renderer import (march_windows,
                                            march_windows_cuda,
                                            march_windows_plain)
from perf_tpu_torch.render.snapshot import (
    bake_corners, bake_scatter_pack, bake_scatter_pack_plain, bake_snapshot,
    composite_snapshot, composite_snapshot_cuda, composite_snapshot_plain)
from perf_tpu_torch.utils import cube_room_occ_grid, random_field_params

# 4 levels (res 8, 16, 32, 64), levels 2 and 3 hashed into 256 rows
TINY = NGPFieldConfig(grid=BrickGridConfig(n_levels=4, log2_bricks=8,
                                           base_res=8, per_level_scale=2.0))
RENDER = RenderConfig(step=4e-3, occ_res=64, march_coarse=12)
SNAP = SnapshotConfig(res=48, sample_stride=12, bake_chunk=4096)


def _rays(n: int, seed: int, device):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return torch.from_numpy(o).to(device), torch.from_numpy(d).to(device)


def test_cuda_wrappers_refuse_cpu_tensors_before_building():
    params = params_from_jax(random_field_params(0, TINY))
    cfg = snapshot_render_cfg(RENDER, SNAP)
    occ = torch.zeros((64 ** 3,), dtype=torch.uint8)
    o, d = _rays(8, 0, "cpu")
    widx = torch.zeros((8, 2), dtype=torch.int32)
    table = torch.zeros((SNAP.n_bricks ** 3, 256), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        field_eval_cuda(params, o, TINY)
    with pytest.raises(ValueError, match="CUDA"):
        march_windows_cuda(occ, o, d, cfg, coarse=coarse_occ_grid(occ, 64))
    with pytest.raises(ValueError, match="CUDA"):
        composite_snapshot_cuda(table, o, d, widx, widx.float(), TINY, cfg,
                                SNAP.res)
    with pytest.raises(ValueError, match="field_eval kernel takes"):
        field_eval_cuda(params, o, dataclasses.replace(TINY, n_neurons=32))


def test_plain_path_counts_no_launch():
    cuda.reset_counts()
    params = params_from_jax(random_field_params(0, TINY))
    occ = cube_room_occ_grid(64, 32, 64)
    table = bake_snapshot(params, TINY, occ, 64, SNAP)
    cfg = snapshot_render_cfg(RENDER, SNAP)
    o, d = _rays(64, 1, "cpu")
    widx, wvalid = march_windows(occ, o, d, cfg,
                                 coarse=coarse_occ_grid(occ, 64))[:2]
    composite_snapshot(table, o, d, widx, wvalid, TINY, cfg, SNAP.res)
    assert set(cuda.counts()) == {"field_eval", "bake_scatter_pack",
                                  "march_windows", "snapshot_composite"}
    assert all(v == 0 for v in cuda.counts().values())


# -- on the card -----------------------------------------------------------------

@pytest.fixture(scope="module")
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    params = params_from_jax(random_field_params(0, TINY), dev)
    occ = cube_room_occ_grid(64, 32, 64, device=dev)
    return dev, params, occ


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1037])
def test_field_eval_kernel_matches_plain(gpu, n):
    dev, params, _ = gpu
    rng = np.random.default_rng(n)
    xyz = torch.from_numpy(rng.uniform(-1.1, 1.1, (n, 3)).astype(
        np.float32)).to(dev)
    before = cuda.counts()["field_eval"]
    got = field_eval(params, xyz, TINY)
    assert cuda.counts()["field_eval"] == before + 1
    ref = field_eval_plain(params, xyz, TINY)
    err, scale = (got - ref).abs(), ref.abs()
    # same bf16 rounding points, float32 sums in another order: ~1e-6
    # relative, up to a few percent where a hidden unit sits on a bf16 tie
    assert (err > 1e-4 * scale + 1e-6).float().mean().item() <= 5e-3
    assert bool((err <= 0.05 * scale + 1e-6).all())
    assert bool((got[:, 0] == 0).eq(ref[:, 0] == 0).all())   # AABB select


@pytest.mark.cuda
def test_bake_scatter_pack_kernel_equals_plain(gpu):
    dev, params, occ = gpu
    idx = bake_corners(occ, 64, SNAP.res)
    vals = torch.randn((idx.shape[0], 4), generator=torch.Generator()
                       .manual_seed(2)).to(dev)
    shape = (SNAP.n_bricks ** 3, 256)
    got = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    ref = torch.zeros_like(got)
    bake_scatter_pack(got, idx, vals, SNAP.res)
    bake_scatter_pack_plain(ref, idx, vals, SNAP.res)
    assert torch.equal(got, ref)            # the same bf16 values, bitwise


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [None, 4])
def test_march_and_composite_kernels_match_plain(gpu, budget):
    dev, params, occ = gpu
    cfg = snapshot_render_cfg(RENDER, SNAP)
    if budget:
        cfg = dataclasses.replace(cfg, max_samples=budget)
    o, d = _rays(3001, 3, dev)
    coarse = coarse_occ_grid(occ, 64)
    got = march_windows(occ, o, d, cfg, coarse=coarse)
    ref = march_windows_plain(occ, o, d, cfg, coarse=coarse)
    seg = (ref[3].contiguous(), ref[4].contiguous())
    planned = march_windows(occ, o, d, cfg, segments=seg)
    for a in (got, planned):
        # integers: exactly equal where valid; padding carries weight 0
        valid = ref[1] > 0
        assert torch.equal(a[1] > 0, valid) and torch.equal(a[2], ref[2])
        assert torch.equal(torch.where(valid, a[0], -1),
                           torch.where(valid, ref[0], -1))
    assert torch.equal(torch.where(ref[4], got[3], -1),
                       torch.where(ref[4], ref[3], -1))
    assert int(ref[2].max()) > 0

    table = bake_snapshot(params, TINY, occ, 64, SNAP)
    args = (table, o, d, got[0], got[1], TINY, cfg, SNAP.res)
    out, want = composite_snapshot(*args), composite_snapshot_plain(*args)
    # same rows and samples; float32 sums and the scan in another order
    for k, tol in (("rgb", 2e-5), ("opacity", 2e-5), ("distance", 1e-4)):
        assert (out[k] - want[k]).abs().max().item() <= tol, k
