"""Port vs ``perf_tpu``: the run-dedup encode (K12) on the training path.

The encode and its table gradient (``brick_encode_ray_dedup`` with
``corner_interp_dedup``'s VJP), the per-episode probe of the run caps
(``_probe_run_caps``, through ``select_sample_budget``) and the training
contract of ``tests/test_bucketed.py:121``; a geometry and an appearance step
with caps are in ``tests/test_torch_dedup_steps.py``. Inputs come from NumPy
seeds; where JAX draws inside a function the test hands its draws to the
port. The port runs on CPU tensors, where every wrapper takes its plain
version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perf_tpu.kernels.brickgrid import brick_encode_ray_dedup as j_dedup
from perf_tpu.render import renderer as J
from perf_tpu.train import NeRFScene as JScene, SupInfoPool as JPool
from perf_tpu.train import TrainConfig as JTrain
from perf_tpu.utils import render_cube_room_pano as j_room

from perf_tpu_torch.fields import NGPFieldConfig
from perf_tpu_torch.kernels import BrickGridConfig, HashGridConfig
from perf_tpu_torch.kernels.brickgrid import (
    axis_split, brick_encode_ray, brick_index, brick_points_grad_plain,
    dedup_caps)
from perf_tpu_torch.kernels.hashgrid import (coarse_coords, level_plan,
                                             lerp_levels_transpose)
from perf_tpu_torch.render import renderer as T
from perf_tpu_torch.train import NeRFScene, SupInfoPool, TrainConfig
from perf_tpu_torch.utils import render_cube_room_pano

from test_torch_common import GRID, configs

# the probe's grid: res 16, 32, 64, 128, so at a 4e-3 step levels 2 and 3
# (strides 2 and 1) get caps
PROBE_GRID = dict(n_levels=4, log2_bricks=8, base_res=16, per_level_scale=2.0)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |v| (2^(e - 7) for v in [2^e, 2^(e + 1)))."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 1e-38)))
    return np.exp2(e - 7)


def _runs(x, y, z, grid, strides) -> np.ndarray:
    """[levels, rays]: the brick runs (changes of the encode's row + 1) of
    every ray's coarse points, level by level."""
    out = []
    for lvl, k in enumerate(strides):
        res, nb = grid.level_res(lvl), grid.level_bricks(lvl)
        b = [axis_split(coarse_coords(a, k), res)[0] for a in (x, y, z)]
        rows = brick_index(*b, nb, grid.n_bricks)
        out.append(((rows[:, 1:] != rows[:, :-1]).sum(1) + 1).numpy())
    return np.stack(out)


@pytest.fixture(scope="module")
def encode_case():
    """96 rays of 32 samples crossing the unit cube, strides (2, 1, 1, 1) on
    the 4-level grid (levels 0-1 dense, 2-3 hashed into 256 rows), a table
    of values in [-1, 1], cotangents N(0, 1); the caps that cover every
    run ('full') and half the most runs of each level ('tight': the rays
    with the most runs are clipped on every level)."""
    rng = np.random.default_rng(20)
    n, s, strides = 96, 32, (2, 1, 1, 1)
    x, y, z = (np.sort(rng.uniform(0.02, 0.98, (n, s)), axis=1)
               .astype(np.float32) for _ in range(3))
    grid = BrickGridConfig(**GRID)
    table = rng.uniform(-1.0, 1.0, grid.table_shape).astype(np.float32)
    cot = rng.normal(size=(n, s, grid.out_dim)).astype(np.float32)
    runs = _runs(*map(torch.from_numpy, (x, y, z)), grid, strides).max(1)
    caps = {"full": tuple(int(r) for r in runs),
            "tight": tuple(max(1, int(r) // 2) for r in runs)}
    return (x, y, z), strides, table, cot, caps


@pytest.mark.parametrize("which", ["full", "tight"])
def test_dedup_encode_and_table_grad_match_jax(encode_case, which):
    (x, y, z), strides, table, cot, all_caps = encode_case
    caps = all_caps[which]
    jg, tg = configs()[0][0].grid, configs()[1][0].grid
    n, s = x.shape
    # every level takes the dedup path (each cap below its point count)
    assert dedup_caps(strides, s, caps) == caps
    runs = _runs(*map(torch.from_numpy, (x, y, z)), tg, strides)
    if which == "tight":      # at least one ray clipped on every level
        assert all((r > c).any() for r, c in zip(runs, caps))
    else:
        assert all((r <= c).all() for r, c in zip(runs, caps))

    @jax.jit
    def fwd_vjp(t, c):
        out, vjp = jax.vjp(lambda t: j_dedup(
            t, *map(jnp.asarray, (x, y, z)), jg, strides, caps), t)
        return out, vjp(c)[0]

    ref, g_ref = fwd_vjp(jnp.asarray(table), jnp.asarray(cot))
    ref, g_ref = np.asarray(ref), np.asarray(g_ref)
    tt = torch.from_numpy(table.copy()).requires_grad_(True)
    got = brick_encode_ray(tt, *map(torch.from_numpy, (x, y, z)), tg, strides,
                           caps)
    # the same bf16 rows, the 8 corners summed in another order than JAX's
    # 128 lanes: measured 1.5e-7 at these table values
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=1e-6)
    std = brick_encode_ray(torch.from_numpy(table), *map(
        torch.from_numpy, (x, y, z)), tg, strides)
    if which == "tight":      # the clipped points read another row
        assert not torch.equal(got, std)
    else:                     # every point reads its own row
        assert torch.equal(got, std)
    got.backward(torch.from_numpy(cot))
    g = tt.grad.numpy()
    assert _rel(g, g_ref) <= 1e-5
    # where a run's float32 sum lands on a bf16 rounding tie in one package
    # and not the other (another summation order), the entry moves by one
    # bf16 ulp of that run's sum, which the same gradient of |cotangent|
    # bounds; measured: no such entry (the run sums agree bitwise)
    diff = np.abs(g - g_ref)
    plan, total = level_plan(tg, strides, n, s)
    g_abs = brick_points_grad_plain(
        tg.table_shape, *map(torch.from_numpy, (x, y, z)), tg, strides,
        lerp_levels_transpose(torch.from_numpy(cot), plan, n, s, total).abs(),
        caps).numpy()
    moved = diff > 0
    assert moved.mean() <= 1e-3, moved.mean()
    assert (diff[moved] <= _bf16_ulp(g_abs[moved])).all()


@pytest.fixture(scope="module")
def room():
    """The 32x64 cube-room pano in a JAX and a port pool, and the pool's
    occupancy grid (res 64, dilation 1)."""
    pano = j_room(jnp.eye(4), 32, 64)
    maps = {k: np.asarray(v) for k, v in pano.items()}
    jp, tp = JPool(), SupInfoPool()
    for pool in (jp, tp):
        pool.register_sup_info(np.eye(4, dtype=np.float32),
                               np.ones((32, 64)), maps["rgb"],
                               maps["distance"], maps["normal"])
    return jp, tp, jp.gen_occ_grid(64, 1)


def test_probe_run_caps_equal_jax(room):
    """``select_sample_budget`` with ``dedup_runs``: the budget, the bucket
    plan and the probed caps equal JAX's on JAX's jitter draw (integers);
    the probe at a larger budget too. A hash field gets no caps."""
    jp, tp, occ_j = room
    kw = dict(step=4e-3, max_samples=128, occ_res=64)
    tc = dict(pixel_loss_batch_size=256, dedup_runs=True)
    from perf_tpu.fields.ngp import NGPFieldConfig as JField
    from perf_tpu.kernels.brickgrid import BrickGridConfig as JGrid
    js = JScene(JField(grid=JGrid(**PROBE_GRID)), J.RenderConfig(**kw),
                JTrain(**tc), jax.random.PRNGKey(0))
    ts = NeRFScene(NGPFieldConfig(grid=BrickGridConfig(**PROBE_GRID)),
                   T.RenderConfig(**kw), torch.Generator().manual_seed(0),
                   "cpu", train_cfg=TrainConfig(**tc))
    js.occ_grid = occ_j
    ts.occ_grid = torch.from_numpy(np.array(occ_j))
    key = jax.random.PRNGKey(5)
    js._next_key = lambda: key
    probe = 300
    jitter = torch.from_numpy(np.array(jax.random.uniform(key, (probe, 1))))
    budget = ts.select_sample_budget(tp.device_arrays("cpu"), probe, jitter)
    assert budget == js.select_sample_budget(jp.device_arrays(), probe)
    assert ts.bucket_plan == js.bucket_plan
    assert ts.run_caps == js.run_caps
    assert ts.run_caps is not None and sum(c > 0 for c in ts.run_caps) == 2
    assert ts.phase_render_cfg("geo")[0].run_caps == ts.run_caps
    arrs = jp.device_arrays()
    idx = np.linspace(0, int(arrs["n_valid"]) - 1, probe).astype(np.int32)
    o, d = arrs["rays_o"][idx], arrs["rays_d"][idx]
    caps_j = js._probe_run_caps(o, d, 128)
    assert ts.probe_run_caps(torch.from_numpy(np.array(o)),
                             torch.from_numpy(np.array(d)), 128,
                             jitter) == caps_j
    # a hash field: no caps, the standard encode
    hs = NeRFScene(NGPFieldConfig(grid=HashGridConfig(
        n_levels=4, log2_table_size=10, base_res=16, per_level_scale=2.0)),
        T.RenderConfig(**kw), torch.Generator().manual_seed(0), "cpu",
        train_cfg=TrainConfig(**tc))
    hs.occ_grid = ts.occ_grid
    hs.select_sample_budget(tp.device_arrays("cpu"), probe)
    assert hs.run_caps is None and hs.phase_render_cfg("app")[0].run_caps \
        is None


def test_dedup_training_converges():
    """The contract of tests/test_bucketed.py:121 on the port: a brick field
    probes run caps, at least one above 0, and training through the dedup
    encode lowers the loss with finite losses."""
    h, w = 64, 128
    fc = NGPFieldConfig(grid=BrickGridConfig(
        n_levels=4, n_features=2, log2_bricks=10, base_res=16,
        per_level_scale=2.0))
    rc = T.RenderConfig(step=4e-3, max_samples=64, occ_res=64)
    pano = render_cube_room_pano(torch.eye(4), h, w)
    pool = SupInfoPool()
    pool.register_sup_info(np.eye(4, dtype=np.float32), np.ones((h, w)),
                           pano["rgb"].numpy(), pano["distance"].numpy(),
                           pano["normal"].numpy())
    tc = TrainConfig(pixel_loss_batch_size=512, raw_phase_iter_geo=40,
                     raw_phase_iter_app=20, dedup_runs=True)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        scene = NeRFScene(fc, rc, torch.Generator().manual_seed(0), "cpu",
                          train_cfg=tc)
        out = scene.fit(pool)
    finally:
        torch.set_num_threads(n)
    assert scene.run_caps is not None, "brick field must probe run caps"
    assert any(c > 0 for c in scene.run_caps)
    g = out["geo_losses"]
    assert float(g[-1][0]) < float(g[0][0])
    assert np.isfinite(g).all() and np.isfinite(out["app_losses"]).all()
