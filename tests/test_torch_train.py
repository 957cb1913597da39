"""Port vs ``perf_tpu``: the training slice (``mode=train``, the raw fit).

Inputs are drawn with NumPy from a seed; where JAX draws random numbers
inside a function (march jitter, backgrounds, distance noise) the test
draws JAX's own values from the same key with ``jax.random`` and hands
them to the port, so one training step compares exactly. The port runs on
CPU tensors, where every kernel wrapper takes its plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from perf_tpu.core import edge_keep_mask as j_edge_keep
from perf_tpu.core.optim import guarded_step
from perf_tpu.kernels.brickgrid import brick_encode_ray as j_encode_ray
from perf_tpu.kernels.hashgrid import level_strides as j_level_strides
from perf_tpu.render import renderer as J
from perf_tpu.train import NeRFScene as JScene, SupInfoPool as JPool
from perf_tpu.train import TrainConfig as JTrain
from perf_tpu.train import load_checkpoint as j_load
from perf_tpu.train.schedule import (OptimConfig as JOptim, lr_at as j_lr_at,
                                     smooth_l1 as j_smooth_l1)
from perf_tpu.utils import render_cube_room_pano

from perf_tpu_torch.convert import params_from_jax
from perf_tpu_torch.core import GuardedAdam, edge_keep_mask
from perf_tpu_torch.kernels.brickgrid import brick_encode_ray
from perf_tpu_torch.kernels.hashgrid import level_strides
from perf_tpu_torch.render import renderer as T
from perf_tpu_torch.train import (NeRFScene, OptimConfig, SupInfoPool,
                                  TrainConfig, lr_at, smooth_l1)
from perf_tpu_torch.utils import random_field_params

from test_torch_common import configs

# the training render config of these tests: 8-step windows sampled at
# stride 2 (4 samples per window), a 64-sample budget (16 windows)
TRAIN_RENDER = dict(step=4e-3, occ_res=64, march_coarse=8, max_samples=32,
                    sample_stride=2)


@pytest.fixture
def one_thread():
    """Run the port's many small CPU ops on one thread: beside JAX's thread
    pool (and other test workers) torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


@pytest.fixture(scope="module")
def room():
    """The 32x64 cube-room pano, registered in a JAX and a port pool."""
    pano = render_cube_room_pano(jnp.eye(4), 32, 64)
    maps = {k: np.asarray(v) for k, v in pano.items()}
    jp, tp = JPool(), SupInfoPool()
    for pool in (jp, tp):
        pool.register_sup_info(np.eye(4, dtype=np.float32),
                               np.ones((32, 64)), maps["rgb"],
                               maps["distance"], maps["normal"])
    return maps, jp, tp


@pytest.fixture(scope="module")
def pool_grid(room):
    """The JAX pool's occupancy grid (res 64, dilation 1) and its arrays,
    made once for the tests that march its rays."""
    _, jp, _ = room
    return jp.gen_occ_grid(64, 1), jp.device_arrays()


@pytest.fixture(scope="module")
def field():
    """Tiny field params in both trees, scaled so that the rays' opacity
    spreads over 0.15-0.8 (neither transparent nor saturated)."""
    (jf, _, _), (tf, _, _) = configs()
    p = random_field_params(3, tf, table_scale=0.2, density_gain=6.0)
    return jf, tf, jax.tree_util.tree_map(jnp.asarray, p), p


def test_lr_at_and_smooth_l1_match_jax():
    cfg = dict(init_lr=1e-3, peak_lr=1e-2, peak_at=0.2, lr_alpha=1e-2)
    for prog in (0.0, 0.05, 0.2, 0.37, 0.9, 1.0):
        np.testing.assert_allclose(lr_at(prog, OptimConfig(**cfg)),
                                   float(j_lr_at(prog, JOptim(**cfg))),
                                   rtol=1e-6, atol=1e-12)
    rng = np.random.default_rng(0)
    a, b = (rng.normal(size=(257, 3)).astype(np.float32) * 0.05
            for _ in range(2))
    for beta in (1e-2, 5e-2):
        np.testing.assert_allclose(
            float(smooth_l1(torch.from_numpy(a), torch.from_numpy(b), beta)),
            float(j_smooth_l1(jnp.asarray(a), jnp.asarray(b), beta)),
            rtol=1e-6)


def test_guarded_adam_matches_optax_and_skips_nonfinite():
    rng = np.random.default_rng(1)
    p0 = [rng.normal(size=s).astype(np.float32) for s in ((3, 5), (7,))]
    grads = [[rng.normal(size=x.shape).astype(np.float32) for x in p0]
             for _ in range(4)]
    grads[2][1][3] = np.nan                      # step 3 must be skipped
    adam = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)
    jp = [jnp.asarray(x) for x in p0]
    js = adam.init(jp)
    tp = [torch.from_numpy(x.copy()) for x in p0]
    opt = GuardedAdam(tp)
    for step, g in enumerate(grads):
        lr = 1e-2 * (step + 1)
        gj = [jnp.asarray(x) for x in g]
        upd, new_s = adam.update(gj, js)
        new_p = [p - lr * u for p, u in zip(jp, upd)]
        jp, js, finite_j = guarded_step(gj, new_p, new_s, jp, js)
        finite = opt.step(tp, [torch.from_numpy(x) for x in g], lr)
        assert bool(finite) == bool(finite_j) == (step != 2)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
        for a, b in zip(opt.mu + opt.nu, list(js.mu) + list(js.nu)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-9)
        assert int(opt.count) == int(js.count)
    assert int(opt.count) == 3


def test_edge_mask_and_sup_info_match_jax(room):
    maps, jp, tp = room
    dist = maps["distance"].copy()
    dist[10:14, 20:30] *= 0.6                     # a depth edge to filter
    got = edge_keep_mask(torch.from_numpy(dist)).numpy()
    assert np.array_equal(got, np.asarray(j_edge_keep(jnp.asarray(dist))))
    assert 0 < got.sum() < got.size
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.1, -0.05, 0.02)
    jp2, tp2 = JPool(), SupInfoPool()
    for pool in (jp2, tp2):
        pool.register_sup_info(pose, np.ones((32, 64)), maps["rgb"], dist,
                               maps["normal"])
    for a, b in ((jp, tp), (jp2, tp2)):
        ia, ib = a.sup_infos[0], b.sup_infos[0]
        assert np.array_equal(ia.mask, ib.mask)       # the kept pixels
        for k in ("rays_o", "rays_d", "colors", "distances", "normals"):
            np.testing.assert_allclose(b._cat[k], a._cat[k], atol=1e-6)
    # the occupancy grid of the pool: integers, bitwise
    assert np.array_equal(tp.gen_occ_grid(64, 1).numpy(),
                          np.asarray(jp.gen_occ_grid(64, 1)))


def test_stratified_march_and_count_equal_jax(pool_grid):
    occ_j, arrs = pool_grid
    occ_t = torch.from_numpy(np.array(occ_j))
    o = np.array(arrs["rays_o"][:1500])
    d = np.array(arrs["rays_d"][:1500])
    for kw in (TRAIN_RENDER, dict(TRAIN_RENDER, max_samples=64)):
        jc, tc = J.RenderConfig(**kw), T.RenderConfig(**kw)
        widx_j, wv_j, jit = jax.jit(J.march_windows, static_argnums=(4, 5))(
            occ_j, jnp.asarray(o), jnp.asarray(d), jax.random.PRNGKey(7), jc,
            True)
        jitter = torch.from_numpy(np.array(jit))
        widx, wv, counts, _, _ = T.march_windows(
            occ_t, torch.from_numpy(o), torch.from_numpy(d), tc,
            T.coarse_occ_grid(occ_t, 64), jitter=jitter)
        # every slot, the invalid ones included (lax.top_k's tie order)
        assert np.array_equal(widx.numpy(), np.asarray(widx_j))
        assert np.array_equal(wv.numpy(), np.asarray(wv_j))
        assert np.array_equal(counts.numpy(), np.asarray(wv_j).sum(1))
        assert 0 < counts.float().mean() < widx.shape[1]
        t_j, v_j = jax.jit(J._windows_to_samples, static_argnums=3)(
            widx_j, wv_j, jit, jc)
        t_t, v_t = T.windows_to_samples(widx, wv, tc, jitter)
        np.testing.assert_array_equal(t_t.numpy(), np.asarray(t_j))
        np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    jc = J.RenderConfig(**TRAIN_RENDER)
    assert np.array_equal(
        T.count_occupied_windows(occ_t, torch.from_numpy(o),
                                 torch.from_numpy(d),
                                 T.RenderConfig(**TRAIN_RENDER)).numpy(),
        np.asarray(J.count_occupied_windows(occ_j, jnp.asarray(o),
                                            jnp.asarray(d), jc)))


def test_brick_encode_ray_and_table_grad_match_jax(field):
    jf, tf, pj, pt = field
    rng = np.random.default_rng(2)
    n, s = 96, 32
    x, y, z = (np.sort(rng.uniform(0.1, 0.9, (n, s)), axis=1)
               .astype(np.float32) for _ in range(3))
    strides = level_strides(tf.grid, 4e-3, s)
    assert strides == j_level_strides(jf.grid, 4e-3, s) and max(strides) > 1
    cot = rng.normal(size=(n, s, tf.grid.out_dim)).astype(np.float32)
    table = pj["geo"]["table"]

    @jax.jit
    def fwd_vjp(t, c):
        out, vjp = jax.vjp(lambda t: j_encode_ray(
            t, *map(jnp.asarray, (x, y, z)), jf.grid, strides), t)
        return out, vjp(c)[0]

    ref, g_ref = fwd_vjp(table, jnp.asarray(cot))
    tt = torch.from_numpy(pt["geo"]["table"].copy()).requires_grad_(True)
    got = brick_encode_ray(tt, *map(torch.from_numpy, (x, y, z)), tf.grid,
                           strides)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-6)
    got.backward(torch.from_numpy(cot))
    assert _rel(tt.grad.numpy(), g_ref) < 1e-5


def _j_composite(sigma, t_mid, valid, delta):
    """The compositing lines of JAX's shade_rays (renderer.py:384-390) and
    distortion_per_ray, as a function of sigma."""
    from perf_tpu.kernels.distortion import distortion_per_ray
    tau = sigma * delta
    trans = jnp.exp(-(jnp.cumsum(tau, axis=-1) - tau))
    w = trans * (1.0 - jnp.exp(-tau))
    return (jnp.sum(w, -1, keepdims=True), jnp.sum(w * t_mid, -1, keepdims=True),
            distortion_per_ray(w, t_mid, delta, valid))


def test_shade_rays_train_and_dsigma_match_jax(pool_grid, field):
    """The training shade's outputs with JAX's draws, and dsigma of the
    composite (the gradients through the whole shade are held in
    test_bucketed_train_step_matches_jax)."""
    occ_j, arrs = pool_grid
    jf, tf, pj, pt = field
    jc = J.RenderConfig(**TRAIN_RENDER, remat=False)
    tc = T.RenderConfig(**TRAIN_RENDER)
    o, d = arrs["rays_o"][:300], arrs["rays_d"][:300]
    t_mid, valid = jax.jit(J.march_rays, static_argnums=(4, 5))(
        occ_j, o, d, jax.random.PRNGKey(1), jc, True)
    key = jax.random.PRNGKey(4)
    kc, kd = jax.random.split(key)
    bg = jax.random.uniform(kc, (300, 3))
    noise = jax.random.uniform(kd, (300, 1))
    out_j = jax.jit(lambda p: J.shade_rays(p, jf, o, d, t_mid, valid, key, jc,
                                           True))(pj)
    out = T.shade_rays(params_from_jax(pt), tf, *(
        torch.from_numpy(np.asarray(a)) for a in (o, d, t_mid, valid)), tc,
        torch.from_numpy(np.asarray(bg)), torch.from_numpy(np.asarray(noise)))
    assert 0.2 < float(out_j["opacity"].mean()) < 0.9
    for k in ("rgb", "distance", "opacity", "dist_loss"):
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(out_j[k]), atol=1e-5)

    # dsigma of the composite alone, against jax.grad of its JAX lines
    rng = np.random.default_rng(5)
    sig = (rng.exponential(40.0, t_mid.shape) * np.asarray(valid)).astype(
        np.float32)
    cots = [rng.normal(size=(300, 1)).astype(np.float32) for _ in range(2)]
    cots.append(rng.normal(size=(300,)).astype(np.float32))
    delta = tc.step * tc.sample_stride

    def j_lin(s):
        op, dist, dl = _j_composite(s, t_mid, valid, delta)
        return (jnp.sum(op * cots[0]) + jnp.sum(dist * cots[1])
                + jnp.sum(dl * cots[2]))

    ds_ref = jax.jit(jax.grad(j_lin))(jnp.asarray(sig))
    st = torch.from_numpy(sig).requires_grad_(True)
    _, op, dist, dl = T.shade_composite(st, torch.from_numpy(np.asarray(t_mid)),
                                        torch.from_numpy(np.asarray(valid)),
                                        delta)
    ((op * torch.from_numpy(cots[0])).sum() + (dist * torch.from_numpy(
        cots[1])).sum() + (dl * torch.from_numpy(cots[2])).sum()).backward()
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(ds_ref), atol=1e-5,
                               rtol=1e-5)


def test_render_train_finite_under_saturated_field(field):
    """A fully saturated density head must give finite outputs and finite
    gradients: padding samples are where-selected to 0, never inf * 0."""
    _, tf, _, pt = field
    p = params_from_jax(pt)
    p["geo"]["table"] = torch.ones_like(p["geo"]["table"])
    w0, w1 = p["geo"]["mlp"]["w"]
    p["geo"]["mlp"]["w"] = [w0.abs() + 0.1, (w1.abs() + 0.1) * 1e4]
    for t in [p["geo"]["table"]] + p["geo"]["mlp"]["w"]:
        t.requires_grad_(True)
    rc = T.RenderConfig(step=4e-3, occ_res=64, max_samples=64)
    from perf_tpu_torch.render import occ_grid_from_points
    grid = occ_grid_from_points(torch.tensor([[0.5, 0.0, 0.0],
                                              [0.0, 0.5, 0.0]]), 64)
    th = torch.linspace(0, 2 * np.pi, 9)[:8]
    d = torch.stack([torch.cos(th), torch.sin(th), torch.zeros(8)], -1)
    g = torch.Generator().manual_seed(1)
    draws = {k: torch.rand(s, generator=g) for k, s in
             (("jitter", (8, 1)), ("bg", (8, 3)), ("noise", (8, 1)))}
    out = T.render_rays(p, tf, grid, torch.zeros(8, 3), d, rc, draws,
                        stop_app_grad=True, need_rgb=False)
    loss = out["distance"].mean() + out["dist_loss"].mean()
    loss.backward()
    assert torch.isfinite(loss)
    for k in ("distance", "opacity", "dist_loss"):
        assert torch.isfinite(out[k]).all(), k
    for t in [p["geo"]["table"]] + p["geo"]["mlp"]["w"]:
        assert torch.isfinite(t.grad).all()


@pytest.mark.parametrize("phase", ["geo", "app"])
def test_bucketed_train_step_matches_jax(room, pool_grid, field, phase):
    """One step of the scene's geo / app loss through the two-budget
    render, with JAX's own draws: loss and gradients."""
    _, jp, _ = room
    occ_j, arrs = pool_grid
    jf, tf, pj, pt = field
    # remat only changes what JAX recomputes in the backward, not the values
    jc = J.RenderConfig(**TRAIN_RENDER, remat=False)
    tc = T.RenderConfig(**TRAIN_RENDER)
    sel = np.random.default_rng(6).integers(0, jp.n_valid, 512)
    o, d = arrs["rays_o"][sel], arrs["rays_d"][sel]
    gt_d, gt_c = arrs["distances"][sel], arrs["colors"][sel]
    s_low, n_high = 16, 64
    key = jax.random.PRNGKey(11)
    train_key = phase
    frozen_key = "app" if phase == "geo" else "geo"
    flags = (dict(stop_app_grad=True, need_rgb=False) if phase == "geo"
             else dict(stop_geo_grad=True))

    def j_loss(train):
        params = {train_key: train, frozen_key: pj[frozen_key]}
        out = J.render_rays_bucketed(params, jf, occ_j, o, d, key, jc, s_low,
                                     n_high, train=True, **flags)
        if phase == "geo":
            return (j_smooth_l1(out["distance"], gt_d, 1e-2)
                    + 0.1 * 0.5 * jnp.mean(out["dist_loss"]))
        return j_smooth_l1(out["rgb"], gt_c, 5e-2)

    loss_j, grads_j = jax.jit(jax.value_and_grad(j_loss))(pj[train_key])
    # JAX's draws: jitter from the march key, per bucket (colour, noise)
    k_march, k_lo, k_hi = jax.random.split(key, 3)
    bgs, noises = [], []
    for kb, nb in ((k_lo, 512 - n_high), (k_hi, n_high)):
        kc, kd = jax.random.split(kb)
        bgs.append(np.asarray(jax.random.uniform(kc, (nb, 3))))
        noises.append(np.asarray(jax.random.uniform(kd, (nb, 1))))
    draws = {"jitter": torch.from_numpy(np.array(
                 jax.random.uniform(k_march, (512, 1)))),
             "bg": torch.from_numpy(np.concatenate(bgs)),
             "noise": torch.from_numpy(np.concatenate(noises))}
    params = params_from_jax(pt)
    leaves = [params[train_key]["table"]] + params[train_key]["mlp"]["w"]
    for t in leaves:
        t.requires_grad_(True)
    occ_t = torch.from_numpy(np.array(occ_j))
    out = T.render_rays_bucketed(params, tf, occ_t,
                                 torch.from_numpy(np.asarray(o)),
                                 torch.from_numpy(np.asarray(d)), tc, s_low,
                                 n_high, draws, **flags)
    if phase == "geo":
        loss = (smooth_l1(out["distance"], torch.from_numpy(np.asarray(gt_d)),
                          1e-2) + 0.1 * 0.5 * out["dist_loss"].mean())
    else:
        loss = smooth_l1(out["rgb"], torch.from_numpy(np.asarray(gt_c)), 5e-2)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    refs = [grads_j["table"]] + list(grads_j["mlp"]["w"])
    for g, r in zip(grads, refs):
        assert float(np.abs(np.asarray(r)).max()) > 0
        # float32 sums in another order flip bf16 rounding ties of the MLP
        # (ROADMAP Queue 3): at most 0.6% of an app weight's entries move
        # by more than 1e-4 of its largest entry; the rest agree to ~1e-6
        assert _rel(g.numpy(), r) < 1e-3


def _tiny_train_cfgs(**kw):
    fc_j, fc_t = configs()[0][0], configs()[1][0]
    rc = dict(step=4e-3, max_samples=128, occ_res=64)
    tc = dict(raw_phase_iter_geo=60, raw_phase_iter_app=120,
              pixel_loss_batch_size=256, **kw)
    return ((fc_j, J.RenderConfig(**rc), JTrain(**tc)),
            (fc_t, T.RenderConfig(**rc), TrainConfig(**tc)))


def test_select_sample_budget_matches_jax(room):
    _, jp, tp = room
    (fj, rj, tj), (ft, rt, tt) = _tiny_train_cfgs()
    js = JScene(fj, rj, tj, jax.random.PRNGKey(0))
    ts = NeRFScene(ft, rt, torch.Generator().manual_seed(0), "cpu",
                   train_cfg=tt)
    for dil in (1, 0):
        js.occ_grid = jp.gen_occ_grid(64, dil)
        ts.occ_grid = tp.gen_occ_grid(64, dil)
        for probe in (16384, 300):
            b = ts.select_sample_budget(tp.device_arrays("cpu"), probe)
            assert b == js.select_sample_budget(jp.device_arrays(), probe)
            assert ts.bucket_plan == js.bucket_plan
    # the stride rule of _get_phase_fn: engaged where it divides
    ts.sample_budget, ts.bucket_plan = 96, (48, 64)
    rc, plan = ts.phase_render_cfg("geo")
    assert (rc.sample_stride, rc.max_samples, plan) == (2, 48, (24, 64))
    ts.sample_budget = 38
    rc, plan = ts.phase_render_cfg("app")
    assert (rc.sample_stride, rc.max_samples) == (1, 38)


def test_tiny_fit_meets_the_golden_bars(room, one_thread):
    """The port's episode on the 32x64 cube room, rendered through the
    snapshot at the input pose: the bars of test_train.py:112-136."""
    maps, _, tp = room
    _, (ft, rt, tt) = _tiny_train_cfgs()
    from perf_tpu_torch.core import gen_pano_rays
    from perf_tpu_torch.render import SnapshotConfig
    scene = NeRFScene(ft, rt, torch.Generator().manual_seed(0), "cpu",
                      SnapshotConfig(res=96, sample_stride=2), train_cfg=tt)
    losses = scene.fit(tp)
    geo, app = losses["geo_losses"], losses["app_losses"]
    assert (geo[:, -1] == 1).all() and (app[:, -1] == 1).all()
    assert geo[-10:, 1].mean() < geo[:10, 1].mean() * 0.5
    assert app[-10:, 1].mean() < app[:10, 1].mean()
    out = scene.render_snapshot(gen_pano_rays(torch.eye(4), 32, 64))
    mask = tp.sup_infos[0].mask[..., 0]
    depth_err = np.abs(out["distance"].numpy()[..., 0]
                       - maps["distance"][..., 0])[mask].mean()
    assert depth_err < 0.05, depth_err
    mse = np.mean((out["rgb"].numpy()[mask] - maps["rgb"][mask]) ** 2)
    assert -10 * np.log10(mse) > 30.0, mse


def test_cli_train_writes_a_checkpoint_jax_loads(tmp_path, room, one_thread):
    """``python -m perf_tpu_torch --device cpu ... mode=train`` on a 64x32
    cube-room pano: the run's artefacts, and a checkpoint that JAX's
    load_checkpoint, NeRFScene.load_state_dict and SupInfoPool restore."""
    from perf_tpu_torch.__main__ import main
    from perf_tpu_torch.utils.io import png_bytes
    pano = render_cube_room_pano(jnp.eye(4), 32, 64)
    room_dir = tmp_path / "room"
    room_dir.mkdir()
    rgb = np.round(np.clip(np.asarray(pano["rgb"]), 0, 1) * 255).astype(
        np.uint8)
    (room_dir / "image.png").write_bytes(png_bytes(rgb))
    np.save(room_dir / "image_ref_distance.npy", np.asarray(pano["distance"]))
    np.save(room_dir / "image_ref_normal.npy", np.asarray(pano["normal"]))
    exp = tmp_path / "exp"
    runner = main(["--device", "cpu", "--config-name", "nerf",
                   f"dataset.image_path={room_dir / 'image.png'}",
                   "dataset.image_resize=[64,32]",
                   f"device.base_exp_dir={exp}", "mode=train",
                   "pose_sampler.n_anchors_per_ratio=[0,0,0]",
                   "scene.occ_res=64", "scene.march_step=0.004",
                   "scene.max_samples=64", "scene.field.n_levels=4",
                   "scene.field.log2_bricks=8", "scene.field.base_res=8",
                   "scene.field.per_level_scale=2.0",
                   "scene.train_conf.raw_phase_iter_geo=6",
                   "scene.train_conf.raw_phase_iter_app=4",
                   "scene.train_conf.pixel_loss_batch_size=256",
                   "snapshot.res=24"])
    run_dir = exp / "WildDataset_room" / "nerf_experiment"
    for name in ("1.png", "1_distance.png", "distance_vis.png",
                 "normal_vis.png", "ts_log/metrics.jsonl",
                 "checkpoints/ckpt.npz"):
        assert (run_dir / name).exists(), name
    state = j_load(str(run_dir / "checkpoints" / "ckpt.npz"))
    assert int(state["phase"]) == 0
    jf = configs()[0][0]
    js = JScene(jf, J.RenderConfig(step=4e-3, occ_res=64, max_samples=64),
                JTrain(), jax.random.PRNGKey(0))
    js.load_state_dict(state["scene"])
    assert (js.global_iter_geo, js.global_iter_app) == (6, 4)
    assert js.sample_budget == runner.scene.sample_budget
    np.testing.assert_array_equal(
        np.asarray(js.params["geo"]["table"]),
        runner.scene.params["geo"]["table"].numpy())
    pool = JPool()
    pool.load_state_dict(state["sup_pool"])
    assert pool.n_valid == runner.sup_pool.n_valid > 0
    # resuming a run whose raw fit is checkpointed trains nothing again
    resumed = main(["--device", "cpu", "--config-name", "nerf",
                    f"dataset.image_path={room_dir / 'image.png'}",
                    "dataset.image_resize=[64,32]",
                    f"device.base_exp_dir={exp}", "mode=train",
                    "is_continue=true",
                    "pose_sampler.n_anchors_per_ratio=[0,0,0]",
                    "scene.occ_res=64", "scene.field.n_levels=4",
                    "scene.field.log2_bricks=8", "scene.field.base_res=8",
                    "scene.field.per_level_scale=2.0"])
    assert resumed.phase == 0 and resumed.losses is None
    assert resumed.scene.global_iter_geo == 6
    # a refused configuration (an image not at the config's image_resize,
    # whose INTER_AREA resize is not ported) raises before any work
    with pytest.raises(ValueError, match="resizing is not ported"):
        main(["--device", "cpu", f"dataset.image_path={room_dir / 'image.png'}",
              f"device.base_exp_dir={exp}", "mode=train"])


def test_cli_refuses_what_jax_asserts_or_the_port_lacks(tmp_path):
    """``scene.train_conf.scan_chunk`` other than 1 (JAX's k steps per
    dispatch, not ported) raises; ``priors.joint.scan_chunk`` must divide
    ``iters_per_phase`` as JAX asserts; ``priors.joint.field.*`` replace
    keys of the joint default field (brick + analytic) as the JAX runner's
    ``_joint_cfg`` does, so hash alone (hash + analytic) and brick + ad are
    refused, and hash + ad is the published PeRF's field."""
    import dataclasses
    import os
    from types import SimpleNamespace

    from perf_tpu.app.runner import CoreRunner as JRunner
    from perf_tpu.config import load_config as j_load_config

    from perf_tpu_torch.__main__ import main
    from perf_tpu_torch.app.runner import joint_config, train_config
    from perf_tpu_torch.config import load_config

    configs = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs")

    def both(*overrides):
        conf = load_config(configs, "nerf", list(overrides))
        jconf = j_load_config(configs, "nerf", list(overrides))
        return conf, JRunner._joint_cfg(SimpleNamespace(conf=jconf))

    with pytest.raises(ValueError, match="scan_chunk"):
        train_config(load_config(configs, "nerf", [
            "scene.train_conf.scan_chunk=3"])["scene"]["train_conf"])
    with pytest.raises(ValueError, match="scan_chunk"):
        main(["--device", "cpu", "--config-name", "nerf",
              f"device.base_exp_dir={tmp_path}", "mode=train",
              "scene.train_conf.scan_chunk=25"])
    with pytest.raises(ValueError, match="scan_chunk"):
        joint_config(load_config(configs, "nerf", [
            "priors.joint.iters_per_phase=100", "priors.joint.scan_chunk=3"]))
    for overrides in (["priors.joint.iters_per_phase=100",
                       "priors.joint.scan_chunk=20"],
                      ["priors.joint.field.encoding=hash",
                       "priors.joint.field.grad_mode=ad"],
                      ["priors.joint.field.encoding=brick",
                       "priors.joint.field.grad_mode=fd",
                       "priors.joint.field.fine_res=1024"]):
        conf, jcfg = both(*overrides)
        assert (dataclasses.asdict(joint_config(conf))
                == dataclasses.asdict(jcfg)), overrides
    cfg = joint_config(both("priors.joint.field.encoding=hash",
                            "priors.joint.field.grad_mode=ad")[0])
    assert (cfg.field.encoding, cfg.field.grad_mode, cfg.field.fine_res,
            cfg.field.log2_table_size) == ("hash", "ad", 2048, 19)
    with pytest.raises(ValueError, match="analytic"):
        joint_config(load_config(configs, "nerf", [
            "priors.joint.field.encoding=hash"]))
    with pytest.raises(ValueError, match="'ad' needs"):
        joint_config(load_config(configs, "nerf", [
            "priors.joint.field.grad_mode=ad"]))
