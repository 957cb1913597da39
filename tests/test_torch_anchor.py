"""Port vs ``perf_tpu``: the modules of the anchor cycle and the bootstrap.

Inputs are drawn with NumPy from a seed; where JAX draws random numbers
inside a function (the sphere field's init, the distillation's coords and
tangent draws, the normals' tangent basis, the prune's jitter) the test
draws JAX's own values from the same keys with ``jax.random`` and hands
them to the port. The port runs on CPU tensors, where every kernel wrapper
(``bilinear``, ``brick_encode_grad``, ``occ_prune``) takes its plain
version. Widths are small: a 6-level sphere field, 24-32 pixel views,
32x64 panos.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import perf_tpu.core as JC
from perf_tpu.core.morphology import binary_open_close as j_open_close
from perf_tpu.core.morphology import ellipse_kernel as j_ellipse
from perf_tpu.fields.sphere_field import (
    SphereFieldConfig as JSphere, grads_to_normal as j_grads_to_normal,
    init_sphere_field as j_init_sphere,
    sphere_field_distance_and_grad as j_sphere_dg)
from perf_tpu.priors import (FakeCubeRoomDepthPredictor as JFakeDepth,
                             FakeCubeRoomNormalPredictor as JFakeNormal)
from perf_tpu.fields.mlp import vanilla_mlp_apply as j_vanilla_apply
from perf_tpu.inpaint import (FakeInpainter as JFakeInpainter,
                              PanoPersFusionInpainter as JFusion)
from perf_tpu.kernels.brickgrid import (
    BrickGridConfig as JGrid, brick_encode_stacked_grad as j_stacked_grad)
from perf_tpu.native import solve_tour as j_solve_tour
from perf_tpu.pose import (CirclePoseSampler as JCircle,
                           DenseTravelPoseSampler as JDense)
from perf_tpu.render import renderer as J
from perf_tpu.train import NeRFScene as JScene, SupInfoPool as JPool
from perf_tpu.train import TrainConfig as JTrain
from perf_tpu.train.scene import pano_visibility_from_distance as j_visibility
from perf_tpu.utils import render_cube_room_pano as j_room

import perf_tpu_torch.core as TC
from perf_tpu_torch.convert import (occ_grid_from_jax, params_from_jax,
                                    sphere_field_from_jax)
from perf_tpu_torch.fields import (SphereFieldConfig, grads_to_normal,
                                   sphere_field_distance_and_grad,
                                   vanilla_mlp_apply)
from perf_tpu_torch.inpaint import FakeInpainter, PanoPersFusionInpainter
from perf_tpu_torch.kernels.brickgrid import (BrickGridConfig,
                                              brick_encode_stacked_grad)
from perf_tpu_torch.native import solve_tour
from perf_tpu_torch.pose import CirclePoseSampler, DenseTravelPoseSampler
from perf_tpu_torch.priors import (FakeCubeRoomDepthPredictor,
                                   FakeCubeRoomNormalPredictor)
from perf_tpu_torch.render.renderer import render_image
from perf_tpu_torch.train import NeRFScene, SupInfoPool
from perf_tpu_torch.train.scene import (field_prune_occ,
                                        pano_visibility_from_distance)
from perf_tpu_torch.utils import cube_room_occ_grid, random_field_params

from test_torch_common import configs

# the sphere field of tests/test_sphere_analytic.py: 6 levels from 16 to
# 128, 64 rows per level, every level hashed
SPHERE = dict(n_levels=6, log2_table_size=12, fine_res=128)
H, W = 32, 64


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _unit(rng, shape):
    d = rng.standard_normal(shape)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def room():
    """The cube room from the origin at 32x64 (JAX's), as numpy."""
    pano = j_room(jnp.eye(4), H, W)
    return {k: np.asarray(v) for k, v in pano.items()}


# -- cameras, poses, resampling, morphology ------------------------------------

def test_tangent_cameras_and_camera_chain_match_jax():
    for ratio, yaw in ((1.1, 0.0), (1.4, 2.3)):
        ours = TC.tangent_cameras(16, ratio, yaw=yaw)
        ref = JC.tangent_cameras(16, ratio, yaw=yaw)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(TC.tangent_c2w(*ours[2:]), JC.tangent_c2w(*ref[2:])):
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    dirs = rng.standard_normal((64, 3)).astype(np.float32) * 2.0
    # trig on float32: within a few ulps (atan2 / arcsin implementations)
    for name in ("direction_to_pano_coord", "direction_to_img_coord"):
        np.testing.assert_allclose(getattr(TC, name)(_t(dirs)).numpy(),
                                   getattr(JC, name)(jnp.asarray(dirs)),
                                   rtol=0, atol=2e-6, err_msg=name)
    pc = np.stack([rng.uniform(-1.5, 1.5, 64), rng.uniform(-3, 3, 64)], -1)
    np.testing.assert_allclose(TC.pano_to_img_coord(_t(pc)).numpy(),
                               JC.pano_to_img_coord(jnp.asarray(pc, jnp.float32)),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(TC.look_at(_t(dirs)).numpy(),
                               JC.look_at(jnp.asarray(dirs)), atol=1e-6)
    _, _, tos, downs, rights = JC.tangent_cameras(8, 1.1)
    ij, m = TC.direction_to_pers_img_coord(_t(dirs), _t(tos[3]), _t(downs[3]),
                                           _t(rights[3]))
    jij, jm = JC.direction_to_pers_img_coord(jnp.asarray(dirs), tos[3],
                                             downs[3], rights[3])
    np.testing.assert_array_equal(m.numpy(), jm)
    np.testing.assert_allclose(ij.numpy(), jij, atol=2e-6)


def test_pose_samplers_and_tour_match_jax(room):
    dist = room["distance"] / room["distance"].max() / 1.05
    ours = CirclePoseSampler(dist, (0.2, 0.4), (3, 2))
    ref = JCircle(dist, (0.2, 0.4), (3, 2))
    # the loops are resampled at W * 128 points by arc length: an ulp of
    # sin / cos between the packages can move a pick to a neighbouring
    # point, ~2 pi r / (W * 128) away (1.3e-4 here); bound: two spacings
    step = 4 * np.pi * float(np.linalg.norm(ref.anchor_pts, axis=-1).max()) \
        / (W * 128)
    np.testing.assert_allclose(ours.anchor_pts, ref.anchor_pts, atol=step)
    pos = np.random.default_rng(1).uniform(-1, 1, (9, 3)).astype(np.float32)
    # the tour: the same C++ annealer on both sides, so the same order
    np.testing.assert_array_equal(solve_tour(pos, 2000, 3),
                                  j_solve_tour(pos, 2000, 3))
    d_ours = DenseTravelPoseSampler(ours, 12)
    d_ref = JDense(ref, 12)
    assert d_ours.n_poses == d_ref.n_poses
    np.testing.assert_allclose(d_ours.sample_poses[:, :3, 3],
                               d_ref.sample_poses[:, :3, 3], atol=step)
    np.testing.assert_allclose(d_ours.sample_poses[:, :3, :3],
                               d_ref.sample_poses[:, :3, :3], atol=1e-2)


@pytest.mark.parametrize("padding", ["border", "wrap_x", "zeros"])
def test_bilinear_sample_and_image_grad_match_jax(padding):
    rng = np.random.default_rng(2)
    img = rng.standard_normal((3, 9, 13, 4)).astype(np.float32)
    # coords reach past the image on every side
    coords = rng.uniform(-0.2, 1.2, (3, 50, 2)).astype(np.float32)
    cot = rng.standard_normal((3, 50, 4)).astype(np.float32)
    jfn = jax.vmap(lambda i, c: JC.bilinear_sample(i, c, padding))
    ref, vjp = jax.vjp(lambda i: jfn(i, jnp.asarray(coords)), jnp.asarray(img))
    (g_ref,) = vjp(jnp.asarray(cot))
    timg = _t(img).requires_grad_(True)
    out = TC.bilinear_sample(timg, _t(coords), padding)
    (g,) = torch.autograd.grad(out, timg, _t(cot))
    # the same taps and weights, products in JAX's order: float32 rounding
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=2e-6)
    np.testing.assert_allclose(g.numpy(), g_ref, atol=2e-6)
    # one image, coords of any leading shape
    one = TC.bilinear_sample(_t(img[1]), _t(coords[1].reshape(5, 10, 2)),
                             padding)
    np.testing.assert_allclose(
        one.numpy().reshape(50, 4),
        JC.bilinear_sample(jnp.asarray(img[1]), jnp.asarray(coords[1]),
                           padding), atol=2e-6)


def test_binary_open_close_matches_jax():
    for size in (3, 5, 9, 11):
        np.testing.assert_array_equal(TC.ellipse_kernel(size), j_ellipse(size))
    m = (np.random.default_rng(3).uniform(size=(H, W)) > 0.4).astype(
        np.float32)
    for small, large, first in ((5, 9, True), (3, 9, True), (3, 5, False)):
        np.testing.assert_array_equal(
            TC.binary_open_close(_t(m), small, large, first).numpy(),
            j_open_close(jnp.asarray(m), small, large, first))


def test_fake_priors_match_jax():
    dirs, _, tos, downs, rights = JC.tangent_cameras(12, 1.4, yaw=0.7)
    c2w = JC.tangent_c2w(tos, downs, rights)[0]
    origin = np.array([0.1, -0.2, 0.05], np.float32)
    d_ours = FakeCubeRoomDepthPredictor(noise=0.05, scale_jitter=0.1, seed=4)
    d_ref = JFakeDepth(noise=0.05, scale_jitter=0.1, seed=4)
    np.testing.assert_allclose(
        d_ours.predict_depth(None, dirs=_t(dirs), origin=origin).numpy(),
        d_ref.predict_depth(None, dirs=jnp.asarray(dirs), origin=origin),
        rtol=2e-6)
    n_ours = FakeCubeRoomNormalPredictor(noise=0.02, seed=5)
    n_ref = JFakeNormal(noise=0.02, seed=5)
    np.testing.assert_allclose(
        n_ours.predict_normal(None, dirs=_t(dirs), c2w=_t(c2w)).numpy(),
        n_ref.predict_normal(None, dirs=jnp.asarray(dirs), c2w=c2w),
        atol=2e-6)


# -- the sphere field ------------------------------------------------------------

@pytest.fixture(scope="module")
def sphere():
    """A JAX sphere field with bf16-robust table magnitudes, its port copy,
    and unit directions."""
    jcfg = JSphere(**SPHERE, encoding="brick", grad_mode="analytic")
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    params = j_init_sphere(k1, jcfg)
    params["table"] = 0.1 * jax.random.normal(k2, params["table"].shape)
    dirs = np.asarray(jax.random.normal(k3, (384, 3)))
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    return jcfg, params, SphereFieldConfig(**SPHERE, encoding="brick",
                                           grad_mode="analytic"), \
        sphere_field_from_jax(params), dirs


def test_brick_encode_stacked_grad_and_table_grad_match_jax(sphere):
    jcfg, jp, cfg, tp, dirs = sphere
    x = (dirs * 0.49 + 0.49).astype(np.float32)
    jgrid, grid = jcfg.grid, cfg.grid
    assert grid == BrickGridConfig(**{
        f.name: getattr(jgrid, f.name) for f in dataclasses.fields(grid)})
    (f_ref, d_ref), vjp = jax.vjp(
        lambda t: j_stacked_grad(t, jnp.asarray(x), jgrid), jp["table"])
    table = tp["table"].clone().requires_grad_(True)
    feats, dfeats = brick_encode_stacked_grad(table, _t(x), grid)
    # 8 corners summed against JAX's 128 lanes: float32 sum order
    np.testing.assert_allclose(feats.detach().numpy(), f_ref, atol=1e-6)
    np.testing.assert_allclose(dfeats.detach().numpy(), d_ref,
                               atol=1e-6 * float(np.abs(d_ref).max()))
    rng = np.random.default_rng(6)
    gf = rng.standard_normal(f_ref.shape).astype(np.float32)
    gd = rng.standard_normal(d_ref.shape).astype(np.float32)
    (g_ref,) = vjp((jnp.asarray(gf), jnp.asarray(gd)))
    g = torch.autograd.grad((feats, dfeats), table, (_t(gf), _t(gd)))[0]
    # the same bf16-rounded combined rows; the chain products and the
    # float32 scatter sums in another order (bound 1e-5 relative norm)
    assert _rel(g.numpy(), g_ref) < 1e-5


def test_sphere_field_distance_and_grad_match_jax(sphere):
    jcfg, jp, cfg, tp, dirs = sphere
    d_ref, g_ref = j_sphere_dg(jp, jnp.asarray(dirs), jcfg)
    d, g = sphere_field_distance_and_grad(tp, _t(dirs), cfg)
    # the MLP's float32 products in another order: ~1e-6 relative
    np.testing.assert_allclose(d.detach().numpy(), d_ref, rtol=1e-5)
    np.testing.assert_allclose(g.detach().numpy(), g_ref, rtol=1e-4,
                               atol=1e-4 * float(np.abs(g_ref).max()))
    # the VanillaMLP alone, on the field's input width
    x = np.random.default_rng(10).normal(size=(64, 3 + 2 * SPHERE["n_levels"]))
    x = x.astype(np.float32)
    np.testing.assert_allclose(
        vanilla_mlp_apply(tp["mlp"], _t(x)).numpy(),
        j_vanilla_apply(jp["mlp"], jnp.asarray(x), sphere_init=True),
        rtol=1e-5, atol=1e-6)
    key = jax.random.PRNGKey(9)
    ortho = np.asarray(jax.random.normal(key, dirs.shape))
    np.testing.assert_allclose(
        grads_to_normal(_t(dirs), _t(g_ref), _t(ortho)).numpy(),
        j_grads_to_normal(jnp.asarray(dirs), g_ref, key), atol=2e-5)


# -- inpainting ----------------------------------------------------------------------

def test_fake_inpainter_and_fusion_match_jax(room):
    img = room["rgb"]
    mask = np.zeros((H, W), np.float32)
    mask[8:20, 10:40] = 1.0
    mask[2:6, 50:62] = 1.0
    ours = FakeInpainter().inpaint(_t(img), _t(mask))
    ref = JFakeInpainter().inpaint(jnp.asarray(img), jnp.asarray(mask))
    # pyramid means and box sums in another order: float32 rounding
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5)
    dist = room["distance"] / room["distance"].max()
    ours = FakeInpainter().inpaint_rgbd(_t(img), _t(dist), _t(mask))
    ref = JFakeInpainter().inpaint_rgbd(jnp.asarray(img), jnp.asarray(dist),
                                        jnp.asarray(mask))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5)
    ours = PanoPersFusionInpainter(FakeInpainter(), gen_res=24).inpaint(
        _t(img), _t(mask))
    ref = JFusion(JFakeInpainter(), gen_res=24).inpaint(jnp.asarray(img),
                                                        jnp.asarray(mask))
    # 20 sequential view fills and reprojections: the rounding compounds
    np.testing.assert_allclose(ours.numpy(), ref, atol=5e-5)


# -- the pool's projection cores, the prune, the preview --------------------------

def _pools(room):
    """Three registered panos (the room from three poses) in both pools:
    capacity 4, so one padded slot."""
    jpool, pool = JPool(), SupInfoPool()
    for k, pos in enumerate(((0, 0, 0), (0.2, -0.1, 0.05), (-0.15, 0.2, 0))):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = pos
        p = j_room(jnp.asarray(pose), H, W)
        m = np.ones((H, W), np.float32)
        m[:, k * 10:k * 10 + 12] = 0.0
        for pl in (jpool, pool):
            pl.register_sup_info(pose=pose, mask=m, rgb=np.asarray(p["rgb"]),
                                 distance=np.asarray(p["distance"]),
                                 normal=np.asarray(p["normal"]))
    return jpool, pool


def test_visibility_and_geo_check_masks_match_jax(room):
    jpool, pool = _pools(room)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.1, 0.25, -0.1)
    jrays = JC.gen_pano_rays(jnp.asarray(pose), H, W)
    rays = TC.gen_pano_rays(_t(pose), H, W)
    dist = j_room(jnp.asarray(pose), H, W)["distance"]
    for scale in (1.0, 0.9, 1.15):
        jd = dist * scale
        np.testing.assert_array_equal(
            pano_visibility_from_distance(pool, rays, _t(jd)).numpy(),
            j_visibility(jpool, jrays, jd))
        np.testing.assert_array_equal(pool.geo_check(rays, _t(jd)).numpy(),
                                      jpool.geo_check(jrays, jd))


@pytest.fixture(scope="module")
def trained_field():
    """A JAX scene with seeded random parameters over the cube room's
    occupancy (the tiny NGP config of test_torch_common)."""
    (jf, jr, _), (tf, tr, _) = configs()
    # a density gain that puts about half the shell under the prune's
    # threshold
    params = random_field_params(0, tf, density_gain=0.9)
    # the port's grid of the room (occ_grid_from_points is bitwise JAX's:
    # test_torch_common)
    occ = cube_room_occ_grid(64, 64, 128).numpy()
    js = JScene(jf, jr, JTrain(occ_field_prune=True), jax.random.PRNGKey(1))
    js.params = jax.tree_util.tree_map(jnp.asarray, params)
    js.occ_grid = jnp.asarray(occ)
    return js, params, occ, (tf, tr)


def test_field_prune_occ_matches_jax(trained_field):
    js, params, occ, (tf, tr) = trained_field
    rng = np.random.default_rng(8)
    occ_new = occ.copy()
    occ_new[rng.uniform(size=occ.size) < 0.01] = 1
    prev = occ.copy()
    prev[rng.uniform(size=occ.size) < 0.2] = 0
    res, chunk = tr.occ_res, min(1 << 21, tr.occ_res ** 3)
    # JAX draws one key per prune and one jitter table per fold
    k = jax.random.split(js.key)[1]
    jitter = np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(k, j), (chunk, 3))) for j in range(2)])
    ref = np.asarray(js._field_prune_occ(jnp.asarray(occ_new),
                                         jnp.asarray(prev)))
    got = field_prune_occ(params_from_jax(params)["geo"], tf,
                          torch.from_numpy(occ_new), torch.from_numpy(prev),
                          res, _t(jitter)).numpy()
    # the same densities up to float32 sum order and bf16 ties in the MLP;
    # no voxel here sits within rounding of the threshold, so bitwise
    assert (got != ref).sum() == 0
    shell = (occ_new != 0) & (prev != 0)
    assert 0 < int((ref[shell] == 0).sum()) < int(shell.sum())


def test_preview_render_image_matches_jax(trained_field):
    js, params, occ, (tf, tr) = trained_field
    jrays = JC.gen_pano_rays(jnp.eye(4), 16, 32)
    rc = dataclasses.replace(js.render_cfg, adaptive_eval=False,
                             max_samples=64)
    ref = J.render_image(js.params, js.field_cfg, js.occ_grid, jrays,
                         jax.random.PRNGKey(0), rc, chunk=256)
    rays = TC.gen_pano_rays(torch.eye(4), 16, 32)
    out = render_image(params_from_jax(params), tf, occ_grid_from_jax(occ),
                       rays, dataclasses.replace(tr, max_samples=64),
                       chunk=256)
    # bf16 ties in the MLPs and float32 composite order (Queue 3)
    for q in ("rgb", "distance"):
        err = np.abs(out[q].numpy() - np.asarray(ref[q]))
        assert (err > 1e-4).mean() < 0.02 and err.max() < 5e-2, q
