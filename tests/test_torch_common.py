"""Shared tiny configs for the PyTorch port's parity tests, plus the parity
of the port's camera chain and checkpoint format with ``perf_tpu``.

Inputs are drawn with NumPy from a seed and handed to both packages; JAX
runs on the CPU (tests/conftest.py), the port on CPU tensors, where every
kernel wrapper takes its plain version.
"""

import numpy as np
import jax.numpy as jnp
import torch

from perf_tpu.core import gen_pano_rays as j_pano, gen_pers_rays as j_pers
from perf_tpu.fields.ngp import NGPFieldConfig as JField
from perf_tpu.kernels.brickgrid import BrickGridConfig as JGrid
from perf_tpu.render.occgrid import occ_grid_from_points as j_occ_from_points
from perf_tpu.render.renderer import RenderConfig as JRender
from perf_tpu.render.snapshot import SnapshotConfig as JSnap
from perf_tpu.train.checkpoint import (load_checkpoint as j_load,
                                       save_checkpoint as j_save)
from perf_tpu.utils import render_cube_room_pano

from perf_tpu_torch.core import gen_pano_rays, gen_pers_rays
from perf_tpu_torch.fields import NGPFieldConfig
from perf_tpu_torch.kernels import BrickGridConfig
from perf_tpu_torch.render import RenderConfig, SnapshotConfig
from perf_tpu_torch.render.occgrid import occ_grid_from_points
from perf_tpu_torch.train import load_checkpoint, save_checkpoint
from perf_tpu_torch.utils import random_field_params

# 4 levels (res 8, 16, 32, 64); levels 2 and 3 have more bricks than the
# 256 rows and are hashed
GRID = dict(n_levels=4, log2_bricks=8, base_res=8, per_level_scale=2.0)
# a short ladder: 375 steps of 4e-3 to far=1.5 over a 64^3 occupancy grid
RENDER = dict(step=4e-3, occ_res=64, march_coarse=8)
# snapshot stride 4 inside 8-step windows: 2 samples per window
SNAP = dict(res=48, sample_stride=4, bake_chunk=4096)


def configs():
    """(jax field, render, snap), (port field, render, snap)."""
    return ((JField(grid=JGrid(**GRID)), JRender(**RENDER), JSnap(**SNAP)),
            (NGPFieldConfig(grid=BrickGridConfig(**GRID)),
             RenderConfig(**RENDER), SnapshotConfig(**SNAP)))


def cube_room_occ(res: int = 64, h: int = 64, w: int = 128) -> np.ndarray:
    """The cube room's wall shell seen from the origin, built by the JAX
    package (flat uint8 [res^3])."""
    pano = render_cube_room_pano(jnp.eye(4), h, w)
    rays = j_pano(jnp.eye(4), h, w)
    pts = rays.o + rays.d * pano["distance"]
    return np.array(j_occ_from_points(pts.reshape(-1, 3), res))


def params_np(seed: int = 0) -> dict:
    return random_field_params(seed, configs()[1][0])


def random_rays(n: int, seed: int):
    """Origins in a small box around the centre, unit directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def assert_close_up_to_bf16_ties(got, ref, rtol: float, max_frac: float,
                                  rtol_tie: float):
    """Field outputs round the MLP's float32 sums to bf16 at the same points
    in both packages, but the sums are taken in another order (XLA vs
    torch's BLAS; even the buffer's alignment picks torch's path). Where a
    sum lies within a float32 ulp of a bf16 rounding tie the two round to
    neighbouring bf16 values, moving the output by about one bf16 ulp
    (2^-8 relative) of a hidden unit. So: ``rtol`` for all but a
    ``max_frac`` share of entries, ``rtol_tie`` for those."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref)
    scale = np.maximum(np.abs(ref), 1e-30)
    assert (err > rtol * scale).mean() <= max_frac, (err / scale).max()
    assert np.all(err <= rtol_tie * scale), (err / scale).max()


# -- the hash-grid field (scene.field.kind: hash) --------------------------------

# 6 levels from res 4 to 41 in 1024 rows: levels 0 and 1 dense, 2-5 hashed
HASH_GRID = dict(n_levels=6, n_features=2, log2_table_size=10, base_res=4,
                 per_level_scale=1.6)
# the same grid as CLI overrides of configs/nerf.yaml
HASH_CLI = ["scene.field.kind=hash", "scene.field.n_levels=6",
            "scene.field.log2_table_size=10", "scene.field.base_res=4",
            "scene.field.per_level_scale=1.6"]


def hash_fields(**grid):
    """(JAX NGP field, port NGP field) on the hash grid ``grid`` (default
    HASH_GRID)."""
    from perf_tpu.kernels.hashgrid import HashGridConfig as JHash
    from perf_tpu_torch.kernels import HashGridConfig
    grid = grid or HASH_GRID
    return (JField(grid=JHash(**grid)),
            NGPFieldConfig(grid=HashGridConfig(**grid)))


def cube_room_pools(h: int = 32, w: int = 64):
    """The cube-room pano at h x w (JAX's, as NumPy maps), registered in a
    JAX and a port pool."""
    from perf_tpu.train import SupInfoPool as JPool
    from perf_tpu_torch.train import SupInfoPool
    pano = render_cube_room_pano(jnp.eye(4), h, w)
    maps = {k: np.asarray(v) for k, v in pano.items()}
    jp, tp = JPool(), SupInfoPool()
    for pool in (jp, tp):
        pool.register_sup_info(np.eye(4, dtype=np.float32), np.ones((h, w)),
                               maps["rgb"], maps["distance"], maps["normal"])
    return maps, jp, tp


def test_occ_grid_from_points_matches_jax():
    pano = render_cube_room_pano(jnp.eye(4), 64, 128)
    rays = j_pano(jnp.eye(4), 64, 128)
    pts = np.array(rays.o + rays.d * pano["distance"]).reshape(-1, 3)
    # integer output: exactly equal
    assert np.array_equal(occ_grid_from_points(torch.from_numpy(pts), 64)
                          .numpy(), cube_room_occ())


def test_camera_rays_match_jax():
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.1, -0.2, 0.05)
    c, s = np.cos(0.4), np.sin(0.4)
    pose[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    for jr, tr in ((j_pano(jnp.asarray(pose), 32, 64),
                    gen_pano_rays(torch.from_numpy(pose), 32, 64)),
                   (j_pers(jnp.asarray(pose), 1.3, 32),
                    gen_pers_rays(torch.from_numpy(pose), 1.3, 32))):
        # float32 trig / linspace in two libraries: a few ulps
        np.testing.assert_allclose(tr.o.numpy(), np.asarray(jr.o), atol=0)
        np.testing.assert_allclose(tr.d.numpy(), np.asarray(jr.d), atol=1e-6)


def test_checkpoint_format_roundtrips_both_ways(tmp_path):
    state = {"scene": {"params": params_np(), "occ_grid": cube_room_occ(),
                       "global_iter_geo": 3, "global_iter_app": 2,
                       "sample_budget": 0},
             "phase": 1, "tup": (np.arange(3), 2.5)}
    j_save(str(tmp_path / "j.npz"), state)
    got = load_checkpoint(str(tmp_path / "j.npz"))
    save_checkpoint(str(tmp_path / "t.npz"), got)
    back = j_load(str(tmp_path / "t.npz"))
    for tree in (got, back):
        w = tree["scene"]["params"]["app"]["mlp"]["w"]
        assert isinstance(w, list) and len(w) == 3
        for a, b in zip(w, state["scene"]["params"]["app"]["mlp"]["w"]):
            assert np.array_equal(a, b)
        assert np.array_equal(tree["scene"]["occ_grid"],
                              state["scene"]["occ_grid"])
        assert isinstance(tree["tup"], tuple) and int(tree["phase"]) == 1
