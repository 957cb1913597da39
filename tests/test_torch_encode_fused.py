"""The encodes whose forward kernels write the finished features, against
JAX on the CPU.

``HashEncode`` and ``BrickEncode`` return the lerped, level-concatenated
features [N, S, L*F] (the point form: S = 1), as the ``hash_encode`` and
``brick_encode`` forward kernels write them on the card; their backward
forms the coarse points' cotangents with ``lerp_levels_transpose``. Here,
on CPU tensors (the plain versions), on 4-level grids with a dense level
and hashed ones, on plans that mix strides 16, 4, 2 and 1 (at 16 samples
a ray on the hash grid, 48 on the brick grid) and in the point form, with
coordinates exactly at 0 and 1 and beyond both faces:

- the features against JAX's ``hash_encode_ray``, ``brick_encode_ray`` and
  ``hash_encode_coords`` (hash bitwise, brick within 1e-6 as
  ``tests/test_torch_kernels.py`` states), and the table gradient against
  ``jax.vjp`` within the tolerances of ``tests/test_torch_hashgrid.py``
  and ``tests/test_torch_train.py`` (1e-5 relative norm: the same float32
  contributions, scatter-added in another order);
- the table gradient against autograd of the composition the port ran
  before (an encode of the coarse points [points, 2] with the same
  backward, then ``lerp_levels``), bitwise;
- ``lerp_levels_transpose`` against autograd of ``lerp_levels``, bitwise;
- the plain backward the hash kernel is held to on the card
  (``hash_encode_ray_bwd_plain``, from the features' cotangent) against
  ``jax.vjp`` at the fields' own grids: the proposal field's 5-level grid
  at stride 1, the sphere field's smoothstep point form and the NGP
  field's grid at a strided plan (1e-5 relative norm).

Inputs come from NumPy with a seed. JAX runs eagerly for the hash grid (its
jitted encode rounds differently from the op-by-op one the port follows
bitwise) and jitted for the brick grid.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perf_tpu.kernels import brickgrid as JB
from perf_tpu.kernels import hashgrid as JH

from perf_tpu_torch.fields.ngp import NGPDensityFieldConfig
from perf_tpu_torch.kernels import cuda
from perf_tpu_torch.kernels import brickgrid as TB
from perf_tpu_torch.kernels import hashgrid as TH

# res 4, 10, 27, 70: level 0 dense (125 corners), 1-3 hashed into 512 rows
HASH = TH.HashGridConfig(n_levels=4, log2_table_size=9, base_res=4,
                         per_level_scale=2.6)
# res 8, 16, 32, 64: level 0 dense (27 bricks), 1-3 hashed into 64 rows
BRICK = TB.BrickGridConfig(n_levels=4, log2_bricks=6, base_res=8,
                           per_level_scale=2.0)
# (samples a ray, strides): the hash grid's at 16 samples and in the point
# form (S = 1), the brick grid's at 48 (one ray shape each: JAX compiles
# its eager ops once a shape)
PLANS = {"s16": (16, (16, 1, 4, 2)), "point": (1, (1, 1, 1, 1)),
         "s48": (48, (2, 16, 1, 4))}


def _j_hash(grid: TH.HashGridConfig) -> JH.HashGridConfig:
    return JH.HashGridConfig(**dataclasses.asdict(grid))


def _j_brick(grid: TB.BrickGridConfig) -> JB.BrickGridConfig:
    return JB.BrickGridConfig(
        n_levels=grid.n_levels, log2_bricks=grid.log2_bricks,
        base_res=grid.base_res, per_level_scale=grid.per_level_scale)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _inputs(plan: str, out_dim: int, seed: int):
    """x, y, z [N, S] float32 (sorted along each ray, some samples exactly
    at 0 and 1 or beyond the faces), the strides and a cotangent [N, S,
    out_dim]."""
    s, strides = PLANS[plan]
    n = 37 if s == 1 else 11
    rng = np.random.default_rng(seed)
    pts = np.sort(rng.uniform(-0.05, 1.05, (n, s, 3)), axis=1)
    flat = pts.reshape(-1, 3)
    flat[::5] = np.array([0.0, 1.0, -0.2, 1.2, 0.5])[
        rng.integers(0, 5, flat[::5].shape)]
    x, y, z = (np.ascontiguousarray(pts[..., a], np.float32) for a in range(3))
    cot = rng.standard_normal((n, s, out_dim)).astype(np.float32)
    return x, y, z, strides, cot


class _CoarseHash(torch.autograd.Function):
    """The coarse points' features [points, 2] with the table gradient: the
    encode the port ran before its forward kernels wrote the finished
    features."""

    @staticmethod
    def forward(ctx, table, x, y, z, cfg, strides):
        ctx.save_for_backward(x, y, z)
        ctx.cfg, ctx.strides, ctx.shape = cfg, strides, table.shape
        return TH.hash_points_plain(table, x, y, z, cfg, strides)

    @staticmethod
    def backward(ctx, grad):
        x, y, z = ctx.saved_tensors
        return (TH.hash_points_grad_plain(ctx.shape, x, y, z, ctx.cfg,
                                          ctx.strides, grad),
                None, None, None, None, None)


class _CoarseBrick(_CoarseHash):

    @staticmethod
    def forward(ctx, table, x, y, z, cfg, strides):
        ctx.save_for_backward(x, y, z)
        ctx.cfg, ctx.strides, ctx.shape = cfg, strides, table.shape
        return TB.brick_points_plain(table, x, y, z, cfg, strides)

    @staticmethod
    def backward(ctx, grad):
        x, y, z = ctx.saved_tensors
        return (TB.brick_points_grad_plain(ctx.shape, x, y, z, ctx.cfg,
                                           ctx.strides, grad),
                None, None, None, None, None)


def _composition_grad(coarse_fn, table, coords, grid, strides, cot):
    """Table gradient of the earlier composition: the coarse encode, then
    each level's lerp and the concatenation under autograd."""
    n, s = coords[0].shape
    plan, _ = TH.level_plan(grid, strides, n, s)
    t = table.clone().requires_grad_(True)
    out = TH.lerp_levels(coarse_fn.apply(t, *coords, grid, strides), plan,
                         n, s)
    (g,) = torch.autograd.grad(out, t, cot)
    return out.detach(), g


@pytest.mark.parametrize("interpolation", ["linear", "smoothstep"])
@pytest.mark.parametrize("plan", ["s16", "point"])
def test_hash_encode_matches_jax_and_the_composition(plan, interpolation):
    grid = dataclasses.replace(HASH, interpolation=interpolation)
    x, y, z, strides, cot = _inputs(plan, grid.out_dim,
                                    len(plan) + len(interpolation))
    rng = np.random.default_rng(1)
    table = rng.uniform(-0.1, 0.1, grid.table_shape).astype(np.float32)
    jx, jy, jz = map(jnp.asarray, (x, y, z))
    if plan == "point":
        def j_fn(t):
            return JH.hash_encode_coords(t, jx[:, 0], jy[:, 0], jz[:, 0],
                                         _j_hash(grid))
    else:
        def j_fn(t):
            return JH.hash_encode_ray(t, jx, jy, jz, _j_hash(grid), strides)
    ref, vjp = jax.vjp(j_fn, jnp.asarray(table))
    cuda.reset_counts()
    tt = torch.from_numpy(table.copy()).requires_grad_(True)
    coords = [torch.from_numpy(a) for a in (x, y, z)]
    if plan == "point":
        got = TH.hash_encode_coords(tt, *(a[:, 0] for a in coords), grid)
        cot_t = torch.from_numpy(cot[:, 0])
    else:
        got = TH.hash_encode_ray(tt, *coords, grid, strides)
        cot_t = torch.from_numpy(cot)
    # the same corners, weights, sums and lerp in the same order
    assert np.array_equal(got.detach().numpy(), np.asarray(ref))
    (g_got,) = torch.autograd.grad(got, tt, cot_t)
    (g_ref,) = vjp(jnp.asarray(cot_t.numpy()))
    assert _rel(g_got.numpy(), g_ref) <= 1e-5
    out, g_comp = _composition_grad(_CoarseHash, torch.from_numpy(table),
                                    coords, grid, strides,
                                    torch.from_numpy(cot))
    assert torch.equal(got.detach().reshape(out.shape), out)
    assert torch.equal(g_got, g_comp)
    assert all(v == 0 for v in cuda.counts().values())   # the plain path


# the fields' own grids for the backward: (grid, samples a ray, strides).
# Cut to keep JAX's eager ops on one core within seconds: the sphere
# field's grid at fine_res 4096 to its first 6 levels (its growth kept) in
# 2^15 rows (levels 0-1 dense), the NGP field's grid to its first 3 levels
# (res 16 .. 33) in 2^13 rows (level 0 dense) at a 4e-3 step's strides 8
# and 4
_NGP = TH.HashGridConfig(n_levels=3, log2_table_size=13)
_SPHERE = dataclasses.replace(
    TH.HashGridConfig.sphere_field(fine_res=4096, log2_table_size=15),
    n_levels=6)
BWD_GRIDS = {
    # a proposal field's [5, 2, 2^17] grid (levels 0-2 dense) at stride 1
    "prop_stride1": (NGPDensityFieldConfig().grid, 16, (1,) * 5),
    # the sphere field's smoothstep grid, the point form
    "sphere_points": (_SPHERE, 1, (1,) * 6),
    "ngp_strided": (_NGP, 16, TH.level_strides(_NGP, 4e-3, 16)),
}


@pytest.mark.parametrize("case", list(BWD_GRIDS))
def test_hash_encode_ray_bwd_plain_matches_jax_vjp(case):
    """The plain backward from the features' cotangent against JAX's
    ``hash_encode_ray`` / ``hash_encode_coords`` VJP (the same float32
    contributions, scatter-added in another order); the coordinates start
    at and cross the box's faces."""
    grid, s, strides = BWD_GRIDS[case]
    # _inputs' shapes: JAX compiles its eager ops once a shape
    n = 37 if s == 1 else 11
    rng = np.random.default_rng(30 + len(case))
    pts = np.sort(rng.uniform(-0.05, 1.05, (n, s, 3)), axis=1)
    pts.reshape(-1, 3)[::5] = np.array([0.0, 1.0, -0.2, 1.2, 0.5])[
        rng.integers(0, 5, pts.reshape(-1, 3)[::5].shape)]
    x, y, z = (np.ascontiguousarray(pts[..., a], np.float32) for a in range(3))
    cot = rng.standard_normal((n, s, grid.out_dim)).astype(np.float32)
    table = np.zeros(grid.table_shape, np.float32)
    jx, jy, jz = map(jnp.asarray, (x, y, z))
    if s == 1:
        def j_fn(t):
            return JH.hash_encode_coords(t, jx[:, 0], jy[:, 0], jz[:, 0],
                                         _j_hash(grid))
        j_cot = cot[:, 0]
    else:
        def j_fn(t):
            return JH.hash_encode_ray(t, jx, jy, jz, _j_hash(grid), strides)
        j_cot = cot
    (g_ref,) = jax.vjp(j_fn, jnp.asarray(table))[1](jnp.asarray(j_cot))
    g_got = TH.hash_encode_ray_bwd_plain(
        grid.table_shape, *(torch.from_numpy(a) for a in (x, y, z)), grid,
        strides, torch.from_numpy(cot))
    assert np.abs(np.asarray(g_ref)).max() > 0.0
    assert _rel(g_got.numpy(), g_ref) <= 1e-5


def test_brick_encode_matches_jax_and_the_composition():
    x, y, z, strides, cot = _inputs("s48", BRICK.out_dim, 10)
    rng = np.random.default_rng(2)
    table = rng.uniform(-1e-2, 1e-2, BRICK.table_shape).astype(np.float32)
    jgrid = _j_brick(BRICK)

    # jitted, as tests/test_torch_train.py's brick encode test: one XLA
    # compile instead of one a primitive (within 1e-6 of the eager ops)
    @jax.jit
    def fwd_vjp(t, c):
        out, vjp = jax.vjp(lambda t: JB.brick_encode_ray(
            t, *map(jnp.asarray, (x, y, z)), jgrid, strides), t)
        return out, vjp(c)[0]

    ref, g_ref = fwd_vjp(jnp.asarray(table), jnp.asarray(cot))
    tt = torch.from_numpy(table.copy()).requires_grad_(True)
    coords = [torch.from_numpy(a) for a in (x, y, z)]
    got = TB.brick_encode_ray(tt, *coords, BRICK, strides)
    # the same 8 bf16 corners a point, summed in another order; the lerp
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-6, rtol=0)
    (g_got,) = torch.autograd.grad(got, tt, torch.from_numpy(cot))
    assert _rel(g_got.numpy(), g_ref) < 1e-5
    out, g_comp = _composition_grad(_CoarseBrick, torch.from_numpy(table),
                                    coords, BRICK, strides,
                                    torch.from_numpy(cot))
    assert torch.equal(got.detach(), out)
    assert torch.equal(g_got, g_comp)


@pytest.mark.parametrize("plan", list(PLANS))
def test_lerp_levels_transpose_is_autograds(plan):
    """Zeros among the cotangents included; a run of stride-1 levels is
    copied at once."""
    s, strides = PLANS[plan]
    strides = strides + (1, 1)
    grid = dataclasses.replace(HASH, n_levels=len(strides))
    x, _, _, _, cot = _inputs(plan, grid.out_dim, 20 + len(plan))
    cot[np.abs(cot) < 0.5] = 0.0
    n = x.shape[0]
    plan_rows, total = TH.level_plan(grid, strides, n, s)
    leaf = torch.zeros((total, 2), requires_grad=True)
    g = torch.from_numpy(cot)
    (ref,) = torch.autograd.grad(TH.lerp_levels(leaf, plan_rows, n, s), leaf,
                                 g)
    assert torch.equal(TH.lerp_levels_transpose(g, plan_rows, n, s, total),
                       ref)


def test_forward_kernels_refuse_strides_they_cannot_lerp():
    x = torch.rand(4, 12)
    with pytest.raises(ValueError, match="power-of-two"):
        TH.ray_kernel_plan(HASH, (3, 1, 1), x)
    levels, per_ray = TH.ray_kernel_plan(HASH, (4, 2, 1), x)
    assert per_ray == (12 // 4 + 1) + (12 // 2 + 1) + 12
    assert tuple(levels.shape) == (3, 6)
