"""The plain versions the card's kernels are held to, against JAX, on the
inputs the kernels' Hopper designs are shaped for.

The ``brick_encode`` backward groups the points of a warp that add to the
same corner, and the ``bilinear`` forward has a code path per channel count
and padding mode; on the card each is held against its plain version
(``tests/test_torch_kernels.py``, marker ``cuda``). Here those plain
versions are held against ``perf_tpu`` on the same hard inputs: long runs
of one key, ray and level boundaries, zero cotangents, two bricks the hash
puts in one row, an all-stride-1 plan; every channel count the main path
passes and one other, in every padding mode. Inputs come from
``test_torch_kernels``'s seeded case functions (two plan shapes, so JAX
compiles each op once per shape); JAX runs eagerly on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import perf_tpu.core as JC
from perf_tpu.kernels.brickgrid import BrickGridConfig as JGrid
from perf_tpu.kernels.brickgrid import brick_encode_ray as j_encode_ray

from perf_tpu_torch.core.resample import bilinear_sample, bilinear_sample_plain
from perf_tpu_torch.kernels import cuda
from perf_tpu_torch.kernels.brickgrid import brick_encode_ray

from test_torch_kernels import (BWD_CASES, TINY, bilinear_case,
                                brick_bwd_case)

JTINY = JGrid(n_levels=TINY.grid.n_levels, log2_bricks=TINY.grid.log2_bricks,
              base_res=TINY.grid.base_res,
              per_level_scale=TINY.grid.per_level_scale)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("case", BWD_CASES)
def test_brick_encode_backward_matches_jax_on_hard_plans(case):
    x, y, z, strides, _, gs = brick_bwd_case(case)
    rng = np.random.default_rng(3)
    table = rng.uniform(-1e-2, 1e-2, TINY.grid.table_shape).astype(np.float32)
    # eagerly, op by op: XLA's fusion of the jitted lerp transposes rounds
    # some cotangents an ulp otherwise, and the bf16 rounding of w * g
    # then moves them by 2^-8
    _, vjp = jax.vjp(lambda t: j_encode_ray(t, jnp.asarray(x), jnp.asarray(y),
                                            jnp.asarray(z), JTINY, strides),
                     jnp.asarray(table))
    (ref,) = vjp(jnp.asarray(gs))
    cuda.reset_counts()
    t = torch.from_numpy(table).requires_grad_(True)
    out = brick_encode_ray(t, *(torch.from_numpy(a) for a in (x, y, z)),
                           TINY.grid, strides)
    (got,) = torch.autograd.grad(out, t, torch.from_numpy(gs))
    assert cuda.counts()["brick_encode_bwd"] == 0     # the plain version
    ref = np.asarray(ref)
    assert np.linalg.norm(ref) > 0
    # JAX's rule on both sides: each w * g rounded to bf16, float32 sums;
    # the lerp's transposes and the scatter add in other orders
    assert _rel(got.numpy(), ref) <= 1e-6
    # a cell gets a gradient where JAX's does
    np.testing.assert_array_equal(got.numpy() != 0, ref != 0)


@pytest.mark.parametrize("padding", ["border", "wrap_x", "zeros"])
@pytest.mark.parametrize("c", [1, 2, 3, 7, 5])
def test_bilinear_plain_matches_jax_per_channel_count(c, padding):
    img, coords, _ = bilinear_case(c, padding, 11)
    ref = jax.vmap(lambda i, q: JC.bilinear_sample(i, q, padding))(
        jnp.asarray(img), jnp.asarray(coords))
    got = bilinear_sample_plain(torch.from_numpy(img),
                                torch.from_numpy(coords), padding)
    # JAX run op by op rounds every product and sum in the same order as
    # the plain version: bitwise
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # and the entry point takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        bilinear_sample(torch.from_numpy(img), torch.from_numpy(coords),
                        padding).numpy(), got.numpy())
