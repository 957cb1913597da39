"""The training composite and distortion loss (K4, ``shade_composite``)
against JAX.

``shade_composite_plain`` (what CPU tensors take, and what the kernels are
held to on the card) is held against JAX's compositing lines
(``perf_tpu/render/renderer.py:384-390``) and
``perf_tpu.kernels.distortion.distortion_per_ray``, outputs and dsigma by
``jax.grad``, at the bars of
``tests/test_torch_train.py::test_shade_rays_train_and_dsigma_match_jax``
(1e-5). Then a float32 emulation of the kernels' sum order (kept here, not
in the package) is held to the same bars for every lane count the kernels
take: a lane's run summed in registers, the lanes' run totals scanned
Hillis-Steele style across the group, the suffix sums of the backward by
the mirror scan, per-ray sums by a butterfly. A control that must fail: the
transmittance from the scan shifted by one sample (the inclusive sum in
place of C - tau).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perf_tpu.kernels.distortion import distortion_per_ray
from perf_tpu.render.renderer import _exclusive_cumsum
from perf_tpu_torch.render.renderer import (composite_lanes,
                                            shade_composite,
                                            shade_composite_plain)

SAMPLES = (1, 7, 32, 33, 80, 256)
DELTA = 1e-3        # march_step 5e-4 at the geometry phase's stride 2
# delta 1 puts dsigma = dL/dtau at its own scale (up to ~4 here), where the
# bar's 1e-5 is tight; at 1e-3 it is scaled down with delta
DELTAS = (DELTA, 1.0)
TOL = 1e-5
F = np.float32


def composite_case(n: int, s: int, seed: int, delta: float = DELTA) -> tuple:
    """sigma, t_mid, valid [n, s] float32 and the three cotangents: rays
    with a run of valid samples at a random place and densities from clear
    to opaque; rows 0-1 entirely invalid, rows 2-3 saturated from their
    first valid sample on (tau up to 1e3, where T underflows to 0)."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, s, n)
    length = rng.integers(1, s + 1, n)
    idx = np.arange(s)[None, :]
    valid = ((idx >= start[:, None]) & (idx < (start + length)[:, None])
             & (rng.uniform(size=(n, s)) < 0.9)).astype(F)
    valid[:2] = 0.0
    valid[2:4, 0] = 1.0
    # per-ray scale of tau: from nearly clear to opaque within a few samples
    scale = 10.0 ** rng.uniform(-3.0, 0.5, (n, 1))
    tau = rng.exponential(1.0, (n, s)) * scale
    tau[2:4] = rng.uniform(100.0, 1e3, (2, s))
    sigma = (tau / delta * valid).astype(F)
    t_mid = np.sort(rng.uniform(0.05, 1.5, (n, s)), 1).astype(F)
    cots = (rng.normal(size=(n, 1)).astype(F), rng.normal(size=(n, 1)).astype(F),
            rng.normal(size=(n,)).astype(F))
    return sigma, t_mid, valid, cots


def jax_composite(sigma, t_mid, valid, delta):
    """JAX's lines: (weights, opacity, distance, dist_loss)."""
    tau = sigma * delta
    trans = jnp.exp(-_exclusive_cumsum(tau))
    weights = trans * (1.0 - jnp.exp(-tau))
    return (weights, jnp.sum(weights, axis=-1, keepdims=True),
            jnp.sum(weights * t_mid, axis=-1, keepdims=True),
            distortion_per_ray(weights, t_mid, delta, valid))


def jax_reference(sigma, t_mid, valid, cots, delta):
    """JAX's outputs and dsigma of sum(outputs * cotangents) by jax.grad."""
    def lin(s):
        _, op, dist, dl = jax_composite(s, t_mid, valid, delta)
        return (jnp.sum(op * cots[0]) + jnp.sum(dist * cots[1])
                + jnp.sum(dl * cots[2]))
    outs = jax.jit(jax_composite, static_argnums=3)(sigma, t_mid, valid,
                                                    delta)
    ds = jax.jit(jax.grad(lin))(jnp.asarray(sigma))
    return [np.asarray(o) for o in outs], np.asarray(ds)


# -- the kernels' sum order, in float32 ----------------------------------------

def _lanes_below(x: np.ndarray) -> tuple:
    """Per group [..., G]: the sum over the lanes below each (0 at lane 0),
    Hillis-Steele (at d = 1, 2, 4, ... lane l adds lane l - d), and the
    group's total."""
    x = x.copy()
    d = 1
    while d < x.shape[-1]:
        x[..., d:] = x[..., :-d] + x[..., d:]
        d *= 2
    below = np.zeros_like(x)
    below[..., 1:] = x[..., :-1]
    return below, x[..., -1]


def _lanes_above(x: np.ndarray) -> tuple:
    """The mirror: the sum over the lanes above each (0 at the last lane),
    and the group's total."""
    x = x.copy()
    d = 1
    while d < x.shape[-1]:
        x[..., :-d] = x[..., :-d] + x[..., d:]
        d *= 2
    above = np.zeros_like(x)
    above[..., :-1] = x[..., 1:]
    return above, x[..., 0]


def _group_sum(x: np.ndarray) -> np.ndarray:
    """Butterfly over the lanes [..., G] at d = G/2, ..., 1 (lane 0's)."""
    lanes = np.arange(x.shape[-1])
    d = x.shape[-1] // 2
    while d:
        x = x + x[..., lanes ^ d]
        d //= 2
    return x[..., 0]


def _chunk_forward(tau, t, v, carries, shift=False):
    """One chunk [n, G, R] of every ray: (Te, w, u, wx) and the carries
    (C, W, M) advanced, as the kernels' ``chunk_forward``. ``shift``: the
    control, T = exp(-C) from the inclusive sum."""
    c_c, c_w, c_m = carries
    r = tau.shape[-1]
    run = np.empty_like(tau)
    acc = np.zeros(tau.shape[:-1], F)
    for j in range(r):
        acc = acc + tau[..., j]
        run[..., j] = acc
    below, tot = _lanes_below(acc)
    base = c_c[:, None] + below
    c_c = c_c + tot
    trans = np.exp(-((base[..., None] + run) - (0 if shift else tau)))
    e = np.exp(-tau)
    te, w = trans * e, trans * (F(1) - e)
    u = w * v
    um = u * t
    run_u, run_m = np.empty_like(u), np.empty_like(u)
    au, am = np.zeros_like(acc), np.zeros_like(acc)
    for j in range(r):
        au = au + u[..., j]
        run_u[..., j] = au
        am = am + um[..., j]
        run_m[..., j] = am
    below_w, tot_w = _lanes_below(au)
    below_m, tot_m = _lanes_below(am)
    bw = (c_w[:, None] + below_w)[..., None]
    bm = (c_m[:, None] + below_m)[..., None]
    wx = t * ((bw + run_u) - u) - ((bm + run_m) - um)
    return (te, w, u, wx), (c_c, c_w + tot_w, c_m + tot_m)


def emulate_kernels(sigma, t_mid, valid, delta, cots, lanes, shift=False):
    """The forward's (weights, opacity, distance, dist_loss) and the
    backward's dsigma in the kernels' order with G lanes a ray and runs of
    R samples (``lanes``), float32 throughout. ``shift``: the control, T
    from the inclusive sum."""
    g, r = lanes
    n, s = sigma.shape
    ch = g * r
    k = -(-s // ch)

    def runs(x):
        x = np.pad(np.asarray(x, F), ((0, 0), (0, k * ch - s)))
        return x.reshape(n, k, g, r)
    tau = runs(sigma) * F(delta)
    t, v = runs(t_mid), runs(valid)
    zeros = np.zeros(n, F)
    carries, at_start = (zeros, zeros, zeros), []
    lane_sums = [np.zeros((n, g), F) for _ in range(4)]
    weights = np.empty_like(tau)
    for c in range(k):
        at_start.append(carries)
        (te, w, u, wx), carries = _chunk_forward(tau[:, c], t[:, c], v[:, c],
                                                 carries, shift)
        weights[:, c] = w
        for j in range(r):
            op, dist, bi, uni = lane_sums
            lane_sums = [op + w[..., j], dist + w[..., j] * t[:, c, :, j],
                         bi + u[..., j] * wx[..., j],
                         uni + F(delta) * u[..., j] * u[..., j]]
    op, dist, bi, uni = (_group_sum(x) for x in lane_sums)
    outs = (weights.reshape(n, -1)[:, :s], op[:, None], dist[:, None],
            F(2) * bi + F(1 / 3) * uni)

    go, gd, gl = (np.asarray(c, F).reshape(n, 1) for c in cots)
    ds = np.empty_like(tau)
    c_a = c_b = c_g = zeros
    for c in reversed(range(k)):
        (te, w, u, wx), _ = _chunk_forward(tau[:, c], t[:, c], v[:, c],
                                           at_start[c], shift)
        tc, vc = t[:, c], v[:, c]
        sa, sb, sg = (np.empty_like(u) for _ in range(3))
        aa, ab = np.zeros((n, g), F), np.zeros((n, g), F)
        for j in reversed(range(r)):
            sa[..., j], sb[..., j] = aa, ab
            aa = aa + u[..., j] * tc[..., j]
            ab = ab + u[..., j]
        above_a, tot_a = _lanes_above(aa)
        above_b, tot_b = _lanes_above(ab)
        ba = (c_a[:, None] + above_a)[..., None]
        bb = (c_b[:, None] + above_b)[..., None]
        c_a, c_b = c_a + tot_a, c_b + tot_b
        ddl = (F(2) * wx + F(2) * ((ba + sa) - tc * (bb + sb))
               + F(2 / 3) * F(delta) * u)
        gw = go[..., None] + gd[..., None] * tc + gl[..., None] * vc * ddl
        ag = np.zeros((n, g), F)
        for j in reversed(range(r)):
            sg[..., j] = ag
            ag = ag + gw[..., j] * w[..., j]
        above_g, tot_g = _lanes_above(ag)
        bg = (c_g[:, None] + above_g)[..., None]
        c_g = c_g + tot_g
        ds[:, c] = (gw * te - (bg + sg)) * F(delta)
    return outs, ds.reshape(n, -1)[:, :s]


def _within(got, want, rtol=0.0) -> bool:
    return bool(np.all(np.abs(got - want) <= TOL + rtol * np.abs(want)))


def _check(outs, ds, ref_outs, ref_ds):
    for name, a, b in zip(("weights", "opacity", "distance", "dist_loss"),
                          outs, ref_outs):
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, atol=TOL, err_msg=name)
    assert np.isfinite(ds).all()
    np.testing.assert_allclose(ds, ref_ds, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("delta", DELTAS)
@pytest.mark.parametrize("s", SAMPLES)
def test_plain_composite_matches_jax(s, delta):
    n = 41
    sigma, t_mid, valid, cots = composite_case(n, s, s, delta)
    ref_outs, ref_ds = jax_reference(sigma, t_mid, valid, cots, delta)
    st = torch.from_numpy(sigma).requires_grad_(True)
    w, op, dist, dl = shade_composite_plain(st, torch.from_numpy(t_mid),
                                            torch.from_numpy(valid), delta)
    ((op * torch.from_numpy(cots[0])).sum() + (dist * torch.from_numpy(
        cots[1])).sum() + (dl * torch.from_numpy(cots[2])).sum()).backward()
    _check([x.detach().numpy() for x in (w, op, dist, dl)], st.grad.numpy(),
           ref_outs, ref_ds)
    # the CPU route of the wrapper is the plain version
    got = shade_composite(torch.from_numpy(sigma), torch.from_numpy(t_mid),
                          torch.from_numpy(valid), delta)
    assert all(torch.equal(a, b.detach()) for a, b in zip(got, (w, op, dist,
                                                                dl)))
    # entirely invalid rows give no weight; saturated rows put theirs on
    # their first valid sample
    assert not ref_outs[0][:2].any() and not ref_outs[3][:2].any()
    np.testing.assert_allclose(ref_outs[1][2:4], 1.0, atol=TOL)


@pytest.mark.parametrize("delta", DELTAS)
@pytest.mark.parametrize("s", SAMPLES)
def test_kernel_sum_order_matches_jax(s, delta):
    """The emulated kernels for every lane count they take, with R =
    ceil(s / G) and ``composite_lanes``'s plan, against JAX."""
    n = 41
    sigma, t_mid, valid, cots = composite_case(n, s, 100 + s, delta)
    ref_outs, ref_ds = jax_reference(sigma, t_mid, valid, cots, delta)
    plans = {(g, min(8, -(-s // g))) for g in (8, 16, 32)}
    plans.add(composite_lanes(s))
    for lanes in sorted(plans):
        outs, ds = emulate_kernels(sigma, t_mid, valid, delta, cots, lanes)
        _check(outs, ds, ref_outs, ref_ds)


def test_kernel_sum_order_in_chunks():
    """Rows longer than a group's G R samples at ``composite_lanes``'s plan
    (32 lanes of 8: 3 and 4 chunks): the carries from chunk to chunk,
    forward and backward."""
    for s in (600, 1001):
        sigma, t_mid, valid, cots = composite_case(19, s, 7)
        ref_outs, ref_ds = jax_reference(sigma, t_mid, valid, cots, DELTA)
        assert composite_lanes(s) == (32, 8)
        outs, ds = emulate_kernels(sigma, t_mid, valid, DELTA, cots,
                                   composite_lanes(s))
        _check(outs, ds, ref_outs, ref_ds)


def test_shifted_scan_control_fails():
    """The control: T from the scan shifted by one sample (the inclusive
    sum C in place of C - tau) misses the bar by far."""
    sigma, t_mid, valid, cots = composite_case(41, 80, 3)
    ref_outs, _ = jax_reference(sigma, t_mid, valid, cots, DELTA)
    outs, _ = emulate_kernels(sigma, t_mid, valid, DELTA, cots,
                              composite_lanes(80), shift=True)
    err = max(np.abs(a - b).max() for a, b in zip(outs, ref_outs))
    assert err > 100 * TOL


def test_composite_lanes_plan():
    """Every plan covers its row with runs of 1-8 samples in groups of 8,
    16 or 32 lanes (in chunks past 256 samples); a row of a multiple of 4
    samples takes runs of 4 or 8 (16-byte loads)."""
    for s in list(range(1, 300)) + [512, 1 << 12]:
        g, r = composite_lanes(s)
        assert g in (8, 16, 32) and 1 <= r <= 8
        assert g * r >= s or (g, r) == (32, 8)
        assert -(-s // g) <= r < -(-s // g) + 4 or r == 8
        assert r % 4 == 0 if s % 4 == 0 else r == min(8, -(-s // g))
    assert composite_lanes(80) == (16, 8)
    assert composite_lanes(48) == (8, 8)
    assert composite_lanes(128) == (16, 8)
    assert composite_lanes(256) == (32, 8)
    assert composite_lanes(33) == (8, 5)
