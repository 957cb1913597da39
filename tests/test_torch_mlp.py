"""Port vs ``perf_tpu``: the NGP MLPs with their epilogues (K2), forward and
backward.

The density head (bf16 32 -> 64 -> 1, ``trunc_exp``, the where-select), the
colour head (bf16 32 -> 64 -> 64 -> 3, sigmoid times the selector) and the
proposal fields' density (float32 10 -> 64 -> 1, ``trunc_exp(raw - 1)``)
on the same numpy inputs in both packages: the plain forward
(``ngp_head_plain``) against JAX's, the hand-written backward
(``ngp_head_bwd_plain``, the kernels' math) against ``jax.vjp`` and against
``torch.autograd`` of the plain forward, and the ``NGPMlp`` autograd
Function's CPU dispatch against autograd. The inputs hold a zero row (every
ReLU at 0), rows whose raw output passes 15 and 80 (the clamps), rows
outside the select and a negative raw output (``mlp_case``, shared with
the kernels' card tests in tests/test_torch_kernels.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perf_tpu.fields.mlp import (ngp_mlp_apply as j_apply,
                                 ngp_mlp_apply_channels as j_channels)
from perf_tpu.fields.ngp import trunc_exp as j_trunc_exp

from perf_tpu_torch.fields.mlp import (APP_HEAD, GEO_HEAD, PROP_HEAD,
                                       bf16_grad_sums_f64, bf16_grads_within,
                                       bf16_head_reach, bf16_round_f64,
                                       bf16_ulp_f64, head_epilogue,
                                       head_epilogue_grad, ngp_head_bwd_plain,
                                       ngp_head_bwd_terms, ngp_head_plain)
from perf_tpu_torch.kernels.ngp_mlp import NGPMlp, ngp_head

from test_torch_kernels import (bf16_ulp, bf16_ulps_apart, is_bf16_valued,
                                mlp_case)

HEADS = (GEO_HEAD, APP_HEAD, PROP_HEAD)


def j_head(ws, x, sel, head):
    """JAX's composition of the head as ``perf_tpu/fields/ngp.py`` applies
    it -> [C, M]."""
    if head is PROP_HEAD:
        raw = j_apply({"w": ws}, x)
        return jnp.where(sel[:, None], j_trunc_exp(raw - 1.0), 0.0).T
    if head is GEO_HEAD:
        (raw,) = j_channels({"w": ws}, x)
        return jnp.where(sel, j_trunc_exp(raw), 0.0)[None]
    return jnp.stack([c * sel for c in j_channels(
        {"w": ws}, x, out_activation=jax.nn.sigmoid)])


def torch_case(ws, x, sel, g=None):
    return ([torch.from_numpy(w) for w in ws], torch.from_numpy(x),
            torch.from_numpy(sel), None if g is None else torch.from_numpy(g))


def assert_bf16_within_one_ulp(got, ref):
    """``got`` bf16-valued and every element within one bf16 ulp of
    ``ref``."""
    assert is_bf16_valued(got)
    assert (bf16_ulps_apart(got, ref) <= 1.0).all()


def rel_norm(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def check_grads(head, dx, dws, ref_dx, ref_dws):
    """The bf16 heads: dx and the hidden layers' weight gradients
    bf16-valued within one bf16 ulp, the last layer's within 1e-5 relative
    norm (float32 sums over the points in another order). The float32
    proposal head: every gradient within 1e-5 relative norm."""
    if head.bf16:
        for got, ref in zip((dx, *dws[:-1]), (ref_dx, *ref_dws[:-1])):
            assert_bf16_within_one_ulp(got, ref)
    else:
        for got, ref in zip((dx, *dws[:-1]), (ref_dx, *ref_dws[:-1])):
            assert rel_norm(got, ref) <= 1e-5
    assert rel_norm(dws[-1], ref_dws[-1]) <= 1e-5


def j_raw(ws, x, head):
    """JAX's MLP output [C, M] (before the epilogue)."""
    if head is PROP_HEAD:
        return j_apply({"w": ws}, x).T
    return jnp.stack(j_channels({"w": ws}, x))


def j_epilogue(raw, sel, head):
    if head is APP_HEAD:
        return jax.nn.sigmoid(raw) * sel
    z = raw - 1.0 if head is PROP_HEAD else raw
    return jnp.where(sel, j_trunc_exp(z), 0.0)


@pytest.mark.parametrize("head", HEADS, ids=lambda h: h.name)
def test_plain_forward_matches_jax(head):
    ws, x, sel, _ = mlp_case(head, 1)
    tws, tx, tsel, _ = torch_case(ws, x, sel)
    out, raw = ngp_head_plain(tws, tx, tsel, head)
    jws, jsel = [jnp.asarray(w) for w in ws], jnp.asarray(sel)
    ref = np.asarray(j_head(jws, jnp.asarray(x), jsel, head))
    got, r = out.numpy(), raw.numpy()
    assert got.shape == (head.channels, x.shape[0]) and np.isfinite(got).all()
    assert (r[0] > 80).any() and (r[0] < -15).any() and (~sel).any()
    assert ((got == 0) == (ref == 0)).all()
    # the MLP: the same bf16 rounding points and exact bf16 products, float32
    # sums of 64 terms in another order, within 1e-6 of the sum of the
    # terms' magnitudes (read: <= 1.6e-7 over seeds 1-11, 4.4e-7 once)
    jr = np.array(j_raw(jws, jnp.asarray(x), head))
    rnd = (lambda t: t.to(torch.bfloat16).float()) if head.bf16 else (
        lambda t: t)
    h = rnd(tx)
    for w in tws[:-1]:
        h = rnd(torch.relu(h @ rnd(w)))
    scale = (h.abs() @ tws[-1].abs()).T.numpy()
    assert (np.abs(r - jr) <= 1e-6 * scale).all()
    # the epilogue on the same raw output within 1e-6 (read: <= 1.3e-7);
    # on the composition a raw output one float32 ulp apart moves exp(20)
    # by 4e-6 relative
    epi = head_epilogue(torch.from_numpy(jr), tsel, head).numpy()
    j_epi = np.asarray(j_epilogue(jnp.asarray(jr), jsel, head))
    assert (np.abs(epi - j_epi) <= 1e-6 * np.abs(j_epi)).all()


@pytest.mark.parametrize("head", HEADS, ids=lambda h: h.name)
def test_plain_backward_matches_jax_vjp_and_autograd(head):
    ws, x, sel, g = mlp_case(head, 2)
    tws, tx, tsel, tg = torch_case(ws, x, sel, g)
    _, raw = ngp_head_plain(tws, tx, tsel, head)
    dx, dws = ngp_head_bwd_plain(tws, tx, tsel, raw, tg, head)
    assert dx.shape == tx.shape
    assert [tuple(d.shape) for d in dws] == [w.shape for w in ws]

    jsel = jnp.asarray(sel)
    _, vjp = jax.vjp(lambda a, b: j_head(b, a, jsel, head), jnp.asarray(x),
                     [jnp.asarray(w) for w in ws])
    jdx, jdws = vjp(jnp.asarray(g))
    check_grads(head, dx.numpy(), [d.numpy() for d in dws], np.asarray(jdx),
                [np.asarray(d) for d in jdws])

    lx = tx.clone().requires_grad_(True)
    lws = [w.clone().requires_grad_(True) for w in tws]
    out = ngp_head_plain(lws, lx, tsel, head)[0]
    adx, *adws = torch.autograd.grad(out, [lx, *lws], tg)
    check_grads(head, dx.numpy(), [d.numpy() for d in dws], adx.numpy(),
                [d.numpy() for d in adws])


@pytest.mark.parametrize("head", HEADS, ids=lambda h: h.name)
def test_function_cpu_dispatch_matches_autograd(head):
    ws, x, sel, g = mlp_case(head, 3)
    tws, tx, tsel, tg = torch_case(ws, x, sel, g)
    ref_out, _ = ngp_head_plain(tws, tx, tsel, head)
    lx = tx.clone().requires_grad_(True)
    lws = [w.clone().requires_grad_(True) for w in tws]
    out = ngp_head(lws, lx, tsel, head)
    assert out.grad_fn is not None
    assert torch.equal(out, ref_out)
    fdx, *fdws = torch.autograd.grad(out, [lx, *lws], tg)
    ax = tx.clone().requires_grad_(True)
    aws = [w.clone().requires_grad_(True) for w in tws]
    adx, *adws = torch.autograd.grad(ngp_head_plain(aws, ax, tsel, head)[0],
                                     [ax, *aws], tg)
    check_grads(head, fdx.numpy(), [d.numpy() for d in fdws], adx.numpy(),
                [d.numpy() for d in adws])

    # without the inputs' gradient the Function forms only the weights'
    out = NGPMlp.apply(tx, tsel, head, *lws)
    wdws = torch.autograd.grad(out, lws, tg)
    for a, b in zip(wdws, fdws):
        assert torch.equal(a, b)
    # under no_grad nothing is recorded
    with torch.no_grad():
        out = ngp_head(lws, lx, tsel, head)
    assert out.grad_fn is None and torch.equal(out, ref_out)


def test_ngp_head_refuses_other_devices():
    ws, x, sel, _ = mlp_case(GEO_HEAD, 4)
    tws, tx, tsel, _ = torch_case(ws, x, sel)
    with pytest.raises(ValueError, match="unsupported device"):
        ngp_head(tws, tx.to("meta"), tsel.to("meta"), GEO_HEAD)


@pytest.mark.parametrize("head", (GEO_HEAD, APP_HEAD), ids=lambda h: h.name)
def test_float64_yardstick_sums_the_plain_backwards_terms(head):
    """``bf16_grad_sums_f64`` gives dx, dW0 (and dW1) as the float64 sums
    of the plain backward's float32 terms, as numpy sums them (to 1e-12 of
    the terms' magnitudes); every entry of the plain backward's dW0
    / dW1 lies within one bf16 ulp of its float64 sum, or no farther from
    it than ``jax.vjp``'s result is (both round one float32 sum of the same
    terms)."""
    ws, x, sel, g = mlp_case(head, 6)
    tws, tx, tsel, tg = torch_case(ws, x, sel, g)
    _, raw = ngp_head_plain(tws, tx, tsel, head)
    acts, d_pres, _, _ = ngp_head_bwd_terms(tws, tx, tsel, raw, tg, head)
    a64 = [a.numpy().astype(np.float64) for a in acts]
    d64 = [d.numpy().astype(np.float64) for d in d_pres]
    w0 = tws[0].to(torch.bfloat16).double().numpy()
    want = [d64[0] @ w0.T] + [a.T @ d for a, d in zip(a64, d64)]
    want_mag = ([np.abs(d64[0]) @ np.abs(w0).T]
                + [np.abs(a).T @ np.abs(d) for a, d in zip(a64, d64)])
    sums = bf16_grad_sums_f64(tws, tx, tsel, raw, tg, head)
    assert len(sums) == head.hidden + 1
    for got, ref, mag in zip(sums, want, want_mag):
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12 * mag.max())

    _, dws = ngp_head_bwd_plain(tws, tx, tsel, raw, tg, head)
    jsel = jnp.asarray(sel)
    _, vjp = jax.vjp(lambda b: j_head(b, jnp.asarray(x), jsel, head),
                     [jnp.asarray(w) for w in ws])
    (jdws,) = vjp(jnp.asarray(g))
    for p, j, e in zip(dws[:-1], jdws[:-1], sums[1:]):
        p = p.numpy().astype(np.float64)
        j = np.asarray(j, np.float64)
        e = e.numpy()
        within = np.abs(p - e) <= bf16_ulp(np.maximum(np.abs(p), np.abs(e)))
        assert (within | (np.abs(p - e) <= np.abs(j - e))).all()


def test_float64_bf16_rounding_and_ulp():
    """``bf16_round_f64`` rounds float64 values to bf16 as torch rounds
    their float32 values (to nearest, ties to even), and ``bf16_ulp_f64``
    is the step to the next bf16 value (2^-133 at 0)."""
    rng = np.random.default_rng(3)
    v = (rng.standard_normal(20000)
         * 10.0 ** rng.integers(-30, 30, 20000)).astype(np.float32)
    v[:4] = [0.0, 1.0, -1.00390625, 1.001953125]        # 1 + 2^-9: a tie
    t = torch.from_numpy(v).double()
    r = bf16_round_f64(t)
    assert torch.equal(r, torch.from_numpy(v).to(torch.bfloat16).double())
    assert r[3].item() == 1.0
    ulp = bf16_ulp_f64(r)
    nxt = (r.abs() + ulp).float()
    assert torch.equal(nxt.to(torch.bfloat16).float(), nxt)
    assert (bf16_round_f64(r.abs() + 0.49 * ulp) == r.abs()).all()
    assert bf16_ulp_f64(torch.zeros(1, dtype=torch.float64)).item() == 2.0 ** -133


def another_sum_order(ws, x, sel, raw, g, head) -> list:
    """The plain backward with every product's sum taken in float64 and
    rounded to float32 once: another order of the same float32 sums, as
    the kernels' tensor cores take one. [dx, dW0, (dW1), dWL]."""
    def mm(a, b):
        return (a.double() @ b.double()).float()
    bf = lambda t: t.to(torch.bfloat16).float()
    h = bf(x)
    acts, pres = [h], []
    for w in ws[:-1]:
        pres.append(mm(h, bf(w)))
        h = bf(torch.relu(pres[-1]))
        acts.append(h)
    d = head_epilogue_grad(raw, sel, g, head).T
    d_h = d[:, :1] * ws[-1][:, 0]
    for c in range(1, ws[-1].shape[1]):
        d_h = d_h + d[:, c:c + 1] * ws[-1][:, c]
    d_pres = [None] * len(pres)
    for i in reversed(range(len(pres))):
        d_pres[i] = torch.where(pres[i] > 0, bf(d_h), torch.zeros_like(d_h))
        d_h = mm(d_pres[i], bf(ws[i]).T)
    return ([bf(d_h)] + [bf(mm(a.T, dp)) for a, dp in zip(acts, d_pres)]
            + [mm(acts[-1].T, d)])


def heaviest_tile(ws, x, sel, raw, g, head) -> int:
    """The 64-point tile whose terms of the last layer's gradient weigh
    most (the sum over its points of |last hidden outputs| |d raw|)."""
    acts, _, d, _ = ngp_head_bwd_terms(ws, x, sel, raw, g, head,
                                       need_dx=False)
    w = acts[-1].abs().sum(dim=1) * d.abs().sum(dim=1)
    w = torch.nn.functional.pad(w, (0, -w.shape[0] % 64))
    return int(w.view(-1, 64).sum(dim=1).argmax())


@pytest.mark.parametrize("m", (301, 6000))
@pytest.mark.parametrize("head", (GEO_HEAD, APP_HEAD), ids=lambda h: h.name)
def test_reach_holds_another_sum_order_and_not_a_wrong_one(head, m):
    """``bf16_grads_within`` with ``bf16_head_reach`` passes the plain
    backward's float32 sums taken in another order (float64, rounded once)
    on the full cotangent and, with no reach left, on the points no tie
    reaches; it fails dx with five nonzero rows zeroed and, on those points,
    a last layer with the heaviest 64-point tile of the cotangent
    dropped."""
    ws, x, sel, g = mlp_case(head, 11, m)
    tws, tx, tsel, tg = torch_case(ws, x, sel, g)
    _, raw = ngp_head_plain(tws, tx, tsel, head)

    def judge(g_, got):
        dx, dws = ngp_head_bwd_plain(tws, tx, tsel, raw, g_, head)
        reach = bf16_head_reach(tws, tx, tsel, raw, g_, head)
        sums = bf16_grad_sums_f64(tws, tx, tsel, raw, g_, head)
        want = [dx, *dws]
        return want, reach, sums, bf16_grads_within(got, want, sums, reach)

    want, reach, sums, full = judge(
        tg, another_sum_order(tws, tx, tsel, raw, tg, head))
    assert all(full["ok"].values()), full
    bad = another_sum_order(tws, tx, tsel, raw, tg, head)
    rows = torch.nonzero(want[0].abs().sum(dim=1) > 0).flatten()[-5:]
    bad[0][rows] = 0.0
    assert not bf16_grads_within(bad, want, sums, reach)["ok"]["dx"]

    tie_free = reach["tie_free"]
    assert 0 < tie_free.float().mean().item() < 1
    g2 = tg * tie_free
    want2, reach2, sums2, free = judge(
        g2, another_sum_order(tws, tx, tsel, raw, g2, head))
    assert all(free["ok"].values()), free
    assert all(bool((t == 0).all()) for t in reach2["terms"])
    tile = heaviest_tile(tws, tx, tsel, raw, g2, head)
    g3 = g2.clone()
    g3[:, 64 * tile:64 * tile + 64] = 0.0
    dropped = another_sum_order(tws, tx, tsel, raw, g3, head)
    assert not bf16_grads_within(dropped, want2, sums2, reach2)["ok"]["last"]


@pytest.mark.parametrize("head", (GEO_HEAD, APP_HEAD), ids=lambda h: h.name)
def test_reach_bounds_the_moves_of_the_hidden_values(head):
    """Every move ``bf16_head_reach`` carries is no smaller than the
    difference between the plain backward's and the other sum order's
    hidden values and cotangents, and a point it calls tie-free holds the
    same hidden values and cotangents in both."""
    ws, x, sel, g = mlp_case(head, 12, 3000)
    tws, tx, tsel, tg = torch_case(ws, x, sel, g)
    _, raw = ngp_head_plain(tws, tx, tsel, head)
    acts, d_pres, _, _ = ngp_head_bwd_terms(tws, tx, tsel, raw, tg, head)
    bf = lambda t: t.to(torch.bfloat16).float()
    h = bf(tx)
    other = [h]
    for w in tws[:-1]:
        h = bf(torch.relu((h.double() @ bf(w).double()).float()))
        other.append(h)
    reach = bf16_head_reach(tws, tx, tsel, raw, tg, head)
    free = reach["tie_free"]
    for a, b in zip(acts[1:], other[1:]):
        assert torch.equal(a[free], b[free])
    assert reach["dx"].shape == tx.shape
    assert (reach["dx"] >= 0).all() and (reach["last"] >= 0).all()
    assert len(reach["terms"]) == len(d_pres)
