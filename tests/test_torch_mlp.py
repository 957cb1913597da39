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
                                       head_epilogue, ngp_head_bwd_plain,
                                       ngp_head_plain)
from perf_tpu_torch.kernels.ngp_mlp import NGPMlp, ngp_head

from test_torch_kernels import bf16_ulps_apart, is_bf16_valued, mlp_case

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
