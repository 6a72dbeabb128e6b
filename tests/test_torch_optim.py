"""The port's optimizers and schedules against the JAX package's.

The same numpy parameters and per-step gradients go through
``repro.optim`` and ``repro_torch.optim`` for 5 updates: AdamW (with and
without clipping and weight decay), SGD-momentum (with and without
clipping), Adafactor (factored matrices and unfactored vectors, with and
without weight decay), each at a constant and a scheduled lr.  float32
parameters, updates and moments agree at atol 1e-6 / rtol 1e-5 (the same
arithmetic; the port's in-place moment updates and dot-product norms
round in another order, a few ulps); bfloat16 parameters at one bf16 ulp
(atol 1e-2 on values of order 1), with float32 moments.  A leaf that is
not floating point keeps its value and moments (the reference raises).
``cosine_warmup`` and ``constant`` match at rtol 1e-6 for Python and
tensor steps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adafactor as j_adafactor
from repro.optim import adamw as j_adamw
from repro.optim import sgd_momentum as j_sgd
from repro.optim.optimizer import apply_updates as j_apply
from repro.optim.optimizer import clip_by_global_norm as j_clip
from repro.optim.optimizer import global_norm as j_norm
from repro.optim.schedules import constant as j_constant
from repro.optim.schedules import cosine_warmup as j_cosine
from repro_torch import tree as tree_lib
from repro_torch.optim import adafactor, adamw, cosine_warmup, sgd_momentum
from repro_torch.optim.optimizer import (
    apply_updates, clip_by_global_norm, global_norm)
from repro_torch.optim.schedules import constant

STEPS = 5
SHAPES = {"w": (8, 16), "b": (16,), "blocks": [{"k": (3, 4, 5)},
                                               {"k": (3, 4, 5)}]}


def _tree(rng, scale=1.0):
    return jax.tree.map(
        lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
        SHAPES, is_leaf=lambda x: isinstance(x, tuple))


def _to_torch(tree, dtype=torch.float32):
    return tree_lib.map(lambda x: torch.from_numpy(np.array(x)).to(dtype),
                        tree)


def _run_both(make_j, make_t, lr_j, lr_t, dtype=np.float32):
    rng = np.random.default_rng(0)
    params_np = _tree(rng)
    grads_np = [_tree(rng, scale=0.5 + i) for i in range(STEPS)]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    pj = jax.tree.map(lambda x: jnp.asarray(x, jdt), params_np)
    pt = _to_torch(params_np, tdt)
    oj, ot = make_j(), make_t()
    sj, st = oj.init(pj), ot.init(pt)
    for i in range(STEPS):
        gj = jax.tree.map(lambda x: jnp.asarray(x, jdt), grads_np[i])
        gt = _to_torch(grads_np[i], tdt)
        uj, sj, nj = oj.update(gj, sj, pj, lr_j(sj.step))
        ut, st, nt = ot.update(gt, st, pt, lr_t(st.step))
        np.testing.assert_allclose(float(nt), float(nj), rtol=1e-5)
        for a, b in zip(tree_lib.leaves(ut), jax.tree.leaves(uj)):
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32),
                                       atol=1e-6 if dtype != "bfloat16"
                                       else 1e-2, rtol=1e-5)
        pj = j_apply(pj, uj)
        pt = apply_updates(pt, ut)
    return pj, pt, sj, st


def _check_params(pj, pt, atol):
    for a, b in zip(tree_lib.leaves(pt), jax.tree.leaves(pj)):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), atol=atol,
                                   rtol=1e-5)


def _lrs(kind):
    if kind == "constant":
        return (lambda s: 1e-2), (lambda s: 1e-2)
    return j_cosine(1e-2, 2, STEPS), cosine_warmup(1e-2, 2, STEPS)


@pytest.mark.parametrize("lr", ["constant", "cosine"])
@pytest.mark.parametrize("grad_clip,weight_decay",
                         [(None, 0.0), (1.0, 0.0), (1.0, 0.1), (None, 0.1)],
                         ids=["plain", "clip", "clip+wd", "wd"])
def test_adamw_matches_jax(grad_clip, weight_decay, lr):
    lr_j, lr_t = _lrs(lr)
    kw = dict(grad_clip=grad_clip, weight_decay=weight_decay)
    pj, pt, sj, st = _run_both(lambda: j_adamw(**kw), lambda: adamw(**kw),
                               lr_j, lr_t)
    _check_params(pj, pt, 1e-6)
    assert int(st.step) == int(sj.step) == STEPS
    for a, b in zip(tree_lib.leaves((st.m, st.v)),
                    jax.tree.leaves((sj.m, sj.v))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-5)


@pytest.mark.parametrize("grad_clip", [None, 1.0])
def test_sgd_momentum_matches_jax(grad_clip):
    lr_j, lr_t = _lrs("cosine")
    pj, pt, sj, st = _run_both(lambda: j_sgd(grad_clip=grad_clip),
                               lambda: sgd_momentum(grad_clip=grad_clip),
                               lr_j, lr_t)
    _check_params(pj, pt, 1e-6)
    for a, b in zip(tree_lib.leaves(st.mom), jax.tree.leaves(sj.mom)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-5)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("lr", ["constant", "cosine"])
def test_adafactor_matches_jax(lr, weight_decay):
    lr_j, lr_t = _lrs(lr)
    pj, pt, sj, st = _run_both(
        lambda: j_adafactor(weight_decay=weight_decay),
        lambda: adafactor(weight_decay=weight_decay), lr_j, lr_t)
    _check_params(pj, pt, 1e-6)
    # factored: a row and a column factor for w (8, 16) and k (3, 4, 5);
    # the vector b keeps a full second moment and an empty column factor
    vr, vc = st.vr, st.vc
    assert tuple(vr["w"].shape) == (8,) and tuple(vc["w"].shape) == (16,)
    assert tuple(vr["blocks"][0]["k"].shape) == (3, 4)
    assert tuple(vc["blocks"][0]["k"].shape) == (3, 5)
    assert tuple(vr["b"].shape) == (16,) and tuple(vc["b"].shape) == (0,)
    for a, b in zip(tree_lib.leaves((vr, vc)),
                    jax.tree.leaves((sj.vr, sj.vc))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-5)


@pytest.mark.parametrize("make", ["adamw", "sgd", "adafactor"])
def test_bf16_params_keep_f32_moments(make):
    pair = {"adamw": (j_adamw, adamw), "sgd": (j_sgd, sgd_momentum),
            "adafactor": (j_adafactor, adafactor)}[make]
    lr_j, lr_t = _lrs("constant")
    pj, pt, sj, st = _run_both(pair[0], pair[1], lr_j, lr_t,
                               dtype="bfloat16")
    _check_params(pj, pt, 1e-2)
    assert all(p.dtype == torch.bfloat16 for p in tree_lib.leaves(pt))
    moments = tree_lib.leaves(st[1:])
    assert moments and all(m.dtype == torch.float32 for m in moments)


@pytest.mark.parametrize("make", [adamw, sgd_momentum, adafactor])
def test_integer_leaves_are_left_alone(make):
    rng = np.random.default_rng(1)
    params = {"w": torch.from_numpy(rng.standard_normal((4, 4)).astype(
        np.float32)), "offsets": torch.arange(3, dtype=torch.int32) * 7}
    opt = make()
    state = opt.init(params)
    for _ in range(3):
        grads = {"w": torch.from_numpy(rng.standard_normal((4, 4)).astype(
            np.float32)), "offsets": torch.zeros(3)}
        w0 = params["w"].clone()
        upd, state, _ = opt.update(grads, state, params, 1e-2)
        assert upd["offsets"].dtype == torch.int32
        assert torch.count_nonzero(upd["offsets"]) == 0
        params = apply_updates(params, upd)
        assert not torch.equal(params["w"], w0)
    assert torch.equal(params["offsets"], torch.arange(3,
                                                       dtype=torch.int32) * 7)
    for moment in tree_lib.leaves(state[1:]):
        if moment.dim() == 1 and moment.numel() == 3:
            assert torch.count_nonzero(moment) == 0


def test_global_norm_and_clipping_match_jax():
    tree = _tree(np.random.default_rng(2), scale=3.0)
    want_n = float(j_norm(jax.tree.map(jnp.asarray, tree)))
    got_n = float(global_norm(_to_torch(tree)))
    np.testing.assert_allclose(got_n, want_n, rtol=1e-6)
    cj, nj = j_clip(jax.tree.map(jnp.asarray, tree), 1.0)
    ct, nt = clip_by_global_norm(_to_torch(tree), 1.0)
    np.testing.assert_allclose(float(nt), float(nj), rtol=1e-6)
    np.testing.assert_allclose(float(global_norm(ct)), 1.0, rtol=1e-5)
    for a, b in zip(tree_lib.leaves(ct), jax.tree.leaves(cj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("warmup,total,min_ratio",
                         [(2, 10, 0.1), (0, 5, 0.0), (10, 30, 0.2)])
def test_cosine_warmup_matches_jax(warmup, total, min_ratio):
    fj = j_cosine(3e-4, warmup, total, min_ratio)
    ft = cosine_warmup(3e-4, warmup, total, min_ratio)
    for s in range(total + 3):
        want = float(fj(s))
        np.testing.assert_allclose(float(ft(s)), want, rtol=1e-6)
        np.testing.assert_allclose(
            float(ft(torch.tensor(s, dtype=torch.int32))),
            float(fj(jnp.asarray(s, jnp.int32))), rtol=1e-6)


def test_constant_matches_jax():
    for s in (0, 7, torch.tensor(3, dtype=torch.int32)):
        got = constant(1e-3)(s)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(j_constant(1e-3)(0)),
                                   rtol=0)
