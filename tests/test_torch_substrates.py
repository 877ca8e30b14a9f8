"""The port's substrates against ``repro``: the model-shape configs
(``configs/base.py``), the optimizer and its schedule (``optim/``).

The first four optimizer tests mirror those of
``tests/test_substrates.py`` on the port (its checkpoint half is
mirrored by ``tests/test_torch_checkpoint.py``); the rest hold the port
against the JAX package on the same numpy inputs.

Tolerances, each measured on this package pair before it was set:
- ``ModelConfig``'s derived values and ``dataclasses.asdict``: equal.
- The 200-step quadratic, gradients from ``torch.autograd`` against
  ``jax.grad``: bit-identical for the first 151 steps; then the master
  differs by one ulp, a gap that grows relative to the weights as they
  near 0; the largest relative gap over the trajectory is 8.4e-6, held
  at rtol 2e-5.
- ``adamw_update`` on a bf16 tree: each leaf's global sum of squares is
  summed in another order (the grad norm one ulp apart, 1e-7), so m, v
  and master are held to ``max|port - jax| <= 1e-5 * max|jax|`` per
  leaf (measured: m 1.6e-7, v 3.2e-7, master 1.4e-7 over five
  updates), the bf16 params to one bf16 ulp of the JAX value (equal in
  every measured case), the step
  exactly, the grad norm at rtol 1e-6 (measured 1.6e-7) and the lr
  exactly.
- ``warmup_cosine``: rtol 1e-6 (``cos`` of two libraries; equal at every
  edge measured).
- The specs of ``opt_pspecs`` and ``zero_assign``: equal, as tuples.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.sharding import PartitionSpec as JP

from repro.configs import base as jcfg
from repro.optim import adamw as jadamw
from repro.optim.schedule import warmup_cosine as jwarmup_cosine
from repro_torch.configs import base as tcfg
from repro_torch.core.compat import P
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     global_norm, opt_pspecs, zero_assign)
from repro_torch.optim.schedule import warmup_cosine

settings.register_profile("ci", max_examples=20, deadline=None)
settings.load_profile("ci")


# ------------------------------------------------------------ configs
def _configs(mod):
    """The sweep of model shapes, built with ``mod``'s classes."""
    M, MoE, SSM = mod.ModelConfig, mod.MoEConfig, mod.SSMConfig
    base = dict(n_layers=4, d_model=256, n_heads=8, n_kv_heads=8,
                d_ff=1024, vocab_size=1000)

    def cfg(name, family="dense", **kw):
        return M(name=name, family=family, **{**base, **kw})

    return {
        "dense": cfg("dense"),
        "gqa": cfg("gqa", n_kv_heads=2, qk_norm=True),
        "mqa": cfg("mqa", n_kv_heads=1, head_dim=48),
        "moe_shared": cfg("moe_shared", "moe", d_ff=512, moe=MoE(
            n_experts=8, top_k=2, n_shared_experts=2)),
        "ssm": cfg("ssm", "ssm", n_heads=0, n_kv_heads=0, attn_free=True,
                   ssm=SSM(d_state=16, expand=2)),
        "hybrid": cfg("hybrid", "hybrid", d_model=1600, n_heads=25,
                      n_kv_heads=5, hybrid=True, ssm=SSM(dt_rank=8),
                      global_layers=(0, 2)),
        "local_global": cfg("local_global", n_layers=12,
                            local_global_ratio=5, sliding_window=512,
                            rope_theta_local=10_000.0),
        "local_no_window": cfg("local_no_window", n_layers=6,
                               local_global_ratio=2),
        "global_layers": cfg("global_layers", n_layers=12,
                             global_layers=(0, 5, 11), sliding_window=256),
        "tied": cfg("tied", tie_embeddings=True, frontend="embed"),
        "moe_hybrid": cfg("moe_hybrid", "moe", n_heads=24, n_kv_heads=8,
                          hybrid=True, ssm=SSM(), moe=MoE(
                              n_experts=4, top_k=1)),
    }


@pytest.mark.parametrize("name", sorted(_configs(jcfg)))
def test_model_config_matches_reference(name):
    want, got = _configs(jcfg)[name], _configs(tcfg)[name]
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert got.layer_kinds == want.layer_kinds
    assert got.sub_quadratic == want.sub_quadratic
    assert got.resolved_head_dim == want.resolved_head_dim
    assert (got.uses_attention, got.uses_ssm) == \
        (want.uses_attention, want.uses_ssm)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_shape_config_and_layer_constants_match_reference():
    for kind in ("train", "decode"):
        want = jcfg.ShapeConfig("s", 4096, 256, kind)
        got = tcfg.ShapeConfig("s", 4096, 256, kind)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.tokens == want.tokens
    names = [n for n in dir(jcfg) if n.startswith("LAYER_")]
    assert len(names) == 4
    assert {n: getattr(tcfg, n) for n in names} == \
        {n: getattr(jcfg, n) for n in names}
    assert tcfg.SSMConfig().resolved_dt_rank(1600) == \
        jcfg.SSMConfig().resolved_dt_rank(1600)


# ------------------------------------------------- the four mirrored
def test_adamw_descends_quadratic():
    w = {"w": torch.tensor([3.0, -2.0])}
    opt = adamw_init(w)
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    for _ in range(200):
        x = w["w"].detach().requires_grad_(True)
        torch.sum(x ** 2).backward()
        w, opt, _ = adamw_update({"w": x.grad}, opt, w, cfg)
    assert float(torch.sum(w["w"] ** 2)) < 1e-3


def test_adamw_grad_clip():
    w = {"w": torch.ones((4,))}
    opt = adamw_init(w)
    cfg = AdamWConfig(lr=1e-3, grad_clip=1.0)
    g = {"w": torch.full((4,), 1e6)}
    _, _, metrics = adamw_update(g, opt, w, cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(2e6, rel=1e-3)


@given(step=st.integers(0, 10_000))
def test_warmup_cosine_bounds(step):
    s = float(warmup_cosine(torch.tensor(step, dtype=torch.int32),
                            warmup=100, total=10_000))
    assert 0.0 <= s <= 1.0


def test_zero1_specs_shard_largest_dim():
    pspecs = {"w": P(None, "model")}
    shapes = {"w": torch.empty((64, 32), device="meta")}
    out = opt_pspecs(pspecs, shapes, dp_axes=("data",), dp_size=16)
    assert out["m"]["w"] == P("data", "model")


# ------------------------------------------------- parity with repro
def test_adamw_quadratic_trajectory_matches_reference():
    """200 steps of the mirrored quadratic, gradients from
    ``torch.autograd`` and ``jax.grad``: the whole trajectory at rtol
    2e-5 (measured 8.4e-6)."""
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    jcfg_ = jadamw.AdamWConfig(lr=0.1, weight_decay=0.0)
    w = {"w": torch.tensor([3.0, -2.0])}
    wj = {"w": jnp.array([3.0, -2.0])}
    opt, optj = adamw_init(w), jadamw.adamw_init(wj)
    loss = jax.grad(lambda p: jnp.sum(p["w"] ** 2))
    got, want = [], []
    for _ in range(200):
        x = w["w"].detach().requires_grad_(True)
        torch.sum(x ** 2).backward()
        w, opt, _ = adamw_update({"w": x.grad}, opt, w, cfg)
        wj, optj, _ = jadamw.adamw_update(loss(wj), optj, wj, jcfg_)
        got.append(w["w"].numpy().copy())
        want.append(np.asarray(wj["w"]))
    np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=2e-5,
                               atol=0)
    assert int(opt["step"]) == int(optj["step"]) == 200


_SHAPES = {"a": (8, 16), "b": {"c": (32,), "d": (4, 4, 4)}, "e": (3,)}


def _tree(rng, scale):
    def make(shapes):
        if isinstance(shapes, dict):
            return {k: make(v) for k, v in shapes.items()}
        return (scale * rng.standard_normal(shapes)).astype(np.float32)
    return make(_SHAPES)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("scheduled", [False, True])
def test_adamw_update_bf16_tree_matches_reference(scheduled):
    """Five updates of a bf16 tree (gradients alternately clipped and
    not), ``lr_scale`` a float or ``warmup_cosine`` of the device step:
    params, master, m, v, step and both metrics against JAX."""
    rng = np.random.default_rng(0)
    p0 = _tree(rng, 0.02)
    bf = lambda t: jax.tree.map(lambda x: torch.from_numpy(x).to(
        torch.bfloat16), t)
    jbf = lambda t: jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), t)
    params, jparams = bf(p0), jbf(p0)
    opt, jopt = adamw_init(params), jadamw.adamw_init(jparams)
    cfg, jc = AdamWConfig(lr=1e-2), jadamw.AdamWConfig(lr=1e-2)
    for i in range(5):
        g = _tree(rng, 10.0 if i % 2 == 0 else 0.05)
        scale, jscale = (warmup_cosine(opt["step"], warmup=2, total=10),
                         jwarmup_cosine(jopt["step"], warmup=2, total=10)) \
            if scheduled else (0.5, 0.5)
        params, opt, metrics = adamw_update(bf(g), opt, params, cfg, scale)
        jparams, jopt, jmetrics = jadamw.adamw_update(jbf(g), jopt, jparams,
                                                      jc, jscale)
        for key in ("m", "v", "master"):
            for a, b in zip(_leaves(opt[key]), jax.tree.leaves(jopt[key])):
                assert a.dtype == torch.float32
                b = np.asarray(b)
                assert np.max(np.abs(a.numpy() - b)) <= \
                    1e-5 * np.max(np.abs(b)), (i, key)
        for a, b in zip(_leaves(params), jax.tree.leaves(jparams)):
            assert a.dtype == torch.bfloat16
            np.testing.assert_allclose(_f32(a), _f32(b), rtol=2 ** -7,
                                       atol=0)
        assert int(opt["step"]) == int(jopt["step"]) == i + 1
        assert opt["step"].dtype == torch.int32
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(jmetrics["grad_norm"]), rtol=1e-6)
        assert metrics["lr"].dtype == torch.float32
        assert float(metrics["lr"]) == float(jmetrics["lr"])


def test_adamw_is_out_of_place():
    """``adamw_init`` copies fp32 params into the master (no alias), and
    ``adamw_update`` writes into none of its inputs."""
    rng = np.random.default_rng(1)
    params = jax.tree.map(torch.from_numpy, _tree(rng, 1.0))
    opt = adamw_init(params)
    for p, m in zip(_leaves(params), _leaves(opt["master"])):
        assert m.data_ptr() != p.data_ptr() and torch.equal(m, p)
    grads = jax.tree.map(torch.from_numpy, _tree(rng, 1.0))
    inputs = _leaves(params) + _leaves(grads) + [opt["step"]] + \
        [x for k in ("master", "m", "v") for x in _leaves(opt[k])]
    before = [x.clone() for x in inputs]
    adamw_update(grads, opt, params, AdamWConfig())
    assert all(torch.equal(a, b) for a, b in zip(before, inputs))


def test_global_norm_matches_reference():
    """fp32 and bf16 leaves; rtol 1e-6 (the sums run in another
    order)."""
    rng = np.random.default_rng(2)
    tree = _tree(rng, 3.0)
    t = jax.tree.map(torch.from_numpy, tree)
    t["a"] = t["a"].to(torch.bfloat16)
    j = jax.tree.map(jnp.asarray, tree)
    j["a"] = j["a"].astype(jnp.bfloat16)
    np.testing.assert_allclose(float(global_norm(t)),
                               float(jadamw.global_norm(j)), rtol=1e-6)


@pytest.mark.parametrize("warmup,total,floor", [(100, 10_000, 0.1),
                                                (0, 50, 0.0), (7, 8, 0.5)])
def test_warmup_cosine_matches_reference(warmup, total, floor):
    """At the edges (0, warmup - 1, warmup, warmup + 1, total - 1, total,
    beyond): rtol 1e-6.  A tensor step keeps its device; an int step
    takes ``device=``; the result is 0-d fp32."""
    kw = dict(warmup=warmup, total=total, floor=floor)
    for step in sorted({0, max(warmup - 1, 0), warmup, warmup + 1,
                        total - 1, total, total + 1, 3 * total}):
        want = float(jwarmup_cosine(jnp.int32(step), **kw))
        got = warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw)
        by_int = warmup_cosine(step, device="cpu", **kw)
        assert got.dtype == by_int.dtype == torch.float32
        assert got.shape == () and got.device.type == "cpu"
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0)
        assert float(by_int) == float(got)


def test_warmup_cosine_int_step_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        warmup_cosine(3)


_ZERO_CASES = [
    # (spec, shape, dp_axes, dp_size, mesh_shape)
    ((None, "model"), (64, 32), ("data",), 16, None),
    ((None, "model"), (64, 32), ("data",), 16, {"data": 16, "model": 16}),
    ((None, None), (48, 1600), ("pod", "data"), 32,
     {"pod": 2, "data": 16, "model": 16}),
    ((None, None), (1600,), ("pod", "data"), 32,
     {"pod": 2, "data": 16, "model": 16}),
    ((None, None, None), (4, 1600, 100), ("pod", "data"), 512,
     {"data": 16}),                      # "pod" missing: counts as 16
    ((("pod", "data"), None), (64, 48), ("pod", "data"), 32,
     {"pod": 2, "data": 16}),            # every dp axis used already
    (("data", None), (64, 48), ("pod", "data"), 32,
     {"pod": 2, "data": 16}),
    ((None,), (7,), ("data",), 16, {"data": 16}),   # nothing divides
    ((), (8, 16, 32), ("data",), 1, {"data": 1}),   # dp_size 1: no ZeRO
    (None, (256, 128), ("data", "model"), 256,
     {"data": 16, "model": 16}),
    ((None, "model", None), (16, 2048, 512), ("data",), 16,
     {"data": 16, "model": 16}),
]


@pytest.mark.parametrize("case", range(len(_ZERO_CASES)))
def test_opt_pspecs_matches_reference(case):
    spec, shape, dp_axes, dp_size, mesh_shape = _ZERO_CASES[case]
    jspec = None if spec is None else JP(*spec)
    tspec = None if spec is None else P(*spec)
    want = jadamw.opt_pspecs(
        {"w": jspec, "n": {"b": JP()}},
        {"w": jax.ShapeDtypeStruct(shape, jnp.float32),
         "n": {"b": jax.ShapeDtypeStruct((5,), jnp.float32)}},
        dp_axes=dp_axes, dp_size=dp_size, mesh_shape=mesh_shape)
    got = opt_pspecs({"w": tspec, "n": {"b": P()}},
                     {"w": shape, "n": {"b": torch.empty(5, device="meta")}},
                     dp_axes=dp_axes, dp_size=dp_size, mesh_shape=mesh_shape)
    assert set(got) == set(want)
    for key in ("master", "m", "v"):
        assert isinstance(got[key]["w"], P)
        assert tuple(got[key]["w"]) == tuple(want[key]["w"])
        assert tuple(got[key]["n"]["b"]) == tuple(want[key]["n"]["b"])
    assert tuple(got["step"]) == tuple(want["step"]) == ()
    parts = [None] * len(shape)
    assert zero_assign(list(parts), shape, dp_axes, mesh_shape) == \
        jadamw.zero_assign(list(parts), shape, dp_axes, mesh_shape)


def test_partition_spec_is_canonical_as_jax():
    for entries in [(), (None,), (("data",), None), (("pod", "data"),),
                    ([], "model"), (["a", "b"], None, "c")]:
        assert tuple(P(*entries)) == tuple(JP(*entries))
    assert P("data") == ("data",) and P(("data",)) == P("data")
