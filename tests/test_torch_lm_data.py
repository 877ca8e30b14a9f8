"""The port's sharding rules and LM data against ``repro``:
``parallel/sharding.py`` (specs and placements), ``data/synthetic.py``'s
``lm_batch`` and ``data/pipeline.py``.

Tolerances: none; everything here is compared exactly.
- Specs (``param_pspecs``, ``cache_pspecs``, ``batch_spec``,
  ``act_spec``) as tuples, at the production meshes (16, 16) and
  (2, 16, 16): JAX's side on an ``AbstractMesh``, the port's on a
  stand-in with the same axis names and sizes (a ``DeviceMesh`` of 256
  ranks cannot be built in a test; the spec functions read only names
  and sizes).
- ``lm_batch`` with JAX's own draws (drawn here exactly as
  ``repro.data.synthetic.lm_batch`` draws them) bit for bit: integer
  arithmetic, and one fp32 product for the embeddings.
- Placements pick blocks exactly; the rank of each is a stand-in
  ``compat.Axes``, or a one-rank gloo mesh of this process.
"""
import datetime
import threading
import time
from types import SimpleNamespace
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import SSMConfig as JSSMConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.data.synthetic import lm_batch as jlm_batch
from repro.parallel import sharding as jsh
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig
from repro_torch.core.compat import NO_AXES, Axes, P
from repro_torch.data.pipeline import PrefetchLoader, lm_loader
from repro_torch.data.synthetic import lm_batch, lm_draws, lm_seed
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel import sharding as tsh
from repro_torch.parallel.sharding import Placement, for_mesh


class _Mesh:
    """The names and sizes of a mesh, read as ``compat.mesh_shape`` reads
    a ``DeviceMesh``."""

    def __init__(self, shape, names):
        self.mesh_dim_names = names
        self.mesh = SimpleNamespace(shape=tuple(shape))


MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
RULES = {"default": {}, "fsdp": dict(fsdp=True), "dp_only":
         dict(dp_only=True), "dp_only_fsdp": dict(dp_only=True, fsdp=True),
         "seq_act": dict(seq_shard_activations=True)}


def _model(mods, heads, kv, d):
    M, MoE, SSM = mods
    return M(name=f"h{heads}", family="hybrid", n_layers=4, d_model=d,
             n_heads=heads, n_kv_heads=kv, d_ff=2 * d, vocab_size=32_000,
             hybrid=True, qk_norm=True, ssm=SSM(),
             moe=MoE(n_experts=16, top_k=2, n_shared_experts=1))


JMODS = (JModelConfig, JMoEConfig, JSSMConfig)
TMODS = (ModelConfig, MoEConfig, SSMConfig)
# heads dividing 16 and not (granite-moe's 24, hymba's 25)
MODELS = {"32h": (32, 8, 2048), "24h": (24, 8, 1536), "25h": (25, 5, 1600)}


class FFN(NamedTuple):
    w1: tuple
    w3: tuple
    w2: tuple


def _shapes(cfg):
    """A parameter tree with every leaf name the rules dispatch on, the
    dense FFN as a NamedTuple, and a ``None`` leaf."""
    L, d, V, ff = cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.d_ff
    hd = cfg.resolved_head_dim
    H, K = cfg.n_heads * hd, cfg.n_kv_heads * hd
    dI, ds, dc = 2 * d, cfg.ssm.d_state, cfg.ssm.d_conv
    dtr = cfg.ssm.resolved_dt_rank(d)
    E = cfg.moe.n_experts
    return {
        "embed": (V, d), "head": (d, V), "final_norm": (d,),
        "vision": None,
        "layers": {
            "ln1": (L, d), "ln2": (L, d), "q_norm": (L, hd),
            "attn": {"wq": (L, d, H), "wk": (L, d, K), "wv": (L, d, K),
                     "wo": (L, H, d)},
            "mamba": {"in_proj": (L, d, 2 * dI), "conv_w": (L, dc, dI),
                      "conv_b": (L, dI), "x_proj": (L, dI, dtr + 2 * ds),
                      "dt_proj": (L, dtr, dI), "dt_bias": (L, dI),
                      "A_log": (L, dI, ds), "D": (L, dI),
                      "out_proj": (L, dI, d)},
            "moe": {"router": (L, d, E), "we1": (L, E, d, ff),
                    "we3": (L, E, d, ff), "we2": (L, E, ff, d),
                    "ws1": (L, d, ff), "ws3": (L, d, ff), "ws2": (L, ff, d)},
            "ffn": FFN((L, d, ff), (L, d, ff), (L, ff, d)),
        },
    }


def _leaves_as(tree, make):
    if isinstance(tree, dict):
        return {k: _leaves_as(v, make) for k, v in tree.items()}
    if isinstance(tree, FFN):
        return FFN(*(make(s) for s in tree))
    return None if tree is None else make(tree)


def _as_tuples(tree):
    """Specs of either package as nested dicts of tuples."""
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    if isinstance(tree, FFN):
        return tuple(_as_tuples(s) for s in tree)
    return None if tree is None else ("spec",) + tuple(tree)


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("model", sorted(MODELS))
def test_param_pspecs_match_reference(model, mesh, rules):
    shape, names = MESHES[mesh]
    jr = jsh.for_mesh(AbstractMesh(shape, names), **RULES[rules])
    tr = for_mesh(_Mesh(shape, names), **RULES[rules])
    assert (tr.tp, tr.dp, tr.dp_size, tr.t_ax) == \
        (jr.tp, jr.dp, jr.dp_size, jr.t_ax)
    jcfg, tcfg = _model(JMODS, *MODELS[model]), _model(TMODS, *MODELS[model])
    shapes = _shapes(tcfg)
    want = jsh.param_pspecs(jcfg, jr, _leaves_as(
        shapes, lambda s: jax.ShapeDtypeStruct(s, jnp.bfloat16)))
    got = tsh.param_pspecs(tcfg, tr, _leaves_as(
        shapes, lambda s: torch.empty(s, dtype=torch.bfloat16,
                                      device="meta")))
    assert isinstance(got["layers"]["ffn"], FFN)
    assert isinstance(got["layers"]["attn"]["wq"], P)
    assert _as_tuples(got) == _as_tuples(want)
    for extra in (1, 2):
        assert tuple(tr.batch_spec(extra)) == tuple(jr.batch_spec(extra))
    assert tuple(tr.act_spec(tcfg)) == tuple(jr.act_spec(jcfg))


def test_rules_without_a_mesh_match_reference():
    jr, tr = jsh.for_mesh(None), for_mesh(None)
    assert (tr.tp, tr.dp, tr.dp_size) == (jr.tp, jr.dp, jr.dp_size)
    assert tr.sharding(P("data")) is None and jr.sharding(None) is None
    x = torch.arange(4)
    assert tr.cs(x, P("data")) is x
    jcfg, tcfg = _model(JMODS, 32, 8, 256), _model(TMODS, 32, 8, 256)
    shapes = _shapes(tcfg)
    want = jsh.param_pspecs(jcfg, jr, _leaves_as(
        shapes, lambda s: jax.ShapeDtypeStruct(s, jnp.float32)))
    got = tsh.param_pspecs(tcfg, tr, _leaves_as(
        shapes, lambda s: torch.empty(s, device="meta")))
    assert _as_tuples(got) == _as_tuples(want)


def test_unknown_leaf_raises_as_reference():
    shape, names = MESHES["16x16"]
    jcfg, tcfg = _model(JMODS, 32, 8, 256), _model(TMODS, 32, 8, 256)
    with pytest.raises(ValueError, match="layers/mystery"):
        jsh.param_pspecs(jcfg, jsh.for_mesh(AbstractMesh(shape, names)),
                         {"layers": {"mystery": jax.ShapeDtypeStruct(
                             (4, 8), jnp.float32)}})
    with pytest.raises(ValueError, match="layers/mystery"):
        tsh.param_pspecs(tcfg, for_mesh(_Mesh(shape, names)),
                         {"layers": {"mystery": torch.empty(
                             (4, 8), device="meta")}})
    with pytest.raises(ValueError):
        jsh.cache_pspecs(jcfg, jsh.for_mesh(None), {"q": 1}, 1)
    with pytest.raises(ValueError):
        tsh.cache_pspecs(tcfg, for_mesh(None), {"q": 1}, 1)


CACHE = {"k": 1, "v": 1, "k_scale": 1, "v_scale": 1, "conv": 1, "ssm": 1,
         "none": None}


@pytest.mark.parametrize("batch", [32, 24, 1])
@pytest.mark.parametrize("seq", [False, True])
@pytest.mark.parametrize("kv", [16, 8])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_cache_pspecs_match_reference(mesh, kv, seq, batch):
    """kv heads that divide the model axis and not, the sequence axis
    sharded over dp or not, batches that divide dp (32 over 16 and 32),
    divide only 16 (24 does not) and do not (1)."""
    shape, names = MESHES[mesh]
    jcfg, tcfg = _model(JMODS, 32, kv, 2048), _model(TMODS, 32, kv, 2048)
    for kw in ({}, dict(dp_only=True)):
        want = jsh.cache_pspecs(jcfg, jsh.for_mesh(
            AbstractMesh(shape, names), shard_cache_seq=seq, **kw),
            CACHE, batch)
        got = tsh.cache_pspecs(tcfg, for_mesh(
            _Mesh(shape, names), shard_cache_seq=seq, **kw), CACHE, batch)
        assert _as_tuples(got) == _as_tuples(want)


# ------------------------------------------------------------ placements
def test_placement_picks_each_ranks_block():
    x = torch.arange(8 * 6).reshape(8, 6)
    for r in range(4):
        rows = Placement(P("data", None),
                         [Axes(("data",), size=4, rank=r), NO_AXES])(x)
        assert torch.equal(rows, x[2 * r:2 * r + 2])
        # a tuple of axes: the block over their product, pod major
        both = Placement(P(("pod", "data"), "model"),
                         [Axes(("pod", "data"), size=4, rank=r),
                          Axes(("model",), size=2, rank=r % 2)])(x)
        assert torch.equal(both, x[2 * r:2 * r + 2, 3 * (r % 2):
                                   3 * (r % 2) + 3])
        assert both.is_contiguous()
        cols = Placement(P(None, "model"),
                         [NO_AXES, Axes(("model",), size=4, rank=r)])
        with pytest.raises(ValueError, match="not divisible"):
            cols(x)
    # nothing split: the tensor itself
    whole = Placement(P("data"), [Axes(("data",), size=1, rank=0)])
    assert whole(x) is x
    with pytest.raises(ValueError, match="more entries"):
        Placement(P(None, None, "data"), [NO_AXES] * 3)(x)


@pytest.fixture
def one_rank_mesh(tmp_path):
    """A (data=1, model=1) gloo mesh over a one-rank process group of
    this process, torn down after use."""
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "store"), 1),
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield make_mesh((1, 1), ("data", "model"), device="cpu")
    finally:
        dist.destroy_process_group()


def test_placements_and_loader_under_a_one_rank_mesh(one_rank_mesh):
    """On a real mesh: placements keep every row of the one rank, take
    the axes in the mesh's order, and the loader under the mesh yields
    ``lm_batch``'s batches."""
    rules = for_mesh(one_rank_mesh)
    assert (rules.tp, rules.dp, rules.dp_size) == (1, ("data",), 1)
    x = torch.arange(12.0).reshape(4, 3)
    for spec in (rules.batch_spec(1), P(None, "model"),
                 P(("data", "model"))):
        place = rules.sharding(spec)
        assert isinstance(place, Placement) and place(x) is x
    with pytest.raises(ValueError, match="mesh's order"):
        rules.sharding(P(("model", "data")))
    cfg = _lm_cfg("token")
    loader = lm_loader(cfg, rules, batch=2, seq=8, seed=1, device="cpu")
    try:
        for want_step in range(3):
            step, batch = next(loader)
            assert step == want_step
            _equal(batch, lm_batch(cfg, 2, 8, 1, step, device="cpu"))
    finally:
        loader.close()


# ------------------------------------------------------------ lm_batch
def _lm_cfg(frontend, V=1000, d=16, mods=TMODS):
    return mods[0](name="lm", family="dense", n_layers=2, d_model=d,
                   n_heads=2, n_kv_heads=2, d_ff=32, vocab_size=V,
                   frontend=frontend)


def _jax_draws(cfg, batch, seq, seed, step):
    """The draws of ``repro.data.synthetic.lm_batch``, made as it makes
    them."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    k1, k2, k3 = jax.random.split(key, 3)
    out = {"start": jax.random.randint(k1, (batch, 1), 0, cfg.vocab_size),
           "drift": jax.random.randint(k2, (batch, 1), 1, 7),
           "noise": jax.random.bernoulli(k3, 0.05, (batch, seq + 1))}
    if cfg.frontend == "embed":
        emb_key = jax.random.fold_in(jax.random.PRNGKey(seed + 1), step)
        out["embeds"] = jax.random.normal(emb_key, (batch, seq, cfg.d_model),
                                          jnp.float32)
    return {k: np.asarray(v) for k, v in out.items()}


def _equal(got, want):
    assert list(got) == list(want)
    for k in want:
        a = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        b = np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("V", [1000, 128_256])
@pytest.mark.parametrize("frontend", ["token", "embed"])
def test_lm_batch_matches_reference_bit_for_bit(frontend, V):
    for seed, step in ((0, 0), (3, 17)):
        jcfg = _lm_cfg(frontend, V, mods=JMODS)
        cfg = _lm_cfg(frontend, V)
        want = jlm_batch(jcfg, 4, 64, seed, step)
        got = lm_batch(cfg, 4, 64, seed, step, device="cpu",
                       draws=_jax_draws(cfg, 4, 64, seed, step))
        assert got["labels"].dtype == torch.int32
        _equal(got, want)


def test_lm_batch_is_a_function_of_seed_and_step():
    cfg = _lm_cfg("embed")
    a = lm_batch(cfg, 3, 32, 5, 7, device="cpu")
    b = lm_batch(cfg, 3, 32, 5, 7, device="cpu")
    _equal(a, {k: v.numpy() for k, v in b.items()})
    for other in (lm_batch(cfg, 3, 32, 5, 8, device="cpu"),
                  lm_batch(cfg, 3, 32, 6, 7, device="cpu")):
        assert not torch.equal(a["labels"], other["labels"])
        assert not torch.equal(a["embeds"], other["embeds"])
    # the draws are lm_draws' for (seed, step)
    _equal(lm_batch(cfg, 3, 32, 5, 7, device="cpu",
                    draws=lm_draws(cfg, 3, 32, 5, 7)),
           {k: v.numpy() for k, v in a.items()})
    # labels follow tokens by one, mod V
    tok = lm_batch(_lm_cfg("token"), 3, 32, 5, 7, device="cpu")
    assert torch.equal(tok["labels"][:, :-1], tok["tokens"][:, 1:])
    seeds = {lm_seed(a, b) for a in range(64) for b in range(64)}
    assert len(seeds) == 64 * 64 and max(seeds) < 2 ** 32
    with pytest.raises(ValueError):
        lm_seed(-1, 0)


def test_lm_batch_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm_batch(_lm_cfg("token"), 2, 8, 0, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm_loader(_lm_cfg("token"), for_mesh(None), batch=2, seq=8)


# ------------------------------------------------------------ the loader
@pytest.mark.parametrize("start", [0, 4])
def test_lm_loader_yields_lm_batch_and_resumes(start):
    cfg = _lm_cfg("token")
    loader = lm_loader(cfg, for_mesh(None), batch=3, seq=16, seed=2,
                       start_step=start, device="cpu")
    try:
        for i in range(5):
            step, batch = next(loader)
            assert step == start + i
            _equal(batch, {k: v.numpy() for k, v in
                           lm_batch(cfg, 3, 16, 2, step,
                                    device="cpu").items()})
    finally:
        loader.close()
    assert not loader._thread.is_alive()


def test_close_stops_a_worker_blocked_on_a_full_queue():
    """depth 1, never read: the worker blocks on the full queue; close()
    leaves the thread dead (a 2 s join)."""
    made = threading.Event()

    def make(step):
        made.set()
        return {"x": torch.full((2,), float(step))}

    loader = PrefetchLoader(make, for_mesh(None), depth=1, device="cpu")
    assert made.wait(5)
    time.sleep(0.05)            # the second batch waits on the queue
    closer = threading.Thread(target=loader.close)
    closer.start()
    closer.join(2)
    loader._thread.join(2)
    assert not closer.is_alive() and not loader._thread.is_alive()


def test_loader_raises_what_make_batch_raised():
    def make(step):
        if step == 2:
            raise KeyError("no batch 2")
        return {"x": np.full((2, 3), step, np.int32)}

    loader = PrefetchLoader(make, for_mesh(None), device="cpu")
    try:
        assert [next(loader)[0] for _ in range(2)] == [0, 1]
        with pytest.raises(KeyError, match="no batch 2"):
            next(loader)
    finally:
        loader.close()
    assert not loader._thread.is_alive()
