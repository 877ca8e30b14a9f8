"""The port's linter, ``repro_torch.lint``.

Each rule has fixtures that must fire (the right rule ID, and the line
where it matters) and clean fixtures written in the port's idioms that
must not.  Fixtures are written into ``tmp_path`` as files, so neither
linter reads them as part of the tree.  Beyond the rules: suppressions,
the output format, syntax errors, the command line, the stable rule
table, mutation tests on copies of the port's real steps (a sync put
into them is found, the unedited copies are clean), and the gate that
the port's tree lints clean.
"""
import ast
import json
import re
import runpy
import shutil
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.lint import all_rules, lint_file, lint_paths
from repro_torch.lint.checkers.steps import step_reachable
from repro_torch.lint.cli import default_paths
from repro_torch.lint.cli import main as lint_main
from repro_torch.lint.core import ModuleSource

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def _lint(tmp_path, source, name="mod.py"):
    p = tmp_path / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(source))
    return lint_file(p)


def _only(findings, rule_id):
    return [f for f in findings if f.rule.id == rule_id]


def _reachable(path):
    text = Path(path).read_text()
    mod = ModuleSource(Path(path), text, ast.parse(text))
    return {getattr(fn, "name", "<lambda>") for fn in step_reachable(mod)}


# =====================================================================
# RPL301 tensor-branch / RPL302 host-sync: what is step-reachable
# =====================================================================

_PROBLEM = """
    import torch
    from repro_torch.core.problem import Problem, register

    @register("fixture")
    class Fixture(Problem):
        def init_bundle(self, inputs, device, mesh=None):
            return None

        def full_step(self, d, rep, axes):
            x = d["x"] * rep["tau"]
            {body}
            return dict(d, x=x), {{"cost": torch.sum(x * x)}}
"""


@pytest.mark.parametrize("body,rule,what", [
    ("if x.sum() > 0:\n                x = -x", "RPL301", "'if'"),
    ("while torch.any(x > 1):\n                x = 0.5 * x", "RPL301",
     "'while'"),
    ("x = x if x.max() > 0 else -x", "RPL301", "ternary"),
    ("assert torch.isfinite(x).all()", "RPL301", "'assert'"),
    ("y = [v for v in (x, x) if v.sum() > 0]", "RPL301", "filter"),
    ("s = x.sum().item()", "RPL302", ".item()"),
    ("s = float(torch.sum(x))", "RPL302", "float()"),
    ("s = bool(x.any())", "RPL302", "bool()"),
    ("h = x.cpu()", "RPL302", ".cpu()"),
    ("h = x.to('cpu')", "RPL302", ".to()"),
    ("h = x.detach().numpy()", "RPL302", ".numpy()"),
    ("h = x.tolist()", "RPL302", ".tolist()"),
    ("import numpy as np\n            h = np.asarray(x)", "RPL302",
     "numpy.asarray"),
    ("import math\n            h = math.sqrt(x.sum())", "RPL302",
     "math.sqrt"),
    ("L = torch.linalg.cholesky(x)", "RPL302", "torch.linalg.cholesky"),
    ("w, v = torch.linalg.eigh(x)", "RPL302", "torch.linalg.eigh"),
    ("s = torch.linalg.svdvals(x)", "RPL302", "torch.linalg.svdvals"),
    ("y = torch.linalg.solve(x, x)", "RPL302", "torch.linalg.solve"),
    ("i = torch.nonzero(x)", "RPL302", "torch.nonzero"),
    ("u = torch.unique(x)", "RPL302", "torch.unique"),
    ("i = torch.where(x > 0)", "RPL302", "one-argument"),
    ("y = x[x > 0]", "RPL302", "boolean-mask"),
    ("y = x[torch.isfinite(x)]", "RPL302", "boolean-mask"),
    ("torch.cuda.synchronize()", "RPL302", "synchronize"),
])
def test_step_hook_hazards_fire(tmp_path, body, rule, what):
    found = _lint(tmp_path, _PROBLEM.format(body=body))
    hits = _only(found, rule)
    assert len(hits) == 1, [f.format() for f in found]
    assert what in hits[0].message and "'full_step'" in hits[0].message
    assert [f for f in found if f.rule.id != rule] == []


def test_step_hazard_line(tmp_path):
    found = _lint(tmp_path, _PROBLEM.format(body="s = x.sum().item()"))
    assert [(f.rule.id, f.line) for f in found] == [("RPL302", 12)]


def test_step_hook_static_idioms_are_clean(tmp_path):
    # the port's idioms: static names and annotations, metadata, container
    # truthiness, identity and membership tests, static helpers, the _ex
    # factorizations, Python numbers from the config, loops over tensors
    found = _lint(tmp_path, """
        import torch
        from repro_torch.core.compat import psum
        from repro_torch.core.problem import Problem, register
        from repro_torch.kernels import common

        def _route(t, use_kernel):
            return common.on_card(t) if use_kernel is None else use_kernel

        def _count(v, like):
            return v.numel() if isinstance(v, torch.Tensor) else 1

        def _smooth(x, scale: int, n_scales, chunk, last=None):
            if scale > 3 or n_scales < 1 or chunk == 1:
                return x
            if last is None:
                last = x
            return x + last

        @register("fixture")
        class Fixture(Problem):
            def init_bundle(self, inputs, device, mesh=None):
                return None

            def full_step(self, d, rep, axes):
                if not d or "CX" in d:
                    return d, {"cost": torch.zeros(())}
                x = d["x"]
                if axes:
                    x = psum(x, axes)
                if self.cfg.mode == "sparse" and x.dim() == 3:
                    x = x[None]
                if x.shape[0] > 2 and len(x.shape) == 4 and x.numel():
                    x = x * float(self.cfg.lam) * int(x.shape[0])
                if not _route(x, None) or _count(rep["tau"], x) > 1:
                    x = -x
                L = torch.linalg.cholesky_ex(x @ x.mT).L
                parts = [p for p in torch.unbind(x) if p.dim() == 2]
                for p in x:
                    x = x + p
                x = x if x.is_contiguous() else x.contiguous()
                return dict(d, x=_smooth(x + L.sum(), 2, 4, 8)), \\
                    {"cost": torch.sum(x), "n": len(parts)}
    """)
    assert found == [], [f.format() for f in found]


def test_code_that_no_step_reaches_may_sync(tmp_path):
    # host code, init_bundle, finalize and a sequential reference sync on
    # purpose: none is step-reachable
    found = _lint(tmp_path, """
        import torch
        from repro_torch.core.problem import Problem, register

        def summarize(x):
            if x.sum() > 0:
                return float(torch.sum(x))
            return x.max().item()

        def svt(mat, thresh):
            u, s, vt = torch.linalg.svd(mat, full_matrices=False)
            return (u * torch.clamp(s - thresh, min=0.0)) @ vt

        @register("fixture")
        class Fixture(Problem):
            def init_bundle(self, inputs, device, mesh=None):
                scale = float(torch.linalg.eigvalsh(inputs[0]).max())
                return scale

            def full_step(self, d, rep, axes):
                return d, {"cost": torch.sum(d["x"])}

            def finalize(self, bundle, log):
                return bundle.data["x"].cpu().numpy(), {}
    """)
    assert found == [], [f.format() for f in found]


@pytest.mark.parametrize("source,label", [
    # a closure of a step factory
    ("""
        import torch

        def make_cost_fn(cfg):
            def cost(d, rep, axes):
                c = torch.sum(d["x"])
                return {"cost": c.item()}
            return cost
    """, "'cost'"),
    # a lambda given to the engine
    ("""
        from repro_torch.core import engine

        def build(fn):
            return engine.make_scan_step(
                fn, fn_light=lambda d, r, a: d["x"].cpu(), cost_every=2)
    """, "'<lambda>'"),
    # a function given to the driver by name, and the helper it calls
    ("""
        import torch
        from repro_torch.core.driver import IterativeDriver

        def _norm(x):
            return x.norm().item()

        def run(bundle):
            def step(d, rep, axes):
                return d, {"cost": _norm(d["x"])}
            return IterativeDriver(step, bundle).run()
    """, "'_norm'"),
    # RunOptions' step wiring
    ("""
        from repro_torch.core.driver import RunOptions

        def refresh(rep, out):
            return {"w": out["w"].tolist()}

        OPTS = RunOptions(update_replicated=refresh)
    """, "'refresh'"),
    # a method called through self from a hook
    ("""
        import torch
        from repro_torch.core.problem import Problem, register

        @register("fixture")
        class Fixture(Problem):
            def init_bundle(self, inputs, device, mesh=None):
                return None

            def _iterate(self, d, rep, axes):
                return dict(d, x=d["x"][d["x"] > 0])

            def full_step(self, d, rep, axes):
                d = self._iterate(d, rep, axes)
                return d, {"cost": torch.sum(d["x"])}
    """, "'_iterate'"),
])
def test_reachability_finds_steps(tmp_path, source, label):
    found = _lint(tmp_path, source)
    hits = _only(found, "RPL302")
    assert len(hits) == 1 and label in hits[0].message, \
        [f.format() for f in found]


def test_the_jax_packages_driver_is_not_a_root(tmp_path):
    found = _lint(tmp_path, """
        from repro.core.driver import IterativeDriver

        def run(bundle):
            def step(d, rep, axes):
                return d, {"cost": float(d["x"].sum())}
            return IterativeDriver(step, bundle).run()
    """)
    assert found == []


def test_kernel_wrappers_are_step_reachable(tmp_path):
    (tmp_path / "kernels" / "fam").mkdir(parents=True)
    (tmp_path / "kernels" / "fam" / "ref.py").write_text(
        "def foo_ref(x, k):\n    return x\n")
    (tmp_path / "kernels" / "fam" / "ops.py").write_text(
        "def foo(x, k, *, use_kernel=None):\n    return x\n")
    found = _lint(tmp_path, """
        import torch

        def _check(what: str, x, rank: int):
            if x.dim() != rank or not x.is_contiguous():
                raise ValueError(what)

        def foo_fwd(x, k: float, *, with_xbar: bool = False):
            _check("fam.foo", x, 3)
            out = torch.empty_like(x)
            scale = float(k) * int(with_xbar)
            return out, x.sum().item() + scale
    """, name="kernels/fam/kernel.py")
    hits = _only(found, "RPL302")
    assert len(hits) == 1 and "'foo_fwd'" in hits[0].message
    assert _only(found, "RPL301") == []


# =====================================================================
# RPL102 inplace-carry
# =====================================================================

_STEP = """
    import torch

    def make_step_fn(cfg):
        def step(d, rep, axes):
            x = d["x"]
            {body}
            return dict(d, x=x * 2), {{"cost": torch.sum(x)}}
        return step
"""


@pytest.mark.parametrize("body,how", [
    ("x.add_(1.0)", ".add_()"),
    ("d['x'].clamp_(min=0.0)", ".clamp_()"),
    ("rep['tau'].copy_(rep['tau'] * 2)", ".copy_()"),
    ("x.view(-1).zero_()", ".zero_()"),
    ("x.T.mul_(2.0)", ".mul_()"),
    ("x[0] = 0.0", "item assignment"),
    ("d['x'] = x * 2", "item assignment"),
    ("x += 1.0", "augmented assignment"),
    ("torch.add(x, 1.0, out=rep['buf'])", "out="),
    ("torch.nn.init.zeros_(x)", "zeros_"),
    ("u, w = d['u'], rep['w']\n            w.sub_(u)", ".sub_()"),
])
def test_rpl102_writes_into_the_input(tmp_path, body, how):
    found = _lint(tmp_path, _STEP.format(body=body))
    hits = _only(found, "RPL102")
    assert len(hits) == 1, [f.format() for f in found]
    assert how in hits[0].message and "'step'" in hits[0].message


def test_rpl102_fresh_tensors_may_be_written(tmp_path):
    found = _lint(tmp_path, _STEP.format(body="""y = x * 2.0
            y.add_(1.0)
            z = torch.zeros(3)
            z[0] = 1.0
            x = x + 1.0
            x += 1.0
            new = dict(d)
            new["x"] = x
            buf = torch.empty_like(x)
            torch.add(x, 1.0, out=buf)"""))
    assert found == [], [f.format() for f in found]


def test_rpl102_host_code_may_write_in_place(tmp_path):
    found = _lint(tmp_path, """
        def reset(d):
            d["x"].zero_()
            d["y"] = None
    """)
    assert found == []


# =====================================================================
# RPL203 ref-parity / RPL204 kernel-fallback
# =====================================================================

def _family(tmp_path, name, ref=None):
    fam = tmp_path / "kernels" / name
    fam.mkdir(parents=True)
    if ref is not None:
        (fam / "ref.py").write_text(textwrap.dedent(ref))
    return f"kernels/{name}"


def test_rpl203_signature_drift_and_missing_wrapper(tmp_path):
    fam = _family(tmp_path, "fam", """
        def foo_ref(a, b, gamma):
            return a + b * gamma

        def bar_ref(a):
            return a
    """)
    found = _lint(tmp_path, """
        def foo(a, b, *, use_kernel=None, device=None):
            return a + b
    """, name=f"{fam}/ops.py")
    hits = _only(found, "RPL203")
    msgs = " | ".join(h.message for h in hits)
    assert len(hits) == 2
    assert "drifted" in msgs and "gamma" in msgs
    assert "'bar'" in msgs


def test_rpl203_missing_siblings(tmp_path):
    found = _lint(tmp_path, "def foo(a):\n    return a\n",
                  name="kernels/solo/ops.py")
    hits = _only(found, "RPL203")
    assert len(hits) == 1 and "no sibling ref.py" in hits[0].message
    found = _lint(tmp_path, "def foo_fwd(a):\n    return a\n",
                  name="kernels/lone/kernel.py")
    msgs = sorted(h.message for h in _only(found, "RPL203"))
    assert msgs == ["kernel family has no sibling ops.py",
                    "kernel family has no sibling ref.py"]


def test_rpl203_parity_with_control_params_is_clean(tmp_path):
    fam = _family(tmp_path, "good", """
        def foo_ref(a, b, gamma, *, with_xbar=False):
            return a + b * gamma

        def cascade(a, n):
            return a
    """)
    (tmp_path / fam / "kernel.py").write_text("def foo_fwd(a):\n    return a\n")
    found = _lint(tmp_path, """
        from repro_torch.kernels import common

        def foo(a, b, gamma, *, with_xbar=False, use_kernel=None):
            common.chaos_point("good", a)
            if use_kernel is None:
                use_kernel = common.on_card(a)
            if not use_kernel:
                return foo_ref(a, b, gamma, with_xbar=with_xbar)
            return foo_fwd(a)
    """, name=f"{fam}/ops.py")
    assert found == [], [f.format() for f in found]
    assert lint_file(tmp_path / fam / "kernel.py") == []


@pytest.mark.parametrize("handler,what", [
    ("except RuntimeError:\n        return foo_ref(a)", "falls back"),
    ("except Exception:\n        return ref.foo_ref(a)", "falls back"),
    ("except RuntimeError:\n        pass", "swallows"),
])
def test_rpl204_fallback_after_a_failure(tmp_path, handler, what):
    fam = _family(tmp_path, "fb", "def foo_ref(a):\n    return a\n")
    found = _lint(tmp_path, f"""
from repro_torch.kernels.fb import ref
from repro_torch.kernels.fb.ref import foo_ref
from repro_torch.kernels.fb.kernel import foo_fwd


def foo(a, *, use_kernel=None):
    try:
        return foo_fwd(a)
    {handler}
""", name=f"{fam}/ops.py")
    hits = _only(found, "RPL204")
    assert len(hits) == 1 and what in hits[0].message
    assert hits[0].line == 10


def test_rpl204_suppress_and_clean_reraise(tmp_path):
    fam = _family(tmp_path, "sp", "def foo_ref(a):\n    return a\n")
    found = _lint(tmp_path, """
        import contextlib

        def launch(a):
            with contextlib.suppress(RuntimeError):
                return a
    """, name=f"{fam}/kernel.py")
    assert len(_only(found, "RPL204")) == 1
    found = _lint(tmp_path, """
        def launch(a):
            try:
                return int(a)
            except ValueError as e:
                raise RuntimeError("launch failed") from e
    """, name=f"{fam}/kernel.py")
    assert _only(found, "RPL204") == []


def test_rpl204_outside_the_kernels_is_not_checked(tmp_path):
    found = _lint(tmp_path, """
        def probe(a):
            try:
                return a()
            except RuntimeError:
                return None
    """, name="imaging/probe.py")
    assert found == []


# =====================================================================
# RPL401 f64-dtype / RPL402 bf16-accum
# =====================================================================

@pytest.mark.parametrize("expr", [
    "x.to(torch.float64)", "x.double()", "torch.zeros(4, dtype=torch.double)",
    "torch.ones(2, dtype=torch.complex128)", "x.to(dtype=torch.cdouble)",
])
def test_rpl401_torch_float64(tmp_path, expr):
    found = _lint(tmp_path, f"""
        import torch

        def f(x):
            return {expr}
    """)
    assert len(_only(found, "RPL401")) == 1


def test_rpl401_host_numpy_float64_is_clean(tmp_path):
    found = _lint(tmp_path, """
        import numpy as np
        import torch

        def costs(trace):
            host = trace.detach().cpu().numpy()
            return np.asarray(host, dtype=np.float64).sum(dtype=np.float64)

        def check(x):
            if x.dtype != torch.float32:
                raise ValueError("fp32 only")
    """)
    assert found == []


@pytest.mark.parametrize("expr,leaf", [
    ("torch.sum(x.to(torch.bfloat16))", "sum"),
    ("x.to(dtype=torch.float16).mean()", "mean"),
    ("torch.matmul(x.half(), x)", "matmul"),
    ("x.bfloat16() @ x", "'@'"),
    ("torch.einsum('ij,jk->ik', x.bfloat16(), x)", "einsum"),
])
def test_rpl402_narrow_accumulation(tmp_path, expr, leaf):
    found = _lint(tmp_path, f"""
        import torch

        def f(x):
            return {expr}
    """)
    hits = _only(found, "RPL402")
    assert len(hits) == 1 and leaf in hits[0].message


def test_rpl402_wide_accumulator_is_clean(tmp_path):
    found = _lint(tmp_path, """
        import torch

        def f(x, a, b):
            s = torch.sum(x.to(torch.bfloat16), dtype=torch.float32)
            m = a.to(torch.bfloat16).float() @ b
            t = torch.sum(x.to(torch.float32))
            return s, m, t, x.to(torch.bfloat16)
    """)
    assert found == []


# =====================================================================
# RPL501 problem-hooks / RPL502 problem-metadata
# =====================================================================

_HEAD = "from repro_torch.core.problem import Problem, register\n"


def test_rpl501_missing_full_step(tmp_path):
    found = _lint(tmp_path, _HEAD + """
@register("fixture_a")
class A(Problem):
    def init_bundle(self, inputs, device):
        return None
""")
    hits = _only(found, "RPL501")
    assert len(hits) == 1 and "full_step" in hits[0].message


def test_rpl501_wrong_arity(tmp_path):
    found = _lint(tmp_path, _HEAD + """
@register("fixture_b")
class B(Problem):
    def init_bundle(self, inputs):
        return None

    def full_step(self, d, rep, axes, extra):
        return d, 0.0

    def batch_axes(self, n):
        return None
""")
    hits = _only(found, "RPL501")
    assert len(hits) == 3
    assert all("repro_torch/core/problem.py" in h.message for h in hits)


def test_rpl501_the_jax_signature_requires_mesh(tmp_path):
    found = _lint(tmp_path, _HEAD + """
@register("fixture_c")
class C(Problem):
    def init_bundle(self, inputs, mesh):
        return None

    def full_step(self, d, rep, axes):
        return d, 0.0
""")
    hits = _only(found, "RPL501")
    assert len(hits) == 1 and "requires 'mesh'" in hits[0].message
    assert hits[0].line == 5


def test_rpl501_conforming_and_foreign_classes_are_clean(tmp_path):
    found = _lint(tmp_path, _HEAD + """
from repro.core.problem import register as jax_register


@register("fixture_d")
class D(Problem):
    replicated_in_carry = True

    def init_bundle(self, inputs, device, mesh=None):
        return None

    def full_step(self, d, rep, axes):
        return d, 0.0

    def light_step(self, d, rep, axes):
        return d, 0.0

    def refresh_replicated(self, rep, out):
        return rep

    def finalize(self, bundle, log):
        return None, {}

    def batch_axes(self):
        return None


@jax_register("fixture_jax")
class JaxSide:
    def init_bundle(self, inputs, mesh):
        return None


class NotRegistered:
    def init_bundle(self):
        pass
""")
    assert found == [], [f.format() for f in found]


def test_rpl502_replicated_without_refresh(tmp_path):
    found = _lint(tmp_path, _HEAD + """
@register("fixture_e")
class E(Problem):
    replicated_in_carry = True

    def init_bundle(self, inputs, device):
        return None

    def full_step(self, d, rep, axes):
        return d, 0.0
""")
    msgs = " | ".join(h.message for h in _only(found, "RPL502"))
    assert len(_only(found, "RPL502")) == 2
    assert "refresh_replicated" in msgs and "light_step" in msgs


def test_rpl502_refresh_without_flag_and_chunk_without_cost(tmp_path):
    found = _lint(tmp_path, _HEAD + """
@register("fixture_f")
class F(Problem):
    default_cost_every = "chunk"

    def init_bundle(self, inputs, device):
        return None

    def full_step(self, d, rep, axes):
        return d, 0.0

    def refresh_replicated(self, rep, out):
        return rep
""")
    msgs = " | ".join(h.message for h in _only(found, "RPL502"))
    assert "dead wiring" in msgs and "cost_every='chunk'" in msgs


# =====================================================================
# RPL601 noncanonical-import
# =====================================================================

@pytest.mark.parametrize("line", [
    "from repro_torch.kernels.condat_elwise.kernel import require_cuda",
    "from repro_torch.kernels.starlet2d.ops import common",
    "from repro_torch.kernels.jacobi.kernel import library, check",
])
def test_rpl601_helper_through_a_family(tmp_path, line):
    found = _lint(tmp_path, line + "\n")
    hits = _only(found, "RPL601")
    assert len(hits) >= 1 and "repro_torch.kernels.common" in hits[0].message


def test_rpl601_canonical_imports_are_clean(tmp_path):
    found = _lint(tmp_path, """
        from repro_torch.kernels import common
        from repro_torch.kernels.common import on_card, require_cuda
        from repro_torch.kernels.dict_outer.kernel import dict_outer_fwd
        from repro_torch.kernels.jacobi import ops as jacobi_ops
    """)
    assert found == []


# =====================================================================
# RPL701 swallowed-exception
# =====================================================================

@pytest.mark.parametrize("name,handler,what", [
    ("repro_torch/core/loader.py", "except:\n        pass", "bare except"),
    ("repro_torch/checkpoint/writer.py",
     "except Exception as e:\n        print('failed', e)",
     "except Exception"),
    ("repro_torch/resilience/loop.py",
     "except (OSError, BaseException):\n        return None",
     "except BaseException"),
])
def test_rpl701_swallowed_in_scope(tmp_path, name, handler, what):
    found = _lint(tmp_path, f"""
def load(path):
    try:
        return open(path).read()
    {handler}
""", name=name)
    hits = _only(found, "RPL701")
    assert len(hits) == 1 and what in hits[0].message
    assert hits[0].line == 5


def test_rpl701_reraise_router_narrow_and_out_of_scope_are_clean(tmp_path):
    source = """
        from repro_torch.resilience.errors import classify

        def dispatch(self, fn):
            try:
                return fn()
            except Exception as e:
                if classify(e) != "transient":
                    raise
                self.retries += 1

        def background(self, fn):
            try:
                fn()
            except BaseException as e:
                self._record_failure(e)

        def parse(text):
            try:
                return int(text)
            except ValueError:
                return None
    """
    assert _lint(tmp_path, source, name="repro_torch/core/sup.py") == []
    swallow = """
        def probe():
            try:
                return _compile()
            except Exception:
                return None
    """
    # the port's other packages, and the JAX package's paths
    assert _lint(tmp_path, swallow, name="repro_torch/kernels/probe.py") == []
    assert _lint(tmp_path, swallow, name="repro/core/probe.py") == []


# =====================================================================
# RPL801 batch-axes
# =====================================================================

_TOY = _HEAD + """
@register("toy")
class Toy(Problem):
    def __init__(self, cfg=None, sigma=0.02, u0=None):
        self.cfg = cfg
        self.sigma = sigma
        self.u0 = u0
        self._cache = None

    def init_bundle(self, inputs, device, mesh=None):
        return build(inputs, self.cfg, noise=self.sigma, u0=self.u0,
                     helper=self.helper(), cache=self._cache)

    def helper(self):
        return 1

    def full_step(self, d, rep, axes):
        return d, {{"cost": 0.0}}
{batch_axes}
"""


def test_rpl801_undeclared_constructor_state(tmp_path):
    found = _lint(tmp_path, _TOY.format(batch_axes="""
    def batch_axes(self):
        from repro_torch.core.batching import BatchAxes
        return BatchAxes(record_axes=(0, 0), instance_invariant=("u0",))
"""))
    hits = _only(found, "RPL801")
    assert len(hits) == 1 and "self.sigma" in hits[0].message


def test_rpl801_missing_batch_axes(tmp_path):
    found = _lint(tmp_path, _TOY.format(batch_axes=""))
    hits = _only(found, "RPL801")
    assert len(hits) == 1 and "declares no batch_axes()" in hits[0].message
    assert "sigma, u0" in hits[0].message


def test_rpl801_declared_and_unregistered_are_clean(tmp_path):
    found = _lint(tmp_path, _TOY.format(batch_axes="""
    def batch_axes(self):
        shared = ("u0",) if self.cfg else ()
        return BatchAxes(record_axes=(0, 0), shared_in_batch=shared,
                         instance_invariant=("sigma",))
"""))
    assert _only(found, "RPL801") == []
    found = _lint(tmp_path, """
        class Helper:
            def __init__(self, sigma):
                self.sigma = sigma

            def init_bundle(self, inputs, device, mesh=None):
                return build(inputs, self.sigma)
    """)
    assert found == []


# =====================================================================
# RPL901 untracked-task
# =====================================================================

@pytest.mark.parametrize("body,what", [
    ("asyncio.create_task(self._watchdog())", "discards the task handle"),
    ("t = asyncio.ensure_future(self._watchdog())\n    return self",
     "'t'"),
])
def test_rpl901_dropped_handles(tmp_path, body, what):
    found = _lint(tmp_path, f"""
import asyncio


async def start(self):
    {body}
""", name="repro_torch/serve/svc.py")
    hits = _only(found, "RPL901")
    assert len(hits) == 1 and what in hits[0].message


def test_rpl901_tracked_and_out_of_scope_are_clean(tmp_path):
    tracked = """
        import asyncio

        async def start(self):
            self._watchdog_task = asyncio.create_task(self._watchdog())
            self._watchdog_task.add_done_callback(self._task_exc)

        async def probe(self, coros):
            t = asyncio.create_task(coros[0])
            await t
            rest = [asyncio.ensure_future(c) for c in coros[1:]]
            return await asyncio.gather(*rest)
    """
    assert _lint(tmp_path, tracked, name="repro_torch/serve/svc.py") == []
    bare = """
        import asyncio

        async def fire_and_forget(coro):
            asyncio.create_task(coro)
    """
    assert _lint(tmp_path, bare, name="repro_torch/core/loop.py") == []
    assert _lint(tmp_path, bare, name="repro/serve/svc.py") == []


# =====================================================================
# Suppressions, format, syntax errors
# =====================================================================

_SUPPRESSIBLE = _PROBLEM.format(body="s = x.sum().item(){comment}")


@pytest.mark.parametrize("comment,left", [
    ("  # repro-lint: disable=RPL302", 0),
    ("  # repro-lint: disable=host-sync", 0),
    ("  # repro-lint: disable=RPL301,RPL302 (the reason)", 0),
    ("  # repro-lint: disable=all", 0),
    ("  # repro-lint: disable=RPL999", 1),
])
def test_suppression_on_the_line(tmp_path, comment, left):
    found = _lint(tmp_path, _SUPPRESSIBLE.replace("{comment}", comment))
    assert len(_only(found, "RPL302")) == left


def test_suppression_file_wide(tmp_path):
    p = tmp_path / "mod.py"
    p.write_text("# repro-lint: disable-file=RPL302\n" + textwrap.dedent(
        _SUPPRESSIBLE.replace("{comment}", "")))
    assert lint_file(p) == []


def test_finding_format_is_path_line_col(tmp_path):
    found = _lint(tmp_path, "from repro_torch.kernels.x.ops import on_card\n")
    assert re.match(r"^.+mod\.py:1:0: RPL601\[noncanonical-import\] .+",
                    found[0].format())
    assert found[0].to_json()["rule"] == "RPL601"


def test_syntax_error_reported_not_raised(tmp_path):
    found = _lint(tmp_path, "def broken(:\n")
    assert [f.rule.id for f in found] == ["RPL000"]


# =====================================================================
# The command line and the rule table
# =====================================================================

def test_rule_ids_stable():
    assert {r.id: r.slug for r in all_rules()} == {
        "RPL102": "inplace-carry",
        "RPL203": "ref-parity",
        "RPL204": "kernel-fallback",
        "RPL301": "tensor-branch",
        "RPL302": "host-sync",
        "RPL401": "f64-dtype",
        "RPL402": "bf16-accum",
        "RPL501": "problem-hooks",
        "RPL502": "problem-metadata",
        "RPL601": "noncanonical-import",
        "RPL701": "swallowed-exception",
        "RPL801": "batch-axes",
        "RPL901": "untracked-task",
    }


def test_cli_exit_codes_and_report(tmp_path, capsys):
    dirty = tmp_path / "dirty.py"
    dirty.write_text("from repro_torch.kernels.x.kernel import check\n")
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    report = tmp_path / "report.json"
    assert lint_main([str(dirty), "--report", str(report)]) == 1
    out = capsys.readouterr().out
    assert "RPL601" in out and "1 finding" in out
    data = json.loads(report.read_text())
    assert data["files_checked"] == 1
    assert data["findings"][0]["rule"] == "RPL601"
    assert {r["id"] for r in data["rules"]} >= {"RPL102", "RPL302", "RPL601"}
    assert lint_main([str(clean)]) == 0
    assert lint_main([str(dirty), "-q"]) == 1
    assert "RPL601" not in capsys.readouterr().out.splitlines()[0]


def test_cli_select_and_usage_errors(tmp_path, capsys):
    dirty = tmp_path / "dirty.py"
    dirty.write_text("from repro_torch.kernels.x.kernel import check\n")
    assert lint_main([str(dirty), "--select", "RPL302"]) == 0
    assert lint_main([str(dirty), "--select", "noncanonical-import"]) == 1
    assert lint_main([str(dirty), "--select", "RPL999"]) == 2
    assert lint_main([str(tmp_path / "missing")]) == 2
    assert lint_main(["--no-such-flag"]) == 2
    assert lint_main(["--list-rules"]) == 0
    table = capsys.readouterr().out
    for rule in all_rules():
        assert rule.id in table and rule.slug in table


def test_module_entry_point(tmp_path, monkeypatch, capsys):
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    monkeypatch.setattr(sys, "argv", ["repro_torch.lint", str(clean)])
    with pytest.raises(SystemExit) as e:
        runpy.run_module("repro_torch.lint", run_name="__main__")
    assert e.value.code == 0
    assert "1 files checked, 0 findings" in capsys.readouterr().out


def test_default_paths_are_the_port_and_its_tests():
    paths = default_paths()
    assert paths[0] == PORT
    assert {p.name for p in paths[1:]} == \
        {p.name for p in (REPO / "tests").glob("test_torch_*.py")}
    assert Path(__file__).resolve() in paths


# =====================================================================
# Mutation tests on the port's real steps
# =====================================================================

def _copy(tmp_path, rel, old=None, new=None, name=None):
    src = (PORT / rel).read_text()
    if old is not None:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    dst = tmp_path / (name or Path(rel).name)
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.write_text(src)
    return dst


def test_the_real_steps_are_step_reachable():
    scdl = _reachable(PORT / "imaging" / "scdl.py")
    assert {"step", "cost", "refresh", "full_step", "light_step",
            "refresh_replicated", "_iterate", "_code_updates",
            "_dict_update", "update", "_cho_solve", "_solve_factor",
            "_ridge_solve", "_outer_products", "_nrmse"} <= scdl
    assert "init_dicts" not in scdl and "_atom_indices" not in scdl
    deconv = _reachable(PORT / "imaging" / "deconvolve.py")
    assert {"step", "cost", "_sparse_update", "_lowrank_update",
            "_nuclear"} <= deconv
    assert "build_bundle" not in deconv
    # across the package: the Condat pieces the deconvolution's steps call
    assert {"primal_update", "sparse_dual_update", "grad_from_HX",
            "data_cost_from"} <= _reachable(PORT / "imaging" / "condat.py")
    assert {"psum", "psum_tree"} <= _reachable(PORT / "core" / "compat.py")


@pytest.mark.parametrize("rel,old,new", [
    ("imaging/scdl.py", "torch.linalg.cholesky_ex(G).L",
     "torch.linalg.cholesky(G)"),
    ("imaging/deconvolve.py",
     '        data_part = data_cost_from(d["HX"], d["Y"])\n',
     '        data_part = data_cost_from(d["HX"], d["Y"])\n'
     '        data_part.item()\n'),
])
def test_mutation_a_sync_in_a_real_step_is_found(tmp_path, rel, old, new):
    assert lint_file(_copy(tmp_path / "clean", rel)) == []
    found = lint_file(_copy(tmp_path / "mutant", rel, old, new))
    assert [f.rule.id for f in found] == ["RPL302"], \
        [f.format() for f in found]
    line = next(i for i, s in enumerate(
        (tmp_path / "mutant" / Path(rel).name).read_text().splitlines(), 1)
        if new.strip().splitlines()[-1] in s)
    assert found[0].line == line


def test_mutation_across_the_package(tmp_path):
    """A sync put into a Condat piece that only the deconvolution's
    steps (another module) call is found, in a copy of the package."""
    pkg = tmp_path / "repro_torch"
    shutil.copytree(PORT, pkg, ignore=shutil.ignore_patterns(
        "csrc", "__pycache__"))
    target = pkg / "imaging" / "condat.py"
    assert lint_file(target) == []
    src = target.read_text()
    old = "    return condat_primal(X, U_adj, grad, tau)\n"
    assert src.count(old) == 1
    target.write_text(src.replace(old, "    tau = float(tau)\n" + old))
    found = lint_file(target)
    assert [f.rule.id for f in found] == ["RPL302"]
    assert "'primal_update'" in found[0].message


@pytest.mark.parametrize("rel,name", [("imaging/lowrank.py", "svt"),
                                      ("imaging/condat.py", "solve")])
def test_sequential_references_are_not_flagged(tmp_path, rel, name):
    """``lowrank.svt`` and ``condat.solve`` call ``torch.linalg`` on
    purpose; no step reaches them, alone or within the package."""
    assert name not in _reachable(PORT / rel)
    assert lint_file(PORT / rel) == []
    assert lint_file(_copy(tmp_path, rel)) == []


def test_rpl701_finds_the_checkpoint_writers_old_stash(tmp_path):
    rel = "checkpoint/checkpointer.py"
    fixed = _copy(tmp_path / "fixed", rel,
                  name="repro_torch/checkpoint/checkpointer.py")
    assert lint_file(fixed) == []
    old = _copy(tmp_path / "old", rel, "self._record_failure(e)",
                "self._error = e",
                name="repro_torch/checkpoint/checkpointer.py")
    found = lint_file(old)
    assert [f.rule.id for f in found] == ["RPL701"]
    assert "except BaseException" in found[0].message


# =====================================================================
# Acceptance: the port's tree lints clean
# =====================================================================

def test_repo_tree_lints_clean():
    findings = lint_paths([PORT, REPO / "tests"])
    assert findings == [], "\n".join(f.format() for f in findings)
