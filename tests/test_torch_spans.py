"""The port's profiler spans (``repro_torch.core.spans``).

Under ``torch.profiler.profile`` a small sparse deconvolution, a small
low-rank one, a small completion and a small SCDL training record the
spans of ``core.spans``' docstring, each inside the span that calls it,
siblings disjoint, one ``driver.launch`` and one ``driver.sync`` a chunk
(supervised too, and for a ``solve_many`` bucket), one ``lowrank.svt``
an iteration and one ``lowrank.nuclear`` a chunk, and in the completion
one ``completion.grad`` an iteration and one ``completion.draws`` when
no test matrix is injected.  The profiler changes no result, and with
none running no ``record_function`` is made."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.problem import solve, solve_many
from repro_torch.core.spans import PREFIX
from repro_torch.data.synthetic import coupled_patches
from repro_torch.imaging import psf, starlet
from repro_torch.imaging.condat import SolverConfig
from repro_torch.imaging.deconvolve import DeconvolutionProblem
from repro_torch.imaging.lowrank import (CompletionConfig,
                                         LowRankCompletionProblem)
from repro_torch.imaging.scdl import SCDLConfig
from repro_torch.resilience.recovery import ResilienceConfig

torch.set_num_threads(2)

ITERS, CHUNK = 12, 4
CHUNKS = ITERS // CHUNK
# each span's caller, by name
PARENT = {"solve": None, "solve.init": "solve", "solve.run": "solve",
          "solve.finalize": "solve", "deconvolve.draws": "solve.init",
          "deconvolve.norms": "solve.init", "driver.launch": "solve.run",
          "driver.sync": "solve.run", "lowrank.svt": "driver.launch",
          "lowrank.nuclear": "driver.launch",
          "completion.draws": "solve.init",
          "completion.grad": "driver.launch"}


def _deconvolve(**kw):
    d = psf.simulate(24, stamp=15, device="cpu")
    # the memoized starlet norm is drawn and iterated on its first call,
    # and the PSF's kept start vectors are drawn on theirs
    starlet._spectral_norm_default.cache_clear()
    psf._default_starts.clear()
    sol = solve("deconvolve", d.Y, d.psfs, cfg=SolverConfig(n_scales=3),
                device="cpu", max_iter=ITERS, chunk=CHUNK, tol=0.0, **kw)
    return sol.x, sol.log.costs


def _lowrank(omega=None, **kw):
    d = psf.simulate(24, stamp=15, device="cpu")
    psf._default_starts.clear()
    problem = DeconvolutionProblem(SolverConfig(mode="lowrank", lam=0.05,
                                                rank=4), omega=omega)
    sol = solve(problem, d.Y, d.psfs, device="cpu", max_iter=ITERS,
                chunk=CHUNK, tol=0.0, cost_every="chunk", **kw)
    return sol.x, sol.log.costs


def _scdl(**kw):
    S_h, S_l = coupled_patches(128, 25, 9, 16, device="cpu")
    sol = solve("scdl", S_h, S_l, cfg=SCDLConfig(n_atoms=16), device="cpu",
                max_iter=ITERS, chunk=CHUNK, tol=0.0, **kw)
    return sol.x, sol.log.costs


def _completion(omega=None, **kw):
    g = torch.Generator().manual_seed(3)
    A = torch.randn((40, 2), generator=g) @ torch.randn((2, 30), generator=g)
    M = (torch.rand((40, 30), generator=g) < 0.6).float()
    problem = LowRankCompletionProblem(
        CompletionConfig(rank=4, oversample=4, lam=0.2, step=0.9),
        omega=omega)
    sol = solve(problem, A * M, M, device="cpu", max_iter=ITERS,
                chunk=CHUNK, tol=0.0, cost_every="chunk", **kw)
    return sol.x, sol.log.costs


RUNS = {"deconvolve": _deconvolve, "lowrank": _lowrank, "scdl": _scdl,
        "completion": _completion}


def _profiled(run, **kw):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run(**kw)
    spans = [(e.name[len(PREFIX):], e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name.startswith(PREFIX)]
    return out, sorted(spans, key=lambda s: (s[1], -s[2]))


@pytest.fixture(scope="module")
def profiled():
    """``(kind, supervised) -> (result, spans)``, each profiled once
    (reading a deconvolution's events takes seconds)."""
    done = {}

    def get(kind, supervised=False):
        if (kind, supervised) not in done:
            kw = {"resilience": ResilienceConfig()} if supervised else {}
            done[kind, supervised] = _profiled(RUNS[kind], **kw)
        return done[kind, supervised]

    return get


def _innermost_caller(spans, i):
    """The shortest other span that holds span ``i``."""
    name, a, b = spans[i]
    around = [s for j, s in enumerate(spans)
              if j != i and s[1] <= a and b <= s[2]]
    return min(around, key=lambda s: s[2] - s[1])[0] if around else None


@pytest.mark.parametrize("supervised", [False, True],
                         ids=["plain", "supervised"])
@pytest.mark.parametrize("kind", sorted(RUNS))
def test_spans_nest_as_the_call_stack(profiled, kind, supervised):
    _, spans = profiled(kind, supervised)
    names = [s[0] for s in spans]
    assert set(names) <= set(PARENT), names
    for i, (name, a, b) in enumerate(spans):
        assert a <= b
        assert _innermost_caller(spans, i) == PARENT[name], (name, spans)
    # siblings (the spans of one caller) never overlap
    for parent in set(PARENT.values()):
        kids = sorted((a, b) for i, (n, a, b) in enumerate(spans)
                      if PARENT[n] == parent and
                      _innermost_caller(spans, i) == parent)
        assert all(b0 <= a1 for (_, b0), (a1, _) in zip(kids, kids[1:]))
    for name in ("solve", "solve.init", "solve.run", "solve.finalize"):
        assert names.count(name) == 1, name
    assert names.count("driver.launch") == CHUNKS
    assert names.count("driver.sync") == CHUNKS
    if kind == "deconvolve":
        # the PSF's start vectors, the Monte-Carlo noise and the
        # starlet's start vector; the PSF's and the starlet's norms
        assert names.count("deconvolve.draws") == 3
        assert names.count("deconvolve.norms") == 2
    elif kind == "lowrank":
        # the PSF's start vectors and the test matrix; the PSF's norm;
        # an SVT an iteration, a nuclear norm a chunk (cost_every="chunk")
        assert names.count("deconvolve.draws") == 2
        assert names.count("deconvolve.norms") == 1
        assert names.count("lowrank.svt") == ITERS
        assert names.count("lowrank.nuclear") == CHUNKS
        assert "completion.grad" not in names
    elif kind == "completion":
        # the test matrix; a masked step and an SVT an iteration, a
        # nuclear norm a chunk (cost_every="chunk")
        assert names.count("completion.draws") == 1
        assert names.count("completion.grad") == ITERS
        assert names.count("lowrank.svt") == ITERS
        assert names.count("lowrank.nuclear") == CHUNKS
        assert "deconvolve.draws" not in names
    else:
        assert "deconvolve.draws" not in names
        assert "deconvolve.norms" not in names


@pytest.mark.parametrize("kind", sorted(RUNS))
def test_profiler_changes_no_result(profiled, kind):
    x0, c0 = RUNS[kind]()
    (x1, c1), _ = profiled(kind)
    for a, b in zip(x0 if isinstance(x0, tuple) else (x0,),
                    x1 if isinstance(x1, tuple) else (x1,)):
        np.testing.assert_array_equal(a, b)
    assert c0 == c1


def test_no_record_function_without_a_profiler(monkeypatch):
    made = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        made.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    _deconvolve()
    _lowrank()
    _completion()
    _scdl(resilience=ResilienceConfig())
    assert made == []
    # the count sees the spans when a profiler records
    _profiled(_scdl)
    assert PREFIX + "driver.launch" in made


def test_lowrank_spans_per_chunk(profiled):
    """Each chunk's launch holds its iterations' SVTs and, at its end,
    the chunk's one nuclear norm."""
    _, spans = profiled("lowrank")
    launches = [(a, b) for n, a, b in spans if n == "driver.launch"]
    assert len(launches) == CHUNKS
    for a, b in launches:
        inside = [n for n, s0, s1 in spans if a <= s0 and s1 <= b]
        assert inside.count("lowrank.svt") == CHUNK
        assert inside.count("lowrank.nuclear") == 1


def test_completion_spans_per_iteration(profiled):
    """Each chunk's launch holds its iterations' masked steps, each
    followed by its SVT, and at its end the chunk's one nuclear norm."""
    _, spans = profiled("completion")
    launches = [(a, b) for n, a, b in spans if n == "driver.launch"]
    assert len(launches) == CHUNKS
    for a, b in launches:
        inside = [n for n, s0, s1 in spans
                  if a <= s0 and s1 <= b and n != "driver.launch"]
        assert inside == ["completion.grad", "lowrank.svt"] * CHUNK + [
            "lowrank.nuclear"]


@pytest.mark.parametrize("supervised", [False, True],
                         ids=["plain", "supervised"])
def test_bucket_spans_per_chunk(supervised):
    """A ``solve_many`` bucket runs the same chunk loop: each chunk is
    one ``driver.launch`` followed by one ``driver.sync``."""
    insts = []
    for seed in (0, 1):
        d = psf.simulate(4, torch.Generator().manual_seed(seed), stamp=15,
                         device="cpu")
        insts.append((d.Y, d.psfs))
    kw = {"resilience": ResilienceConfig()} if supervised else {}

    def run():
        return solve_many("deconvolve", insts, cfg=SolverConfig(n_scales=3),
                          device="cpu", max_iter=ITERS, chunk=CHUNK,
                          tol=0.0, **kw)

    sols, spans = _profiled(run)
    assert [s.log.iters_run for s in sols] == [ITERS, ITERS]
    loop = [n for n, _, _ in spans if n in ("driver.launch", "driver.sync")]
    assert loop == ["driver.launch", "driver.sync"] * CHUNKS


def test_injected_test_matrix_is_no_draw():
    """The test matrix is drawn under ``deconvolve.draws`` only when the
    caller injects none; injected, the draws are the PSF's alone, and
    the result is the one of the default draw."""
    from repro_torch.imaging import lowrank
    omega = lowrank.make_test_matrix(15 * 15, 4)
    (x0, c0), default = _profiled(_lowrank)
    (x1, c1), injected = _profiled(_lowrank, omega=omega)
    names = [s[0] for s in injected]
    assert names.count("deconvolve.draws") == 1
    assert [s[0] for s in default].count("deconvolve.draws") == 2
    np.testing.assert_array_equal(x0, x1)
    assert c0 == c1


def test_completion_injected_test_matrix_is_no_draw():
    """The completion's test matrix is drawn under ``completion.draws``
    only when the caller injects none; injected, nothing is drawn, and
    the result is the one of the default draw."""
    from repro_torch.imaging import lowrank
    omega = lowrank.make_test_matrix(30, 4, 4)
    (x0, c0), default = _profiled(_completion)
    (x1, c1), injected = _profiled(_completion, omega=omega)
    assert [s[0] for s in default].count("completion.draws") == 1
    assert "completion.draws" not in [s[0] for s in injected]
    np.testing.assert_array_equal(x0, x1)
    assert c0 == c1
