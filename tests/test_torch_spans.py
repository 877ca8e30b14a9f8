"""The port's profiler spans (``repro_torch.core.spans``).

Under ``torch.profiler.profile`` a small sparse deconvolution and a
small SCDL training record the spans of ``core.spans``' docstring, each
inside the span that calls it, siblings disjoint, one ``driver.launch``
and one ``driver.sync`` a chunk (supervised too).  The profiler changes
no result, and with none running no ``record_function`` is made."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.problem import solve
from repro_torch.core.spans import PREFIX
from repro_torch.data.synthetic import coupled_patches
from repro_torch.imaging import psf, starlet
from repro_torch.imaging.condat import SolverConfig
from repro_torch.imaging.scdl import SCDLConfig
from repro_torch.resilience.recovery import ResilienceConfig

torch.set_num_threads(2)

ITERS, CHUNK = 12, 4
CHUNKS = ITERS // CHUNK
# each span's caller, by name
PARENT = {"solve": None, "solve.init": "solve", "solve.run": "solve",
          "solve.finalize": "solve", "deconvolve.draws": "solve.init",
          "deconvolve.norms": "solve.init", "driver.launch": "solve.run",
          "driver.sync": "solve.run"}


def _deconvolve(**kw):
    d = psf.simulate(24, stamp=15, device="cpu")
    # the memoized starlet norm is drawn and iterated on its first call,
    # and the PSF's kept start vectors are drawn on theirs
    starlet._spectral_norm_default.cache_clear()
    psf._default_starts.clear()
    sol = solve("deconvolve", d.Y, d.psfs, cfg=SolverConfig(n_scales=3),
                device="cpu", max_iter=ITERS, chunk=CHUNK, tol=0.0, **kw)
    return sol.x, sol.log.costs


def _scdl(**kw):
    S_h, S_l = coupled_patches(128, 25, 9, 16, device="cpu")
    sol = solve("scdl", S_h, S_l, cfg=SCDLConfig(n_atoms=16), device="cpu",
                max_iter=ITERS, chunk=CHUNK, tol=0.0, **kw)
    return sol.x, sol.log.costs


RUNS = {"deconvolve": _deconvolve, "scdl": _scdl}


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
    _scdl(resilience=ResilienceConfig())
    assert made == []
    # the count sees the spans when a profiler records
    _profiled(_scdl)
    assert PREFIX + "driver.launch" in made
