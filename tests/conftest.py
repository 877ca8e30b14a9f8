"""Shared fixtures. NOTE: no XLA_FLAGS here — tests see 1 CPU device;
multi-device behaviour is tested via subprocesses (test_distributed.py).

When ``hypothesis`` is unavailable (the TPU container doesn't ship it) a
deterministic stand-in is installed before test modules import it: every
``@given`` test runs over a small fixed sample drawn from each strategy's
bounds instead of being skipped at collection time."""
import sys

import jax
import pytest

try:
    import hypothesis  # noqa: F401
except ImportError:
    import itertools
    import types

    class _Strategy:
        def __init__(self, samples):
            self.samples = list(samples)

    def _integers(lo=0, hi=10):
        mid = (lo + hi) // 2
        vals = sorted({lo, mid, hi})
        return _Strategy(vals)

    def _floats(lo=0.0, hi=1.0, **_kw):
        return _Strategy([lo, (lo + hi) / 2.0, hi])

    def _booleans():
        return _Strategy([False, True])

    def _sampled_from(xs):
        return _Strategy(list(xs))

    def _given(**strategies):
        names = sorted(strategies)

        def deco(fn):
            grids = [strategies[n].samples for n in names]

            def wrapper(*args, **kw):
                for combo in itertools.product(*grids):
                    fn(*args, **dict(zip(names, combo)), **kw)

            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            return wrapper

        return deco

    class _Settings:
        def __init__(self, *a, **kw):
            pass

        def __call__(self, fn):
            return fn

        @staticmethod
        def register_profile(name, **kw):
            pass

        @staticmethod
        def load_profile(name):
            pass

    _mod = types.ModuleType("hypothesis")
    _mod.given = _given
    _mod.settings = _Settings
    _mod.assume = lambda cond: True
    _st = types.ModuleType("hypothesis.strategies")
    _st.integers = _integers
    _st.floats = _floats
    _st.booleans = _booleans
    _st.sampled_from = _sampled_from
    _mod.strategies = _st
    sys.modules["hypothesis"] = _mod
    sys.modules["hypothesis.strategies"] = _st


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (CUDA); skipped without one")


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)
