"""The work counts behind the roofline shares: hand reckonings at the
cells' shapes, shapes alone as input, and the three peaks."""
import ast
import inspect
import math

import pytest

from portbench import harness, peaks
from portbench.work import galaxy_deconv, scdl_sr

DECONV = {"n": 10000, "stamp": 41, "n_scales": 4, "grid": 81}
SCDL = {"K": 40000, "p_dim": 289, "m_dim": 81, "n_atoms": 512}


def test_galaxy_deconv_by_hand():
    w = galaxy_deconv.per_iteration(DECONV)
    # Y, PSF, X read and written, U (4 planes) read and written: 12
    # planes of 41 x 41, and 4 weights a stamp, 4 bytes each
    assert w["bytes"] == 4 * 10000 * (12 * 1681 + 4) == 807_040_000
    fft = 2.5 * 6561 * math.log2(6561)                  # one real 81 x 81 FFT
    per_stamp = (4 * fft                                # two convolutions
                 + 2 * 6 * 81 * 41                      # two spectral products
                 + 4 * 19 * 1681                        # Phi: 4 smoothings + diff
                 + (7 * 18 + 8) * 1681                  # Phi^T, Horner
                 + 30 * 1681)                           # primal, dual, residual
    assert w["flops"] == pytest.approx(10000 * per_stamp, rel=1e-12)
    assert w["matmul_flops"] == 0
    # bound by its bytes
    assert peaks.least_seconds(w) == pytest.approx(807_040_000 / 3.35e12)


def test_scdl_sr_by_hand():
    w = scdl_sr.per_iteration(SCDL)
    K, P, M, A = 40000, 289, 81, 512
    # patches read, five K x A planes read and written, the dictionaries
    assert w["bytes"] == 4 * (K * (P + M) + 10 * K * A + 2 * A * (P + M))
    assert w["bytes"] == 879_915_520
    ridge = 2 * K * A * (P + A) + 6 * K * M * A     # dense for P, thin for M
    outer = 2 * K * P * A + 2 * K * M * A + 2 * K * A * A
    small = 2 * sum(A ** 3 / 3 + 2 * A * A * d for d in (P, M))
    assert w["matmul_flops"] == pytest.approx(ridge + outer + small, rel=1e-12)
    assert w["matmul_flops"] == pytest.approx(79.456e9, rel=1e-3)
    assert w["flops"] == 24 * K * A
    # bound by its bytes
    assert peaks.least_seconds(w) == pytest.approx(879_915_520 / 3.35e12)


@pytest.mark.parametrize("mod,shapes", [(galaxy_deconv, DECONV),
                                        (scdl_sr, SCDL)])
def test_counts_read_shapes_alone(mod, shapes, monkeypatch):
    """A count takes the shapes and nothing else: it imports nothing of
    the port or of torch, and swapping the port's kernels for their
    plain versions cannot move it."""
    tree = ast.parse(inspect.getsource(mod))
    imported = {a.name.split(".")[0] for n in ast.walk(tree)
                if isinstance(n, ast.Import) for a in n.names}
    imported |= {n.module.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module}
    assert imported <= {"__future__", "math"}
    assert list(inspect.signature(mod.per_iteration).parameters) == ["shapes"]
    first = mod.per_iteration(dict(shapes))
    import repro_torch.kernels.common as common
    monkeypatch.setattr(common, "resolve_device", lambda *a, **k: "cpu",
                        raising=False)
    assert mod.per_iteration(dict(shapes)) == first


def test_each_config_has_its_count():
    for c in harness.benchmark()["configs"]:
        assert callable(harness.work(c["name"]).per_iteration)


def test_share_uses_the_three_peaks():
    one = 1e12
    assert peaks.HBM_BYTES_PER_S == 3.35e12
    assert peaks.MATMUL_FLOPS_PER_S == 495e12
    assert peaks.FP32_FLOPS_PER_S == 67e12
    by_bytes = {"bytes": 3.35 * one, "matmul_flops": 0.0, "flops": 0.0}
    by_mm = {"bytes": 0.0, "matmul_flops": 495 * one, "flops": 0.0}
    by_fp = {"bytes": 0.0, "matmul_flops": 0.0, "flops": 67 * one}
    for w in (by_bytes, by_mm, by_fp):
        assert peaks.least_seconds(w) == pytest.approx(1.0)
        assert peaks.roofline_percent(w, 2.0) == pytest.approx(50.0)
    mixed = {"bytes": 3.35 * one, "matmul_flops": 990 * one, "flops": 0.0}
    assert peaks.least_seconds(mixed) == pytest.approx(2.0)
    assert peaks.roofline_percent(mixed, 0) is None
