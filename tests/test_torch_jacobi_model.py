"""The numpy model of the Jacobi kernels (``tools/lowrank_model.py``)
against LAPACK, on the CPU.

The kernels (``src/repro_torch/csrc/jacobi.cu``, ``jacobi.cuh``) run only
on the card.  The model follows their design step for step: the
round-robin pairs, the rotation from two fp32 reciprocal-square-root
seeds (each taken 2 ulp off, the card's ``rsqrtf`` bound) refined by
one fp64 step, each step's rotations from one copy of the matrix
applied at once, the stopping tests and the sweeps ending after one that
rotated nothing.  So the arithmetic of the kernels is held here to
``chip_smoke.py`` phase 11's bounds, where there is no card: on
symmetric matrices, Grams of rank r and r / 2 and a cluster of equal
eigenvalues, and for the SVD also an exactly rank-deficient R^T (the
low-rank paths' case once their iterate's rank falls below r), at the
sides r = 3 (odd and tiny), 8, 24 (the low-rank paths'), 25 (odd) and 33
(odd, past the one-warp design):

- reconstruction and orthogonality within ``JACOBI_REC`` /
  ``JACOBI_ORTH`` r eps (fp32), the values within ``JACOBI_VALUES`` r eps
  of the largest from LAPACK's fp32 ones, the counts above the 1e-6 clip
  equal to LAPACK's (and to the rank where it is known), the order
  (ascending eigenvalues, descending singular values);
- the sweeps end before the kernels' limit, kMaxSweeps.
"""
import re
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import lowrank_model as lm  # noqa: E402
from chip_smoke import JACOBI_ORTH, JACOBI_REC, JACOBI_VALUES  # noqa: E402

RS = [3, 8, 24, 25, 33]
KINDS = ["symmetric", "gram rank r", "gram rank r/2", "cluster"]
CUH = ROOT / "src" / "repro_torch" / "csrc" / "jacobi.cuh"


def _case(r, kind):
    """(matrix, known rank or None), the same draw for every test."""
    if kind == "rank-deficient R^T":
        return lm.rank_deficient_rt(r, np.random.default_rng(r)), \
            r - r // 3
    for name, A, rank in lm.cases(r, np.random.default_rng(r)):
        if name == kind:
            return A, rank
    raise KeyError(kind)


def _within_bounds(e):
    return e["rec"] <= JACOBI_REC and e["orth"] <= JACOBI_ORTH \
        and e["values"] <= JACOBI_VALUES


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("r", RS)
def test_model_eigh_against_lapack(r, kind):
    A, rank = _case(r, kind)
    w, V, sweeps = lm.model_eigh(A)
    e = lm.eigh_errors(A, w, V)
    assert _within_bounds(e), e
    assert e["clip"][0] == e["clip"][1] and rank in (None, e["clip"][0])
    assert np.all(w[1:] >= w[:-1])
    assert sweeps < lm.MAX_SWEEPS
    # the eigvalsh form: the same values without the vectors
    np.testing.assert_array_equal(lm.model_eigh(A, want_v=False)[0], w)


@pytest.mark.parametrize("kind", KINDS + ["rank-deficient R^T"])
@pytest.mark.parametrize("r", RS)
def test_model_svd_against_lapack(r, kind):
    R, rank = _case(r, kind)
    U, s, Vh, sweeps = lm.model_svd(R)
    e = lm.svd_errors(R, U, s, Vh)
    assert _within_bounds(e), e
    assert e["rank"][0] == e["rank"][1] and rank in (None, e["rank"][0])
    assert np.all(s[1:] <= s[:-1])
    assert sweeps < lm.MAX_SWEEPS


def test_model_rotation_is_orthogonal_to_fp64_rounding():
    """c^2 + s^2 = 1 to a few fp64 ulps, t = s / c and the pivot zeroed,
    over pivots of every scale an fp32 input gives, with seeds 2 ulp
    off."""
    rng = np.random.default_rng(0)
    scale = 10.0 ** rng.integers(-30, 30, 4096)
    x, y, z = (rng.standard_normal(4096) * scale for _ in range(3))
    c, s, t = lm._rotation(x, y, z)
    on = t != 0
    assert on.mean() > 0.99
    np.testing.assert_allclose(c * c + s * s, 1.0, rtol=0, atol=8e-16)
    np.testing.assert_allclose(t[on], s[on] / c[on], rtol=1e-15)
    # the 2 x 2 pivot block J^T [[x, z], [z, y]] J has a zero off-diagonal
    off = c * s * (x - y) + (c * c - s * s) * z
    size = np.maximum(np.maximum(np.abs(x), np.abs(y)), np.abs(z))
    assert np.all(np.abs(off[on]) <= 1e-14 * size[on])


def test_model_constants_match_the_kernel_source():
    """The model's stopping constants are the kernels'."""
    src = CUH.read_text()
    assert int(re.search(r"kMaxSweeps = (\d+);", src)[1]) == lm.MAX_SWEEPS
    assert re.search(r"kTiny = 0x1p-(\d+);", src)[1] == "1000"
    assert lm.TINY == 2.0 ** -1000
    assert "kEps = FLT_EPSILON;" in src
    assert lm.EPS == float(np.finfo(np.float32).eps)
