"""The port's fused SCDL outer products against
``repro.kernels.dict_outer``.

On the CPU the port's wrappers take their plain versions (``ref.py``);
they are compared with JAX's Pallas kernels in interpret mode and with
JAX's oracles, at small K, block-aligned and not.  Both forms return
fp32 whatever the input dtype, as the JAX contract says.

Tolerances are ``tests/test_kernels.py``'s ``_do_tol``: fp32 rtol 1e-4
with atol K * 1e-6, bf16 rtol 2e-2 with atol K * 2e-3 (a sum over K of
products rounds with K).

The CUDA kernel computes fp32 products as three TF32 products on the
tensor cores (3xTF32) and caps the rows one accumulator sums
(``kernel.ACC_ROWS``).  The tensor cores run only on the card; the last
tests here hold the numerical scheme itself, emulated on the CPU, to the
same fp32 tolerance.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dict_outer.ops import dict_outer as jouter
from repro.kernels.dict_outer.ops import dict_outer_pair as jpair
from repro_torch.kernels import common
from repro_torch.kernels.dict_outer import kernel
from repro_torch.kernels.dict_outer.ops import dict_outer, dict_outer_pair
from repro_torch.kernels.dict_outer.ref import dict_outer_pair_ref

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _do_tol(dtype, K):
    return dict(rtol=2e-2, atol=K * 2e-3) if dtype == "bfloat16" else \
        dict(rtol=1e-4, atol=K * 1e-6)


def _draw(seed, shape, jdtype):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.asarray(jnp.asarray(a, jdtype), np.float32)


def _pair(seed, K, P, M, A, jdt):
    return [_draw(seed + i, shape, jdt)
            for i, shape in enumerate(((K, P), (K, M), (K, A), (K, A)))]


@pytest.mark.parametrize("case", [(130, 25, 64), (1000, 25, 64),
                                  (512, 9, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dict_outer_matches_jax(case, dtype):
    K, P, A = case
    jdt, tdt = DTYPES[dtype]
    S, W = _draw(1, (K, P), jdt), _draw(2, (K, A), jdt)
    sw, ww = dict_outer(torch.tensor(S, dtype=tdt),
                        torch.tensor(W, dtype=tdt))
    assert sw.dtype == ww.dtype == torch.float32
    assert tuple(sw.shape) == (P, A) and tuple(ww.shape) == (A, A)
    jsw, jww = jouter(jnp.asarray(S, jdt), jnp.asarray(W, jdt),
                      use_kernel=True, interpret=True)
    tol = _do_tol(dtype, K)
    np.testing.assert_allclose(sw.numpy(), np.asarray(jsw), **tol)
    np.testing.assert_allclose(ww.numpy(), np.asarray(jww), **tol)


@pytest.mark.parametrize("case", [(130, 25, 9, 128), (1000, 25, 9, 64),
                                  (1000, 289, 81, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dict_outer_pair_matches_jax(case, dtype):
    K, P, M, A = case
    jdt, tdt = DTYPES[dtype]
    ins = _pair(3, K, P, M, A, jdt)
    got = dict_outer_pair(*(torch.tensor(a, dtype=tdt) for a in ins))
    want = jpair(*(jnp.asarray(a, jdt) for a in ins), use_kernel=True,
                 interpret=True)
    shapes = [(P, A), (M, A), (A, A), (A, A)]
    tol = _do_tol(dtype, K)
    for g, w, shape in zip(got, want, shapes):
        assert g.dtype == torch.float32 and tuple(g.shape) == shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


def test_pair_equals_two_single_calls():
    ins = [torch.tensor(a) for a in _pair(9, 200, 25, 9, 32, jnp.float32)]
    ShWh, SlWl, ph, pl = dict_outer_pair(*ins)
    for got, want in zip((ShWh, ph, SlWl, pl),
                         (*dict_outer(ins[0], ins[2]),
                          *dict_outer(ins[1], ins[3]))):
        assert torch.equal(got, want)


def test_cpu_wrappers_launch_no_kernel_and_refuse_use_kernel():
    S, W = torch.zeros((6, 5)), torch.zeros((6, 4))
    before = (kernel.dict_outer_fwd.launches,
              kernel.dict_outer_pair_fwd.launches)
    dict_outer(S, W)
    dict_outer_pair(S, S, W, W)
    assert (kernel.dict_outer_fwd.launches,
            kernel.dict_outer_pair_fwd.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        dict_outer(S, W, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        dict_outer_pair(S, S, W, W, use_kernel=True)
    assert (kernel.dict_outer_fwd.launches,
            kernel.dict_outer_pair_fwd.launches) == before


def _tf32_rna(x):
    """fp32 -> TF32 as ``cvt.rna.tf32.f32`` rounds (to nearest, ties away
    from zero), on the bit pattern: add half a TF32 ulp (bit 12) to the
    magnitude bits and clear the 13 low bits that TF32 drops.  For finite
    inputs."""
    bits = x.to(torch.float32).view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    """The kernel's split of an fp32 operand: hi = tf32(x),
    lo = tf32(x - hi)."""
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x.to(torch.float32) - hi)


def _low_bits(t):
    return t.view(torch.int32) & 0x1FFF


@pytest.mark.parametrize("exponent", [-60, -8, 0, 8, 60])
@pytest.mark.parametrize("seed", [0, 1])
def test_tf32_split_gives_back_fp32(seed, exponent):
    """hi and lo are TF32 values (13 low bits clear) and hi + lo gives x
    back within 2^-22 relative: what the kernel's split keeps of each fp32
    operand.  The split runs in the kernel's registers only on the card;
    this is its bit-level emulation."""
    a = np.random.default_rng(seed).standard_normal(4096) * 2.0 ** exponent
    x = torch.tensor(a, dtype=torch.float32)
    hi, lo = _split(x)
    assert not bool(_low_bits(hi).any()) and not bool(_low_bits(lo).any())
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())


@pytest.mark.parametrize("x, want", [
    (1 + 2.0 ** -11, 1 + 2.0 ** -10),            # a tie: away from zero
    (-(1 + 2.0 ** -11), -(1 + 2.0 ** -10)),
    (1 + 2.0 ** -11 - 2.0 ** -23, 1.0),          # below the tie: down
    (3 * 2.0 ** -11, 3 * 2.0 ** -11),            # a TF32 value stays
])
def test_tf32_rna_rounds_to_nearest_ties_away(x, want):
    """The emulation rounds as ``cvt.rna`` does (the card's instruction
    itself runs only there)."""
    got = _tf32_rna(torch.tensor([x], dtype=torch.float32))
    assert float(got[0]) == want


@pytest.mark.parametrize("K, dtype", [(40_000, "float32"),
                                      (1001, "float32"),
                                      (1001, "bfloat16")])
def test_three_tf32_products_match_fp32(K, dtype):
    """hi^T hi + hi^T lo + lo^T hi, each product in fp64, matches the fp32
    plain version of the pair within the fp32 tolerance (rtol 1e-4, atol
    K * 1e-6) at P = 289, M = 81, A = 64: dropping lo^T lo and rounding lo
    to TF32 keeps fp32 accuracy.  bf16 values are TF32 values, so their lo
    is 0 and the kernel computes hi^T hi alone.  The tensor-core products
    themselves run only on the card."""
    jdt, tdt = DTYPES[dtype]
    ins = [torch.tensor(a, dtype=tdt) for a in _pair(21, K, 289, 81, 64, jdt)]
    want = dict_outer_pair_ref(*ins)
    Sh, Sl, Wh, Wl = (_split(t.float()) for t in ins)
    if dtype == "bfloat16":
        assert all(not bool(lo.any()) for _, lo in (Sh, Sl, Wh, Wl))

    def tf32x3(L, R):
        (Lh, Ll), (Rh, Rl) = ((a.double(), b.double()) for a, b in (L, R))
        return Lh.T @ Rh + Lh.T @ Rl + Ll.T @ Rh

    got = [tf32x3(L, R) for L, R in ((Sh, Wh), (Sl, Wl), (Wh, Wh), (Wl, Wl))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.double().numpy(),
                                   **_do_tol("float32", K))


def _rz_add(acc, s):
    """acc + s rounded toward zero to fp32 (acc fp32, s fp64)."""
    exact = acc.astype(np.float64) + s
    r = exact.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(exact)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def _kernel_fold_rows():
    """The rows of fp32 products one tensor-core accumulator sums in the
    kernel: kFold steps of 8 (csrc/dict_outer.cu)."""
    src = (common.CSRC / "dict_outer.cu").read_text()
    return 8 * int(re.search(r"constexpr int kFold = (\d+);", src).group(1))


@pytest.mark.parametrize("rows, fold, within", [
    (kernel.ACC_ROWS, kernel.ACC_ROWS, True),
    (40_000, 40_000, False),
    (40_000, _kernel_fold_rows(), True)])
def test_accumulator_cap_keeps_fp32_tolerance(rows, fold, within):
    """Why the kernel bounds the rows one tensor-core accumulator sums.  If
    the tensor core adds each 8-row MMA step into its fp32 accumulator
    rounding toward zero, the Gram diagonal of 40 000 rows (sums of
    squares, all of one sign) drifts past rtol 1e-4 in one accumulator.
    It stays well within it when slices of ``kernel.ACC_ROWS`` rows (the
    plan's cap, the longest sum of the kernel's bf16 path) are summed
    apart and their sums added with round-to-nearest, as the reduction
    pass does; and when, as in the kernel's fp32 path, every ``fold``
    rows go into a fresh accumulator whose sum is added to an fp32 one
    with round-to-nearest.  This emulates the worst case on the CPU; the
    tensor cores run only on the card."""
    K, A = 40_000, 64
    sq = np.random.default_rng(5).standard_normal((K, A)).astype(
        np.float32).astype(np.float64) ** 2
    total = np.zeros(A, np.float32)
    for k0 in range(0, K, rows):
        end = min(k0 + rows, K)
        acc = np.zeros(A, np.float32)
        for f0 in range(k0, end, fold):
            tc = np.zeros(A, np.float32)
            for k in range(f0, min(f0 + fold, end), 8):
                tc = _rz_add(tc, sq[k:min(k + 8, f0 + fold, end)].sum(0))
            acc = (acc + tc).astype(np.float32)
        total = (total + acc).astype(np.float32)
    rel = np.max(np.abs(total - sq.sum(0)) / sq.sum(0))
    assert (rel <= 1e-4) == within, rel
