"""The port's fused SCDL outer products against
``repro.kernels.dict_outer``.

On the CPU the port's wrappers take their plain versions (``ref.py``);
they are compared with JAX's Pallas kernels in interpret mode and with
JAX's oracles, at small K, block-aligned and not.  Both forms return
fp32 whatever the input dtype, as the JAX contract says.

Tolerances are ``tests/test_kernels.py``'s ``_do_tol``: fp32 rtol 1e-4
with atol K * 1e-6, bf16 rtol 2e-2 with atol K * 2e-3 (a sum over K of
products rounds with K).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dict_outer.ops import dict_outer as jouter
from repro.kernels.dict_outer.ops import dict_outer_pair as jpair
from repro_torch.kernels.dict_outer import kernel
from repro_torch.kernels.dict_outer.ops import dict_outer, dict_outer_pair

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
