"""The PSF convolution's kernel family (``kernels/psf_conv``).

On the CPU: the dispatch rule (CPU and ``meta`` tensors take the plain
version; ``use_kernel=True`` on the CPU raises), the wrapper's checks of
shapes, grid and dtypes, and the plain version against the operator's
``torch.fft`` code as it stood before the kernel (``_before_*`` below),
bit for bit, including the gradient's fused ``Ht(HX - Y)``.

On the card (marker ``card``; skipped without CUDA): the kernel against
the plain version for H, Ht, the gradient and the pair, at S = 41 on the
81-point grid, S = 32 (grid 64) and S = 17 (grid 36), with a PSF smaller
than the stamp, bucket axes, one stamp, an odd count and bfloat16
operands.  fp32 tolerance: 2e-6 of the largest entry, since the kernel
sums its butterflies in another order than cuFFT (a host build of the
kernel's templates reads at most 4.6e-7 against pocketfft over every
grid); bfloat16: 1e-2, one rounding of the result to 8 bits.  Also: a
batch is bit-identical to its single calls, and a sparse solve launches
the kernel 2T + 60 + 2 times, with ``torch.fft`` only for the set-up's
one spectrum.  On the card, without the repository's conftest (it
imports JAX, which that machine lacks):

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_psf_conv.py
"""
import numpy as np
import pytest
import torch

from repro_torch.imaging import psf
from repro_torch.imaging.condat import SolverConfig, grad_from_HX
from repro_torch.kernels.psf_conv import ops
from repro_torch.kernels.psf_conv.kernel import GRIDS, psf_conv_fwd

torch.set_num_threads(2)


def _before_convolve_f(x, kf, adjoint=False):
    """``psf.convolve_f`` before the kernel."""
    s = x.shape[-1]
    pad = kf.shape[-2]
    xr = x if x.is_floating_point() and x.element_size() >= 4 \
        else x.to(torch.float32)
    xf = torch.fft.rfft2(xr, s=(pad, pad))
    if adjoint:
        kf = torch.conj(kf)
    out = torch.fft.irfft2(xf * kf, s=(pad, pad))
    return out[..., :s, :s].to(x.dtype).contiguous()


def _before_conv_pair_f(A, B, kf_pair):
    """``psf.conv_pair_f`` before the kernel."""
    s = A.shape[-1]
    pad = kf_pair.shape[-2]

    def real(x):
        return x if x.is_floating_point() and x.element_size() >= 4 \
            else x.to(torch.float32)

    z = torch.stack([real(A), real(B)], dim=-3)
    zf = torch.fft.rfft2(z, s=(pad, pad))
    out = torch.fft.irfft2(zf * kf_pair, s=(pad, pad))[..., :s, :s]
    return (out[..., 0, :, :].to(A.dtype).contiguous(),
            out[..., 1, :, :].to(B.dtype).contiguous())


def _inputs(lead, stamp, kernel=None, seed=0, device="cpu",
            dtype=torch.float32):
    """Stamps X and Y of shape lead + (S, S) and the carried spectrum
    pair of PSFs ``kernel`` wide, all from one seed."""
    rng = np.random.default_rng(seed)
    kernel = kernel or stamp
    X = torch.tensor(rng.standard_normal(lead + (stamp, stamp)),
                     dtype=torch.float32)
    Y = torch.tensor(rng.standard_normal(lead + (stamp, stamp)),
                     dtype=torch.float32)
    p = torch.tensor(rng.random(lead + (kernel, kernel)), dtype=torch.float32)
    p = p / p.sum(dim=(-2, -1), keepdim=True)
    kf = psf.psf_fft_pair(p, psf.pad_for(stamp, kernel))
    return (X.to(device, dtype), Y.to(device, dtype), kf.to(device))


# --------------------------------------------------------------- CPU

def test_cpu_and_meta_take_the_plain_version():
    X, Y, kf = _inputs((3,), 9)
    before = psf_conv_fwd.launches
    assert torch.equal(ops.convolve(X, kf[:, 0]),
                       ops.convolve(X, kf[:, 0], use_kernel=False))
    for got, want in zip(ops.convolve_pair(X, Y, kf),
                         ops.convolve_pair(X, Y, kf, use_kernel=False)):
        assert torch.equal(got, want)
    meta = ops.convolve(X.to("meta"), kf[:, 1].to("meta"), minus=Y.to("meta"))
    assert meta.device.type == "meta" and meta.shape == X.shape
    ma, mb = ops.convolve_pair(X.to("meta"), Y.to("meta"), kf.to("meta"))
    assert ma.shape == mb.shape == X.shape
    assert psf_conv_fwd.launches == before


@pytest.mark.parametrize("form", ["convolve", "grad", "pair"])
def test_use_kernel_on_cpu_raises(form):
    X, Y, kf = _inputs((2,), 9)
    with pytest.raises(ValueError, match="expects CUDA tensors"):
        if form == "pair":
            ops.convolve_pair(X, Y, kf, use_kernel=True)
        else:
            ops.convolve(X, kf[:, 1], minus=Y if form == "grad" else None,
                         use_kernel=True)


def _spec(n, g, h=None, dtype=torch.complex64):
    return torch.zeros((n, g, h or g // 2 + 1), dtype=dtype)


@pytest.mark.parametrize("case, match", [
    ("grid not 5-smooth", "no kernel instance for the grid 7"),
    ("grid above the largest", "no kernel instance for the grid 135"),
    ("stamp wider than the grid", "stamps of 9 x 9 on a grid of 8"),
    ("no half spectrum", "no half spectra"),
    ("complex128 spectra", "complex64"),
    ("float64 stamps", "expects float32 operands"),
    ("spectra per stamp", "3 spectra for 2 stamps"),
    ("stamps not square", "expects \\(n, S, S\\) stamps"),
])
def test_checks_raise_on_what_the_kernel_refuses(case, match):
    x = torch.zeros((2, 9, 9))
    spec = {"grid not 5-smooth": _spec(2, 7),
            "grid above the largest": _spec(2, 135),
            "stamp wider than the grid": _spec(2, 8),
            "no half spectrum": _spec(2, 18, 18),
            "complex128 spectra": _spec(
                2, 18, dtype=torch.complex128),  # repro-lint: disable=RPL401 (a refused dtype)
            "spectra per stamp": _spec(3, 18)}.get(case, _spec(2, 18))
    if case == "float64 stamps":
        x = x.double()  # repro-lint: disable=RPL401 (a refused dtype)
    if case == "stamps not square":
        x = torch.zeros((2, 9, 8))
    with pytest.raises(ValueError, match=match):
        psf_conv_fwd((x,), spec, (False,))


def test_wrapper_checks_raise_before_any_device_check():
    X, Y, kf = _inputs((2, 3), 9)
    with pytest.raises(ValueError, match="leading shape"):
        ops.convolve(X, kf[:1, :, 0], use_kernel=True)
    with pytest.raises(ValueError, match="minus of shape"):
        ops.convolve(X, kf[..., 1, :, :], minus=Y[:1], use_kernel=True)
    with pytest.raises(ValueError, match="a pair of shapes"):
        ops.convolve_pair(X, Y[:1], kf, use_kernel=True)
    with pytest.raises(ValueError, match="a pair of shapes"):
        ops.convolve_pair(X, Y, kf[..., :1, :, :], use_kernel=True)
    with pytest.raises(ValueError, match="operand shapes differ"):
        psf_conv_fwd((X[0], Y[0, :1]), kf[0, :, 0], (False, True))


def test_grids_with_an_instance_cover_the_paths():
    assert psf.pad_for(41) == 81 and 81 in GRIDS
    for stamp in range(1, 65):
        for kernel in range(1, stamp + 1):
            assert psf.pad_for(stamp, kernel) in GRIDS, (stamp, kernel)


@pytest.mark.parametrize("lead, stamp, kernel, dtype", [
    ((5,), 17, 17, torch.float32), ((2, 3), 13, 13, torch.float32),
    ((4,), 21, 9, torch.float32), ((3,), 9, 9, torch.bfloat16),
    ((1,), 41, 41, torch.float32)])
def test_plain_version_is_the_operator_before_the_kernel(lead, stamp, kernel,
                                                        dtype):
    X, Y, kf = _inputs(lead, stamp, kernel, seed=stamp, dtype=dtype)
    k0, k1 = kf[..., 0, :, :], kf[..., 1, :, :]
    assert torch.equal(psf.convolve_f(X, k0), _before_convolve_f(X, k0))
    assert torch.equal(psf.convolve_f(X, k0, adjoint=True),
                       _before_convolve_f(X, k0, adjoint=True))
    assert torch.equal(psf.H_fp(X, kf), _before_convolve_f(X, k0))
    assert torch.equal(psf.Ht_fp(Y, kf), _before_convolve_f(Y, k1))
    for got, want in zip(psf.conv_pair_f(X, Y, kf),
                         _before_conv_pair_f(X, Y, kf)):
        assert got.dtype == want.dtype == dtype
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_gradient_plain_form_is_Ht_of_the_difference(dtype):
    HX, Y, kf = _inputs((2, 4), 13, seed=5, dtype=dtype)
    want = psf.Ht_fp(HX - Y, kf)
    assert torch.equal(psf.Ht_fp_diff(HX, Y, kf), want)
    assert torch.equal(grad_from_HX(HX, Y, kf), want)
    assert torch.equal(ops.convolve(HX, kf[..., 1, :, :], minus=Y), want)


def _before_power_norm(u, v, kf_pair, iters):
    """``psf._power_norm`` before the kernel."""
    nrm0 = torch.sqrt(torch.sum(u ** 2) + torch.sum(v ** 2))
    u, v = u / nrm0, v / nrm0
    nrm = None
    for _ in range(iters):
        Hu, Htv = _before_conv_pair_f(u, v, kf_pair)
        nrm = torch.sqrt(torch.sum(Htv ** 2) + torch.sum(Hu ** 2)) + 1e-12
        u, v = Htv / nrm, Hu / nrm
    return nrm


def test_power_step_plain_form_is_the_iteration_before_the_kernel():
    U, V, kf = _inputs((6,), 17, seed=9)
    scale = torch.tensor(2.5)
    Hu, Htv, sq_hu, sq_htv = ops.power_step(U, V, kf, scale)
    want = _before_conv_pair_f(U / scale, V / scale, kf)
    assert torch.equal(Hu, want[0]) and torch.equal(Htv, want[1])
    assert torch.equal(sq_hu, torch.sum(want[0] ** 2))
    assert torch.equal(sq_htv, torch.sum(want[1] ** 2))
    for iters in (1, 7):
        assert torch.equal(psf._power_norm(U, V, kf, iters),
                           _before_power_norm(U, V, kf, iters))


# -------------------------------------------------------------- card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda")


def _close(got, want, dtype):
    frac = 2e-6 if dtype == torch.float32 else 1e-2
    assert got.dtype == want.dtype and got.shape == want.shape
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= frac * scale, (err, scale)


@pytest.mark.card
@pytest.mark.parametrize("lead, stamp, kernel, dtype", [
    ((300,), 41, 41, torch.float32),
    ((257,), 32, 32, torch.float32),
    ((129,), 17, 17, torch.float32),
    ((64,), 41, 21, torch.float32),
    ((3, 50), 41, 41, torch.float32),
    ((1,), 41, 41, torch.float32),
    ((77,), 41, 41, torch.bfloat16),
    ((2, 9), 17, 17, torch.bfloat16)])
def test_kernel_matches_plain_version(card, lead, stamp, kernel, dtype):
    X, Y, kf = _inputs(lead, stamp, kernel, seed=stamp + len(lead),
                       device=card, dtype=dtype)
    k0, k1 = kf[..., 0, :, :], kf[..., 1, :, :]
    _close(ops.convolve(X, k0), ops.convolve(X, k0, use_kernel=False), dtype)
    _close(ops.convolve(Y, k1), ops.convolve(Y, k1, use_kernel=False), dtype)
    _close(ops.convolve(X, k0, conj=True),
           ops.convolve(X, k0, conj=True, use_kernel=False), dtype)
    _close(ops.convolve(X, k1, minus=Y),
           ops.convolve(X, k1, minus=Y, use_kernel=False), dtype)
    for got, want in zip(ops.convolve_pair(X, Y, kf),
                         ops.convolve_pair(X, Y, kf, use_kernel=False)):
        _close(got, want, dtype)
    # one spectrum for every stamp, and a lazily conjugated one
    _close(ops.convolve(X, k0[(0,) * len(lead)]),
           ops.convolve(X, k0[(0,) * len(lead)], use_kernel=False), dtype)
    _close(ops.convolve(X, torch.conj(k0)),
           ops.convolve(X, torch.conj(k0), use_kernel=False), dtype)
    if dtype == torch.float32:
        # the power step: the norm divides as the operands are read; the
        # sums of squares add each stamp's in another order (2e-6)
        scale = torch.tensor(1.7, device=card)
        got = ops.power_step(X, Y, kf, scale)
        want = ops.power_step(X, Y, kf, scale, use_kernel=False)
        for a, b in zip(got[:2], want[:2]):
            _close(a, b, dtype)
        for a, b in zip(got[2:], want[2:]):
            assert float(abs(a - b)) <= 2e-6 * float(b), (a, b)
    torch.cuda.synchronize()


@pytest.mark.card
def test_batch_is_bit_identical_to_its_single_calls(card):
    X, Y, kf = _inputs((4, 33), 41, seed=3, device=card)
    k1 = kf[..., 1, :, :]
    a, b = ops.convolve_pair(X, Y, kf)
    g = ops.convolve(X, k1, minus=Y)
    for i in range(4):
        ai, bi = ops.convolve_pair(X[i], Y[i], kf[i])
        assert torch.equal(a[i], ai) and torch.equal(b[i], bi)
        assert torch.equal(g[i], ops.convolve(X[i], k1[i], minus=Y[i]))
        assert torch.equal(a[i, 5:6], psf.H_fp(X[i, 5:6], kf[i, 5:6]))
    # the pair's adjoint conjugates the forward slab on the fly: the
    # same numbers as reading the carried conjugate
    assert torch.equal(a, psf.H_fp(X, kf))
    assert torch.equal(b, psf.Ht_fp(Y, kf))
    # the power step's outputs and each stamp's sums of squares
    scale = torch.tensor(0.75, device=card)
    p = ops.power_step(X, Y, kf, scale)
    for i in range(4):
        pi = ops.power_step(X[i], Y[i], kf[i], scale)
        assert torch.equal(p[0][i], pi[0]) and torch.equal(p[1][i], pi[1])
    xs = (X.reshape(-1, 41, 41), Y.reshape(-1, 41, 41))
    spec = kf[..., 0, :, :].reshape((-1,) + tuple(kf.shape[-2:]))
    whole = psf_conv_fwd(xs, spec, (False, True), scale=scale)
    one = psf_conv_fwd(tuple(x[40:41] for x in xs), spec[40:41],
                       (False, True), scale=scale)
    assert torch.equal(whole[2][:, 40:41], one[2])
    assert torch.equal(whole[0][40:41], one[0])


@pytest.mark.card
def test_sparse_solve_launches_the_kernel_for_every_convolution(card,
                                                                monkeypatch):
    from repro_torch.core.problem import solve
    data = psf.simulate(256, stamp=41, device=card)
    torch.cuda.synchronize()
    ffts = {"rfft2": 0, "irfft2": 0}
    for name in ffts:
        real = getattr(torch.fft, name)

        def counted(*a, _real=real, _name=name, **kw):
            ffts[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(torch.fft, name, counted)
    n0 = (psf_conv_fwd.launches, psf_conv_fwd.launches_pair,
          psf_conv_fwd.launches_grad)
    T = 24
    sol = solve("deconvolve", data.Y, data.psfs,
                cfg=SolverConfig(mode="sparse", n_scales=4), max_iter=T,
                chunk=12, cost_every="chunk", tol=0.0)
    torch.cuda.synchronize()
    assert sol.log.iters_run == T
    launches = psf_conv_fwd.launches - n0[0]
    # an iteration's Ht(HX - Y) and H(X_new), the 60 power steps, and
    # the set-up's X0 = Ht(Y) and H(X0)
    assert launches == 2 * T + 60 + 2, launches
    assert psf_conv_fwd.launches_pair - n0[1] == 60
    assert psf_conv_fwd.launches_grad - n0[2] == T
    # torch.fft only builds the spectrum, once
    assert ffts == {"rfft2": 1, "irfft2": 0}, ffts
