#!/usr/bin/env python3
"""CPU models of the low-rank paths, for the questions a run on the card
cannot answer alone.

    PYTHONPATH=src python3 tools/lowrank_model.py jacobi
    PYTHONPATH=src python3 tools/lowrank_model.py completion [n p r iters]
    PYTHONPATH=src python3 tools/lowrank_model.py rankdef [iters]
    PYTHONPATH=src python3 tools/lowrank_model.py parity

``jacobi``: a numpy model of the Jacobi kernels (``csrc/jacobi.cu``,
``jacobi.cuh``): the same round-robin pairs, the rotation from two fp32
reciprocal-square-root seeds (here each 2 ulp off, the card's ``rsqrtf``
bound) refined by one fp64 step, each step's rotations from one copy of
the matrix applied at once (eigh with the pivot blocks from the
rotation's own formulas), the same stopping tests and the sweeps ending
after one that rotated nothing; fp64 from an fp32 input to fp32
outputs, with numpy's rounding instead of the card's fused
multiply-adds.  Runs ``chip_smoke.py`` phase 11's cases at its sides
(r = 3, 24, 25, 32, 33, 40, 64) and an exactly rank-deficient R^T, and
prints each one's sweeps and phase 11's measures against LAPACK's fp32
factorizations: reconstruction, orthogonality and values in r eps, and
the counts above the clip.  ``tests/test_torch_jacobi_model.py`` holds
the model to phase 11's bounds.

``completion``: the completion workload (proximal gradient with the
randomized SVT) on ``chip_smoke.py`` phase 14's data (a rank-4 matrix
from seeded Gaussian factors, 60 % observed; default (10 000, 1681),
r = 24, 36 iterations), three ways on the CPU: the JAX package's
``solve("lowrank")``, the port's in fp32, and the port's step in fp64
(``chip_smoke.completion_fp64``), each with the JAX package's test matrix
(``PRNGKey(7)``) and then with the port's (a torch generator seeded 7);
prints each cost trajectory, its least, and the final relative errors.
Needs JAX; the other commands do not import it.

``rankdef``: the port's completion at phase 14's r = 64 on the CPU
(default 14 iterations), each iteration's r x r R^T fed to the fp64 SVD
model with and without its test for negligible columns; prints the least
singular value, the sweeps and the values' distance from fp64.  Once the
iterate's rank falls below r, R^T is exactly rank-deficient and without
the test the sweeps run to their limit.

``parity``: the port's completion at phase 14's (1024, 128) card-against-
CPU shape, 24 iterations, three ways on the CPU: the plain route (LAPACK)
with all threads and with one, and with the Jacobi model in place of
the two small factorizations; prints each trajectory's largest relative
distance from the first and from the fp64 trajectory of the same
algebra, the spread that phase 14's check must hold.

Runs on the CPU only.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

F32 = np.float32
EPS = float(np.finfo(np.float32).eps)
MAX_SWEEPS = 30
# kTiny in csrc/jacobi.cuh
TINY = 2.0 ** -1000


def _pairs(step, m):
    """The m / 2 disjoint pairs (p < q) of one round-robin step
    (``pair_of`` in csrc/jacobi.cuh), as two index arrays."""
    k = np.arange(m // 2)
    a = np.where(k == 0, m - 1, (step + k) % (m - 1))
    b = np.where(k == 0, step, (step - k + m - 1) % (m - 1))
    return np.minimum(a, b), np.maximum(a, b)


def _rsqrt(w):
    """``rsqrt_refined``: an fp32 seed, here 2 ulp above the rounded
    value (the card's ``rsqrtf`` is within 2 ulp), and one fp64 step of
    y (1 - e)^(-1/2) cut after e^2."""
    y = (F32(1) / np.sqrt(w.astype(F32))).astype(F32)
    y = np.nextafter(np.nextafter(y, F32(np.inf)), F32(np.inf))
    y = y.astype(np.float64)
    e = 1.0 - w * (y * y)
    return y + (y * e) * (0.5 + 0.375 * e)


def _rotation(x, y, z):
    """(c, s, t) of ``rotation`` in csrc/jacobi.cuh for arrays of pivots:
    the identity (1, 0, 0) where |z| <= eps sqrt(|x| |y|) (tested
    squared), else d and z scaled by the power of two that brings
    max(|d|, 2|z|) into [1, 2), h = sqrt(d^2 + 4z^2) and rho =
    rsqrt(2 h (|d| + h)) from the seeded reciprocal square roots."""
    on = (z * z > EPS * EPS * np.abs(x) * np.abs(y)) & (np.abs(z) > TINY)
    d = y - x
    big = np.where(on, np.maximum(np.abs(d), 2.0 * np.abs(z)), 1.0)
    scale = np.ldexp(1.0, 1 - np.frexp(big)[1])
    dn = np.abs(d) * scale
    zn = np.where(np.signbit(d), -z, z) * scale
    with np.errstate(all="ignore"):
        u = dn * dn + 4.0 * zn * zn
        h = u * _rsqrt(u)
        g = dn + h
        rho = _rsqrt(2.0 * h * g)
        return (np.where(on, g * rho, 1.0), np.where(on, 2.0 * zn * rho, 0.0),
                np.where(on, 4.0 * zn * h * (rho * rho), 0.0))


def _step_rotation(m, P, Q, c, s):
    """The step's rotations as one m x m matrix J (A <- J^T A J, V <- V J)."""
    J = np.eye(m)
    J[P, P], J[Q, Q], J[P, Q], J[Q, P] = c, c, s, -s
    return J


def model_eigh(A, want_v=True):
    """(w ascending, V, sweeps) as the kernel computes them: fp64 from
    the fp32 input, M = r rounded up to even with a zero row and column
    for odd r; each step's rotations from the pivots of one copy of A,
    applied at once as J^T A J with the pivot blocks from the rotation's
    own formulas; the sweeps end after one that rotated nothing.  The
    outputs rounded to fp32; numpy's rounding stands in for the card's
    fused multiply-adds."""
    r = A.shape[0]
    m = r + (r & 1)
    a = A.astype(F32).astype(np.float64)
    A = np.zeros((m, m))
    A[:r, :r] = (a + a.T) * 0.5
    V = np.eye(r, m)
    sweep, more = 0, True
    while more and sweep < MAX_SWEEPS:
        more = False
        for step in range(m - 1):
            P, Q = _pairs(step, m)
            x, y, z = A[P, P], A[Q, Q], A[P, Q]
            c, s, t = _rotation(x, y, z)
            if not t.any():
                continue
            more = True
            J = _step_rotation(m, P, Q, c, s)
            A = np.triu(J.T @ A @ J)
            A = A + np.triu(A, 1).T
            on = t != 0
            A[P[on], P[on]] = x[on] - t[on] * z[on]
            A[Q[on], Q[on]] = y[on] + t[on] * z[on]
            A[P[on], Q[on]] = A[Q[on], P[on]] = 0.0
            if want_v:
                V = V @ J
        sweep += 1
    w = np.diag(A)[:r].copy()
    order = np.argsort(w, kind="stable")
    return w[order].astype(F32), V[:, order].astype(F32), sweep


def model_svd(R, floor=True):
    """(U, s descending, Vh, sweeps) as the kernel computes them, in
    fp64 as :func:`model_eigh`: each step's pairs from the 2 x 2 Grams of
    their columns; ``floor=False`` drops the kernel's test that leaves a
    column under eps ||R||_F alone."""
    r = R.shape[0]
    m = r + (r & 1)
    G, W = np.zeros((r, m)), np.eye(r, m)
    G[:, :r] = R.astype(F32)
    negligible = EPS * EPS * (G * G).sum()
    sweep, more = 0, True
    while more and sweep < MAX_SWEEPS:
        more = False
        for step in range(m - 1):
            P, Q = _pairs(step, m)
            alpha = (G[:, P] * G[:, P]).sum(0)
            beta = (G[:, Q] * G[:, Q]).sum(0)
            gamma = (G[:, P] * G[:, Q]).sum(0)
            c, s, t = _rotation(alpha, beta, gamma)
            if floor:
                keep = np.minimum(alpha, beta) > negligible
                c, s, t = np.where(keep, c, 1.0), np.where(keep, s, 0.0), \
                    np.where(keep, t, 0.0)
            if not t.any():
                continue
            more = True
            J = _step_rotation(m, P, Q, c, s)
            G, W = G @ J, W @ J
        sweep += 1
    S = np.sqrt((G[:, :r] * G[:, :r]).sum(0))
    order = np.argsort(-S, kind="stable")
    with np.errstate(all="ignore"):
        U = np.where(S > 0, G[:, :r] / np.where(S > 0, S, 1), 0)
    return (U[:, order].astype(F32), S[order].astype(F32),
            W[:, :r][:, order].T.astype(F32), sweep)


def cases(r, rng):
    """chip_smoke.py phase 11's kinds of matrix: (name, A, rank or None)."""
    x = rng.standard_normal((r, r))
    yield "symmetric", ((x + x.T) / 2).astype(F32), None
    y = rng.standard_normal((4 * r, r)).astype(F32)
    yield "gram rank r", y.T @ y, r
    y = (rng.standard_normal((4 * r, r // 2))
         @ rng.standard_normal((r // 2, r))).astype(F32)
    yield "gram rank r/2", y.T @ y, r // 2
    q = np.linalg.qr(rng.standard_normal((r, r)))[0]
    lam = np.concatenate([np.full(r // 3, 2.0),
                          rng.standard_normal(r - r // 3)])
    yield "cluster", ((q * lam) @ q.T).astype(F32), None


def rank_deficient_rt(r, rng):
    """R^T as the low-rank paths hand it to the SVD once their iterate's
    rank falls below r: lower triangular (the transpose of a QR's R) with
    its last r / 3 columns exactly zero."""
    rt = np.tril(rng.standard_normal((r, r))).astype(F32)
    rt[:, r - r // 3:] = 0
    return rt


def eigh_errors(A, w, V):
    """Phase 11's measures of an eigendecomposition of fp32 A against
    LAPACK's fp32 one, reconstruction and orthogonality in r eps, the
    values in r eps of the largest, and the counts above the 1e-6 clip."""
    r = A.shape[0]
    A64, w64, V64 = (x.astype(np.float64) for x in (A, w, V))
    ref = np.linalg.eigvalsh(A)
    return {"rec": np.linalg.norm(A64 - (V64 * w64) @ V64.T)
            / np.linalg.norm(A64) / (r * EPS),
            "orth": np.linalg.norm(V64.T @ V64 - np.eye(r)) / (r * EPS),
            "values": np.abs(w64 - ref).max()
            / (r * EPS * np.abs(ref).max()),
            "clip": (int((w > 1e-6 * w.max()).sum()),
                     int((ref > 1e-6 * ref.max()).sum()))}


def svd_errors(R, U, s, Vh):
    """The same for an SVD: U's orthogonality on the columns whose
    singular value exceeds 1e-3 of the largest, the counts above 1e-6 of
    the largest."""
    r = R.shape[0]
    R64, U64, s64, Vh64 = (x.astype(np.float64) for x in (R, U, s, Vh))
    ref = np.linalg.svd(R, compute_uv=False)
    big = U64[:, s > 1e-3 * s[0]]
    return {"rec": np.linalg.norm(R64 - (U64 * s64) @ Vh64)
            / np.linalg.norm(R64) / (r * EPS),
            "orth": max(np.linalg.norm(Vh64 @ Vh64.T - np.eye(r)),
                        np.linalg.norm(big.T @ big - np.eye(big.shape[1])))
            / (r * EPS),
            "values": np.abs(s64 - ref).max() / (r * EPS * ref[0]),
            "rank": (int((s > 1e-6 * s[0]).sum()),
                     int((ref > 1e-6 * ref[0]).sum()))}


def jacobi():
    rng = np.random.default_rng(0)
    for r in (3, 24, 25, 32, 33, 40, 64):
        kinds = [(name, A) for name, A, _ in cases(r, rng)]
        for name, A in kinds + [("rank-deficient R^T",
                                 rank_deficient_rt(r, rng))]:
            line = f"r={r} {name}:"
            if name != "rank-deficient R^T":
                w, V, sweeps = model_eigh(A)
                e = eigh_errors(A, w, V)
                line += (f" eigh {sweeps} sweeps, reconstruction "
                         f"{e['rec']:.3f}, orthogonality {e['orth']:.3f}, "
                         f"values {e['values']:.3f} (r eps), above the clip "
                         f"{e['clip'][0]}/{e['clip'][1]};")
            U, s, Vh, sweeps = model_svd(A)
            e = svd_errors(A, U, s, Vh)
            print(f"{line} svd {sweeps} sweeps, reconstruction "
                  f"{e['rec']:.3f}, orthogonality {e['orth']:.3f}, values "
                  f"{e['values']:.3f} (r eps), rank {e['rank'][0]}/"
                  f"{e['rank'][1]}")


def completion(n=10_000, p=1681, r=24, iters=36):
    import jax.numpy as jnp
    import torch

    from chip_smoke import completion_data, completion_fp64
    from repro.core.problem import solve as jsolve
    from repro.imaging import lowrank as jlr
    from repro_torch.core.problem import solve
    from repro_torch.imaging import lowrank
    A, M = completion_data(torch, n, p, 31, "cpu")
    cfg = lowrank.CompletionConfig(rank=12, oversample=r - 12, lam=0.2,
                                   step=0.9, max_iter=iters)
    jcfg = jlr.CompletionConfig(rank=12, oversample=r - 12, lam=0.2,
                                step=0.9, max_iter=iters)
    a = A.numpy()
    masked = np.linalg.norm(M.numpy() * a - a) / np.linalg.norm(a)
    print(f"({n}, {p}) r={r}: relative error of the masked input "
          f"{masked:.4f}")
    draws = (("the JAX package's", np.asarray(jlr.make_test_matrix(
                  p, 12, r - 12))),
             ("the port's", lowrank.make_test_matrix(p, 12, r - 12).numpy()))
    draw_jax = jlr.make_test_matrix
    for which, omega in draws:
        # the JAX problem draws its own test matrix; hand it this one
        jlr.make_test_matrix = lambda *args, key=None: jnp.asarray(omega)
        try:
            ref = jsolve("lowrank", jnp.asarray(a), jnp.asarray(M.numpy()),
                         cfg=jcfg, tol=0, chunk=iters, cost_every=1)
        finally:
            jlr.make_test_matrix = draw_jax
        port = solve(lowrank.LowRankCompletionProblem(cfg, omega=omega), A,
                     M, device="cpu", tol=0, chunk=iters, cost_every=1)
        exact = completion_fp64(torch, cfg, A, M, iters, omega=omega)
        for name, costs, x in (
                ("repro (JAX), fp32", ref.log.costs, np.asarray(ref.x)),
                ("repro_torch, fp32", port.log.costs, port.x),
                ("repro_torch's step, fp64", exact, None)):
            costs = [float(c) for c in costs]
            err = "" if x is None else \
                f"; relative error {np.linalg.norm(x - a) / np.linalg.norm(a):.4f}"
            print(f"{which} test matrix, {name}: costs "
                  f"{[round(c, 1) for c in costs]}; least at iteration "
                  f"{int(np.argmin(costs)) + 1}{err}")


def rankdef(iters=14):
    import torch

    from chip_smoke import completion_data
    from repro_torch.core.problem import solve
    from repro_torch.imaging.lowrank import CompletionConfig
    from repro_torch.kernels.jacobi import ops
    A, M = completion_data(torch, 10_000, 1681, 31, "cpu")
    cfg = CompletionConfig(rank=12, oversample=52, lam=0.2, step=0.9)
    seen, plain = [], ops.svd

    def svd(R, *, use_kernel=None):
        seen.append(R.clone())
        return plain(R)

    ops.svd = svd
    try:
        solve("lowrank", A, M, cfg=cfg, device="cpu", max_iter=iters,
              chunk=iters, cost_every="chunk", tol=0.0)
    finally:
        ops.svd = plain
    for i, R in enumerate(seen):
        R = R.numpy()
        s64 = np.linalg.svd(R.astype(np.float64), compute_uv=False)
        runs = []
        for floor in (False, True):
            _, s, _, sweeps = model_svd(R, floor=floor)
            runs.append(f"{sweeps} sweeps, values off fp64 by "
                        f"{np.abs(s - s64).max() / (EPS * s64[0]):.2f} eps")
        print(f"iteration {i + 1}: least singular value "
              f"{s64[-1] / s64[0]:.1e} of the largest; without the floor "
              f"{runs[0]}; with it {runs[1]}")


def parity():
    import torch

    from chip_smoke import completion_data, completion_fp64
    from repro_torch.core.problem import solve
    from repro_torch.imaging.lowrank import CompletionConfig
    from repro_torch.kernels.jacobi import ops
    A, M = completion_data(torch, 1024, 128, 37, "cpu")
    cfg = CompletionConfig(rank=12, oversample=12, lam=0.2, step=0.9)

    def run():
        return np.asarray(solve("lowrank", A, M, cfg=cfg, device="cpu",
                                max_iter=24, chunk=8, cost_every=1,
                                tol=0.0).log.costs)

    def with_model():
        def eigh(G, *, compute_v=True, use_kernel=None):
            w, V, _ = model_eigh(G.numpy(), want_v=compute_v)
            return (torch.tensor(w), torch.tensor(V)) if compute_v \
                else torch.tensor(w)

        def svd(R, *, use_kernel=None):
            U, s, Vh, _ = model_svd(R.contiguous().numpy())
            return torch.tensor(U), torch.tensor(s), torch.tensor(Vh)

        saved = ops.eigh, ops.svd
        ops.eigh, ops.svd = eigh, svd
        try:
            return run()
        finally:
            ops.eigh, ops.svd = saved

    def dist(c, ref):
        return np.max(np.abs(c - ref) / np.abs(ref))

    plain = run()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    one = run()
    torch.set_num_threads(threads)
    exact = completion_fp64(torch, cfg, A, M, 24)
    print(f"{threads} threads: largest relative distance from the fp64 "
          f"trajectory {dist(plain, exact):.3e}")
    for name, c in (("one thread", one), ("Jacobi model", with_model())):
        print(f"{name}: largest relative cost gap to {threads} threads "
              f"{dist(c, plain):.3e}, distance from the fp64 trajectory "
              f"{dist(c, exact):.3e}")


if __name__ == "__main__":
    what, args = sys.argv[1], [int(a) for a in sys.argv[2:]]
    {"jacobi": jacobi, "completion": completion, "rankdef": rankdef,
     "parity": parity}[what](
        *args)
