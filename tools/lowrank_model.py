#!/usr/bin/env python3
"""CPU models of the low-rank paths, for the questions a run on the card
cannot answer alone.

    PYTHONPATH=src python3 tools/lowrank_model.py jacobi
    PYTHONPATH=src python3 tools/lowrank_model.py completion [n p r iters]
    PYTHONPATH=src python3 tools/lowrank_model.py rankdef [iters]
    PYTHONPATH=src python3 tools/lowrank_model.py parity

``jacobi``: a numpy model of ``csrc/jacobi.cu`` (the same round-robin
pairs, rotation formula, pivot update and stopping test, in fp64 from an
fp32 input to fp32 outputs, with numpy's rounding instead of the card's
fused multiply-adds; and the same in fp32, the kernels' first form) on
``chip_smoke.py`` phase 11's cases at r = 24, 40, 64; prints each case's
sweeps, reconstruction and orthogonality in units of r eps, the values'
distance from fp64 in eps of the largest (beside LAPACK's in fp32), and
the count above the solver's 1e-6 clip beside LAPACK's.

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
CPU shape, 24 iterations, four ways on the CPU: the plain route (LAPACK)
with all threads and with one, and with the Jacobi model (fp64, and the
fp32 form) in place of the two small factorizations; prints each trajectory's largest relative
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


def _pairs(step, m):
    """The m / 2 disjoint pairs of one round-robin step (csrc/jacobi.cu)."""
    out = []
    for k in range(m // 2):
        a, b = (m - 1, step) if k == 0 else \
            ((step + k) % (m - 1), (step - k + m - 1) % (m - 1))
        out.append((min(a, b), max(a, b)))
    return out


def _tan(x, y, z):
    dt = type(x)
    if not z * z > dt(EPS) * dt(EPS) * abs(x) * abs(y):
        return dt(0)
    d = y - x
    return dt(np.copysign(1, d)) * (dt(2) * z) / (
        abs(d) + np.sqrt(d * d + dt(4) * z * z))


def model_eigh(A, want_v=True, dt=np.float64):
    """(w ascending, V, sweeps) as the kernel computes them: in ``dt``
    (the kernel's fp64; np.float32 models its first, all-fp32 form), the
    outputs rounded to fp32."""
    r = A.shape[0]
    A = A.astype(F32).astype(dt)
    A = (A + A.T) * dt(0.5)
    V = np.eye(r, dtype=dt)
    m = r + (r & 1)
    sweep = 0
    while sweep < MAX_SWEEPS:
        rots = []
        for step in range(m - 1):
            step_rots = []
            for p, q in _pairs(step, m):
                if q < r:
                    t = _tan(A[p, p], A[q, q], A[p, q])
                    if t != 0:
                        step_rots.append((p, q, t, A[p, p], A[q, q], A[p, q]))
            for p, q, t, *_ in step_rots:
                c = dt(1) / np.sqrt(dt(1) + t * t)
                s = t * c
                ap, aq = A[p].copy(), A[q].copy()
                A[p], A[q] = c * ap - s * aq, s * ap + c * aq
            for p, q, t, app, aqq, apq in step_rots:
                c = dt(1) / np.sqrt(dt(1) + t * t)
                s = t * c
                ap, aq = A[:, p].copy(), A[:, q].copy()
                A[:, p], A[:, q] = c * ap - s * aq, s * ap + c * aq
                A[p, q] = A[q, p] = 0
                A[p, p], A[q, q] = app - t * apq, aqq + t * apq
                if want_v:
                    vp, vq = V[:, p].copy(), V[:, q].copy()
                    V[:, p], V[:, q] = c * vp - s * vq, s * vp + c * vq
            rots += step_rots
        sweep += 1
        if not rots:
            break
    w = np.diag(A).copy()
    order = np.argsort(w, kind="stable")
    return w[order].astype(F32), V[:, order].astype(F32), sweep


def model_svd(R, dt=np.float64, floor=True):
    """(U, s descending, Vh, sweeps) as the kernel computes them, in
    ``dt`` as :func:`model_eigh`; ``floor=False`` drops the kernel's
    test that leaves a column under eps ||R||_F alone."""
    r = R.shape[0]
    G, W = R.astype(F32).astype(dt), np.eye(r, dtype=dt)
    negligible = dt(EPS) * dt(EPS) * (G * G).sum(dtype=dt)
    m = r + (r & 1)
    sweep = 0
    while sweep < MAX_SWEEPS:
        rotated = False
        for step in range(m - 1):
            for p, q in _pairs(step, m):
                if q >= r:
                    continue
                alpha, beta = dt(G[:, p] @ G[:, p]), dt(G[:, q] @ G[:, q])
                if floor and not min(alpha, beta) > negligible:
                    continue
                t = _tan(alpha, beta, dt(G[:, p] @ G[:, q]))
                if t == 0:
                    continue
                c = dt(1) / np.sqrt(dt(1) + t * t)
                s = t * c
                for M in (G, W):
                    mp, mq = M[:, p].copy(), M[:, q].copy()
                    M[:, p], M[:, q] = c * mp - s * mq, s * mp + c * mq
                rotated = True
        sweep += 1
        if not rotated:
            break
    S = np.sqrt((G * G).sum(0, dtype=dt))
    order = np.argsort(-S, kind="stable")
    U = np.where(S > 0, G / np.where(S > 0, S, 1), 0)
    return (U[:, order].astype(F32), S[order].astype(F32),
            W[:, order].T.astype(F32), sweep)


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


def jacobi():
    rng = np.random.default_rng(0)
    for r in (24, 40, 64):
        for name, A, rank in cases(r, rng):
            A64 = A.astype(np.float64)
            w64 = np.linalg.eigvalsh(A64)
            s64 = np.linalg.svd(A64, compute_uv=False)
            clip64 = int((w64 > 1e-6 * w64.max()).sum())
            lapack = (np.abs(np.linalg.eigvalsh(A) - w64).max(),
                      np.abs(np.linalg.svd(A, compute_uv=False) - s64).max())
            print(f"r={r} {name}: LAPACK fp32 values off fp64 by "
                  f"{lapack[0] / (EPS * np.abs(w64).max()):.2f} / "
                  f"{lapack[1] / (EPS * s64.max()):.2f} eps (eigh / svd, of "
                  f"the largest)")
            for dt in (np.float64, np.float32):
                w, V, sw = model_eigh(A, dt=dt)
                U, s, Vh, sw2 = model_svd(A, dt=dt)
                rec = np.linalg.norm(A64 - (V * w) @ V.T) / \
                    np.linalg.norm(A64)
                orth = np.linalg.norm(V.T.astype(np.float64) @ V - np.eye(r))
                srec = np.linalg.norm(A64 - (U * s) @ Vh) / \
                    np.linalg.norm(A64)
                clip = int((w > 1e-6 * w.max()).sum())
                print(f"  model in {np.dtype(dt).name}: eigh {sw} sweeps, "
                      f"reconstruction {rec / (r * EPS):.2f} r eps, "
                      f"orthogonality {orth / (r * EPS):.2f} r eps, values "
                      f"off fp64 by {np.abs(w - w64).max() / (EPS * np.abs(w64).max()):.2f}"
                      f" eps, above the clip {clip}/{clip64} (expected "
                      f"{rank}); svd {sw2} sweeps, reconstruction "
                      f"{srec / (r * EPS):.2f} r eps, values off fp64 by "
                      f"{np.abs(s - s64).max() / (EPS * s64.max()):.2f} eps")


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

    def with_model(dt):
        def eigh(G, *, compute_v=True, use_kernel=None):
            w, V, _ = model_eigh(G.numpy(), want_v=compute_v, dt=dt)
            return (torch.tensor(w), torch.tensor(V)) if compute_v \
                else torch.tensor(w)

        def svd(R, *, use_kernel=None):
            U, s, Vh, _ = model_svd(R.contiguous().numpy(), dt=dt)
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
    for name, c in (("one thread", one),
                    ("Jacobi model in fp64", with_model(np.float64)),
                    ("Jacobi model in fp32", with_model(np.float32))):
        print(f"{name}: largest relative cost gap to {threads} threads "
              f"{dist(c, plain):.3e}, distance from the fp64 trajectory "
              f"{dist(c, exact):.3e}")


if __name__ == "__main__":
    what, args = sys.argv[1], [int(a) for a in sys.argv[2:]]
    {"jacobi": jacobi, "completion": completion, "rankdef": rankdef,
     "parity": parity}[what](
        *args)
