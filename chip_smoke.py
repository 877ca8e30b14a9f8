#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py            # from the repository root

Phases (any failure raises, so the script exits non-zero and never
prints its final line):

1. device: require CUDA and compute capability 9.0; print the card's
   name and power limit (nvidia-smi), torch and CUDA versions; turn
   TF32 off for matmul and cuDNN;
2. build: compile ``src/repro_torch/csrc/*.cu`` with nvcc for sm_90a
   (one nvcc per source, all started together) and load the library;
   the Jacobi kernels must have no stack frame and no spills;
3. kernels against their plain PyTorch versions on the card, at the
   main path's shapes and at small, ragged and bf16 shapes; the fused
   starlet transforms (Phi, Phi^T) also pass the dot-product test and
   give bit-identical results on a second call;
4. the main path at survey width: ``solve("deconvolve", ...)`` on
   10 000 simulated 41x41 stamps with J = 4 starlet scales; the launch
   counters, reset just before, must show every kernel on the path
   (one Phi and one Phi^T an iteration, no single smoothing) and one
   host sync per chunk;
   then one more chunk of its iteration runs under torch.profiler, for
   the device time of each part and the device's idle share;
5. the same solve at n = 256 on the card and on the CPU (plain
   versions, pocketfft), cost trajectories compared;
6. times from CUDA events (median of 30 runs after warm-up) for each
   kernel, its plain version and, where one exists, the one PyTorch
   call computing the same function, beside the memory/compute bound;
   Phi and Phi^T also beside their route composed of single smoothings;
7. the SCDL kernels (``admm_elwise``, ``dict_outer_pair``,
   ``dict_outer``) against their plain versions: the main path's
   shapes, a ragged K, a ragged and unaligned fp32 shape (K = 1001,
   P = 289, M = 81, A = 200), bf16, operands that start off a 16-byte
   boundary, and the pair at the paper's A = 2056; each Gram symmetric,
   and two calls at the main shape bit-identical;
8. the SCDL main path at the paper's grayscale width:
   ``solve("scdl", ...)`` on K = 40 000 coupled patches (P = 289,
   M = 81), A = 512 atoms, 100 iterations; launch counters and host
   syncs as in phase 4, the NRMSE must fall; then one more chunk of
   its iteration under torch.profiler;
9. the SCDL solve at K = 2048, A = 128 on the card and on the CPU,
   cost trajectories compared;
10. times of the SCDL kernels, as in phase 6;
11. the Jacobi kernels (``jacobi.eigh``, ``jacobi.svd``) against
    ``torch.linalg`` at r = 3, 24, 25, 32, 33, 40, 64 on random symmetric
    matrices, Grams of rank r and r / 2 and a cluster of equal
    eigenvalues (reconstruction, orthogonality, values, the count above
    the low-rank solver's 1e-6 clip, the sweeps each took); two calls
    bit-identical, and batches of four (r = 24) and eight (r = 32)
    bit-identical to their own calls;
    the whole randomized SVT at (10 000, 1681), r = 24, card route
    against plain route, and its host syncs (none);
12. the low-rank main path: ``solve("deconvolve", ...,
    cfg=SolverConfig(mode="lowrank", lam=0.05, rank=16))`` on phase 4's
    stamps, 60 iterations; launches (one primal pass with X_bar and one
    ``jacobi.svd`` an iteration, one ``jacobi.eigh`` an iteration and one
    a chunk, no starlet or dual pass) and one host sync per chunk; then
    one more chunk under torch.profiler;
13. that solve at n = 256 on the card and on the CPU, cost trajectories
    compared;
14. ``solve("lowrank", Y, M)`` completing a rank-4 (10 000, 1681) matrix
    from 60 % of its entries, 60 iterations, one host sync per chunk:
    with the range finder of tests/test_problem_api.py (r = 24), too
    narrow at this size for the algebra to converge (reported), then at
    r = 64, where the cost falls and the matrix is recovered; each then
    one more chunk under torch.profiler; then card against CPU at
    (1024, 128);
15. times of the two-output primal pass and of the Jacobi kernels at
    r = 24, 32, 40 and 64 beside ``torch.linalg``, with their sweeps and
    microseconds per dependent step;
16. checkpoints on the main path: phase 4's solve (tol 0, 60
    iterations) with ``checkpoint_every=24`` into ``build/``, one host
    sync per chunk on this thread with checkpoints written, then
    ``resume=True`` from step 48: the evaluated cost and the final
    iterate bit-identical to the uninterrupted run; the checkpoint's
    bytes, this thread's time to queue the spill, the writer's seconds
    per checkpoint, ms per iteration with and without checkpoints;
17. ``solve_many("deconvolve", ...)``: phase 4's stamps split in order
    into eight instances (one bucket, capacity 1350), phase 4's options:
    one bucket, one host sync per chunk, one Phi, Phi^T, primal and dual
    launch an iteration for the whole bucket, each instance's costs
    against its own single solve on the card (rtol 1e-4, equal
    ``iters_run``); ms per iteration beside phase 4's and the single
    solves'; one more chunk under torch.profiler.  Then 64 instances of
    120-180 stamps as one bucket against the same run one after another
    (the host-bound regime), and the bucket of eight in low rank (one
    ``jacobi.eigh`` and one ``jacobi.svd`` an iteration);
18. buckets of four completions at r = 64 (2400-2600 rows, one shared
    Omega; one Jacobi launch per kernel an iteration) and of four SCDL
    instances at K = 10 000 (``dict_outer_pair`` once per instance an
    iteration), each instance against its single solve (rtol 1e-4);
19. supervision on the main path: phase 4's solve (tol 0) with
    ``resilience=ResilienceConfig()``, one host sync per chunk, costs and
    iterate bit-identical to the unsupervised run, ms per iteration and
    the ring's device memory beside it; under a dispatch fault, a
    poisoned carry, a ``kernel:condat_elwise`` fault and a torn newest
    checkpoint (checkpoints every 24 under ``build/``): bit-identical
    again, ``kernel_fallbacks == []``, the report printed, and
    ``resume=True`` falling back past the torn checkpoint bit for bit;
    phase 17's bucket with a poisoned carry (one rollback, one sync per
    chunk, every instance bit-identical to the fault-free bucket); a run
    at n = 256 that diverges every chunk raises ``ResilienceExhausted``;
20. serving on the card: ``serve_http`` on 127.0.0.1 and eight
    concurrent ``ServeClient`` requests of phase 17's catalogues: one
    bucket, one ``solve_many`` dispatch, one Phi, Phi^T, primal and dual
    launch an iteration; each HTTP result against its single solve (rtol
    1e-4, equal ``iters_run``) and bit for bit against ``solve_many`` in
    process on the same arrays in the served lane order; whether it is
    bit-identical to phase 17's bucket (reported: a lane's position in
    the stack can change the last bits); latency p50/p99, the codec's
    seconds and ms per
    iteration beside phase 17's; then the three drills of
    ``repro_torch.serve.drill`` on the card.

21. multi-device: (a) a one-rank NCCL process group in this process
    (a ``FileStore`` under ``build/phase21/``) and a (data=1) mesh;
    phases 4, 12, 8 and 14's paths (the completion at r = 64) each with
    ``mesh=`` against the same call without: costs and iterate
    bit-identical, one host sync per chunk, the same kernel launches;
    ms per iteration beside the meshless run, collectives per iteration,
    and their device time in one more chunk under torch.profiler.
    (b) four gloo ranks time-sharing the card (this script run with
    ``--mesh-rank``, each on cuda:0, a timeout on every one): phase 4's
    sparse deconvolution (2 500 stamps a rank) and phase 8's SCDL
    (10 000 samples a rank) against the single-process solves of (a):
    deconvolution costs and iterate rtol 1e-4 with equal ``iters_run``,
    SCDL costs rtol 5e-3 (tests/test_distributed.py:85); the replicated
    state, costs and results bit for bit across the ranks; the gaps,
    host syncs (gloo syncs: reported) and times reported, labelled as
    four processes sharing one card.
22. supervision and serving under a mesh: (a) a one-rank NCCL mesh in
    this process: phase 19's supervised main path (one host sync per
    chunk, bit-identical to the unsupervised meshed run, ms per
    iteration beside it and beside phase 19's), then under phase 19's
    faults (the report's counts phase 19's, bit-identical again) and
    phase 19's bucket with a poisoned carry; (b) four gloo ranks
    time-sharing the card (this script run with ``--sup-rank``): phase
    4's stamps supervised under ``dispatch@1;carry_nan@1;seed=7`` (the
    NaN on one rank's shard; bit-identical to the same ranks
    unsupervised, the same report on every rank) and the low-rank path
    under ``kernel:jacobi@2`` on every rank (the vote; bit-identical);
    phase 20's catalogues as eight HTTP requests to rank 0 with ranks
    1-3 following (``serve.follow``): one bucket, each result within
    rtol 1e-4 of phase 17's bucket (the gap reported), the input
    broadcast's seconds; the poison-bucket drill under the mesh.  Its
    ranks start up (and import ``torch._dynamo``) while phase 21 and
    22(a) run; the supervised sparse run is held against phase 21(b)'s
    unsupervised one.
23. the JAX package's public names that the port took on: the
    deprecated ``deconvolve`` shim on phase 5's 256 stamps and ``train``
    on phase 9's K = 2048, A = 128 patches, each bit-identical to
    ``solve`` on the same inputs, with one ``DeprecationWarning``, the
    solve's host syncs (one a chunk) and its launches (Phi, Phi^T and
    the Condat passes; ``admm_elwise`` and ``dict_outer_pair``);
    ``IterativeDriver``'s legacy keyword arguments on the card,
    bit-identical to ``options=``; and ``python -m repro_torch.lint``
    over the tree in a subprocess on the host, beside the rest, which
    must exit 0 (its file count and seconds printed).

Phases 3 and 6 also hold the Condat passes with a step size per
instance (count 1 and 8, the bucket's layout and a ragged one, fp32 and
bf16; each instance of a batch bit-identical to its own call) and time
them at count 8 on phase 17's bucket.

Prints one JSON line per kernel, the ``{"kernels": [...]}`` line (the
per-instance Condat passes as their own entries, launches from phase
17), and last ``{"ok": true, "device": {...}}``.  The whole report also goes to
``chiprun_out/chip_smoke.json``.  Imports nothing of JAX or of the JAX
package.
"""
from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12  # dense, on the tensor cores

MAIN_N, STAMP, SCALES = 10_000, 41, 4
MAIN_ITERS, MAIN_CHUNK = 60, 12
PARITY_N, PARITY_ITERS, PARITY_CHUNK = 256, 24, 8
# fp32: kernel and plain version differ only in the order of summation
# and FMA contraction; bf16: one rounding of the output
TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# card against CPU, cost trajectories of the whole solve: cuFFT and
# pocketfft round differently, and the reductions sum in another order
PARITY_RTOL = 1e-4
# the main path's setup runs the starlet transforms outside the loop:
# 30 power-iteration steps (one Phi and one Phi^T each), the noise
# calibration (one Phi) and the first coefficients CX (one Phi)
SETUP_FORWARDS, SETUP_ADJOINTS = 32, 30

# SCDL at the paper's grayscale patch shape (benchmarks/bench_scdl.py),
# the SCDLConfig default of 512 atoms and the K ~ 40k both TPU kernels
# were sized for
SCDL_K, SCDL_P, SCDL_M, SCDL_A = 40_000, 289, 81, 512
SCDL_ITERS, SCDL_CHUNK = 100, 10
SCDL_PARITY_K, SCDL_PARITY_A, SCDL_PARITY_ITERS, SCDL_PARITY_CHUNK = \
    2048, 128, 24, 8


def outer_tol(dtype_name, K):
    """Outer products: sums over K of products, so the absolute error
    grows with K (tests/test_kernels.py's ``_do_tol``)."""
    if dtype_name == "bfloat16":
        return dict(rtol=2e-2, atol=K * 2e-3)
    return dict(rtol=1e-4, atol=K * 1e-6)


def cascade_tol(dtype_name, smoothings):
    """Phi / Phi^T fused against composed: in fp32 each chained
    smoothing adds its rounding differences (FMA contraction), so TOL
    scales by their count (J for Phi, 2J - 1 for Phi^T); in bf16 the
    kernel rounds where the composed path stores, so one rounding."""
    if dtype_name == "bfloat16":
        return TOL["bfloat16"]
    return {k: v * smoothings for k, v in TOL["float32"].items()}


LOG_FILE = []          # the open copy of the log under chiprun_out/


def log(msg: str) -> None:
    print(msg, flush=True)
    for f in LOG_FILE:
        f.write(msg + "\n")
        f.flush()


# ----------------------------------------------------------------- 1
def device_phase(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability 9.0 "
                         f"(Hopper), found {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


# ----------------------------------------------------------------- 2
def build_phase():
    from repro_torch.kernels import common
    t0 = time.perf_counter()
    path = common.build_library()
    common.library()
    secs = time.perf_counter() - t0
    log(f"build: {path.name} in {secs:.2f} s")
    build_log = Path(str(path) + ".log")
    if build_log.exists():
        # every source's seconds; the compiler's registers and spills for
        # each kernel, of the starlet register kernels and the Jacobi
        # kernels only at the sides the phases below run (one is built per
        # side up to 41, and per even side up to 64)
        shown, props, frames = True, "", {}
        for line in build_log.read_text().splitlines():
            if "entry function" in line:
                side = re.search(r"_regsI\w*?Li(\d+)E", line)
                jacobi = re.search(r"(eigh|svd)_kernelILi(\d+)E", line)
                shown = (side is None or int(side[1]) in (13, 32, STAMP)) \
                    and (jacobi is None or int(jacobi[2]) in JACOBI_SIDES)
            if "Function properties for" in line:
                props = line.split()[-1]
            if "stack frame" in line and re.search(
                    r"(eigh|svd)_kernelILi\d+E", props):
                frames[props] = line.strip()
            if line.startswith("==") or shown and any(
                    k in line for k in ("entry function", "registers",
                                        "spill")):
                log(f"  {line.strip()}")
        # the Jacobi kernels keep each thread's rotations, blocks and rows
        # in registers only if nothing goes to a stack frame
        bad = {k: v for k, v in frames.items() if v != NO_FRAME}
        log(f"  jacobi kernels: {len(frames)} built, {len(bad)} with a "
            f"stack frame or spills")
        if len(frames) != JACOBI_KERNELS or bad:
            raise AssertionError(f"jacobi kernels: {bad or frames}")
    return secs


# ----------------------------------------------------------------- 3
def compare(name, got, want, tol):
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        raise AssertionError(f"{name}: shape {tuple(g.shape)} != "
                             f"{tuple(w.shape)}")
    if not bool(g.isfinite().all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (g - w).abs()
    bad = err > tol["atol"] + tol["rtol"] * w.abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements off, "
                             f"max abs err {max_err:.3e} ({tol})")
    log(f"  {name}: max abs err {max_err:.3e}")
    return max_err


def kernel_phase(torch):
    from repro_torch.kernels.condat_elwise.ops import (condat_dual,
                                                       condat_primal)
    from repro_torch.kernels.starlet2d.kernel import MAX_REGS_SIDE
    from repro_torch.kernels.starlet2d.ops import adjoint, forward, smooth
    g = torch.Generator(device="cuda").manual_seed(7)
    dev = "cuda"

    def randn(shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    errs = {"starlet2d.smooth": 0.0, "starlet2d.forward": 0.0,
            "starlet2d.adjoint": 0.0, "condat_elwise.primal": 0.0,
            "condat_elwise.dual": 0.0}
    bf16, f32 = torch.bfloat16, torch.float32
    for shape, dtype, scales in (((MAIN_N, STAMP, STAMP), f32, range(4)),
                                 ((100, STAMP, STAMP), bf16, range(4)),
                                 ((7, 13, 13), f32, (3,)),
                                 ((7, 13, 13), bf16, (3,))):
        x = randn(shape, dtype)
        for j in scales:
            got = smooth(x, scale=j)
            want = smooth(x, scale=j, use_kernel=False)
            torch.cuda.synchronize()
            e = compare(f"smooth {tuple(shape)} {dtype} j={j}", got, want,
                        TOL[str(dtype).split(".")[1]])
            if shape[0] == MAIN_N:
                errs["starlet2d.smooth"] = max(errs["starlet2d.smooth"], e)
    # square stamps up to MAX_REGS_SIDE wide run the register kernels
    # (Phi^T in fp32 only), the rest the shared-memory ones: both designs
    # at the survey stamp, at a square one of another width, and where
    # the taps wrap around the stamp (13 wide at J = 5)
    for shape, dtype, J in (((MAIN_N, STAMP, STAMP), f32, SCALES),
                            ((100, STAMP, STAMP), bf16, SCALES),
                            ((7, 13, 13), f32, 5), ((7, 13, 13), bf16, 5),
                            ((9, 32, 32), f32, SCALES),
                            ((7, 13, 17), f32, 5), ((7, 13, 17), bf16, 5),
                            ((3, 64, 64), f32, SCALES)):
        x, u = randn(shape, dtype), randn((J,) + shape, dtype)
        name = str(dtype).split(".")[1]
        regs = shape[1] == shape[2] <= MAX_REGS_SIDE
        design = {True: "registers", False: "shared memory"}
        got_f, got_a = forward(x, J), adjoint(u, J)
        want_f = forward(x, J, use_kernel=False)
        want_a = adjoint(u, J, use_kernel=False)
        torch.cuda.synchronize()
        ef = compare(f"forward {tuple(shape)} {dtype} J={J} "
                     f"({design[regs]})", got_f, want_f,
                     cascade_tol(name, J))
        ea = compare(f"adjoint {(J,) + tuple(shape)} {dtype} J={J} "
                     f"({design[regs and dtype == f32]})", got_a, want_a,
                     cascade_tol(name, 2 * J - 1))
        if shape[0] != MAIN_N:
            continue
        errs["starlet2d.forward"], errs["starlet2d.adjoint"] = ef, ea
        # <Phi x, u> = <x, Phi^T u>, summed in fp64 (the JAX package's
        # own bound, tests/test_imaging.py)
        lhs = float(torch.sum(got_f.double() * u.double()))
        rhs = float(torch.sum(x.double() * got_a.double()))
        if not abs(lhs - rhs) <= 1e-4 * max(abs(lhs), 1.0):
            raise AssertionError(f"dot-product test: <Phi x, u> = {lhs} "
                                 f"but <x, Phi^T u> = {rhs}")
        log(f"  dot-product test {tuple(shape)}: <Phi x, u> = {lhs:.9g}, "
            f"<x, Phi^T u> = {rhs:.9g}")
        if not (torch.equal(got_f, forward(x, J))
                and torch.equal(got_a, adjoint(u, J))):
            raise AssertionError(f"forward/adjoint {tuple(shape)}: two "
                                 f"calls differ")
        log(f"  forward/adjoint {tuple(shape)}: two calls bit-identical")
    for shape, dtype in (((MAIN_N, STAMP, STAMP), f32),
                         ((130, 21, 21), bf16)):
        X, Ua, gr = (randn(shape, dtype) for _ in range(3))
        tau = torch.tensor(0.31, device=dev)
        tol = TOL[str(dtype).split(".")[1]]
        got = condat_primal(X, Ua, gr, tau)
        want = condat_primal(X, Ua, gr, tau, use_kernel=False)
        torch.cuda.synchronize()
        e = compare(f"primal {tuple(shape)} {dtype}", got, want, tol)
        xn, xb = condat_primal(X, Ua, gr, tau, with_xbar=True)
        rn, rb = condat_primal(X, Ua, gr, tau, with_xbar=True,
                               use_kernel=False)
        torch.cuda.synchronize()
        e_xbar = max(compare(f"primal+xbar X_new {tuple(shape)} {dtype}",
                             xn, rn, tol),
                     compare(f"primal+xbar X_bar {tuple(shape)} {dtype}",
                             xb, rb, tol))
        if shape[0] == MAIN_N:
            errs["condat_elwise.primal"] = max(e, e_xbar)
            errs["condat_elwise.primal_xbar"] = e_xbar
    for shape, dtype in (((SCALES, MAIN_N, STAMP, STAMP), f32),
                         ((3, 100, STAMP, STAMP), bf16)):
        U, Cn, Co = (randn(shape, dtype) for _ in range(3))
        W = torch.rand(shape[:2] + (1, 1), generator=g,
                       device=dev).to(dtype)
        sig = torch.tensor(0.47, device=dev)
        got = condat_dual(U, Cn, Co, W, sig)
        want = condat_dual(U, Cn, Co, W, sig, use_kernel=False)
        torch.cuda.synchronize()
        e = compare(f"dual {tuple(shape)} {dtype}", got, want,
                    TOL[str(dtype).split(".")[1]])
        if shape[1] == MAIN_N:
            errs["condat_elwise.dual"] = e
    return errs


# ----------------------------------------------------------------- 4
DECONV_KERNELS = ("starlet2d.smooth", "starlet2d.forward",
                  "starlet2d.adjoint", "condat_elwise.primal",
                  "condat_elwise.dual")
SCDL_KERNELS = ("admm_elwise", "dict_outer_pair", "dict_outer")


LOWRANK_KERNELS = ("condat_elwise.primal_xbar", "jacobi.eigh", "jacobi.svd")
# the Condat passes with a step size per instance, on phase 17's bucket
BATCHED_KERNELS = ("condat_elwise.primal_batched",
                   "condat_elwise.dual_batched")


def counters():
    """Every kernel, by name: the wrapper that launches it and the
    attribute holding its launch count (the two-output primal pass is
    counted apart as well as in ``condat_elwise.primal``)."""
    from repro_torch.kernels.admm_elwise.kernel import admm_elwise_fwd
    from repro_torch.kernels.condat_elwise.kernel import (condat_dual_fwd,
                                                          condat_primal_fwd)
    from repro_torch.kernels.dict_outer.kernel import (dict_outer_fwd,
                                                       dict_outer_pair_fwd)
    from repro_torch.kernels.jacobi.kernel import eigh_fwd, svd_fwd
    from repro_torch.kernels.starlet2d.kernel import (smooth_fwd,
                                                      starlet_adjoint_fwd,
                                                      starlet_forward_fwd)
    fns = {"starlet2d.smooth": smooth_fwd,
           "starlet2d.forward": starlet_forward_fwd,
           "starlet2d.adjoint": starlet_adjoint_fwd,
           "condat_elwise.primal": condat_primal_fwd,
           "condat_elwise.dual": condat_dual_fwd,
           "admm_elwise": admm_elwise_fwd,
           "dict_outer_pair": dict_outer_pair_fwd,
           "dict_outer": dict_outer_fwd,
           "jacobi.eigh": eigh_fwd,
           "jacobi.svd": svd_fwd}
    out = {name: (fn, "launches") for name, fn in fns.items()}
    out["condat_elwise.primal_xbar"] = (condat_primal_fwd, "launches_xbar")
    # a step size per instance (a bucket of solve_many), counted apart too
    out["condat_elwise.primal_batched"] = (condat_primal_fwd,
                                           "launches_batched")
    out["condat_elwise.dual_batched"] = (condat_dual_fwd, "launches_batched")
    return out


def reset_launches():
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_launches():
    return {name: getattr(fn, attr) for name, (fn, attr) in counters().items()}


def run_counting_syncs(torch, run):
    """``run(progress_fn)`` under torch's sync debug mode; returns its
    result and the median count of host syncs between consecutive
    progress events (one event per chunk)."""
    syncs_at = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        def progress(event):
            syncs_at.append(sum("synchroniz" in str(w.message)
                                for w in caught))

        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            out = run(progress)
            wall = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
    steady = [b - a for a, b in zip(syncs_at, syncs_at[1:])]
    return out, wall, statistics.median(steady) if steady else None


def evaluated_costs(costs, chunk):
    """The costs a ``cost_every="chunk"`` run evaluated: each chunk's
    last and the run's last."""
    return [costs[i] for i in range(len(costs))
            if (i + 1) % chunk == 0 or i == len(costs) - 1]


def main_path_phase(torch):
    from repro_torch.core.problem import solve
    from repro_torch.imaging.condat import SolverConfig
    from repro_torch.imaging.psf import simulate

    data = simulate(MAIN_N, torch.Generator().manual_seed(42), stamp=STAMP)
    torch.cuda.synchronize()
    reset_launches()
    sol, wall, syncs_per_chunk = run_counting_syncs(
        torch, lambda progress: solve(
            "deconvolve", data.Y, data.psfs,
            cfg=SolverConfig(mode="sparse", n_scales=SCALES),
            max_iter=MAIN_ITERS, chunk=MAIN_CHUNK, cost_every="chunk",
            tol=1e-5, progress_fn=progress))
    launches = read_launches()
    it = sol.log.iters_run
    log(f"main path: n={MAIN_N} J={SCALES} iters_run={it} "
        f"converged_at={sol.log.converged_at} wall {wall:.2f} s, "
        f"launches {launches}")
    if launches["condat_elwise.primal"] != it or \
            launches["condat_elwise.dual"] != it:
        raise AssertionError(f"primal/dual launches {launches} != "
                             f"iters_run {it}")
    want = {"starlet2d.forward": it + SETUP_FORWARDS,
            "starlet2d.adjoint": it + SETUP_ADJOINTS, "starlet2d.smooth": 0}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"starlet launches {launches}, expected {want} "
                             f"(one Phi and one Phi^T an iteration)")
    if syncs_per_chunk != 1:
        raise AssertionError(f"{syncs_per_chunk} host syncs per chunk, "
                             f"expected 1")
    if any(launches[k] for k in SCDL_KERNELS + LOWRANK_KERNELS):
        raise AssertionError(f"SCDL or low-rank kernels launched on the "
                             f"sparse deconvolution path: {launches}")
    evaluated = evaluated_costs(sol.log.costs, MAIN_CHUNK)
    if not all(math.isfinite(c) for c in evaluated):
        raise AssertionError(f"non-finite evaluated cost: {evaluated}")
    if not evaluated[-1] < evaluated[0]:
        raise AssertionError(f"cost did not fall: {evaluated}")
    x = torch.as_tensor(sol.x, device="cuda")
    mse_dec = float(torch.mean((x - data.X_true) ** 2))
    mse_obs = float(torch.mean((data.Y - data.X_true) ** 2))
    if not mse_dec < mse_obs:
        raise AssertionError(f"deconvolved MSE {mse_dec:.3e} not below "
                             f"observation MSE {mse_obs:.3e}")
    # each chunk's time runs to its host sync, which waits for the card
    chunk_ms = [t * 1e3 for t in sol.log.times[MAIN_CHUNK::MAIN_CHUNK]]
    ms_per_iter = statistics.median(chunk_ms) if chunk_ms else None
    log(f"main path: evaluated costs {evaluated[0]:.6g} -> "
        f"{evaluated[-1]:.6g}; MSE deconvolved {mse_dec:.3e} vs observed "
        f"{mse_obs:.3e}; {ms_per_iter} ms/iteration (median over chunks "
        f"after the first); host syncs per chunk {syncs_per_chunk} "
        f"(torch sync debug mode)")
    return {"n": MAIN_N, "iters_run": it, "launches": launches,
            "ms_per_iter": ms_per_iter, "syncs_per_chunk": syncs_per_chunk,
            "wall_s": wall, "cost_first": evaluated[0],
            "cost_last": evaluated[-1], "mse_deconvolved": mse_dec,
            "mse_observed": mse_obs}, sol.bundle


# ---------------------------------------------------------------- 4b
# kernel-name fragments -> the part of the iteration they belong to
PARTS = (("starlet2d.forward", ("starlet_forward",)),
         ("starlet2d.adjoint", ("starlet_adjoint",)),
         ("starlet2d.smooth", ("starlet_smooth",)),
         ("condat_elwise.primal", ("condat_primal",)),
         ("condat_elwise.dual", ("condat_dual",)),
         ("fft", ("fft", "FFT")))


def profile_window(torch, body, iters, parts_by_key):
    """Run ``body()`` (``iters`` iterations, device work only) under
    ``torch.profiler``: device time per iteration for each part
    (kernel-name fragments -> part, first match wins, the rest is
    "other"), the device's idle share of the window's wall time, the
    device operations (kernels and copies) per iteration, and the
    kernels that took most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        body()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    parts = {name: 0.0 for name, _ in parts_by_key}
    parts["other"] = 0.0
    top = []
    launches = 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        launches += ev.count
        ms = ev.self_device_time_total / 1e3
        part = next((name for name, keys in parts_by_key
                     if any(k in ev.key for k in keys)), "other")
        parts[part] += ms
        top.append((ms, ev.key[:90]))
    busy = sum(parts.values())
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")
    return {"iters": iters, "wall_ms_per_iter": wall_ms / iters,
            "device_ms_per_iter": busy / iters,
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "device_ops_per_iter": launches / iters,
            "device_ms_per_iter_by_part": {k: v / iters
                                           for k, v in parts.items()},
            "top_kernels_ms_per_iter": [[k, ms / iters] for ms, k in
                                        sorted(top, reverse=True)[:12]]}


def profile_phase(torch, bundle):
    """One chunk of the main path's iteration, continued from its final
    state, under ``torch.profiler``: device time per iteration for each
    part (the four kernels, cuFFT, the rest), and the device's idle
    share of the window's wall time."""
    from repro_torch.imaging.condat import SolverConfig
    from repro_torch.imaging.deconvolve import make_light_step_fn
    light = make_light_step_fn(SolverConfig(mode="sparse", n_scales=SCALES))
    state = {"d": light(bundle.data, bundle.replicated, ())}

    def body():
        for _ in range(MAIN_CHUNK):
            state["d"] = light(state["d"], bundle.replicated, ())

    out = profile_window(torch, body, MAIN_CHUNK, PARTS)
    log(f"profile: {json.dumps(out)}")
    return out


# ----------------------------------------------------------------- 5
def cost_gap(runs, label, rtol=PARITY_RTOL):
    """Card against CPU: equal ``iters_run`` and finite cost entries, the
    largest relative gap of the cost trajectories (held to ``rtol``
    unless it is None) and the largest absolute gap of the iterates (of
    each array, where the solution is a tuple)."""
    import numpy as np
    gpu, cpu = runs["cuda"], runs["cpu"]
    if gpu.log.iters_run != cpu.log.iters_run:
        raise AssertionError(f"{label}: iters_run differs between card and "
                             f"CPU")
    c_gpu, c_cpu = np.asarray(gpu.log.costs), np.asarray(cpu.log.costs)
    fin = np.isfinite(c_cpu)
    if not np.array_equal(fin, np.isfinite(c_gpu)) or not fin.any():
        raise AssertionError(f"{label}: finite cost entries differ")
    gap = float(np.max(np.abs(c_gpu[fin] - c_cpu[fin]) / np.abs(c_cpu[fin])))
    pairs = zip(gpu.x, cpu.x) if isinstance(gpu.x, (tuple, list)) \
        else [(gpu.x, cpu.x)]
    x_gap = max(float(np.max(np.abs(a - b))) for a, b in pairs)
    log(f"{label}: max relative cost gap {gap:.3e} (rtol {rtol}), max abs "
        f"x gap {x_gap:.3e}")
    if rtol is not None and not gap <= rtol:
        raise AssertionError(f"{label}: card/CPU cost gap {gap} > {rtol}")
    return gap, x_gap


def parity_phase(torch):
    from repro_torch.core.problem import solve
    from repro_torch.imaging.condat import SolverConfig
    from repro_torch.imaging.psf import simulate
    data = simulate(PARITY_N, torch.Generator().manual_seed(5),
                    stamp=STAMP, device="cpu")
    runs = {}
    for dev in ("cuda", "cpu"):
        sol = solve("deconvolve", data.Y, data.psfs,
                    cfg=SolverConfig(mode="sparse", n_scales=SCALES),
                    device=dev, max_iter=PARITY_ITERS, chunk=PARITY_CHUNK,
                    cost_every="chunk", tol=1e-5)
        runs[dev] = sol
    gap, x_gap = cost_gap(runs, f"card vs CPU at n={PARITY_N}")
    return {"n": PARITY_N, "max_rel_cost_gap": gap, "max_abs_x_gap": x_gap}


# ----------------------------------------------------------------- 6
def time_ms(torch, fn, reps=30, warmup=3):
    """Median of ``reps`` single-call times from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def outer_bound(nbytes, flops):
    """The least time for fp32 outer products at fp32 accuracy: the
    operations either on the SIMT units or as three TF32 products each
    on the tensor cores (3xTF32), whichever is faster, against the bytes.
    Also returns the fp32 SIMT bound alone, which earlier rows used."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_fp32 = flops / FP32_FLOPS_PER_S * 1e3
    t_tf32x3 = 3 * flops / TF32_FLOPS_PER_S * 1e3
    t_ops, route = min((t_fp32, "fp32"), (t_tf32x3, "tf32x3"))
    t_bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else \
        (t_ops, "operations")
    return {"bound_ms": t_bound, "bound_by": by, "bound_route": route,
            "bound_fp32_ms": max(t_bytes, t_fp32),
            "bound_tf32x3_ms": max(t_bytes, t_tf32x3)}


def composed_forward(torch, x, J):
    """Phi composed of J single-smoothing kernels, with the differences
    and the stack in torch (the route before the fused cascade)."""
    from repro_torch.kernels.starlet2d.ops import smooth
    from repro_torch.kernels.starlet2d.ref import cascade
    return torch.stack(cascade(x, J, lambda c, j: smooth(c, scale=j))[0])


def composed_adjoint(u, J):
    """Phi^T composed of Horner's 2J - 1 single-smoothing kernels, with
    the differences and sums in torch (the route before the fused
    cascade)."""
    from repro_torch.kernels.starlet2d.ops import smooth
    from repro_torch.kernels.starlet2d.ref import horner
    return horner(u, J, lambda c, j: smooth(c, scale=j))


def starlet_conv(torch, J, adjoint):
    """Phi (or, with ``adjoint``, Phi^T) on STAMP x STAMP stamps as one
    circular ``Conv2d``, the library yardstick of phase 6 (the port never
    calls it).  Detail scale j is x - H_0 x for j = 0 and
    H_{j-1}..H_0 x - H_j..H_0 x after: a periodic convolution with the
    plain cascade's response to a centred delta, which wraps (folds modulo
    the stamp) like the cascade itself.  Each response is symmetric, so
    the correlation Conv2d computes equals the convolution, and Phi^T
    (the sum over j of the transposed, i.e. the same, filters) is the
    mirror convolution from J channels to one."""
    from repro_torch.kernels.starlet2d.ops import forward
    delta = torch.zeros((1, STAMP, STAMP), device="cuda")
    delta[0, STAMP // 2, STAMP // 2] = 1.0
    filters = forward(delta, J, use_kernel=False)        # (J, 1, S, S)
    channels = (J, 1) if adjoint else (1, J)
    conv = torch.nn.Conv2d(*channels, STAMP, padding=STAMP // 2,
                           padding_mode="circular", bias=False).to("cuda")
    with torch.no_grad():
        conv.weight.copy_(filters.transpose(0, 1) if adjoint else filters)
    return conv


def timing_phase(torch):
    from repro_torch.kernels.condat_elwise.ops import (condat_dual,
                                                       condat_primal)
    from repro_torch.kernels.starlet2d.ops import adjoint, forward, smooth
    g = torch.Generator(device="cuda").manual_seed(11)
    dev = "cuda"
    out = {}

    x = torch.randn((MAIN_N, STAMP, STAMP), generator=g, device=dev)
    elems = x.numel()
    by_scale = {}
    lib_err = 0.0
    for j in range(SCALES):
        conv = torch.nn.Conv2d(1, 1, 5, dilation=2 ** j, padding=2 * 2 ** j,
                               padding_mode="circular", bias=False).to(dev)
        taps = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], device=dev)
        with torch.no_grad():
            conv.weight.copy_((taps[:, None] * taps[None, :] / 256)[None, None])
        x4 = x[:, None]
        with torch.no_grad():
            lib_err = max(lib_err, float(
                (conv(x4)[:, 0] - smooth(x, scale=j)).abs().max()))
            by_scale[j] = {
                "ms": time_ms(torch, lambda: smooth(x, scale=j)),
                "plain_ms": time_ms(torch, lambda: smooth(
                    x, scale=j, use_kernel=False)),
                "library_ms": time_ms(torch, lambda: conv(x4))}
    t_bound, by = bound(2 * elems * 4, 18 * elems)
    out["starlet2d.smooth"] = {
        **{k: statistics.mean(v[k] for v in by_scale.values())
           for k in ("ms", "plain_ms", "library_ms")},
        "bound_ms": t_bound, "bound_by": by,
        "ms_by_scale": {str(j): v["ms"] for j, v in by_scale.items()},
        "library_max_abs_err": lib_err}

    u = torch.randn((SCALES,) + tuple(x.shape), generator=g, device=dev)
    # each reads its input planes once and writes its outputs once: 1 + J
    # planes of fp32; per element each smoothing costs 18 flops and each
    # difference or sum one.  At this shape (fp32, 41 x 41: the register
    # kernels) Phi and Phi^T each run J smoothings.
    for name, fn, arg, composed, adj in (
            ("starlet2d.forward", forward, x,
             lambda x, J: composed_forward(torch, x, J), False),
            ("starlet2d.adjoint", adjoint, u, composed_adjoint, True)):
        t_bound, by = bound((1 + SCALES) * elems * 4, 19 * SCALES * elems)
        conv = starlet_conv(torch, SCALES, adj)
        # the convolution takes the stamp axis first: (N, 1) -> (N, J) for
        # Phi, a (N, J) view of the scale-major planes -> (N, 1) for Phi^T
        arg4 = arg.transpose(0, 1) if adj else arg[:, None]
        with torch.no_grad():
            lib = conv(arg4)
            lib = lib[:, 0] if adj else lib.transpose(0, 1)
            # a 41 x 41 sum an output, in another order (or by FFT)
            lib_err = compare(f"{name} as one circular Conv2d", lib,
                              fn(arg, SCALES, use_kernel=False),
                              dict(rtol=1e-4, atol=1e-4))
            del lib
            lib_ms = time_ms(torch, lambda: conv(arg4))
        out[name] = {
            "ms": time_ms(torch, lambda: fn(arg, SCALES)),
            "plain_ms": time_ms(torch, lambda: fn(arg, SCALES,
                                                   use_kernel=False)),
            "composed_ms": time_ms(torch, lambda: composed(arg, SCALES)),
            "library_ms": lib_ms, "library_max_abs_err": lib_err,
            "bound_ms": t_bound, "bound_by": by}
        log(f"  {name}: {out[name]['ms']:.4f} ms (plain "
            f"{out[name]['plain_ms']:.4f}, composed of single smoothings "
            f"{out[name]['composed_ms']:.4f}, one circular Conv2d "
            f"{lib_ms:.4f}, bound {t_bound:.4f} by {by})")
    del u

    X, Ua, gr = (torch.randn((MAIN_N, STAMP, STAMP), generator=g, device=dev)
                 for _ in range(3))
    tau = torch.tensor(0.31, device=dev)
    t_bound, by = bound(4 * elems * 4, 5 * elems)
    out["condat_elwise.primal"] = {
        "ms": time_ms(torch, lambda: condat_primal(X, Ua, gr, tau)),
        "plain_ms": time_ms(torch, lambda: condat_primal(
            X, Ua, gr, tau, use_kernel=False)),
        "library_ms": None, "bound_ms": t_bound, "bound_by": by}
    del X, Ua, gr

    shape = (SCALES, MAIN_N, STAMP, STAMP)
    U, Cn, Co = (torch.randn(shape, generator=g, device=dev)
                 for _ in range(3))
    W = torch.rand(shape[:2] + (1, 1), generator=g, device=dev)
    sig = torch.tensor(0.47, device=dev)
    m = U.numel()
    t_bound, by = bound(4 * m * 4 + W.numel() * 4, 6 * m)
    out["condat_elwise.dual"] = {
        "ms": time_ms(torch, lambda: condat_dual(U, Cn, Co, W, sig)),
        "plain_ms": time_ms(torch, lambda: condat_dual(
            U, Cn, Co, W, sig, use_kernel=False)),
        "library_ms": None, "bound_ms": t_bound, "bound_by": by}
    return out


# ----------------------------------------------------------------- 7
def scdl_kernel_phase(torch):
    from repro_torch.kernels.admm_elwise.ops import admm_elwise
    from repro_torch.kernels.dict_outer.ops import (dict_outer,
                                                    dict_outer_pair)
    g = torch.Generator(device="cuda").manual_seed(17)
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(shape, dtype):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    def dname(dtype):
        return str(dtype).split(".")[1]

    errs = {name: 0.0 for name in SCDL_KERNELS}
    kw = dict(c1=0.4, c2=0.4, c3=0.8, t1=0.025, t2=0.025)
    for (K, A), dtype in (((SCDL_K, SCDL_A), f32), ((1000, 256), f32),
                          ((130, 128), bf16)):
        Wh, Wl, YZ = randn((K, A), dtype), randn((K, A), dtype), \
            randn((5, K, A), dtype)
        got = admm_elwise(Wh, Wl, YZ, **kw)
        want = admm_elwise(Wh, Wl, YZ, use_kernel=False, **kw)
        torch.cuda.synchronize()
        e = compare(f"admm_elwise {(5, K, A)} {dtype}", got, want,
                    TOL[dname(dtype)])
        if K == SCDL_K:
            errs["admm_elwise"] = e
    def offset(x, k):
        """x copied k elements into a fresh buffer: a view whose first
        element is not on a 16-byte boundary."""
        buf = torch.empty(x.numel() + k, dtype=x.dtype, device=x.device)
        out = buf[k:].view(x.shape)
        out.copy_(x)
        return out

    def symmetric(name, G, tol):
        """G against its transpose: the kernel computes the upper
        triangle of a Gram and mirrors it."""
        compare(f"{name} symmetric", G, G.T, tol)

    # (K, P, M, A), dtype, elements by which every operand is offset
    for (K, P, M, A), dtype, off in (
            ((SCDL_K, SCDL_P, SCDL_M, SCDL_A), f32, 0),
            ((1000, SCDL_P, SCDL_M, 128), f32, 0),
            ((1001, SCDL_P, SCDL_M, 200), f32, 0),
            ((1001, SCDL_P, SCDL_M, 200), f32, 3),
            ((130, 25, 9, 128), bf16, 0),
            ((130, 25, 9, 128), bf16, 5),
            ((4096, SCDL_P, SCDL_M, 2056), f32, 0)):
        ins = [offset(randn((K, m), dtype), off) for m in (P, M, A, A)]
        got = dict_outer_pair(*ins)
        want = dict_outer_pair(*ins, use_kernel=False)
        torch.cuda.synchronize()
        what = f"dict_outer_pair K={K} P={P} M={M} A={A} {dtype} offset {off}"
        tol = outer_tol(dname(dtype), K)
        e = max(compare(f"{what} {name}", o, r, tol)
                for name, o, r in zip(("ShWh", "SlWl", "phi_h", "phi_l"),
                                      got, want))
        for name, G in zip(("phi_h", "phi_l"), got[2:]):
            symmetric(f"{what} {name}", G, tol)
        if K == SCDL_K:
            errs["dict_outer_pair"] = e
            again = dict_outer_pair(*ins)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{what}: two calls differ")
            log(f"  {what}: two calls bit-identical")
    for (K, P, A), dtype in (((SCDL_K, SCDL_P, SCDL_A), f32),
                             ((1000, 25, 64), f32),
                             ((1001, SCDL_P, 200), f32),
                             ((130, SCDL_P, 128), bf16)):
        S, W = randn((K, P), dtype), randn((K, A), dtype)
        got = dict_outer(S, W)
        want = dict_outer(S, W, use_kernel=False)
        torch.cuda.synchronize()
        what = f"dict_outer K={K} P={P} A={A} {dtype}"
        tol = outer_tol(dname(dtype), K)
        e = max(compare(f"{what} {name}", o, r, tol)
                for name, o, r in zip(("SW", "WW"), got, want))
        symmetric(f"{what} WW", got[1], tol)
        if K == SCDL_K:
            errs["dict_outer"] = e
            again = dict_outer(S, W)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{what}: two calls differ")
            log(f"  {what}: two calls bit-identical")
    return errs


# ----------------------------------------------------------------- 8
# kernel-name fragments -> the part of the SCDL iteration they belong to
SCDL_PARTS = (("dict_outer_pair", ("dict_outer",)),
              ("admm_elwise", ("admm_elwise",)),
              # cuSOLVER's potrf runs as getrf without pivoting
              ("cusolver", ("potrf", "potrs", "getrf", "trsm", "syrk",
                            "chol", "cusolver")),
              ("cublas_gemm", ("gemm", "Gemm", "GEMM")))


def scdl_main_path_phase(torch):
    from repro_torch.core.problem import solve
    from repro_torch.data.synthetic import coupled_patches
    from repro_torch.imaging.scdl import SCDLConfig

    t0 = time.perf_counter()
    S_h, S_l = coupled_patches(SCDL_K, SCDL_P, SCDL_M, SCDL_A,
                               torch.Generator().manual_seed(12))
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    cfg = SCDLConfig(n_atoms=SCDL_A, max_iter=SCDL_ITERS)
    reset_launches()
    sol, wall, syncs_per_chunk = run_counting_syncs(
        torch, lambda progress: solve(
            "scdl", S_h, S_l, cfg=cfg, max_iter=SCDL_ITERS,
            chunk=SCDL_CHUNK, cost_every="chunk", progress_fn=progress))
    launches = read_launches()
    it = sol.log.iters_run
    log(f"scdl main path: K={SCDL_K} P={SCDL_P} M={SCDL_M} A={SCDL_A} "
        f"iters_run={it} wall {wall:.2f} s (data {data_s:.2f} s), "
        f"launches {launches}")
    if it != SCDL_ITERS:
        raise AssertionError(f"iters_run {it} != {SCDL_ITERS} (tol = 0)")
    if launches["admm_elwise"] != it or launches["dict_outer_pair"] != it:
        raise AssertionError(f"admm_elwise/dict_outer_pair launches "
                             f"{launches} != iters_run {it}")
    if any(launches[k] for k in DECONV_KERNELS + LOWRANK_KERNELS
           + ("dict_outer",)):
        raise AssertionError(f"kernels off the SCDL path launched: "
                             f"{launches}")
    if syncs_per_chunk != 1:
        raise AssertionError(f"{syncs_per_chunk} host syncs per chunk, "
                             f"expected 1")
    evaluated = evaluated_costs(sol.log.costs, SCDL_CHUNK)
    if not all(math.isfinite(c) for c in evaluated):
        raise AssertionError(f"non-finite NRMSE: {evaluated}")
    if not evaluated[-1] < evaluated[0]:
        raise AssertionError(f"NRMSE did not fall: {evaluated}")
    Xh, Xl = sol.x
    if Xh.shape != (SCDL_P, SCDL_A) or Xl.shape != (SCDL_M, SCDL_A):
        raise AssertionError(f"dictionary shapes {Xh.shape}, {Xl.shape}")
    chunk_ms = [t * 1e3 for t in sol.log.times[SCDL_CHUNK::SCDL_CHUNK]]
    ms_per_iter = statistics.median(chunk_ms)
    log(f"scdl main path: NRMSE {evaluated[0]:.6g} -> {evaluated[-1]:.6g} "
        f"(every {SCDL_CHUNK}: {[round(c, 6) for c in evaluated]}); "
        f"{ms_per_iter} ms/iteration (median over chunks after the "
        f"first); host syncs per chunk {syncs_per_chunk}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return {"K": SCDL_K, "P": SCDL_P, "M": SCDL_M, "A": SCDL_A,
            "iters_run": it, "launches": launches,
            "ms_per_iter": ms_per_iter, "chunk_ms": chunk_ms,
            "syncs_per_chunk": syncs_per_chunk, "wall_s": wall,
            "data_s": data_s, "nrmse": evaluated}, sol.bundle, cfg


def scdl_profile_phase(torch, bundle, cfg):
    """One more chunk of the SCDL iteration (light step and replicated
    refresh), continued from the main path's final state, under
    ``torch.profiler``."""
    from repro_torch.imaging.scdl import make_light_step_fn, make_refresh_fn
    light, refresh = make_light_step_fn(cfg), make_refresh_fn(cfg)
    state = {"d": bundle.data, "rep": bundle.replicated}

    def one():
        state["d"], out = light(state["d"], state["rep"], ())
        state["rep"] = refresh(state["rep"], out)

    one()

    def body():
        for _ in range(SCDL_CHUNK):
            one()

    out = profile_window(torch, body, SCDL_CHUNK, SCDL_PARTS)
    log(f"scdl profile: {json.dumps(out)}")
    return out


# ----------------------------------------------------------------- 9
def scdl_parity_phase(torch):
    from repro_torch.core.problem import solve
    from repro_torch.data.synthetic import coupled_patches
    from repro_torch.imaging.scdl import SCDLConfig
    S_h, S_l = coupled_patches(SCDL_PARITY_K, SCDL_P, SCDL_M, SCDL_PARITY_A,
                               torch.Generator().manual_seed(5),
                               device="cpu")
    runs = {dev: solve("scdl", S_h, S_l,
                       cfg=SCDLConfig(n_atoms=SCDL_PARITY_A), device=dev,
                       max_iter=SCDL_PARITY_ITERS, chunk=SCDL_PARITY_CHUNK,
                       cost_every="chunk")
            for dev in ("cuda", "cpu")}
    # the cost is the NRMSE, x the two dictionaries
    gap, x_gap = cost_gap(runs, f"scdl card vs CPU at K={SCDL_PARITY_K} "
                                f"A={SCDL_PARITY_A}")
    return {"K": SCDL_PARITY_K, "A": SCDL_PARITY_A,
            "max_rel_cost_gap": gap, "max_abs_dict_gap": x_gap}


# ---------------------------------------------------------------- 10
def scdl_timing_phase(torch):
    from repro_torch.kernels.admm_elwise.ops import admm_elwise
    from repro_torch.kernels.dict_outer.ops import (dict_outer,
                                                    dict_outer_pair)
    g = torch.Generator(device="cuda").manual_seed(19)
    K, P, M, A = SCDL_K, SCDL_P, SCDL_M, SCDL_A
    out = {}

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    Wh, Wl, YZ = randn(K, A), randn(K, A), randn(5, K, A)
    kw = dict(c1=0.4, c2=0.4, c3=0.8, t1=0.025, t2=0.025)
    # five planes read (Wh, Wl, Y1, Y2, Y3), five written; ~25 flops each
    t_bound, by = bound(10 * K * A * 4, 25 * K * A)
    out["admm_elwise"] = {
        "ms": time_ms(torch, lambda: admm_elwise(Wh, Wl, YZ, **kw)),
        "plain_ms": time_ms(torch, lambda: admm_elwise(
            Wh, Wl, YZ, use_kernel=False, **kw)),
        "library_ms": None, "bound_ms": t_bound, "bound_by": by}
    del YZ

    Sh, Sl = randn(K, P), randn(K, M)
    cols = P + M + 2 * A
    # each Gram W^T W is symmetric: K A (A + 1) flops (SYRK) suffice;
    # the library yardstick is torch.matmul in fp32 (TF32 off, phase 1)
    out["dict_outer_pair"] = {
        "ms": time_ms(torch, lambda: dict_outer_pair(Sh, Sl, Wh, Wl)),
        "plain_ms": time_ms(torch, lambda: dict_outer_pair(
            Sh, Sl, Wh, Wl, use_kernel=False)),
        "library_ms": time_ms(torch, lambda: (
            Sh.T @ Wh, Sl.T @ Wl, Wh.T @ Wh, Wl.T @ Wl)),
        **outer_bound((K * cols + cols * A) * 4,
                      2 * K * A * (P + M) + 2 * K * A * (A + 1))}

    out["dict_outer"] = {
        "ms": time_ms(torch, lambda: dict_outer(Sh, Wh)),
        "plain_ms": time_ms(torch, lambda: dict_outer(
            Sh, Wh, use_kernel=False)),
        "library_ms": time_ms(torch, lambda: (Sh.T @ Wh, Wh.T @ Wh)),
        **outer_bound((K * (P + A) + (P + A) * A) * 4,
                      2 * K * A * P + K * A * (A + 1))}
    for name, t in out.items():
        extra = (f", fp32 SIMT bound {t['bound_fp32_ms']:.4f}"
                 if "bound_fp32_ms" in t else "")
        log(f"  {name}: {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, "
            f"library {t['library_ms']}, bound {t['bound_ms']:.4f} by "
            f"{t['bound_by']}{extra})")
    return out


# ---------------------------------------------------------------- 11
# the low-rank paths: the deconvolution with the config of
# examples/psf_deconvolution.py:93 (rank 16: the range finder's r = 16 + 8
# = 24) on the main path's stamps, and the completion workload at the
# same matrix shape (n, S * S) with tests/test_problem_api.py:233's config
# (rank 12 + oversample 12: r = 24)
LR_RANK, LR_LAM = 16, 0.05
LR_ITERS, LR_CHUNK = 60, 12
LR_PARITY_N, LR_PARITY_ITERS, LR_PARITY_CHUNK = 256, 24, 8
COMP_N, COMP_P, COMP_TRUE_RANK, COMP_OBSERVED = MAIN_N, STAMP * STAMP, 4, 0.6
COMP_PARITY_N, COMP_PARITY_P = 1024, 128
# the completion's card route against the fp64 trajectory of its algebra:
# within twice the CPU route's distance (tests/test_torch_lowrank.py's
# rule for the port against the JAX package), plus a floor for a CPU
# route that happens to land near the fp64 value
COMP_FP64_FACTOR, COMP_FP64_FLOOR = 2.0, 1e-6
# 24: the paths' r; 3, 25 and 33: odd sides, where each step leaves one
# index out (3: a team of one warp); 32 and 33: 16 and 17 pairs a step,
# either side of half a warp of rotations; 40 and 64: the completion's
# wider range finders
JACOBI_RS = (3, 24, 25, 32, 33, 40, 64)
# the even sides those run (an odd r runs the instance of r + 1), and the
# instances the build must hold without a stack frame: eigh with and
# without vectors and the SVD at each of the 32 even sides up to 64
JACOBI_SIDES = {r + (r & 1) for r in JACOBI_RS}
JACOBI_KERNELS = 3 * 32
NO_FRAME = "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
# a batch of eight at r = 32 beside the batch of four at r = 24
JACOBI_BATCH_R = 32
FP32_EPS = 2.0 ** -23
# Jacobi against torch.linalg, in fp32 units of r eps: reconstruction
# ||A - V diag(w) V^T||_F / ||A||_F, eigenvalue or singular value error /
# max |value| and orthogonality ||V^T V - I||_F within 4 r eps (the
# kernels rotate in fp64, so their outputs carry the final fp32 rounding:
# at most 0.25 r eps in a model of the kernels, tools/lowrank_model.py
# jacobi, held to these bounds by tests/test_torch_jacobi_model.py; the
# same rotations in fp32 left V up to 10 r eps from orthogonal); U checked
# on the columns whose singular value exceeds 1e-3 of the largest (a zero
# singular value has no direction)
JACOBI_REC, JACOBI_VALUES, JACOBI_ORTH = 4, 4, 4
# the whole randomized SVT, card route against the plain route: the range
# finder scales each Gram direction by lambda^-1/2, which magnifies fp32
# rounding; two exact fp32 factorizations give routes about 4e-5 apart in
# relative Frobenius norm at this shape
SVT_REL = 2e-4
# phase 15: the paths' r = 24, r = 32, and the completion's 40 and 64
JACOBI_TIMED_RS = (24, 32, 40, 64)


def jacobi_cases(torch, r, g):
    """(name, matrix, expected count of eigenvalues above 1e-6 of the
    largest or None): a random symmetric matrix, Grams y^T y of rank r and
    r / 2, and eigenvalues with a cluster of r / 3 equal ones."""
    dev = "cuda"

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    x = randn(r, r)
    yield "symmetric", 0.5 * (x + x.T), None
    y = randn(4 * r, r)
    yield "gram rank r", y.T @ y, r
    y = randn(4 * r, r // 2) @ randn(r // 2, r)
    yield "gram rank r/2", y.T @ y, r // 2
    q = torch.linalg.qr(randn(r, r)).Q
    lam = torch.cat([torch.full((r // 3,), 2.0, device=dev),
                     randn(r - r // 3)])
    yield "cluster", (q * lam) @ q.T, None


def _rel_fro(torch, a, b):
    """||a - b||_F / ||b||_F, in fp64."""
    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _orth_err(torch, M):
    M = M.double()
    return float(torch.linalg.norm(M.T @ M - torch.eye(
        M.shape[1], dtype=M.dtype, device=M.device)))


def count_syncs(torch, fn):
    """Host syncs of one call of ``fn`` (torch's sync debug mode), each
    as the source line that made it."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return [f"{'/'.join(Path(w.filename).parts[-2:])}:{w.lineno}"
            for w in caught if "synchroniz" in str(w.message)]


def jacobi_phase(torch):
    """The Jacobi kernels against torch.linalg on the card; the whole
    randomized SVT, card route against plain route; the route's host
    syncs (none: torch.linalg.qr is the one library factorization left
    on it)."""
    from repro_torch.imaging.lowrank import (make_test_matrix,
                                             randomized_svt_local)
    from repro_torch.kernels.jacobi import kernel as jk
    from repro_torch.kernels.jacobi.ops import eigh, svd
    g = torch.Generator(device="cuda").manual_seed(23)
    errs = {"jacobi.eigh": 0.0, "jacobi.svd": 0.0}
    sweeps = {}
    main_cases, batch_cases = [], []
    for r in JACOBI_RS:
        tol_r = r * FP32_EPS
        for name, A, rank in jacobi_cases(torch, r, g):
            if r == 24:
                main_cases.append(A)
            if r == JACOBI_BATCH_R:
                batch_cases.append(A)
            what = f"r={r} {name}"
            w, V = eigh(A)
            w_only = eigh(A, compute_v=False)
            sw_e = int(jk.eigh_fwd.sweeps)
            w_ref = eigh(A, use_kernel=False)[0]
            U, sv, Vh = svd(A)
            sw_s = int(jk.svd_fwd.sweeps)
            sv_ref = torch.linalg.svdvals(A)
            torch.cuda.synchronize()
            scale = float(w_ref.abs().max())
            rec = _rel_fro(torch, (V * w) @ V.T, A)
            orth = _orth_err(torch, V)
            e_w = float((w - w_ref).abs().max())
            clip = int((w > 1e-6 * w.max()).sum())
            clip_ref = int((w_ref > 1e-6 * w_ref.max()).sum())
            s_rec = _rel_fro(torch, (U * sv) @ Vh, A)
            s_orth = _orth_err(torch, Vh.T)
            big = sv > 1e-3 * sv[0]
            u_orth = _orth_err(torch, U[:, big])
            e_s = float((sv - sv_ref).abs().max())
            s_rank = int((sv > 1e-6 * sv[0]).sum())
            s_rank_ref = int((sv_ref > 1e-6 * sv_ref[0]).sum())
            log(f"  {what}: eigh sweeps {sw_e}, rec {rec:.2e}, orth "
                f"{orth:.2e}, eigenvalue err {e_w:.2e} (of {scale:.3g}), "
                f"above the clip {clip}/{clip_ref}; svd sweeps {sw_s}, rec "
                f"{s_rec:.2e}, orth V {s_orth:.2e} U {u_orth:.2e}, "
                f"singular value err {e_s:.2e}, rank {s_rank}/{s_rank_ref}")
            sweeps[what] = {"eigh": sw_e, "svd": sw_s}
            checks = {
                "eigh reconstruction": rec <= JACOBI_REC * tol_r,
                "eigh orthogonality": orth <= JACOBI_ORTH * tol_r,
                "eigenvalues": e_w <= JACOBI_VALUES * tol_r * scale,
                "ascending": bool((w[1:] >= w[:-1]).all()),
                "eigenvalues without vectors": torch.equal(w_only, w),
                "clip count": clip == clip_ref and rank in (None, clip),
                "svd reconstruction": s_rec <= JACOBI_REC * tol_r,
                "svd orthogonality": max(s_orth, u_orth)
                <= JACOBI_ORTH * tol_r,
                "singular values": e_s <= JACOBI_VALUES * tol_r
                * float(sv_ref[0]),
                "descending": bool((sv[1:] <= sv[:-1]).all()),
                "svd rank": s_rank == s_rank_ref
                and rank in (None, s_rank)}
            failed = [k for k, ok in checks.items() if not ok]
            if failed:
                raise AssertionError(f"jacobi {what}: {failed}")
            if r == 24 and rank == r:
                # the main path's size and kind of matrix
                errs["jacobi.eigh"] = e_w
                errs["jacobi.svd"] = e_s
                again = (eigh(A), svd(A))
                if not (all(torch.equal(a, b) for a, b in zip(again[0],
                                                               (w, V)))
                        and all(torch.equal(a, b) for a, b in zip(
                            again[1], (U, sv, Vh)))):
                    raise AssertionError(f"jacobi {what}: two calls differ")
                log(f"  jacobi {what}: two calls bit-identical")
    # batches, one block a matrix: each matrix's result bit for bit as in
    # its own call; four at r = 24, eight at r = 32 (the four cases and
    # four more of the same kinds)
    batch_cases += [A for _, A, _ in jacobi_cases(torch, JACOBI_BATCH_R, g)]
    for cases in (main_cases, batch_cases):
        batch = torch.stack(cases)
        (w_b, V_b), (U_b, s_b, Vh_b) = eigh(batch), svd(batch)
        for i, A in enumerate(cases):
            if not (all(torch.equal(a, b[i]) for a, b in zip(eigh(A),
                                                             (w_b, V_b)))
                    and all(torch.equal(a, b[i]) for a, b in zip(
                        svd(A), (U_b, s_b, Vh_b)))):
                raise AssertionError(f"jacobi: batch {tuple(batch.shape)} "
                                     f"entry {i} differs from its own call")
        log(f"  jacobi batch {tuple(batch.shape)}: every entry bit-identical "
            f"to its own call")
    # the whole SVT at the main path's shape: a rank-16 signal and noise,
    # threshold inside the signal's singular values
    n, p, k = MAIN_N, STAMP * STAMP, LR_RANK
    cg = torch.Generator().manual_seed(29)
    a = (torch.randn(n, k, generator=cg) @ torch.randn(k, p, generator=cg)
         + 0.5 * torch.randn(n, p, generator=cg)).to("cuda")
    omega = make_test_matrix(p, k, device="cuda")
    thresh = float(torch.linalg.svdvals(a)[k // 2])
    got = randomized_svt_local(a, omega, thresh)
    want = randomized_svt_local(a, omega, thresh, use_kernel=False)
    torch.cuda.synchronize()
    gap = _rel_fro(torch, got, want)
    max_err = float((got - want).abs().max())
    # the first call under the sync debug mode in a process can report
    # one sync raised from torch's own Python code, a bare
    # torch.linalg.qr's as well, and none on its next call: the second
    # call is the one held
    first = count_syncs(torch, lambda: randomized_svt_local(a, omega, thresh))
    syncs = count_syncs(torch, lambda: randomized_svt_local(a, omega, thresh))
    log(f"  randomized_svt_local ({n}, {p}) r={omega.shape[1]}: card route "
        f"against plain route relative Frobenius gap {gap:.3e} (bound "
        f"{SVT_REL}), max abs err {max_err:.3e}; host syncs in two calls "
        f"{first} and {syncs}")
    if not gap <= SVT_REL:
        raise AssertionError(f"randomized SVT routes {gap} apart")
    if syncs:
        raise AssertionError(f"the card route of the randomized SVT syncs "
                             f"at {syncs}")
    return errs, {"sweeps": sweeps, "svt_rel_gap": gap,
                  "svt_max_abs_err": max_err, "svt_syncs": len(syncs)}


# ---------------------------------------------------------------- 12
# kernel-name fragments -> the part of the low-rank iteration they belong to
LR_PARTS = (("condat_elwise.primal", ("condat_primal",)),
            ("jacobi", ("jacobi",)),
            # cuSOLVER's Householder QR (geqrf) and the reduced Q (orgqr)
            ("qr", ("geqr", "orgqr", "ormqr", "larf", "householder")),
            ("fft", ("fft", "FFT")),
            ("cublas_gemm", ("gemm", "Gemm", "GEMM", "gemv")))


def lowrank_path_phase(torch):
    from repro_torch.core.problem import solve
    from repro_torch.imaging.condat import SolverConfig
    from repro_torch.imaging.psf import simulate

    data = simulate(MAIN_N, torch.Generator().manual_seed(42), stamp=STAMP)
    cfg = SolverConfig(mode="lowrank", n_scales=SCALES, lam=LR_LAM,
                       rank=LR_RANK)
    torch.cuda.synchronize()
    reset_launches()
    sol, wall, syncs_per_chunk = run_counting_syncs(
        torch, lambda progress: solve(
            "deconvolve", data.Y, data.psfs, cfg=cfg, max_iter=LR_ITERS,
            chunk=LR_CHUNK, cost_every="chunk", tol=0.0,
            progress_fn=progress))
    launches = read_launches()
    it = sol.log.iters_run
    chunks = -(-it // LR_CHUNK)
    log(f"low-rank path: n={MAIN_N} rank={LR_RANK} iters_run={it} wall "
        f"{wall:.2f} s, launches {launches}")
    want = {"condat_elwise.primal": it, "condat_elwise.primal_xbar": it,
            "jacobi.svd": it, "jacobi.eigh": it + chunks}
    want.update({k: 0 for k in DECONV_KERNELS + SCDL_KERNELS
                 if k != "condat_elwise.primal"})
    if it != LR_ITERS or any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"low-rank launches {launches}, expected "
                             f"{want} over {LR_ITERS} iterations")
    if syncs_per_chunk != 1:
        raise AssertionError(f"{syncs_per_chunk} host syncs per chunk, "
                             f"expected 1")
    evaluated = evaluated_costs(sol.log.costs, LR_CHUNK)
    if not all(math.isfinite(c) for c in evaluated):
        raise AssertionError(f"non-finite evaluated cost: {evaluated}")
    # the primal-dual cost is not monotone: tests/test_imaging.py's bound
    if not max(evaluated[1:]) <= 1.1 * evaluated[0]:
        raise AssertionError(f"low-rank cost grew past 1.1 x its first "
                             f"value: {evaluated}")
    x = torch.as_tensor(sol.x, device="cuda")
    mse_dec = float(torch.mean((x - data.X_true) ** 2))
    mse_obs = float(torch.mean((data.Y - data.X_true) ** 2))
    if not mse_dec < mse_obs:
        raise AssertionError(f"deconvolved MSE {mse_dec:.3e} not below "
                             f"observation MSE {mse_obs:.3e}")
    chunk_ms = [t * 1e3 for t in sol.log.times[LR_CHUNK::LR_CHUNK]]
    ms_per_iter = statistics.median(chunk_ms)
    log(f"low-rank path: evaluated costs {[round(c, 6) for c in evaluated]}"
        f"; MSE deconvolved {mse_dec:.3e} vs observed {mse_obs:.3e}; "
        f"{ms_per_iter} ms/iteration (median over chunks after the first); "
        f"host syncs per chunk {syncs_per_chunk}")
    return {"n": MAIN_N, "rank": LR_RANK, "iters_run": it,
            "launches": launches, "ms_per_iter": ms_per_iter,
            "chunk_ms": chunk_ms, "syncs_per_chunk": syncs_per_chunk,
            "wall_s": wall, "costs": evaluated, "mse_deconvolved": mse_dec,
            "mse_observed": mse_obs}, sol.bundle, cfg


def lowrank_profile_phase(torch, bundle, cfg):
    """One more chunk of the low-rank iteration, continued from the
    path's final state, under ``torch.profiler``."""
    from repro_torch.imaging.deconvolve import make_light_step_fn
    light = make_light_step_fn(cfg)
    state = {"d": light(bundle.data, bundle.replicated, ())}

    def body():
        for _ in range(LR_CHUNK):
            state["d"] = light(state["d"], bundle.replicated, ())

    out = profile_window(torch, body, LR_CHUNK, LR_PARTS)
    log(f"low-rank profile: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------- 13
def lowrank_parity_phase(torch):
    from repro_torch.core.problem import solve
    from repro_torch.imaging.condat import SolverConfig
    from repro_torch.imaging.psf import simulate
    data = simulate(LR_PARITY_N, torch.Generator().manual_seed(5),
                    stamp=STAMP, device="cpu")
    cfg = SolverConfig(mode="lowrank", n_scales=SCALES, lam=LR_LAM,
                       rank=LR_RANK)
    runs = {dev: solve("deconvolve", data.Y, data.psfs, cfg=cfg, device=dev,
                       max_iter=LR_PARITY_ITERS, chunk=LR_PARITY_CHUNK,
                       cost_every=1, tol=0.0)
            for dev in ("cuda", "cpu")}
    gap, x_gap = cost_gap(runs, f"low-rank card vs CPU at n={LR_PARITY_N}")
    return {"n": LR_PARITY_N, "max_rel_cost_gap": gap, "max_abs_x_gap": x_gap}


# ---------------------------------------------------------------- 14
def completion_data(torch, n, p, seed, device):
    """A rank-4 truth from seeded Gaussian factors and a mask observing
    60 % of it (tests/test_problem_api.py's recipe)."""
    g = torch.Generator().manual_seed(seed)
    A = torch.randn(n, COMP_TRUE_RANK, generator=g) @ \
        torch.randn(COMP_TRUE_RANK, p, generator=g)
    M = (torch.rand(n, p, generator=g) < COMP_OBSERVED).float()
    return A.to(device), M.to(device)


def completion_fp64(torch, cfg, A, M, iters, omega=None):
    """The completion's cost trajectory in fp64 on the CPU: the port's
    own step and cost (``LowRankCompletionProblem.full_step``, the plain
    factorizations) on fp64 copies of the data and of the test matrix
    (``omega``, or the one the fp32 runs draw).  The value that the
    card's and the CPU's fp32 routes both approximate."""
    import numpy as np
    from repro_torch.imaging.lowrank import (LowRankCompletionProblem,
                                             resolve_omega)
    Y, M = (A * M).double().cpu(), M.double().cpu()
    omega = resolve_omega(omega, Y.shape[1], cfg.rank, cfg.oversample, "cpu")
    rep, d = {"omega": omega.double()}, {"Y": Y, "M": M, "X": Y.clone()}
    problem, costs = LowRankCompletionProblem(cfg), []
    for _ in range(iters):
        d, cost = problem.full_step(d, rep, ())
        costs.append(float(cost["cost"]))
    return np.asarray(costs)


def completion_run(torch, cfg, A, M):
    """One completion solve on the card: launches, one host sync per
    chunk, finite costs; returns its chunk-end costs, ms per iteration,
    relative recovery error, and the profile of one more chunk."""
    from repro_torch.core.problem import solve
    from repro_torch.imaging.lowrank import LowRankCompletionProblem
    from repro_torch.kernels.jacobi import kernel as jk
    torch.cuda.synchronize()
    reset_launches()
    sol, wall, syncs_per_chunk = run_counting_syncs(
        torch, lambda progress: solve(
            "lowrank", A, M, cfg=cfg, max_iter=LR_ITERS, chunk=LR_CHUNK,
            cost_every="chunk", tol=0.0, progress_fn=progress))
    launches = read_launches()
    it = sol.log.iters_run
    chunks = -(-it // LR_CHUNK)
    want = {"jacobi.svd": it, "jacobi.eigh": it + chunks}
    want.update({k: 0 for k in DECONV_KERNELS + SCDL_KERNELS
                 + ("condat_elwise.primal_xbar",)})
    r = cfg.rank + cfg.oversample
    if it != LR_ITERS or any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"completion r={r} launches {launches}, "
                             f"expected {want}")
    if syncs_per_chunk != 1:
        raise AssertionError(f"completion r={r}: {syncs_per_chunk} host "
                             f"syncs per chunk, expected 1")
    evaluated = evaluated_costs(sol.log.costs, LR_CHUNK)
    if not all(math.isfinite(c) for c in evaluated):
        raise AssertionError(f"completion r={r}: non-finite cost "
                             f"{evaluated}")
    x = torch.as_tensor(sol.x, device="cuda")
    err = float(torch.linalg.norm(x - A) / torch.linalg.norm(A))
    ms = statistics.median(t * 1e3 for t in
                           sol.log.times[LR_CHUNK::LR_CHUNK])
    # the last launches: the last iteration's SVD, the last cost's eigvalsh
    sweeps = {"eigh": int(jk.eigh_fwd.sweeps), "svd": int(jk.svd_fwd.sweeps)}
    log(f"completion r={r}: ({COMP_N}, {COMP_P}), iters_run={it}, wall "
        f"{wall:.2f} s, launches {launches}; costs "
        f"{[round(c, 3) for c in evaluated]}; relative error {err:.3e}; "
        f"{ms} ms/iteration (median over chunks after the first); host "
        f"syncs per chunk {syncs_per_chunk}; sweeps of the last calls "
        f"{sweeps}")
    # one more chunk of the iteration, continued from the solve's final
    # state, under torch.profiler
    problem, state = LowRankCompletionProblem(cfg), {"d": sol.bundle.data}

    def body():
        for _ in range(LR_CHUNK):
            state["d"] = problem.light_step(state["d"],
                                            sol.bundle.replicated, ())

    profile = profile_window(torch, body, LR_CHUNK, LR_PARTS)
    log(f"completion r={r} profile: {json.dumps(profile)}")
    return {"r": r, "iters_run": it, "launches": launches,
            "ms_per_iter": ms, "syncs_per_chunk": syncs_per_chunk,
            "wall_s": wall, "costs": evaluated, "rel_err": err,
            "last_sweeps": sweeps, "profile": profile}


def completion_phase(torch):
    """The completion workload at (10 000, 1681).  First with the config
    of tests/test_problem_api.py:233 (r = 24), whose range finder is too
    narrow at this size: the reference algebra's cost is least at
    iteration 15 and then grows, the same on the CPU in fp64
    (tools/lowrank_model.py completion), so that run is held to
    launches, syncs and finite costs and its trajectory is reported.
    Then with oversample 52 (r = 64, the kernels' largest side), where
    the same algebra converges: the cost must fall and the recovery error
    drop below the masked input's.  Last, the r = 24 config card against
    CPU at (1024, 128), at PARITY_RTOL; and, since the range finder scales
    each Gram direction by lambda^-1/2 and so magnifies rounding, each
    route against the fp64 trajectory of the same algebra: the card
    within twice the CPU's distance from it."""
    import numpy as np

    from repro_torch.core.problem import solve
    from repro_torch.imaging.lowrank import CompletionConfig
    cfg = CompletionConfig(rank=12, oversample=12, lam=0.2, step=0.9)
    wide = CompletionConfig(rank=12, oversample=52, lam=0.2, step=0.9)
    A, M = completion_data(torch, COMP_N, COMP_P, 31, "cuda")
    err0 = float(torch.linalg.norm(M * A - A) / torch.linalg.norm(A))
    log(f"completion: true rank {COMP_TRUE_RANK}, {COMP_OBSERVED:.0%} "
        f"observed, relative error of the masked input {err0:.4f}")
    out = {"n": COMP_N, "p": COMP_P, "rel_err_masked": err0,
           "r24": completion_run(torch, cfg, A, M),
           "r64": completion_run(torch, wide, A, M)}
    wide_run = out["r64"]
    if not wide_run["costs"][-1] < wide_run["costs"][0] or \
            not wide_run["rel_err"] < err0:
        raise AssertionError(f"completion r=64 did not converge: costs "
                             f"{wide_run['costs']}, relative error "
                             f"{wide_run['rel_err']} against {err0}")
    out["ms_per_iter"] = out["r24"]["ms_per_iter"]
    out["syncs_per_chunk"] = out["r24"]["syncs_per_chunk"]
    Ap, Mp = completion_data(torch, COMP_PARITY_N, COMP_PARITY_P, 37, "cpu")
    runs = {dev: solve("lowrank", Ap, Mp, cfg=cfg, device=dev,
                       max_iter=LR_PARITY_ITERS, chunk=LR_PARITY_CHUNK,
                       cost_every=1, tol=0.0)
            for dev in ("cuda", "cpu")}
    label = f"completion card vs CPU at ({COMP_PARITY_N}, {COMP_PARITY_P})"
    gap, x_gap = cost_gap(runs, label)
    exact = completion_fp64(torch, cfg, Ap, Mp, LR_PARITY_ITERS)
    dist = {dev: float(np.max(np.abs(np.asarray(sol.log.costs) - exact)
                              / np.abs(exact)))
            for dev, sol in runs.items()}
    log(f"{label}: largest relative distance of the cost trajectory from "
        f"the fp64 one, card {dist['cuda']:.3e}, CPU {dist['cpu']:.3e} "
        f"(bound {COMP_FP64_FACTOR} x the CPU's + {COMP_FP64_FLOOR})")
    if not dist["cuda"] <= COMP_FP64_FACTOR * dist["cpu"] + COMP_FP64_FLOOR:
        raise AssertionError(f"{label}: the card lies {dist['cuda']} from "
                             f"the fp64 trajectory, the CPU {dist['cpu']}")
    out["parity"] = {"n": COMP_PARITY_N, "p": COMP_PARITY_P,
                     "max_rel_cost_gap": gap, "max_abs_x_gap": x_gap,
                     "fp64_rel_dist_cuda": dist["cuda"],
                     "fp64_rel_dist_cpu": dist["cpu"]}
    return out


# ---------------------------------------------------------------- 15
def jacobi_bound(name, r):
    """What the function needs, whatever the sweeps the kernel takes.
    Bytes: the matrix read once and the factors written once (eigh: r^2
    in, r^2 + r out; svd: r^2 in, 2 r^2 + r out).  Operations: a dense
    factorization's count, 9 r^3 for a symmetric eigendecomposition with
    vectors and 22 r^3 for an SVD with both sets of vectors (Golub and
    Van Loan's counts).  Both lie far under the kernels' chain of sweeps
    x (r - 1) dependent steps, which the phase prints beside them."""
    words, flops = {"jacobi.eigh": (2 * r * r + r, 9 * r ** 3),
                    "jacobi.svd": (3 * r * r + r, 22 * r ** 3)}[name]
    return bound(words * 4, flops)


def lowrank_timing_phase(torch):
    from repro_torch.kernels.condat_elwise.ops import condat_primal
    from repro_torch.kernels.jacobi import kernel as jk
    from repro_torch.kernels.jacobi.ops import eigh, svd
    g = torch.Generator(device="cuda").manual_seed(41)
    out = {}
    X, Ua, gr = (torch.randn((MAIN_N, STAMP, STAMP), generator=g,
                             device="cuda") for _ in range(3))
    tau = torch.tensor(0.31, device="cuda")
    elems = X.numel()
    # three planes read, two written
    t_bound, by = bound(5 * elems * 4, 6 * elems)
    out["condat_elwise.primal_xbar"] = {
        "ms": time_ms(torch, lambda: condat_primal(X, Ua, gr, tau,
                                                   with_xbar=True)),
        "plain_ms": time_ms(torch, lambda: condat_primal(
            X, Ua, gr, tau, with_xbar=True, use_kernel=False)),
        "library_ms": None, "bound_ms": t_bound, "bound_by": by}
    del X, Ua, gr
    by_r = {}
    for r in JACOBI_TIMED_RS:
        # the path's matrices: the Gram of an (n, r) projection, and R^T
        # of the QR of an (S * S, r) one
        y = torch.randn((MAIN_N, r), generator=g, device="cuda")
        G = y.T @ y
        Rt = torch.linalg.qr(torch.randn((STAMP * STAMP, r), generator=g,
                                         device="cuda")).R.T.contiguous()
        eigh(G)
        svd(Rt)
        sw_e, sw_s = int(jk.eigh_fwd.sweeps), int(jk.svd_fwd.sweeps)
        for name, fn, plain, lib, sw in (
                ("jacobi.eigh", lambda: eigh(G),
                 lambda: eigh(G, use_kernel=False),
                 lambda: torch.linalg.eigh(G), sw_e),
                ("jacobi.svd", lambda: svd(Rt),
                 lambda: svd(Rt, use_kernel=False),
                 lambda: torch.linalg.svd(Rt), sw_s)):
            t_bound, by = jacobi_bound(name, r)
            t = {"ms": time_ms(torch, fn), "plain_ms": time_ms(torch, plain),
                 "library_ms": time_ms(torch, lib), "bound_ms": t_bound,
                 "bound_by": by, "r": r, "sweeps": sw,
                 "dependent_steps": sw * (r + (r & 1) - 1)}
            t["us_per_step"] = 1e3 * t["ms"] / t["dependent_steps"]
            by_r.setdefault(name, {})[str(r)] = t
            log(f"  {name} r={r}: {t['ms']:.4f} ms (plain {t['plain_ms']:.4f},"
                f" torch.linalg {t['library_ms']:.4f}, both syncing to the "
                f"host; bound {t_bound:.6f} by {by}; {sw} sweeps, "
                f"{t['dependent_steps']} dependent steps, "
                f"{t['us_per_step']:.3f} us a step)")
    for name, rows in by_r.items():
        out[name] = {**rows["24"], "by_r": rows}
    t = out["condat_elwise.primal_xbar"]
    log(f"  condat_elwise.primal_xbar: {t['ms']:.4f} ms (plain "
        f"{t['plain_ms']:.4f}, bound {t['bound_ms']:.4f} by {t['bound_by']})")
    return out


# ------------------------------------------------------ 3 and 6, per instance
# a bucket of solve_many: phase 4's 10 000 stamps split in order into
# eight instances (capacity 1350, 7.4 % of the rows padding)
BUCKET_SIZES = (1150, 1200, 1250, 1300, 1350, 1250, 1200, 1300)
BUCKET_CAP = max(BUCKET_SIZES)
# many small instances: 64 of 120-180 stamps, the host-bound regime
SMALL_COUNT, SMALL_RANGE = 64, (120, 181)
# phase 18: the completion at r = 64 and SCDL, four instances each
COMP_BUCKET_ROWS = (2400, 2500, 2600, 2500)
SCDL_BUCKET_K, SCDL_BUCKET_N = 10_000, 4
# each instance of a bucket against its own single solve on the card
BUCKET_RTOL = 1e-4


def batched_condat_phase(torch):
    """The per-instance Condat passes (a tau and a sig per instance)
    against their plain versions: count 1 and 8, at the bucket's layout
    (8 x 1350 stamps of 41 x 41, J = 4) and a ragged one (37 stamps of
    21 x 21 an instance), fp32 and bf16; each instance of a batch of
    eight bit-identical to its own call with one step size."""
    from repro_torch.kernels.condat_elwise.ops import (condat_dual,
                                                       condat_primal)
    g = torch.Generator(device="cuda").manual_seed(23)
    f32, bf16 = torch.float32, torch.bfloat16
    errs = {"condat_elwise.primal_batched": 0.0,
            "condat_elwise.dual_batched": 0.0}

    def randn(shape, dtype):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    for B, n, S, dtype in ((8, BUCKET_CAP, STAMP, f32),
                           (1, BUCKET_CAP, STAMP, f32),
                           (8, 37, 21, f32), (8, 37, 21, bf16),
                           (8, 130, STAMP, bf16), (1, 37, 21, bf16)):
        name = str(dtype).split(".")[1]
        tol = TOL[name]
        tau = torch.linspace(0.2, 0.5, B, device="cuda")
        sig = torch.linspace(0.3, 0.6, B, device="cuda")
        X, Ua, gr = (randn((B, n, S, S), dtype) for _ in range(3))
        xn, xb = condat_primal(X, Ua, gr, tau, with_xbar=True)
        rn, rb = condat_primal(X, Ua, gr, tau, with_xbar=True,
                               use_kernel=False)
        got = condat_primal(X, Ua, gr, tau)
        torch.cuda.synchronize()
        label = f"count={B} ({B}, {n}, {S}, {S}) {name}"
        e = max(compare(f"primal {label}", got, rn, tol),
                compare(f"primal+xbar X_new {label}", xn, rn, tol),
                compare(f"primal+xbar X_bar {label}", xb, rb, tol))
        same = all(torch.equal(got[b], condat_primal(X[b], Ua[b], gr[b],
                                                     tau[b]))
                   and torch.equal(xb[b], condat_primal(
                       X[b], Ua[b], gr[b], tau[b], with_xbar=True)[1])
                   for b in range(B))
        del X, Ua, gr, xn, xb, rn, rb, got
        U, Cn, Co = (randn((SCALES, B, n, S, S), dtype) for _ in range(3))
        W = torch.rand((SCALES, B, n, 1, 1), generator=g,
                       device="cuda").to(dtype)
        got = condat_dual(U, Cn, Co, W, sig)
        want = condat_dual(U, Cn, Co, W, sig, use_kernel=False)
        torch.cuda.synchronize()
        ed = compare(f"dual count={B} ({SCALES}, {B}, {n}, {S}, {S}) {name}",
                     got, want, tol)
        same = same and all(
            torch.equal(got[:, b], condat_dual(
                *(x[:, b].contiguous() for x in (U, Cn, Co, W)), sig[b]))
            for b in range(B))
        if not same:
            raise AssertionError(f"per-instance Condat {label}: an instance "
                                 f"differs from its own call")
        if B > 1:
            log(f"  count={B} ({n}, {S}, {S}) {name}: every instance "
                f"bit-identical to its own call")
        if (B, n, S, dtype) == (8, BUCKET_CAP, STAMP, f32):
            errs["condat_elwise.primal_batched"] = e
            errs["condat_elwise.dual_batched"] = ed
        del U, Cn, Co, W, got, want
    return errs


def batched_timing_phase(torch):
    """The per-instance passes at count 8 on phase 17's bucket, beside
    the same stamps as one instance (count 1)."""
    from repro_torch.kernels.condat_elwise.ops import (condat_dual,
                                                       condat_primal)
    g = torch.Generator(device="cuda").manual_seed(29)
    B, n = len(BUCKET_SIZES), BUCKET_CAP
    X, Ua, gr = (torch.randn((B, n, STAMP, STAMP), generator=g,
                             device="cuda") for _ in range(3))
    taus = {8: torch.linspace(0.2, 0.5, B, device="cuda"),
            1: torch.tensor(0.31, device="cuda")}
    elems = X.numel()
    out = {}
    t_bound, by = bound(4 * elems * 4 + B * 4, 5 * elems)
    t = {c: time_ms(torch, lambda c=c: condat_primal(X, Ua, gr, taus[c]))
         for c in (8, 1)}
    out["condat_elwise.primal_batched"] = {
        "ms": t[8], "count1_ms": t[1],
        "plain_ms": time_ms(torch, lambda: condat_primal(
            X, Ua, gr, taus[8], use_kernel=False)),
        "library_ms": None, "bound_ms": t_bound, "bound_by": by,
        "shape": [B, n, STAMP, STAMP]}
    del X, Ua, gr
    shape = (SCALES, B, n, STAMP, STAMP)
    U, Cn, Co = (torch.randn(shape, generator=g, device="cuda")
                 for _ in range(3))
    W = torch.rand(shape[:3] + (1, 1), generator=g, device="cuda")
    sigs = {8: torch.linspace(0.3, 0.6, B, device="cuda"),
            1: torch.tensor(0.47, device="cuda")}
    m = U.numel()
    t_bound, by = bound(4 * m * 4 + W.numel() * 4 + B * 4, 6 * m)
    t = {c: time_ms(torch, lambda c=c: condat_dual(U, Cn, Co, W, sigs[c]))
         for c in (8, 1)}
    out["condat_elwise.dual_batched"] = {
        "ms": t[8], "count1_ms": t[1],
        "plain_ms": time_ms(torch, lambda: condat_dual(
            U, Cn, Co, W, sigs[8], use_kernel=False)),
        "library_ms": None, "bound_ms": t_bound, "bound_by": by,
        "shape": list(shape)}
    for name, r in out.items():
        log(f"  {name} {tuple(r['shape'])}: count 8 {r['ms']:.4f} ms, "
            f"count 1 {r['count1_ms']:.4f} (plain {r['plain_ms']:.4f}, "
            f"bound {r['bound_ms']:.4f} by {r['bound_by']})")
    return out


# ---------------------------------------------------------------- 16
CKPT_EVERY, CKPT_RESUME_AT = 24, 48


def checkpoint_phase(torch):
    """Phase 4's solve (tol 0: all 60 iterations) with checkpoints every
    24 iterations into a scratch directory under build/, then a resume
    from step 48: iterations 48-59 must give the uninterrupted run's
    evaluated cost and final iterate bit for bit, and the checkpointed
    run one host sync per chunk on this thread."""
    import shutil

    import numpy as np

    from repro_torch.core.problem import solve
    from repro_torch.imaging.condat import SolverConfig
    from repro_torch.imaging.psf import simulate
    data = simulate(MAIN_N, torch.Generator().manual_seed(42), stamp=STAMP)
    cfg = SolverConfig(mode="sparse", n_scales=SCALES)
    kw = dict(cfg=cfg, max_iter=MAIN_ITERS, chunk=MAIN_CHUNK,
              cost_every="chunk", tol=0.0)
    ckdir = ROOT / "build" / "chip_smoke_checkpoints"
    shutil.rmtree(ckdir, ignore_errors=True)
    try:
        full = solve("deconvolve", data.Y, data.psfs, **kw)
        part, wall, syncs = run_counting_syncs(
            torch, lambda progress: solve(
                "deconvolve", data.Y, data.psfs, checkpoint_dir=ckdir,
                checkpoint_every=CKPT_EVERY, progress_fn=progress, **kw))
        ck = part.checkpointer
        steps = sorted(int(p.name.split("_")[1]) for p in ckdir.iterdir())
        nbytes = sum(f.stat().st_size for f in
                     (ckdir / f"step_{CKPT_RESUME_AT:08d}").iterdir())
        rest = solve("deconvolve", data.Y, data.psfs, checkpoint_dir=ckdir,
                     resume=True, **kw)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    if steps != list(range(CKPT_EVERY, MAIN_ITERS + 1, CKPT_EVERY)):
        raise AssertionError(f"checkpoints at {steps}")
    if syncs != 1:
        raise AssertionError(f"checkpointed run: {syncs} host syncs per "
                             f"chunk, expected 1")
    if part.log.costs != full.log.costs:
        raise AssertionError("checkpoints changed the trajectory")
    tail = full.log.costs[CKPT_RESUME_AT:]
    want = [float("inf")] * (MAIN_CHUNK - 1) + tail[MAIN_CHUNK - 1:]
    if rest.log.costs != want or not np.array_equal(rest.x, full.x):
        raise AssertionError(
            f"resume from {CKPT_RESUME_AT}: costs {rest.log.costs[-1]!r} "
            f"against {tail[-1]!r}, iterates equal "
            f"{np.array_equal(rest.x, full.x)}")

    def ms(sol):
        return statistics.median(t * 1e3 for t in
                                 sol.log.times[MAIN_CHUNK::MAIN_CHUNK])

    out = {"checkpoint_steps": steps, "bytes": nbytes,
           "syncs_per_chunk": syncs, "ms_per_iter": ms(full),
           "ms_per_iter_checkpointed": ms(part), "wall_s": wall,
           "spill_s": ck.spill_seconds, "write_s": ck.write_seconds,
           "resumed_last_cost": rest.log.costs[-1]}
    log(f"checkpoints: steps {steps}, {nbytes / 1e9:.3f} GB each; this "
        f"thread's spill {[round(s * 1e3, 3) for s in ck.spill_seconds]} "
        f"ms, the writer's {[round(s, 3) for s in ck.write_seconds]} s a "
        f"checkpoint; {out['ms_per_iter_checkpointed']} ms/iteration with "
        f"checkpoints, {out['ms_per_iter']} without; host syncs per chunk "
        f"{syncs}; resume from {CKPT_RESUME_AT}: cost and iterate "
        f"bit-identical to the uninterrupted run")
    return out


# ---------------------------------------------------------------- 17
def bucket_ms(sols, chunk):
    """A bucket's ms per iteration: the median over its chunks after the
    first of the chunk's wall time (every live instance logs it)."""
    log_ = max((s.log for s in sols), key=lambda lg: len(lg.times))
    return statistics.median(t * 1e3 for t in log_.times[chunk::chunk])


def single_ms(sol, chunk):
    return statistics.median(t * 1e3 for t in sol.log.times[chunk::chunk])


def hold_instances(label, sols, singles, rtol=BUCKET_RTOL):
    """Each instance of a bucket against its own single solve: equal
    ``iters_run``, finite entries alike, cost trajectories within rtol;
    returns the largest relative gap."""
    import numpy as np
    gap, where = 0.0, None
    for j, (sol, ref) in enumerate(zip(sols, singles)):
        if sol.log.iters_run != ref.log.iters_run:
            raise AssertionError(f"{label} instance {j}: iters_run "
                                 f"{sol.log.iters_run} != "
                                 f"{ref.log.iters_run}")
        a, b = np.asarray(sol.log.costs), np.asarray(ref.log.costs)
        fin = np.isfinite(b)
        if a.shape != b.shape or not np.array_equal(np.isfinite(a), fin):
            raise AssertionError(f"{label} instance {j}: cost entries "
                                 f"differ")
        rel = np.abs(a[fin] - b[fin]) / np.abs(b[fin])
        if rel.size and float(rel.max()) > gap:
            k = int(np.argmax(rel))
            gap = float(rel[k])
            where = (j, int(np.flatnonzero(fin)[k]), float(a[fin][k]),
                     float(b[fin][k]))
    if rtol is not None and not gap <= rtol:
        raise AssertionError(f"{label}: an instance lies {gap} from its "
                             f"single solve (rtol {rtol}); (instance, "
                             f"iteration, bucket, single) {where}")
    return gap


def profile_bucket(torch, problem, insts, chunk, parts):
    """One chunk of a bucket's cost-free iteration under torch.profiler,
    on the bucket's state as ``solve_many`` stacks it."""
    from repro_torch.core import batching
    from repro_torch.core.problem import stack_bucket
    [bucket] = batching.plan_buckets(insts, problem.batch_axes())
    state, shared, _ = stack_bucket(problem, bucket, insts, "cuda")
    box = {"d": state["d"], "rep": {**shared, **state["r"]}}
    del state

    def one():
        if problem.replicated_in_carry:
            box["d"], aux = problem.light_step(box["d"], box["rep"], ())
            box["rep"] = problem.refresh_replicated(box["rep"], aux)
        else:
            box["d"] = problem.light_step(box["d"], box["rep"], ())

    one()

    def body():
        for _ in range(chunk):
            one()

    return profile_window(torch, body, chunk, parts)


def run_bucket(torch, label, key, insts, cfg, chunk, rtol=BUCKET_RTOL,
               **kw):
    """``solve_many`` on the card under the launch counters and the sync
    count; then each instance alone (``solve``)."""
    from repro_torch.core.problem import solve, solve_many
    torch.cuda.synchronize()
    reset_launches()
    sols, wall, syncs = run_counting_syncs(
        torch, lambda progress: solve_many(key, insts, cfg=cfg, chunk=chunk,
                                           progress_fn=progress, **kw))
    launches = read_launches()
    if syncs != 1:
        raise AssertionError(f"{label}: {syncs} host syncs per chunk, "
                             f"expected 1")
    t0 = time.perf_counter()
    singles = [solve(key, *inst, cfg=cfg, chunk=chunk, **kw)
               for inst in insts]
    torch.cuda.synchronize()
    singles_wall = time.perf_counter() - t0
    gap = hold_instances(label, sols, singles, rtol)
    out = {"instances": len(insts),
           "shapes": [list(inst[0].shape) for inst in insts],
           "iters": max(s.log.iters_run for s in sols),
           "iters_run": [s.log.iters_run for s in sols],
           "launches": launches, "syncs_per_chunk": syncs,
           "wall_s": wall, "singles_wall_s": singles_wall,
           "ms_per_iter": bucket_ms(sols, chunk),
           "singles_ms_per_iter": [single_ms(s, chunk) for s in singles],
           "max_rel_cost_gap_to_single": gap}
    out["singles_ms_per_iter_sum"] = sum(out["singles_ms_per_iter"])
    log(f"{label}: {len(insts)} instances, iters_run {out['iters_run']}, "
        f"launches {launches}; {out['ms_per_iter']} ms/iteration for the "
        f"bucket against {out['singles_ms_per_iter_sum']:.4f} summed over "
        f"the single solves; wall {wall:.2f} s against {singles_wall:.2f} "
        f"s; host syncs per chunk {syncs}; largest relative cost gap to "
        f"the single solves {gap:.3e} (rtol {rtol})")
    return out, sols, singles


# phase 17's bucket of eight and its single solves, for phase 20
PHASE17 = {}


def bucket_phase(torch, main_ms):
    """Phase 4's stamps as a bucket of eight instances, sparse and low
    rank; 64 small instances as one bucket."""
    import numpy as np

    from repro_torch.core import batching
    from repro_torch.imaging.condat import SolverConfig
    from repro_torch.imaging.deconvolve import DeconvolutionProblem
    from repro_torch.imaging.psf import simulate
    data = simulate(MAIN_N, torch.Generator().manual_seed(42), stamp=STAMP)
    edges = np.cumsum((0,) + BUCKET_SIZES)
    insts = [(data.Y[a:b], data.psfs[a:b])
             for a, b in zip(edges[:-1], edges[1:])]
    cfg = SolverConfig(mode="sparse", n_scales=SCALES)
    problem = DeconvolutionProblem(cfg)
    plan = batching.plan_buckets(insts, problem.batch_axes())
    log(f"bucket plan: {[(b.capacity, len(b.indices), round(b.waste, 4)) for b in plan]} "
        f"(capacity, instances, padding share)")
    if len(plan) != 1 or plan[0].capacity != BUCKET_CAP:
        raise AssertionError(f"expected one bucket of capacity "
                             f"{BUCKET_CAP}: {plan}")
    # the setup's transforms, per instance as solve_many builds it (the
    # power iteration's norm is memoized per stamp shape since phase 4;
    # each instance calibrates its noise and takes its first Phi)
    problem.init_bundle(insts[0], torch.device("cuda"))    # warm caches
    reset_launches()
    for inst in insts:
        problem.init_bundle(inst, torch.device("cuda"))
    setup = read_launches()
    sparse, sols, singles = run_bucket(
        torch, "bucket of eight, sparse", "deconvolve", insts, cfg,
        MAIN_CHUNK, max_iter=MAIN_ITERS, cost_every="chunk", tol=1e-5)
    # phase 20 serves these eight catalogues and holds them to these runs
    PHASE17.update(bucket=sols, singles=singles)
    it, lc = sparse["iters"], sparse["launches"]
    want = {"condat_elwise.primal": it, "condat_elwise.dual": it,
            "condat_elwise.primal_batched": it,
            "condat_elwise.dual_batched": it,
            "starlet2d.forward": it + setup["starlet2d.forward"],
            "starlet2d.adjoint": it + setup["starlet2d.adjoint"],
            "starlet2d.smooth": 0}
    if any(lc[k] != v for k, v in want.items()):
        raise AssertionError(f"bucket launches {lc}, expected {want}: one "
                             f"Phi, Phi^T, primal and dual a bucket "
                             f"iteration")
    for sol, (Y, _) in zip(sols, insts):
        if sol.x.shape != tuple(Y.shape) or not np.isfinite(sol.x).all():
            raise AssertionError("a bucket's iterate is not finite or "
                                 "not unpadded")
    sparse["plan"] = {"capacity": plan[0].capacity,
                      "waste": plan[0].waste}
    sparse["setup_launches"] = {k: v for k, v in setup.items() if v}
    sparse["main_path_ms_per_iter"] = main_ms
    sparse["profile"] = profile_bucket(torch, problem, insts, MAIN_CHUNK,
                                       PARTS)
    log(f"bucket of eight: {sparse['ms_per_iter']} ms/iteration against "
        f"phase 4's {main_ms} (the same stamps as one instance) and "
        f"{sparse['singles_ms_per_iter_sum']:.4f} over the eight single "
        f"solves; profile {json.dumps(sparse['profile'])}")

    rng = np.random.default_rng(64)
    sizes = rng.integers(*SMALL_RANGE, size=SMALL_COUNT)
    edges = np.cumsum(np.concatenate([[0], sizes]))
    if edges[-1] > MAIN_N:
        raise AssertionError(f"{edges[-1]} stamps for the small instances")
    small = [(data.Y[a:b], data.psfs[a:b])
             for a, b in zip(edges[:-1], edges[1:])]
    splan = batching.plan_buckets(small, problem.batch_axes())
    if len(splan) != 1:
        raise AssertionError(f"64 small instances in {len(splan)} buckets")
    many, _, _ = run_bucket(
        torch, f"bucket of {SMALL_COUNT} small instances", "deconvolve",
        small, cfg, MAIN_CHUNK, max_iter=MAIN_ITERS, cost_every="chunk",
        tol=0.0)
    many["plan"] = {"capacity": splan[0].capacity, "waste": splan[0].waste,
                    "stamps": int(edges[-1])}
    many["profile"] = profile_bucket(torch, problem, small, MAIN_CHUNK,
                                     PARTS)
    many["single_profile"] = profile_bucket(torch, problem, small[:1],
                                            MAIN_CHUNK, PARTS)
    log(f"{SMALL_COUNT} small instances ({int(edges[-1])} stamps, "
        f"capacity {splan[0].capacity}): bucket idle "
        f"{many['profile']['idle_share']:.3f}, one instance alone idle "
        f"{many['single_profile']['idle_share']:.3f}")

    lr_cfg = SolverConfig(mode="lowrank", n_scales=SCALES, lam=LR_LAM,
                          rank=LR_RANK)
    lowrank, _, _ = run_bucket(
        torch, "bucket of eight, low rank", "deconvolve", insts, lr_cfg,
        LR_CHUNK, max_iter=LR_ITERS, cost_every="chunk", tol=0.0)
    it, lc = lowrank["iters"], lowrank["launches"]
    want = {"jacobi.svd": it, "jacobi.eigh": it + -(-it // LR_CHUNK),
            "condat_elwise.primal_xbar": it,
            "condat_elwise.primal_batched": it, "condat_elwise.dual": 0,
            "starlet2d.forward": 0, "starlet2d.adjoint": 0}
    if any(lc[k] != v for k, v in want.items()):
        raise AssertionError(f"low-rank bucket launches {lc}, expected "
                             f"{want}")
    lowrank["profile"] = profile_bucket(
        torch, DeconvolutionProblem(lr_cfg), insts, LR_CHUNK, LR_PARTS)
    log(f"bucket of eight, low rank: profile "
        f"{json.dumps(lowrank['profile'])}")
    return {"sparse": sparse, "small": many, "lowrank": lowrank}


# ---------------------------------------------------------------- 18
def bucket_completion_scdl_phase(torch):
    """Four completions at r = 64 sharing Omega, and four SCDL instances
    at K = 10 000, each as one bucket against its single solves."""
    from repro_torch.data.synthetic import coupled_patches
    from repro_torch.imaging.lowrank import CompletionConfig
    from repro_torch.imaging.scdl import SCDLConfig
    wide = CompletionConfig(rank=12, oversample=52, lam=0.2, step=0.9)
    insts = [completion_data(torch, n, COMP_P, 51 + j, "cuda")
             for j, n in enumerate(COMP_BUCKET_ROWS)]
    comp, sols, singles = run_bucket(
        torch, "completion bucket r=64", "lowrank", insts, wide, LR_CHUNK,
        rtol=None, max_iter=LR_ITERS, cost_every="chunk", tol=0.0)
    # the range finder scales each Gram direction by lambda^-1/2, so two
    # fp32 routes through different cuBLAS products part; each route's
    # distance from the fp64 trajectory of the same algebra (phase 14)
    import numpy as np
    dist = []
    for (A, M), sol, ref in zip(insts, sols, singles):
        exact = completion_fp64(torch, wide, A, M, LR_ITERS)
        at = [i for i in range(LR_ITERS) if (i + 1) % LR_CHUNK == 0]
        d = [float(np.max(np.abs(np.asarray(r.log.costs)[at] - exact[at])
                          / np.abs(exact[at]))) for r in (sol, ref)]
        dist.append(d)
    comp["fp64_rel_dist_bucket_single"] = dist
    log(f"completion bucket r=64: relative distance of each instance's "
        f"evaluated costs from the fp64 trajectory, (bucket, single) "
        f"{[[f'{x:.3e}' for x in d] for d in dist]} (bound "
        f"{COMP_FP64_FACTOR} x the single's + {COMP_FP64_FLOOR})")
    # the gate: each instance's bucket route within twice its single
    # route's distance from the exact trajectory (phase 14's rule): two
    # fp32 routes of this algebra lie up to some 4e-3 from it, so they
    # cannot be held to BUCKET_RTOL of each other
    if not all(b <= COMP_FP64_FACTOR * a + COMP_FP64_FLOOR
               for b, a in dist):
        raise AssertionError(f"completion bucket: an instance's bucket "
                             f"route lies farther from fp64 than its "
                             f"single route allows: {dist}")
    it, lc = comp["iters"], comp["launches"]
    want = {"jacobi.svd": it, "jacobi.eigh": it + -(-it // LR_CHUNK)}
    if any(lc[k] != v for k, v in want.items()):
        raise AssertionError(f"completion bucket launches {lc}, expected "
                             f"{want}")
    from repro_torch.imaging.lowrank import LowRankCompletionProblem
    comp["profile"] = profile_bucket(torch, LowRankCompletionProblem(wide),
                                     insts, LR_CHUNK, LR_PARTS)
    log(f"completion bucket r=64: profile {json.dumps(comp['profile'])}")
    del insts
    scdl_insts = [coupled_patches(SCDL_BUCKET_K, SCDL_P, SCDL_M, SCDL_A,
                                  torch.Generator().manual_seed(61 + j))
                  for j in range(SCDL_BUCKET_N)]
    cfg = SCDLConfig(n_atoms=SCDL_A, max_iter=SCDL_ITERS)
    scdl, _, _ = run_bucket(torch, f"SCDL bucket K={SCDL_BUCKET_K}", "scdl",
                         scdl_insts, cfg, SCDL_CHUNK, max_iter=SCDL_ITERS,
                         cost_every="chunk")
    it, lc = scdl["iters"], scdl["launches"]
    want = {"dict_outer_pair": SCDL_BUCKET_N * it, "admm_elwise": it}
    if any(lc[k] != v for k, v in want.items()):
        raise AssertionError(f"SCDL bucket launches {lc}, expected {want} "
                             f"(dict_outer_pair once per instance)")
    from repro_torch.imaging.scdl import SCDLProblem
    scdl["profile"] = profile_bucket(torch, SCDLProblem(cfg), scdl_insts,
                                     SCDL_CHUNK, SCDL_PARTS)
    log(f"SCDL bucket: profile {json.dumps(scdl['profile'])}")
    return {"completion": comp, "scdl": scdl}


# ---------------------------------------------------------------- 19
# the supervised main path: phase 4's solve with a fault at each kind of
# point (a dispatch, a poisoned carry, a kernel wrapper, the newest
# checkpoint torn: a resume reads the newest first, so the fault sits on
# the second of the two checkpoints for the resume to fall back past it)
SUP_SPEC = ("dispatch@1;carry_nan@3;kernel:condat_elwise@2;ckpt_corrupt@1;"
            "seed=11")
SUP_BUCKET_SPEC = "carry_nan@2;seed=7"
SUP_SMALL_N = 256
# leaves of the deconvolution that a step replaces (the others pass
# through unchanged and are shared with the ring's entries)
CARRIED = ("Xp", "HX", "Xd", "CX")


def chunk_ms(sol, chunk=MAIN_CHUNK):
    """Median over chunks after the first of a run's ms per iteration."""
    return statistics.median(t * 1e3 for t in sol.log.times[chunk::chunk])


def same_run(a, b):
    """Costs and iterate equal bit for bit."""
    import numpy as np
    return a.log.costs == b.log.costs and np.array_equal(a.x, b.x)


def supervision_phase(torch, main_ms):
    """Phase 4's solve under ``resilience=``: (a) fault-free, against the
    unsupervised run; (b) with faults, checkpoints and a resume past the
    torn one; (c) phase 17's bucket with a poisoned carry; (d) a run
    that diverges every chunk exhausts its rollbacks."""
    import shutil

    import numpy as np

    from repro_torch.checkpoint import latest_valid_step
    from repro_torch.core.problem import solve, solve_many
    from repro_torch.imaging.condat import SolverConfig
    from repro_torch.imaging.psf import simulate
    from repro_torch.resilience import chaos
    from repro_torch.resilience.errors import ResilienceExhausted
    from repro_torch.resilience.recovery import ResilienceConfig
    data = simulate(MAIN_N, torch.Generator().manual_seed(42), stamp=STAMP)
    kw = dict(cfg=SolverConfig(mode="sparse", n_scales=SCALES),
              max_iter=MAIN_ITERS, chunk=MAIN_CHUNK, cost_every="chunk",
              tol=0.0)
    def peak_over_start(run):
        """``run()`` and its peak device memory above what was allocated
        when it started; the result keeps no tensor on the card."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        sol = run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - start
        carry = sum(sol.bundle.data[k].numel()
                    * sol.bundle.data[k].element_size() for k in CARRIED)
        sol.bundle = None
        return sol, peak, carry

    plain, plain_peak, carry = peak_over_start(
        lambda: solve("deconvolve", data.Y, data.psfs, **kw))

    # (a) no fault
    reset_launches()
    (sup, sup_peak, _), wall, syncs = run_counting_syncs(
        torch, lambda progress: peak_over_start(lambda: solve(
            "deconvolve", data.Y, data.psfs, progress_fn=progress,
            resilience=ResilienceConfig(), **kw)))
    launches = read_launches()
    rec = sup.recovery
    if syncs != 1:
        raise AssertionError(f"supervised: {syncs} host syncs per chunk, "
                             f"expected 1")
    if not same_run(sup, plain):
        raise AssertionError("supervision changed the trajectory")
    if rec is None or rec.faults or rec.retries or rec.rollbacks:
        raise AssertionError(f"fault-free supervised run reports {rec}")
    if launches["condat_elwise.primal"] != MAIN_ITERS or \
            launches["condat_elwise.dual"] != MAIN_ITERS:
        raise AssertionError(f"supervised launches {launches}")
    out = {"syncs_per_chunk": syncs, "ms_per_iter": chunk_ms(sup),
           "plain_ms_per_iter": chunk_ms(plain),
           "main_path_ms_per_iter": main_ms, "wall_s": wall,
           "peak_bytes": sup_peak, "plain_peak_bytes": plain_peak,
           "ring_bytes_measured": sup_peak - plain_peak,
           "ring_bytes_expected": (ResilienceConfig().ring - 1) * carry,
           "launches": {k: v for k, v in launches.items() if v}}
    log(f"supervised main path: {out['ms_per_iter']} ms/iteration "
        f"(unsupervised {out['plain_ms_per_iter']}, phase 4 {main_ms}); "
        f"host syncs per chunk {syncs}; costs and iterate bit-identical "
        f"to the unsupervised run; ring on the card: peak over the run's "
        f"start {sup_peak / 1e9:.3f} GB against {plain_peak / 1e9:.3f} GB "
        f"unsupervised ({(sup_peak - plain_peak) / 1e9:.3f} GB; the "
        f"ring's older entry, the leaves a chunk replaces, "
        f"{out['ring_bytes_expected'] / 1e9:.3f} GB: its newest is the "
        f"chunk's input, which an unsupervised run holds too)")

    # (b) faults, checkpoints, a resume past the torn one
    ckdir = ROOT / "build" / "chip_smoke_supervised"
    shutil.rmtree(ckdir, ignore_errors=True)
    try:
        with chaos.active_chaos(chaos.ChaosConfig.parse(SUP_SPEC)) as st:
            t0 = time.perf_counter()
            faulted = solve("deconvolve", data.Y, data.psfs,
                            checkpoint_dir=ckdir,
                            checkpoint_every=CKPT_EVERY,
                            resilience=ResilienceConfig(), **kw)
            faulted_wall = time.perf_counter() - t0
            fired = list(st.fired)
        valid = latest_valid_step(ckdir)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            rest = solve("deconvolve", data.Y, data.psfs,
                         checkpoint_dir=ckdir, resume=True, **kw)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    frec = faulted.recovery
    want_fired = {"dispatch", "carry_nan", "kernel:condat_elwise",
                  "ckpt_corrupt"}
    if {k for k, _ in fired} != want_fired:
        raise AssertionError(f"faults fired {fired}, expected {want_fired}")
    if frec.kernel_fallbacks != []:
        raise AssertionError(f"kernel_fallbacks {frec.kernel_fallbacks}")
    if frec.rollbacks != 1 or frec.retries != 2:
        raise AssertionError(f"faulted run: {frec}")
    if not same_run(faulted, sup):
        raise AssertionError("the faulted run is not bit-identical to the "
                             "fault-free one")
    back = CKPT_EVERY
    if valid != (back, [2 * CKPT_EVERY]):
        raise AssertionError(f"latest valid checkpoint {valid}")
    tail = plain.log.costs[back:]
    want = [float("inf")] * (MAIN_CHUNK - 1) + tail[MAIN_CHUNK - 1:]
    if rest.log.costs != want or not np.array_equal(rest.x, plain.x) or \
            not any("integrity" in str(w.message) for w in caught):
        raise AssertionError(f"resume past the torn checkpoint: costs "
                             f"{rest.log.costs[-1]!r} against {tail[-1]!r}")
    out["faulted"] = {"report": frec.to_json(), "fired": fired,
                      "wall_s": faulted_wall,
                      "lost_s_per_fault": frec.wall_time_lost_s
                      / max(len(frec.faults), 1),
                      "resumed_from": back}
    log(f"supervised faults {SUP_SPEC}: retries {frec.retries}, rollbacks "
        f"{frec.rollbacks}, checkpoint restores "
        f"{frec.checkpoint_restores}, kernel_fallbacks "
        f"{frec.kernel_fallbacks}, wall_time_lost_s "
        f"{frec.wall_time_lost_s:.4f} ({len(frec.faults)} faults: "
        f"{[(f['point'], f['step']) for f in frec.faults]}), wall "
        f"{faulted_wall:.2f} s against {wall:.2f} s; costs and iterate "
        f"bit-identical to the fault-free run; resume=True fell back past "
        f"the torn step {2 * CKPT_EVERY} to {back}: bit-identical tail")

    # (c) phase 17's bucket, a poisoned carry
    edges = np.cumsum((0,) + BUCKET_SIZES)
    insts = [(data.Y[a:b], data.psfs[a:b])
             for a, b in zip(edges[:-1], edges[1:])]
    bkw = dict(kw, tol=1e-5)
    clean, _, csyncs = run_counting_syncs(
        torch, lambda progress: solve_many(
            "deconvolve", insts, progress_fn=progress,
            resilience=ResilienceConfig(), **bkw))
    with chaos.active_chaos(chaos.ChaosConfig.parse(SUP_BUCKET_SPEC)):
        hit, _, hsyncs = run_counting_syncs(
            torch, lambda progress: solve_many(
                "deconvolve", insts, progress_fn=progress,
                resilience=ResilienceConfig(), **bkw))
    brec = hit[0].recovery
    if csyncs != 1 or hsyncs != 1:
        raise AssertionError(f"supervised bucket: host syncs per chunk "
                             f"{csyncs} and {hsyncs}, expected 1")
    if brec.rollbacks != 1 or brec.retries:
        raise AssertionError(f"bucket under {SUP_BUCKET_SPEC}: {brec}")
    if not all(same_run(h, c) for h, c in zip(hit, clean)):
        raise AssertionError("an instance of the rolled-back bucket is not "
                             "bit-identical to the fault-free bucket")
    out["bucket"] = {"report": brec.to_json(), "syncs_per_chunk": hsyncs,
                     "ms_per_iter": bucket_ms(clean, MAIN_CHUNK)}
    log(f"supervised bucket of eight under {SUP_BUCKET_SPEC}: rollbacks "
        f"{brec.rollbacks}, wall_time_lost_s {brec.wall_time_lost_s:.4f}; "
        f"host syncs per chunk {hsyncs}; every instance bit-identical to "
        f"the fault-free bucket ({out['bucket']['ms_per_iter']} "
        f"ms/iteration supervised)")

    # (d) a run that diverges every chunk
    small = simulate(SUP_SMALL_N, torch.Generator().manual_seed(7),
                     stamp=STAMP)
    spec = "carry_nan@" + ",".join(str(i) for i in range(16))
    try:
        with chaos.active_chaos(chaos.ChaosConfig.parse(spec)):
            solve("deconvolve", small.Y, small.psfs,
                  resilience=ResilienceConfig(max_rollbacks=1), **kw)
    except ResilienceExhausted as e:
        out["exhausted"] = str(e)[:120]
        log(f"diverging every chunk at n={SUP_SMALL_N}, max_rollbacks=1: "
            f"ResilienceExhausted ({out['exhausted']}...)")
    else:
        raise AssertionError("a run diverging every chunk did not exhaust "
                             "its rollbacks")
    return out


# ---------------------------------------------------------------- 20
SERVE_WINDOW_S = 30.0      # the bucket dispatches at its eighth member


def serving_phase(torch, phase17):
    """Phase 17's eight catalogues as eight concurrent HTTP requests: one
    bucket, one ``solve_many`` dispatch; each result against its single
    solve; the codec's seconds; then the three drills on the card."""
    import shutil
    import threading
    from types import SimpleNamespace

    import numpy as np

    from repro_torch.core.problem import solve_many
    from repro_torch.imaging.condat import SolverConfig
    from repro_torch.imaging.psf import simulate
    from repro_torch.serve import codec, drill
    from repro_torch.serve.client import ServeClient
    from repro_torch.serve.server import ServeConfig, serve_http
    data = simulate(MAIN_N, torch.Generator().manual_seed(42), stamp=STAMP)
    edges = np.cumsum((0,) + BUCKET_SIZES)
    insts = [(data.Y[a:b], data.psfs[a:b])
             for a, b in zip(edges[:-1], edges[1:])]
    cfg = dict(mode="sparse", n_scales=SCALES)
    options = dict(max_iter=MAIN_ITERS, chunk=MAIN_CHUNK,
                   cost_every="chunk", tol=1e-5)

    # the codec on the largest request: its client encode and server decode
    big = max(insts, key=lambda inst: inst[0].shape[0])
    t0 = time.perf_counter()
    body = json.dumps({"problem": "deconvolve",
                       "inputs": [codec.encode_input(x) for x in big]})
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = codec.decode_inputs(json.loads(body)["inputs"])
    dec_s = time.perf_counter() - t0
    if not all(np.array_equal(b, x.cpu().numpy()) for b, x in zip(back, big)):
        raise AssertionError("codec round trip is not exact")
    nbytes = sum(x.numel() * x.element_size() for x in big)
    log(f"codec: a request of {big[0].shape[0]} stamps ({nbytes / 1e6:.2f} "
        f"MB of arrays, {len(body) / 1e6:.2f} MB of JSON): encode "
        f"{enc_s:.4f} s, decode {dec_s:.4f} s")

    handle = serve_http(ServeConfig(max_batch=len(insts),
                                    batch_window_s=SERVE_WINDOW_S),
                        host="127.0.0.1", port=0)
    try:
        client = ServeClient(handle.url, timeout=300)
        ids = [None] * len(insts)

        def send(j):
            ids[j] = client.submit("deconvolve", insts[j], cfg=cfg,
                                   options=options)

        torch.cuda.synchronize()
        reset_launches()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                threads = [threading.Thread(target=send, args=(j,))
                           for j in range(len(insts))]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(300)
                results = [client.result(rid, include_x=True, timeout=300)
                           for rid in ids]
                wall = time.perf_counter() - t0
            finally:
                torch.cuda.set_sync_debug_mode(0)
            syncs = sum("synchroniz" in str(w.message) for w in caught)
        launches = read_launches()
        metrics = client.metrics()
    finally:
        handle.close()
    if metrics["batch_occupancy"]["batches"] != 1 or \
            {r["batch_size"] for r in results} != {len(insts)} or \
            len({r["bucket_key"] for r in results}) != 1:
        raise AssertionError(f"the eight requests did not coalesce into one "
                             f"bucket: {metrics['batch_occupancy']}")
    it = max(r["iters_run"] for r in results)
    setup = phase17["setup_launches"]
    want = {"condat_elwise.primal": it, "condat_elwise.dual": it,
            "condat_elwise.primal_batched": it,
            "condat_elwise.dual_batched": it,
            "starlet2d.forward": it + setup.get("starlet2d.forward", 0),
            "starlet2d.adjoint": it + setup.get("starlet2d.adjoint", 0),
            "starlet2d.smooth": 0}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"served bucket launches {launches}, expected "
                             f"{want}: one Phi, Phi^T, primal and dual a "
                             f"bucket iteration")
    served = [SimpleNamespace(log=SimpleNamespace(
        costs=r["costs"], iters_run=r["iters_run"]), x=r["x"])
        for r in results]
    gap = hold_instances("served bucket", served, phase17["singles"])
    identical = all(same_run(s, b)
                    for s, b in zip(served, phase17["bucket"]))
    # the same bucket in this process, on host copies of the inputs in
    # the order the service stacked them (admission order: its tokens)
    order = sorted(range(len(ids)),
                   key=lambda j: handle.runner.service.records[ids[j]]._token)
    host = [tuple(x.cpu().numpy() for x in insts[j]) for j in order]
    direct = solve_many("deconvolve", host, cfg=SolverConfig(**cfg),
                        **options)
    in_process = all(same_run(served[j], d) for j, d in zip(order, direct))
    if not in_process:
        raise AssertionError(f"the served results differ from solve_many "
                             f"in process on the same arrays in the served "
                             f"lane order {order}")
    ms = statistics.median(r["time_percentiles_s"]["p50"] * 1e3
                           for r in results)
    lat = metrics["latency_s"]
    out = {"requests": len(insts), "iters": it, "launches": {
        k: v for k, v in launches.items() if v}, "wall_s": wall,
        "syncs_in_requests": syncs, "latency_s": lat,
        "ms_per_iter": ms, "phase17_ms_per_iter": phase17["ms_per_iter"],
        "max_rel_cost_gap_to_single": gap,
        "bit_identical_to_phase17": identical,
        "bit_identical_in_process": in_process, "lane_order": order,
        "codec": {"array_bytes": nbytes, "json_bytes": len(body),
                  "encode_s": enc_s, "decode_s": dec_s}}
    log(f"served bucket: {len(insts)} HTTP requests in one bucket, "
        f"iters {it}, launches {out['launches']}; latency p50 "
        f"{lat.get('p50')} s, p99 {lat.get('p99')} s; {ms} ms/iteration "
        f"(median of the requests' p50) against phase 17's "
        f"{phase17['ms_per_iter']}; largest relative cost gap to the single "
        f"solves {gap:.3e}; bit-identical to solve_many in process on the "
        f"same host arrays in the served lane order {order}; "
        f"to phase 17's bucket: {identical}; host syncs over the whole "
        f"exchange "
        f"{syncs} (torch sync debug mode, every thread: the client's "
        f"copies off the card, the setup, the chunks, the results)")

    drills = {}
    workdir = ROOT / "build" / "chip_smoke_drill"
    for name, run in drill.SCENARIOS.items():
        kwargs = {"workdir": str(workdir)} \
            if name == "kill-and-restart" else {}
        shutil.rmtree(workdir, ignore_errors=True)
        t0 = time.perf_counter()
        try:
            detail = run(device="cuda", **kwargs)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        drills[name] = {"seconds": time.perf_counter() - t0,
                        "counters": detail["counters"]}
        log(f"drill {name}: ok in {drills[name]['seconds']:.2f} s "
            f"({ {k: v for k, v in detail['counters'].items() if v} })")
    out["drills"] = drills
    return out


# ----------------------------------------------------------------- 21
# multi-device: (a) NCCL at world size 1 in this process, (b) four gloo
# ranks sharing the card (subprocesses of this script, --mesh-rank)
MESH_DIR = ROOT / "build" / "phase21"
MESH_RANKS = 4
MESH_TIMEOUT_S = 600
MESH_PATHS = ("sparse", "lowrank", "scdl", "completion")
MESH_CHUNK = {"sparse": MAIN_CHUNK, "lowrank": LR_CHUNK,
              "scdl": SCDL_CHUNK, "completion": LR_CHUNK}
# phase 21(b) against the single-process solve on the card: the
# reference's own bounds (tests/test_solve_many.py for the
# deconvolution, tests/test_distributed.py:85 for SCDL's costs)
MESH_DECONV_TOL = dict(rtol=1e-4, atol=1e-6)
MESH_SCDL_RTOL = 5e-3
NCCL_PARTS = (("nccl", ("nccl", "Nccl")),)


def mesh_inputs(torch, name):
    """The inputs of the path ``name`` (phase 4, 12, 8 and 14's)."""
    if name in ("sparse", "lowrank"):
        from repro_torch.imaging.psf import simulate
        data = simulate(MAIN_N, torch.Generator().manual_seed(42),
                        stamp=STAMP)
        return data.Y, data.psfs
    if name == "scdl":
        from repro_torch.data.synthetic import coupled_patches
        return coupled_patches(SCDL_K, SCDL_P, SCDL_M, SCDL_A,
                               torch.Generator().manual_seed(12))
    return completion_data(torch, COMP_N, COMP_P, 31, "cuda")


def mesh_solve(name, inputs, mesh, progress=None, **extra):
    """The path ``name`` as its phase runs it, under ``mesh`` (or
    none); ``extra`` adds run options (``resilience=``)."""
    from repro_torch.core.problem import solve
    from repro_torch.imaging.condat import SolverConfig
    from repro_torch.imaging.lowrank import CompletionConfig
    from repro_torch.imaging.scdl import SCDLConfig
    kw = dict(mesh=mesh, progress_fn=progress, cost_every="chunk",
              chunk=MESH_CHUNK[name], **extra)
    if name == "sparse":
        return solve("deconvolve", *inputs, cfg=SolverConfig(
            mode="sparse", n_scales=SCALES), max_iter=MAIN_ITERS, tol=1e-5,
            **kw)
    if name == "lowrank":
        return solve("deconvolve", *inputs, cfg=SolverConfig(
            mode="lowrank", n_scales=SCALES, lam=LR_LAM, rank=LR_RANK),
            max_iter=LR_ITERS, tol=0.0, **kw)
    if name == "scdl":
        return solve("scdl", *inputs, cfg=SCDLConfig(
            n_atoms=SCDL_A, max_iter=SCDL_ITERS), max_iter=SCDL_ITERS, **kw)
    return solve("lowrank", *inputs, cfg=CompletionConfig(
        rank=12, oversample=52, lam=0.2, step=0.9), max_iter=LR_ITERS,
        tol=0.0, **kw)


def mesh_ms(sol, name):
    """Median ms per iteration over the chunks after the first."""
    k = MESH_CHUNK[name]
    return statistics.median(t * 1e3 for t in sol.log.times[k::k])


def _xs(sol):
    return sol.x if isinstance(sol.x, tuple) else (sol.x,)


def _digests(sol):
    """sha256 of each of a solve's results (its bits)."""
    import hashlib
    return [hashlib.sha256(a.tobytes()).hexdigest() for a in _xs(sol)]


def mesh_nccl_profile(torch, sol, name):
    """One more chunk of the mesh path under torch.profiler: the device
    time of the collectives (NCCL kernels) in it."""
    from repro_torch.core.engine import make_chunk_cost_step
    problem, b = sol.problem, sol.bundle
    k = MESH_CHUNK[name]
    step = make_chunk_cost_step(
        problem.light_step, problem.cost, chunk=k,
        update_replicated=problem._declared("refresh_replicated"),
        axes=b.axes)
    state = {"d": b.data, "r": b.replicated}

    def body():
        state["d"], state["r"], _, _ = step(state["d"], state["r"], 0, None)

    return profile_window(torch, body, k, NCCL_PARTS)


def mesh_plain_entry(sol, name, inputs):
    """What the multi-rank runs are held against: a single-process
    solve's costs, iterate, time and (host) inputs."""
    import numpy as np
    return {"costs": sol.log.costs, "iters": sol.log.iters_run,
            "x": tuple(np.array(a) for a in _xs(sol)),
            "ms_per_iter": mesh_ms(sol, name),
            "inputs": tuple(t.cpu().numpy() for t in inputs)}


def mesh_plain(torch, names):
    """The single-process solves of ``names`` on this card."""
    out = {}
    for name in names:
        inputs = mesh_inputs(torch, name)
        out[name] = mesh_plain_entry(mesh_solve(name, inputs, None), name,
                                     inputs)
        log(f"single process {name}: {out[name]['ms_per_iter']} "
            f"ms/iteration, iters {out[name]['iters']}")
    return out


def mesh_nccl_phase(torch):
    """21(a): NCCL at world size 1 in this process, at full width: each
    path with ``mesh=`` against the same call without, bit for bit, one
    host sync per chunk, the same kernel launches."""
    import shutil
    from datetime import timedelta
    import inspect

    import numpy as np
    import torch.distributed as dist

    from repro_torch.core.compat import COLLECTIVES
    from repro_torch.launch.mesh import make_mesh
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    MESH_DIR.mkdir(parents=True)
    init = dict(rank=0, world_size=1, timeout=timedelta(seconds=300),
                store=dist.FileStore(str(MESH_DIR / "store_nccl"), 1))
    if "device_id" in inspect.signature(dist.init_process_group).parameters:
        init["device_id"] = torch.device("cuda", 0)
    dist.init_process_group("nccl", **init)
    out, plain = {}, {}
    try:
        mesh = make_mesh((1,), ("data",))
        log(f"mesh: {mesh}, backend {dist.get_backend()}")
        for name in MESH_PATHS:
            inputs = mesh_inputs(torch, name)
            torch.cuda.synchronize()
            # launches at each chunk's end: those of the iterations after
            # the first chunk, apart from the setup's (whose starlet norm
            # is cached after a first solve)
            marks = {"ref": [], "mesh": []}

            def mark(key, progress=None):
                def event(e):
                    marks[key].append(read_launches())
                    if progress is not None:
                        progress(e)
                return event

            reset_launches()
            ref = mesh_solve(name, inputs, None, mark("ref"))
            reset_launches()
            c0 = COLLECTIVES["launches"]
            sol, wall, syncs = run_counting_syncs(
                torch, lambda progress: mesh_solve(name, inputs, mesh,
                                                   mark("mesh", progress)))
            launches, ref_launches = (
                {k: m[-1][k] - m[0][k] for k in m[0]}
                for m in (marks["mesh"], marks["ref"]))
            it = sol.log.iters_run
            nccl = (COLLECTIVES["launches"] - c0) / it
            same = (sol.log.costs == ref.log.costs and all(
                np.array_equal(a, b) for a, b in zip(_xs(sol), _xs(ref))))
            prof = mesh_nccl_profile(torch, sol, name)
            k = MESH_CHUNK[name]
            nccl_ms = prof["device_ms_per_iter_by_part"]["nccl"] * k
            row = {"iters_run": it, "bit_identical": same,
                   "syncs_per_chunk": syncs,
                   "launches_after_chunk1": launches,
                   "launches_after_chunk1_meshless": ref_launches,
                   "ms_per_iter": mesh_ms(sol, name),
                   "ms_per_iter_meshless": mesh_ms(ref, name),
                   "nccl_launches_per_iter": nccl,
                   "nccl_device_ms_per_chunk": nccl_ms,
                   "profile": prof, "wall_s": wall}
            log(f"mesh (1,) nccl {name}: iters {it}, bit-identical to the "
                f"meshless run {same}; {row['ms_per_iter']} ms/iteration "
                f"(meshless {row['ms_per_iter_meshless']}); host syncs per "
                f"chunk {syncs}; kernel launches after the first chunk "
                f"{ {k: v for k, v in launches.items() if v} } (meshless "
                f"the same); NCCL launches per iteration {nccl:.4g}; "
                f"NCCL device time in one chunk of {k}: {nccl_ms:.6f} ms; "
                f"profile {json.dumps(prof)}")
            if not same or it != ref.log.iters_run:
                raise AssertionError(f"mesh {name}: not bit-identical to "
                                     f"the meshless run")
            if syncs != 1:
                raise AssertionError(f"mesh {name}: {syncs} host syncs per "
                                     f"chunk, expected 1")
            if launches != ref_launches or not any(launches.values()):
                raise AssertionError(f"mesh {name}: launches after the "
                                     f"first chunk {launches} != meshless "
                                     f"{ref_launches}")
            if name in ("sparse", "scdl"):
                plain[name] = mesh_plain_entry(ref, name, inputs)
            out[name] = row
            del ref, sol, inputs
    finally:
        dist.destroy_process_group()
    return out, plain


def mesh_rank_main(rank: int, size: int, out: Path,
                   backend: str = "gloo") -> None:
    """One rank of a multi-rank world under a (size,) mesh, on every path
    whose inputs lie in ``out``: with gloo over the card's tensors, every
    rank on the one card (21(b)); with NCCL, rank r on card r
    (``tools/mesh_phase.py --cards``)."""
    import hashlib
    import pickle
    from datetime import timedelta

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the host's cores shared by the ranks
    torch.set_num_threads(2)
    init = {}
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        init["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(
        backend, rank=rank, world_size=size, timeout=timedelta(seconds=300),
        store=dist.FileStore(str(out / f"store_{backend}"), size), **init)
    try:
        mesh = make_mesh((size,), ("data",), device="cuda")
        res = {}
        for name in (n for n in MESH_PATHS
                     if (out / f"{n}_0.npy").exists()):
            inputs = tuple(np.load(out / f"{name}_{i}.npy") for i in (0, 1))
            sol, wall, syncs = run_counting_syncs(
                torch, lambda progress: mesh_solve(name, inputs, mesh,
                                                   progress))

            rep = {}
            for k, v in sol.bundle.replicated.items():
                for kk, t in (v.items() if isinstance(v, dict)
                              else [("", v)]):
                    rep[f"{k}.{kk}" if kk else k] = hashlib.sha256(
                        t.detach().cpu().numpy().tobytes()).hexdigest()
            res[name] = {
                "costs": sol.log.costs, "iters": sol.log.iters_run,
                "ms_per_iter": mesh_ms(sol, name), "syncs_per_chunk": syncs,
                "wall_s": wall, "records": sol.bundle.record_range,
                "x": _xs(sol) if rank == 0 else None,
                "x_digest": _digests(sol), "replicated_digest": rep}
        (out / f"rank_{rank}.pkl").write_bytes(pickle.dumps(res))
    finally:
        dist.destroy_process_group()


def mesh_gloo_phase(torch, plain):
    """21(b): four gloo ranks time-sharing the card, each a subprocess on
    cuda:0 with the same full inputs: the sparse deconvolution (2 500
    stamps a rank) and SCDL (10 000 samples a rank) against the
    single-process solve on the card, the replicated state across ranks
    bit for bit."""
    return mesh_world_phase(torch, plain, "gloo", MESH_RANKS)


def mesh_world_phase(torch, plain, backend, size):
    """``size`` ranks (subprocesses of this script, a timeout on every
    one) on the paths of ``plain``, each against its single-process
    solve: the sparse deconvolution's costs and iterate at rtol 1e-4 with
    equal ``iters_run``, the low-rank deconvolution's costs at rtol 1e-4,
    SCDL's costs at rtol 5e-3, the completion's gaps reported; the
    replicated state, costs and results bit for bit across ranks."""
    import pickle
    import shutil

    import numpy as np
    where = (f"{size} processes time-sharing one card" if backend == "gloo"
             else f"{size} ranks on {size} cards")
    if backend != "gloo":
        shutil.rmtree(MESH_DIR, ignore_errors=True)
        MESH_DIR.mkdir(parents=True)
    for name, p in plain.items():
        for i, a in enumerate(p["inputs"]):
            np.save(MESH_DIR / f"{name}_{i}.npy", a)
    logs = [open(MESH_DIR / f"rank_{r}.log", "w") for r in range(size)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--mesh-rank",
         str(r), str(size), str(MESH_DIR), backend], stdout=logs[r],
        stderr=subprocess.STDOUT, cwd=str(ROOT)) for r in range(size)]
    try:
        for p in procs:
            p.wait(timeout=max(1.0, MESH_TIMEOUT_S
                               - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"mesh ranks: no end within "
                             f"{MESH_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    world_s = time.perf_counter() - t0
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        tails = {r: (MESH_DIR / f"rank_{r}.log").read_text()[-2000:]
                 for r in bad}
        raise AssertionError(f"mesh ranks {bad} failed: {tails}")
    ranks = [pickle.loads((MESH_DIR / f"rank_{r}.pkl").read_bytes())
             for r in range(size)]
    out = {"world_s": world_s}
    for name, p in plain.items():
        got = ranks[0][name]
        want_c = np.asarray(p["costs"])
        got_c = np.asarray(got["costs"])
        if got["iters"] != p["iters"] or got_c.shape != want_c.shape:
            raise AssertionError(f"mesh ranks {name}: iters_run "
                                 f"{got['iters']} != {p['iters']}")
        fin = np.isfinite(want_c)
        gap = float(np.max(np.abs(got_c[fin] - want_c[fin])
                           / np.abs(want_c[fin])))
        x_gap = max(float(np.max(np.abs(a - b)))
                    for a, b in zip(got["x"], p["x"]))
        bits = got_c.tolist() == want_c.tolist() and all(
            np.array_equal(a, b) for a, b in zip(got["x"], p["x"]))
        same_ranks = all(
            r[name]["costs"] == got["costs"]
            and r[name]["x_digest"] == got["x_digest"]
            and r[name]["replicated_digest"] == got["replicated_digest"]
            for r in ranks)
        row = {"iters_run": got["iters"], "max_rel_cost_gap": gap,
               "max_abs_iterate_gap": x_gap, "bit_identical": bits,
               "ranks_bit_identical": same_ranks,
               "records": [r[name]["records"] for r in ranks],
               "syncs_per_chunk": [r[name]["syncs_per_chunk"]
                                   for r in ranks],
               "ms_per_iter": [r[name]["ms_per_iter"] for r in ranks],
               "ms_per_iter_single_process": p["ms_per_iter"]}
        log(f"mesh ({size},) {backend} {name}, {where}: "
            f"iters {got['iters']}; largest relative cost gap {gap:.3g}, "
            f"largest iterate gap {x_gap:.3g} against the single-process "
            f"solve; bit-identical to it {bits}; replicated state, costs "
            f"and results bit-identical across ranks {same_ranks}; records "
            f"{row['records']}; host syncs per chunk "
            f"{row['syncs_per_chunk']} (reported, not gated); "
            f"ms/iteration "
            f"{row['ms_per_iter']} (single process "
            f"{row['ms_per_iter_single_process']})")
        if name == "scdl":
            # how far the dictionaries move anyway: the single process
            # again with S_h one ulp up
            S_h, S_l = p["inputs"]
            nudged = mesh_solve(name, (np.nextafter(S_h, np.float32(np.inf)),
                                       S_l), None)
            row["nudge_dict_gap"] = max(
                float(np.max(np.abs(np.asarray(a) - b)))
                for a, b in zip(_xs(nudged), p["x"]))
            log(f"mesh ({size},) {backend} scdl: S_h one ulp up moves the "
                f"single-process dictionaries by {row['nudge_dict_gap']:.3g}"
                f" (the four ranks' gap {x_gap:.3g})")
            del nudged
        if not same_ranks:
            raise AssertionError(f"mesh ranks {name}: ranks disagree")
        if name == "sparse":
            np.testing.assert_allclose(got_c[fin], want_c[fin],
                                       **MESH_DECONV_TOL)
            np.testing.assert_allclose(got["x"][0], p["x"][0],
                                       **MESH_DECONV_TOL)
        elif name == "lowrank":
            np.testing.assert_allclose(got_c[fin], want_c[fin],
                                       rtol=MESH_DECONV_TOL["rtol"])
        elif name == "scdl":
            np.testing.assert_allclose(got_c, want_c, rtol=MESH_SCDL_RTOL)
        out[name] = row
    log(f"mesh ({size},) {backend} world: {world_s:.1f} s, {where}"
        + (" (not a multi-GPU figure)" if backend == "gloo" else ""))
    return out


# ----------------------------------------------------------------- 22
# supervision and serving under a mesh: (a) a one-rank NCCL mesh in this
# process, (b) four gloo ranks sharing the card (subprocesses of this
# script, --sup-rank)
SUP_MESH_DIR = ROOT / "build" / "phase22"
SUP_MESH_SPEC = "dispatch@1;carry_nan@1;seed=7"
SUP_MESH_VOTE_SPEC = "kernel:jacobi@2;seed=7"
SUP_MESH_TIMEOUT_S = 300
# tools/mesh_phase.py --cards: the fault one rank meets alone, in the
# low-rank path's second chunk past its first collective (the setup's
# Jacobi calls, then an eigh and an svd an iteration)
SUP_MESH_LONE_SPEC = "kernel:jacobi@30;seed=7"
SUP_MESH_LONE_RANK = 2


def supervised_nccl_phase(torch, phase19):
    """22(a): phase 19's supervised main path and bucket under a
    one-rank NCCL mesh, against the same calls unsupervised under it."""
    import inspect
    import shutil
    from datetime import timedelta

    import numpy as np
    import torch.distributed as dist

    from repro_torch.core.compat import COLLECTIVES
    from repro_torch.core.problem import solve, solve_many
    from repro_torch.imaging.condat import SolverConfig
    from repro_torch.imaging.psf import simulate
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.resilience import chaos
    from repro_torch.resilience.recovery import ResilienceConfig
    here = SUP_MESH_DIR / "nccl"
    here.mkdir(parents=True)
    init = dict(rank=0, world_size=1, timeout=timedelta(seconds=300),
                store=dist.FileStore(str(here / "store"), 1))
    if "device_id" in inspect.signature(dist.init_process_group).parameters:
        init["device_id"] = torch.device("cuda", 0)
    dist.init_process_group("nccl", **init)
    try:
        mesh = make_mesh((1,), ("data",))
        data = simulate(MAIN_N, torch.Generator().manual_seed(42),
                        stamp=STAMP)
        kw = dict(cfg=SolverConfig(mode="sparse", n_scales=SCALES),
                  max_iter=MAIN_ITERS, chunk=MAIN_CHUNK,
                  cost_every="chunk", tol=0.0, mesh=mesh)
        out = {}

        # the bucket and the faults first, the timed pair last (22(b)'s
        # ranks start up meanwhile)
        edges = np.cumsum((0,) + BUCKET_SIZES)
        insts = [(data.Y[a:b], data.psfs[a:b])
                 for a, b in zip(edges[:-1], edges[1:])]

        def bucket(progress):
            return solve_many("deconvolve", insts, progress_fn=progress,
                              resilience=ResilienceConfig(),
                              **dict(kw, tol=1e-5))

        clean, _, csyncs = run_counting_syncs(torch, bucket)
        with chaos.active_chaos(chaos.ChaosConfig.parse(SUP_BUCKET_SPEC)):
            hit, _, hsyncs = run_counting_syncs(torch, bucket)
        brec = hit[0].recovery
        want_b = phase19["bucket"]["report"]
        out["bucket"] = {"report": brec.to_json(),
                         "syncs_per_chunk": [csyncs, hsyncs],
                         "ms_per_iter": bucket_ms(clean, MAIN_CHUNK),
                         "bit_identical": all(same_run(h, c) for h, c
                                              in zip(hit, clean))}
        del clean, hit
        log(f"supervised bucket of eight under {SUP_BUCKET_SPEC} and the "
            f"mesh: rollbacks {brec.rollbacks} (phase 19: "
            f"{want_b['rollbacks']}), host syncs per chunk {csyncs} and "
            f"{hsyncs}; every instance bit-identical to the fault-free "
            f"bucket: {out['bucket']['bit_identical']} "
            f"({out['bucket']['ms_per_iter']} ms/iteration)")
        if csyncs != 1 or hsyncs != 1:
            raise AssertionError(f"supervised meshed bucket: host syncs "
                                 f"per chunk {csyncs} and {hsyncs}")
        if (brec.retries, brec.rollbacks) != (want_b["retries"],
                                              want_b["rollbacks"]):
            raise AssertionError(f"meshed bucket under "
                                 f"{SUP_BUCKET_SPEC}: {brec}")
        if not out["bucket"]["bit_identical"]:
            raise AssertionError("an instance of the rolled-back meshed "
                                 "bucket is not bit-identical")

        ckdir = here / "ckpt"
        with chaos.active_chaos(chaos.ChaosConfig.parse(SUP_SPEC)) as st:
            t0 = time.perf_counter()
            faulted = solve("deconvolve", data.Y, data.psfs,
                            checkpoint_dir=ckdir,
                            checkpoint_every=CKPT_EVERY,
                            resilience=ResilienceConfig(), **kw)
            faulted_wall = time.perf_counter() - t0
            fired = sorted({k for k, _ in st.fired})
        shutil.rmtree(ckdir, ignore_errors=True)

        def run(progress, **extra):
            return solve("deconvolve", data.Y, data.psfs,
                         progress_fn=progress, **kw, **extra)

        plain, _, psyncs = run_counting_syncs(torch, run)
        c0 = COLLECTIVES["launches"]
        sup, wall, syncs = run_counting_syncs(
            torch, lambda p: run(p, resilience=ResilienceConfig()))
        per_chunk = (COLLECTIVES["launches"] - c0) / (MAIN_ITERS
                                                      // MAIN_CHUNK)
        rec = sup.recovery
        out.update({
            "syncs_per_chunk": syncs, "syncs_per_chunk_plain": psyncs,
            "ms_per_iter": chunk_ms(sup),
            "plain_ms_per_iter": chunk_ms(plain),
            "phase19_ms_per_iter": phase19["ms_per_iter"],
            "phase19_plain_ms_per_iter": phase19["plain_ms_per_iter"],
            "collectives_per_chunk": per_chunk, "wall_s": wall,
            "bit_identical": same_run(sup, plain)})
        log(f"supervised main path under a (1,) NCCL mesh: "
            f"{out['ms_per_iter']} ms/iteration (unsupervised under the "
            f"mesh {out['plain_ms_per_iter']}; phase 19 meshless "
            f"{out['phase19_ms_per_iter']} supervised, "
            f"{out['phase19_plain_ms_per_iter']} not); host syncs per "
            f"chunk {syncs} (unsupervised {psyncs}); collectives per "
            f"chunk {per_chunk:.4g}; costs and iterate bit-identical to "
            f"the unsupervised meshed run: {out['bit_identical']}")
        if syncs != 1:
            raise AssertionError(f"supervised under the mesh: {syncs} host "
                                 f"syncs per chunk, expected 1")
        if not out["bit_identical"]:
            raise AssertionError("supervision under the mesh changed the "
                                 "trajectory")
        if rec is None or rec.faults or rec.retries or rec.rollbacks:
            raise AssertionError(f"fault-free supervised meshed run "
                                 f"reports {rec}")

        frec, want = faulted.recovery, phase19["faulted"]["report"]
        out["faulted"] = {"report": frec.to_json(), "fired": fired,
                          "wall_s": faulted_wall,
                          "bit_identical": same_run(faulted, sup)}
        log(f"supervised faults {SUP_SPEC} under the mesh: retries "
            f"{frec.retries}, rollbacks {frec.rollbacks} (phase 19: "
            f"{want['retries']}, {want['rollbacks']}), fired {fired}, "
            f"wall_time_lost_s {frec.wall_time_lost_s:.4f}; bit-identical "
            f"to the fault-free run: {out['faulted']['bit_identical']}")
        if (frec.retries, frec.rollbacks) != (want["retries"],
                                              want["rollbacks"]):
            raise AssertionError(f"faulted run under the mesh: {frec}")
        if not out["faulted"]["bit_identical"]:
            raise AssertionError("the faulted meshed run is not "
                                 "bit-identical to the fault-free one")
    finally:
        dist.destroy_process_group()
    return out


def sup_rank_main(rank: int, size: int, out: Path,
                  backend: str = "gloo") -> None:
    """One rank of 22(b) (or of ``tools/mesh_phase.py --cards``, with
    NCCL and without the service): phase 4's stamps and the low-rank
    path unsupervised and supervised under faults on every rank; with
    gloo then phase 20's catalogues served by rank 0 (the others
    follow) and the poison-bucket drill."""
    import pickle
    from datetime import timedelta

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.resilience import chaos
    from repro_torch.resilience.recovery import ResilienceConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    init = {}
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        init["device_id"] = torch.device("cuda", torch.cuda.current_device())
    # under NCCL a peer that waits past the lone fault's bound (the vote's
    # 10 s) fails at this timeout rather than the one of phase 22(b)
    dist.init_process_group(
        backend, rank=rank, world_size=size,
        timeout=timedelta(seconds=90 if backend == "nccl" else 300),
        store=dist.FileStore(str(out / f"store_sup_{backend}"), size),
        **init)
    try:
        mesh = make_mesh((size,), ("data",), device="cuda")
        Y, P = (np.load(out / f"stamps_{i}.npy") for i in (0, 1))
        # started before phase 21: begin when the parent says so
        res = {"seconds": {"start": time.perf_counter() - T_START}}
        t0 = time.perf_counter()
        # a process's first bucket takes its cost's structure from the
        # cost run on meta tensors (engine.init_batched_cost_like), whose
        # first use imports torch._dynamo: 7-12 s in a fresh process on
        # the chip machine (its sources compile at import); import it
        # during start-up, as the parent process has by phase 17
        import torch._dynamo  # noqa: F401
        res["seconds"]["dynamo_import"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        while not (out / "go").exists():
            if time.perf_counter() - t0 > SUP_MESH_TIMEOUT_S:
                raise TimeoutError("supervised mesh rank: no go")
            time.sleep(0.02)
        res["seconds"]["waited"] = time.perf_counter() - t0
        # phase 21(b)'s ranks ran the sparse path unsupervised in the same
        # layout (this rank's result is in MESH_DIR): the supervised run is
        # held against that one
        earlier = MESH_DIR / f"rank_{rank}.pkl"
        earlier = (pickle.loads(earlier.read_bytes()).get("sparse")
                   if backend == "gloo" and earlier.exists() else None)
        for name, spec in (("sparse", SUP_MESH_SPEC),
                           ("lowrank", SUP_MESH_VOTE_SPEC)):
            t0 = time.perf_counter()
            if name == "sparse" and earlier is not None:
                plain = {"costs": earlier["costs"],
                         "x_digest": earlier["x_digest"],
                         "ms_per_iter": earlier["ms_per_iter"],
                         "wall_s": earlier["wall_s"]}
            else:
                sol, pwall, _ = run_counting_syncs(
                    torch, lambda progress: mesh_solve(name, (Y, P), mesh,
                                                       progress))
                plain = {"costs": sol.log.costs,
                         "x_digest": _digests(sol),
                         "ms_per_iter": mesh_ms(sol, name),
                         "wall_s": pwall}
                del sol
            with chaos.active_chaos(chaos.ChaosConfig.parse(spec)):
                sup, wall, syncs = run_counting_syncs(
                    torch, lambda progress: mesh_solve(
                        name, (Y, P), mesh, progress,
                        resilience=ResilienceConfig()))
            res[name] = {"bit_identical": (
                             sup.log.costs == plain["costs"]
                             and _digests(sup) == plain["x_digest"]),
                         "plain_from_phase21": name == "sparse"
                         and earlier is not None,
                         "report": sup.recovery.to_json(),
                         "iters": sup.log.iters_run,
                         "ms_per_iter": mesh_ms(sup, name),
                         "plain_ms_per_iter": plain["ms_per_iter"],
                         "syncs_per_chunk": syncs, "wall_s": wall,
                         "plain_wall_s": plain["wall_s"]}
            res["seconds"][name] = time.perf_counter() - t0
            del sup
        if backend == "gloo":
            t0 = time.perf_counter()
            res["serve"] = sup_serve(torch, rank, mesh, Y, P)
            res["seconds"]["serve"] = time.perf_counter() - t0
        else:
            t0 = time.perf_counter()
            res["overhead"] = sup_overhead(torch, (Y, P), mesh)
            res["seconds"]["overhead"] = time.perf_counter() - t0
            (out / f"sup_{rank}.pkl").write_bytes(pickle.dumps(res))
            # last: the process groups end here
            res["lone"] = lone_fault(rank, (Y, P), mesh)
        (out / f"sup_{rank}.pkl").write_bytes(pickle.dumps(res))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def sup_overhead(torch, inputs, mesh):
    """Supervision's cost on NCCL ranks, one a card: the sparse path
    without faults supervised and not, in turns (plain, supervised,
    supervised, plain); then one run of each with each part of a chunk
    timed on the host (the enqueue, the finite flag, its all-reduce, the
    sync, the checks), and one under ``torch.profiler`` from the end of
    its first chunk to its last: device and NCCL time, the device's idle
    share, and the host operations that took most time."""
    import contextlib

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import driver as drv
    from repro_torch.resilience import supervisor as sv
    from repro_torch.resilience.recovery import ResilienceConfig

    def run(sup, progress=None):
        extra = {"resilience": ResilienceConfig()} if sup else {}
        return mesh_solve("sparse", inputs, mesh, progress, **extra)

    out = {"ms_per_iter": {"plain": [], "supervised": []}}
    for sup in (False, True, True, False):
        sol = run(sup)
        out["ms_per_iter"]["supervised" if sup else "plain"].append(
            mesh_ms(sol, "sparse"))
        del sol

    @contextlib.contextmanager
    def timed(owners):
        seconds = {name: 0.0 for _, name in owners}
        saved = [(owner, name, getattr(owner, name)) for owner, name
                 in owners]

        def wrap(fn, name):
            def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    seconds[name] += time.perf_counter() - t0
            return wrapper

        for owner, name, fn in saved:
            setattr(owner, name, wrap(fn, name))
        try:
            yield seconds
        finally:
            for owner, name, fn in saved:
                setattr(owner, name, fn)

    parts = [(drv.IterativeDriver, "_launch_chunk"), (drv, "_host_costs"),
             (drv, "finite_flag"), (drv, "mesh_flag"),
             (drv, "host_costs_and_flag"), (sv.Supervisor, "begin_chunk"),
             (sv.Supervisor, "validate")]
    out["host_ms_per_chunk"] = {}
    for sup in (False, True):
        with timed(parts) as seconds:
            sol = run(sup)
        chunks = len(sol.log.times) // MESH_CHUNK["sparse"]
        out["host_ms_per_chunk"]["supervised" if sup else "plain"] = {
            k: v * 1e3 / chunks for k, v in seconds.items() if v}
        del sol

    out["profile"] = {}
    for sup in (False, True):
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        marks = []

        def window(event):
            # each chunk's end; the profile starts at the first
            if not marks:
                torch.cuda.synchronize()
                prof.start()
            marks.append((time.perf_counter(), event["done"]))

        run(sup, window)
        prof.stop()
        wall_ms = (marks[-1][0] - marks[0][0]) * 1e3
        iters = marks[-1][1] - marks[0][1]
        busy = nccl = 0.0
        host = []
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA:
                ms = ev.self_device_time_total / 1e3
                busy += ms
                if "nccl" in ev.key.lower():
                    nccl += ms
            else:
                host.append((ev.self_cpu_time_total / 1e3, ev.key[:60],
                             ev.count))
        out["profile"]["supervised" if sup else "plain"] = {
            "wall_ms_per_iter": wall_ms / iters,
            "device_ms_per_iter": busy / iters,
            "nccl_ms_per_iter": nccl / iters,
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "host_top_ms_per_iter": [(k, ms / iters, n) for ms, k, n in
                                     sorted(host, reverse=True)[:8]]}
    return out


def lone_fault(rank, inputs, mesh):
    """Rank ``SUP_MESH_LONE_RANK`` alone meets a Jacobi fault in the
    low-rank path's second chunk, past a collective: it waits out the
    vote, raises ``MeshFaultError`` and tears the mesh down, and every
    other rank must raise it too (over NCCL, once its watch has aborted
    its communicators).  Returns this rank's error, its seconds in the
    call and the host clock when it raised (the ranks share a host)."""
    from repro_torch.resilience import chaos
    from repro_torch.resilience.recovery import ResilienceConfig
    spec = SUP_MESH_LONE_SPEC if rank == SUP_MESH_LONE_RANK else ""
    t0 = time.perf_counter()
    err = None
    try:
        with chaos.active_chaos(chaos.ChaosConfig.parse(spec)):
            mesh_solve("lowrank", inputs, mesh,
                       resilience=ResilienceConfig())
    except Exception as e:
        err = e
    return {"type": type(err).__name__ if err is not None else None,
            "error": str(err)[:400] if err is not None else None,
            "seconds": time.perf_counter() - t0, "raised_at": time.time()}


def sup_serve(torch, rank, mesh, Y, P):
    """22(b)'s service: rank 0 serves phase 20's catalogues over HTTP as
    one bucket, then runs the poison-bucket drill; the other ranks
    follow both."""
    import threading

    import numpy as np

    from repro_torch.core import driver as driver_mod
    from repro_torch.core import problem as problem_mod
    from repro_torch.serve import drill, follow
    from repro_torch.serve.client import ServeClient
    from repro_torch.serve.server import ServeConfig, serve_http
    # the seconds of a bucket's parts on this rank: its stacking, its
    # chunks and its gather to every rank
    parts = {"stack_bucket": [], "run": [], "host_states": []}

    def timed(owner, name):
        fn = getattr(owner, name)

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                parts[name].append(time.perf_counter() - t0)

        setattr(owner, name, wrapper)

    timed(problem_mod, "stack_bucket")
    timed(driver_mod.BatchedDriver, "run")
    timed(driver_mod.BatchedDriver, "host_states")
    if rank != 0:
        calls = [c for _ in range(2) for c in follow(mesh)]
        # each call's kind and result, and its chunks' seconds
        kinds = [(kind, type(r).__name__) for kind, r in calls]
        walls = [sum((r[0] if isinstance(r, list) else r).times)
                 if not isinstance(r, Exception) else None
                 for _, r in calls]
        return {"kinds": kinds, "walls": walls, "parts": parts}
    edges = np.cumsum((0,) + BUCKET_SIZES)
    insts = [(Y[a:b], P[a:b]) for a, b in zip(edges[:-1], edges[1:])]
    options = dict(max_iter=MAIN_ITERS, chunk=MAIN_CHUNK,
                   cost_every="chunk", tol=1e-5)
    handle = serve_http(ServeConfig(max_batch=len(insts),
                                    batch_window_s=SERVE_WINDOW_S),
                        mesh=mesh)
    try:
        client = ServeClient(handle.url, timeout=300)
        ids = [None] * len(insts)

        def send(j):
            ids[j] = client.submit("deconvolve", insts[j],
                                   cfg=dict(mode="sparse", n_scales=SCALES),
                                   options=options)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=send, args=(j,))
                   for j in range(len(insts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        results = [client.result(rid, include_x=True, timeout=300)
                   for rid in ids]
        wall = time.perf_counter() - t0
        metrics = client.metrics()
        recs = [handle.runner.service.records[rid] for rid in ids]
        # each request's wait for its bucket and its bucket's run
        stages = [(r.started_at - r.submitted_at,
                   r.finished_at - r.started_at) for r in recs]
    finally:
        handle.close()
    t0 = time.perf_counter()
    detail = drill.drill_poison_bucket(device="cuda", mesh=mesh)
    return {"results": [{k: r[k] for k in ("costs", "iters_run", "x",
                                           "batch_size", "bucket_key")}
                        for r in results],
            "wall_s": wall, "latency_s": metrics["latency_s"],
            "stages_s": stages, "parts": parts,
            "batches": metrics["batch_occupancy"]["batches"],
            "broadcast_s": metrics["input_broadcast_s"],
            "drill": {"seconds": time.perf_counter() - t0,
                      "counters": detail["counters"]}}


def sup_world_start(torch, backend, size):
    """Start 22(b)'s ranks (or the supervised NCCL ranks, one a card):
    they start up, then wait for ``sup_world_phase`` to let them work.
    Returns the handle ``sup_world_phase`` takes."""
    import shutil

    import numpy as np

    from repro_torch.imaging.psf import simulate
    shutil.rmtree(SUP_MESH_DIR, ignore_errors=True)
    SUP_MESH_DIR.mkdir(parents=True)
    data = simulate(MAIN_N, torch.Generator().manual_seed(42), stamp=STAMP)
    for i, t in enumerate((data.Y, data.psfs)):
        np.save(SUP_MESH_DIR / f"stamps_{i}.npy", t.cpu().numpy())
    del data
    logs = [open(SUP_MESH_DIR / f"sup_rank_{r}.log", "w")
            for r in range(size)]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--sup-rank",
         str(r), str(size), str(SUP_MESH_DIR), backend], stdout=logs[r],
        stderr=subprocess.STDOUT, cwd=str(ROOT)) for r in range(size)]
    return {"procs": procs, "logs": logs, "t0": time.perf_counter(),
            "backend": backend, "size": size}


def sup_world_stop(world) -> None:
    """Kill the ranks that are still running and close their logs."""
    for p in world["procs"]:
        if p.poll() is None:
            p.kill()
            p.wait()
    for f in world["logs"]:
        f.close()


def sup_world_phase(torch, world, phase17=None, meanwhile=None):
    """22(b) (``backend="gloo"``, the ranks sharing the card) or the
    supervised paths over NCCL one rank a card, on the ranks
    ``sup_world_start`` started: each rank's supervised runs
    bit-identical to its unsupervised ones, the same report on every
    rank; with gloo the served bucket against phase 17's bucket (rtol
    1e-4, the gap reported) and the drill.  ``meanwhile()`` runs here
    first (the ranks begin their work after it); returns this phase's
    report and what ``meanwhile`` returned."""
    import pickle

    import numpy as np
    procs, t0 = world["procs"], world["t0"]
    backend, size = world["backend"], world["size"]
    try:
        before = meanwhile() if meanwhile is not None else None
        (SUP_MESH_DIR / "go").touch()
        t_go = time.perf_counter()
        # over NCCL a hung peer fails at its group's 90 s
        bound = SUP_MESH_TIMEOUT_S if backend == "gloo" else 180
        for p in procs:
            p.wait(timeout=max(1.0, bound - (time.perf_counter() - t_go)))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"supervised mesh ranks: no end within "
                             f"{bound} s")
    finally:
        sup_world_stop(world)
    world_s = time.perf_counter() - t0
    after_go_s = time.perf_counter() - t_go
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        tails = {r: (SUP_MESH_DIR / f"sup_rank_{r}.log").read_text()[-2000:]
                 for r in bad}
        raise AssertionError(f"supervised mesh ranks {bad} failed: {tails}")
    ranks = [pickle.loads((SUP_MESH_DIR / f"sup_{r}.pkl").read_bytes())
             for r in range(size)]
    where = (f"{size} processes time-sharing one card" if backend == "gloo"
             else f"{size} ranks on {size} cards")
    out = {"world_s": world_s, "after_go_s": after_go_s,
           "rank_seconds": [r["seconds"] for r in ranks]}
    log(f"supervised mesh ({size},) {backend}: each rank's seconds "
        f"{out['rank_seconds']}")
    for name, want in (("sparse", (1, 1)), ("lowrank", (1, 0))):
        rows = [r[name] for r in ranks]
        rep = rows[0]["report"]
        same = all(r["report"] == rep for r in rows)
        bits = all(r["bit_identical"] for r in rows)
        out[name] = {"report": rep, "same_report": same,
                     "bit_identical": bits,
                     "ms_per_iter": [r["ms_per_iter"] for r in rows],
                     "plain_ms_per_iter": [r["plain_ms_per_iter"]
                                           for r in rows],
                     "wall_s": [r["wall_s"] for r in rows],
                     "plain_wall_s": [r["plain_wall_s"] for r in rows],
                     "syncs_per_chunk": [r["syncs_per_chunk"] for r in rows],
                     "plain_from_phase21": rows[0]["plain_from_phase21"]}
        log(f"supervised mesh ({size},) {backend} {name}, {where}: "
            f"retries {rep['retries']}, rollbacks {rep['rollbacks']}, "
            f"faults {[(f['point'], f['step'], f.get('rank')) for f in rep['faults']]}; "
            f"the same report on every rank {same}; bit-identical to the "
            f"ranks' unsupervised run "
            f"{'(phase 21(b)) ' if out[name]['plain_from_phase21'] else ''}"
            f"{bits}; ms/iteration "
            f"{out[name]['ms_per_iter']} (unsupervised "
            f"{out[name]['plain_ms_per_iter']}); host syncs per chunk "
            f"{out[name]['syncs_per_chunk']} (reported, not gated)")
        if not (same and bits) or (rep["retries"], rep["rollbacks"]) != want:
            raise AssertionError(f"supervised mesh {name}: same report "
                                 f"{same}, bit-identical {bits}, report "
                                 f"{rep}")
    if backend == "nccl":
        over = [r["overhead"] for r in ranks]
        out["overhead"] = over
        for r, o in enumerate(over):
            pr = o["profile"]
            log(f"supervision without faults, rank {r} of {size} NCCL ranks: "
                f"ms/iteration in turns {o['ms_per_iter']}; host ms a chunk "
                f"by part {o['host_ms_per_chunk']}; profiled, wall / device "
                f"/ NCCL ms an iteration and idle share: unsupervised "
                f"{pr['plain']['wall_ms_per_iter']:.4f} / "
                f"{pr['plain']['device_ms_per_iter']:.4f} / "
                f"{pr['plain']['nccl_ms_per_iter']:.4f} / "
                f"{pr['plain']['idle_share']:.3f}, supervised "
                f"{pr['supervised']['wall_ms_per_iter']:.4f} / "
                f"{pr['supervised']['device_ms_per_iter']:.4f} / "
                f"{pr['supervised']['nccl_ms_per_iter']:.4f} / "
                f"{pr['supervised']['idle_share']:.3f}")
            log(f"  rank {r} host operations (ms an iteration, count): "
                f"unsupervised {pr['plain']['host_top_ms_per_iter']}; "
                f"supervised {pr['supervised']['host_top_ms_per_iter']}")
        lone = [r["lone"] for r in ranks]
        at = lone[SUP_MESH_LONE_RANK]["raised_at"]
        lag = [r["raised_at"] - at for r in lone]
        out["lone"] = {"spec": SUP_MESH_LONE_SPEC, "rank":
                       SUP_MESH_LONE_RANK, "ranks": lone,
                       "lag_s": lag}
        log(f"a fault on rank {SUP_MESH_LONE_RANK} alone past a collective "
            f"({SUP_MESH_LONE_SPEC}): each rank's error "
            f"{[r['type'] for r in lone]}, seconds in the call "
            f"{[round(r['seconds'], 3) for r in lone]}, raised "
            f"{[round(x, 3) for x in lag]} s after rank "
            f"{SUP_MESH_LONE_RANK}; {lone[0]['error']}")
        if any(r["type"] != "MeshFaultError" for r in lone) or \
                max(lag) > 30.0:
            raise AssertionError(f"lone fault over NCCL: {lone}")
    if backend == "gloo":
        served = ranks[0]["serve"]
        kinds = [r["serve"]["kinds"] for r in ranks[1:]]
        gap = 0.0
        for got, want in zip(served["results"], phase17["bucket"]):
            w = np.asarray(want.log.costs)
            g = np.asarray(got["costs"])
            fin = np.isfinite(w)
            np.testing.assert_allclose(g[fin], w[fin], rtol=BUCKET_RTOL)
            np.testing.assert_allclose(got["x"], want.x, rtol=BUCKET_RTOL,
                                       atol=1e-6)
            gap = max(gap, float(np.max(np.abs(g[fin] - w[fin])
                                        / np.abs(w[fin]))))
        out["serve"] = {k: served[k] for k in ("wall_s", "latency_s",
                                               "batches", "broadcast_s",
                                               "drill", "stages_s")}
        out["serve"]["follower_walls"] = [r["serve"]["walls"]
                                          for r in ranks[1:]]
        out["serve"]["bucket_parts_s"] = [r["serve"]["parts"]
                                          for r in ranks]
        log(f"served under the mesh: each rank's seconds in its buckets' "
            f"stacking, chunks and gather {out['serve']['bucket_parts_s']}")
        log(f"served under the mesh: each request's wait for its bucket "
            f"and the bucket's run (s) {served['stages_s']}; the seconds "
            f"of each follower's calls' chunks "
            f"{out['serve']['follower_walls']}")
        out["serve"]["max_rel_cost_gap_to_phase17"] = gap
        out["serve"]["follower_calls"] = kinds
        log(f"served under the mesh: {len(served['results'])} HTTP requests "
            f"to rank 0, ranks 1-{size - 1} following, batches "
            f"{served['batches']} (batch sizes "
            f"{sorted({r['batch_size'] for r in served['results']})}); "
            f"largest relative cost gap to phase 17's bucket {gap:.3e}; "
            f"input broadcast {served['broadcast_s']} s; latency "
            f"{served['latency_s']}; wall {served['wall_s']:.2f} s; the "
            f"followers' calls {kinds[0]}; drill poison-bucket under the "
            f"mesh: ok in {served['drill']['seconds']:.2f} s "
            f"({ {k: v for k, v in served['drill']['counters'].items() if v} })")
        if served["batches"] != 1 or \
                {r["batch_size"] for r in served["results"]} != \
                {len(BUCKET_SIZES)}:
            raise AssertionError(f"served under the mesh: not one bucket "
                                 f"({served['batches']} batches)")
        if any(k != kinds[0] for k in kinds) or kinds[0][0] != \
                ("solve_many", "list"):
            raise AssertionError(f"followers' calls {kinds}")
    log(f"supervised mesh ({size},) {backend} world: {world_s:.1f} s "
        f"since its ranks started, {after_go_s:.1f} s of work after their "
        f"start-up, {where}"
        + (" (not a multi-GPU figure)" if backend == "gloo" else ""))
    return out, before


def supervised_mesh_phase(torch, world, phase19, phase17):
    """Phase 22: (a), then (b) on the ranks started (``world``) while
    phase 21(b) ran."""
    t0 = time.perf_counter()
    out = {}
    out["gloo"], out["nccl"] = sup_world_phase(
        torch, world, phase17,
        meanwhile=lambda: supervised_nccl_phase(torch, phase19))
    out["seconds"] = time.perf_counter() - t0
    out["seconds_with_start_up"] = time.perf_counter() - world["t0"]
    log(f"phase 22: {out['seconds']:.1f} s ({out['seconds_with_start_up']:.1f} "
        f"s with 22(b)'s start-up, which overlaps phase 21(b))")
    return out


# ---------------------------------------------------------------- 23
LINT_TIMEOUT_S = 300
# the deprecated shims' warnings, which name the entry point to use
SHIM_WARNING = "is deprecated; use repro_torch.core.problem.solve("


def record_run(torch, run):
    """``run(progress_fn)`` under torch's sync debug mode: its result, the
    host syncs it made in all, the median between consecutive progress
    events (one event per chunk; None where ``run`` passes none on) and
    the shims' deprecation warnings it raised."""
    syncs_at = []
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        def syncs():
            return sum("synchroniz" in str(w.message) for w in caught)

        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = run(lambda event: syncs_at.append(syncs()))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        total = syncs()
        shims = [str(w.message) for w in caught
                 if issubclass(w.category, DeprecationWarning)
                 and SHIM_WARNING in str(w.message)]
    steady = [b - a for a, b in zip(syncs_at, syncs_at[1:])]
    return out, total, statistics.median(steady) if steady else None, shims


def shim_run(torch, label, solve_run, shim, kernels):
    """A deprecated shim against ``solve`` on the same inputs: one
    warning, the solve's host syncs (one a chunk), its launches of
    ``kernels`` and its result bit for bit.  Returns the numbers."""
    want, _, per_chunk, solve_warned = record_run(torch, solve_run)
    # the same solve without a progress hook, as the shim passes none, and
    # after the first (whose setup fills the starlet norm's cache)
    reset_launches()
    _, plain_total, _, _ = record_run(torch, lambda _: solve_run(None))
    want_launches = read_launches()
    reset_launches()
    got, total, _, shims = record_run(torch, lambda _: shim())
    launches = read_launches()
    if solve_warned or len(shims) != 1:
        raise AssertionError(f"{label}: deprecation warnings {shims} (solve "
                             f"{solve_warned}), expected one from the shim")
    if per_chunk != 1 or total != plain_total:
        raise AssertionError(f"{label}: solve syncs {per_chunk} a chunk; shim "
                             f"{total} syncs in all against solve's "
                             f"{plain_total}")
    if launches != want_launches or not all(launches[k] for k in kernels):
        raise AssertionError(f"{label}: launches {launches}, solve's "
                             f"{want_launches}; expected each of {kernels}")
    return want, got, {"syncs_per_chunk": per_chunk, "syncs": total,
                       "launches": {k: launches[k] for k in kernels},
                       "warning": shims[0]}


def names_and_lint_phase(torch):
    """Phase 23: the JAX package's public names the port took on (ROADMAP
    C1) on the card, and the port's linter on the chip host."""
    import os

    import numpy as np

    from repro_torch.core.bundle import Bundle
    from repro_torch.core.driver import IterativeDriver, RunOptions
    from repro_torch.core.problem import solve
    from repro_torch.data.synthetic import coupled_patches
    from repro_torch.imaging.condat import SolverConfig
    from repro_torch.imaging.deconvolve import deconvolve
    from repro_torch.imaging.psf import simulate
    from repro_torch.imaging.scdl import SCDLConfig, train

    t0 = time.perf_counter()
    # the linter runs on the host's cores while the card works
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    lint = subprocess.Popen([sys.executable, "-m", "repro_torch.lint"],
                            cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        out = {}
        # (a) the deconvolve shim on phase 5's 256 stamps
        data = simulate(PARITY_N, torch.Generator().manual_seed(5),
                        stamp=STAMP, device="cpu")
        cfg = SolverConfig(mode="sparse", n_scales=SCALES)
        kw = dict(max_iter=PARITY_ITERS, chunk=PARITY_CHUNK,
                  cost_every="chunk", tol=1e-5)
        want, got, out["deconvolve"] = shim_run(
            torch, "deconvolve shim",
            lambda progress: solve("deconvolve", data.Y, data.psfs, cfg=cfg,
                                   progress_fn=progress, **kw),
            lambda: deconvolve(data.Y, data.psfs, cfg, **kw),
            ("starlet2d.forward", "starlet2d.adjoint",
             "condat_elwise.primal", "condat_elwise.dual"))
        same = np.array_equal(want.x, got[0]) and \
            want.log.costs == got[1].costs
        log(f"deconvolve shim at n={PARITY_N}: {out['deconvolve']}; "
            f"bit-identical to solve: {same}")
        if not same:
            raise AssertionError("deconvolve shim differs from solve")
        # (b) the train shim on phase 9's K=2048, A=128 patches
        S_h, S_l = coupled_patches(SCDL_PARITY_K, SCDL_P, SCDL_M,
                                   SCDL_PARITY_A,
                                   torch.Generator().manual_seed(5),
                                   device="cpu")
        scfg = SCDLConfig(n_atoms=SCDL_PARITY_A)
        skw = dict(max_iter=SCDL_PARITY_ITERS, chunk=SCDL_PARITY_CHUNK,
                   cost_every="chunk")
        want, got, out["train"] = shim_run(
            torch, "train shim",
            lambda progress: solve("scdl", S_h, S_l, cfg=scfg,
                                   progress_fn=progress, **skw),
            lambda: train(S_h, S_l, scfg, **skw),
            ("admm_elwise", "dict_outer_pair"))
        same = np.array_equal(want.x[0], got[0]) and \
            np.array_equal(want.x[1], got[1]) and \
            want.log.costs == got[2].costs
        log(f"train shim at K={SCDL_PARITY_K} A={SCDL_PARITY_A}: "
            f"{out['train']}; bit-identical to solve: {same}")
        if not same:
            raise AssertionError("train shim differs from solve")
        # (c) IterativeDriver's legacy kwargs on the card (the ridge toy)
        g = torch.Generator().manual_seed(3)
        X = torch.randn((64, 4), generator=g)
        y = X @ torch.arange(1.0, 5.0)

        def ridge():
            return Bundle.create({"X": X, "y": y},
                                 replicated={"w": torch.zeros(4)},
                                 device="cuda")

        def step(d, rep, axes):
            r = d["X"] @ rep["w"] - d["y"]
            grad = d["X"].T @ r / d["X"].shape[0]
            return d, {"cost": 0.5 * torch.sum(r ** 2),
                       "w": rep["w"] - 0.1 * grad}

        def keep_w(rep, o):
            return {"w": o["w"]}

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            legacy = IterativeDriver(step, ridge(), max_iter=8, tol=0,
                                     chunk=4, update_replicated=keep_w)
        legacy_w = legacy.run().replicated["w"].cpu()
        opt = IterativeDriver(step, ridge(), options=RunOptions(
            max_iter=8, tol=0, chunk=4, update_replicated=keep_w))
        opt_w = opt.run().replicated["w"].cpu()
        warned = sum(issubclass(w.category, DeprecationWarning)
                     for w in caught)
        same = legacy.log.costs == opt.log.costs and \
            torch.equal(legacy_w, opt_w)
        out["driver_legacy"] = {"warnings": warned, "same": same,
                                "costs": [legacy.log.costs[0],
                                          legacy.log.costs[-1]]}
        log(f"IterativeDriver legacy kwargs on the card: {warned} "
            f"DeprecationWarning, costs {legacy.log.costs[0]:.6g} -> "
            f"{legacy.log.costs[-1]:.6g}, bit-identical to options=: "
            f"{same}")
        if warned != 1 or not same or \
                not legacy.log.costs[-1] < legacy.log.costs[0]:
            raise AssertionError("legacy IterativeDriver kwargs on the card")
        card_s = time.perf_counter() - t0
        # (d) the port's linter over the tree, in its own process
        text, _ = lint.communicate(timeout=LINT_TIMEOUT_S)
    finally:
        if lint.poll() is None:
            lint.kill()
            lint.wait()
    lint_s = time.perf_counter() - t0
    m = re.search(r"(\d+) files checked, (\d+) finding", text)
    out["lint"] = {"rc": lint.returncode, "seconds": lint_s,
                   "files": int(m.group(1)) if m else None,
                   "findings": int(m.group(2)) if m else None,
                   "python": sys.version.split()[0]}
    log(f"lint: python -m repro_torch.lint (Python "
        f"{out['lint']['python']}) over {out['lint']['files']} files: "
        f"exit {lint.returncode}, {out['lint']['findings']} findings, "
        f"{lint_s:.2f} s from the phase's start (it ran beside (a)-(c), "
        f"{card_s:.2f} s)")
    if lint.returncode != 0:
        raise AssertionError(f"python -m repro_torch.lint exited "
                             f"{lint.returncode}:\n{text[-4000:]}")
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 23: {out['seconds']:.1f} s")
    return out


KERNELS = {
    "starlet2d.smooth": ("src/repro_torch/csrc/starlet2d.cu",
                         "src/repro/kernels/starlet2d/kernel.py:45"),
    "starlet2d.forward": ("src/repro_torch/csrc/starlet2d.cu",
                          "src/repro/kernels/starlet2d/kernel.py:45 as "
                          "composed by src/repro/kernels/starlet2d/ops.py:63"),
    "starlet2d.adjoint": ("src/repro_torch/csrc/starlet2d.cu",
                          "src/repro/kernels/starlet2d/kernel.py:45 as "
                          "composed by src/repro/kernels/starlet2d/ops.py:68"),
    "condat_elwise.primal": ("src/repro_torch/csrc/condat_elwise.cu",
                             "src/repro/kernels/condat_elwise/kernel.py:65"),
    "condat_elwise.dual": ("src/repro_torch/csrc/condat_elwise.cu",
                           "src/repro/kernels/condat_elwise/kernel.py:91"),
    "admm_elwise": ("src/repro_torch/csrc/admm_elwise.cu",
                    "src/repro/kernels/admm_elwise/kernel.py:51"),
    "dict_outer_pair": ("src/repro_torch/csrc/dict_outer.cu",
                        "src/repro/kernels/dict_outer/kernel.py:99"),
    "dict_outer": ("src/repro_torch/csrc/dict_outer.cu",
                   "src/repro/kernels/dict_outer/kernel.py:49"),
    "condat_elwise.primal_xbar": (
        "src/repro_torch/csrc/condat_elwise.cu",
        "src/repro/kernels/condat_elwise/kernel.py:65 with with_xbar=True "
        "(_primal_xbar_kernel, :43)"),
    "jacobi.eigh": ("src/repro_torch/csrc/jacobi.cu",
                    "no TPU kernel: jnp.linalg.eigh at "
                    "src/repro/imaging/lowrank.py:59 and eigvalsh at :107 "
                    "(XLA)"),
    "jacobi.svd": ("src/repro_torch/csrc/jacobi.cu",
                   "no TPU kernel: jnp.linalg.svd at "
                   "src/repro/imaging/lowrank.py:66 (XLA)"),
    "condat_elwise.primal_batched": (
        "src/repro_torch/csrc/condat_elwise.cu",
        "src/repro/kernels/condat_elwise/kernel.py:65 under jax.vmap (a "
        "tau per instance: src/repro/core/engine.py:383)"),
    "condat_elwise.dual_batched": (
        "src/repro_torch/csrc/condat_elwise.cu",
        "src/repro/kernels/condat_elwise/kernel.py:91 under jax.vmap (a "
        "sig per instance: src/repro/core/engine.py:383)"),
}


def main() -> int:
    import torch
    smi = device_phase(torch)
    # the port must be importable from this checkout (fails when the
    # script stands alone)
    import repro_torch  # noqa: F401
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    # the whole log, also when a phase fails (the output shows its end)
    LOG_FILE.append(open(out_dir / "chip_smoke.log", "w"))
    log(smi)
    t_start = time.perf_counter()
    report = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    log("== build")
    report["build_s"] = build_phase()
    log("== kernels against their plain versions")
    errs = kernel_phase(torch)
    log("== per-instance Condat passes against their plain versions")
    errs.update(batched_condat_phase(torch))
    log("== main path")
    report["main_path"], bundle = main_path_phase(torch)
    log("== where the time of one iteration goes (torch.profiler)")
    report["profile"] = profile_phase(torch, bundle)
    del bundle
    log("== card against CPU")
    report["parity"] = parity_phase(torch)
    log("== timings (CUDA events, median of 30)")
    times = timing_phase(torch)
    log("== per-instance Condat timings (CUDA events, median of 30)")
    times.update(batched_timing_phase(torch))
    log("== SCDL kernels against their plain versions")
    errs.update(scdl_kernel_phase(torch))
    log("== SCDL main path")
    torch.cuda.reset_peak_memory_stats()
    report["scdl_main_path"], bundle, cfg = scdl_main_path_phase(torch)
    log("== where the time of one SCDL iteration goes (torch.profiler)")
    report["scdl_profile"] = scdl_profile_phase(torch, bundle, cfg)
    del bundle
    log("== SCDL card against CPU")
    report["scdl_parity"] = scdl_parity_phase(torch)
    log("== SCDL timings (CUDA events, median of 30)")
    times.update(scdl_timing_phase(torch))
    log("== Jacobi kernels against torch.linalg")
    jacobi_errs, report["jacobi"] = jacobi_phase(torch)
    errs.update(jacobi_errs)
    log("== low-rank path")
    report["lowrank_path"], bundle, cfg = lowrank_path_phase(torch)
    log("== where the time of one low-rank iteration goes (torch.profiler)")
    report["lowrank_profile"] = lowrank_profile_phase(torch, bundle, cfg)
    del bundle
    log("== low-rank card against CPU")
    report["lowrank_parity"] = lowrank_parity_phase(torch)
    log("== low-rank completion")
    report["completion"] = completion_phase(torch)
    log("== low-rank timings (CUDA events, median of 30)")
    times.update(lowrank_timing_phase(torch))
    log("== checkpoints on the main path")
    report["checkpoints"] = checkpoint_phase(torch)
    log("== buckets of deconvolutions (solve_many)")
    report["buckets"] = bucket_phase(torch,
                                     report["main_path"]["ms_per_iter"])
    log("== buckets of completions and SCDL (solve_many)")
    report["buckets"].update(bucket_completion_scdl_phase(torch))
    log("== supervision on the main path (resilience)")
    t0 = time.perf_counter()
    report["supervision"] = supervision_phase(
        torch, report["main_path"]["ms_per_iter"])
    report["supervision"]["seconds"] = time.perf_counter() - t0
    log("== serving on the card (HTTP, one bucket; the drills)")
    t0 = time.perf_counter()
    report["serving"] = serving_phase(torch, dict(
        PHASE17, setup_launches=report["buckets"]["sparse"]["setup_launches"],
        ms_per_iter=report["buckets"]["sparse"]["ms_per_iter"]))
    report["serving"]["seconds"] = time.perf_counter() - t0
    log("== multi-device: NCCL at world size 1, full width (mesh=)")
    t0 = time.perf_counter()
    report["mesh"], mesh_plain = mesh_nccl_phase(torch)
    # phase 22(b)'s ranks start up (torch, the card, torch._dynamo) while
    # phase 21(b)'s ranks run, after 21(a)'s timed runs, and wait for
    # phase 22
    sup_world = sup_world_start(torch, "gloo", MESH_RANKS)
    try:
        log("== multi-device: four gloo ranks sharing the card")
        report["mesh"]["gloo"] = mesh_gloo_phase(torch, mesh_plain)
        report["mesh"]["seconds"] = time.perf_counter() - t0
        del mesh_plain
    except BaseException:
        sup_world_stop(sup_world)
        raise
    log("== supervision and serving under a mesh")
    report["supervised_mesh"] = supervised_mesh_phase(
        torch, sup_world, report["supervision"], PHASE17)
    PHASE17.clear()
    log("== the JAX package's public names on the card; the port's linter")
    report["names_and_lint"] = names_and_lint_phase(torch)
    path_launches = {**report["main_path"]["launches"],
                     **{k: report["scdl_main_path"]["launches"][k]
                        for k in SCDL_KERNELS},
                     **{k: report["lowrank_path"]["launches"][k]
                        for k in LOWRANK_KERNELS},
                     **{k: report["buckets"]["sparse"]["launches"][k]
                        for k in BATCHED_KERNELS}}
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        t = times[name]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": path_launches[name],
                 "max_abs_err": errs[name], "ms": t["ms"],
                 "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                 "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                 "kernel_ms": t["ms"]}
        entry.update({k: v for k, v in t.items() if k not in entry})
        kernels.append(entry)
        print(json.dumps({"kernel": entry}), flush=True)
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    log(f"main path: {report['main_path']['ms_per_iter']} ms/iteration at "
        f"n={MAIN_N}, {report['main_path']['syncs_per_chunk']} host syncs "
        f"per chunk")
    log(f"scdl main path: {report['scdl_main_path']['ms_per_iter']} "
        f"ms/iteration at K={SCDL_K} A={SCDL_A}, "
        f"{report['scdl_main_path']['syncs_per_chunk']} host syncs per "
        f"chunk")
    b = report["buckets"]
    log(f"buckets: sparse {b['sparse']['ms_per_iter']} ms/iteration for "
        f"eight instances ({b['sparse']['singles_ms_per_iter_sum']:.4f} "
        f"summed alone); {SMALL_COUNT} small "
        f"{b['small']['ms_per_iter']} ({b['small']['singles_ms_per_iter_sum']:.4f}); "
        f"low rank {b['lowrank']['ms_per_iter']}; completion "
        f"{b['completion']['ms_per_iter']}; SCDL {b['scdl']['ms_per_iter']}; "
        f"checkpointed main path "
        f"{report['checkpoints']['ms_per_iter_checkpointed']}")
    log(f"low-rank path: {report['lowrank_path']['ms_per_iter']} "
        f"ms/iteration at n={MAIN_N} rank={LR_RANK}, completion "
        f"{report['completion']['ms_per_iter']} ms/iteration at "
        f"({COMP_N}, {COMP_P}); host syncs per chunk "
        f"{report['lowrank_path']['syncs_per_chunk']} and "
        f"{report['completion']['syncs_per_chunk']}")
    sv, sr = report["supervision"], report["serving"]
    log(f"supervision: {sv['ms_per_iter']} ms/iteration against "
        f"{sv['plain_ms_per_iter']} unsupervised; faulted run lost "
        f"{sv['faulted']['report']['wall_time_lost_s']} s; "
        f"{sv['seconds']:.1f} s of phase 19. Serving: {sr['ms_per_iter']} "
        f"ms/iteration for the served bucket against "
        f"{sr['phase17_ms_per_iter']}, latency {sr['latency_s']}; "
        f"{sr['seconds']:.1f} s of phase 20")
    mg = report["mesh"]
    with_mesh = {k: mg[k]["ms_per_iter"] for k in MESH_PATHS}
    meshless = {k: mg[k]["ms_per_iter_meshless"] for k in MESH_PATHS}
    log(f"multi-device: NCCL (1,) ms/iteration {with_mesh} against "
        f"meshless {meshless}; gloo "
        f"(4,) sharing the card {mg['gloo']['world_s']:.1f} s; "
        f"{mg['seconds']:.1f} s of phase 21")
    sm = report["supervised_mesh"]
    log(f"supervision under a (1,) NCCL mesh: "
        f"{sm['nccl']['ms_per_iter']} ms/iteration against "
        f"{sm['nccl']['plain_ms_per_iter']} unsupervised under it and "
        f"{sv['ms_per_iter']} meshless (phase 19); gloo (4,) supervised "
        f"and served {sm['gloo']['world_s']:.1f} s; "
        f"{sm['seconds']:.1f} s of phase 22")
    nl = report["names_and_lint"]
    log(f"shims: deconvolve and train bit-identical to solve, one "
        f"DeprecationWarning and one host sync a chunk each; linter over "
        f"{nl['lint']['files']} files clean; {nl['seconds']:.1f} s of "
        f"phase 23")
    report["command_s"] = time.perf_counter() - T_START
    log(f"whole run {report['seconds']:.1f} s after the device check; "
        f"command time {report['command_s']:.1f} s")
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        mesh_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                       Path(sys.argv[4]), *sys.argv[5:6])
        sys.exit(0)
    if sys.argv[1:2] == ["--sup-rank"]:
        sup_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                      Path(sys.argv[4]), *sys.argv[5:6])
        sys.exit(0)
    sys.exit(main())
