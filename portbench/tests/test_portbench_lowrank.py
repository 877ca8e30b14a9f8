"""The low-rank deconvolution cell (``deconv-lowrank-10k``) on the CPU at
small sizes: the port against its plain reference, the control and
lower precisions failing the comparison, the faults caught, the work
counts by hand and the device time read by launch."""
import ast
import inspect
import math
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from portbench import data, harness, launches, peaks, seeds, spans
from portbench import faults as _faults
from portbench.reference import compare, deconv_lowrank, deconv_sparse
from portbench.traffic import lowrank_loop
from portbench.work import galaxy_deconv_lowrank

from repro_torch.imaging.deconvolve import DeconvolutionProblem

CELL = "deconv-lowrank-10k"
LIMITS = harness.workload(CELL)["limits"]
# a small run of the cell through the harness (41 x 41 stamps)
SMALL = dict(stamps=32, catalogues=2, iterations=8, chunk=4)
SHAPES = {"n": 10000, "stamp": 41, "grid": 81, "columns": 24}


def _ctx(stamp=17, **params):
    spec = harness.workload(CELL)
    spec["params"] = dict(spec["params"], **params)
    ctx = harness.Run(CELL, 2 ** 31 + 29, 0, False, device="cpu", spec=spec)
    ctx.config = dict(ctx.config, stamp=stamp)
    return ctx


@pytest.fixture(scope="module")
def case():
    """64 stamps of 17 x 17, 24 iterations in chunks of 8."""
    torch.set_num_threads(2)
    ctx = _ctx(stamps=64, iterations=24, chunk=8)
    Y, psfs = data.catalogue(64, seeds.generator(7, "stamps"), stamp=17)
    sol = lowrank_loop.program(ctx, Y, psfs)
    costs = compare.chunk_costs(sol.log.costs, ctx.params["chunk"])
    return ctx, Y, psfs, sol.x, costs, lowrank_loop.reference(ctx, Y, psfs)


def test_lowrank_reference_matches_the_port(case):
    _, _, _, x, costs, ref = case
    g = lowrank_loop.gaps(x, costs, ref)
    assert set(g) == set(LIMITS)
    assert g["stamp_gap"] <= LIMITS["stamp_gap"] / 3, g
    assert g["cost_gap"] <= LIMITS["cost_gap"], g


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_lowrank_lower_precision_output_fails(case, dtype):
    """The port's iterate and costs stored in a lower precision fail."""
    _, _, _, x, costs, ref = case
    low = torch.as_tensor(x).to(dtype).float().numpy()
    g = lowrank_loop.gaps(low, [float(torch.tensor(c).to(dtype))
                                for c in costs], ref)
    assert g["stamp_gap"] > LIMITS["stamp_gap"], g


def test_lowrank_control_fails(case):
    """The control: the reference with its state in bfloat16."""
    ctx, Y, psfs, _, _, ref = case
    X, costs = lowrank_loop.reference(ctx, Y, psfs,
                                      round_state=torch.bfloat16)
    g = lowrank_loop.gaps(X.numpy(), costs, ref)
    # the control is held to stamp_gap; cost_gap's limit is held to the
    # faults that leave stamps unstepped (test_fault_is_caught)
    assert g["stamp_gap"] > 10 * LIMITS["stamp_gap"], g


def test_reference_runs_without_tf32(monkeypatch):
    """Both TF32 flags are off while the reference factors, and restored
    after."""
    seen = []
    real = torch.linalg.eigh

    def eigh(*a, **k):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return real(*a, **k)

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.linalg, "eigh", eigh)
    Y, psfs = data.catalogue(8, seeds.generator(8, "stamps"), stamp=9)
    deconv_lowrank.solve(Y, psfs, lam=0.05, rank=4, iterations=2, chunk=2)
    assert seen and set(seen) == {(False, False)}
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32


def test_range_finder_svt_is_exact_at_low_rank():
    """On a matrix of rank under r the range finder's SVT is the full
    SVD's; its nuclear norm is that of the matrix times Omega."""
    g = seeds.generator(9, "low rank")
    a = torch.randn((60, 5), generator=g, dtype=torch.float64) @ \
        torch.randn((5, 49), generator=g, dtype=torch.float64)
    omega = deconv_lowrank.default_omega(49, 4)
    s = torch.linalg.svdvals(a)
    t = float(s[2])
    assert torch.allclose(deconv_lowrank.svt(a, omega, t),
                          deconv_lowrank.svt_exact(a, t), atol=1e-10)
    assert deconv_lowrank.nuclear_norm(a, omega) == pytest.approx(
        float(torch.linalg.svdvals(a @ omega.double()).sum()), rel=1e-6)


def test_exact_reading_on_a_small_catalogue():
    """The reading of the range finder against the exact SVT runs, and
    Eq. 3's objective takes the nuclear norm from singular values."""
    ctx = _ctx(stamp=9, stamps=12, catalogues=1, iterations=4, chunk=2)
    r = lowrank_loop.exact_svt_readings(ctx)
    assert r["catalogue"] == 0 and len(r["costs_exact"]) == 2
    assert all(math.isfinite(r[k]) for k in
               ("stamp_gap", "cost_gap", "eq3_exact", "eq3_range_finder"))
    Y, psfs = lowrank_loop.catalogues(ctx)[0]
    X = torch.rand(Y.shape, generator=seeds.generator(3, "x"))
    HX = deconv_sparse.convolve(X, deconv_sparse.psf_spectrum(psfs))
    want = 0.5 * float(torch.sum((Y.double() - HX.double()) ** 2)) \
        + 0.05 * float(torch.linalg.svdvals(X.reshape(12, -1).double())
                       .sum())
    assert deconv_lowrank.eq3_objective(Y, psfs, X, 0.05) == \
        pytest.approx(want, rel=1e-9)


def test_default_omega_is_the_solvers_draw():
    from repro_torch.imaging import lowrank
    assert torch.equal(deconv_lowrank.default_omega(1681, 16),
                       lowrank.make_test_matrix(1681, 16))


# ------------------------------------------------------------ the cell
def _run(seconds=3.0, seed=2 ** 31 + 103):
    """The cell at a small size on the CPU, its window made longer until
    a catalogue returns in it."""
    spec = harness.workload(CELL)
    spec["params"] = dict(spec["params"], **SMALL)
    for s in (seconds, 3 * seconds, 9 * seconds):
        r = harness.run_cell(CELL, seed, s, False, device="cpu", spec=spec,
                             log=lambda m: None)
        if "not_compared" not in r["checks"]:
            break
    return r


def test_sound_run_is_correct():
    r = _run()
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] >= 2 and r["failed"] == 0
    assert set(r["metrics"]) == {"stamps_per_s", "setup_s"}


@pytest.mark.parametrize("name", ["state_unchanged", "half_batch",
                                  "answer_altered"])
def test_fault_is_caught(monkeypatch, name):
    (target, hook, fault), = [(t, h, f) for n, t, h, f in
                              lowrank_loop.faults() if n == name]
    assert target is DeconvolutionProblem
    with _faults.patched(monkeypatch, target, hook, fault):
        r = _run()
    checks = r["checks"]
    assert set(checks) == set(LIMITS), checks
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in checks.values()), checks
    if name != "answer_altered":
        assert checks["cost_gap"]["value"] > checks["cost_gap"]["limit"], \
            checks


@pytest.mark.card
def test_control_fails_at_the_cells_size(card):
    """On the chip, at the cell's own size: the program reads inside the
    limits and the control above one of them."""
    ctx = harness.Run(CELL, 2 ** 31 + 23, 0, False)
    r = lowrank_loop.readings(ctx)
    assert all(r["program"][k] <= LIMITS[k] for k in LIMITS), r
    assert any(r["control"][k] > LIMITS[k] for k in LIMITS), r


# ---------------------------------------------------------- the counts
def test_iteration_by_hand():
    w = galaxy_deconv_lowrank.per_iteration(SHAPES)
    n, p, r = 10000, 1681, 24
    # Y, PSF, X read and written, U read and written, the SVT's two
    # reads: 8 planes of 41 x 41, and Omega, 4 bytes each
    assert w["bytes"] == 4 * (8 * n * p + p * r) == 538_081_376
    # A Omega, Q^T A and the rebuild; the Gram, Q and Q U_B; the QR of
    # B^T and Q_B W
    mm = 3 * 2 * n * p * r + 3 * 2 * n * r * r + (4 + 2) * p * r * r
    assert w["matmul_flops"] == mm
    fft = 2.5 * 6561 * math.log2(6561)
    per_stamp = 4 * fft + 2 * 6 * 81 * 41 + (1 + 7 + 5) * p
    assert w["flops"] == pytest.approx(n * per_stamp + 31 * r ** 3 + n * r,
                                       rel=1e-12)
    # bound by its bytes
    assert peaks.least_seconds(w) == pytest.approx(538_081_376 / 3.35e12)


def test_svt_by_hand():
    w = galaxy_deconv_lowrank.svt(SHAPES)
    n, p, r = 10000, 1681, 24
    # the matrix read twice and the result written once, and Omega
    assert w["bytes"] == 4 * (3 * n * p + p * r) == 201_881_376
    assert w["matmul_flops"] == galaxy_deconv_lowrank.per_iteration(
        SHAPES)["matmul_flops"]
    assert w["flops"] == 31 * r ** 3 + n * r
    assert peaks.least_seconds(w) == pytest.approx(201_881_376 / 3.35e12)


def test_counts_read_shapes_alone():
    tree = ast.parse(inspect.getsource(galaxy_deconv_lowrank))
    imported = {a.name.split(".")[0] for n in ast.walk(tree)
                if isinstance(n, ast.Import) for a in n.names}
    imported |= {n.module.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module}
    assert imported <= {"__future__", "math"}
    for fn in (galaxy_deconv_lowrank.per_iteration, galaxy_deconv_lowrank.svt):
        assert list(inspect.signature(fn).parameters) == ["shapes"]


# ------------------------------------------------- device time by launch
def _ev(name, a, b, id=0, device=DeviceType.CPU, annotation=False):
    return SimpleNamespace(name=name, id=id, device_type=device,
                           time_range=SimpleNamespace(start=a, end=b),
                           is_user_annotation=annotation)


def _events():
    """Microseconds: an SVT span at [100, 200] with an ``mm`` inside and
    a kernel launched from the span itself (as ``ctypes`` does); an
    ``add`` after it; a ``mul`` and a second SVT after the stretch
    [50, 300).  A launch call and its device operation share an id."""
    svt = spans.PROGRAM_PREFIX + lowrank_loop.SVT_SPAN
    cuda = DeviceType.CUDA
    return [_ev(svt, 100, 200, id=1), _ev("aten::mm", 110, 120, id=2),
            _ev("cudaLaunchKernel", 112, 115, id=11),
            _ev("cudaLaunchKernel", 150, 152, id=12),
            # an operation's own id may equal a launch's: not a launch
            _ev("aten::add", 250, 260, id=13),
            _ev("cudaLaunchKernel", 252, 255, id=14),
            _ev("cudaLaunchKernel", 322, 325, id=15),
            _ev(svt, 340, 380, id=3),
            _ev("gemm", 130, 160, id=11, device=cuda),
            _ev("jacobi", 160, 165, id=12, device=cuda),
            _ev("add", 262, 312, id=14, device=cuda),
            _ev("mul", 335, 345, id=15, device=cuda),
            _ev("lost", 300, 307, id=13, device=cuda),
            # the device's copy of the span is no operation
            _ev(svt, 100, 200, id=1, device=cuda, annotation=True)]


def test_device_time_by_launch():
    got = launches.by_launch(_events(), lowrank_loop.SVT_SPAN, 50, 300)
    assert got["spans"] == 1
    assert got["inside_s"] == pytest.approx(35e-6)
    assert got["outside_s"] == pytest.approx(50e-6)
    assert got["unlinked_s"] == pytest.approx(7e-6)
    # a program without the span gives nothing to read
    assert launches.by_launch(_events(), "no.such.span", 50, 300) is None


def test_svt_readers():
    t = {"iters": 4, "launched": {"inside_s": 4e-3, "outside_s": 0.0,
                                  "unlinked_s": 0.0, "spans": 4},
         "svt_work": {"bytes": 3.35e9, "matmul_flops": 0.0, "flops": 0.0}}
    rec = {"trace": t}
    ms = harness.reader("svt_ms_per_iter.lowrank")
    share = harness.reader("roofline.lowrank_svt")
    assert ms.read(rec) == pytest.approx(1.0)
    # 1 ms of least time against 1 ms of device time
    assert share.read(rec) == pytest.approx(100.0)
    # the parent's traced record has no launches: nothing, and no raise
    parent = {"trace": {"iters": 48, "device_s": 0.2}}
    assert ms.read(parent) is None and share.read(parent) is None


def _traced_record(launched=True):
    """A traced record as ``lowrank_loop.run`` builds it at the cell's
    shapes (one catalogue of 60 iterations, 48 in the chunks after the
    first); the parent's has no launches and no SVT work."""
    t = {"iters": 48, "ops": 74.5 * 48, "device_s": 48 * 4.35e-3,
         "work": galaxy_deconv_lowrank.per_iteration(SHAPES),
         "window_s": 0.54, "busy_s": 0.52}
    if launched:
        t.update(launched={"inside_s": 48 * 0.57e-3,
                           "outside_s": 48 * 3.78e-3, "unlinked_s": 0.0,
                           "spans": 48},
                 svt_work=galaxy_deconv_lowrank.svt(SHAPES))
    unit = {"work": 10000, "iters": 60, "wall_s": 0.53, "chunk_s": 0.27,
            "iter_s": [4.46e-3] * 4}
    return {"units": [unit], "window_s": 0.53, "trace": t}


@pytest.mark.parametrize(
    "m", harness.cell_metrics(harness.benchmark(), CELL, True),
    ids=lambda m: m["name"])
def test_cell_reads_each_traced_metric(m):
    """Each per-layer metric of the cell reads its traced record, the
    accepted ``.deconv`` readers as in the sparse cell; on the parent's
    record only the SVT's metrics read nothing, and none raises."""
    r = harness.reader(m["name"])
    value = r.read(_traced_record())
    assert value is not None and 0 < value < math.inf, m["name"]
    if m["unit"] == "%":
        assert value <= 100, m["name"]
    parent = r.read(_traced_record(launched=False))
    if m["name"].endswith(".lowrank") or m["name"] == "roofline.lowrank_svt":
        assert parent is None
    else:
        assert parent == value


@pytest.mark.parametrize("key", harness.config(
    harness.workload(CELL)["config"])["reduced"])
def test_reduced_names_a_departure(key):
    """Each key the configuration lists in ``reduced`` is in its file,
    says what the source has instead, and is no width."""
    cfg = harness.config(harness.workload(CELL)["config"])
    assert isinstance(cfg[key], str) and "the source:" in cfg[key]
    assert not key.endswith(("_dim", "_rank")) and key != "rank"
