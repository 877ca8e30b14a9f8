"""A run of the deconvolution cells, with the timed path broken
underneath, comes out not correct (CPU, small sizes; the harness's look
for a chip skipped)."""
import pytest

from portbench import harness
from portbench import faults as _faults

from repro_torch.imaging.deconvolve import DeconvolutionProblem

SMALL = dict(stamps=16, catalogues=2, iterations=8, chunk=4)


def _run(cell, seconds=3.0, seed=2 ** 31 + 101, **params):
    """The cell at a small size on the CPU.  A window in which no unit
    returned compares nothing; on a host that the rest of a test run
    keeps busy, the window is made longer until one does."""
    spec = harness.workload(cell)
    spec["params"] = dict(spec["params"], **params)
    for s in (seconds, 3 * seconds, 9 * seconds):
        r = harness.run_cell(cell, seed, s, False, device="cpu", spec=spec,
                             log=lambda m: None)
        if "not_compared" not in r["checks"]:
            break
    return r


def _assert_caught(result, cell):
    """Not correct, and for the fault: every number was compared, and one
    reads above its limit."""
    limits = harness.workload(cell)["limits"]
    checks = result["checks"]
    assert set(checks) == set(limits), checks
    assert result["correct"] is False
    assert any(not isinstance(c["value"], float) or c["value"] > c["limit"]
               for c in checks.values()), checks


def test_sound_run_is_correct():
    r = _run("deconv-sparse-10k", **SMALL)
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] >= 2 and r["failed"] == 0
    assert set(r["metrics"]) == {"stamps_per_s", "setup_s"}


@pytest.mark.parametrize("hook,fault", [
    ("light_step", _faults.deconv_unchanged),
    ("light_step", _faults.deconv_half_batch),
    ("finalize", _faults.deconv_altered)],
    ids=["state_unchanged", "half_batch", "answer_altered"])
def test_fault_is_caught(monkeypatch, hook, fault):
    with _faults.patched(monkeypatch, DeconvolutionProblem, hook, fault):
        r = _run("deconv-sparse-10k", **SMALL)
    _assert_caught(r, "deconv-sparse-10k")


def test_served_answer_altered_is_caught(monkeypatch):
    """The service solves in this process, so the fault reaches it."""
    params = dict(stamps_min=8, stamps_max=12, iterations=8, chunk=4,
                  processes=2, threads=2, judged=3)
    with _faults.patched(monkeypatch, DeconvolutionProblem, "finalize",
                         _faults.deconv_altered):
        r = _run("deconv-served-small", seconds=4.0, **params)
    _assert_caught(r, "deconv-served-small")
    assert r["attempted"] > 0
