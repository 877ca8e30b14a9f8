"""A run of the dictionary-training cells, with the timed path broken
underneath, comes out not correct (CPU, small sizes; the harness's look
for a chip skipped; the mesh as two gloo ranks)."""
import pytest
import torch

from portbench import faults as _faults
from portbench.tests.test_portbench_faults_deconv import _assert_caught
from portbench.tests.test_portbench_faults_deconv import _run as _run_cell

import repro_torch.imaging.scdl as scdl_mod
from repro_torch.imaging.scdl import SCDLProblem

SMALL = dict(samples=600, iterations=6, chunk=3)


def _run(cell, seconds=3.0, **params):
    return _run_cell(cell, seconds, seed=2 ** 31 + 202, **params)


def test_sound_run_is_correct():
    r = _run("scdl-40k", **SMALL)
    assert r["correct"] is True, r["checks"]
    assert set(r["metrics"]) == {"train_iter_ms", "setup_s"}


@pytest.mark.parametrize("target,hook,fault", [
    (SCDLProblem, "light_step", _faults.scdl_unchanged),
    (scdl_mod, "_outer_products", _faults.scdl_half_batch),
    (SCDLProblem, "finalize", _faults.scdl_altered)],
    ids=["state_unchanged", "half_batch", "answer_altered"])
def test_fault_is_caught(monkeypatch, target, hook, fault):
    with _faults.patched(monkeypatch, target, hook, fault):
        r = _run("scdl-40k", **SMALL)
    _assert_caught(r, "scdl-40k")


@pytest.mark.parametrize("broken", [False, True],
                         ids=["sound", "exchange_left_out"])
def test_mesh_exchange(monkeypatch, tmp_path, broken):
    """Two gloo ranks.  With the all-reduce of the dictionary products
    left out (on every rank), the ranks and the reference disagree."""
    # two processes share this host's cores
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    if broken:
        (tmp_path / "sitecustomize.py").write_text(
            "import repro_torch.imaging.scdl as s\n"
            "s.psum_tree = lambda tree, axes: tree\n")
        monkeypatch.setenv("PYTHONPATH", str(tmp_path))
        monkeypatch.setattr(scdl_mod, "psum_tree", lambda tree, axes: tree)
    try:
        r = _run("scdl-40k-4chip", seconds=6.0, ranks=2, samples=600,
                 iterations=4, chunk=2)
    finally:
        torch.set_num_threads(threads)
    if broken:
        _assert_caught(r, "scdl-40k-4chip")
        assert r["checks"]["rank_mismatch"]["value"] >= 1
    else:
        assert r["correct"] is True, r["checks"]
        assert r["device"]["count"] == 2
