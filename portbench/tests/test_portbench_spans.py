"""Reading the program's spans (``portbench.spans``) on a hand-built
timeline: a catalogue's set-up with its draws and norms, three chunks
of launch and sync, the copy-back, and the device's work between."""
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import harness, loop, profiling, spans

CHUNK = 4


def _ev(name, a, b, device=DeviceType.CPU, annotation=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a,
                                                                 end=b),
                           device_type=device, is_user_annotation=annotation)


def _prog(name, a, b):
    return _ev(spans.PROGRAM_PREFIX + name, a, b)


def _timeline():
    """Microseconds: the window is [0, 1000)."""
    host = [_ev(profiling.WINDOW_SPAN, 0, 1000),
            _ev(profiling.SPAN_PREFIX + "solve", 10, 990),
            _prog("solve", 20, 975), _prog("solve.init", 30, 400),
            _prog("deconvolve.draws", 40, 200), _ev("aten::normal_", 50, 150),
            _prog("deconvolve.norms", 210, 390), _prog("solve.run", 410, 900),
            _prog("driver.launch", 410, 450), _prog("driver.sync", 450, 600),
            _prog("driver.launch", 610, 640), _prog("driver.sync", 640, 750),
            _prog("driver.launch", 760, 800), _prog("driver.sync", 800, 890),
            _prog("solve.finalize", 905, 970)]
    marks = [_ev(profiling.MARK_SPAN, t, t) for t in (600, 750, 890)]
    device = [_ev("kernel", a, b, DeviceType.CUDA) for a, b in
              ((215, 380), (385, 395), (420, 590), (615, 745), (765, 885),
               (910, 960))]
    # the device's copy of a program span is no operation
    device.append(_ev(spans.PROGRAM_PREFIX + "driver.launch", 610, 640,
                      DeviceType.CUDA, annotation=True))
    prof = SimpleNamespace(events=lambda: host + marks + device)
    return profiling.Timeline(prof, 1e-3)


def test_span_seconds():
    tl = _timeline()
    assert spans.span_s(tl, "deconvolve.draws") == pytest.approx(160e-6)
    assert spans.span_s(tl, "driver.launch") == pytest.approx(110e-6)
    # the launches that start in [600, 890): the second and third chunk's
    assert spans.span_s(tl, "driver.launch", 600, 890) == pytest.approx(
        70e-6)
    assert spans.span_s(tl, "solve.finalize", 0, 900) == 0.0
    assert spans.span_s(tl, "no.such.span") == 0.0


def test_idle_by_span():
    got = dict(spans.idle_by_span(_timeline()))
    want = {"deconvolve.draws": 215e-6, "solve.run": 70e-6, "solve": 25e-6,
            spans.OUTSIDE: 40e-6, "gaps under 20 us": 5e-6}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v), k


def test_trace_spans_beside_the_trace_entry():
    tl = _timeline()
    entry = loop.trace_entry(tl, CHUNK, {})
    # the kernels at 615 and 765; the annotation's copy is left out
    assert entry["ops"] == 2
    extra = spans.trace_spans(tl)
    assert extra["spans"]["driver.sync"] == pytest.approx(350e-6)
    assert extra["spans"]["solve.init"] == pytest.approx(370e-6)
    assert extra["launch_s"] == pytest.approx(70e-6)
    assert extra["idle_by_span"] == spans.idle_by_span(tl)
    rec = {"trace": dict(entry, **extra)}
    read = {name: harness.reader(name).read(rec) for name in spans.METRICS}
    assert read["init_ms.deconv"] == pytest.approx(0.370)
    assert read["draws_ms.deconv"] == pytest.approx(0.160)
    assert read["norms_ms.deconv"] == pytest.approx(0.180)
    assert read["finalize_ms.scdl"] == pytest.approx(0.065)
    for cell in ("deconv", "scdl", "mesh"):
        assert read[f"launch_ms_per_iter.{cell}"] == pytest.approx(
            1e3 * 70e-6 / (CHUNK * 2))


@pytest.mark.parametrize("name", sorted(spans.METRICS))
def test_readers_find_nothing_without_spans(name):
    """A traced record as ``loop.trace_entry`` builds it, with no
    program spans in it."""
    r = harness.reader(name)
    assert r.UNIT == "ms" and r.MOVES in ("stamps_per_s", "train_iter_ms",
                                          "mesh_iter_ms")
    rec = {"trace": loop.trace_entry(_timeline(), CHUNK, {})}
    assert r.read(rec) is None
    assert r.read({"trace": None}) is None
