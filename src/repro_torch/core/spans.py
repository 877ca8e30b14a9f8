"""Profiler spans at the port's layer boundaries.

``span(name)`` is ``torch.profiler.record_function("repro_torch." +
name)`` while a torch profiler records, and a shared null context
otherwise, so an untraced call pays one flag check.  There is no
setting and no store of its own: the profiler records each span's start,
end and parent on the timeline it shares with the device's work, and its
chrome trace (``prof.export_chrome_trace``) is what one reads.

The spans (``repro_torch.`` + ...): ``solve`` and its ``solve.init``,
``solve.run`` and ``solve.finalize`` (``core.problem.solve``);
``deconvolve.draws`` (the default start vectors, noise and low-rank
test matrix drawn on the host and copied to the device) and
``deconvolve.norms`` (the operator norms' power iterations, up to their
host floats) inside ``solve.init``; ``driver.launch`` (enqueuing one
chunk) and ``driver.sync`` (the chunk's one host sync) inside
``solve.run``; ``lowrank.svt`` (one randomized SVT,
``imaging.lowrank.randomized_svt_local``) and ``lowrank.nuclear`` (the
range finder's nuclear norm, ``imaging.lowrank.nuclear_norm_rf``)
wherever they are called, inside ``driver.launch`` in a solve;
``completion.draws`` (the completion's default test matrix drawn on the
host and copied to the device, when none is injected) inside
``solve.init``, and ``completion.grad`` (the completion's masked
gradient step, once an iteration) inside ``driver.launch``
(``imaging.lowrank.LowRankCompletionProblem``).
"""
from __future__ import annotations

from contextlib import nullcontext

import torch
from torch.autograd import profiler as _profiler

PREFIX = "repro_torch."
_OFF = nullcontext()


def span(name: str):
    """A context manager that records ``repro_torch.<name>`` on the
    running profiler's timeline; a no-op when none records."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(PREFIX + name)
    return _OFF
