"""Closed-loop clients of the solve service over HTTP.

The service runs in this process (``serve_http`` on 127.0.0.1, an
ephemeral port, ``ServeConfig`` at its defaults).  The clients run in
``processes`` other processes of ``threads`` threads each
(``served_client.py``), since real clients are other processes; each
sends its next request as soon as its last one was answered.  A request
is one catalogue of ``stamps_min``..``stamps_max`` stamps (uniform, from
the seed) with the same solver options (``iterations``, ``chunk``,
``cost_every``).

Latency is the client's, from just before its submit until its result,
with the iterate, was decoded; the window counts every request that
completed inside it.  Afterwards ``judged`` requests that completed in
the window, drawn from the seed with the largest among them, are
compared with the plain reference solving each catalogue alone.
A traced run profiles the last ``profile_s`` seconds of the window in
this process, and reads the service's own numbers from the requests
that completed before that stretch.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

from portbench import harness, profiling
from portbench.profiling import span
from portbench.reference import compare
from portbench.traffic import catalogue_loop
from portbench.traffic.served_client import request_inputs


def _clients(ctx, url: str):
    p = ctx.params
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(harness.ROOT / "src"), str(harness.ROOT)]),
        OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    per = p["threads"]
    procs = []
    for i in range(p["processes"]):
        ids = [str(i * per + t) for t in range(per)]
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "portbench.traffic.served_client",
             "--url", url, "--cell", ctx.cell, "--seed", str(ctx.seed),
             "--params", json.dumps(p), "--clients", *ids],
            cwd=str(harness.ROOT), env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True))
    return procs


def _read_until(proc, word: str):
    lines = []
    for line in proc.stdout:
        if line.strip() == word:
            return lines
        lines.append(line)
    raise RuntimeError(f"a client process ended before '{word}' "
                       f"(exit {proc.wait()})")


def _stop(procs) -> None:
    for proc in procs:
        try:
            proc.stdin.write("exit\n")
            proc.stdin.close()
        except (BrokenPipeError, ValueError):
            pass
    for proc in procs:
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def run(ctx) -> harness.Outcome:
    import torch

    from repro_torch.serve.server import serve_http
    from repro_torch.serve.service import ServeConfig

    p, c = ctx.params, ctx.config
    dev = ctx.device
    with span("serve_start"):
        server = serve_http(ServeConfig(), device=dev, port=0)
    procs = []
    try:
        # the clients' set-up sends one round of requests (warm-up)
        procs = _clients(ctx, server.url)
        for proc in procs:
            _read_until(proc, "ready")
        t0 = time.time() + 0.5
        t1 = t0 + ctx.seconds
        for proc in procs:
            proc.stdin.write(f"go {t0!r} {t1!r}\n")
            proc.stdin.flush()
        time.sleep(max(0.0, t0 - time.time()))
        ctx.open_window()
        tl = None
        prof_from = t1
        if ctx.trace:
            prof_from = max(t0, t1 - p["profile_s"])
            time.sleep(max(0.0, prof_from - time.time()))
            with profiling.profiled(torch, dev == "cuda") as prof:
                time.sleep(max(0.0, t1 - time.time()))
            tl = prof.timeline
        recs = []
        for proc in procs:
            recs += [json.loads(line) for line in _read_until(proc, "done")]
        peak = int(torch.cuda.max_memory_allocated()) if dev == "cuda" else 0
        # the requests submitted in the window, and those done in it
        attempted = [r for r in recs if t0 <= r["t_submit"] < t1]
        done = [r for r in attempted if r["ok"] and r["t_done"] <= t1]
        failed = sum(1 for r in attempted if not r["ok"])
        served = [r for r in done if r["t_done"] <= prof_from]
        record = {"latencies_s": [r["latency_s"] for r in done],
                  "inservice_s": [r["inservice_s"] for r in served
                                  if r.get("inservice_s") is not None],
                  # the mean over dispatches: the harmonic mean of the
                  # batch sizes of the requests they served
                  "batch_sizes": _dispatch_sizes(served),
                  "memory_peak_bytes": peak}
        trace = None
        if tl is not None:
            trace = {"busy_s": tl.busy_s(), "window_s": tl.window_s,
                     "breakdown": {"device_ops": tl.top_ops(),
                                   "idle_gaps": tl.idle_gaps()}}
            record["trace"] = trace
        picked = _sample(ctx, done, p["judged"])
        xs = _fetch(procs, picked)
    finally:
        _stop(procs)
        server.close()

    def judge():
        worst = {}
        for r in picked:
            key = f"{r['c']}:{r['j']}"
            Y, psfs = (t.to(dev) for t in request_inputs(
                ctx.cell, ctx.seed, p, c, r["c"], r["j"]))
            ref = catalogue_loop.reference(ctx, Y, psfs)
            g = catalogue_loop.gaps(xs.get(key),
                                    compare.chunk_costs(r["costs"] or [],
                                                        p["chunk"]), ref)
            for k, v in g.items():
                worst[k] = max(worst.get(k, 0.0), v)
        return worst

    return harness.Outcome(record=record, attempted=len(attempted),
                           failed=failed, memory_peak_bytes=peak,
                           judge=judge, trace=trace)


def _dispatch_sizes(reqs):
    """Dispatch sizes recovered from the requests they served: a
    dispatch of b requests appears b times."""
    sizes = [r["batch_size"] for r in reqs if r.get("batch_size")]
    if not sizes:
        return []
    n_dispatch = sum(1.0 / b for b in sizes)
    return [len(sizes) / n_dispatch]


def _sample(ctx, done, k: int):
    """The largest completed request and ``k - 1`` more drawn from the
    seed."""
    if not done:
        return []
    order = sorted(done, key=lambda r: (r["c"], r["j"]))
    largest = max(order, key=lambda r: (r["n"], -r["c"], -r["j"]))
    rest = [r for r in order if r is not largest]
    picked = [largest]
    for i in range(min(k - 1, len(rest))):
        picked.append(rest.pop(int(ctx.uniform("judged", i) * len(rest))))
    return picked


def _fetch(procs, picked):
    """The picked requests' iterates, from the client processes that
    hold them (numpy arrays by ``c:j``)."""
    from repro_torch.serve import codec
    keys = [f"{r['c']}:{r['j']}" for r in picked]
    out = {}
    for proc in procs:
        proc.stdin.write("send " + " ".join(keys) + "\n")
        proc.stdin.flush()
        for line in _read_until(proc, "sent"):
            rec = json.loads(line)
            if rec["x"] is not None:
                out[rec["key"]] = codec.decode_array(rec["x"])
    return out
