"""Dictionary trainings back to back on a mesh of ``ranks`` cards, one
process a card (NCCL; gloo on the CPU), every rank calling
``solve("scdl", ..., mesh=)`` with the same full patches, as the port's
SPMD meshes run.

Rank 0 is the process the benchmark started: it starts ranks 1.. as
``run.py --rank r --port p`` (``follower``), makes the patch sets from
the seed and broadcasts them, and before each training broadcasts
whether the window is still open, so every rank runs the same trainings.
The window, the counts of ``core.compat.COLLECTIVES`` and the result
are rank 0's; a traced run profiles one more training on every rank and
averages the device's busy seconds over the ranks.  After the window
every rank reports a digest of its dictionaries of the judged set: the
ranks must agree bit for bit, and rank 0's are compared with the plain
reference on one card.

Parameters (``params``): ``ranks`` and those of ``training_loop``.
"""
from __future__ import annotations

import hashlib
import json
import os
import socket
import subprocess
import sys
import time
from datetime import timedelta

from portbench import harness, loop, profiling
from portbench.profiling import span
from portbench.traffic import training_loop


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _digest(x) -> int:
    h = hashlib.blake2b(digest_size=7)
    for a in x:
        h.update(a.tobytes())
    return int.from_bytes(h.digest(), "little")


def _world(torch, rank: int, size: int, port: int, device: str):
    """Join the process group and build the (data = size, model = 1)
    mesh; returns ``(mesh, this rank's device)``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    os.environ["LOCAL_RANK"] = str(rank)
    dev, init = device, {}
    if device == "cuda":
        torch.cuda.set_device(rank)
        dev = f"cuda:{rank}"
        init["device_id"] = torch.device("cuda", rank)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            world_size=size, rank=rank,
                            timeout=timedelta(seconds=300), **init)
    return make_mesh((size, 1), ("data", "model"), device=device), dev


def _session(ctx, torch, rank: int, mesh, dev: str):
    """What every rank runs; rank 0's return is the outcome's record."""
    import torch.distributed as dist

    from repro_torch.core import compat
    from repro_torch.core.problem import solve
    from repro_torch.imaging.scdl import SCDLProblem

    p, c = ctx.params, ctx.config
    K, P, M = p["samples"], c["p_dim"], c["m_dim"]
    if rank == 0:
        sets = training_loop.make_sets(ctx, device=dev)
    else:
        sets = [(torch.empty((P, K), device=dev),
                 torch.empty((M, K), device=dev)) for _ in range(p["sets"])]
    with span("broadcast_inputs"):
        for S_h, S_l in sets:
            dist.broadcast(S_h, 0)
            dist.broadcast(S_l, 0)
    cfg = training_loop.scdl_config(c)
    flag = torch.zeros((), dtype=torch.int32, device=dev)

    def unit(k, progress):
        S_h, S_l = sets[k]
        with span("solve"):
            sol = solve(SCDLProblem(cfg), S_h, S_l, device=dev, mesh=mesh,
                        max_iter=p["iterations"], tol=0.0, chunk=p["chunk"],
                        cost_every=p["cost_every"], progress_fn=progress)
        return (sol.x, list(sol.log.costs)), sol.log

    def go(open_: bool) -> bool:
        flag.fill_(int(open_))
        dist.broadcast(flag, 0)
        return bool(flag.item())

    unit(0, None)
    loop.sync(torch, ctx.device)
    dist.barrier()
    if rank == 0:
        t0 = ctx.open_window()
        t_end = t0 + ctx.seconds
    calls0 = compat.COLLECTIVES["launches"]
    units, kept, in_window = [], {}, set()
    attempted = failed = 0
    last_end = time.perf_counter()
    while go(rank != 0 or time.perf_counter() < t_end):
        k = attempted % len(sets)
        attempted += 1
        a = time.perf_counter()
        res, log = unit(k, None)
        b = time.perf_counter()
        # every rank keeps the last result of each set: the same
        # training on every rank
        kept[k] = res
        if rank == 0 and b <= t_end:
            units.append(loop.unit_entry(log, b - a, p["chunk"], K))
            in_window.add(k)
            last_end = b
    calls = compat.COLLECTIVES["launches"] - calls0
    peak = loop.memory_peak(torch, ctx.device)
    record = {}
    if rank == 0:
        record = {"window_s": last_end - t0, "units": units,
                  "collectives": {"calls": calls,
                                  "iters": sum(u["iters"] for u in units)
                                  + p["iterations"] * (attempted
                                                       - len(units))}}
    trace = None
    if ctx.trace:
        def progress(event):
            profiling.mark()

        with profiling.profiled(torch, ctx.device == "cuda") as prof:
            unit(attempted % len(sets), progress)
        if prof.timeline is not None:
            trace = loop.trace_entry(prof.timeline, p["chunk"],
                                     training_loop.work_count(ctx))
    # the judged set, drawn by rank 0 among those done in the window;
    # every rank's peak, busy seconds and digest of that set's result
    judged = sorted(in_window)
    pick = torch.tensor(judged[int(ctx.uniform("judged") * len(judged))]
                        if judged else -1, dtype=torch.int64, device=dev)
    dist.broadcast(pick, 0)
    k = int(pick.item())
    mine = torch.tensor([float(peak),
                         trace["busy_s"] if trace else 0.0,
                         trace["window_s"] if trace else 0.0,
                         float(_digest(kept[k][0]) if k >= 0 else -1)],
                        dtype=torch.float64, device=dev)
    every = [torch.zeros_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    every = [t.tolist() for t in every]
    if rank == 0:
        record["memory_peak_bytes"] = int(max(e[0] for e in every))
        record["rank_digests"] = [e[3] for e in every]
        if trace is not None:
            # the readers read rank 0's own timeline; the device line
            # carries busy and wall seconds averaged over the ranks
            record["trace"] = trace
            record["device_trace"] = {
                "busy_s": sum(e[1] for e in every) / len(every),
                "window_s": sum(e[2] for e in every) / len(every),
                "breakdown": trace["breakdown"]}
    return record, attempted, failed, kept, k, sets


def run(ctx) -> harness.Outcome:
    import torch
    import torch.distributed as dist

    p = ctx.params
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(harness.ROOT / "src"), str(harness.ROOT)]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    cmd = [sys.executable, str(harness.HERE / "run.py"), "--workload",
           ctx.cell, "--seed", str(ctx.seed), "--seconds", str(ctx.seconds),
           "--trace", str(int(ctx.trace)), "--port", str(port),
           "--spec", json.dumps(ctx.workload)]
    if ctx.device != "cuda":
        cmd += ["--device", ctx.device]
    followers = [subprocess.Popen(cmd + ["--rank", str(r)], env=env,
                                  cwd=str(harness.ROOT),
                                  stdout=subprocess.DEVNULL)
                 for r in range(1, p["ranks"])]
    try:
        mesh, dev = _world(torch, 0, p["ranks"], port, ctx.device)
        record, attempted, failed, kept, k, sets = _session(
            ctx, torch, 0, mesh, dev)
        dist.barrier()
    finally:
        # the other ranks end after the last barrier without freeing
        # their groups (a rank freeing its NCCL groups while another
        # still holds them can wait for it); then this rank frees its own
        for f in followers:
            try:
                f.wait(timeout=60)
            except subprocess.TimeoutExpired:
                f.kill()
                f.wait()
        _leave()
    digests = record.pop("rank_digests")

    def judge():
        if k < 0:
            return {}
        out = training_loop.reference_gaps(ctx, *sets[k], kept[k])
        out["rank_mismatch"] = float(sum(d != digests[0] for d in digests))
        return out

    return harness.Outcome(
        record=record, attempted=attempted, failed=failed,
        memory_peak_bytes=record["memory_peak_bytes"], judge=judge,
        device_count=p["ranks"], trace=record.pop("device_trace", None))


def follower(cell: str, seed: int, seconds: float, trace: bool, rank: int,
             port: int, device: str = "cuda", spec=None) -> int:
    """Rank ``rank`` of the cell's mesh, started by rank 0's ``run``
    with its workload (``spec``)."""
    import torch
    import torch.distributed as dist
    ctx = harness.Run(cell, seed, seconds, trace, device=device, spec=spec)
    mesh, dev = _world(torch, rank, ctx.params["ranks"], port, device)
    code = 1
    try:
        _session(ctx, torch, rank, mesh, dev)
        dist.barrier()
        code = 0
    except BaseException:
        import traceback
        traceback.print_exc()
    # leave at once: nothing of this process is left to wait for, and
    # freeing the groups could wait for rank 0, which waits for this one
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def _leave() -> None:
    """Free this rank's process groups (the mesh's control plane and the
    default group)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
