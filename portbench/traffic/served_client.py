"""One process of closed-loop clients of the solve service (started by
``served_loop.py``; not a traffic driver of its own).

    python3 -m portbench.traffic.served_client --url U --cell C --seed S \
        --params JSON --clients 0 1 ...

Each client is a thread with its own ``repro_torch.serve.client
.ServeClient``.  In set-up every client sends one request and waits
for it, then the process prints ``ready``.  After the line ``go <t0> <t1>`` on standard input
(wall-clock seconds), each sends its next request as soon as its last
one was answered, from ``t0`` until ``t1``: request ``j`` of client
``c`` is the catalogue the seed gives to ``(c, j)``.  Then the process
prints one JSON line per request and ``done``; for each later line
``send <c>:<j> ...`` it prints those requests' iterates as array
records, then ``sent``, and it exits on ``exit``.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def request_size(cell: str, seed: int, params: dict, c: int, j: int) -> int:
    """The stamps of request ``j`` of client ``c``: every client walks
    through all the sizes of the cell's range, one each, before any
    repeats, in an order drawn from the seed; so every seed sends the
    same sizes, uniform over the range, in another order."""
    from portbench import seeds
    lo, hi = params["stamps_min"], params["stamps_max"]
    sizes = list(range(lo, hi + 1))
    cycle, pos = divmod(j, len(sizes))
    order = sorted(sizes, key=lambda n: seeds.sub_seed(seed, cell, "size",
                                                       c, cycle, n))
    return order[pos]


def request_inputs(cell: str, seed: int, params: dict, cfg: dict, c: int,
                   j: int):
    """The catalogue of request ``j`` of client ``c`` (CPU tensors): its
    size (:func:`request_size`) and its stamps, from the seed."""
    from portbench import data, seeds
    n = request_size(cell, seed, params, c, j)
    gen = seeds.generator(seed, cell, "request", c, j, device="cpu")
    return data.catalogue(n, gen, stamp=cfg["stamp"],
                          sigma=cfg["sigma_noise"])


def request_body(params: dict, cfg: dict):
    """The solver settings every request sends (``cfg``, ``options``)."""
    return ({"mode": cfg["mode"], "n_scales": cfg["n_scales"],
             "k_sigma": cfg["k_sigma"]},
            {"max_iter": params["iterations"], "tol": 0.0,
             "chunk": params["chunk"], "cost_every": params["cost_every"]})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--url", required=True)
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--params", required=True)
    ap.add_argument("--clients", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness
    from repro_torch.serve import codec
    from repro_torch.serve.client import ServeClient

    torch.set_num_threads(1)
    params = json.loads(args.params)
    cfg = harness.config(harness.workload(args.cell)["config"])
    s_cfg, s_opts = request_body(params, cfg)
    # set-up: every client sends one request of its own (j = -1), so the
    # service meets buckets of the window's sizes before the window; the
    # first request of the window is made before it opens
    def warm(c: int) -> None:
        cl = ServeClient(args.url, timeout=600.0)
        Y, psfs = request_inputs(args.cell, args.seed, params, cfg, c, -1)
        cl.result(cl.submit("deconvolve", [Y.numpy(), psfs.numpy()],
                            cfg=s_cfg, options=s_opts),
                  include_x=True, timeout=600.0)

    warmers = [threading.Thread(target=warm, args=(c,), daemon=True)
               for c in args.clients]
    for t in warmers:
        t.start()
    for t in warmers:
        t.join()
    ready = {c: request_inputs(args.cell, args.seed, params, cfg, c, 0)
             for c in args.clients}
    print("ready", flush=True)
    go = sys.stdin.readline().split()
    t0, t1 = float(go[1]), float(go[2])
    records, results = [], {}
    lock = threading.Lock()

    def client(c: int) -> None:
        cl = ServeClient(args.url, timeout=600.0)
        j = 0
        nxt = ready[c]
        time.sleep(max(0.0, t0 - time.time()))
        while time.time() < t1:
            Y, psfs = nxt
            rec = {"c": c, "j": j, "n": int(Y.shape[0]),
                   "t_submit": time.time()}
            a = time.perf_counter()
            try:
                rid = cl.submit("deconvolve", [Y.numpy(), psfs.numpy()],
                                cfg=s_cfg, options=s_opts)
                out = cl.result(rid, include_x=True, timeout=600.0)
                rec.update(latency_s=time.perf_counter() - a,
                           t_done=time.time(), ok=out["status"] == "done",
                           error=out.get("error"),
                           inservice_s=out.get("latency_s"),
                           batch_size=out.get("batch_size"),
                           costs=out.get("costs"))
                x = out.get("x")
            except Exception as e:              # noqa: BLE001 (reported)
                rec.update(latency_s=time.perf_counter() - a,
                           t_done=time.time(), ok=False, error=repr(e))
                x = None
            with lock:
                records.append(rec)
                if x is not None:
                    results[(c, j)] = x
            j += 1
            nxt = request_inputs(args.cell, args.seed, params, cfg, c, j)

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in args.clients]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for rec in records:
        print(json.dumps(rec))
    print("done", flush=True)
    for line in sys.stdin:
        words = line.split()
        if not words or words[0] == "exit":
            break
        for key in words[1:]:
            c, j = (int(v) for v in key.split(":"))
            x = results.get((c, j))
            print(json.dumps({"key": key, "x": None if x is None
                              else codec.encode_array(x)}))
        print("sent", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
