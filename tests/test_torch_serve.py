"""``repro_torch.serve``: batched solves as a service, against the JAX
package.

The scenarios of ``tests/test_serve.py`` on the port, on the CPU (the
service's ``device="cpu"``), each on tiny deconvolution instances that
carry the JAX package's random draws as a trailing dict of their inputs:

- a served request reproduces the port's direct ``solve`` and the JAX
  package's ``solve`` of the same instance (rtol 1e-4), solo and
  coalesced into a mixed-shape batch;
- admission control (queue full, draining: retriable; malformed: not),
  cancel queued and in flight, graceful drain, the progress stream;
- resilience: the chaos pass-through, quarantine of a poisoned lane,
  deadlines frozen at a chunk boundary, the breaker, the watchdog,
  journal replay after a crash, the WAL's torn tail;
- the HTTP transport and client (inputs and iterates as lossless array
  records), and the three drills of ``repro_torch.serve.drill``.

Every wait is bounded (``asyncio.wait_for``, request timeouts, the HTTP
server closed by its context manager), so a hang fails one test.
"""
import asyncio
import tempfile
import threading

import jax
import numpy as np
import pytest
import torch

from repro.core.problem import solve as jsolve
from repro_torch.core.problem import solve
from repro_torch.resilience.recovery import ResilienceConfig
from repro_torch.serve import (AsyncSolveService, RequestRejected,
                               ServeConfig, SolveRequest, codec)

torch.set_num_threads(2)

ITERS, CHUNK = 6, 2
RTOL = 1e-4
LIMIT = 120.0          # seconds any one scenario may take
OPTIONS = dict(chunk=CHUNK, cost_every=1)


@pytest.fixture(scope="module")
def instances():
    """tests/test_serve.py's instances, each ``(Y, psfs, draws)``."""
    from repro.imaging import psf as jpsf
    out = []
    for (n, S, seed) in [(3, 16, 0), (5, 16, 1), (3, 20, 2), (4, 20, 3)]:
        d = jpsf.simulate(n, jax.random.PRNGKey(seed), stamp=S)
        P = np.asarray(d.psfs)
        ku, kv = jax.random.split(jax.random.PRNGKey(0))
        draws = dict(
            u0=np.asarray(jax.random.normal(ku, P.shape)),
            v0=np.asarray(jax.random.normal(kv, P.shape)),
            x0=np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                            (S, S))),
            noise=np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                               (8, 41, 41))))
        out.append((np.asarray(d.Y), P, draws))
    return out


def _cfg(**kw):
    from repro_torch.imaging.condat import SolverConfig
    base = dict(mode="sparse", max_iter=ITERS, tol=0.0, n_scales=2)
    base.update(kw)
    return SolverConfig(**base)


def _req(inputs, **kw):
    kw.setdefault("options", dict(OPTIONS))
    return SolveRequest("deconvolve", inputs, cfg=_cfg(), **kw)


def _service(cfg=None):
    return AsyncSolveService(cfg or ServeConfig(), device="cpu")


def _run(scenario):
    """One async scenario under its own loop, bounded."""
    async def bounded():
        return await asyncio.wait_for(scenario(), LIMIT)
    return asyncio.run(bounded())


def _direct(inputs, **kw):
    opts = dict(OPTIONS)
    opts.update(kw)
    return solve("deconvolve", *inputs, cfg=_cfg(), device="cpu", **opts)


_JAX = {}


def _jax_direct(inputs, max_iter=ITERS):
    """The JAX package's solve of the same instance (cached)."""
    from repro.imaging.condat import SolverConfig as JConfig
    key = (id(inputs[0]), max_iter)
    if key not in _JAX:
        _JAX[key] = jsolve("deconvolve", inputs[0], inputs[1],
                           cfg=JConfig(mode="sparse", max_iter=max_iter,
                                       tol=0.0, n_scales=2), **OPTIONS)
    return _JAX[key]


def _assert_parity(rec, inputs, max_iter=ITERS):
    """A served record against the port's direct solve and the JAX
    package's, costs and iterate at rtol 1e-4 (iterate atol 1e-6)."""
    assert rec.status == "done", (rec.status, rec.error)
    got = rec.solution
    for ref in (_direct(inputs, max_iter=max_iter),
                _jax_direct(inputs, max_iter)):
        np.testing.assert_allclose(np.asarray(got.log.costs),
                                   np.asarray(ref.log.costs), rtol=RTOL)
        np.testing.assert_allclose(np.asarray(got.x), np.asarray(ref.x),
                                   rtol=RTOL, atol=1e-6)


# ==================================================================
# Core service: parity, coalescing, admission, cancel, drain
# ==================================================================

def test_single_submit_parity(instances):
    async def run():
        async with _service() as svc:
            rec = await svc.submit(_req(instances[0]))
            return await svc.result(rec.id, timeout=LIMIT)

    rec = _run(run)
    _assert_parity(rec, instances[0])
    assert rec.batch_size == 1
    assert rec.latency_s is not None and rec.latency_s > 0
    assert len(rec.events) == ITERS // CHUNK
    assert rec.events[-1]["done"] == ITERS
    # a solo dispatch is the direct solve, bit for bit
    direct = _direct(instances[0])
    assert rec.solution.log.costs == direct.log.costs
    np.testing.assert_array_equal(rec.solution.x, direct.x)


def test_mixed_shape_coalescing_parity(instances):
    async def run():
        cfg = ServeConfig(batch_window_s=1.0, max_batch=8)
        async with _service(cfg) as svc:
            recs = [await svc.submit(_req(i)) for i in instances]
            return [await svc.result(r.id, timeout=LIMIT) for r in recs]

    recs = _run(run)
    for rec, inst in zip(recs, instances):
        _assert_parity(rec, inst)
    # two stamp shapes -> two buckets of two
    assert [r.batch_size for r in recs] == [2, 2, 2, 2]
    assert len({r.bucket_key for r in recs}) == 2
    assert recs[0].bucket_key == recs[1].bucket_key
    assert recs[2].bucket_key == recs[3].bucket_key


def test_run_control_in_the_config_splits_lanes(instances):
    """Requests that differ only in the config's ``max_iter`` never share
    a dispatch (the bucket would run one of them for both)."""
    async def run():
        cfg = ServeConfig(batch_window_s=0.3, max_batch=8)
        async with _service(cfg) as svc:
            a = await svc.submit(_req(instances[0]))
            b = await svc.submit(SolveRequest(
                "deconvolve", instances[1], cfg=_cfg(max_iter=2 * ITERS),
                options=dict(OPTIONS)))
            return [await svc.result(r.id, timeout=LIMIT) for r in (a, b)]

    a, b = _run(run)
    assert a.bucket_key != b.bucket_key
    assert a.solution.log.iters_run == ITERS
    assert b.solution.log.iters_run == 2 * ITERS


def test_queue_full_rejects_retriable(instances):
    async def run():
        cfg = ServeConfig(max_queue=1, batch_window_s=30.0, max_batch=8)
        async with _service(cfg) as svc:
            first = await svc.submit(_req(instances[0]))
            with pytest.raises(RequestRejected) as ei:
                await svc.submit(_req(instances[1]))
            assert ei.value.retriable
            assert ei.value.record.status == "rejected"
            assert await svc.cancel(first.id)
            assert svc.record(ei.value.record.id).retriable

    _run(run)


def test_malformed_request_rejects_non_retriable(instances):
    async def run():
        async with _service() as svc:
            with pytest.raises(RequestRejected) as ei:
                await svc.submit(SolveRequest("nonesuch", instances[0]))
            assert not ei.value.retriable

    _run(run)


def test_service_without_cuda_refuses():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AsyncSolveService(ServeConfig())


def test_cancel_queued_not_running(instances):
    async def run():
        cfg = ServeConfig(batch_window_s=30.0, max_batch=8)
        async with _service(cfg) as svc:
            a = await svc.submit(_req(instances[0]))
            b = await svc.submit(_req(instances[1]))
            assert await svc.cancel(a.id)
            assert a.status == "cancelled"
            assert not await svc.cancel(a.id)      # already terminal
            assert await svc.cancel(b.id)
            assert svc.metrics.queue_depth == 0
            assert svc.metrics.counter("cancelled") == 2

    _run(run)


def test_graceful_drain(instances):
    async def run():
        cfg = ServeConfig(batch_window_s=30.0, max_batch=2)
        async with _service(cfg) as svc:
            a = await svc.submit(_req(instances[0]))
            b = await svc.submit(_req(instances[1]))
            c = await svc.submit(_req(instances[2]))
            assert c.status == "queued"
            summary = await svc.drain()
            assert summary["rejected_queued"] == 1
            assert c.status == "rejected" and c.retriable
            assert "drained" in c.error
            assert a.status == "done" and b.status == "done"
            with pytest.raises(RequestRejected) as ei:
                await svc.submit(_req(instances[3]))
            assert ei.value.retriable
            return a, b

    a, b = _run(run)
    _assert_parity(a, instances[0])
    _assert_parity(b, instances[1])


def test_progress_long_poll_stream(instances):
    async def run():
        async with _service() as svc:
            rec = await svc.submit(_req(instances[0]))
            events, cursor, terminal = [], 0, False
            while not terminal:
                chunk, terminal, cursor = await svc.wait_events(
                    rec.id, cursor, timeout=0.2)
                events.extend(chunk)
            return rec, events

    rec, events = _run(run)
    assert rec.status == "done"
    assert [e["done"] for e in events] == \
        list(range(CHUNK, ITERS + 1, CHUNK))
    assert all(np.isfinite(e["cost"]) for e in events)


# ==================================================================
# Resilience in the serving path
# ==================================================================

def test_chaos_resilience_pass_through(instances):
    """A chaos-armed request dispatches solo and its ``resilience=``
    rides through to the supervisor: the dispatch fault is retried and
    the trajectory still matches."""
    async def run():
        cfg = ServeConfig(batch_window_s=5.0, max_batch=8)
        async with _service(cfg) as svc:
            opts = dict(OPTIONS)
            opts["resilience"] = ResilienceConfig(max_retries=2,
                                                  backoff_s=0.0)
            rec = await svc.submit(_req(instances[0], options=opts,
                                        chaos_spec="dispatch@2"))
            return await svc.result(rec.id, timeout=LIMIT)

    rec = _run(run)
    assert rec.batch_size == 1          # chaos never shares a dispatch
    _assert_parity(rec, instances[0])
    assert rec.solution.recovery.retries == 1
    assert rec.solution.recovery.faults[0]["point"] == "dispatch"
    assert rec.solution.recovery.kernel_fallbacks == []


def test_batch_failure_marks_all_failed(instances):
    async def run():
        async with _service() as svc:
            rec = await svc.submit(_req(instances[0],
                                        chaos_spec="dispatch@0"))
            got = await svc.result(rec.id, timeout=LIMIT)
            assert got.status == "failed"
            assert "InjectedFault" in got.error
            assert svc.metrics.counter("failed") == 1
            ok = await svc.submit(_req(instances[0]))
            done = await svc.result(ok.id, timeout=LIMIT)
            assert done.status == "done"

    _run(run)


def test_quarantine_isolates_poisoned_lane(instances):
    res = ResilienceConfig(max_rollbacks=2, backoff_s=0.001, ring=2)

    async def run():
        cfg = ServeConfig(batch_window_s=0.3, max_batch=8,
                          chaos_spec="serve_bucket_poison@0;seed=7")
        async with _service(cfg) as svc:
            opts = dict(OPTIONS)
            opts["resilience"] = res
            a = await svc.submit(_req(instances[0], options=dict(opts)))
            b = await svc.submit(_req(instances[1], options=dict(opts)))
            got = [await svc.result(r.id, timeout=LIMIT) for r in (a, b)]
            assert svc.metrics.counter("quarantined") == 1
            return got

    out = _run(run)
    assert {r.bucket_key for r in out} == {out[0].bucket_key}
    assert out[0].batch_size == 2
    failed = [r for r in out if r.status == "failed"]
    assert len(failed) == 1
    assert failed[0].quarantined
    assert failed[0].recovery is not None
    assert failed[0].recovery.rollbacks >= 1
    assert "recovery" in [e.get("kind") for e in failed[0].events]
    sibling = next(r for r in out if r.status == "done")
    assert sibling.quarantined
    _assert_parity(sibling, instances[out.index(sibling)])


def test_deadline_expires_at_chunk_boundary(instances):
    """A running request past ``deadline_s`` freezes at the next chunk
    boundary and fails with the deadline error (its budget is far beyond
    what the deadline covers)."""
    async def run():
        async with _service(ServeConfig(batch_window_s=0.05,
                                        max_batch=8)) as svc:
            opts = dict(OPTIONS)
            opts["max_iter"] = 1_000_000
            rec = await svc.submit(_req(instances[0], options=opts,
                                        deadline_s=0.5))
            got = await svc.result(rec.id, timeout=LIMIT)
            assert svc.metrics.counter("expired") == 1
            return got

    got = _run(run)
    assert got.status == "failed" and "deadline" in got.error
    chunks = [e for e in got.events if e.get("kind") == "chunk"]
    assert 0 < max(e["done"] for e in chunks) < 1_000_000


def test_cancel_while_dispatched_freezes_lane(instances):
    async def run():
        cfg = ServeConfig(batch_window_s=0.2, max_batch=8)
        async with _service(cfg) as svc:
            opts = dict(OPTIONS)
            opts["max_iter"] = 400
            a = await svc.submit(_req(instances[0], options=dict(opts)))
            b = await svc.submit(_req(instances[1], options=dict(opts)))
            events, done, _ = await svc.wait_events(a.id, 0, timeout=60)
            assert events and not done
            assert await svc.cancel(a.id)
            assert not await svc.cancel(a.id)
            got_a = await svc.result(a.id, timeout=LIMIT)
            got_b = await svc.result(b.id, timeout=LIMIT)
            assert svc.metrics.counter("cancelled") == 1
            return got_a, got_b

    got_a, got_b = _run(run)
    assert got_a.status == "cancelled"
    assert "chunk boundary" in got_a.error
    assert got_a.solution.log.cancelled_at is not None
    _assert_parity(got_b, instances[1], max_iter=400)


def test_drain_while_dispatched(instances):
    async def run():
        cfg = ServeConfig(batch_window_s=0.1, max_batch=8)
        async with _service(cfg) as svc:
            a = await svc.submit(_req(instances[0]))
            b = await svc.submit(_req(instances[1]))
            events, done, _ = await svc.wait_events(a.id, 0, timeout=60)
            assert events or done
            await svc.drain()
            return (await svc.result(a.id, timeout=LIMIT),
                    await svc.result(b.id, timeout=LIMIT))

    got_a, got_b = _run(run)
    _assert_parity(got_a, instances[0])
    _assert_parity(got_b, instances[1])


def test_breaker_trips_sheds_and_recovers(instances):
    async def run():
        cfg = ServeConfig(batch_window_s=0.0, max_batch=1,
                          breaker_min_samples=2, breaker_window=4,
                          breaker_error_threshold=0.5,
                          breaker_cooldown_s=0.3)
        async with _service(cfg) as svc:
            for _ in range(2):
                rec = await svc.submit(_req(instances[0],
                                            chaos_spec="dispatch@0"))
                got = await svc.result(rec.id, timeout=LIMIT)
                assert got.status == "failed"
            assert svc.breaker_states()["deconvolve"]["state"] == "open"
            ok, detail = svc.ready()
            assert not ok and detail["open_breakers"] == ["deconvolve"]
            with pytest.raises(RequestRejected) as ei:
                await svc.submit(_req(instances[0]))
            assert ei.value.retriable
            assert svc.metrics.counter("shed") == 1
            await asyncio.sleep(0.35)    # cooldown -> half-open probe
            rec = await svc.submit(_req(instances[0]))
            got = await svc.result(rec.id, timeout=LIMIT)
            assert got.status == "done"
            assert svc.breaker_states()["deconvolve"]["state"] == "closed"
            assert svc.ready()[0]

    _run(run)


def test_watchdog_reaps_hung_dispatch(instances):
    async def run():
        cfg = ServeConfig(batch_window_s=0.0, max_batch=1,
                          dispatch_timeout_s=0.4)
        async with _service(cfg) as svc:
            opts = dict(OPTIONS)
            opts["max_iter"] = 1_000_000     # far beyond the timeout
            rec = await svc.submit(_req(instances[0], options=opts))
            got = await svc.result(rec.id, timeout=LIMIT)
            assert svc.metrics.counter("hung") == 1
            return got

    got = _run(run)
    assert got.status == "failed"
    assert "hung dispatch" in got.error


def test_journal_replay_recovers_dropped_request(instances):
    journal_dir = tempfile.mkdtemp(prefix="serve-journal-")

    async def phase1():
        cfg = ServeConfig(batch_window_s=0.05, max_batch=8,
                          journal_dir=journal_dir,
                          chaos_spec="serve_admit_drop@0")
        svc = _service(cfg)
        await svc.start()
        rec = await svc.submit(_req(instances[0]))
        assert rec.status == "queued"    # journaled, never scheduled
        await svc.abandon()
        return rec.id

    rid = _run(phase1)

    async def phase2():
        cfg = ServeConfig(batch_window_s=0.05, max_batch=8,
                          journal_dir=journal_dir)
        async with _service(cfg) as svc:
            got = await svc.result(rid, timeout=LIMIT)
            assert svc.metrics.counter("replayed") == 1
            return got

    got = _run(phase2)
    assert got.replayed
    _assert_parity(got, instances[0])
    # the journal carried the draws dict through
    assert isinstance(got.request.inputs[2], dict)


def test_wal_skips_torn_tail(tmp_path):
    from repro_torch.checkpoint.wal import WriteAheadLog
    path = tmp_path / "j.wal"
    with WriteAheadLog(path) as wal:
        wal.append({"kind": "admit", "id": "a"})
        wal.append({"kind": "done", "id": "a", "status": "done"})
    with open(path, "ab") as f:
        f.write(b"deadbeef {torn")      # a crash mid-append
    records, skipped = WriteAheadLog.read(path)
    assert [r["kind"] for r in records] == ["admit", "done"]
    assert skipped == 1


def test_poison_inputs_is_out_of_place():
    from repro_torch.serve.service import _poison_inputs
    t = torch.ones(2, 3, 3).transpose(1, 2)
    a = np.ones((2, 2), np.float32)
    out = _poison_inputs((t, a, {"u0": a}))
    assert torch.isnan(out[0]).sum() == 1 and not torch.isnan(t).any()
    assert out[1] is a
    out = _poison_inputs((np.arange(3), a))
    assert np.isnan(out[1]).sum() == 1 and not np.isnan(a).any()


# ==================================================================
# Codecs
# ==================================================================

@pytest.mark.parametrize("value", [
    np.arange(12, dtype=np.float32).reshape(3, 4) / 7,
    np.arange(5, dtype=np.int64),
    torch.randn(2, 3, generator=torch.Generator().manual_seed(0)),
    torch.randn(4, generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16),
    torch.randn(3, 5, generator=torch.Generator().manual_seed(2)).t()],
    ids=["numpy-f32", "numpy-i64", "tensor-f32", "tensor-bf16",
         "tensor-strided"])
def test_array_codec_is_lossless(value):
    back = codec.decode_array(codec.encode_array(value))
    want = value if isinstance(value, np.ndarray) else value.contiguous()
    if isinstance(back, torch.Tensor):         # bf16 comes back a tensor
        assert back.dtype == torch.bfloat16
        assert torch.equal(back, want)
        return
    want = want.numpy() if isinstance(want, torch.Tensor) else want
    assert back.dtype == want.dtype
    np.testing.assert_array_equal(back, want)
    t = codec.decode_array(codec.encode_array(value), as_tensor=True)
    assert isinstance(t, torch.Tensor)


def test_inputs_and_configs_round_trip(instances):
    Y, P, draws = instances[0]
    enc = [codec.encode_input(x) for x in instances[0]]
    dec = codec.decode_inputs(enc)
    np.testing.assert_array_equal(dec[0], Y)
    np.testing.assert_array_equal(dec[1], P)
    assert sorted(dec[2]) == sorted(draws)
    for k, v in draws.items():
        np.testing.assert_array_equal(dec[2][k], v)
    # the JAX package's wire forms still decode
    lists = codec.decode_inputs([Y.tolist(), {"data": [1, 2],
                                              "dtype": "int32"}])
    np.testing.assert_array_equal(lists[0], Y)
    assert lists[1].dtype == np.int32
    from repro_torch.imaging.condat import SolverConfig
    from repro_torch.imaging.lowrank import CompletionConfig
    from repro_torch.imaging.scdl import SCDLConfig
    for problem, cfg in (("deconvolve", _cfg()),
                         ("scdl", SCDLConfig(n_atoms=8)),
                         ("lowrank", CompletionConfig(rank=3))):
        assert codec.decode_config(problem, codec.encode_config(cfg)) \
            == cfg
    assert isinstance(codec.decode_config("deconvolve", {}), SolverConfig)
    opts = {"chunk": 2, "resilience": ResilienceConfig(
        max_retries=1, rollback_rescale=lambda r, n: r)}
    back = codec.decode_options(codec.encode_options(opts))
    assert back["chunk"] == 2
    assert back["resilience"] == ResilienceConfig(max_retries=1)


# ==================================================================
# HTTP transport round trip
# ==================================================================

def test_http_roundtrip(instances):
    from repro_torch.serve.client import ServeClient, ServeError
    from repro_torch.serve.server import serve_http
    Y, P, draws = instances[0]
    cfg_dict = dict(mode="sparse", max_iter=ITERS, tol=0.0, n_scales=2)

    with serve_http(ServeConfig(batch_window_s=0.2, max_batch=8),
                    device="cpu") as h:
        c = ServeClient(h.url, timeout=LIMIT)
        assert c.health()["ok"]
        rid = c.submit("deconvolve", (Y, P, draws), cfg=cfg_dict,
                       options=dict(OPTIONS))
        events = list(c.events(rid))
        assert events[-1]["kind"] == "end"
        assert events[-1]["status"] == "done"
        chunks = [e for e in events if e.get("kind") == "chunk"]
        assert [e["done"] for e in chunks] == \
            list(range(CHUNK, ITERS + 1, CHUNK))
        res = c.result(rid, include_x=True, timeout=LIMIT)
        assert res["status"] == "done"
        assert res["iters_run"] == ITERS
        for ref in (_direct(instances[0]), _jax_direct(instances[0])):
            np.testing.assert_allclose(res["costs"],
                                       np.asarray(ref.log.costs),
                                       rtol=RTOL)
            np.testing.assert_allclose(res["x"], np.asarray(ref.x),
                                       rtol=RTOL, atol=1e-6)
        assert isinstance(res["x"], np.ndarray)
        assert set(res["time_percentiles_s"]) == {"p50", "p90", "p99"}
        as_t = c.result(rid, include_x=True, as_tensors=True,
                        timeout=LIMIT)
        assert torch.equal(as_t["x"], torch.from_numpy(res["x"]))

        st = c.status(rid)
        assert st["status"] == "done" and st["batch_size"] == 1

        with pytest.raises(ServeError) as ei:
            c.status("deadbeef")
        assert ei.value.status == 404
        with pytest.raises(ServeError) as ei:
            c.submit("nonesuch", (Y,))
        assert ei.value.status == 400 and not ei.value.retriable
        assert c.cancel(rid) is False          # already terminal

        m = c.metrics()
        assert m["counters"]["completed"] == 1
        assert m["counters"]["rejected"] == 1

        c.drain()
        with pytest.raises(ServeError) as ei:
            c.submit("deconvolve", (Y, P, draws), cfg=cfg_dict)
        assert ei.value.status == 503 and ei.value.retriable


def test_http_resilient_chaos_request(instances):
    from repro_torch.serve.client import ServeClient
    from repro_torch.serve.server import serve_http
    with serve_http(device="cpu") as h:
        c = ServeClient(h.url, timeout=LIMIT)
        rid = c.submit(
            "deconvolve", instances[0],
            cfg=dict(mode="sparse", max_iter=ITERS, tol=0.0, n_scales=2),
            options=dict(chunk=CHUNK, cost_every=1,
                         resilience=dict(max_retries=2, backoff_s=0.0)),
            chaos="dispatch@2")
        res = c.result(rid, timeout=LIMIT)
        assert res["status"] == "done"
        assert res["recovery"]["retries"] == 1
        assert res["recovery"]["kernel_fallbacks"] == []


def test_http_coalesces_concurrent_requests(instances):
    """Concurrent HTTP submits of one shape coalesce into one bucket, one
    ``solve_many`` dispatch, each result its direct solve's."""
    from repro_torch.serve.client import ServeClient
    from repro_torch.serve.server import serve_http
    cfg_dict = dict(mode="sparse", max_iter=ITERS, tol=0.0, n_scales=2)
    with serve_http(ServeConfig(batch_window_s=1.0, max_batch=2),
                    device="cpu") as h:
        c = ServeClient(h.url, timeout=LIMIT)
        ids = [None, None]

        def send(j):
            ids[j] = c.submit("deconvolve", instances[j], cfg=cfg_dict,
                              options=dict(OPTIONS))

        threads = [threading.Thread(target=send, args=(j,))
                   for j in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(LIMIT)
        results = [c.result(rid, include_x=True, timeout=LIMIT)
                   for rid in ids]
        m = c.metrics()
    assert m["batch_occupancy"]["batches"] == 1
    assert {r["bucket_key"] for r in results} == {results[0]["bucket_key"]}
    for res, inst in zip(results, instances[:2]):
        ref = _direct(inst)
        assert res["batch_size"] == 2 and res["iters_run"] == ITERS
        np.testing.assert_allclose(res["costs"], ref.log.costs, rtol=RTOL)
        np.testing.assert_allclose(res["x"], ref.x, rtol=RTOL, atol=1e-6)


# ==================================================================
# The drills, at their own sizes
# ==================================================================

@pytest.mark.parametrize("scenario", ["poison-bucket", "deadline-storm",
                                      "kill-and-restart"])
def test_drill_scenario(scenario, tmp_path):
    from repro_torch.serve import drill
    kw = {"workdir": str(tmp_path)} if scenario == "kill-and-restart" \
        else {}
    detail = drill.SCENARIOS[scenario](device="cpu", **kw)
    assert detail["counters"]["completed"] >= 1


def test_drill_cli(tmp_path, capsys):
    from repro_torch.serve import drill
    report = tmp_path / "drill.json"
    assert drill.main(["--scenario", "poison-bucket", "--device", "cpu",
                       "--report", str(report)]) == 0
    assert "poison-bucket: ok" in capsys.readouterr().out
    assert report.exists()
