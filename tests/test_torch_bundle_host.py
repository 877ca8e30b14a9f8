"""The copy back of ``core.bundle.gather_leaf``: results from the card
in pooled page-locked host buffers.

On the CPU, the pool's bookkeeping with the registration swapped for a
plain allocation (``_pin``/``_unpin``): a buffer is taken again once the
array and every view of it are gone, and not while one lives; free
buffers go least recently returned first; past the cap the copy goes to
pageable memory and the bytes held never cross it; the counts of
``PINNED_RESULTS``; concurrent callers; a CPU leaf still comes back as
``.numpy()`` of the bundle's own tensor.

On the card (marker ``card``; skipped without CUDA): both deconvolution
modes at 10 000 stamps of 41 x 41 return the iterate bit for bit in
page-locked memory, a dropped result's buffer serves the next solve, a
result still held is never written by later ones, and 20 kept results
hold at most the cap.  On the card, without the repository's conftest
(it imports JAX, which that machine lacks):

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_bundle_host.py
"""
import gc
import random
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import bundle as bundle_mod
from repro_torch.core.bundle import Bundle, gather_leaf
from repro_torch.core.problem import solve
from repro_torch.imaging import psf
from repro_torch.imaging.condat import SolverConfig


@pytest.fixture
def pool(monkeypatch):
    """A fresh pool whose buffers are plain host arrays, zeroed counts,
    and the lists of buffers made and released."""
    made, unpinned = [], []

    def pin(nbytes):
        made.append(np.empty(nbytes, np.uint8))
        return made[-1]

    p = bundle_mod._PinnedPool()
    monkeypatch.setattr(bundle_mod, "_pinned_pool", p)
    monkeypatch.setattr(bundle_mod, "_pin", pin)
    monkeypatch.setattr(bundle_mod, "_unpin", unpinned.append)
    for k in bundle_mod.PINNED_RESULTS:
        monkeypatch.setitem(bundle_mod.PINNED_RESULTS, k, 0)
    p.made, p.unpinned = made, unpinned
    return p


def _counts():
    r = bundle_mod.PINNED_RESULTS
    return r["reused"], r["allocated"], r["pageable"]


def _leaf(n, fill, dtype=torch.float32):
    return torch.full((n, 3, 3), fill, dtype=dtype)


def _in_pool(a, p):
    """The pooled buffer that ``a`` lies in, or None."""
    for buf in p.made:
        if np.shares_memory(a, buf):
            return buf
    return None


def _free_bytes(p):
    return sum(b.nbytes for b in [*p.free, *p.returned])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.int64, torch.complex64, torch.bool,
                                   torch.uint8])
@pytest.mark.parametrize("shape", [(), (7,), (4, 5, 6), (2, 1, 3, 3)])
def test_result_is_a_c_ordered_writeable_bit_copy(pool, dtype, shape):
    values = np.arange(int(np.prod(shape))) * 1.37 - 4
    x = torch.from_numpy(values.reshape(shape)).to(dtype)
    a = pool.copy(x)
    want = x.numpy().copy()
    assert a.shape == want.shape and a.dtype == want.dtype
    assert a.flags.c_contiguous and a.flags.writeable
    assert a.tobytes() == want.tobytes()
    assert _in_pool(a, pool) is not None
    a[...] = 1
    assert x.numpy().tobytes() == want.tobytes()


def test_non_contiguous_leaf_comes_back_c_ordered(pool):
    x = torch.arange(60, dtype=torch.float32).reshape(3, 4, 5)
    t = x.transpose(0, 2)
    a = pool.copy(t)
    assert a.flags.c_contiguous
    assert np.array_equal(a, t.contiguous().numpy())


def test_buffer_is_reused_after_the_array_is_dropped(pool):
    a = pool.copy(_leaf(10, 1.0))
    buf = _in_pool(a, pool)
    del a
    b = pool.copy(_leaf(10, 2.0))
    assert _in_pool(b, pool) is buf and len(pool.made) == 1
    assert np.all(b == 2.0)
    assert _counts() == (1, 1, 0)


def test_buffer_in_a_reference_cycle_returns_when_collected(pool):
    a = pool.copy(_leaf(10, 1.0))
    buf = _in_pool(a, pool)
    cycle = [a]
    cycle.append(cycle)
    del a, cycle
    gc.collect()
    b = pool.copy(_leaf(10, 3.0))
    assert _in_pool(b, pool) is buf and len(pool.made) == 1


_VIEWS = {
    "numpy slice": lambda a: a[1:],
    "view of a view": lambda a: a[1:][::2].T,
    "reshape": lambda a: a.reshape(-1),
    "torch.from_numpy": torch.from_numpy,
    "torch view of the base": lambda a: a.base[1:],
    "torch view of from_numpy": lambda a: torch.from_numpy(a).view(-1)[3:],
    "memoryview": memoryview,
    "dtype view": lambda a: a.view(np.int32),
}


@pytest.mark.parametrize("name", sorted(_VIEWS))
def test_buffer_is_not_reused_while_a_view_lives(pool, name):
    a = pool.copy(_leaf(10, 1.0))
    buf = _in_pool(a, pool)
    kept = _VIEWS[name](a)
    del a
    gc.collect()
    b = pool.copy(_leaf(10, 2.0))
    assert _in_pool(b, pool) is not buf
    assert np.all(buf.view(np.float32) == 1.0)
    assert _counts() == (0, 2, 0)
    del kept
    c = pool.copy(_leaf(10, 3.0))
    assert _in_pool(c, pool) is buf
    assert _counts() == (1, 2, 0)


def test_free_buffers_are_evicted_least_recently_returned_first(
        pool, monkeypatch):
    """Sizes of 1, 2 and 3 units (36 B each, fp32 3 x 3 stamps), room
    for 4: the third size evicts the buffer returned first, and only as
    many as make room."""
    unit = 9 * 4
    monkeypatch.setattr(bundle_mod, "_PINNED_CAP", 4 * unit)
    a, b = pool.copy(_leaf(1, 1.0)), pool.copy(_leaf(2, 2.0))
    buf_a, buf_b = _in_pool(a, pool), _in_pool(b, pool)
    del b, a                     # b returned first
    c = pool.copy(_leaf(3, 3.0))
    assert pool.unpinned == [buf_b]
    assert pool.held == 4 * unit
    assert _in_pool(c, pool) is not None
    d = pool.copy(_leaf(1, 4.0))
    assert _in_pool(d, pool) is buf_a
    assert _counts() == (1, 3, 0)


def test_pageable_copy_past_the_cap(pool, monkeypatch):
    unit = 9 * 4
    monkeypatch.setattr(bundle_mod, "_PINNED_CAP", 2 * 4 * unit)
    kept = [pool.copy(_leaf(4, float(i))) for i in range(3)]
    assert [_in_pool(a, pool) is not None for a in kept] == [True, True,
                                                            False]
    assert all(np.all(a == i) for i, a in enumerate(kept))
    assert pool.held == 2 * 4 * unit
    assert _counts() == (0, 2, 1)
    # a free buffer that could not make room for another size stays
    del kept[0]
    five = pool.copy(_leaf(5, 5.0))
    assert _in_pool(five, pool) is None and np.all(five == 5.0)
    assert pool.unpinned == [] and _counts() == (0, 2, 2)
    again = pool.copy(_leaf(4, 6.0))
    assert _in_pool(again, pool) is not None and np.all(again == 6.0)
    assert _counts() == (1, 2, 2)
    # nor for a result larger than the cap
    del again
    big = pool.copy(_leaf(20, 7.0))
    assert _in_pool(big, pool) is None and pool.unpinned == []
    assert _counts() == (1, 2, 3)


def test_bytes_held_never_cross_the_cap(pool, monkeypatch):
    """A random run of sizes, kept and dropped: every step holds at most
    the cap, and ``held`` is the bytes in callers' hands plus free."""
    cap = 40 * 9 * 4
    monkeypatch.setattr(bundle_mod, "_PINNED_CAP", cap)
    rng = random.Random(11)
    live = []
    for step in range(400):
        n = rng.choice([1, 2, 5, 8, 13])
        live.append(pool.copy(_leaf(n, float(step))))
        assert np.all(live[-1] == step)
        while live and rng.random() < 0.45:
            live.pop(rng.randrange(len(live)))
        in_hands = sum(x.nbytes for x in live
                       if _in_pool(x, pool) is not None)
        assert pool.held <= cap
        assert pool.held == in_hands + _free_bytes(pool)
    reused, allocated, pageable = _counts()
    assert reused + allocated + pageable == 400
    assert reused > 0 and allocated > 0 and pageable > 0


def test_counts_follow_the_results(pool, monkeypatch):
    monkeypatch.setattr(bundle_mod, "_PINNED_CAP", 2 * 10 * 9 * 4)
    a = pool.copy(_leaf(10, 1.0))
    b = pool.copy(_leaf(10, 2.0))
    assert _counts() == (0, 2, 0)
    c = pool.copy(_leaf(10, 3.0))
    assert _counts() == (0, 2, 1)
    del a, c
    pool.copy(_leaf(10, 4.0))
    assert _counts() == (1, 2, 1)
    pool.copy(_leaf(10, 5.0))                 # the first one, dropped
    assert _counts() == (2, 2, 1)
    del b


def test_concurrent_callers(pool, monkeypatch):
    """Twelve threads copy, check and drop results of three sizes under a
    cap of a few of them, with a short switch interval: every result is
    its own input, the bytes held stay under the cap, every call is
    counted once."""
    cap = 6 * 64 * 9 * 4
    monkeypatch.setattr(bundle_mod, "_PINNED_CAP", cap)
    errors, peaks = [], []
    calls = 60

    def work(seed):
        rng = random.Random(seed)
        keep = []
        try:
            for i in range(calls):
                fill = float(seed * 1000 + i)
                a = pool.copy(_leaf(rng.choice([16, 32, 64]), fill))
                if not np.all(a == fill):
                    errors.append((seed, i))
                keep.append(a)
                if len(keep) > 2:
                    keep.pop(0)
                peaks.append(pool.held)
        except Exception as e:          # noqa: BLE001 (reported below)
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(s,))
                   for s in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    assert max(peaks) <= cap
    assert sum(_counts()) == 12 * calls
    assert _counts()[0] > 0


def test_refused_registration_copies_to_pageable_memory(pool,
                                                       monkeypatch):
    monkeypatch.setattr(bundle_mod, "_pin", lambda nbytes: None)
    a = pool.copy(_leaf(10, 2.0))
    assert np.all(a == 2.0) and a.flags.writeable
    assert pool.held == 0 and _counts() == (0, 0, 1)


def test_cpu_leaf_comes_back_as_today_sharing_memory(pool):
    x = np.arange(2 * 3 * 5, dtype=np.float32).reshape(2, 3, 5)
    b = Bundle.create({"x": x, "y": x[:, :1]}, device="cpu")
    got = gather_leaf(b, "x")
    assert np.shares_memory(got, b.data["x"].numpy())
    assert got.ctypes.data == b.data["x"].data_ptr()
    assert np.array_equal(got, x)
    assert _counts() == (0, 0, 0) and pool.made == []


# -------------------------------------------------------------- card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pinned copy runs only there")
    return torch.device("cuda")


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


def _catalogue(n=10_000, seed=3):
    d = psf.simulate(n, torch.Generator().manual_seed(seed), stamp=41,
                     device="cuda")
    return d.Y, d.psfs


_MODES = {"sparse": SolverConfig(),
          "lowrank": SolverConfig(mode="lowrank", lam=0.05, rank=16)}


def _solve(mode, Y, P):
    return solve("deconvolve", Y, P, cfg=_MODES[mode], max_iter=4, chunk=4,
                 tol=0.0)


@pytest.mark.card
@pytest.mark.parametrize("mode", sorted(_MODES))
def test_card_result_is_the_iterate_in_pinned_memory(card, mode):
    Y, P = _catalogue()
    sol = _solve(mode, Y, P)
    want = sol.bundle.data["Xp"].cpu().numpy()
    assert sol.x.shape == (10_000, 41, 41) and sol.x.dtype == np.float32
    assert sol.x.flags.c_contiguous and sol.x.flags.writeable
    assert np.array_equal(_bits(sol.x), _bits(want))
    assert torch.from_numpy(sol.x).is_pinned()


@pytest.mark.card
def test_card_dropped_result_serves_the_next_solve(card):
    Y, P = _catalogue()
    first = _solve("sparse", Y, P).x
    ptr = first.ctypes.data
    del first
    reused = bundle_mod.PINNED_RESULTS["reused"]
    second = _solve("sparse", Y, P).x
    assert second.ctypes.data == ptr
    assert bundle_mod.PINNED_RESULTS["reused"] == reused + 1


@pytest.mark.card
def test_card_held_result_is_never_written_by_later_solves(card):
    Y, P = _catalogue()
    held = _solve("sparse", Y, P).x
    copy = held.copy()
    ptrs = {held.ctypes.data}
    for seed in (4, 5, 6):
        x = _solve("lowrank", *_catalogue(seed=seed)).x
        ptrs.add(x.ctypes.data)
        del x
    assert np.array_equal(_bits(held), _bits(copy))
    assert len(ptrs) == 2          # the held one, and one reused by the rest


@pytest.mark.card
def test_card_refused_registration_leaves_no_error_behind(card):
    """A second registration of one range is refused, and the refusal
    stays the runtime's last error until it is read: the next kernel
    launch would raise it."""
    cudart = torch.cuda.cudart()
    buf = np.empty(1 << 20, np.uint8)
    assert int(cudart.cudaHostRegister(buf.ctypes.data, buf.nbytes, 1)) == 0
    try:
        assert int(cudart.cudaHostRegister(buf.ctypes.data, buf.nbytes,
                                           1)) != 0
        bundle_mod._forget_cuda_error()
        assert (torch.ones(4, device=card) + 1).sum().item() == 8.0
    finally:
        cudart.cudaHostUnregister(buf.ctypes.data)


@pytest.mark.card
def test_card_kept_results_hold_at_most_the_cap(card):
    leaf = torch.empty((10_000, 41, 41), device=card)
    b = Bundle.create({"Xp": leaf}, device=card)
    size = leaf.numel() * 4
    pageable = bundle_mod.PINNED_RESULTS["pageable"]
    kept = []
    for i in range(20):
        b.data["Xp"].fill_(float(i))
        kept.append(gather_leaf(b, "Xp"))
        assert bundle_mod._pinned_pool.held <= bundle_mod._PINNED_CAP
    pinned = [torch.from_numpy(a).is_pinned() for a in kept]
    room = bundle_mod._PINNED_CAP // size
    assert pinned[:room] == [True] * room and not any(pinned[room:])
    assert bundle_mod.PINNED_RESULTS["pageable"] - pageable == 20 - room
    assert all(np.all(a == i) for i, a in enumerate(kept))
