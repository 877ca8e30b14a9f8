"""Faults planted under the timed path: the CPU tests see ``correct``
come out false with each, and ``control.py --faults`` reads each at a
cell's own size on the chip.  Each is a wrapper of a hook of the port,
patched in this process only."""
import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def patched(monkeypatch, target, name, make):
    orig = getattr(target, name)
    monkeypatch.setattr(target, name, make(orig))
    yield


@contextlib.contextmanager
def planted(target, name, make):
    """The same without pytest: restores the hook on exit."""
    orig = getattr(target, name)
    setattr(target, name, make(orig))
    try:
        yield
    finally:
        setattr(target, name, orig)


def scdl_faults():
    """``(name, target, hook, wrapper)`` of each fault a dictionary
    training can have on one card."""
    import repro_torch.imaging.scdl as scdl_mod
    return [("state_unchanged", scdl_mod.SCDLProblem, "light_step",
             scdl_unchanged),
            ("half_batch", scdl_mod, "_outer_products", scdl_half_batch),
            ("answer_altered", scdl_mod.SCDLProblem, "finalize",
             scdl_altered)]


def deconv_unchanged(orig):
    """A step that returns its state unchanged."""
    return lambda self, d, rep, axes: d


def deconv_half_batch(orig):
    """Half of the stamps left out: their state stays as it was."""
    def step(self, d, rep, axes):
        new = dict(orig(self, d, rep, axes))
        n = d["Xp"].shape[-3]
        h = n // 2
        for k, v in new.items():
            if not isinstance(v, torch.Tensor) or v.dim() < 3 or \
                    v.shape[-3] != n or k in ("Y", "psf_fp", "W"):
                continue
            new[k] = torch.cat([v[..., :h, :, :], d[k][..., h:, :, :]],
                               dim=-3)
        return new
    return step


def deconv_altered(orig):
    """One stamp of the answer altered where it is produced."""
    def finalize(self, bundle, log):
        x, aux = orig(self, bundle, log)
        x = np.array(x, copy=True)
        x[0] *= 1.01
        return x, aux
    return finalize


def scdl_unchanged(orig):
    return lambda self, d, rep, axes: (d, {"Xh": rep["Xh"], "Xl": rep["Xl"]})


def scdl_half_batch(orig):
    """The outer products over half of the samples, doubled (the mean
    taken over the rest)."""
    def outer(d, axes):
        K = d["Sh"].shape[-2]
        half = {k: (v[..., : K // 2, :] if k in ("Sh", "Sl", "Wh", "Wl")
                    else v) for k, v in d.items()}
        return {k: 2.0 * v for k, v in orig(half, axes).items()}
    return outer


def scdl_altered(orig):
    """The returned high-resolution dictionary's pixels shifted by one."""
    def finalize(self, bundle, log):
        (Xh, Xl), aux = orig(self, bundle, log)
        return (np.roll(Xh, 1, axis=0), Xl), aux
    return finalize
