"""Deterministic fault injection.  Port of ``repro.resilience.chaos``.

Every failure the supervised solve loop recovers from can be injected
deterministically, so the recovery path is a unit test.

Fault points (each injector is a no-op unless chaos is active, so a
probe costs one module-global ``is None`` check on the hot path):

==================  ==================================================
``dispatch``        raise in the driver's chunk dispatch, before the
                    chunk's work is enqueued — a lost worker or a
                    failed launch, classified transient
``carry_nan``       poison one float leaf of the data carry with NaN
                    after a chunk is enqueued — divergence
``ckpt_write``      raise at the top of a checkpoint ``save()`` — a
                    failed write (surfaced at the writer's next sync)
``ckpt_corrupt``    truncate a leaf file of a checkpoint *after* the
                    manifest's checksums are computed — a torn write
                    that survives the atomic rename
``kernel``          raise in a kernel wrapper before its launch (also
                    per family, ``kernel:<family>``, the families of
                    the JAX package: ``starlet2d``, ``condat_elwise``,
                    ``admm_elwise``, ``dict_outer``, and the port's own
                    ``jacobi``).  The JAX package degrades the family
                    to a slower route; the port has none, so the fault
                    is a transient error: under supervision the chunk is
                    retried on the same kernel, without it the run dies
``serve_*``         serving-layer faults consumed by ``repro_torch.serve``
                    (a dropped admission, a poisoned bucket lane, a
                    crash at the k-th progress event)
==================  ==================================================

Each point keeps an invocation counter; a :class:`ChaosConfig` maps
points to the 0-based invocations at which they fire (each index once:
a retried dispatch advances the counter, so the retry sees a healthy
call).  Leaf and element choices come from one seeded numpy generator,
so a chaos run replays exactly from its spec string.

Activation: ``with chaos.active_chaos(cfg): ...``, or the
``REPRO_CHAOS`` environment variable (read once per ``solve()``), e.g.
``REPRO_CHAOS="dispatch@1;carry_nan@0,2;seed=7"``.

``python -m repro_torch.resilience.chaos --workload deconvolve`` runs a
seeded faulty solve with resilience on and prints the recovery report
as JSON (``--device cpu`` on a host without a card).
"""
from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.checks import leaves_with_path
from repro_torch.resilience.errors import InjectedFault

ENV_VAR = "REPRO_CHAOS"

#: the canonical fault points (``kernel:<family>`` also accepted)
FAULT_POINTS = ("dispatch", "carry_nan", "ckpt_write", "ckpt_corrupt",
                "kernel", "serve_admit_drop", "serve_bucket_poison",
                "serve_crash")


@dataclass(frozen=True)
class ChaosConfig:
    """Seeded, declarative fault plan: ``faults`` maps a fault point
    (optionally ``point:tag``) to the invocations at which it fires."""
    seed: int = 0
    faults: Dict[str, Tuple[int, ...]] = field(default_factory=dict)

    @classmethod
    def parse(cls, spec: str) -> "ChaosConfig":
        """Parse a ``REPRO_CHAOS`` spec: ``;``-separated tokens, each
        ``point@i[,j...]``, a bare ``point`` (index 0), or ``seed=N``."""
        seed = 0
        faults: Dict[str, Tuple[int, ...]] = {}
        for token in spec.split(";"):
            token = token.strip()
            if not token:
                continue
            if token.startswith("seed="):
                seed = int(token[len("seed="):])
                continue
            point, _, idx = token.partition("@")
            point = point.strip()
            base = point.split(":", 1)[0]
            if base not in FAULT_POINTS:
                raise ValueError(
                    f"unknown chaos fault point {point!r}; known points: "
                    f"{FAULT_POINTS} (plus 'kernel:<family>')")
            indices = (tuple(int(t) for t in idx.split(",") if t.strip())
                       if idx else (0,))
            faults[point] = tuple(sorted(set(
                faults.get(point, ()) + indices)))
        return cls(seed=seed, faults=faults)

    @classmethod
    def from_env(cls) -> Optional["ChaosConfig"]:
        spec = os.environ.get(ENV_VAR, "").strip()
        return cls.parse(spec) if spec else None


class ChaosState:
    """One activation: per-point invocation counters and the seeded
    generator.  The serving layer keeps one of its own for the
    ``serve_*`` points."""

    def __init__(self, cfg: ChaosConfig):
        self.cfg = cfg
        self.counts: Dict[str, int] = {}
        self.rng = np.random.default_rng(cfg.seed)
        self.fired: list = []           # [(key, invocation index), ...]

    def _tick(self, key: str) -> bool:
        n = self.counts.get(key, 0)
        self.counts[key] = n + 1
        want = self.cfg.faults.get(key)
        if want is not None and n in want:
            self.fired.append((key, n))
            return True
        return False

    def should_fire(self, point: str, tag: Optional[str] = None) -> bool:
        hit = self._tick(point)
        if tag is not None:
            hit = self._tick(f"{point}:{tag}") or hit
        return hit


_STATE: Optional[ChaosState] = None


def is_active() -> bool:
    return _STATE is not None


def active_seed() -> Optional[int]:
    """The seed of the active plan, or ``None``: the supervisor's backoff
    jitter reuses it so a drill's report replays exactly."""
    return _STATE.cfg.seed if _STATE is not None else None


@contextlib.contextmanager
def active_chaos(cfg: Optional[ChaosConfig]) -> Iterator:
    """Install ``cfg`` as the process-wide plan for the block (``None``
    is a no-op context)."""
    global _STATE
    if cfg is None:
        yield None
        return
    prev = _STATE
    _STATE = ChaosState(cfg)
    try:
        yield _STATE
    finally:
        _STATE = prev


def maybe_from_env() -> contextlib.AbstractContextManager:
    """Activation context for ``REPRO_CHAOS``; inert when it is unset or
    chaos is already active (an explicit ``active_chaos`` wins)."""
    if is_active():
        return contextlib.nullcontext()
    return active_chaos(ChaosConfig.from_env())


# --------------------------------------------------------------------
# Injectors (each a cheap no-op when chaos is inactive)
# --------------------------------------------------------------------

def maybe_raise(point: str, *, step: Optional[int] = None,
                tag: Optional[str] = None) -> None:
    """Raise :class:`InjectedFault` when ``point`` (or ``point:tag``)
    is due to fire at this invocation."""
    st = _STATE
    if st is None:
        return
    if st.should_fire(point, tag):
        raise InjectedFault(point, step=step, tag=tag)


def _replace(tree: Any, path: Tuple, value: Any) -> Any:
    """A copy of ``tree`` with the leaf at ``path`` replaced (only the
    containers along the path are copied)."""
    if not path:
        return value
    head, rest = path[0], path[1:]
    if isinstance(tree, dict):
        return {**tree, head: _replace(tree[head], rest, value)}
    items = list(tree)
    items[head] = _replace(items[head], rest, value)
    return type(tree)(items)


def poison_tree(point: str, tree, *, step: Optional[int] = None):
    """When ``point`` fires, set one seeded element of one seeded float
    leaf of ``tree`` to NaN — the injected analogue of a diverged
    iterate.  Out of place (the poisoned leaf is a new tensor; the tree
    the caller passed stays intact) and without a host sync: the
    element's position comes from the leaf's shape.  Returns ``tree``
    itself when chaos is inactive or the point does not fire."""
    st = _STATE
    if st is None:
        return tree
    if not st.should_fire(point):
        return tree
    leaves = list(leaves_with_path(tree))
    float_idx = [i for i, (_, leaf) in enumerate(leaves)
                 if isinstance(leaf, torch.Tensor)
                 and leaf.is_floating_point()]
    if not float_idx:
        return tree
    path, leaf = leaves[int(st.rng.choice(float_idx))]
    if leaf.dim() == 0:
        new = torch.full_like(leaf, float("nan"))
    else:
        flat = leaf.reshape(-1).clone()
        flat[int(st.rng.integers(flat.shape[0]))] = float("nan")
        new = flat.reshape(leaf.shape)
    return _replace(tree, path, new)


def corrupt_checkpoint_files(point: str, directory, *,
                             step: Optional[int] = None) -> bool:
    """When ``point`` fires, truncate the first leaf file (or, with no
    leaves, the manifest) of a just-written checkpoint directory to half
    its size — a torn write the restore side must catch.  Returns
    whether a file was corrupted."""
    st = _STATE
    if st is None:
        return False
    if not st.should_fire(point):
        return False
    directory = Path(directory)
    leaves = sorted(directory.glob("leaf_*.npy"))
    target = leaves[0] if leaves else directory / "manifest.json"
    if not target.exists():
        return False
    data = target.read_bytes()
    target.write_bytes(data[: max(len(data) // 2, 1)])
    return True


# --------------------------------------------------------------------
# Chaos smoke entry point
# --------------------------------------------------------------------

def _main(argv=None) -> int:
    """Seeded faulty solve with resilience on; prints the recovery
    report.  Chaos comes from ``REPRO_CHAOS`` (or ``--spec``)."""
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="deconvolve",
                    choices=("deconvolve", "scdl"))
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help='torch device (default "cuda")')
    ap.add_argument("--spec", default=None,
                    help=f"chaos spec (default: ${ENV_VAR})")
    ap.add_argument("--report", default=None,
                    help="write the recovery report JSON here")
    args = ap.parse_args(argv)

    from repro_torch.core.problem import solve
    # under ``python -m`` this file runs as ``__main__``: activate chaos
    # on the module the solve stack's injectors read, not on this alias
    from repro_torch.resilience import chaos as _canon
    from repro_torch.resilience.recovery import ResilienceConfig

    cfg = (_canon.ChaosConfig.parse(args.spec) if args.spec is not None
           else _canon.ChaosConfig.from_env())
    if cfg is None:
        cfg = _canon.ChaosConfig.parse("dispatch@1;carry_nan@2;seed=7")
    with _canon.active_chaos(cfg) as state:
        if args.workload == "deconvolve":
            from repro_torch.imaging import psf as psf_op
            from repro_torch.imaging.condat import SolverConfig
            data = psf_op.simulate(args.n, torch.Generator().manual_seed(0),
                                   device=args.device)
            sol = solve("deconvolve", data.Y, data.psfs,
                        cfg=SolverConfig(mode="sparse", n_scales=3),
                        device=args.device, max_iter=args.iters, tol=0,
                        chunk=args.chunk, resilience=ResilienceConfig())
        else:
            from repro_torch.data.synthetic import coupled_patches
            from repro_torch.imaging.scdl import SCDLConfig
            S_h, S_l = coupled_patches(256, 25, 9, 16,
                                       torch.Generator().manual_seed(0),
                                       device=args.device)
            sol = solve("scdl", S_h, S_l,
                        cfg=SCDLConfig(n_atoms=16, max_iter=args.iters),
                        device=args.device, tol=0, chunk=args.chunk,
                        resilience=ResilienceConfig())
        fired = list(state.fired) if state is not None else []
    report = sol.recovery.to_json() if sol.recovery is not None else {}
    report["chaos"] = {"seed": cfg.seed,
                       "faults": {k: list(v)
                                  for k, v in cfg.faults.items()},
                       "fired": [{"point": k, "invocation": n}
                                 for k, n in fired]}
    report["final_cost"] = float(sol.log.costs[-1])
    print(json.dumps(report, indent=2))
    if args.report:
        Path(args.report).write_text(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":                        # pragma: no cover
    raise SystemExit(_main())
