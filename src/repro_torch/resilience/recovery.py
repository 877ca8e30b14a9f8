"""Resilience configuration and the recovery report.  Port of
``repro.resilience.recovery``: the same fields, the same JSON keys.

:class:`ResilienceConfig` is run control, passed as ``solve(...,
resilience=ResilienceConfig(...))`` and carried on ``RunOptions``;
:class:`RecoveryReport` is the run's ledger, returned on
``Solution.recovery``.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class ResilienceConfig:
    """Supervised-execution policy for one run.

    - ``max_retries`` — transient dispatch failures retried per chunk,
      each from the chunk-start snapshot after an exponential backoff of
      ``backoff_s * backoff_factor**attempt``, jittered by ``jitter``
      (seeded from ``seed``, or from the active chaos seed during a
      drill, so a drill's report replays run to run).
    - ``ring`` — chunk-boundary snapshots kept for rollback.  Divergence
      rollback takes them newest first; when the ring is dry it falls
      back to the newest *valid* checkpoint under ``checkpoint_dir``
      (``solve()`` fills this in from its own ``checkpoint_dir=``).
      Memory: an entry holds *references* to the chunk-start tensors on
      the card, not a copy — the port's steps write out of place
      (``core.persistence.assert_out_of_place``), so the tensors a chunk
      started from stay intact, and a snapshot costs no copy and no
      host sync.  Each entry keeps one carry alive on the card (the
      leaves the chunk replaced: for the deconvolution the primal,
      dual and their transforms; inputs passed through unchanged are
      shared), so the overhead is ``ring x`` that on the card; for a
      ``solve_many`` bucket the carry is the whole padded bucket.  The
      JAX package copies each entry to the host because donation
      consumes its buffers; the port donates nothing.  ``ring=1`` still
      supports dispatch retry; rollback then leans on the checkpoints.
    - ``max_rollbacks`` — total divergence rollbacks before giving up
      (:class:`~repro_torch.resilience.errors.ResilienceExhausted`).
    - ``rollback_rescale(replicated, n_rollbacks) -> replicated`` —
      optional step-size backoff applied to the broadcast state after
      each rollback; ``None`` replays the chunk unchanged.
    - ``transient_types`` — extra exception types classified transient.
    """
    max_retries: int = 3
    backoff_s: float = 0.02
    backoff_factor: float = 2.0
    jitter: float = 0.1
    ring: int = 2
    max_rollbacks: int = 8
    rollback_rescale: Optional[Callable[[Any, int], Any]] = None
    checkpoint_dir: Optional[str] = None
    transient_types: Tuple[type, ...] = ()
    seed: int = 0

    def __post_init__(self):
        if self.ring < 1:
            raise ValueError(
                "ResilienceConfig.ring must be >= 1: retry after a "
                "failed dispatch needs at least the chunk-start snapshot "
                "to restore from")


@dataclass
class RecoveryReport:
    """What resilience did for one run: every fault seen, every retry
    and rollback taken, and the wall time the failures cost (snapshots
    and validation are not counted as lost; only failed work and its
    repair are).  ``kernel_fallbacks`` stays empty in the port: a
    kernel failure is retried on the same kernel, never degraded."""
    retries: int = 0
    rollbacks: int = 0
    checkpoint_restores: int = 0
    faults: List[dict] = field(default_factory=list)
    kernel_fallbacks: List[dict] = field(default_factory=list)
    wall_time_lost_s: float = 0.0

    @classmethod
    def merged(cls, parts: List["RecoveryReport"]) -> "RecoveryReport":
        """One report of a mesh run from every rank's (in rank order),
        the same on every rank.  A fault's ``"key"`` (the chunk's
        ordinal, the kind, the attempt) pairs the ranks' entries: a
        divergence is one decision of every rank (the entry of the
        lowest rank whose own state or costs showed it); a dispatch
        fault every rank met counts once, one that some ranks met alone
        once per rank, each entry naming its ``"rank"``.  Rollbacks and
        restores are collective; ``wall_time_lost_s`` is the largest."""
        by_key: Dict[tuple, list] = {}
        for rank, part in enumerate(parts):
            for f in part.faults:
                by_key.setdefault(tuple(f["key"]), []).append((rank, f))
        faults, retries = [], 0

        def plain(f):
            return {k: v for k, v in f.items()
                    if k not in ("key", "retried", "local")}

        for key in sorted(by_key):
            entries = by_key[key]
            if entries[0][1]["point"] == "divergence":
                pick = next((f for _, f in entries if f.get("local")),
                            entries[0][1])
                faults.append(plain(pick))
            elif len(entries) == len(parts):
                faults.append(plain(entries[0][1]))
                retries += bool(entries[0][1].get("retried"))
            else:
                for rank, f in entries:
                    faults.append({**plain(f), "rank": rank})
                    retries += bool(f.get("retried"))
        first = parts[0]
        return cls(retries=retries, rollbacks=first.rollbacks,
                   checkpoint_restores=first.checkpoint_restores,
                   faults=faults,
                   kernel_fallbacks=[dict(e) for e in first.kernel_fallbacks],
                   wall_time_lost_s=max(p.wall_time_lost_s for p in parts))

    def record_fault(self, point: str, step, exc: BaseException) -> None:
        self.faults.append({
            "point": point,
            "step": None if step is None else int(step),
            "error": f"{type(exc).__name__}: {exc}"})

    def to_json(self) -> dict:
        out = asdict(self)
        out["wall_time_lost_s"] = round(out["wall_time_lost_s"], 6)
        return out

    def for_range(self, last_step: Optional[int]) -> "RecoveryReport":
        """This (bucket-level) ledger sliced to the faults one lane could
        have seen: those at ``step <= last_step`` (and step-less ones).
        Retry and rollback counts come from the sliced faults; kernel
        fallbacks and wall time lost are carried over whole.
        ``last_step=None`` means the lane ran to the end."""
        if last_step is None:
            faults = list(self.faults)
        else:
            faults = [f for f in self.faults
                      if f.get("step") is None
                      or f["step"] <= int(last_step)]
        sliced = RecoveryReport(
            retries=sum(1 for f in faults if f["point"] == "dispatch"),
            rollbacks=sum(1 for f in faults
                          if f["point"] == "divergence"),
            checkpoint_restores=self.checkpoint_restores,
            faults=[dict(f) for f in faults],
            kernel_fallbacks=[dict(e) for e in self.kernel_fallbacks],
            wall_time_lost_s=self.wall_time_lost_s)
        # dispatch faults include the final (not retried) raise: clamp to
        # the counters the supervisor banked
        sliced.retries = min(sliced.retries, self.retries)
        sliced.rollbacks = min(sliced.rollbacks, self.rollbacks)
        return sliced

    def __str__(self) -> str:
        return (f"RecoveryReport(retries={self.retries}, "
                f"rollbacks={self.rollbacks}, "
                f"checkpoint_restores={self.checkpoint_restores}, "
                f"faults={len(self.faults)}, "
                f"kernel_fallbacks={len(self.kernel_fallbacks)}, "
                f"wall_time_lost_s={self.wall_time_lost_s:.3f})")
