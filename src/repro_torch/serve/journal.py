"""Crash-safe request journal for the serving layer.  Port of
``repro.serve.journal``, over the port's ``checkpoint.wal``.

An append-only WAL of three record kinds:

- ``admit`` — a request cleared admission control: id plus a lossless
  encoding of the whole :class:`~repro_torch.serve.service.SolveRequest`
  (inputs as base64 array records, tensors' bytes copied off their
  device; config and options through ``serve.codec``).
- ``bucket`` — a coalesced bucket dispatched: its lane bucket key and
  the member request ids *in dispatch order* (the order fixes
  ``solve_many``'s internal re-plan, hence the per-bucket checkpoint
  directory a restart resumes from).
- ``done`` — a request reached a terminal state; replay skips it.

:func:`RequestJournal.replay` folds the log into the work a restarted
service owes: still-pending requests and the bucket grouping of any
that were already dispatched together.  Torn/corrupt tail lines are
skipped, not fatal — the WAL reader's contract.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from repro_torch.checkpoint.wal import WriteAheadLog
from repro_torch.serve import codec

JOURNAL_FILE = "requests.wal"


@dataclass
class ReplayPlan:
    """What a restarted service owes: ``pending`` maps request id to
    its reconstructed request (admission order preserved by dict
    insertion); ``buckets`` lists ``(bucket_key, [ids...])`` groups
    whose members are ALL still pending — they must re-dispatch
    together, in order, to land on the same per-bucket checkpoints."""
    pending: Dict[str, "object"] = field(default_factory=dict)
    buckets: List[Tuple[str, List[str]]] = field(default_factory=list)
    skipped_lines: int = 0
    done: int = 0


class RequestJournal:
    def __init__(self, directory, *, fsync: bool = False):
        self.directory = Path(directory)
        self._wal = WriteAheadLog(self.directory / JOURNAL_FILE,
                                  fsync=fsync)

    # -------------------------------------------------------- appends
    def admit(self, request_id: str, request) -> None:
        self._wal.append({
            "kind": "admit", "id": request_id,
            "problem": request.problem,
            "inputs": [codec.encode_input(x) for x in request.inputs],
            "cfg": codec.encode_config(request.cfg),
            "options": codec.encode_options(request.options),
            "chaos": request.chaos_spec,
            "deadline_s": request.deadline_s})

    def bucket(self, bucket_key: str, request_ids: List[str]) -> None:
        self._wal.append({"kind": "bucket", "key": bucket_key,
                          "ids": list(request_ids)})

    def done(self, request_id: str, status: str) -> None:
        self._wal.append({"kind": "done", "id": request_id,
                          "status": status})

    def close(self) -> None:
        self._wal.close()

    # --------------------------------------------------------- replay
    @staticmethod
    def replay(directory) -> ReplayPlan:
        from repro_torch.serve.service import SolveRequest
        records, skipped = WriteAheadLog.read(
            Path(directory) / JOURNAL_FILE)
        plan = ReplayPlan(skipped_lines=skipped)
        admits: Dict[str, dict] = {}
        buckets: Dict[str, Tuple[str, List[str]]] = {}
        finished: set = set()
        for r in records:
            kind = r.get("kind")
            if kind == "admit":
                admits[r["id"]] = r
            elif kind == "bucket":
                for rid in r["ids"]:
                    buckets[rid] = (r["key"], list(r["ids"]))
            elif kind == "done":
                finished.add(r["id"])
        plan.done = len(finished)
        for rid, r in admits.items():
            if rid in finished:
                continue
            plan.pending[rid] = SolveRequest(
                problem=r["problem"],
                inputs=codec.decode_inputs(r["inputs"]),
                cfg=codec.decode_config(r["problem"], r.get("cfg")),
                options=codec.decode_options(r.get("options")),
                chaos_spec=r.get("chaos"),
                deadline_s=r.get("deadline_s"))
        # a dispatched bucket only re-dispatches as a group when every
        # member is still owed — a partially-finished bucket's survivors
        # re-enter coalescing like fresh traffic
        seen: set = set()
        for rid in plan.pending:
            grp = buckets.get(rid)
            if grp is None or grp[0] in seen:
                continue
            key, ids = grp
            if len(ids) >= 2 and all(i in plan.pending for i in ids):
                plan.buckets.append((key, ids))
                seen.add(key)
        return plan


def journal_pending(directory) -> Optional[ReplayPlan]:
    """Replay helper tolerant of a missing journal (cold start)."""
    path = Path(directory) / JOURNAL_FILE
    if not path.exists():
        return None
    return RequestJournal.replay(directory)
