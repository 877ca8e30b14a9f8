"""Runtime contract checks: ``solve(..., checks=True)``.

Port of ``repro.core.checks``.  Enabled per run through
``RunOptions.checks`` / ``solve(..., checks=True)`` or for every solve in
the process through the ``REPRO_CHECKS`` environment variable (any value
but ``""``, ``"0"``, ``"false"`` and ``"no"``; read once per solve).
Off, the default, the driver runs no extra operation and no extra host
sync.

Three families of checks:

- **finite** — ``init_bundle``'s state and the evolving data and
  replicated state at every host sync hold no NaN or Inf;
- **carry contract** — the step's output carry has its input carry's
  structure, shapes and dtypes.  The JAX package asks ``jax.eval_shape``;
  the port runs the step once on ``meta`` tensors, which carry shapes
  and dtypes and compute nothing (the kernel wrappers send them to
  their plain versions), before the first dispatch.  The same tool
  seeds a cost-skipping run's carried output (``engine.init_out_like``);
- **costs** — evaluated objectives are finite.  ``+inf`` is exempt: it
  seeds a slot not yet evaluated (``engine.seed_like``), so only NaN and
  ``-inf`` fail.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Iterator, Mapping, Tuple

import numpy as np
import torch

_ENV_VAR = "REPRO_CHECKS"


class CheckError(RuntimeError):
    """A runtime contract check tripped (checks=True mode)."""


def checks_enabled(flag: bool = False) -> bool:
    """``flag`` OR the ``REPRO_CHECKS`` environment variable."""
    env = os.environ.get(_ENV_VAR, "").strip().lower()
    return bool(flag) or env not in ("", "0", "false", "no")


def leaves_with_path(tree: Any, path: Tuple = ()) -> Iterator[Tuple]:
    """``(path, leaf)`` for every leaf of a tree of dicts, tuples and
    lists, dict keys in sorted order (the port's canonical order)."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, path + (i,))
    elif tree is not None:
        yield path, tree


def structure(tree: Any) -> str:
    """The tree's shape of containers and keys, leaves as ``*``."""
    if isinstance(tree, Mapping):
        return "{" + ", ".join(f"{k!r}: {structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        return "(" + ", ".join(structure(v) for v in tree) + ",)"
    return "None" if tree is None else "*"


def label(path: Tuple) -> str:
    return "".join(f"[{k!r}]" for k in path) or "<root>"


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy() \
            if leaf.dtype != torch.bfloat16 \
            else leaf.detach().float().cpu().numpy()
    return np.asarray(leaf)


# --------------------------------------------------------------------
# Finite checks
# --------------------------------------------------------------------

def assert_all_finite(tree: Any, what: str) -> None:
    """NaN/Inf sweep over every floating leaf of ``tree``: one copy to
    the host per leaf, so only ever called with checks on."""
    for path, leaf in leaves_with_path(tree):
        arr = _host(leaf)
        if not (np.issubdtype(arr.dtype, np.floating)
                or np.issubdtype(arr.dtype, np.complexfloating)):
            continue
        bad = ~np.isfinite(arr)
        if bad.any():
            kinds = [k for k, hit in (("NaN", np.isnan(arr).any()),
                                      ("+inf", np.isposinf(arr.real).any()),
                                      ("-inf", np.isneginf(arr.real).any()))
                     if hit]
            raise CheckError(
                f"checks=True: {what}: leaf '{label(path)}' has "
                f"{int(bad.sum())}/{arr.size} non-finite values "
                f"({'/'.join(kinds)}) — the run is poisoned; inspect "
                f"the step math or lower the step sizes")


def assert_costs_finite(costs, what: str) -> None:
    """NaN and ``-inf`` objectives fail; ``+inf`` is the not-yet-
    evaluated seed and passes."""
    costs = np.asarray(costs, dtype=np.float64)
    bad = np.isnan(costs) | np.isneginf(costs)
    if bad.any():
        idx = int(np.argmax(bad.ravel()))
        raise CheckError(
            f"checks=True: {what}: objective value is "
            f"{costs.ravel()[idx]!r} at position {idx} of this sync — "
            f"the iterate diverged (NaN/-inf cost)")


# --------------------------------------------------------------------
# Carry contract (on meta tensors: no dispatch)
# --------------------------------------------------------------------

def to_meta(tree: Any) -> Any:
    """The tree with every tensor replaced by a ``meta`` tensor of its
    shape and dtype (other leaves kept)."""
    if isinstance(tree, Mapping):
        return {k: to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_meta(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    return tree


def eval_step_spec(fn: Callable, *args) -> Any:
    """``fn(*args)`` run on ``meta`` copies of the arguments: the output's
    structure, shapes and dtypes, with no device work.  A failure is
    reported as a :class:`CheckError`."""
    try:
        with torch.no_grad():
            return fn(*to_meta(args))
    except CheckError:
        raise
    except Exception as e:
        raise CheckError(
            f"checks=True: step function failed on meta tensors (before "
            f"any dispatch): {type(e).__name__}: {e}") from e


def _spec(tree: Any):
    return [(p, tuple(x.shape), x.dtype) for p, x in leaves_with_path(tree)
            if isinstance(x, torch.Tensor)]


def assert_carry_stable(in_carry, out_carry, what: str) -> None:
    """An input carry against the step's output carry (tensors or
    ``meta`` tensors): a different structure, a shape that drifts or a
    dtype that flips raises, naming the leaf."""
    s_in, s_out = structure(in_carry), structure(out_carry)
    if s_in != s_out:
        raise CheckError(
            f"checks=True: {what}: step output carry has a different "
            f"structure than its input —\n  in : {s_in}\n  out: {s_out}\n"
            f"the carry must be structure-stable")
    for (path, si, di), (_, so, do) in zip(_spec(in_carry),
                                           _spec(out_carry)):
        if si != so:
            raise CheckError(
                f"checks=True: {what}: carry leaf '{label(path)}' changes "
                f"shape {si} -> {so} across one step")
        if di != do:
            raise CheckError(
                f"checks=True: {what}: carry leaf '{label(path)}' changes "
                f"dtype {str(di).split('.')[-1]} -> "
                f"{str(do).split('.')[-1]} across one step — the objective "
                f"would silently run in {str(do).split('.')[-1]}")
