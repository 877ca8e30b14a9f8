"""Dtype hygiene on the torch side.

RPL401 f64-dtype : an explicit ``torch.float64`` / ``torch.double`` /
                   ``torch.complex128`` / ``torch.cdouble`` dtype, or a
                   ``.double()`` cast.  The port computes in fp32 (and
                   bf16): its kernels take nothing else, and a float64
                   tensor doubles the bytes every pass moves.  Host
                   numpy in float64 stays allowed (the driver's cost log,
                   the runtime checks' sums): it never reaches the card.
RPL402 bf16-accum: a reduction (``torch.sum``/``mean``/``matmul``/
                   ``einsum``/``@``/``.sum()`` ...) over an operand
                   cast to ``bfloat16``/``float16`` without a wider
                   ``dtype=``.  Low-precision inputs are fine;
                   accumulating in them loses the tail of long sums.
                   Cast the operand to ``torch.float32`` first, or give
                   the reduction ``dtype=torch.float32``.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from repro_torch.lint.checkers._ast_util import import_aliases, resolve
from repro_torch.lint.core import Finding, ModuleSource, Rule, register_checker

RPL401 = Rule("RPL401", "f64-dtype",
              "explicit float64/complex128 dtype in the fp32 port")
RPL402 = Rule("RPL402", "bf16-accum",
              "reduction accumulates in bf16/f16 without a wider dtype")

_WIDE = frozenset({"float64", "double", "complex128", "cdouble"})
_WIDE_METHODS = frozenset({"double", "cdouble"})
_NARROW = frozenset({"bfloat16", "float16", "half"})
_NARROW_METHODS = frozenset({"bfloat16", "half"})
_REDUCTIONS = frozenset({
    "sum", "nansum", "mean", "nanmean", "prod", "cumsum", "cumprod", "dot",
    "vdot", "inner", "matmul", "mm", "bmm", "mv", "addmm", "baddbmm",
    "tensordot", "einsum", "trace", "var", "std", "norm", "vector_norm",
    "matrix_norm"})


def _torch_dtype(node, aliases) -> Optional[str]:
    """The leaf of a ``torch.<dtype>`` expression, else None."""
    name = resolve(node, aliases)
    if name is not None and name.startswith("torch.") and name.count(".") == 1:
        return name.split(".")[1]
    return None


def _narrow_cast(node, aliases) -> bool:
    """Whether ``node`` casts or creates a bf16/f16 tensor:
    ``x.to(torch.bfloat16)``, ``x.to(dtype=torch.half)``,
    ``x.bfloat16()``, ``x.half()``, ``x.type(torch.float16)`` or any call
    with a narrow ``dtype=``."""
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    if isinstance(fn, ast.Attribute):
        if fn.attr in _NARROW_METHODS and not node.args:
            return True
        if fn.attr in ("to", "type") and any(
                _torch_dtype(a, aliases) in _NARROW for a in node.args):
            return True
    return any(kw.arg == "dtype" and _torch_dtype(kw.value, aliases)
               in _NARROW for kw in node.keywords)


def _contains_narrow(node, aliases, depth: int = 0) -> bool:
    """Whether a bf16/f16 cast feeds this operand directly or through a
    few levels of arithmetic (one behind another reduction is that
    reduction's finding)."""
    if depth > 4 or node is None:
        return False
    if _narrow_cast(node, aliases):
        return True
    if isinstance(node, ast.BinOp):
        return _contains_narrow(node.left, aliases, depth + 1) or \
            _contains_narrow(node.right, aliases, depth + 1)
    if isinstance(node, ast.UnaryOp):
        return _contains_narrow(node.operand, aliases, depth + 1)
    return False


def _wide_accumulator(call: ast.Call, aliases) -> bool:
    return any(kw.arg == "dtype" and _torch_dtype(kw.value, aliases)
               not in _NARROW for kw in call.keywords)


def _reduction(call: ast.Call, aliases) -> Optional[str]:
    """The reduction a call names (``torch.sum``, ``torch.linalg.norm``,
    ``x.sum()``), else None."""
    name = resolve(call.func, aliases)
    leaf = name.split(".")[-1] if name else None
    if name is not None and name.startswith("torch.") and leaf in _REDUCTIONS:
        return leaf
    if isinstance(call.func, ast.Attribute) and call.func.attr in _REDUCTIONS:
        return call.func.attr
    return None


@register_checker("dtypes", [RPL401, RPL402])
def check(mod: ModuleSource):
    aliases = import_aliases(mod.tree)
    findings: List[Finding] = []
    for node in ast.walk(mod.tree):
        wide = None
        if isinstance(node, (ast.Attribute, ast.Name)):
            leaf = _torch_dtype(node, aliases)
            if leaf in _WIDE:
                wide = f"torch.{leaf}"
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in _WIDE_METHODS and not node.args:
            wide = f".{node.func.attr}()"
        if wide is not None:
            findings.append(mod.finding(
                RPL401, node,
                f"explicit {wide} — the port computes in fp32 and its "
                f"kernels take fp32/bf16 only; keep float64 references "
                f"in host numpy"))
            continue
        if isinstance(node, ast.Call):
            leaf = _reduction(node, aliases)
            if leaf is None or _wide_accumulator(node, aliases):
                continue
            operands = list(node.args)
            if isinstance(node.func, ast.Attribute):
                operands.append(node.func.value)      # x.sum() form
            if any(_contains_narrow(op, aliases) for op in operands):
                findings.append(mod.finding(
                    RPL402, node,
                    f"'{leaf}' accumulates a bf16/f16-cast operand without "
                    f"a wider dtype — pass dtype=torch.float32 or cast the "
                    f"operand to torch.float32 first"))
        elif isinstance(node, ast.BinOp) and \
                isinstance(node.op, ast.MatMult) and \
                (_contains_narrow(node.left, aliases)
                 or _contains_narrow(node.right, aliases)):
            findings.append(mod.finding(
                RPL402, node,
                "'@' matmul on a bf16/f16-cast operand accumulates in low "
                "precision — cast the operands to torch.float32 first"))
    return findings
