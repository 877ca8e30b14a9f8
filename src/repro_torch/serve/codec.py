"""Wire and journal codecs for serve requests.  Port of
``repro.serve.codec``.

Kept apart from ``serve.server`` so the request journal can round-trip
requests without importing the HTTP transport.  Two families:

- configs and options: a config as a plain dict decoded through the
  workload's own config dataclass (the port's ``SolverConfig``,
  ``SCDLConfig``, ``CompletionConfig``); run options as JSON, with a
  ``ResilienceConfig`` flattened to its JSON-safe fields;
- arrays, lossless: :func:`encode_array` writes a numpy array or a
  torch tensor (any device: its bytes are copied to the CPU) as its raw
  bytes in base64 with dtype and shape in the header; a bf16 tensor,
  which numpy cannot hold, goes as its int16 bits with dtype
  ``"bfloat16"``, as the checkpointer stores it.  :func:`decode_array`
  gives numpy back (a tensor on request, and always for bf16).

Inputs (:func:`encode_input` / :func:`decode_inputs`): each array as an
array record; an instance's own random draws, the trailing dict the
port's workloads accept (``(Y, psfs, {"u0": ...})``), as ``{"draws":
{name: record}}``.  Off the wire :func:`decode_inputs` also takes the
JAX package's forms: nested JSON lists (decoded as float32) and
``{"data", "dtype"}`` records.
"""
from __future__ import annotations

import base64
import dataclasses
import importlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

#: problem key -> (module, config dataclass) for decoding ``cfg`` dicts;
#: in-process callers pass config objects directly instead
_CONFIG_TYPES: Dict[str, Tuple[str, str]] = {
    "deconvolve": ("repro_torch.imaging.condat", "SolverConfig"),
    "scdl": ("repro_torch.imaging.scdl", "SCDLConfig"),
    "lowrank": ("repro_torch.imaging.lowrank", "CompletionConfig"),
}

BF16 = "bfloat16"


def decode_config(problem: str, cfg: Optional[dict]):
    if cfg is None:
        return None
    if not isinstance(cfg, dict):
        raise ValueError(f"cfg must be a JSON object, got "
                         f"{type(cfg).__name__}")
    if problem not in _CONFIG_TYPES:
        raise ValueError(
            f"no config codec for workload {problem!r}; known: "
            f"{sorted(_CONFIG_TYPES)}")
    mod, name = _CONFIG_TYPES[problem]
    cls = getattr(importlib.import_module(mod), name)
    return cls(**cfg)


def encode_config(cfg) -> Optional[dict]:
    """A workload config dataclass as a JSON-safe dict (the inverse of
    :func:`decode_config`)."""
    if cfg is None:
        return None
    if isinstance(cfg, dict):
        return dict(cfg)
    return dataclasses.asdict(cfg)


def decode_options(options: Optional[dict]) -> Dict[str, Any]:
    """Run control off the wire; its one structured field is
    ``resilience`` (a dict of ``ResilienceConfig`` fields)."""
    opts = dict(options or {})
    res = opts.get("resilience")
    if isinstance(res, dict):
        from repro_torch.resilience.recovery import ResilienceConfig
        opts["resilience"] = ResilienceConfig(**res)
    return opts


def encode_options(options: Optional[dict]) -> Dict[str, Any]:
    """Run control as JSON (the inverse of :func:`decode_options`).  A
    ``ResilienceConfig`` is flattened to its JSON-safe fields: the
    callable ``rollback_rescale`` and the exception types
    ``transient_types`` cannot be journaled, so a replayed request runs
    with their defaults."""
    opts = dict(options or {})
    res = opts.get("resilience")
    if res is not None and not isinstance(res, dict):
        d = dataclasses.asdict(res)
        d.pop("rollback_rescale", None)
        d.pop("transient_types", None)
        opts["resilience"] = d
    return opts


def encode_array(a) -> dict:
    """Lossless record of one array or tensor: raw bytes in base64 with
    dtype and shape."""
    if isinstance(a, torch.Tensor):
        t = a.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return {"dtype": BF16, "shape": list(t.shape),
                    "b64": base64.b64encode(
                        t.view(torch.int16).numpy().tobytes()
                    ).decode("ascii")}
        a = t.numpy()
    a = np.ascontiguousarray(np.asarray(a))
    return {"dtype": a.dtype.str, "shape": list(a.shape),
            "b64": base64.b64encode(a.tobytes()).decode("ascii")}


def decode_array(d: dict, *, as_tensor: bool = False):
    """An array record back: numpy, or a CPU tensor with ``as_tensor``
    (always a tensor for bf16)."""
    raw = base64.b64decode(d["b64"])
    if d["dtype"] == BF16:
        bits = np.frombuffer(raw, dtype=np.int16).reshape(d["shape"]).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    arr = np.frombuffer(raw, dtype=np.dtype(d["dtype"])
                        ).reshape(d["shape"]).copy()
    return torch.from_numpy(arr) if as_tensor else arr


def encode_input(x) -> dict:
    """One input of a request: an array record, or a draws dict as
    ``{"draws": {name: record}}``."""
    if isinstance(x, dict):
        return {"draws": {k: encode_array(v) for k, v in x.items()}}
    return encode_array(x)


def decode_inputs(inputs) -> Tuple[Any, ...]:
    """Inputs off the wire or out of the journal: array records, draws
    dicts, ``{"data", "dtype"}`` records, or nested JSON lists (decoded
    as float32)."""
    if not isinstance(inputs, (list, tuple)):
        raise ValueError("inputs must be a JSON array of arrays")
    out = []
    for x in inputs:
        if isinstance(x, dict) and "b64" in x:
            out.append(decode_array(x))
        elif isinstance(x, dict) and "draws" in x:
            out.append({k: decode_array(v) for k, v in x["draws"].items()})
        elif isinstance(x, dict):
            out.append(np.asarray(x["data"],
                                  dtype=np.dtype(x.get("dtype",
                                                       "float32"))))
        else:
            out.append(np.asarray(x, dtype=np.float32))
    return tuple(out)


def encode_tree(x):
    """A result as array records (lossless): one record, or a list or a
    dict of them (SCDL's two dictionaries)."""
    if isinstance(x, dict):
        return {k: encode_tree(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return [encode_tree(v) for v in x]
    return encode_array(x)


def decode_tree(x, *, as_tensor: bool = False):
    """The inverse of :func:`encode_tree`: a record or a list of them."""
    if isinstance(x, dict) and "b64" in x:
        return decode_array(x, as_tensor=as_tensor)
    if isinstance(x, dict):
        return {k: decode_tree(v, as_tensor=as_tensor)
                for k, v in x.items()}
    return tuple(decode_tree(v, as_tensor=as_tensor) for v in x)
