"""Shared plumbing for the port's CUDA kernels: device resolution, the
``nvcc`` build of ``src/repro_torch/csrc/*.cu`` into one shared library,
its ``ctypes`` bindings, and the launch-error check.

Build route: every ``.cu`` file under ``csrc/`` is compiled for
``sm_90a`` by its own ``nvcc`` process (all started together), then the
objects are linked into ``libreprotorch-<hash>.so`` under
``build/repro_torch/`` at the repository root.  The hash covers the
sources and the flags, so a stale library is never loaded.  The build
happens at the first kernel launch in a process, never at import: the
CPU tests import every module on hosts that have no ``nvcc``.

There is deliberately no fallback: a CUDA tensor either launches its
kernel or raises.  The chaos point ``kernel:<family>``
(:func:`chaos_point`, called by each ``ops.py`` wrapper before it
chooses a route) raises there too: under supervision the chunk is
retried on the same kernel, without it the run ends.  Each C entry point returns ``cudaGetLastError()``
after its launch and :func:`check` turns anything other than
``cudaSuccess`` into a ``RuntimeError``.  Each wrapper keeps a plain
integer launch counter (``<wrapper>.launches``) that it increments
after a successful launch and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Union

import numpy as np
import torch

from repro_torch.resilience import chaos as _chaos

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C entry point -> argument types (every entry point returns an int
# cudaError_t; a launch takes the stream as its last argument)
_SIGNATURES = {
    "repro_starlet_smooth": (_P, _P, _I, _I, _I, _I, _I, _P),
    "repro_starlet_forward": (_P, _P, _I, _I, _I, _I, _I, _P),
    "repro_starlet_adjoint": (_P, _P, _I, _I, _I, _I, _I, _P),
    "repro_condat_primal": (_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _P),
    "repro_condat_dual": (_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P),
    "repro_admm_elwise": (_P, _P, _P, _P, _L, _F, _F, _F, _F, _F, _I, _P),
    "repro_dict_outer": (_I, _P, _P, _P, _P, _P, _I, _L, _I, _P, _L, _I,
                         _P),
    "repro_jacobi_eigh": (_P, _P, _P, _P, _I, _I, _I, _P),
    "repro_jacobi_svd": (_P, _P, _P, _P, _P, _I, _I, _P),
    "repro_psf_conv": (_P, _P, _P, _P, _P, _L, _I, _I, _P, _P, _P, _P, _L,
                       _I, _I, _I, _P),
    # host-only query (no stream): the split of K and the scratch size
    "repro_dict_outer_plan": (_I, _P, _P, _I, _L, _I, _I, _P, _P),
}


# devices whose tensors take the plain versions: the CPU, and ``meta``
# tensors, which carry shapes and dtypes only (the driver's contract checks
# and its +inf seeds run a step on them; nothing is computed)
PLAIN_DEVICES = ("cpu", "meta")


def chaos_point(family: str, t: torch.Tensor) -> None:
    """The ``kernel`` fault point of a wrapper of ``family``: raises
    ``InjectedFault`` when a chaos plan schedules it.  ``meta`` tensors
    (a contract check, a seed's structure) compute nothing and do not
    count as calls."""
    if _chaos.is_active() and t.device.type != "meta":
        _chaos.maybe_raise("kernel", tag=family)


def on_card(t: torch.Tensor) -> bool:
    """Whether a wrapper launches its kernel for ``t``: every tensor that
    is neither on the CPU nor ``meta`` (a non-CUDA one then raises)."""
    return t.device.type not in PLAIN_DEVICES


def resolve_device(device: Union[None, str, torch.device] = None
                   ) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device without a card raises:
    the port never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        if dev.index is None:
            # tensors report an indexed device; compare like with like
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(x, device: torch.device, dtype=None) -> torch.Tensor:
    """A numpy array or tensor as a tensor on ``device``.  Arrays are
    always copied (never aliased, and read-only ones are fine)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError(f"nvcc not found on PATH or under {home} (set "
                       f"CUDA_HOME); the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libreprotorch-{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile and link the kernels unless the library for these
    sources already exists.  The compiler's output (``-Xptxas -v``:
    registers, shared memory, spills) and each source's seconds to build
    are kept beside the library as ``<library>.log``.  Returns the
    library's path."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    units = sorted(CSRC.glob("*.cu"))
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in units]
        # each compiler's output goes to a file (a pipe left unread while
        # another unit finishes could fill and stall it)
        outs = [Path(tmp) / (src.stem + ".log") for src in units]
        start = time.perf_counter()
        procs = []
        for src, obj, log in zip(units, objs, outs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                     "-o", str(obj)], stdout=f, stderr=subprocess.STDOUT))
        secs = {}
        while len(secs) < len(procs):
            for i, p in enumerate(procs):
                if i not in secs and p.poll() is not None:
                    secs[i] = time.perf_counter() - start
            time.sleep(0.05)
        logs = [f"== {src.name} ({secs[i]:.1f} s)\n{log.read_text()}"
                for i, (src, log) in enumerate(zip(units, outs))]
        failed = [src.name for src, p in zip(units, procs)
                  if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n"
                               + "\n".join(logs))
        staged = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(staged),
             *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        Path(str(out) + ".log").write_text("\n".join(logs))
        # atomic: a concurrent build sees either no file or a whole one
        os.replace(staged, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process."""
    lib = ctypes.CDLL(str(build_library()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = (ctypes.c_int,)
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        msg = library().repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(what: str, *tensors: torch.Tensor) -> None:
    """The checks every wrapper shares: CUDA, one device, fp32 or bf16
    (all alike), contiguous."""
    dev = tensors[0].device
    dtype = tensors[0].dtype
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: expects CUDA tensors, got one on "
                             f"{t.device}")
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {dev} and {t.device}")
        if t.dtype != dtype or t.dtype not in DTYPE_CODES:
            raise ValueError(f"{what}: expects float32 or bfloat16 "
                             f"tensors of one dtype, got {t.dtype} "
                             f"beside {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: expects contiguous tensors")


def device_scalar(value, like: torch.Tensor, what: str,
                  name: str) -> torch.Tensor:
    """A step size as a one-element fp32 tensor on ``like``'s device.

    The solver passes 0-d device tensors, which go through untouched
    (the kernel reads them through a pointer, so the loop never syncs).
    A Python number is copied to the device here, for direct callers."""
    if isinstance(value, torch.Tensor):
        if value.numel() != 1 or value.dtype != torch.float32 \
                or value.device != like.device:
            raise ValueError(
                f"{what}: {name} must be a one-element float32 tensor on "
                f"{like.device}, got {tuple(value.shape)} {value.dtype} "
                f"on {value.device}")
        return value
    # a Python number here: a tensor returned above
    return torch.tensor(float(value),  # repro-lint: disable=RPL302
                        dtype=torch.float32, device=like.device)
