"""PyTorch/CUDA port of ``repro`` for one NVIDIA Hopper card.

The JAX package ``repro`` stays the reference; this package mirrors its
layout (``kernels/``, ``imaging/``, ``core/``) so each module has an
obvious counterpart.  Its kernels are CUDA C++ written for ``sm_90a``
(``csrc/``), built with ``nvcc`` at first use and loaded with
``ctypes`` (``kernels/common.py``).

Device rule: every public entry point takes ``device=None``, which means
``"cuda"`` and raises when no card is present — nothing silently runs
on the CPU.  Tests pass ``device="cpu"``, where each kernel wrapper
takes its plain PyTorch version (the ``ref.py`` beside it) because the
tensor lies on the CPU.

The port covers every module of ``repro``: the three workloads of
``repro.problems`` (``problems.list()``): space-variant PSF deconvolution in sparse and
low-rank mode, ``solve("deconvolve", Y, psfs, cfg=SolverConfig(...))``
(``imaging/deconvolve.py``), sparse coupled dictionary learning for
super-resolution, ``solve("scdl", S_h, S_l, cfg=SCDLConfig(...))``
(``imaging/scdl.py``), and low-rank matrix completion,
``solve("lowrank", Y, M, cfg=CompletionConfig(...))``
(``imaging/lowrank.py``); around them the runtime checks, checkpoints,
``solve_many`` buckets, supervision (``resilience/``), serving
(``serve/``) and multi-device runs over ``torch.distributed``
(``mesh=``, ``launch/mesh.py``, ``parallel/``), the port's linter
(``lint/``), and the substrates the JAX package kept from its LM seed:
``configs/`` (``ModelConfig``), ``optim/`` (AdamW, ZeRO-1 specs,
``warmup_cosine``), ``parallel/sharding.py`` (partition specs and
per-rank placements) and ``data/`` (``lm_batch``, ``lm_loader``).
Their tests run on the CPU against ``repro``
(``tests/test_torch_substrates.py``, ``tests/test_torch_lm_data.py``).
Importing this package imports nothing heavy; ``repro_torch.core.problem.solve`` (or
``repro_torch.problems.solve``) is the entry point.
"""
