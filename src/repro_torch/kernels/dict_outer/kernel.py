"""Fused SCDL outer products — the CUDA kernel's wrappers.

The kernel (``csrc/dict_outer.cu``) replaces the Pallas
``dict_outer_fwd`` and ``dict_outer_pair_fwd``
(``repro/kernels/dict_outer/kernel.py``).  The TPU version walks K in
order, with every (P, A) and (A, A) accumulator resident in VMEM.  On
the card, blocks own 128 x 128 output tiles of all the products at once
and one slice of K each (split-K):

- the products run on the tensor cores (``mma.sync`` m16n8k8 TF32) at
  fp32 accuracy: each fp32 operand is split in registers into a TF32
  ``hi`` and a TF32 ``lo = x - hi``, and ``lo.hi + hi.lo + hi.hi`` are
  summed on the tensor cores (3xTF32); bf16 inputs are TF32 values
  already and take ``hi.hi`` alone;
- a Gram ``W^T W`` is symmetric, so only its upper-triangle tiles are
  computed, and the reduction pass writes each off-diagonal tile twice;
- operands stream through a ring of ``cp.async`` stages in shared
  memory, 16 aligned bytes a copy whatever the row's alignment (a row
  lands shifted by its offset from the 16-byte boundary), zero-filled
  past the ragged edges of K and of the outputs (no padding);
- each 16 rows of fp32 products go into a fresh tensor-core
  accumulator, whose sum is added to an fp32 accumulator with
  round-to-nearest (the tensor cores truncate as they add);
- partial tiles go to a scratch buffer and a second pass sums the slices
  in a fixed order, so the result is the same on every run.  No slice is
  longer than :data:`ACC_ROWS` rows.

The outputs are always fp32, as in the JAX contract.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common

# The longest slice of K one block sums.  The tensor cores add into their
# fp32 accumulator without rounding to nearest: over 40 000 rows of a sum
# of squares that drifts by about 1e-4 relative (a round-toward-zero
# emulation), over 2048 by about 5e-6 (tests/test_torch_dict_outer.py).
# The kernel's fp32 path sums only 16 rows in a tensor-core accumulator
# and adds each such sum to an fp32 one with round-to-nearest; its bf16
# path sums a whole slice in one.  The reduction pass adds the slices'
# sums with round-to-nearest.
ACC_ROWS = 2048


def _outer(what: str, pairs):
    """``[L_q^T R_q for (L_q, R_q) in pairs]`` in fp32, in one launch of
    the kernel (and one of its reduction pass)."""
    ts = [t for pair in pairs for t in pair]
    common.require_cuda(what, *ts)
    K, n = pairs[0][1].shape
    for L, R in pairs:
        if L.dim() != 2 or R.dim() != 2 or L.shape[0] != K or \
                tuple(R.shape) != (K, n):
            raise ValueError(f"{what}: expects (K, m) and (K, {n}) operands "
                             f"with one K = {K}, got {tuple(L.shape)} and "
                             f"{tuple(R.shape)}")
    if K == 0:
        raise ValueError(f"{what}: expects at least one sample row")
    # the kernel reads each row from the 16-byte boundary at or before it
    if any(t.untyped_storage().data_ptr() % 16 for t in ts):
        raise ValueError(f"{what}: expects tensors whose storage starts on "
                         f"a 16-byte boundary")
    dev = ts[0].device
    lib = common.library()
    count = len(pairs)
    ms = (ctypes.c_int * count)(*(L.shape[1] for L, _ in pairs))
    # a Gram (one tensor on both sides) computes its upper triangle only
    grams = (ctypes.c_int * count)(*(
        int(L.data_ptr() == R.data_ptr() and L.shape == R.shape)
        for L, R in pairs))
    # the library sizes the split of K and the scratch for its tiling
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, scratch = ctypes.c_int(), ctypes.c_longlong()
    common.check(lib.repro_dict_outer_plan(
        count, ctypes.addressof(ms), ctypes.addressof(grams), n, K, sms,
        ACC_ROWS, ctypes.byref(splits), ctypes.byref(scratch)), what)
    outs = [torch.empty((L.shape[1], n), dtype=torch.float32, device=dev)
            for L, _ in pairs]
    partials = torch.empty(scratch.value, dtype=torch.float32, device=dev)
    Ls = (ctypes.c_void_p * count)(*(L.data_ptr() for L, _ in pairs))
    Rs = (ctypes.c_void_p * count)(*(R.data_ptr() for _, R in pairs))
    Os = (ctypes.c_void_p * count)(*(o.data_ptr() for o in outs))
    err = lib.repro_dict_outer(
        count, ctypes.addressof(Ls), ctypes.addressof(Rs),
        ctypes.addressof(Os), ctypes.addressof(ms), ctypes.addressof(grams),
        n, K, splits.value, partials.data_ptr(), scratch.value,
        common.DTYPE_CODES[ts[0].dtype],
        common.stream_ptr(ts[0]))
    common.check(err, what)
    return outs


def dict_outer_fwd(S, W):
    """S: (K, P), W: (K, A) CUDA tensors of one dtype (fp32 or bf16),
    contiguous.  Returns (S^T W (P, A), W^T W (A, A)) in fp32."""
    sw, ww = _outer("dict_outer", [(S, W), (W, W)])
    dict_outer_fwd.launches += 1
    return sw, ww


def dict_outer_pair_fwd(Sh, Sl, Wh, Wl):
    """Sh (K, P), Sl (K, M), Wh/Wl (K, A) CUDA tensors of one dtype,
    contiguous.  Returns (Sh^T Wh (P, A), Sl^T Wl (M, A), Wh^T Wh,
    Wl^T Wl (A, A)) in fp32, all from one launch."""
    out = _outer("dict_outer_pair", [(Sh, Wh), (Sl, Wl), (Wh, Wh), (Wl, Wl)])
    dict_outer_pair_fwd.launches += 1
    return tuple(out)


dict_outer_fwd.launches = 0
dict_outer_pair_fwd.launches = 0
