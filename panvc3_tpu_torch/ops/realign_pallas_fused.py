"""The fused realignment DP: fill and traceback of a batch of runs.

Counterpart of ``panvc3_tpu.ops.realign_pallas_fused.realign_fused_pallas``
in its three scoring modes: integer (the default), pinned-quality Malde
(``qual=``) and explicit substitution scores (``sub=``).  ``realign_fused``
launches the hand-written CUDA kernel (``csrc/realign_fused.cu``, one C
entry per mode) on CUDA tensors and runs the plain PyTorch version,
``realign_fused_reference``, on CPU tensors; on any other device it
raises.  Both return ``(ops int8[B, R+Q], count int32[B])``, byte-identical
to the TPU kernel: the traceback's op codes in reverse, 127 past
``count``.  Launches are counted per C entry in ``_kernels.LAUNCHES``.
"""

from __future__ import annotations

import torch

from . import _kernels


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"realign_fused: {name} must be {dtype} of shape {tuple(shape)}, "
            f"got {t.dtype} {tuple(t.shape)}"
        )
    if t.device != device:
        raise ValueError(f"realign_fused: {name} is on {t.device}, ref on {device}")
    if not t.is_contiguous():
        raise ValueError(f"realign_fused: {name} must be contiguous")


def realign_fused(ref, query, m, n, go, ge, R: int, Q: int, sub=None, qual=None):
    """Align each run: ``ref``/``query`` uint8 ``(B, R)``/``(B, Q)``,
    ``m``/``n`` int32 ``(B,)`` query/ref lengths, ``go``/``ge`` the gap
    open/extend costs.  Every score must be an integer (exact in f32):
    integral gap costs in integer mode, gap costs x ``MALDE_SCALE`` in the
    two quality modes.  Lengths are clamped to ``[0, Q]``/``[0, R]``.

    ``qual=(qq, mrow, xrow)``: pinned-quality Malde scores, ``qq`` int32
    ``(B, Q)`` query phreds, ``mrow``/``xrow`` f32 ``(64,)`` the match and
    mismatch rows at the pinned reference quality; a phred outside 0..63
    scores 0.  ``sub``: f32 ``(B, Q, R)`` explicit scores, query i vs ref
    j.  The two are exclusive."""
    if sub is not None and qual is not None:
        raise ValueError("realign_fused: sub and qual are mutually exclusive")
    B = ref.shape[0]
    dev = ref.device
    _check("ref", ref, torch.uint8, (B, R), dev)
    _check("query", query, torch.uint8, (B, Q), dev)
    _check("m", m, torch.int32, (B,), dev)
    _check("n", n, torch.int32, (B,), dev)
    if sub is not None:
        _check("sub", sub, torch.float32, (B, Q, R), dev)
    if qual is not None:
        qq, mrow, xrow = qual
        _check("qq", qq, torch.int32, (B, Q), dev)
        _check("mrow", mrow, torch.float32, (64,), dev)
        _check("xrow", xrow, torch.float32, (64,), dev)
    if dev.type == "cpu":
        return realign_fused_reference(ref, query, m, n, go, ge, R, Q, sub=sub, qual=qual)
    if dev.type != "cuda":
        raise ValueError(f"realign_fused: unsupported device {dev}")
    ops = torch.empty((B, R + Q), dtype=torch.int8, device=dev)
    count = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return ops, count
    if sub is not None:
        name, mode, scores = "realign_fused_sub", 2, (sub.data_ptr(),)
    elif qual is not None:
        name, mode, scores = "realign_fused_qual", 1, tuple(t.data_ptr() for t in qual)
    else:
        name, mode, scores = "realign_fused_int", 0, ()
    # the runs' trace tiles live in shared memory where a block's fit, else
    # in this global scratch ([words, B])
    words = _kernels.kernel("realign_fused_scratch")(R, Q, mode)
    scratch = torch.empty((words, B), dtype=torch.int32, device=dev) if words else None
    with torch.cuda.device(dev):
        _kernels.launch(
            name,
            ref.data_ptr(), query.data_ptr(), m.data_ptr(), n.data_ptr(),
            *scores, float(go), float(ge), B, R, Q,
            None if scratch is None else scratch.data_ptr(),
            ops.data_ptr(), count.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    return ops, count


def realign_fused_reference(ref, query, m, n, go, ge, R: int, Q: int, sub=None, qual=None):
    """Plain PyTorch version: the substitution scores of the mode, then the
    batched fill and traceback scans of ``ops/realign_batch`` (any
    device)."""
    from .realign_batch import (
        _fill_batch,
        _qual_scores,
        _substitution_scores,
        _traceback_batch,
    )

    m = m.clamp(0, Q)
    n = n.clamp(0, R)
    if sub is None:
        sub = (
            _qual_scores(ref, query, *qual)
            if qual is not None
            else _substitution_scores(ref, query)
        )
    trace = _fill_batch(sub, m, n, go, ge, R, Q)
    return _traceback_batch(trace, ref, query, m, n, R, Q)
