"""The fused realignment DP: fill and traceback of a batch of runs.

Counterpart of ``panvc3_tpu.ops.realign_pallas_fused.realign_fused_pallas``
in its integer scoring mode.  ``realign_fused`` launches the hand-written
CUDA kernel (``csrc/realign_fused.cu``) on CUDA tensors and runs the plain
PyTorch version, ``realign_fused_reference``, on CPU tensors; on any other
device it raises.  Both return ``(ops int8[B, R+Q], count int32[B])``,
byte-identical to the TPU kernel: the traceback's op codes in reverse,
127 past ``count``.
"""

from __future__ import annotations

import threading

import torch

from . import _kernels

#: launches of the CUDA kernel since the last reset (the main path's
#: evidence that it went through the kernel); read and reset by callers
LAUNCHES = 0
_launch_lock = threading.Lock()


def reset_launches() -> None:
    global LAUNCHES
    with _launch_lock:
        LAUNCHES = 0


def _check_inputs(ref, query, m, n, R, Q):
    B = ref.shape[0]
    for name, t, dtype, shape in (
        ("ref", ref, torch.uint8, (B, R)),
        ("query", query, torch.uint8, (B, Q)),
        ("m", m, torch.int32, (B,)),
        ("n", n, torch.int32, (B,)),
    ):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"realign_fused: {name} must be {dtype} of shape {shape}, "
                f"got {t.dtype} {tuple(t.shape)}"
            )
        if t.device != ref.device:
            raise ValueError(f"realign_fused: {name} is on {t.device}, ref on {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"realign_fused: {name} must be contiguous")


def realign_fused(ref, query, m, n, go, ge, R: int, Q: int, sub=None, qual=None):
    """Align each run: ``ref``/``query`` uint8 ``(B, R)``/``(B, Q)``,
    ``m``/``n`` int32 ``(B,)`` query/ref lengths, ``go``/``ge`` the gap
    open/extend costs (integral, so every score is exact in f32).
    Lengths are clamped to ``[0, Q]``/``[0, R]``."""
    if sub is not None or qual is not None:
        raise NotImplementedError(
            "realign_fused: only integer scoring is ported; the explicit "
            "substitution and pinned-quality (-q) modes are ROADMAP Queue 1 "
            "item 1"
        )
    _check_inputs(ref, query, m, n, R, Q)
    if ref.device.type == "cpu":
        return realign_fused_reference(ref, query, m, n, go, ge, R, Q)
    if ref.device.type != "cuda":
        raise ValueError(f"realign_fused: unsupported device {ref.device}")
    B = ref.shape[0]
    dev = ref.device
    ops = torch.empty((B, R + Q), dtype=torch.int8, device=dev)
    count = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return ops, count
    n_words = (R + 1 + 7) // 8
    best = torch.empty((R + 1, B), dtype=torch.float32, device=dev)
    vert = torch.empty((R + 1, B), dtype=torch.float32, device=dev)
    trace = torch.empty(((Q + 1) * n_words, B), dtype=torch.int32, device=dev)
    fn = _kernels.kernel("realign_fused_int")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            ref.data_ptr(), query.data_ptr(), m.data_ptr(), n.data_ptr(),
            float(go), float(ge), B, R, Q,
            best.data_ptr(), vert.data_ptr(), trace.data_ptr(),
            ops.data_ptr(), count.data_ptr(), stream,
        )
    _kernels.check(rc, "realign_fused_int")
    global LAUNCHES
    with _launch_lock:
        LAUNCHES += 1
    return ops, count


def realign_fused_reference(ref, query, m, n, go, ge, R: int, Q: int):
    """Plain PyTorch version: the batched fill and traceback scans of
    ``ops/realign_batch`` (any device)."""
    from .realign_batch import _fill_batch, _substitution_scores, _traceback_batch

    m = m.clamp(0, Q)
    n = n.clamp(0, R)
    sub = _substitution_scores(ref, query)
    trace = _fill_batch(sub, m, n, go, ge, R, Q)
    return _traceback_batch(trace, ref, query, m, n, R, Q)
