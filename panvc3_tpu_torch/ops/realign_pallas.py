"""The affine-gap DP fill from explicit substitution scores.

Counterpart of ``panvc3_tpu.ops.realign_pallas.fill_batch_pallas``, the
drop-in for ``realign_batch._fill_batch``.  ``fill_batch`` launches the
hand-written CUDA kernel (``csrc/realign_fill.cu``, C entry
``realign_fill_sub``) on CUDA tensors and runs the plain PyTorch
``_fill_batch`` on CPU tensors; on any other device it raises.  Both
return the trace ``uint8[B, Q+1, R+1]``, equal in every cell.
"""

from __future__ import annotations

import torch

from . import _kernels


def fill_batch(sub, m, n, go, ge, R: int, Q: int):
    """DP fill: ``sub`` f32 ``(B, Q, R)`` substitution scores (integers,
    exact in f32), ``m``/``n`` int32 ``(B,)`` query/ref lengths (rows
    past ``m`` stay 0, columns past ``n`` follow the plain fill's sentinel
    arithmetic), ``go``/``ge`` the gap costs in the scores' units."""
    B = sub.shape[0]
    dev = sub.device
    for name, t, dtype, shape in (
        ("sub", sub, torch.float32, (B, Q, R)),
        ("m", m, torch.int32, (B,)),
        ("n", n, torch.int32, (B,)),
    ):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"fill_batch: {name} must be {dtype} of shape {shape}, "
                f"got {t.dtype} {tuple(t.shape)}"
            )
        if t.device != dev:
            raise ValueError(f"fill_batch: {name} is on {t.device}, sub on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"fill_batch: {name} must be contiguous")
    if dev.type == "cpu":
        from .realign_batch import _fill_batch

        return _fill_batch(sub, m, n, go, ge, R, Q)
    if dev.type != "cuda":
        raise ValueError(f"fill_batch: unsupported device {dev}")
    trace = torch.empty((B, Q + 1, R + 1), dtype=torch.uint8, device=dev)
    if B == 0:
        return trace
    # each warp's previous DP row lives in shared memory where it fits,
    # else in this global scratch ([B, words])
    words = _kernels.kernel("realign_fill_scratch")(R)
    scratch = torch.empty((B, words), dtype=torch.float32, device=dev) if words else None
    with torch.cuda.device(dev):
        _kernels.launch(
            "realign_fill_sub",
            sub.data_ptr(), m.data_ptr(), n.data_ptr(),
            float(go), float(ge), B, R, Q,
            None if scratch is None else scratch.data_ptr(),
            trace.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    return trace
