"""The split route's traceback: the ops of each run from its DP trace.

Counterpart of ``panvc3_tpu.ops.realign_batch._traceback_batch`` (an XLA
``lax.scan`` in the JAX package, not a Pallas kernel), run after the fill
(``realign_pallas.fill_batch``).  ``traceback_batch`` launches the
hand-written CUDA kernel (``csrc/realign_traceback.cu``, C entry
``realign_traceback``) on CUDA tensors and runs the plain PyTorch
``realign_batch._traceback_batch`` on CPU tensors; on any other device it
raises.  Both return ``(ops int8[B, R+Q], count int32[B])``, equal in every
element: op k emitted at step k of the walk (the CIGAR reversed), 127 from
the step that finds the walk at (0, 0).  ``traceback_plan`` reads the
kernel's plan for a shape (its schedule, runs per group, walking warps).
"""

from __future__ import annotations

import ctypes

import torch

from . import _kernels


def traceback_batch(trace, ref, query, m, n, R: int, Q: int):
    """Traceback from (m, n): ``trace`` uint8 ``(B, Q+1, R+1)`` as the fill
    writes it, ``ref``/``query`` uint8 ``(B, R)``/``(B, Q)``, ``m``/``n``
    int32 ``(B,)`` query/ref lengths (``0 <= m <= Q``, ``0 <= n <= R``)."""
    B = trace.shape[0]
    dev = trace.device
    for name, t, dtype, shape in (
        ("trace", trace, torch.uint8, (B, Q + 1, R + 1)),
        ("ref", ref, torch.uint8, (B, R)),
        ("query", query, torch.uint8, (B, Q)),
        ("m", m, torch.int32, (B,)),
        ("n", n, torch.int32, (B,)),
    ):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"traceback_batch: {name} must be {dtype} of shape {shape}, "
                f"got {t.dtype} {tuple(t.shape)}"
            )
        if t.device != dev:
            raise ValueError(f"traceback_batch: {name} is on {t.device}, trace on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"traceback_batch: {name} must be contiguous")
    if dev.type == "cpu":
        from .realign_batch import _traceback_batch

        return _traceback_batch(trace, ref, query, m, n, R, Q)
    if dev.type != "cuda":
        raise ValueError(f"traceback_batch: unsupported device {dev}")
    ops = torch.empty((B, R + Q), dtype=torch.int8, device=dev)
    count = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return ops, count
    with torch.cuda.device(dev):
        _kernels.launch(
            "realign_traceback",
            trace.data_ptr(), ref.data_ptr(), query.data_ptr(),
            m.data_ptr(), n.data_ptr(), B, R, Q,
            ops.data_ptr(), count.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    return ops, count


#: the fields of ``traceback_plan``, in the C helper's order
PLAN_FIELDS = ("shared", "runs", "warps", "smem_bytes", "blocks", "threads")


def traceback_plan(B: int, R: int, Q: int, device="cuda") -> dict:
    """The plan the kernel takes for ``B`` runs of ``(Q+1, R+1)`` on the
    card ``device``: ``shared`` 1 for the shared-memory schedule (0: the
    global one), its runs per group, walking warps per block (each with a
    buffer of its own in the ring) and shared bytes per block, then blocks
    and threads per block.  Launches nothing."""
    out = (ctypes.c_int * len(PLAN_FIELDS))()
    with torch.cuda.device(torch.device(device)):
        rc = _kernels.kernel("realign_traceback_plan")(B, R, Q, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"realign_traceback_plan failed: cudaError {rc}")
    return dict(zip(PLAN_FIELDS, out))
