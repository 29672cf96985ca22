"""Device results on their way to the host."""

from __future__ import annotations

import numpy as np
import torch


class DeviceFetch:
    """Results of one dispatch on their way to the host.  On CUDA the
    copies into pinned host buffers are queued on the current stream right
    after the work that made them, followed by an event; ``get`` (on any
    thread) waits on the event.  On the CPU the tensors are the result."""

    def __init__(self, *tensors: torch.Tensor):
        self.event = None
        if tensors[0].device.type == "cuda":
            with torch.cuda.device(tensors[0].device):
                self.host = []
                for t in tensors:
                    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    h.copy_(t, non_blocking=True)
                    self.host.append(h)
                self.event = torch.cuda.Event()
                self.event.record()
        else:
            self.host = list(tensors)

    def get(self) -> list[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.host]
