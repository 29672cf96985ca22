"""Device results on their way to the host."""

from __future__ import annotations

import numpy as np
import torch


class DeviceFetch:
    """Results of one dispatch on their way to the host.  A result is a
    tensor, or a list of tensors (the shards of a mesh, on one device or
    several) that ``get`` joins along the first dimension in list order.
    On CUDA each tensor's copy into a pinned host buffer is queued on its
    device's current stream right after the work that made it, and one
    event per device follows its copies; ``get`` (on any thread) waits on
    every event.  A tensor on the CPU is its own result."""

    def __init__(self, *results):
        self.parts = []
        self.events = {}
        for res in results:
            pieces = res if isinstance(res, (list, tuple)) else (res,)
            hosts = []
            for t in pieces:
                if t.device.type == "cuda":
                    with torch.cuda.device(t.device):
                        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                        h.copy_(t, non_blocking=True)
                    self.events[t.device] = None
                else:
                    h = t
                hosts.append(h)
            self.parts.append((isinstance(res, (list, tuple)), hosts))
        for dev in self.events:
            with torch.cuda.device(dev):
                self.events[dev] = torch.cuda.Event()
                self.events[dev].record()

    def get(self) -> list[np.ndarray]:
        for event in self.events.values():
            event.synchronize()
        return [
            np.concatenate([h.numpy() for h in hosts]) if joined else hosts[0].numpy()
            for joined, hosts in self.parts
        ]
