"""dna5 normalisation on tensors (counterpart of
``panvc3_tpu.alphabet.dna5_normalise_device``)."""

from __future__ import annotations

import torch

_A, _C, _G, _T, _U, _N = (ord(c) for c in "ACGTUN")


def dna5_normalise_device(x: torch.Tensor) -> torch.Tensor:
    """Elementwise ``panvc3_tpu.alphabet.DNA5_NORMALISE`` on a uint8
    tensor: A/C/G/T in either case map to the upper-case letter, U/u to T,
    every other byte to N."""
    up = x & 0xDF
    up = torch.where(up == _U, torch.full_like(up, _T), up)
    is_acgt = (up == _A) | (up == _C) | (up == _G) | (up == _T)
    return torch.where(is_acgt, up, torch.full_like(up, _N))
