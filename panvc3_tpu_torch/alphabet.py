"""Sequence and quality alphabets: the dna5 table and its tensor form, and
the phred42 decode (copy of ``panvc3_tpu.alphabet``, trimmed to what the
port calls)."""

from __future__ import annotations

import numpy as np
import torch

# -- dna5 -------------------------------------------------------------------
# seqan3::dna5 char semantics: A/C/G/T (U->T) upper or lower case map to the
# upper-case letter; everything else maps to 'N'.
DNA5_NORMALISE = np.full(256, ord("N"), dtype=np.uint8)
for _c in "ACGT":
    DNA5_NORMALISE[ord(_c)] = ord(_c)
    DNA5_NORMALISE[ord(_c.lower())] = ord(_c)
DNA5_NORMALISE[ord("U")] = ord("T")
DNA5_NORMALISE[ord("u")] = ord("T")

_A, _C, _G, _T, _U, _N = (ord(c) for c in "ACGTUN")


def normalise_dna5(seq: str | bytes) -> bytes:
    """Normalise a sequence to dna5 characters (A/C/G/T/N)."""
    if isinstance(seq, str):
        seq = seq.encode("latin1")
    arr = np.frombuffer(seq, dtype=np.uint8)
    return DNA5_NORMALISE[arr].tobytes()


def dna5_normalise_device(x: torch.Tensor) -> torch.Tensor:
    """Elementwise ``DNA5_NORMALISE`` on a uint8 tensor: A/C/G/T in either
    case map to the upper-case letter, U/u to T, every other byte to N."""
    up = x & 0xDF
    up = torch.where(up == _U, torch.full_like(up, _T), up)
    is_acgt = (up == _A) | (up == _C) | (up == _G) | (up == _T)
    return torch.where(is_acgt, up, torch.full_like(up, _N))


# -- phred ------------------------------------------------------------------
PHRED42_MAX = 41  # seqan3::phred42 stores phred scores 0..41
PHRED_OFFSET = 33  # SAM QUAL encoding offset


def decode_phred42(qual: str | bytes) -> np.ndarray:
    """Decode a SAM QUAL string into phred42 values (clamped to 0..41)."""
    if isinstance(qual, str):
        qual = qual.encode("latin1")
    arr = np.frombuffer(qual, dtype=np.uint8).astype(np.int32) - PHRED_OFFSET
    return np.clip(arr, 0, PHRED42_MAX)


# -- dna11 ------------------------------------------------------------------
# The 11-letter alphabet of variant-support counting: {A,C,G,N,T}, their
# lower-case soft-clipped variants and '~', the deletion marker.
DNA11_CHARS = "ACGNTacgnt~"


def dna11_complement(c: str) -> str:
    comp = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N",
            "a": "t", "c": "g", "g": "c", "t": "a", "n": "n", "~": "~"}
    return comp[c]
