"""The MSA coordinate index (copy of ``panvc3_tpu.msa_index``, trimmed to
what the port calls; it reads and writes the same ``.npz`` format).

Per chromosome, per sequence, a gap bitvector over the aligned (MSA
column) space with rank0/select0 support, giving

- unaligned -> aligned:    ``aligned_position(pos) = select0(1 + pos)``
- aligned   -> unaligned:  ``project_aligned_position(pos) = rank0(pos)``
- cross-sequence:          compose the two (``project_position``).

Serialisation uses a single ``.npz`` archive.  Entries are kept sorted by
id so lookups are binary searches.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .bitvec import GapBitVector
from .parallel.distributed import split_chromosomes

MAGIC = "panvc3_tpu-msa-index"
# v1: per-word int64 rank array; v2: two-level rank directory
# (int64 superblocks + uint16 relative blocks, see bitvec.GapBitVector)
FORMAT_VERSION = 2


@dataclass
class SequenceEntry:
    seq_id: str
    gaps: GapBitVector

    def aligned_position(self, pos):
        if isinstance(pos, (int, np.integer)):
            return self.gaps.select0(int(pos) + 1)  # scalar fast path
        return self.gaps.select0(np.asarray(pos, dtype=np.int64) + 1)

    def project_aligned_position(self, pos):
        return self.gaps.rank0(pos)

    def project_position(self, pos, dst: "SequenceEntry"):
        return dst.project_aligned_position(self.aligned_position(pos))

    @property
    def unaligned_length(self) -> int:
        return self.gaps.n_zeros

    @property
    def aligned_length(self) -> int:
        return self.gaps.n


@dataclass
class ChrEntry:
    chr_id: str
    sequence_entries: list[SequenceEntry] = field(default_factory=list)

    def sort(self) -> None:
        self.sequence_entries.sort(key=lambda e: e.seq_id)

    def find(self, seq_id: str) -> SequenceEntry | None:
        entries = self.sequence_entries
        lo, hi = 0, len(entries)
        while lo < hi:
            mid = (lo + hi) // 2
            if entries[mid].seq_id < seq_id:
                lo = mid + 1
            else:
                hi = mid
        if lo < len(entries) and entries[lo].seq_id == seq_id:
            return entries[lo]
        return None


class MsaIndex:
    def __init__(self) -> None:
        self.chr_entries: list[ChrEntry] = []

    def sort(self) -> None:
        self.chr_entries.sort(key=lambda e: e.chr_id)
        for e in self.chr_entries:
            e.sort()

    def find_chr(self, chr_id: str) -> ChrEntry | None:
        entries = self.chr_entries
        lo, hi = 0, len(entries)
        while lo < hi:
            mid = (lo + hi) // 2
            if entries[mid].chr_id < chr_id:
                lo = mid + 1
            else:
                hi = mid
        if lo < len(entries) and entries[lo].chr_id == chr_id:
            return entries[lo]
        return None

    def find(self, chr_id: str, seq_id: str) -> SequenceEntry | None:
        chrom = self.find_chr(chr_id)
        if chrom is None:
            return None
        return chrom.find(seq_id)

    def get_or_add_chr(self, chr_id: str) -> ChrEntry:
        chrom = self.find_chr(chr_id)
        if chrom is None:
            chrom = ChrEntry(chr_id)
            self.chr_entries.append(chrom)
            self.chr_entries.sort(key=lambda e: e.chr_id)
        return chrom

    # -- serialisation -----------------------------------------------------

    def save(self, path: str) -> None:
        arrays: dict[str, np.ndarray] = {
            "__magic__": np.frombuffer(MAGIC.encode(), dtype=np.uint8),
            "__version__": np.array([FORMAT_VERSION], dtype=np.int64),
        }
        names: list[str] = []
        for ci, chrom in enumerate(self.chr_entries):
            for si, entry in enumerate(chrom.sequence_entries):
                key = f"e{ci}_{si}"
                names.append(f"{chrom.chr_id}\t{entry.seq_id}\t{key}")
                st = entry.gaps.state()
                arrays[f"{key}_words"] = st["words"]
                arrays[f"{key}_n"] = np.array([st["n"]], dtype=np.int64)
                arrays[f"{key}_sb"] = st["sb_rank0"]
                arrays[f"{key}_rel"] = st["rel_rank0"]
        arrays["__names__"] = np.frombuffer("\n".join(names).encode(), dtype=np.uint8)
        # np.load-compatible zip of .npy members, but deflate level 1:
        # savez_compressed's level-6 zlib dominates genome-scale build time
        # (~4x slower) for a few percent of size
        import zipfile
        from numpy.lib import format as npformat

        with open(path, "wb") as fh:
            with zipfile.ZipFile(
                fh, "w", zipfile.ZIP_DEFLATED, compresslevel=1
            ) as zf:
                for name, arr in arrays.items():
                    with zf.open(name + ".npy", "w", force_zip64=True) as ef:
                        npformat.write_array(
                            ef, np.asanyarray(arr), allow_pickle=False
                        )

    @classmethod
    def load(
        cls,
        path: str,
        chr_ids: "set[str] | None" = None,
        shard: "tuple[int, int] | None" = None,
    ) -> "MsaIndex":
        """Load the index, optionally restricted to a chromosome subset.

        ``chr_ids`` keeps only the named chromosomes; ``shard=(k, n)``
        keeps shard k of a deterministic round-robin assignment of the
        sorted chromosome ids over n hosts (``split_chromosomes``).
        Bitvector arrays of skipped chromosomes are never deserialised
        (np.load is lazy per key), so per-host memory scales with the shard.
        """
        if shard is not None:
            k, n = shard
            all_ids = cls.chromosome_ids(path)
            chr_ids = set(split_chromosomes(all_ids, n)[k])
        with np.load(path) as data:
            magic = bytes(data["__magic__"]).decode()
            if magic != MAGIC:
                raise ValueError(f"{path}: not a panvc3_tpu MSA index")
            version = int(data["__version__"][0])
            if version > FORMAT_VERSION:
                raise ValueError(f"{path}: unsupported index version {version}")
            idx = cls()
            names_blob = bytes(data["__names__"]).decode()
            chrom_map: dict[str, ChrEntry] = {}
            if names_blob:
                for line in names_blob.split("\n"):
                    chr_id, seq_id, key = line.split("\t")
                    if chr_ids is not None and chr_id not in chr_ids:
                        continue
                    if version >= 2:
                        gv = GapBitVector.from_state(
                            data[f"{key}_words"],
                            int(data[f"{key}_n"][0]),
                            data[f"{key}_sb"],
                            data[f"{key}_rel"],
                        )
                    else:
                        # v1 stored a per-word rank array; rebuild the
                        # two-level directory from the words instead
                        gv = GapBitVector.from_state(
                            data[f"{key}_words"], int(data[f"{key}_n"][0])
                        )
                    chrom = chrom_map.get(chr_id)
                    if chrom is None:
                        chrom = ChrEntry(chr_id)
                        chrom_map[chr_id] = chrom
                        idx.chr_entries.append(chrom)
                    chrom.sequence_entries.append(SequenceEntry(seq_id, gv))
            idx.sort()
            return idx

    @staticmethod
    def chromosome_ids(path: str) -> list[str]:
        """The sorted chromosome ids of a saved index, without
        deserialising any bitvectors."""
        with np.load(path) as data:
            magic = bytes(data["__magic__"]).decode()
            if magic != MAGIC:
                raise ValueError(f"{path}: not a panvc3_tpu MSA index")
            names_blob = bytes(data["__names__"]).decode()
        ids: list[str] = []
        if names_blob:
            for line in names_blob.split("\n"):
                chr_id = line.split("\t", 1)[0]
                if chr_id not in ids:
                    ids.append(chr_id)
        return sorted(ids)


def make_sequence_entry_pair(src_aligned: str, dst_aligned: str) -> tuple[SequenceEntry, SequenceEntry]:
    """Test helper: the two entries of a pairwise alignment given as
    gapped strings."""
    if len(src_aligned) != len(dst_aligned):
        raise ValueError("aligned sequences must have equal length")
    return (
        SequenceEntry("", GapBitVector.from_gap_string(src_aligned)),
        SequenceEntry("", GapBitVector.from_gap_string(dst_aligned)),
    )
