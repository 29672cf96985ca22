"""The generators repeat by seed, give every seed the same work, take
their numbers from the source's test data, place reads as bowtie2's rules
say, and the BAM a call reads holds the pool's passes."""

from __future__ import annotations

import bz2
import gzip
import struct

import numpy as np
import pytest
from conftest import BENCH, ROOT, TINY_COLUMNS, TINY_POOL

from harness import bam, msa, traffic
from harness.inputs import fasta_lines, sample_positions

SEEDS = (7, 2**31 + 11)
CONFIGS = ("grch38_chr21_f4", "grch38_chr21_f3")
MIX = "test_workflow_pairs"
DATA = ROOT / "workflows" / "test-workflow" / "data"


def tiny(real_spec, config_name: str, seed: int):
    config = dict(real_spec.config(config_name), msa_columns=TINY_COLUMNS)
    mix = dict(real_spec.traffic(MIX), pool_records=TINY_POOL)
    made = msa.Msa(seed, config, BENCH / "configs")
    rows = traffic.Rows(made)
    pool = traffic.make_pool(seed, mix, rows, int(config["aligner_k"]), BENCH / "traffic")
    return config, mix, made, rows, pool


@pytest.mark.parametrize("config_name", CONFIGS)
@pytest.mark.parametrize("seed", SEEDS)
def test_pool_repeats_by_seed(real_spec, config_name, seed):
    *_, made_a, _, a = tiny(real_spec, config_name, seed)
    *_, made_b, _, b = tiny(real_spec, config_name, seed)
    assert np.array_equal(made_a.aligned_row(1), made_b.aligned_row(1))
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("config_name", CONFIGS)
def test_seeds_change_places_not_work(real_spec, config_name):
    """Two seeds: other bases and places; the same number of records, and
    the same segments of the pattern, so each row's gap columns and other
    bases in the same numbers."""
    (config, _, made_a, _, a), (_, _, made_b, _, b) = (tiny(real_spec, config_name, s) for s in SEEDS)
    assert not np.array_equal(made_a.aligned_row(0), made_b.aligned_row(0))
    assert not np.array_equal(made_a.source, made_b.source)
    assert np.array_equal(np.sort(made_a.source), np.sort(made_b.source))
    assert len(a["row"]) == len(b["row"]) == TINY_POOL
    secondary = [float((p["flag"] & traffic.FLAG_SECONDARY > 0).mean()) for p in (a, b)]
    assert abs(secondary[0] - secondary[1]) < 0.05


def test_pattern_is_the_test_workflow_msa():
    """The pattern file holds the source's founder MSA rows as its
    ``index-input`` gives them."""
    pattern = dict(line.split("\t") for line in
                   (BENCH / "configs" / "test_workflow_msa.txt").read_text().splitlines())
    for line in (DATA / "index-input" / "input.tsv").read_text().splitlines():
        _, sid, rel = line.split("\t")
        assert pattern[sid] == bz2.open(DATA / "index-input" / rel.split("index-input/")[1]).read().decode().strip()


@pytest.mark.parametrize("config_name", CONFIGS)
def test_msa_keeps_the_pattern_shape(real_spec, config_name):
    """Each row's share of gap columns and of other bases is the
    pattern's, to a few in a thousand."""
    _, _, made, _, _ = tiny(real_spec, config_name, SEEDS[0])
    shape = made.shape
    for r in range(made.n_rows):
        assert abs(made.gap(r).mean() - (shape[r] == msa.GAP_CODE).mean()) < 0.005
        other = (shape[r][made.source] % msa.GAP_CODE > 0).mean()
        assert abs(other - (shape[r] % msa.GAP_CODE > 0).mean()) < 0.005
    starts, lengths = msa.segments(shape)
    quiet = ~shape.any(axis=0)
    assert quiet[starts[1:]].all() and quiet[starts[1:] - 1].all()


def simulator_truth():
    """(fragment lengths, sequencing errors per read) of the test reads'
    mapped records, as the simulator wrote them in ``alignment.bam``."""
    data = gzip.open(DATA / "reads" / "alignment.bam").read()
    p = 8 + struct.unpack_from("<i", data, 4)[0]
    for _ in range(struct.unpack_from("<i", data, p)[0]):
        p += 4
        p += 4 + struct.unpack_from("<i", data, p)[0]
    p += 4
    fragments, errors = [], {}
    while p < len(data):
        size = struct.unpack_from("<i", data, p)[0]
        rec = data[p + 4:p + 4 + size]
        p += 4 + size
        _, _, l_name, _, _, n_cig, flag, l_seq, _, _, tlen = struct.unpack_from("<iiBBHHHiiii", rec)
        if flag & 0x4:
            continue
        if tlen > 0:
            fragments.append(tlen)
        xe = str(bam_tags(rec, 32 + l_name + 4 * n_cig + (l_seq + 1) // 2 + l_seq)["XE"])
        errors[xe] = errors.get(xe, 0) + 1
    return fragments, errors


def bam_tags(rec: bytes, at: int) -> dict:
    """The integer and string tags of one BAM record, from offset ``at``."""
    sizes = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i", "I": "<I", "A": "<c"}
    out = {}
    while at < len(rec):
        name, typ = rec[at:at + 2].decode(), chr(rec[at + 2])
        at += 3
        if typ == "Z":
            end = rec.index(b"\0", at)
            out[name], at = rec[at:end].decode(), end + 1
        else:
            out[name] = struct.unpack_from(sizes[typ], rec, at)[0]
            at += struct.calcsize(sizes[typ])
    return out


def test_traffic_numbers_are_the_test_reads(real_spec):
    mix = real_spec.traffic(MIX)
    fragments, errors = simulator_truth()
    assert mix["fragment_lengths"] == fragments
    assert mix["errors_per_read"] == dict(sorted(errors.items()))
    quals = []
    for side in ("left", "right"):
        lines = gzip.open(DATA / "reads" / f"{side}.fq.gz").read().decode().splitlines()
        assert {len(s) for s in lines[1::4]} == {mix["read_length"]}
        quals += lines[3::4]
    assert (BENCH / "traffic" / mix["qualities"]).read_text().splitlines() == quals


@pytest.mark.parametrize("config_name", CONFIGS)
@pytest.mark.parametrize("seed", SEEDS)
def test_placements_follow_bowtie2(real_spec, config_name, seed):
    """Each record is its read's alignment on its row: the bases of its M
    operations are the row's but for ``XM`` of them, its score is what
    bowtie2's defaults give and at least its minimum; each pair is placed
    on at most k rows, the first primary; YS is the mate's AS and XS the
    best of the read's other placements."""
    config, mix, made, rows, pool = tiny(real_spec, config_name, seed)
    length = mix["read_length"]
    assert (((pool["ops"] != traffic.D) * pool["counts"]).sum(axis=1) == length).all()
    for i in range(0, len(pool["row"]), 7):
        r, pos = int(pool["row"][i]), int(pool["pos"][i])
        stripped = made.stripped_row(r)
        q = k = mism = penalty = 0
        for op, count in zip(pool["ops"][i].tolist(), pool["counts"][i].tolist()):
            if not count:
                continue
            if op == traffic.M:
                got, want = pool["seq"][i, q:q + count], stripped[pos + k:pos + k + count]
                bad = got != want
                mism += int(bad.sum())
                phred = np.minimum(pool["qual"][i, q:q + count].astype(int) - 33, 40)
                penalty += int((2 + np.floor(4 * phred / 40 + 0.5))[bad].sum())
                q, k = q + count, k + count
            else:
                penalty += 5 + 3 * count
                q, k = (q + count, k) if op == traffic.I else (q, k + count)
        assert mism == pool["XM"][i] and -penalty == pool["AS"][i] >= -0.6 - 0.6 * length
        assert k == pool["span"][i]
    by_pair: dict[int, list[int]] = {}
    for i, pair in enumerate(pool["pair"].tolist()):
        by_pair.setdefault(pair, []).append(i)
    last = max(by_pair)
    for pair, idx in by_pair.items():
        flags = pool["flag"][idx]
        primary = idx if pair == last else [i for i in idx if not flags[idx.index(i)] & traffic.FLAG_SECONDARY]
        assert len(idx) <= 2 * config["aligner_k"] and len(idx) % 2 == 0
        assert len(primary) == 2 or pair == last
        for i in idx:
            mate = [j for j in idx if j != i and pool["row"][j] == pool["row"][i]]
            assert len(mate) == 1 and pool["YS"][i] == pool["AS"][mate[0]]
            assert pool["mate_pos"][i] == pool["pos"][mate[0]] and pool["tlen"][i] == -pool["tlen"][mate[0]]
            others = [j for j in idx if pool["row"][j] != pool["row"][i]
                      and (pool["flag"][j] & 0xC0) == (pool["flag"][i] & 0xC0)]
            if others and pair != last:
                assert pool["has_XS"][i] and pool["XS"][i] == max(pool["AS"][j] for j in others)


def test_repeated_pool_bam_reads_back_as_passes(real_spec, tmp_path):
    """The BAM a call reads holds the pool's records, 8 passes over, as
    the port's reader reads them."""
    from panvc3_tpu_torch.io.sam import SamReader

    config, mix, made, rows, pool = tiny(real_spec, "grch38_chr21_f4", SEEDS[1])
    names = [f"chr21/{s}" for s in made.ids]
    lengths = rows.lengths.tolist()
    text = "@HD\tVN:1.6\n" + "".join(f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in zip(names, lengths))
    head = bam.header_bytes(text, list(zip(names, lengths)))
    path = tmp_path / "pool.bam"
    bam.write_bam(path, head, bam.encode_records(pool, mix["mapq"]), 8)
    reader = SamReader(str(path))
    got = [line.decode().rstrip("\n") for block in reader.raw_record_line_blocks() for line in block]
    reader.close()
    assert reader.header.ref_names == names
    assert got == sam_lines(pool, names, mix["mapq"]) * 8


def sam_lines(pool: dict, names: list[str], mapq: int) -> list[str]:
    """The SAM text of the pool's records, written here without the BAM:
    what a reader of the BAM has to print."""
    width = len(str(int(pool["pair"].max())))
    out = []
    for i in range(len(pool["row"])):
        tags = [f"AS:i:{int(pool['AS'][i])}"]
        if pool["has_XS"][i]:
            tags.append(f"XS:i:{int(pool['XS'][i])}")
        tags += ["XN:i:0"] + [f"{k}:i:{int(pool[k][i])}" for k in ("XM", "XO", "XG", "NM", "YS")]
        out.append("\t".join([
            f"p{int(pool['pair'][i]):0{width}d}", str(int(pool["flag"][i])), names[int(pool["row"][i])],
            str(int(pool["pos"][i]) + 1), str(mapq),
            "".join(f"{c}{chr(traffic.OPS[o])}" for o, c in zip(pool["ops"][i], pool["counts"][i]) if c),
            "=", str(int(pool["mate_pos"][i]) + 1), str(int(pool["tlen"][i])),
            pool["seq"][i].tobytes().decode(), pool["qual"][i].tobytes().decode(), *tags, "YT:Z:CP",
        ]))
    return out


@pytest.mark.parametrize("width", [60, 7])
def test_fasta_lines(width):
    seq = np.frombuffer(b"ACGTTGCA" * 31, np.uint8)
    text = fasta_lines("chr21", seq, width).decode().split("\n")
    assert text[0] == ">chr21" and text[-1] == ""
    assert all(len(line) == width for line in text[1:-2])
    assert "".join(text[1:]) == seq.tobytes().decode()


@pytest.mark.parametrize("seed", SEEDS)
def test_sample_holds_the_realigned_and_both_ends(real_spec, seed):
    *_, pool = tiny(real_spec, "grch38_chr21_f3", seed)
    n = TINY_POOL * 8
    sample = sample_positions(seed, pool, n)
    assert np.array_equal(sample, sample_positions(seed, pool, n))
    assert sample[0] == 0 and sample[-1] == n - 1 and np.all(np.diff(sample) > 0)
    realigned = np.flatnonzero(pool["realigns"])
    assert 0 < len(realigned) < 2048
    assert set(realigned.tolist()) <= set((sample % TINY_POOL).tolist())


@pytest.mark.parametrize("config_name", CONFIGS)
def test_realigns_is_what_the_reference_realigns(real_spec, config_name):
    """The generator's mark of the records whose projection holds a run to
    realign agrees, record by record, with the plain reference's walk."""
    from reference import project_alignments as ref

    config, mix, *_ = tiny(real_spec, config_name, SEEDS[1])
    inputs = ref.Inputs(SEEDS[1], config, mix, np.arange(TINY_POOL), BENCH)
    p = inputs.pool
    walked = []
    for i in range(TINY_POOL):
        cigar = [(int(c), chr(traffic.OPS[o])) for o, c in zip(p["ops"][i].tolist(), p["counts"][i].tolist()) if c]
        ops = ref.rewrite(cigar, p["seq"][i].tobytes(), inputs.ref_seq, inputs.excess[i], inputs.ref_gap[i])
        walked.append(bool(ref.indel_runs(ops, int(inputs.excess[i, 0]))))
    assert np.array_equal(np.array(walked), p["realigns"]) and any(walked)
