"""The port's junction rescue (hichap_master_tpu_torch.pipeline.rescue)
against the JAX package's (hichap_master_tpu/pipeline/rescue.py), the port
on the CPU; and the front of the pipeline as a whole.

The rescue FASTQs are text, so they compare byte for byte.  Sources: the
JAX package's FakeAligner ``Global_bams`` (the steps of
tests/test_pipeline_e2e.py) as SAM, gzipped SAM and BAM (``--bam-format``)
with 1 and 3 threads; reads crafted for the search's traps (non-overlapping
counting: ``GATCGATCGATC`` is one site; case kept; the minus junction only
where the plus search found nothing, for a non-palindromic junction; flanks
shorter than 10; a QUAL of another length than SEQ, ``*``; BAM's missing
QUAL and empty SEQ; text outside ASCII); and the port's alignment draw with
its planted junctions (``alignment_chunks(junctions=True)``).  The QUAL
column that the port's readers give on request is held to the JAX
package's ``AlnRecord.qual``.

The chain test runs the front through the port (``rebuildG``,
``rebuildF``), the JAX package's FakeAligner mapping on the port's
FASTAs, the port's ``Rescue``, the JAX package's re-mapping and the port's
``bamProcess``; its chunk beds equal the all-JAX chain's byte for byte."""

import gzip
import os

import numpy as np
import pytest
import torch

from hichap_master_tpu.io.bam import read_bam as j_read_bam
from hichap_master_tpu.io.bam import write_bam as j_write_bam
from hichap_master_tpu.io.sam import AlnRecord
from hichap_master_tpu.io.sam import read_sam as j_read_sam
from hichap_master_tpu.io.sam import write_sam as j_write_sam
from hichap_master_tpu.pipeline import bam_process as JBP
from hichap_master_tpu.pipeline import chunking as JC
from hichap_master_tpu.pipeline import genome_rebuild as JG
from hichap_master_tpu.pipeline import rescue as JR
from hichap_master_tpu.pipeline.enzyme import enzyme_handle, junction_info
from hichap_master_tpu.pipeline.mapping import (FakeAligner, ws_mapping,
                                                ws_rescue_mapping)
from hichap_master_tpu.testing.synthetic import diploid_dataset
from hichap_master_tpu_torch.io.bam import read_bam
from hichap_master_tpu_torch.io.sam import read_sam
from hichap_master_tpu_torch.pipeline import bam_process as PBP
from hichap_master_tpu_torch.pipeline import chunking as PC
from hichap_master_tpu_torch.pipeline import genome_rebuild as PG
from hichap_master_tpu_torch.pipeline import rescue as PR
from hichap_master_tpu_torch.testing.synthetic import alignment_chunks

torch.set_num_threads(1)
CPU = torch.device("cpu")
READ_LEN = 40


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """The JAX package's FakeAligner chain up to Global_bams, as SAM, as
    gzipped SAM and as BAM."""
    ws = tmp_path_factory.mktemp("rescue_ws")
    data = diploid_dataset(np.random.default_rng(11), str(ws / "data"),
                           n_pairs=300, n_snps=50, read_len=READ_LEN,
                           junction_frac=0.4)
    g = ws / "genome"
    g.mkdir()
    npz = JG.snps_integration(data["snps"], str(g))
    out = JG.rebuild_genome(data["fasta"], npz, "MboI", str(g))
    JC.split_reads(data["fq1"], str(ws / "fq"), 120, 1)
    JC.split_reads(data["fq2"], str(ws / "fq"), 120, 2)
    idx = [out["Maternal"], out["Paternal"]]
    for fmt in ("sam", "bam"):
        ws_mapping(str(ws / "fq"), str(ws / f"gb_{fmt}"), idx,
                   aligner=FakeAligner(), jobs=1, out_format=fmt)
    (ws / "gb_samgz").mkdir()
    for f in os.listdir(ws / "gb_sam"):
        with gzip.open(ws / "gb_samgz" / (f + ".gz"), "wb") as fh:
            fh.write((ws / "gb_sam" / f).read_bytes())
    return ws


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("src", ["gb_sam", "gb_samgz", "gb_bam"])
def test_rescue_of_fake_aligner_chunks_as_in_the_jax_package(
        workspace, tmp_path, src, threads):
    paths_j = JR.cutting_reads_to_remapping(str(workspace / src),
                                            str(tmp_path / "j"), "MboI",
                                            threads=threads)
    walls = {}
    paths_p = PR.cutting_reads_to_remapping(str(workspace / src),
                                            str(tmp_path / "p"), "MboI",
                                            threads=threads, device=CPU,
                                            walls=walls)
    assert [os.path.basename(p) for p in paths_p] == [
        os.path.basename(p) for p in paths_j]
    want, got = _files(tmp_path / "j"), _files(tmp_path / "p")
    assert got == want
    assert len(want) == 12 and sum(v.count(b"\n") for v in want.values())
    name = sorted(os.listdir(workspace / src))[0]
    assert {f"{name}.read", f"{name}.scan", f"{name}.write"} <= set(walls)


@pytest.mark.parametrize("src", ["gb_sam", "gb_samgz", "gb_bam"])
def test_the_qual_column_is_the_jax_package_qual(workspace, src):
    for f in sorted(os.listdir(workspace / src))[:4]:
        path = str(workspace / src / f)
        want = list(j_read_bam(path) if f.endswith(".bam")
                    else j_read_sam(path))
        got = (read_bam if f.endswith(".bam") else read_sam)(path, qual=True)
        assert [got.qual(r).decode() for r in range(len(got))] == [
            r.qual for r in want]
        plain = (read_bam if f.endswith(".bam") else read_sam)(path)
        assert plain.quals is None and plain.qual_off is None


def _records(rows):
    return [AlnRecord(name, flag, None if flag & 4 else "chr1",
                      -1 if flag & 4 else 5, 0, seq, qual)
            for name, flag, seq, qual in rows]


JUNC = "GATCGATC"
READS = [
    ("one_site", 4, "A" * 12 + JUNC + "C" * 12, "I" * 32),
    ("overlapping", 4, "A" * 12 + "GATCGATCGATC" + "C" * 12, "J" * 36),
    ("two_sites", 4, "A" * 12 + JUNC + "TT" + JUNC + "C" * 12, "I" * 42),
    ("lowercase", 4, "A" * 12 + "gatcgatc" + "C" * 12, "I" * 32),
    ("left_short", 4, "A" * 9 + JUNC + "C" * 15, "#" * 32),
    ("right_short", 4, "A" * 15 + JUNC + "C" * 9, "#" * 32),
    ("both_short", 4, "A" * 3 + JUNC + "C" * 3, "I" * 14),
    ("at_start", 4, JUNC + "C" * 20, "I" * 28),
    ("at_end", 4, "C" * 20 + JUNC, "I" * 28),
    ("star_qual", 4, "A" * 12 + JUNC + "C" * 12, "*"),
    ("short_qual", 4, "A" * 12 + JUNC + "C" * 12, "I" * 15),
    ("long_qual", 4, "A" * 12 + JUNC + "C" * 12, "I" * 40),
    ("mapped", 0, "A" * 12 + JUNC + "C" * 12, "I" * 32),
    ("none", 4, "ACGT" * 8, "I" * 32),
    ("star_seq", 4, "*", "*"),
    ("short_read", 4, "GATC", "IIII"),
]


@pytest.mark.parametrize("fmt", ["sam", "bam"])
def test_crafted_reads_are_rescued_as_in_the_jax_package(tmp_path, fmt):
    rows = [r for r in READS if not (fmt == "bam" and r[0] in (
        "star_qual", "short_qual", "long_qual", "star_seq"))]
    path = str(tmp_path / f"c_chunk0_1.{fmt}")
    if fmt == "sam":
        j_write_sam(path, _records(rows))
    else:
        j_write_bam(path, _records(rows), {"chr1": 1000})
    junc = junction_info(*enzyme_handle("MboI"))
    nj = JR.rescue_sam(path, str(tmp_path / "j.fq"), junc)
    np_ = PR.rescue_sam(path, str(tmp_path / "p.fq"), junc, device=CPU)
    assert np_ == nj
    assert (tmp_path / "p.fq").read_bytes() == (tmp_path / "j.fq").read_bytes()


def test_bam_qual_rules_as_in_the_jax_package(tmp_path):
    """0xff QUAL is "*", an empty SEQ gives "", a quality byte from 95 on
    is a character outside ASCII (the file is then rescued read by read)."""
    rows = [("missing", 4, "A" * 12 + JUNC + "C" * 12, "*"),
            ("empty", 4, "", ""),
            ("high", 4, "A" * 12 + JUNC + "C" * 12,
             "I" * 10 + chr(200) * 5 + "I" * 17)]
    path = str(tmp_path / "c_chunk0_1.bam")
    j_write_bam(path, _records(rows), {"chr1": 1000})
    got = read_bam(path, qual=True)
    assert [got.qual(r).decode() for r in range(len(got))] == [
        r.qual for r in j_read_bam(path)]
    junc = junction_info(*enzyme_handle("MboI"))
    assert PR.rescue_sam(path, str(tmp_path / "p.fq"), junc,
                         device=CPU) == JR.rescue_sam(
        path, str(tmp_path / "j.fq"), junc)
    assert (tmp_path / "p.fq").read_bytes() == (tmp_path / "j.fq").read_bytes()


@pytest.mark.parametrize("fmt", ["sam", "bam"])
def test_a_name_outside_ascii_keeps_the_scan(tmp_path, fmt, caplog):
    """Names are copied as bytes: a name outside ASCII changes no cut, so
    the file is scanned as one buffer (the ``scan`` wall) with no warning."""
    rows = [("r\u00e9ad", 4, "A" * 12 + JUNC + "C" * 12, "I" * 32),
            ("\u00fcber", 4, "A" * 15 + JUNC + "C" * 9, "#" * 32),
            ("plain", 4, "ACGT" * 8, "I" * 32)]
    path = str(tmp_path / f"c_chunk0_1.{fmt}")
    if fmt == "sam":
        j_write_sam(path, _records(rows))
    else:
        j_write_bam(path, _records(rows), {"chr1": 1000})
    junc = junction_info(*enzyme_handle("MboI"))
    walls = {}
    with caplog.at_level("WARNING"):
        n = PR.rescue_sam(path, str(tmp_path / "p.fq"), junc, device=CPU,
                          walls=walls)
    assert n == JR.rescue_sam(path, str(tmp_path / "j.fq"), junc) == 3
    assert (tmp_path / "p.fq").read_bytes() == (tmp_path / "j.fq").read_bytes()
    assert "scan" in walls
    assert not [r for r in caplog.records if r.levelname == "WARNING"]


def test_a_name_outside_utf8_raises_as_in_the_jax_package(tmp_path):
    path = tmp_path / "c_chunk0_1.sam"
    path.write_bytes(b"ok\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\tIIII\n"
                     b"r\xe9ad\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\tIIII\n")
    junc = junction_info(*enzyme_handle("MboI"))
    with pytest.raises(UnicodeDecodeError):
        JR.rescue_sam(str(path), str(tmp_path / "j.fq"), junc)
    with pytest.raises(UnicodeDecodeError):
        PR.rescue_sam(str(path), str(tmp_path / "p.fq"), junc, device=CPU)


def test_the_host_path_names_the_file_in_a_warning(tmp_path, caplog):
    rows = [("high", 4, "A" * 12 + JUNC + "C" * 12,
             "I" * 10 + chr(200) * 5 + "I" * 17)]
    path = str(tmp_path / "c_chunk0_1.bam")
    j_write_bam(path, _records(rows), {"chr1": 1000})
    junc = junction_info(*enzyme_handle("MboI"))
    walls = {}
    with caplog.at_level("WARNING"):
        PR.rescue_sam(path, str(tmp_path / "p.fq"), junc, device=CPU,
                      walls=walls)
    assert "scan" not in walls
    assert [r for r in caplog.records
            if r.levelname == "WARNING" and path in r.getMessage()]
    JR.rescue_sam(path, str(tmp_path / "j.fq"), junc)
    assert (tmp_path / "p.fq").read_bytes() == (tmp_path / "j.fq").read_bytes()


@pytest.mark.parametrize("enzyme", ["MboI", "HindIII", "A-ACGTT", "G-CGTTC",
                                    "DpnI"])
def test_junction_cuts_match_split_read(enzyme):
    """Random reads with planted plus and minus junctions, through
    ``junction_cuts`` and the per-read rule (``split_read`` of both
    packages)."""
    junc = junction_info(*enzyme_handle(enzyme))
    rng = np.random.default_rng(len(enzyme))
    reads, quals = [], []
    for i in range(600):
        n = int(rng.integers(0, 60))
        s = "".join(rng.choice(list("ACGTN"), n))
        for _ in range(int(rng.integers(0, 3))):
            j = junc[int(rng.integers(0, 2))]
            at = int(rng.integers(0, len(s) + 1))
            s = s[:at] + j + s[at:]
        reads.append(s)
        quals.append("".join(rng.choice(list("#AIJ"), len(s))))
    want = [JR.split_read(f"r{i}", s, q, junc)
            for i, (s, q) in enumerate(zip(reads, quals))]
    assert want == [PR.split_read(f"r{i}", s, q, junc)
                    for i, (s, q) in enumerate(zip(reads, quals))]
    buf = np.frombuffer("".join(reads).encode(), np.uint8).copy()
    ln = np.asarray([len(s) for s in reads], np.int64)
    off = np.cumsum(ln) - ln
    cut = PR.junction_cuts(torch.from_numpy(buf), torch.from_numpy(off),
                           torch.from_numpy(ln), junc).numpy()
    jlen = len(junc[0])
    for i, (s, w) in enumerate(zip(reads, want)):
        if cut[i] < 0:
            assert w == ""
            continue
        c = int(cut[i])
        one = c >= 10 and len(s) - c - jlen >= 10
        assert s[c:c + jlen] in junc[:2]
        assert w.count("@") == (2 if one else 1 if (
            c >= 10 or len(s) - c - jlen >= 10) else 0)


def test_an_enzyme_without_a_junction_is_refused(tmp_path, workspace):
    for mod, kw in ((JR, {}), (PR, {"device": CPU})):
        with pytest.raises(ValueError, match="no ligation junction"):
            mod.cutting_reads_to_remapping(str(workspace / "gb_sam"),
                                           str(tmp_path / "o"), "NlaIII",
                                           **kw)
    path = str(tmp_path / "x_chunk0_1.sam")
    j_write_sam(path, _records([("a", 4, "ACGT", "IIII")]))
    junc = ("", "", True)
    with pytest.raises(ValueError, match="empty junction"):
        JR.rescue_sam(path, str(tmp_path / "j.fq"), junc)
    with pytest.raises(ValueError, match="empty junction"):
        PR.rescue_sam(path, str(tmp_path / "p.fq"), junc, device=CPU)


def test_file_selection_and_names_as_in_the_jax_package(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    recs = _records([("a", 4, "A" * 12 + JUNC + "C" * 12, "I" * 32)])
    for name in ("x_chunk0_1.sam", "x_chunk0_2.sam.gz", "other.sam",
                 "y_chunk1_Maternal.bam.sam", "z_chunk2.txt"):
        j_write_sam(str(src / name), recs)
    j_write_bam(str(src / "w_chunk3_1.bam"), recs, {"chr1": 1000})
    want = JR.cutting_reads_to_remapping(str(src), str(tmp_path / "j"),
                                         "MboI")
    got = PR.cutting_reads_to_remapping(str(src), str(tmp_path / "p"),
                                        "MboI", device=CPU)
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want]
    assert _files(tmp_path / "p") == _files(tmp_path / "j")
    assert len(want) == 4


def test_the_draw_planted_junctions_are_rescued(tmp_path):
    truth = alignment_chunks(str(tmp_path / "Global_bams"),
                             str(tmp_path / "ReMap_bams"), "cell",
                             [3_000_000, 2_000_000], ["1", "10"], 2500, 2,
                             seed=6, device=CPU, junctions=True)
    PR.cutting_reads_to_remapping(str(tmp_path / "Global_bams"),
                                  str(tmp_path / "p"), "MboI", device=CPU)
    JR.cutting_reads_to_remapping(str(tmp_path / "Global_bams"),
                                  str(tmp_path / "j"), "MboI")
    got = _files(tmp_path / "p")
    assert got == _files(tmp_path / "j")
    for hap in ("Maternal", "Paternal"):
        lines = b"".join(v for k, v in got.items() if hap in k).split(b"\n")
        heads, seqs = lines[0:-1:4], lines[1:-1:4]
        want = truth["rescue"][hap]
        assert want["records"] > 100 and want["split"] > 50
        assert len(heads) == want["records"]
        assert sum(h[-3:] in (b"_11", b"_21") for h in heads) == want["split"]
        assert sum(map(len, seqs)) == want["bases"]


def test_the_draw_is_unchanged_without_junctions(tmp_path):
    """``junctions`` is off by default and then changes nothing."""
    args = ("cell", [3_000_000, 2_000_000], ["1", "10"], 800, 1)
    a = alignment_chunks(str(tmp_path / "a" / "G"), str(tmp_path / "a" / "R"),
                         *args, seed=3, device=CPU)
    b = alignment_chunks(str(tmp_path / "b" / "G"), str(tmp_path / "b" / "R"),
                         *args, seed=3, device=CPU, junctions=False)
    c = alignment_chunks(str(tmp_path / "c" / "G"), str(tmp_path / "c" / "R"),
                         *args, seed=3, device=CPU, junctions=True)
    for d in ("G", "R"):
        assert _files(tmp_path / "a" / d) == _files(tmp_path / "b" / d)
        sizes = {k: len(v) for k, v in _files(tmp_path / "c" / d).items()}
        assert sizes == {k: len(v) for k, v in
                         _files(tmp_path / "a" / d).items()}
    for k in ("Maternal", "Paternal", "rows", "hits", "records"):
        assert a[k] == b[k] == c[k]
    assert "rescue" in c and "rescue" not in a


def test_the_front_chain_matches_the_all_jax_chain(tmp_path):
    """rebuildG, rebuildF and Rescue on the port, mapping and re-mapping by
    the JAX package's FakeAligner, bamProcess on the port: the chunk beds
    equal the all-JAX chain's."""
    data = diploid_dataset(np.random.default_rng(21), str(tmp_path / "data"),
                           n_pairs=240, n_snps=40, read_len=READ_LEN,
                           junction_frac=0.3)
    beds = {}
    for side in ("j", "p"):
        ws = tmp_path / side
        g = ws / "genome"
        g.mkdir(parents=True)
        if side == "j":
            npz = JG.snps_integration(data["snps"], str(g))
            out = JG.rebuild_genome(data["fasta"], npz, "MboI", str(g))
            for mate, fq in ((1, data["fq1"]), (2, data["fq2"])):
                JC.split_reads(fq, str(ws / "fq"), 100, mate)
        else:
            npz = PG.snps_integration(data["snps"], str(g))
            out = PG.rebuild_genome(data["fasta"], npz, "MboI", str(g),
                                    device=CPU)
            for mate, fq in ((1, data["fq1"]), (2, data["fq2"])):
                PC.split_reads(fq, str(ws / "fq"), 100, mate)
        idx = [out["Maternal"], out["Paternal"]]
        ws_mapping(str(ws / "fq"), str(ws / "gb"), idx,
                   aligner=FakeAligner(), jobs=1)
        if side == "j":
            JR.cutting_reads_to_remapping(str(ws / "gb"), str(ws / "rf"),
                                          "MboI")
        else:
            PR.cutting_reads_to_remapping(str(ws / "gb"), str(ws / "rf"),
                                          "MboI", device=CPU)
        ws_rescue_mapping(str(ws / "rf"), str(ws / "rb"),
                          {"Maternal": idx[0], "Paternal": idx[1]},
                          aligner=FakeAligner(), jobs=1)
        frags = [out["Maternal_fragments"], out["Paternal_fragments"]]
        if side == "j":
            JBP.bam_extract(str(ws / "gb"), str(ws / "rb"), str(ws / "bed"),
                            frags, npz, read_len=READ_LEN)
        else:
            PBP.bam_extract(str(ws / "gb"), str(ws / "rb"), str(ws / "bed"),
                            frags, npz, read_len=READ_LEN, device=CPU)
        beds[side] = _files(ws / "bed")
    assert beds["p"] == beds["j"]
    assert len(beds["j"]) == 6 and all(beds["j"].values())
