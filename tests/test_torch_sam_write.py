"""The port's SAM and BAM writers and the bowtie2 adapter's name sort
(hichap_master_tpu_torch.io.sam.write_sam, io.bam.sam_to_bam /
bam_to_sam, pipeline.mapping.Bowtie2Aligner) against the JAX package's
(hichap_master_tpu.io.sam.write_sam, io.bam.sam_to_bam / bam_to_sam,
pipeline.mapping.Bowtie2Aligner with its native sort).

Everything is text or integers, so the tolerance is none: SAM files byte
for byte (``.gz`` decompressed), BAM files by their inflated payload (the
port deflates at level 1, the JAX package at level 6)."""

import gzip
import os
import stat

import numpy as np
import pytest
import torch

import hichap_master_tpu.io.bam as JB
import hichap_master_tpu.io.sam as JS
from hichap_master_tpu.pipeline import mapping as JM
from hichap_master_tpu_torch.io import bam as PB
from hichap_master_tpu_torch.io import sam as PS
from hichap_master_tpu_torch.pipeline import mapping as PM

CPU = torch.device("cpu")

# records with the formatter's quirks: unmapped, empty and "*" SEQ/QUAL,
# AS without XS and XS without AS, negative tags, lower-case and other
# bytes outside the BAM codes, QUAL shorter than SEQ, CRLF, a name with a
# byte outside ASCII
BODY = (
    "r1_1\t0\tchr1\t10\t42\t5M\t*\t0\t0\tACGTA\tIIIII\tAS:i:-3\tXS:i:-5\n"
    "r1_2\t16\tchr2\t20\t7\t5M\t*\t0\t0\tacgtN\tII\tXS:i:7\r\n"
    "r2_11\t4\t*\t0\t0\t*\t*\t0\t0\t*\t*\n"
    "r2_12\t0\tchrX\t1\t255\t*\t*\t0\t0\tA=.*x\t*\tAS:i:0\n"
    "short\t0\tchr1\t5\n"
    "é_2\t0\tchr1\t3\t9\t*\t*\t0\t0\tAC\t#$\tYT:Z:UU\n"
    "r3\t256\tchr2\t99\t0\t*\t*\t0\t0\tGATTACA\tABCDEFG\n")


def _sam(path, text):
    with open(path, "w") as f:
        f.write(text)
    return str(path)


def _inflated(path) -> bytes:
    with gzip.open(path, "rb") as f:
        return f.read()


def _text(path) -> bytes:
    return _inflated(path) if str(path).endswith(".gz") else open(
        path, "rb").read()


@pytest.mark.parametrize("name,refs", [
    ("out.sam", None), ("out.sam.gz", None),
    ("out.sam", {"chr1": 100, "chr2": 0, "chrX": 7})])
def test_write_sam_matches_jax(tmp_path, name, refs):
    src = _sam(tmp_path / "in.sam", "@HD\tVN:1.0\n" + BODY)
    want, got = tmp_path / f"j_{name}", tmp_path / f"p_{name}"
    JS.write_sam(str(want), list(JS.read_sam(src)), refs)
    PS.write_sam(str(got), PS.read_sam(src, qual=True, mapq=True), refs)
    assert _text(got) == _text(want)
    assert _text(got).count(b"\n") == 6 + (3 if refs else 0)


def test_write_sam_without_qual_writes_a_star_and_needs_mapq(tmp_path):
    src = _sam(tmp_path / "in.sam", BODY)
    aln = PS.read_sam(src)
    with pytest.raises(ValueError, match="MAPQ"):
        PS.write_sam(str(tmp_path / "x.sam"), aln)
    PS.write_sam(str(tmp_path / "x.sam"), aln, mapq=np.arange(len(aln)))
    lines = open(tmp_path / "x.sam").read().splitlines()
    assert [ln.split("\t")[10] for ln in lines] == ["*"] * len(aln)
    assert [ln.split("\t")[4] for ln in lines] == [str(i) for i in
                                                   range(len(aln))]


# the reference-sizing rules of sam_to_bam: @SQ lines, the scan of the
# records in order of first appearance, an @SQ LN of 0 that keeps
# accumulating, a record whose end is 0 that adds nothing
SIZING = {
    "scan": BODY,
    "sq": "@SQ\tSN:chr1\tLN:500\n@SQ\tSN:chr2\tLN:9\n@SQ\tSN:chrX\tLN:3\n"
          + BODY,
    "partial": "@HD\tVN:1.0\n@SQ\tSN:chr2\tLN:0\n@SQ\tSN:chr9\tLN:40\n"
               + BODY,
    "late_header": BODY + "@SQ\tSN:chr1\tLN:77\n"
                   "z\t0\tchr1\t400\t1\t*\t*\t0\t0\tAC\tII\n",
    "order": "a\t0\tchr5\t0\t1\t*\t*\t0\t0\t*\t*\n"
             "b\t0\tchr4\t3\t1\t*\t*\t0\t0\tACGT\tIIII\n"
             "c\t0\tchr5\t8\t1\t*\t*\t0\t0\tAC\tII\n"
             "d\t0\tchr4\t1\t1\t*\t*\t0\t0\tACGTACGT\tIIIIIIII\n",
}


@pytest.mark.parametrize("case", sorted(SIZING))
def test_sam_to_bam_matches_jax(tmp_path, case):
    src = _sam(tmp_path / "in.sam", SIZING[case])
    JB.sam_to_bam(src, str(tmp_path / "j.bam"))
    PB.sam_to_bam(src, str(tmp_path / "p.bam"))
    assert _inflated(tmp_path / "p.bam") == _inflated(tmp_path / "j.bam")
    refs = JB.read_bam_header(gzip.open(tmp_path / "p.bam"))
    assert len(refs) >= 2


def test_sam_to_bam_takes_the_given_references(tmp_path):
    src = str(tmp_path / "in.sam.gz")
    with gzip.open(src, "wt") as f:
        f.write("@SQ\tSN:chr1\tLN:5\n" + BODY)
    refs = {"chrX": 11, "chr2": 22, "chr1": 33}
    JB.sam_to_bam(src, str(tmp_path / "j.bam"), refs)
    PB.sam_to_bam(src, str(tmp_path / "p.bam"), refs)
    assert _inflated(tmp_path / "p.bam") == _inflated(tmp_path / "j.bam")


def test_sam_to_bam_refuses_an_unsized_reference(tmp_path):
    """A mapped record whose end is 0 sizes nothing: both raise KeyError
    on encoding it."""
    src = _sam(tmp_path / "in.sam", "x\t0\tchr6\t0\t1\t*\t*\t0\t0\t*\t*\n")
    for mod, out in ((JB, "j.bam"), (PB, "p.bam")):
        with pytest.raises(KeyError):
            mod.sam_to_bam(src, str(tmp_path / out))


def test_bam_to_sam_matches_jax(tmp_path):
    recs = list(JS.read_sam(_sam(tmp_path / "in.sam", BODY)))
    recs.append(JS.AlnRecord("empty", 4, None, -1, 0, "", ""))
    recs.append(JS.AlnRecord("hq", 0, "chr1", 4, 60, "ACG", "\x7f~!"))
    JB.write_bam(str(tmp_path / "in.bam"), recs,
                 {"chr1": 100, "chr2": 50, "chrX": 9})
    JB.bam_to_sam(str(tmp_path / "in.bam"), str(tmp_path / "j.sam"))
    PB.bam_to_sam(str(tmp_path / "in.bam"), str(tmp_path / "p.sam"))
    got = open(tmp_path / "p.sam", "rb").read()
    assert got == open(tmp_path / "j.sam", "rb").read()
    assert got.count(b"\n") == len(recs)


# --------------------------------------------------------- bowtie2 adapter
# bowtie2's full columns and tags, headers, shuffled; names that are
# prefixes of one another, equal names (ties keep line order), a CR before
# the newline, an empty line, bytes outside ASCII, a last line without \n
BT2 = (
    "@HD\tVN:1.0\tSO:unsorted\n@SQ\tSN:1\tLN:4000\n@PG\tID:bowtie2\n"
    "zeta_1\t0\t1\t101\t42\t8M\t*\t0\t0\tACGTACGT\tIIIIIIII\tAS:i:0\t"
    "XN:i:0\tXM:i:0\tXO:i:0\tXG:i:0\tNM:i:0\tMD:Z:8\tYT:Z:UU\n"
    "ab\t16\t1\t201\t42\t8M\t*\t0\t0\tACGTACGT\tIIIIIIII\tAS:i:-3\n"
    "a\t4\t*\t0\t0\t*\t*\t0\t0\tACGTACGT\tIIIIIIII\tYT:Z:UU\r\n"
    "abc\t0\t1\t5\t1\t8M\t*\t0\t0\tACGTACGT\tIIIIIIII\n"
    "ab\t0\t1\t9\t1\t8M\t*\t0\t0\tACGTACGT\tIIIIIIII\tAS:i:-9\tXS:i:-9\n"
    "\n"
    "Zed\t0\t1\t1\t1\t8M\t*\t0\t0\tA\tI\n"
    "é\t0\t1\t1\t1\t8M\t*\t0\t0\tA\tI\n"
    "e~\t0\t1\t1\t1\t8M\t*\t0\t0\tA\tI\n"
    "nofields\n"
    "a\t0\t1\t7\t1\t8M\t*\t0\t0\tACGTACGT\tIIIIIIII")


def _stub(tmp_path, payload: str) -> str:
    """A bowtie2 that copies ``payload`` to its -S target."""
    src = tmp_path / "payload.sam"
    src.write_bytes(payload.encode())
    stub = tmp_path / "bowtie2"
    stub.write_text("#!/bin/sh\n"
                    'while [ "$1" ]; do\n'
                    '  if [ "$1" = "-S" ]; then out="$2"; fi\n'
                    "  shift\n"
                    "done\n"
                    f'cp "{src}" "$out"\n')
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    return str(stub)


@pytest.mark.parametrize("seed", [None, 5])
def test_bowtie2_adapter_matches_jax(tmp_path, seed):
    payload = BT2
    if seed is not None:          # many shuffled records, many equal names
        rng = np.random.default_rng(seed)
        lines = [f"{'r' * int(rng.integers(1, 4))}{int(rng.integers(0, 30))}"
                 f"_{int(rng.integers(1, 3))}\t{16 * int(rng.integers(0, 2))}"
                 f"\t1\t{i}\t42\t4M\t*\t0\t0\tACGT\tIIII\tAS:i:{-i}"
                 for i in range(400)]
        payload = "@HD\tVN:1.0\n" + "\n".join(lines) + "\n"
    stub = _stub(tmp_path, payload)
    fq = tmp_path / "chunk_1.fastq"
    fq.write_text("@r1_1\nACGT\n+\nIIII\n")
    JM.Bowtie2Aligner(bowtie2=stub).map_chunk("idx", str(fq),
                                              str(tmp_path / "j.sam"))
    al = PM.Bowtie2Aligner(bowtie2=stub, device=CPU)
    assert al.available()
    walls = {}
    al.map_chunk("idx", str(fq), str(tmp_path / "p.sam"), walls)
    got = (tmp_path / "p.sam").read_bytes()
    assert got == (tmp_path / "j.sam").read_bytes()
    assert not os.path.exists(str(tmp_path / "p.sam") + ".unsorted")
    assert sorted(walls) == ["read", "search", "sort", "write"]
    if seed is None:
        names = [ln.split(b"\t")[0] for ln in got.split(b"\n")[:-1]]
        assert names[:6] == [b"", b"Zed", b"a", b"a", b"ab", b"ab"]
        assert b"a\t4\t*\t0\t0\t*\t*\t0\t0\tACGTACGT\tIIIIIIII\tYT:Z:UU\r" \
            in got


def test_bowtie2_adapter_argv_is_the_jax_one(tmp_path):
    """The same argv reaches bowtie2 from both adapters."""
    log = tmp_path / "argv"
    stub = tmp_path / "bowtie2"
    stub.write_text(f'#!/bin/sh\necho "$@" >> "{log}"\n'
                    'while [ "$1" ]; do\n'
                    '  if [ "$1" = "-S" ]; then out="$2"; fi\n'
                    "  shift\n"
                    "done\n"
                    ': > "$out"\n')
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    JM.Bowtie2Aligner(str(stub), 7).map_chunk("ix", "f.fq",
                                              str(tmp_path / "o.sam"))
    PM.Bowtie2Aligner(str(stub), 7, device=CPU).map_chunk(
        "ix", "f.fq", str(tmp_path / "o.sam"))
    a, b = log.read_text().splitlines()
    assert a == b == f"-x ix -p 7 -U f.fq -S {tmp_path / 'o.sam'}.unsorted"
    assert (tmp_path / "o.sam").read_bytes() == b""
