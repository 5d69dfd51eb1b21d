"""The port's bamProcess stage (hichap_master_tpu_torch.pipeline.
bam_process.bam_extract) against the JAX package's on the same alignment
files, the port on the CPU.

Every output is text or an integer, so the tolerance is none: the chunk
beds equal byte for byte and the reports exactly.  Two sources of
alignments: the workspace that the JAX package's own FakeAligner chain
builds (the steps of tests/test_pipeline_e2e.py:50-117), and the port's
draw (``testing.synthetic.alignment_chunks``), whose reports and rows also
equal its planted truth.  Inputs stay below the JAX package's 32 MB
threshold, above which it sorts through its native external merge."""

import dataclasses
import os
import shutil
import time

import numpy as np
import pytest
import torch

import hichap_master_tpu.pipeline.bam_process as JBP
from hichap_master_tpu.io.bam import sam_to_bam
from hichap_master_tpu.io.sam import AlnRecord, write_sam
from hichap_master_tpu.pipeline.chunking import split_reads
from hichap_master_tpu.pipeline.genome_rebuild import (rebuild_genome,
                                                       snps_integration)
from hichap_master_tpu.pipeline.mapping import (FakeAligner, ws_mapping,
                                                ws_rescue_mapping)
from hichap_master_tpu.pipeline.rescue import cutting_reads_to_remapping
from hichap_master_tpu.testing.synthetic import diploid_dataset
from hichap_master_tpu_torch.kernels import _build
from hichap_master_tpu_torch.pipeline import bam_process as PBP
from hichap_master_tpu_torch.pipeline import pairs as PP
from hichap_master_tpu_torch.testing.synthetic import (ALN_TEMPLATES,
                                                       alignment_chunks)

torch.set_num_threads(1)
CPU = torch.device("cpu")
LENGTHS, LABELS = [3_000_000, 2_000_000], ["1", "10"]
PAIRS, CHUNKS = 2000, 2


def _beds(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


def _both(tmp_path, aln_dir, re_dir, frags, snps, **kw):
    """(JAX report, port report, JAX beds, port beds)."""
    j, p = tmp_path / "j", tmp_path / "p"
    shutil.rmtree(j, ignore_errors=True)
    shutil.rmtree(p, ignore_errors=True)
    rj = JBP.bam_extract(str(aln_dir), str(re_dir), str(j), frags, snps,
                         **kw)
    walls = {}
    rp = PBP.bam_extract(str(aln_dir), str(re_dir), str(p), frags, snps,
                         device=CPU, walls=walls, **kw)
    tags = ["Maternal", "Paternal"] if kw.get("allelic", True) else [
        "NonAllelic"]
    assert set(walls) == {f"{t}.{s}" for t in tags
                          for s in ("read", "sort", "resolve", "write")}
    return rj, rp, _beds(j), _beds(p)


# --------------------------------------------- the FakeAligner workspace
@pytest.fixture(scope="module")
def fake_ws(tmp_path_factory):
    ws = tmp_path_factory.mktemp("fake")
    data = diploid_dataset(np.random.default_rng(0), str(ws / "data"),
                           n_pairs=300, n_snps=50, read_len=40)
    gdir = ws / "genome"
    gdir.mkdir()
    snp = snps_integration(data["snps"], str(gdir))
    out = rebuild_genome(data["fasta"], snp, "MboI", str(gdir))
    split_reads(data["fq1"], str(ws / "fq"), 120, 1)
    split_reads(data["fq2"], str(ws / "fq"), 120, 2)
    fake = FakeAligner()
    ws_mapping(str(ws / "fq"), str(ws / "Global_bams"),
               indexes=[out["Maternal"], out["Paternal"]], aligner=fake,
               jobs=1)
    cutting_reads_to_remapping(str(ws / "Global_bams"),
                               str(ws / "RescueFastq"), "MboI")
    ws_rescue_mapping(str(ws / "RescueFastq"), str(ws / "ReMap_bams"),
                      {"Maternal": out["Maternal"],
                       "Paternal": out["Paternal"]}, aligner=fake, jobs=1)
    return ws, [out["Maternal_fragments"], out["Paternal_fragments"]], snp


@pytest.mark.parametrize("allelic,level,read_len", [
    (True, 1, 40), (True, 2, 40), (True, 1, 37), (False, 1, 40),
    (False, 2, 150)])
def test_fake_aligner_workspace_matches_jax(tmp_path, fake_ws, allelic,
                                            level, read_len):
    ws, frags, snp = fake_ws
    rj, rp, bj, bp = _both(tmp_path, ws / "Global_bams", ws / "ReMap_bams",
                           frags if allelic else frags[:1],
                           snp if allelic else None, level=level,
                           allelic=allelic, read_len=read_len)
    assert rp == rj
    assert bp == bj
    assert sum(len(v) for v in bp.values()) > 10_000


# ------------------------------------------------------------ the draw
@pytest.fixture(scope="module")
def draws(tmp_path_factory):
    """The same draw as SAM, SAM.gz and BAM (the port's writer), and its
    SAM converted to BAM by the JAX package's sam_to_bam."""
    out = {}
    for fmt in ("sam", "sam.gz", "bam"):
        ws = tmp_path_factory.mktemp(fmt.replace(".", "_"))
        truth = alignment_chunks(str(ws / "Global_bams"),
                                 str(ws / "ReMap_bams"), "cell", LENGTHS,
                                 LABELS, PAIRS, CHUNKS, seed=11, fmt=fmt,
                                 device=CPU)
        out[fmt] = (ws, truth)
    ws, truth = out["sam"]
    jb = tmp_path_factory.mktemp("jax_bam")
    for d in ("Global_bams", "ReMap_bams"):
        os.makedirs(jb / d)
        for f in os.listdir(ws / d):
            sam_to_bam(str(ws / d / f), str(jb / d / (f[:-4] + ".bam")))
    out["jax_bam"] = (jb, truth)
    return out


def _rows(beds, hap):
    lines = [ln for f, b in beds.items() if hap in f
             for ln in b.splitlines()]
    fields = [ln.split(b"\t") for ln in lines]
    snp_cols = [int(x[c]) for x in fields
                for c in ((7, 14, 21) if len(x) == 23 else (7, 14))]
    return dict(rows15=sum(len(x) == 15 for x in fields),
                rows23=sum(len(x) == 23 for x in fields),
                suffixed=sum(x[0][-2:] in (b"_1", b"_2") for x in fields),
                snps=sum(snp_cols))


@pytest.mark.parametrize("fmt", ["sam", "sam.gz", "bam", "jax_bam"])
def test_draw_matches_jax_and_its_planted_truth(tmp_path, draws, fmt):
    ws, truth = draws[fmt]
    rj, rp, bj, bp = _both(tmp_path, ws / "Global_bams", ws / "ReMap_bams",
                           truth["fragments"], truth["snps"])
    assert rp == rj == {h: truth[h] for h in ("Maternal", "Paternal")}
    assert bp == bj
    assert sorted(bp) == [f"cell_chunk{k}_{h}.bed" for k in range(CHUNKS)
                          for h in ("Maternal", "Paternal")]
    for hap in ("Maternal", "Paternal"):
        assert _rows(bp, hap) == truth["rows"][hap]
    assert bp == _beds_of(draws, "sam", tmp_path)


def _beds_of(draws, fmt, tmp_path):
    ws, truth = draws[fmt]
    out = tmp_path / f"ref_{fmt.replace('.', '_')}"
    PBP.bam_extract(str(ws / "Global_bams"), str(ws / "ReMap_bams"),
                    str(out), truth["fragments"], truth["snps"], device=CPU)
    return _beds(out)


def test_every_template_of_the_draw_is_hit(draws):
    _, truth = draws["sam"]
    assert len(truth["hits"]) == len(ALN_TEMPLATES)
    assert min(truth["hits"]) >= 1
    rows = truth["rows"]["Maternal"]
    assert rows["rows23"] > 0 and rows["suffixed"] > 0 and rows["snps"] > 0


@pytest.mark.parametrize("kw", [dict(level=2), dict(read_len=100),
                                dict(allelic=False), dict(threads=3)])
def test_draw_modes_match_jax(tmp_path, draws, kw):
    ws, truth = draws["sam"]
    allelic = kw.get("allelic", True)
    rj, rp, bj, bp = _both(
        tmp_path, ws / "Global_bams", ws / "ReMap_bams",
        truth["fragments"] if allelic else truth["fragments"][:1],
        truth["snps"] if allelic else None, **kw)
    assert rp == rj
    assert bp == bj


def test_the_scanner_builds_once_under_several_threads(tmp_path, draws,
                                                     monkeypatch):
    """On a checkout with nothing built, the first scans run on several
    host threads at once: the scanner library is built once, whole, while
    the other threads wait, and ``bam_extract(threads=3)`` writes the beds
    of one thread."""
    ws, truth = draws["sam"]
    want = _beds_of(draws, "sam", tmp_path)
    files = PBP._chunk_files(str(ws / "Global_bams"), str(ws / "ReMap_bams"),
                             *[PBP.get_chunks(str(ws / d))[0]
                               for d in ("Global_bams", "ReMap_bams")],
                             0, "Maternal")
    one = PBP.read_chunk(files, 1)
    built, real = [], _build.build_host

    def build_host(path):
        built.append(path)
        time.sleep(0.5)           # the other threads reach load_host
        return real(path)

    monkeypatch.setattr(_build, "build_host", build_host)
    got = []
    try:
        for k, run in enumerate((
                lambda: PBP.read_chunk(files, 4),
                lambda: PBP.bam_extract(
                    str(ws / "Global_bams"), str(ws / "ReMap_bams"),
                    str(tmp_path / "out"), truth["fragments"],
                    truth["snps"], threads=3, device=CPU))):
            monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / f"b{k}")
            _build._load_host.cache_clear()
            got.append(run())
            assert len(built) == k + 1
            assert os.listdir(tmp_path / f"b{k}") == [built[k].name]
    finally:
        _build._load_host.cache_clear()
    for f in dataclasses.fields(one):
        a, b = getattr(one, f.name), getattr(got[0], f.name)
        assert a == b if isinstance(a, list) else np.array_equal(a, b)
    assert got[1] == {h: truth[h] for h in ("Maternal", "Paternal")}
    assert _beds(tmp_path / "out") == want


def test_a_draw_at_another_read_length(tmp_path):
    truth = alignment_chunks(str(tmp_path / "g"), str(tmp_path / "r"),
                             "cell", LENGTHS, LABELS, 600, 1, seed=2,
                             read_len=100, device=CPU)
    rj, rp, bj, bp = _both(tmp_path, tmp_path / "g", tmp_path / "r",
                           truth["fragments"], truth["snps"], read_len=100)
    assert rp == rj == {h: truth[h] for h in ("Maternal", "Paternal")}
    assert bp == bj


# ------------------------------------------------------------ edge cases
def _rec(name, pos, ref="1", n=40, unmapped=False):
    return AlnRecord(name, 4 if unmapped else 0, None if unmapped else ref,
                     pos, 42, "ACGT" * (n // 4), "I" * n,
                     tag_as=None if unmapped else -2)


def _workspace(tmp_path, files):
    """Chunk alignments of one haplotype-free cell from {(dir, name):
    records}; a fragment table."""
    for (d, name), recs in files.items():
        os.makedirs(tmp_path / d, exist_ok=True)
        write_sam(str(tmp_path / d / name), recs)
    frag = tmp_path / "frags.txt"
    frag.write_text("".join(f"1\t{s}\t{s + 500}\n"
                            for s in range(0, 100_000, 500)))
    return str(frag)


def test_interleaving_names_split_as_in_jax(tmp_path):
    """``a_1, a_11, a_12, a_1x_1, a_1x_2, a_2`` across the four files:
    base ``a`` is resolved as two groups, as the JAX package does."""
    files = {("g", "c_chunk0_1.sam"): [_rec("a_1", 100), _rec("a_1x_1", 900),
                                       _rec("b_1", 5000)],
             ("g", "c_chunk0_2.sam"): [_rec("a_2", 3000),
                                       _rec("a_1x_2", 7000),
                                       _rec("b_2", 9000)],
             ("r", "c_chunk0_1.sam"): [_rec("a_11", 150, n=20),
                                       _rec("a_12", 3100, n=20)],
             ("r", "c_chunk0_2.sam"): []}
    frag = _workspace(tmp_path, files)
    rj, rp, bj, bp = _both(tmp_path, tmp_path / "g", tmp_path / "r",
                           [frag], None, allelic=False, read_len=40)
    assert rp == rj
    assert rj["Total_pairs"] == 4
    assert bp == bj


def test_an_empty_chunk(tmp_path):
    files = {("g", "c_chunk0_1.sam"): [_rec("a_1", 100)],
             ("g", "c_chunk0_2.sam"): [_rec("a_2", 3000)],
             ("r", "c_chunk0_1.sam"): [], ("r", "c_chunk0_2.sam"): [],
             ("g", "c_chunk1_1.sam"): [], ("g", "c_chunk1_2.sam"): [],
             ("r", "c_chunk1_1.sam"): [], ("r", "c_chunk1_2.sam"): []}
    frag = _workspace(tmp_path, files)
    rj, rp, bj, bp = _both(tmp_path, tmp_path / "g", tmp_path / "r",
                           [frag], None, allelic=False, read_len=40)
    assert rp == rj == {"Total_pairs": 1, "Unmapped_pairs": 0,
                        "Multiple_pairs": 0, "Unique_pairs": 1}
    assert bp == bj and bp["c_chunk1.bed"] == b""


def test_missing_files_and_fragments_raise(tmp_path):
    frag = _workspace(tmp_path, {("g", "c_chunk0_1.sam"): [_rec("a_1", 1)],
                                 ("r", "c_chunk0_1.sam"): []})
    with pytest.raises(FileNotFoundError, match="_chunk0_2"):
        PBP.bam_extract(str(tmp_path / "g"), str(tmp_path / "r"),
                        str(tmp_path / "o"), [frag], None, allelic=False,
                        device=CPU)
    with pytest.raises(ValueError, match="M and P"):
        PBP.bam_extract(str(tmp_path / "g"), str(tmp_path / "r"),
                        str(tmp_path / "o"), [frag], None, device=CPU)
    assert PP.load_fragments(frag)["1"][:3].tolist() == [1, 500, 1000]
