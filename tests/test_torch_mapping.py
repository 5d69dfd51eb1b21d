"""The port's mapping stage (hichap_master_tpu_torch.pipeline.mapping) and
its two kernels' plain versions (kernels.exact_index, kernels.exact_hits)
against the JAX package's (hichap_master_tpu.pipeline.mapping) and against
``str.find``.

Everything is text or integers, so the tolerance is none: SAM files byte
for byte, BAM files by their inflated payload (the port deflates at level
1, the JAX package at level 6), the executors' retries and PBS command
lines as the JAX package's.  The genome is small (a few kb a chromosome)
and the window length of the index small, so that every path of K9's plain
version runs: seeded reads, reads shorter than k (buckets and side list)
and reads with no window of ACGT (compared at every position)."""

import gzip
import os
import shutil
import stat
import time

import numpy as np
import pytest
import torch

from hichap_master_tpu.pipeline import mapping as JM
from hichap_master_tpu_torch.kernels.exact_hits import exact_hits_plain
from hichap_master_tpu_torch.kernels.exact_index import (canonical,
                                                         exact_index_plain,
                                                         index_k)
from hichap_master_tpu_torch.pipeline import mapping as PM

CPU = torch.device("cpu")
COMP = str.maketrans("ACGT", "TGCA")


def _rc(s: str) -> str:
    return s.translate(COMP)[::-1]


def _genome(rng):
    """Three chromosomes: random bases with soft-masked runs and N runs, a
    poly-A run, a palindrome, a repeated segment; and a short one."""
    def bases(n, lower=0.0):
        s = rng.choice(list("ACGT"), n)
        low = rng.random(n) < lower
        s[low] = np.char.lower(s[low])
        return "".join(s)

    a = bases(2500, 0.3)
    seg = a[300:360]
    c1 = a[:900] + "N" * 40 + a[900:1700] + "A" * 30 + a[1700:] + seg
    c2 = "N" * 20 + bases(700, 0.5) + "GATCGATC" + seg + _rc(seg[:25]) + \
        bases(1200) + "n" * 6 + bases(300)
    c3 = "ACGTTGCA" * 3
    return {"chr1": c1, "chr2": c2, "chrM": c3}


def _write_fasta(path, genome, extra=None):
    with open(path, "w") as f:
        for c, s in list(genome.items()) + list((extra or {}).items()):
            f.write(f">{c} some description\n")
            for i in range(0, len(s), 60):
                f.write(s[i:i + 60] + "\n")
    return str(path)


def _reads(rng, genome, n=160):
    """Windows of every length from both strands, with N, lower case,
    reads at chromosome ends, reads shorter than k, reads longer than a
    chromosome, empty reads, duplicate names."""
    up = {c: s.upper() for c, s in genome.items()}
    out = []
    for i in range(n):
        c = list(up)[int(rng.integers(0, len(up)))]
        s = up[c]
        L = int(rng.integers(1, min(90, len(s)) + 1))
        p = int(rng.integers(0, len(s) - L + 1))
        r = s[p:p + L]
        u = rng.random()
        if u < 0.3:
            r = _rc(r)
        elif u < 0.35:
            r = r.lower()
        elif u < 0.4 and L > 4:
            r = r[:L // 2] + "N" + r[L // 2 + 1:]
        out.append((f"r{int(rng.integers(0, 60))}_{1 + i % 2}", r))
    c1, c2, c3 = up["chr1"], up["chr2"], up["chrM"]
    out += [("end1", c1[-30:]), ("start2", c2[20:50]), ("ends_rc", _rc(
        c2[-25:])), ("polyA", "A" * 12), ("polyA_long", "A" * 31),
        ("pal", "GATCGATC"), ("pal4", "GATC"), ("nrun", "N" * 10),
        ("n_in", c1[880:900] + "N" * 5), ("longer", c3 + c3[:5]),
        ("whole_M", c3), ("dup", c1[300:360]), ("dup_rc", _rc(c1[310:350])),
        ("short", "ACG"), ("one", "T"), ("empty", ""), ("lower", "acgt"),
        ("mixed", c1[100:140].lower()[:3] + c1[103:140]),
        ("tie", "ACGTTGCA"), ("r1_1", c1[5:45]), ("r1_1", c2[50:90]),
        ("x y", c1[200:230])]
    return out


def _write_fastq(path, reads, end="\n", trunc=True):
    text = "".join(f"@{n} desc\t{len(r)}{end}{r}{end}+{end}{'I' * len(r)}"
                   f"{end}" for n, r in reads)
    if trunc:
        text += f"@cut_1{end}ACGTAC"
    op = gzip.open if str(path).endswith(".gz") else open
    with op(path, "wt", newline="") as f:
        f.write(text)
    return str(path)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    rng = np.random.default_rng(41)
    d = tmp_path_factory.mktemp("map")
    genome = _genome(rng)
    fa = _write_fasta(d / "g.fa", genome,
                      extra={"chr2": genome["chr2"][:500] + "ACGT" * 40})
    reads = _reads(rng, genome)
    fq = _write_fastq(d / "c_chunk0_1.fastq", reads)
    return d, genome, fa, reads, fq


@pytest.mark.parametrize("max_hits", [-1, 0, 1, 4])
@pytest.mark.parametrize("source", ["fasta", "dict"])
def test_fake_aligner_matches_jax(small, tmp_path, max_hits, source):
    d, genome, fa, _, fq = small
    if source == "fasta":
        j = JM.FakeAligner(max_hits=max_hits)
        p = PM.FakeAligner(max_hits=max_hits, device=CPU)
        idx = fa
    else:
        dup = dict(genome, **{"1": genome["chr1"][::-1]})   # chr1 -> 1
        j = JM.FakeAligner(dup, max_hits=max_hits)
        p = PM.FakeAligner(dup, max_hits=max_hits, device=CPU)
        idx = "unused"
    j.map_chunk(idx, fq, str(tmp_path / "j.sam"))
    walls = {}
    p.map_chunk(idx, fq, str(tmp_path / "p.sam"), walls)
    got = (tmp_path / "p.sam").read_bytes()
    assert got == (tmp_path / "j.sam").read_bytes()
    flags = [ln.split(b"\t")[1] for ln in got.splitlines()]
    if max_hits >= 0:
        assert {b"0", b"16", b"4"} <= set(flags)
        assert (b"XS:i:0" in got) == (max_hits >= 1)
    else:
        assert set(flags) == {b"4"}
    assert sorted(walls) == ["index", "read", "search", "sort", "write"]


def test_fake_aligner_from_fasta_matches_jax(small, tmp_path):
    _, _, fa, _, fq = small
    JM.FakeAligner.from_fasta(fa).map_chunk("x", fq, str(tmp_path / "j.sam"))
    PM.FakeAligner.from_fasta(fa, device=CPU).map_chunk(
        "x", fq, str(tmp_path / "p.sam"))
    assert (tmp_path / "p.sam").read_bytes() == \
        (tmp_path / "j.sam").read_bytes()


@pytest.mark.parametrize("form", ["gz", "cr", "crlf", "spaces"])
def test_fake_aligner_reads_fastq_as_the_jax_package(small, tmp_path, form):
    _, _, fa, reads, _ = small
    reads = reads[:40] + [("pad", "ACGT")]
    if form == "spaces":
        reads = [(f" {n}\x0b", f"\t{r} \x0c") for n, r in reads]
    name = "c_chunk0_1.fastq" + (".gz" if form == "gz" else "")
    fq = _write_fastq(tmp_path / name, reads,
                      end={"cr": "\r", "crlf": "\r\n"}.get(form, "\n"))
    JM.FakeAligner().map_chunk(fa, fq, str(tmp_path / "j.sam"))
    PM.FakeAligner(device=CPU).map_chunk(fa, fq, str(tmp_path / "p.sam"))
    got = (tmp_path / "p.sam").read_bytes()
    assert got == (tmp_path / "j.sam").read_bytes()
    assert got.count(b"\n") == len(reads) + 1


@pytest.mark.parametrize("header", ["\n", "@\n", "@ \t\n"])
def test_a_header_without_a_name_raises_index_error(small, tmp_path,
                                                    header):
    _, _, fa, _, _ = small
    fq = tmp_path / "c_chunk0_1.fastq"
    fq.write_text("@a\nACGT\n+\nIIII\n" + header + "ACGT\n+\nIIII\n")
    for mod in (JM, PM):
        al = mod.FakeAligner() if mod is JM else mod.FakeAligner(device=CPU)
        with pytest.raises(IndexError):
            al.map_chunk(fa, str(fq), str(tmp_path / "o.sam"))


def test_text_outside_ascii_is_refused(small, tmp_path):
    _, genome, fa, _, _ = small
    fq = tmp_path / "c_chunk0_1.fastq"
    fq.write_text("@é\nACGT\n+\nIIII\n")
    with pytest.raises(ValueError, match="ASCII"):
        PM.FakeAligner(device=CPU).map_chunk(fa, str(fq), str(tmp_path / "o"))
    with pytest.raises(ValueError, match="ASCII"):
        PM.FakeAligner({"1": "ACGTé"}, device=CPU)


# ------------------------------------------------------------- the drivers
def _inflated_tree(d) -> dict:
    out = {}
    for f in sorted(os.listdir(d)):
        p = os.path.join(d, f)
        out[f] = (gzip.open(p).read() if f.endswith(".bam")
                  else open(p, "rb").read())
    return out


@pytest.fixture(scope="module")
def chunks(small):
    """Two chunks of two mates, and rescue FASTQs of both haplotypes."""
    d, genome, fa, reads, _ = small
    fq = d / "fq"
    fq.mkdir()
    for k in range(2):
        for mate in (1, 2):
            part = reads[k * 50 + mate * 10:k * 50 + mate * 10 + 40]
            _write_fastq(fq / f"c_chunk{k}_{mate}.fastq.gz", part,
                         trunc=False)
    (fq / "c_chunk9_1.txt").write_text("not a chunk")
    (fq / "other_1.fastq").write_text("@a\nA\n+\nI\n")
    rf = d / "rf"
    rf.mkdir()
    for k, tag in ((0, "Maternal"), (0, "Paternal"), (1, "Maternal")):
        _write_fastq(rf / f"c_chunk{k}_1_{tag}_unmapped.fq",
                     reads[k * 30:k * 30 + 12], trunc=False)
    (rf / "c_chunk5_1_Paternal_unmapped.fq").write_text("")
    mat = _write_fasta(d / "M.fa", genome)
    pat = _write_fasta(d / "P.fa", {c: s[::-1] for c, s in genome.items()})
    return fq, rf, mat, pat


@pytest.mark.parametrize("fmt", ["sam", "bam"])
def test_ws_mapping_matches_jax(chunks, tmp_path, fmt):
    fq, _, mat, pat = chunks
    outs = {}
    for side, mod in (("j", JM), ("p", PM)):
        kw = {} if mod is JM else {"device": CPU, "walls": {}}
        al = JM.FakeAligner() if mod is JM else PM.FakeAligner(device=CPU)
        outs[side] = mod.ws_mapping(str(fq), str(tmp_path / side), [mat, pat],
                                    aligner=al, jobs=1, out_format=fmt, **kw)
        if side == "p":
            walls = kw["walls"]
    assert [os.path.relpath(o, tmp_path / "p") for o in outs["p"]] == \
        [os.path.relpath(o, tmp_path / "j") for o in outs["j"]]
    assert len(outs["p"]) == 8
    got = _inflated_tree(tmp_path / "p")
    assert got == _inflated_tree(tmp_path / "j")
    assert not [f for f in got if "tmp" in f]
    assert {k.split(".")[0] for k in walls} == {"Maternal", "Paternal"}


def test_ws_mapping_tags_single_indexes_by_basename(chunks, tmp_path):
    fq, _, mat, _ = chunks
    JM.ws_mapping(str(fq), str(tmp_path / "j"), [mat],
                  aligner=JM.FakeAligner(), jobs=1)
    PM.ws_mapping(str(fq), str(tmp_path / "p"), [mat],
                  aligner=PM.FakeAligner(device=CPU), device=CPU)
    got = _inflated_tree(tmp_path / "p")
    assert got == _inflated_tree(tmp_path / "j")
    assert sorted(got)[0] == "c_chunk0_1_M.fa.sam"


@pytest.mark.parametrize("fmt", ["sam", "bam"])
@pytest.mark.parametrize("tags", ["haplotypes", "one"])
def test_ws_rescue_mapping_matches_jax(chunks, tmp_path, fmt, tags):
    _, rf, mat, pat = chunks
    by_tag = ({"Maternal": mat, "Paternal": pat} if tags == "haplotypes"
              else {"": mat})
    JM.ws_rescue_mapping(str(rf), str(tmp_path / "j"), by_tag,
                         aligner=JM.FakeAligner(), jobs=1, out_format=fmt)
    PM.ws_rescue_mapping(str(rf), str(tmp_path / "p"), by_tag,
                         aligner=PM.FakeAligner(device=CPU), out_format=fmt,
                         device=CPU)
    got = _inflated_tree(tmp_path / "p")
    assert got == _inflated_tree(tmp_path / "j")
    assert len(got) == 4


def test_a_chunk_under_100_bytes_fails_in_both(small, tmp_path):
    _, _, fa, _, _ = small
    fq = tmp_path / "fq"
    fq.mkdir()
    (fq / "c_chunk0_1.fastq").write_text("@a\nAC\n+\nII\n")
    for side, mod in (("j", JM), ("p", PM)):
        kw = {} if mod is JM else {"device": CPU}
        al = JM.FakeAligner() if mod is JM else PM.FakeAligner(device=CPU)
        with pytest.raises(RuntimeError, match="still failing after 3 "
                                               "retries"):
            mod.ws_mapping(str(fq), str(tmp_path / side), [fa], aligner=al,
                           jobs=1, **kw)
        # a rescue output only has to exist
        rf = tmp_path / f"rf{side}"
        rf.mkdir()
        (rf / "c_chunk0_1_unmapped.fq").write_text("@a\nAC\n+\nII\n")
        mod.ws_rescue_mapping(str(rf), str(tmp_path / f"rb{side}"),
                              {"": fa}, aligner=al, jobs=1, **kw)
    assert (tmp_path / "p" / "c_chunk0_1_g.fa.sam").read_bytes() == \
        (tmp_path / "j" / "c_chunk0_1_g.fa.sam").read_bytes()
    assert (tmp_path / "rbp" / "c_chunk0_1.sam").read_bytes() == \
        (tmp_path / "rbj" / "c_chunk0_1.sam").read_bytes()


@pytest.mark.parametrize("case", ["format", "no_chunks"])
def test_drivers_refuse_as_the_jax_package(tmp_path, case):
    (tmp_path / "fq").mkdir()
    errors = []
    for mod in (JM, PM):
        kw = {} if mod is JM else {"device": CPU}
        with pytest.raises((ValueError, FileNotFoundError)) as e:
            if case == "format":
                mod.ws_rescue_mapping(str(tmp_path / "fq"),
                                      str(tmp_path / "o"), {},
                                      out_format="cram", **kw)
            else:
                mod.ws_mapping(str(tmp_path / "fq"), str(tmp_path / "o"),
                               ["i"], aligner=object(), **kw)
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]


# ------------------------------------------------------------- executors
def _flaky_job(flag: str, out: str) -> None:
    if os.path.exists(flag):
        with open(out, "w") as f:
            f.write("x" * 200)
    else:
        open(flag, "w").close()
        with open(out, "w") as f:
            f.write("tiny")


@pytest.mark.parametrize("workers", [1, 3])
def test_executor_retries_until_output_valid(tmp_path, workers):
    outs = [str(tmp_path / f"chunk{i}.sam") for i in range(3)]
    tasks = [PM.Task(_flaky_job, (str(tmp_path / f"f{i}"), o), o)
             for i, o in enumerate(outs)]
    PM.RetryingExecutor(workers=workers, max_retries=3).run(tasks)
    assert all(os.path.getsize(o) >= 100 for o in outs)
    assert [t.tries for t in tasks] == [1, 1, 1]


def test_executor_gives_up_and_logs_raising_tasks(tmp_path, caplog):
    def boom():
        raise OSError("disk on fire")

    with pytest.raises(RuntimeError, match="still failing after 1 retries"):
        PM.RetryingExecutor(workers=1, max_retries=1).run(
            [PM.Task(boom, (), str(tmp_path / "x"))])
    assert "disk on fire" in caplog.text


def _exe(path, body):
    path.write_text("#!/bin/bash\n" + body + "\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_pbs_executor_with_mock_scheduler(tmp_path):
    qsub = _exe(tmp_path / "qsub", "sh")
    qstat = _exe(tmp_path / "qstat", "echo '<Data></Data>'")
    out = str(tmp_path / "chunk0_1_Maternal.sam")
    flag = str(tmp_path / "flag")
    cmd = (f"if [ -f {flag} ]; then head -c 200 /dev/zero | tr '\\0' x > "
           f"{out}; else touch {flag}; echo tiny > {out}; fi")
    ex = PM.PBSExecutor(num_task=2, poll_s=0.01, max_retries=3, qsub=qsub,
                        qstat=qstat)
    assert ex.available()
    ex.run_shell_tasks([(cmd, out)], "cell", threads=1, log_dir=str(tmp_path))
    assert os.path.getsize(out) >= 100
    _exe(tmp_path / "qstat", "echo 'garbage'")
    assert ex._job_count("cell") == 0
    ex.qsub = str(tmp_path / "missing")
    assert not ex.available()


@pytest.mark.parametrize("stage", ["global", "rescue"])
def test_pbs_command_lines_match_jax(chunks, tmp_path, monkeypatch, stage):
    """The piped qsub script of every task, as both packages submit it."""
    fq, rf, mat, pat = chunks
    monkeypatch.setattr(time, "sleep", lambda s: None)
    bowtie = _exe(tmp_path / "bowtie2", 'while [ "$1" != "-S" ]; do shift; '
                  'done; head -c 200 /dev/zero | tr "\\0" x > "$2"')
    scripts = {}
    for side, mod in (("j", JM), ("p", PM)):
        log = tmp_path / f"{side}.log"
        qsub = _exe(tmp_path / f"qsub_{side}",
                    f'echo "$@" >> {log}; tee -a {log} | sh')
        qstat = _exe(tmp_path / f"qstat_{side}", "echo '<Data></Data>'")
        monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")
        shutil.copy(qsub, tmp_path / "qsub")
        shutil.copy(qstat, tmp_path / "qstat")
        out = tmp_path / "out"
        shutil.rmtree(out, ignore_errors=True)
        if stage == "global":
            outs = mod.pbs_mapping(str(fq), str(out), [mat, pat], "cell",
                                   bowtie2=bowtie, threads=3, num_task=5,
                                   mem_gb=7)
        else:
            outs = mod.pbs_rescue_mapping(
                str(rf), str(out), {"Maternal": mat, "Paternal": pat},
                "cell", bowtie2=bowtie, threads=3, qsub="qsub",
                qstat="qstat")
        assert all(os.path.getsize(o) >= 100 for o in outs)
        scripts[side] = (outs, log.read_text())
    assert scripts["p"] == scripts["j"]
    assert scripts["p"][1].count("-x ") == len(scripts["p"][0])


# -------------------------------------------------- K8 / K9 plain versions
@pytest.mark.parametrize("k", [3, 5, 8, 10])
def test_index_and_hits_plain_match_str_find(small, k):
    """K8's plain index and K9's plain search against a brute ``str.find``
    of every read and its reverse complement in every chromosome."""
    _, genome, _, reads, _ = small
    up = {c: s.upper() for c, s in genome.items()}
    g = torch.frombuffer(bytearray("".join(up.values()).encode()),
                         dtype=torch.uint8)
    lens = torch.tensor([len(s) for s in up.values()])
    end = torch.cumsum(lens, 0)
    ix = exact_index_plain(g, end - lens, end, k)
    assert int(ix.bucket[-1]) == len(ix.pos)
    assert torch.equal(canonical(ix), ix.pos.long())
    seqs = [r for _, r in reads] + ["A" * 40, "N" * 3, "GATC" * 12]
    ln = torch.tensor([len(r) for r in seqs], dtype=torch.int32)
    off = torch.cumsum(ln.long(), 0) - ln.long()
    buf = torch.frombuffer(bytearray("".join(seqs).encode() or b"\0"),
                           dtype=torch.uint8)
    hit, count = exact_hits_plain(ix, buf, off, ln)
    at = dict(zip(up, (end - lens).tolist()))
    paths = set()
    for i, r in enumerate(seqs):
        for t, q in enumerate((r, _rc(r))):
            hits = []
            for c, ref in up.items():
                s = 0
                while q and (p := ref.find(q, s)) >= 0:
                    hits.append(at[c] + p)
                    s = p + 1
            want = (min(hits) if hits else -1, min(len(hits), 2))
            assert (int(hit[2 * i + t]), int(count[2 * i + t])) == want, \
                (k, q)
            paths.add("short" if 0 < len(q) < k else
                      "seeded" if any(set(q[o:o + k]) <= set("ACGT")
                                      for o in range(len(q) - k + 1))
                      else "scan")
    assert paths == {"short", "seeded", "scan"}
    assert index_k(3_100_000_000) == 13 and index_k(5_000) == 6


# ------------------------------------------------------------- the chain
def test_the_port_chain_matches_the_all_jax_chain(tmp_path):
    """rebuildG, rebuildF, GlobalMapping, Rescue, ReMapping and bamProcess,
    all on the port: the chunk beds equal the all-JAX chain's."""
    from hichap_master_tpu.pipeline import bam_process as JBP
    from hichap_master_tpu.pipeline import chunking as JC
    from hichap_master_tpu.pipeline import genome_rebuild as JG
    from hichap_master_tpu.pipeline import rescue as JR
    from hichap_master_tpu.testing.synthetic import diploid_dataset
    from hichap_master_tpu_torch.pipeline import bam_process as PBP
    from hichap_master_tpu_torch.pipeline import chunking as PC
    from hichap_master_tpu_torch.pipeline import genome_rebuild as PG
    from hichap_master_tpu_torch.pipeline import rescue as PR

    data = diploid_dataset(np.random.default_rng(23), str(tmp_path / "data"),
                           n_pairs=240, n_snps=40, read_len=60,
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
            idx = [out["Maternal"], out["Paternal"]]
            JM.ws_mapping(str(ws / "fq"), str(ws / "gb"), idx,
                          aligner=JM.FakeAligner(), jobs=1)
            JR.cutting_reads_to_remapping(str(ws / "gb"), str(ws / "rf"),
                                          "MboI")
            JM.ws_rescue_mapping(str(ws / "rf"), str(ws / "rb"),
                                 {"Maternal": idx[0], "Paternal": idx[1]},
                                 aligner=JM.FakeAligner(), jobs=1)
            frags = [out["Maternal_fragments"], out["Paternal_fragments"]]
            JBP.bam_extract(str(ws / "gb"), str(ws / "rb"), str(ws / "bed"),
                            frags, npz, read_len=60)
        else:
            npz = PG.snps_integration(data["snps"], str(g))
            out = PG.rebuild_genome(data["fasta"], npz, "MboI", str(g),
                                    device=CPU)
            for mate, fq in ((1, data["fq1"]), (2, data["fq2"])):
                PC.split_reads(fq, str(ws / "fq"), 100, mate)
            idx = [out["Maternal"], out["Paternal"]]
            PM.ws_mapping(str(ws / "fq"), str(ws / "gb"), idx,
                          aligner=PM.FakeAligner(device=CPU), device=CPU)
            PR.cutting_reads_to_remapping(str(ws / "gb"), str(ws / "rf"),
                                          "MboI", device=CPU)
            PM.ws_rescue_mapping(str(ws / "rf"), str(ws / "rb"),
                                 {"Maternal": idx[0], "Paternal": idx[1]},
                                 aligner=PM.FakeAligner(device=CPU),
                                 device=CPU)
            frags = [out["Maternal_fragments"], out["Paternal_fragments"]]
            PBP.bam_extract(str(ws / "gb"), str(ws / "rb"), str(ws / "bed"),
                            frags, npz, read_len=60, device=CPU)
        beds[side] = {f: (ws / "bed" / f).read_bytes()
                      for f in sorted(os.listdir(ws / "bed"))}
        sams = {f: (ws / "gb" / f).read_bytes()
                for f in sorted(os.listdir(ws / "gb"))}
        beds[side + "_sam"] = sams
    assert beds["p_sam"] == beds["j_sam"]
    assert beds["p"] == beds["j"]
    assert len(beds["j"]) == 6 and all(beds["j"].values())


# ------------------------------------------------------------ the read draw
def test_read_draw_truth_is_what_the_aligner_finds(tmp_path):
    """testing.synthetic.read_draw on a small drawn genome: every read's
    SAM record from the port's FakeAligner equals its planted truth (kind
    by kind: both haplotypes, one, none, XS on the repeats, palindromes
    and N runs)."""
    from hichap_master_tpu_torch.io.sam import read_sam
    from hichap_master_tpu_torch.testing.synthetic import (READ_KINDS,
                                                           genome_draw,
                                                           read_draw)

    names, lengths = ["1", "2", "10"], [400_000, 300_000, 200_000]
    draw = genome_draw(str(tmp_path / "g.fa"), str(tmp_path / "s.txt"),
                       lengths, names, seed=5, device=CPU, repeats=6)
    haps = {}
    for h, k in (("Maternal", 1), ("Paternal", 2)):
        haps[h] = {}
        for c in sorted(names):
            t = draw["chroms"][c].clone()
            pos, *alleles = draw["snps"][c]
            t[pos - 1] = alleles[k - 1]
            haps[h][c] = t
        fa = str(tmp_path / f"{h}.fa")
        with open(fa, "wb") as f:
            for c, t in haps[h].items():
                f.write(f">chr{c}\n".encode() + t.numpy().tobytes() + b"\n")
    rd = read_draw(str(tmp_path / "fq"), "cell", haps, {
        c: draw["snps"][c][0] for c in names}, 3000, 150, seed=9,
        device=CPU, repeats=draw["repeats"],
        palindromes=draw["palindromes"])
    t = rd["truth"][1]
    kinds = {READ_KINDS[i] for i in np.unique(t["kind"])}
    assert kinds == set(READ_KINDS)
    starts = rd["starts"]
    for h in "MP":
        al = PM.FakeAligner(device=CPU)
        out = str(tmp_path / f"{h}.sam")
        al.map_chunk(str(tmp_path / ("Maternal.fa" if h == "M" else
                                     "Paternal.fa")), rd["fastq"][0], out)
        a = read_sam(out)
        ids = np.array([int(a.name(r).split(b".")[1].split(b" ")[0])
                        for r in range(len(a))]) - 1
        rank = {w.decode(): i for i, w in enumerate(a.refs)}
        order = np.array([rd["names"].index(w.decode()) for w in a.refs]
                         + [0])
        glob = np.where(a.ref >= 0, starts[order[a.ref]] + a.pos, -1)
        assert rank and len(a) == 3000
        flag = a.flag.copy()
        xs = (a.has & 2) > 0
        kind = t["kind"][ids]
        long_ok = kind != READ_KINDS.index("short")
        assert np.array_equal(flag[long_ok], t[f"{h}.flag"][ids][long_ok])
        assert np.array_equal(glob[long_ok], t[f"{h}.hit"][ids][long_ok])
        assert np.array_equal(xs[long_ok], t[f"{h}.multi"][ids][long_ok])
    # a palindrome without a SNP maps twice at one place in both haplotypes
    pal = t["kind"] == READ_KINDS.index("palindrome")
    assert (t["M.multi"][pal] & t["P.multi"][pal]).mean() > 0.5
