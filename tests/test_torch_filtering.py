"""The port's filtering stage (hichap_master_tpu_torch.pipeline.filtering)
against the JAX package's (hichap_master_tpu.pipeline.filtering) on the
same files, with the port on the CPU.

The rules of parity (the port's module docstring):

* ``hic_filtering``: the seven statistics equal; the valid bed's sequence
  of keys (chrom1, strand1, pos1, chrom2, strand2, pos2) equal; a key that
  occurs once in the input carries the same line byte for byte; a repeated
  key carries exactly one line, the first of its lines in (file in name
  order, line) order (the port's tie-break; the JAX package's is
  unspecified);
* ``allelic_filtering``: the sixteen report entries equal (integers
  exactly, ``Allelic_Ratio`` the same float); each of the five files holds
  the same multiset of lines; the port's files are in read-name byte
  order, the order of the reference's row-wise merge-join, so they equal
  that path's files line for line;
* the chain, chunk beds -> filtering -> matrix: every integer dataset of
  every cooler identical, float ones as tests/test_torch_matrix_files.py
  holds them (corrected counts 1e-5 relative, ICE weights 1e-4 with the
  same NaN sets).  Its input's duplicates differ only in a column that
  neither filtering nor the matrix stage reads, so that the two packages'
  tie-breaks cannot part them."""

import logging
import os
import shutil

import h5py
import numpy as np
import pytest
import torch

import hichap_master_tpu.pipeline.filtering as JF
import hichap_master_tpu.pipeline.matrix as JM
from hichap_master_tpu_torch.core import Genome
from hichap_master_tpu_torch.pipeline import filtering as PF
from hichap_master_tpu_torch.pipeline import matrix as PM
from hichap_master_tpu_torch.testing.parity import assert_close_nan
from hichap_master_tpu_torch.testing.synthetic import record_beds

torch.set_num_threads(1)

CPU = torch.device("cpu")
CLASSES = ("Bi_Allelic", "M_M", "P_P", "M_P", "P_M")
# three chromosomes whose string order ("10" < "2") is not genome order
LABELS = ["1", "2", "10"]
LENGTHS = [3_000_000, 2_500_000, 2_000_000]


# ------------------------------------------------------------------ helpers
def _lines(path):
    with open(path, "rb") as f:
        return f.read().splitlines(keepends=True)


def _key(line):
    f = line.split(b"\t")
    return (f[1], int(f[2]), int(f[3]), f[8], int(f[9]), int(f[10]))


def _same_valid_bed(got, want, inputs):
    """The ``hic_filtering`` rule: keys in the same order, single keys
    byte for byte, repeated keys the first of their input lines."""
    g, w = _lines(got), _lines(want)
    assert [_key(x) for x in g] == [_key(x) for x in w]
    first, count = {}, {}
    for path in inputs:
        for ln in _lines(path):
            ln = ln.rstrip(b"\r\n") + b"\n"
            k = _key(ln)
            first.setdefault(k, ln)
            count[k] = count.get(k, 0) + 1
    repeated = 0
    for x, y in zip(g, w):
        k = _key(x)
        assert x == first[k], k
        if count[k] == 1:
            assert x == y, k
        else:
            repeated += 1
    return repeated


def _same_allelic(got_dir, want_dir, prefix):
    for k in CLASSES:
        g = sorted(_lines(os.path.join(got_dir, f"{prefix}_{k}.bed")))
        w = sorted(_lines(os.path.join(want_dir, f"{prefix}_{k}.bed")))
        assert g == w, k


def _beds(tmp_path, n=3000, chunks=3, seed=1):
    d = tmp_path / "raw"
    truth = record_beds(str(d), "cell", LENGTHS, LABELS, n, chunks, seed,
                        device="cpu")
    return d, truth


def _one_name_per_key(raw):
    """Each haplotype's repeated keys under their first line's name, with
    column 4 (which no stage reads) changed, so that any survivor gives
    the same allelic files and matrices."""
    for hap in ("Maternal", "Paternal"):
        first = {}
        for path in PF.chunk_beds(str(raw), hap):
            out = []
            for ln in _lines(path):
                f = ln.split(b"\t")
                k = _key(ln)
                if k in first:
                    f[0], f[4] = first[k], b"99"
                else:
                    first[k] = f[0]
                out.append(b"\t".join(f))
            with open(path, "wb") as fh:
                fh.write(b"".join(out))


# ------------------------------------------------------------ hic_filtering
@pytest.mark.parametrize("allelic", ["NonAllelic", "Maternal", "Paternal"])
@pytest.mark.parametrize("clean", [False, True])
def test_hic_filtering_matches_jax(tmp_path, allelic, clean):
    raw, truth = _beds(tmp_path)
    inputs = PF.chunk_beds(str(raw), allelic)
    assert len(inputs) == (6 if allelic == "NonAllelic" else 3)
    assert [os.path.basename(p) for p in inputs] == [
        f for f in sorted(os.listdir(raw))
        if allelic == "NonAllelic" or allelic in f]
    jraw = tmp_path / "jraw"
    shutil.copytree(raw, jraw)
    want = JF.hic_filtering(str(jraw), str(tmp_path / "j"), allelic,
                            clean=clean)
    inputs_copy = [str(tmp_path / "keep" / os.path.basename(p))
                   for p in inputs]
    shutil.copytree(raw, tmp_path / "keep")
    walls = {}
    got = PF.hic_filtering(str(raw), str(tmp_path / "p"), allelic,
                           clean=clean, device=CPU, walls=walls)
    assert got == want
    assert set(walls) == {"scan", "sort", "classify", "write"}
    if allelic != "NonAllelic":
        assert got == truth[allelic]
    assert all(v > 0 for v in got.values()), got
    name = "cell_Valid.bed" if allelic == "NonAllelic" \
        else f"cell_{allelic}_Valid.bed"
    assert os.listdir(tmp_path / "p") == [name]
    repeated = _same_valid_bed(str(tmp_path / "p" / name),
                               str(tmp_path / "j" / name), inputs_copy)
    assert repeated > 0           # some kept keys were repeated
    left = sorted(os.listdir(raw))
    assert left == sorted(os.listdir(jraw))
    assert (set(map(os.path.basename, inputs)) & set(left)) == (
        set() if clean else set(map(os.path.basename, inputs)))


def test_hic_filtering_line_ends_and_other_strands(tmp_path):
    """CRLF lines (written with LF, as the JAX package writes them), a last
    line with no newline, strands other than 0/16,
    ``chr`` prefixes and chromosomes no genome names, all kept as written;
    duplicates across files, the first file's copy kept."""
    def bed(name, c1, s1, p1, f1, c2, s2, p2, f2, end="\n"):
        return "\t".join(map(str, [name, c1, s1, p1, 100, -5, f1, 0, c2, s2,
                                   p2, 100, -7, f2, 0])) + end

    raw = tmp_path / "raw"
    raw.mkdir()
    rng = np.random.default_rng(4)
    chroms = ["chr1", "chr10", "chr2", "chrUn_gl000220", "1", "10", "2"]
    files = []
    for k in range(3):
        lines = []
        for i in range(300):
            c1, c2 = rng.choice(chroms, 2)
            p1, p2 = (int(x) for x in rng.integers(1, 3000, 2))
            s1, s2 = (int(x) for x in rng.choice([0, 16, 256, 272], 2))
            lines.append(bed(f"k{k}r{i}", c1, s1, p1, p1 // 400 * 400, c2,
                             s2, p2, p2 // 400 * 400,
                             "\r\n" if i % 3 == 0 else "\n"))
        lines.append(bed(f"dup{k}", "chr10", 0, 77, 0, "chr2", 16, 99, 0))
        text = "".join(lines)
        if k == 2:
            text = text[:-1]                         # no final newline
        (raw / f"x_chunk{k}.bed").write_bytes(text.encode())
        files.append(str(raw / f"x_chunk{k}.bed"))
    want = JF.hic_filtering(str(raw), str(tmp_path / "j"), clean=False)
    got = PF.hic_filtering(str(raw), str(tmp_path / "p"), clean=False,
                           device=CPU)
    assert got == want
    assert got["Duplicates"] >= 2
    out = str(tmp_path / "p" / "x_Valid.bed")
    assert _same_valid_bed(out, str(tmp_path / "j" / "x_Valid.bed"),
                           files) > 0
    kept = [ln for ln in _lines(out) if b"\tchr10\t0\t77\t" in ln]
    assert len(kept) == 1 and kept[0].startswith(b"dup0\t")
    assert not any(b"\r" in ln for ln in _lines(out))


def test_hic_filtering_refuses_malformed_rows(tmp_path):
    raw = tmp_path / "raw"
    raw.mkdir()
    good = "r\t1\t0\t5\t100\t-5\t0\t0\t2\t16\t9\t100\t-7\t0\t0\n"
    (raw / "c_chunk0.bed").write_text(good + good.replace("\t9\t", "\tx\t"))
    with pytest.raises(ValueError, match="c_chunk0.bed:2"):
        PF.hic_filtering(str(raw), str(tmp_path / "p"), device=CPU)
    (raw / "c_chunk0.bed").write_text(good + "r\t1\t0\n")
    with pytest.raises(ValueError, match="c_chunk0.bed:2: .* 3 fields"):
        PF.hic_filtering(str(raw), str(tmp_path / "p"), device=CPU)
    with pytest.raises(FileNotFoundError):
        PF.hic_filtering(str(raw), str(tmp_path / "p"), "Maternal",
                         device=CPU)


# -------------------------------------------------------- allelic_filtering
def _allelic_row(rng, name, n_cols):
    """A valid-bed row in the layout of the reference's tests
    (tests/test_allelic_vectorized.py): random SNPs and scores, half the
    candidates usable."""
    c1, c2 = str(rng.integers(1, 5)), str(rng.integers(1, 5))
    base = [name, c1, "0", str(rng.integers(1, 10**6)), "100",
            str(-rng.integers(0, 40)), str(rng.integers(1, 10**6)),
            str(rng.integers(0, 4)), c2, "16", str(rng.integers(1, 10**6)),
            "100", str(-rng.integers(0, 40)), str(rng.integers(1, 10**6)),
            str(rng.integers(0, 4))]
    if n_cols == 23:
        mate = rng.choice(["R1", "R2"])
        if rng.random() < 0.5:
            cc, cf = (base[1], base[6]) if mate == "R1" else (base[8],
                                                              base[13])
        else:
            cc, cf = str(rng.integers(1, 5)), str(rng.integers(1, 10**6))
        base += [cc, "0", str(rng.integers(1, 10**6)), "30",
                 str(-rng.integers(0, 40)), cf, str(rng.integers(0, 4)),
                 mate]
    return "\t".join(base)


def _allelic_beds(d, rng, n=2000, repeat=0, ascii_only=False):
    """Maternal and paternal valid beds of n names (80% in each bed, 25%
    of rows with a candidate; names of 6 to 31 bytes, some not ASCII
    unless ``ascii_only``); ``repeat`` names are written twice into the
    maternal bed."""
    os.makedirs(d, exist_ok=True)
    m_lines, p_lines = [], []
    for i in range(n):
        name = ("p%05d" % i) + "x" * int(rng.integers(0, 24)) + (
            "é" if i % 7 == 0 and not ascii_only else "")
        in_m, in_p = rng.random() < 0.8, rng.random() < 0.8
        if not (in_m or in_p):
            in_m = True
        if in_m:
            m_lines.append(_allelic_row(rng, name,
                                        23 if rng.random() < 0.25 else 15))
        if in_p:
            p_lines.append(_allelic_row(rng, name,
                                        23 if rng.random() < 0.25 else 15))
    m_lines += m_lines[:repeat]
    order = rng.permutation(len(m_lines))
    m_bed, p_bed = d / "c_Maternal_Valid.bed", d / "c_Paternal_Valid.bed"
    m_bed.write_text("\n".join(m_lines[i] for i in order) + "\n")
    p_bed.write_text("\n".join(p_lines))           # no final newline
    return str(m_bed), str(p_bed)


@pytest.mark.parametrize("save_id", [False, True])
def test_allelic_filtering_matches_jax(tmp_path, save_id, caplog):
    rng = np.random.default_rng(11)
    # the JAX package writes ids through an ASCII decode
    m_bed, p_bed = _allelic_beds(tmp_path / "in", rng, ascii_only=save_id)
    want = JF.allelic_filtering(m_bed, p_bed, str(tmp_path / "j"),
                                save_id=save_id)
    walls = {}
    with caplog.at_level(logging.INFO):
        got = PF.allelic_filtering(m_bed, p_bed, str(tmp_path / "p"),
                                   save_id=save_id, device=CPU, walls=walls)
    assert "row-wise" not in caplog.text
    assert list(got) == list(want) == list(PF.REPORT)
    assert got == want
    assert type(got["Allelic_Ratio"]) is float
    assert set(walls) == {"scan", "join", "assign", "write"}
    _same_allelic(str(tmp_path / "p"), str(tmp_path / "j"), "c_Valid")
    # the card's files, line for line, are the row-wise rules' files
    outs = {k: open(tmp_path / f"r_{k}.bed", "w") for k in CLASSES}
    S, total = PF._rowwise(m_bed, p_bed, outs, save_id)
    for f in outs.values():
        f.close()
    assert PF._report(S, total) == got
    for k in CLASSES:
        assert _lines(tmp_path / "p" / f"c_Valid_{k}.bed") == \
            _lines(tmp_path / f"r_{k}.bed"), k


def test_allelic_filtering_repeated_names_take_the_rowwise_path(tmp_path,
                                                                caplog):
    rng = np.random.default_rng(12)
    m_bed, p_bed = _allelic_beds(tmp_path / "in", rng, n=600, repeat=40)
    want = JF.allelic_filtering(m_bed, p_bed, str(tmp_path / "j"))
    with caplog.at_level(logging.INFO):
        got = PF.allelic_filtering(m_bed, p_bed, str(tmp_path / "p"),
                                   device=CPU)
    assert "row-wise merge-join" in caplog.text
    assert got == want
    _same_allelic(str(tmp_path / "p"), str(tmp_path / "j"), "c_Valid")


def _info15(snp1, snp2, c1="1", c2="1", f1=500, f2=1500, score=-5, pos1=100,
            pos2=2000, name="p"):
    return list(map(str, [name, c1, 0, pos1, 100, score, f1, snp1,
                          c2, 16, pos2, 100, score, f2, snp2]))


def _cand(mate, c, pos, frag, snp, score=-3):
    return list(map(str, [c, 0, pos, 30, score, frag, snp, mate]))


# the branches of the reference's unit tests (tests/test_filtering_unit.py:
# 56-105) and the candidate retries: (maternal row, paternal row) with
# None for a bed without the name, and the expected (file, tag)
BRANCHES = [
    (_info15(2, 3), None, ("M_M", "Both")),
    (_info15(2, 0), None, ("M_M", "R1")),
    (None, _info15(0, 2), ("P_P", "R2")),
    (_info15(0, 0), None, ("Bi_Allelic", None)),
    (_info15(2, 0) + _cand("R2", "1", 2100, 1500, 1), None, ("M_M", "Both")),
    (_info15(0, 2) + _cand("R1", "1", 90, 500, 1), None, ("M_M", "Both")),
    (None, _info15(0, 0) + _cand("R1", "1", 90, 500, 2), ("P_P", "R1")),
    (_info15(0, 0) + _cand("R2", "1", 2010, 1500, 2), None, ("M_M", "R2")),
    (_info15(0, 0) + _cand("R2", "1", 2010, 999, 2), None,
     ("Bi_Allelic", None)),
    (_info15(3, 0), _info15(1, 0, pos1=102), ("M_M", "R1")),
    (_info15(0, 0, score=-30),
     _info15(2, 2, score=-30 + JF.MAX_DIFF_SCORE, pos1=9000, pos2=9500),
     ("P_P", "Both")),
    (_info15(1, 1), _info15(1, 1, pos1=101, pos2=2001), ("Bi_Allelic", None)),
    (_info15(3, 0), _info15(0, 3, pos1=101, pos2=2001), ("M_P", None)),
    (_info15(0, 3), _info15(3, 0, pos1=101, pos2=2001), ("P_M", None)),
    # retries: maternal candidate only (mate 1 N -> M), paternal only
    # (mate 2 N -> P), both (the maternal marker picks the mate)
    (_info15(1, 1) + _cand("R1", "1", 100, 500, 3),
     _info15(1, 1, pos1=101, pos2=2001), ("M_M", "R1")),
    (_info15(1, 1), _info15(1, 1, pos1=101, pos2=2001)
     + _cand("R2", "1", 2001, 1500, 3), ("P_P", "R2")),
    (_info15(1, 1) + _cand("R1", "1", 100, 500, 0),
     _info15(1, 1, pos1=101, pos2=2001) + _cand("R1", "1", 101, 500, 3),
     ("P_P", "R1")),
    # (a paternal R2 candidate in the R1 slot: its fragment, 1500, is
    # written for mate 1)
    (_info15(1, 1) + _cand("R1", "1", 100, 500, 0),
     _info15(1, 1, pos1=101, pos2=2001) + _cand("R2", "1", 101, 1500, 3),
     ("P_P", "R1")),
]


def test_every_branch_on_the_card_as_the_rowwise_rules(tmp_path):
    """Each branch as one pair among others: the card's file and tag are
    the expected ones and those of the reference's row rules (the port's
    host copy and the JAX package's)."""
    m_lines, p_lines, want = [], [], {}
    for i, (m, p, dest) in enumerate(BRANCHES):
        name = f"b{i:02d}"
        if m is not None:
            m_lines.append("\t".join([name] + m[1:]))
        if p is not None:
            p_lines.append("\t".join([name] + p[1:]))
        if m is not None and p is not None:
            mark, _ = PF._both_mapping([name] + m[1:], [name] + p[1:])
            assert JF._both_mapping([name] + m[1:], [name] + p[1:])[0] \
                == mark
        else:
            mark, _ = PF._specific_mapping([name] + (m or p)[1:])
            assert JF._specific_mapping([name] + (m or p)[1:])[0] == mark
        want[name] = dest
    d = tmp_path / "in"
    d.mkdir()
    (d / "b_Maternal_Valid.bed").write_text("\n".join(m_lines) + "\n")
    (d / "b_Paternal_Valid.bed").write_text("\n".join(p_lines) + "\n")
    got = PF.allelic_filtering(str(d / "b_Maternal_Valid.bed"),
                               str(d / "b_Paternal_Valid.bed"),
                               str(tmp_path / "p"), save_id=True,
                               device=CPU)
    assert got == JF.allelic_filtering(str(d / "b_Maternal_Valid.bed"),
                                       str(d / "b_Paternal_Valid.bed"),
                                       str(tmp_path / "j"), save_id=True)
    seen = {}
    for k in CLASSES:
        for ln in _lines(tmp_path / "p" / f"b_Valid_{k}.bed"):
            f = ln.decode().split()
            seen[f[0]] = (k, f[5] if len(f) > 5 else None)
    assert seen == want
    _same_allelic(str(tmp_path / "p"), str(tmp_path / "j"), "b_Valid")


def test_empty_and_one_sided_beds(tmp_path):
    d = tmp_path / "in"
    d.mkdir()
    (d / "e_Maternal_Valid.bed").write_text("")
    (d / "e_Paternal_Valid.bed").write_text(
        "\t".join(_info15(1, 0, name="z")) + "\n")
    args = (str(d / "e_Maternal_Valid.bed"), str(d / "e_Paternal_Valid.bed"))
    got = PF.allelic_filtering(*args, str(tmp_path / "p"), device=CPU)
    assert got == JF.allelic_filtering(*args, str(tmp_path / "j"))
    _same_allelic(str(tmp_path / "p"), str(tmp_path / "j"), "e_Valid")


def test_record_beds_truth(tmp_path):
    """The generator's planted truth: every statistic and every report
    entry nonzero, and the port's filtering gives them exactly."""
    raw, truth = _beds(tmp_path, n=6000, chunks=4, seed=3)
    assert len(os.listdir(raw)) == 8
    for hap in ("Maternal", "Paternal"):
        got = PF.hic_filtering(str(raw), str(tmp_path / "f"), hap,
                               clean=False, device=CPU)
        assert got == truth[hap] and all(v > 0 for v in got.values())
    rep = PF.allelic_filtering(
        str(tmp_path / "f" / "cell_Maternal_Valid.bed"),
        str(tmp_path / "f" / "cell_Paternal_Valid.bed"),
        str(tmp_path / "a"), device=CPU)
    assert rep == truth["report"]
    assert all(v > 0 for v in rep.values()), rep
    # duplicates straddle chunk files: a key's copies in two files
    files = {}
    for path in PF.chunk_beds(str(raw), "Maternal"):
        for ln in _lines(path):
            files.setdefault(_key(ln), set()).add(path)
    assert any(len(v) > 1 for v in files.values())


# ------------------------------------------------------------------- chains
def _h5(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(
            name, obj[()] if isinstance(obj, h5py.Dataset) else None))
    return out


def _same_cooler(got, want):
    g, w = _h5(got), _h5(want)
    assert list(g) == list(w)
    for name, wd in w.items():
        gd = g[name]
        if wd is None:
            continue
        assert gd.dtype == wd.dtype and gd.shape == wd.shape, name
        if name.endswith("bins/weight"):
            assert_close_nan(gd, wd, rtol=1e-4, label=name)
        elif wd.dtype.kind == "f":
            np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-9,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(gd, wd, name)


SIZES = dict(zip(LABELS, LENGTHS))
VOTE = dict(imputation_region=1_000_000, imputation_min=1,
            imputation_ratio=0.5)


def test_chain_chunk_beds_to_coolers_matches_jax(tmp_path):
    """Chunk beds -> hic_filtering x2 -> allelic_filtering ->
    haplotype_matrix_files, against the JAX chain on the same chunk
    beds."""
    raw, _ = _beds(tmp_path, n=5000, chunks=3, seed=5)
    _one_name_per_key(raw)
    Genome(SIZES).write(str(tmp_path / "genomeSize"))
    for side, F in (("j", JF), ("p", PF)):
        kw = {} if F is JF else {"device": CPU}
        shutil.copytree(raw, tmp_path / side / "raw")
        filt, alle = tmp_path / side / "filt", tmp_path / side / "alle"
        for hap in ("Maternal", "Paternal"):
            F.hic_filtering(str(tmp_path / side / "raw"), str(filt), hap,
                            **kw)
        F.allelic_filtering(str(filt / "cell_Maternal_Valid.bed"),
                            str(filt / "cell_Paternal_Valid.bed"), str(alle),
                            **kw)
    _same_allelic(str(tmp_path / "p" / "alle"), str(tmp_path / "j" / "alle"),
                  "cell_Valid")
    args = ([str(tmp_path / "j" / "alle")], str(tmp_path / "genomeSize"),
            [500_000], [100_000])
    out_j = JM.haplotype_matrix_construction(str(tmp_path / "j" / "mat"),
                                             *args, **VOTE)
    args = ([str(tmp_path / "p" / "alle")],) + args[1:]
    out_p = PM.haplotype_matrix_files(str(tmp_path / "p" / "mat"), *args,
                                      **VOTE, device=CPU)
    assert list(out_p) == list(out_j) == ["cell_"]
    for kind in ("tradition", "unimputated", "imputated"):
        _same_cooler(out_p["cell_"][kind], out_j["cell_"][kind])


def test_nonallelic_chain_to_the_traditional_cooler_matches_jax(tmp_path):
    raw, _ = _beds(tmp_path, n=4000, chunks=3, seed=6)
    Genome(SIZES).write(str(tmp_path / "genomeSize"))
    for side, F in (("j", JF), ("p", PF)):
        d = tmp_path / side / "raw"
        d.mkdir(parents=True)
        for p in PF.chunk_beds(str(raw), "Maternal"):
            shutil.copy(p, d)
        F.hic_filtering(str(d), str(tmp_path / side / "filt"), "NonAllelic",
                        **({} if F is JF else {"device": CPU}))
    assert os.listdir(tmp_path / "p" / "filt") == ["cell_Valid.bed"]
    args = (str(tmp_path / "genomeSize"), [500_000], [100_000])
    out_j = JM.traditional_matrix_construction(
        str(tmp_path / "j" / "mat"), [str(tmp_path / "j" / "filt")], *args)
    out_p = PM.traditional_matrix_files(
        str(tmp_path / "p" / "mat"), [str(tmp_path / "p" / "filt")], *args,
        device=CPU)
    for got, want in zip(out_p["coolers"], out_j["coolers"]):
        _same_cooler(got, want)
