"""The port's pair resolution (hichap_master_tpu_torch.pipeline.pairs)
against the JAX package's (hichap_master_tpu.pipeline.pairs), the port on
the CPU.

Every output is text or an integer, so the tolerance is none: rows equal
byte for byte, outcomes and counts exactly.  Each case is one read group:
the JAX package reads it back from SAM text (``read_sam``), sorts it by
name and resolves it with ``PairResolver.resolve``; the port reads the
same file into columns, orders, groups and resolves it with masks, and
writes its rows.  One case per branch of the case tree and per quirk
(``pipeline/pairs.py:139-350`` of the JAX package)."""

import numpy as np
import pytest
import torch

import hichap_master_tpu.pipeline.pairs as JP
from hichap_master_tpu.io.sam import AlnRecord, read_sam, write_sam
from hichap_master_tpu_torch.io import sam as PS
from hichap_master_tpu_torch.io.fasta import snp_table
from hichap_master_tpu_torch.pipeline import pairs as PP

torch.set_num_threads(1)
CPU = torch.device("cpu")
# chromosome 1: fragments (1, 1000], (1000, 2000], (2000, 3000],
# (3000, 4000]; chromosome 2: (1, 1000], (1000, 5000] (its first
# fragment's midpoint, 500, equals chromosome 1's); a scaffold line
FRAGS = ("1\t0\t1000\n1\t1000\t2000\n1\t2000\t3000\n1\t3000\t4000\n"
         "chr2\t0\t1000\nchr2\t1000\t5000\nGL000220.1\t0\t9000\n")
SNPS = {"1": {"pos": np.array([105, 110, 200, 2105]),
              "m_alt": np.array(["G", "T", "A", "C"]),
              "p_alt": np.array(["C", "C", "C", "AT"])},
        "2": {"pos": np.array([60]), "m_alt": np.array(["G"]),
              "p_alt": np.array(["T"])}}


def rec(name, ref="1", pos=100, flag=0, n=50, tag_as=0, tag_xs=None,
        unmapped=False, seq=None):
    seq = seq or ("ACGT" * 60)[:n]
    return AlnRecord(name, 4 if unmapped else flag,
                     None if unmapped else ref, pos, 42, seq, "I" * len(seq),
                     tag_as=None if unmapped else tag_as, tag_xs=tag_xs)


def N(name, n=150):
    return rec(name, n=n, unmapped=True)


def M(name, **kw):
    return rec(name, tag_xs=0, **kw)


# read_len 150 throughout: "F" reads are 150 long, the rest shorter
CASES = {
    # n == 2: no tag check; the first read that is not unique decides
    "2_unique": [rec("p_1"), rec("p_2", ref="chr2", pos=1500, flag=16)],
    "2_first_unmapped": [N("p_1"), rec("p_2")],
    "2_second_unmapped": [rec("p_1"), N("p_2")],
    "2_multi_then_unmapped": [M("p_1"), N("p_2")],
    "2_unmapped_then_multi": [N("p_1"), M("p_2")],
    "2_scaffold": [rec("p_1"), rec("p_2", ref="GL000220.1")],
    "2_no_AS": [rec("p_1", tag_as=None), rec("p_2")],
    "2_weak_multi": [rec("p_1", tag_as=-2, tag_xs=-10), rec("p_2")],
    "2_any_tags": [rec("p_11", n=30), rec("p_12", pos=1500, n=30)],
    # n == 3: any three reads; the last read whose name ends in 1 / 2
    "3_skip_unmapped": [rec("p_1"), N("p_2"), rec("p_2", pos=2500, n=30)],
    "3_last_wins": [rec("p_1"), rec("p_2", pos=1500),
                    rec("p_2", pos=2500, n=30)],
    "3_name_21_is_mate_1": [rec("p_1"), rec("p_2", pos=1500),
                            rec("p_21", pos=2500, n=30)],
    "3_tags_11_12_2": [rec("p_11", n=30), rec("p_12", pos=1500, n=30),
                       rec("p_2", pos=2500)],
    "3_two_unmapped": [N("p_1"), N("p_2"), rec("p_2", n=30)],
    "3_two_not_unique": [M("p_1"), N("p_2"), rec("p_2", n=30)],
    "3_no_mate_1": [N("p_1"), rec("p_2"), rec("p_2", pos=2500, n=30)],
    "3_multi_printed": [M("p_1"), rec("p_2"), rec("p_2", pos=2500, n=30)],
    # n == 4, R1 split: _four_plus(m11, m12, m2) and _split_r1
    "4r1_cand_R2": [N("p_1"), rec("p_11", pos=150, n=20),
                    rec("p_12", pos=2100, n=20), rec("p_2", pos=2200)],
    "4r1_cand_R1": [N("p_1"), rec("p_11", pos=150, n=20),
                    rec("p_12", pos=300, n=20), rec("p_2", pos=2200)],
    "4r1_pair": [N("p_1"), rec("p_11", pos=150, n=20),
                 rec("p_12", pos=1500, n=20), rec("p_2", pos=2500)],
    "4r1_collapse": [N("p_1"), M("p_11", pos=150, n=20),
                     rec("p_12", pos=2100, n=20), rec("p_2", pos=2200)],
    "4r1_m11_multi": [N("p_1"), M("p_11", pos=150, n=20),
                      rec("p_12", pos=1500, n=20), rec("p_2", pos=2200)],
    "4r1_m12_multi": [N("p_1"), rec("p_11", pos=150, n=20),
                      M("p_12", pos=1500, n=20), rec("p_2", pos=2200)],
    "4r1_whole_unmapped": [rec("p_1"), rec("p_11", n=20),
                           rec("p_12", n=20), N("p_2")],
    "4r1_subs_unmapped": [rec("p_1"), N("p_11", 20), N("p_12", 20),
                          rec("p_2")],
    "4r1_whole_multi": [N("p_1"), rec("p_11", n=20), rec("p_12", n=20),
                        M("p_2")],
    "4r1_subs_not_unique": [N("p_1"), M("p_11", n=20), N("p_12", 20),
                            rec("p_2")],
    # n == 4, R2 split: _four_plus(m21, m22, m1) and _split_r2
    "4r2_cand_R2": [rec("p_1"), N("p_2"), rec("p_21", pos=2100, n=20),
                    rec("p_22", pos=2300, n=20)],
    "4r2_cand_R1": [rec("p_1"), N("p_2"), rec("p_21", pos=2100, n=20),
                    rec("p_22", pos=300, n=20)],
    "4r2_pair": [rec("p_1"), N("p_2"), rec("p_21", pos=2100, n=20),
                 rec("p_22", pos=3100, n=20)],
    "4r2_collapse": [rec("p_1"), N("p_2"), M("p_21", pos=2100, n=20),
                     rec("p_22", pos=300, n=20)],
    "4r2_m21_multi": [rec("p_1"), N("p_2"), M("p_21", pos=2100, n=20),
                      rec("p_22", pos=3100, n=20)],
    "4r2_m22_multi": [rec("p_1"), N("p_2"), rec("p_21", pos=2100, n=20),
                      M("p_22", pos=3100, n=20)],
    # ["1","1","2","2"]: reads of length != read_len, first offender decides
    "1122_row": [N("p_1"), rec("p_1", pos=150, n=60), N("p_2"),
                 rec("p_2", pos=2500, n=60)],
    "1122_multi_then_unmapped": [N("p_1"), M("p_1", n=60), N("p_2"),
                                 N("p_2", 60)],
    "1122_unmapped_then_multi": [N("p_1"), N("p_1", 60), N("p_2"),
                                 M("p_2", n=60)],
    "1122_one_short": [N("p_1"), rec("p_1", n=150), N("p_2"),
                       rec("p_2", n=60)],
    "1122_longer_counts": [rec("p_1", n=150), rec("p_1", pos=150, n=170),
                           rec("p_2", n=150), rec("p_2", pos=2500, n=60)],
    # n == 5: the whole mate is the first of its tag shorter than read_len
    "5r1_cand_R2": [N("p_1"), rec("p_11", n=20),
                    rec("p_12", pos=2100, n=20), N("p_2"),
                    rec("p_2", pos=2200, n=60)],
    "5r1_no_short_2": [N("p_1"), rec("p_11", n=20), rec("p_12", n=20),
                       rec("p_2", pos=2200, n=150),
                       rec("p_2", pos=2300, n=170)],
    "5r1_pair": [N("p_1"), rec("p_11", n=20), rec("p_12", pos=1500, n=20),
                 N("p_2"), rec("p_2", pos=2500, n=60)],
    "5r2_cand_R1": [N("p_1"), rec("p_1", n=60), N("p_2"),
                    rec("p_21", pos=2100, n=20), rec("p_22", pos=300, n=20)],
    "5r2_no_short_1": [rec("p_1", n=150), rec("p_1", n=170), N("p_2"),
                       rec("p_21", n=20), rec("p_22", n=20)],
    "5r2_m22_multi": [N("p_1"), rec("p_1", n=60), N("p_2"),
                      rec("p_21", pos=2100, n=20), M("p_22", n=20)],
    "5_unknown": [N("p_1"), rec("p_11", n=20), rec("p_12", n=20),
                  rec("p_2"), rec("p_21", n=20)],
    # n == 6: _six
    "6_merged_row": [N("p_1"), rec("p_11", pos=100, n=20),
                     rec("p_12", pos=200, n=20), N("p_2"),
                     rec("p_21", pos=2100, n=20),
                     rec("p_22", pos=2200, n=20)],
    "6_same_mid_other_chrom": [N("p_1"), rec("p_11", pos=100, n=20),
                               rec("p_12", ref="chr2", pos=100, n=20),
                               N("p_2"), rec("p_21", pos=2100, n=20),
                               rec("p_22", pos=2200, n=20)],
    "6_f11_f12_R1": [N("p_1"), rec("p_11", pos=100, n=20),
                     rec("p_12", pos=200, n=20), N("p_2"),
                     rec("p_21", pos=2100, n=20),
                     rec("p_22", pos=3100, n=20)],
    "6_f21_f22": [N("p_1"), rec("p_11", pos=100, n=20),
                  rec("p_12", pos=1100, n=20), N("p_2"),
                  rec("p_21", pos=2100, n=20), rec("p_22", pos=2200, n=20)],
    "6_f12_f22": [N("p_1"), rec("p_11", pos=100, n=20),
                  rec("p_12", pos=1100, n=20), N("p_2"),
                  rec("p_21", pos=2100, n=20), rec("p_22", pos=1200, n=20)],
    "6_all_apart": [N("p_1"), rec("p_11", pos=100, n=20),
                    rec("p_12", pos=1100, n=20), N("p_2"),
                    rec("p_21", pos=2100, n=20),
                    rec("p_22", pos=3100, n=20)],
    "6_m11_multi_split_r2": [N("p_1"), M("p_11", n=20),
                             rec("p_12", pos=1100, n=20), N("p_2"),
                             rec("p_21", pos=2100, n=20),
                             rec("p_22", pos=3100, n=20)],
    "6_m11_m22_multi": [N("p_1"), M("p_11", n=20), rec("p_12", n=20),
                        N("p_2"), rec("p_21", pos=2100, n=20),
                        M("p_22", n=20)],
    "6_m11_m21_multi": [N("p_1"), M("p_11", n=20), rec("p_12", n=20),
                        N("p_2"), M("p_21", n=20),
                        rec("p_22", pos=3100, n=20)],
    "6_m21_multi_split_r1": [N("p_1"), rec("p_11", pos=100, n=20),
                             rec("p_12", pos=1100, n=20), N("p_2"),
                             M("p_21", n=20), rec("p_22", pos=1200, n=20)],
    "6_m12_multi_switch": [N("p_1"), rec("p_11", pos=100, n=20),
                           M("p_12", n=20), N("p_2"),
                           rec("p_21", pos=2100, n=20),
                           rec("p_22", pos=2200, n=20)],
    "6_side1_unmapped": [N("p_1"), N("p_11", 20), N("p_12", 20), N("p_2"),
                         rec("p_21", n=20), rec("p_22", n=20)],
    "6_side2_multi": [N("p_1"), rec("p_11", n=20), rec("p_12", n=20),
                      N("p_2"), M("p_21", n=20), M("p_22", n=20)],
    "6_other_two_anything": [rec("p_11", n=20), rec("p_11", pos=900, n=20),
                             rec("p_12", pos=200, n=20),
                             rec("p_21", pos=2100, n=20),
                             rec("p_22", pos=2200, n=20),
                             rec("p_x", pos=2200, n=20)],
    "6_missing_22": [N("p_1"), rec("p_11", n=20), rec("p_12", n=20),
                     N("p_2"), rec("p_2", n=20), rec("p_21", n=20)],
    # sizes with no branch
    "1_read": [rec("p_1")],
    "7_reads": [N("p_1"), rec("p_1", n=20), rec("p_11", n=20),
                rec("p_12", n=20), N("p_2"), rec("p_21", n=20),
                rec("p_22", n=20)],
    "4_unknown_set": [rec("p_1"), rec("p_2"), rec("p_2", n=20),
                      rec("p_2", n=30)],
}


@pytest.fixture(scope="module")
def frag_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("frags") / "frags.txt"
    p.write_text(FRAGS)
    return str(p)


def _expect(want):
    if isinstance(want, tuple):
        return PP.PAIR, ["\t".join(r) for r in want]
    if isinstance(want, list):
        return PP.ROW, ["\t".join(want)]
    if isinstance(want, str):
        return PP.EMPTY, []
    return {JP.UNMAPPED: PP.UNM, JP.MULTI: PP.MULT}[want], []


def _resolve(tmp_path, frag_path, group, snps=None, allelic="", level=1,
             read_len=150):
    """(JAX's resolution of the group, the port's kinds and rows)."""
    sam = tmp_path / "g.sam"
    write_sam(str(sam), group)
    records = sorted(read_sam(str(sam)), key=lambda r: r.query_name)
    want = JP.PairResolver(JP.load_fragments(frag_path), snps, allelic,
                           level, read_len).resolve(records)
    aln = PS.read_sam(str(sam))
    res = PP.PairResolver(PP.load_fragments(frag_path), snps, allelic, level,
                          read_len, device=CPU).resolve(aln)
    bed = tmp_path / "g.bed"
    PP.write_rows(str(bed), aln, res)
    return want, res.kind.tolist(), bed.read_text().splitlines()


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_branch_matches_jax(tmp_path, frag_path, case):
    want, kinds, lines = _resolve(tmp_path, frag_path, CASES[case],
                                  SNPS, "Maternal")
    kind, rows = _expect(want)
    assert kinds == [kind]
    assert lines == rows


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("allelic", ["Maternal", "Paternal"])
def test_levels_and_haplotypes(tmp_path, frag_path, level, allelic):
    for name in ("2_weak_multi", "2_unique", "3_skip_unmapped"):
        want, kinds, lines = _resolve(tmp_path, frag_path, CASES[name],
                                      SNPS, allelic, level)
        kind, rows = _expect(want)
        assert kinds == [kind] and lines == rows, name


def test_read_len_is_the_sentinel(tmp_path, frag_path):
    """The 1122 branch keeps reads of length != read_len: at read_len 60
    the 150-base originals count and the 60-base rescues do not."""
    for read_len in (60, 150, 170):
        for name in ("1122_row", "1122_longer_counts", "5r1_cand_R2",
                     "5r1_no_short_2"):
            want, kinds, lines = _resolve(tmp_path, frag_path, CASES[name],
                                          read_len=read_len)
            kind, rows = _expect(want)
            assert kinds == [kind] and lines == rows, (read_len, name)


def test_a_printed_read_without_AS_raises_in_both(tmp_path, frag_path):
    group = [rec("p_1", tag_as=None), rec("p_2", pos=1500),
             rec("p_2", pos=2500, n=30)]
    with pytest.raises(KeyError):
        _resolve(tmp_path, frag_path, group)
    sam = tmp_path / "g.sam"
    aln = PS.read_sam(str(sam))
    with pytest.raises(KeyError):
        PP.PairResolver(PP.load_fragments(frag_path), device=CPU).resolve(
            aln)


# ------------------------------------------------------------ the parts
def test_frag_mid_matches_jax(frag_path):
    jf, pf = JP.load_fragments(frag_path), PP.load_fragments(frag_path)
    assert list(jf) == list(pf) == ["1", "2"]
    for c in jf:
        np.testing.assert_array_equal(jf[c], pf[c])
    table = PP.frag_table(pf, device=CPU)
    pos = np.array([-5, 0, 1, 2, 998, 999, 1000, 1001, 2500, 3999, 4000,
                    9999, 1 << 41])
    for i, c in enumerate(pf):
        got = PP.frag_mid(table, torch.full((len(pos),), i),
                          torch.from_numpy(pos)).tolist()
        want = [JP.frag_mid(jf, rec("x_1", ref=c, pos=int(p)))
                for p in pos]
        assert got == want
    assert PP.frag_mid(table, torch.tensor([-1]),
                       torch.tensor([5])).tolist() == [-1]


def test_load_fragments_refuses_short_lines(tmp_path):
    p = tmp_path / "f.txt"
    p.write_text("1\t0\t100\n1\t100\n")
    with pytest.raises(ValueError, match=":2:"):
        PP.load_fragments(str(p))
    with pytest.raises(IndexError):
        JP.load_fragments(str(p))


def test_snps_match_matches_jax():
    rng = np.random.default_rng(5)
    snps = {"1": {"pos": np.sort(rng.choice(np.arange(1, 3000), 300,
                                            replace=False)),
                  "m_alt": rng.choice(list("ACGT"), 300),
                  "p_alt": rng.choice(["A", "C", "AG", ""], 300)},
            "X": {"pos": np.array([10, 20]), "m_alt": np.array(["A", "C"]),
                  "p_alt": np.array(["C", "A"])}}
    recs = []
    for i in range(400):
        ref = rng.choice(["1", "chr1", "X", "2"])
        n = int(rng.integers(1, 160))
        seq = "".join(rng.choice(list("ACGT"), n)) if i % 50 else "*"
        recs.append(rec(f"r{i}_1", ref=ref, pos=int(rng.integers(-2, 3000)),
                        seq=seq))
    text = "".join(f"{r.query_name}\t0\t{r.reference_name}\t{r.pos + 1}\t42"
                   f"\t*\t*\t0\t0\t{r.seq}\t*\tAS:i:0\n" for r in recs)
    refs = []
    aln = PS.concat([PS._parse_sam_plain(text.encode(), refs)], refs)
    labels = list(snps)
    _, idx = PP.ref_tables(aln.refs, labels)
    chrom = torch.from_numpy(idx[aln.ref + 1])
    for allelic in ("Maternal", "Paternal"):
        table = snp_table(snps, labels, allelic, device=CPU)
        got = PP.snps_match(table, chrom, torch.from_numpy(aln.pos),
                            torch.from_numpy(aln.qlen.astype(np.int64)),
                            torch.from_numpy(aln.seqs),
                            torch.from_numpy(aln.seq_off),
                            torch.from_numpy(aln.seq_len.astype(np.int64)))
        want = [JP.snps_match(r, snps, allelic) for r in recs]
        assert got.tolist() == want
        assert sum(want) > 20


@pytest.mark.parametrize("level", [1, 2])
def test_unmapped_and_unique_match_jax(level):
    recs = [rec("a_1"), rec("a_1", ref="chr1"), rec("a_1", ref="X"),
            rec("a_1", ref="Y"), rec("a_1", ref="MT"), rec("a_1", ref="chrM"),
            rec("a_1", ref="1_random"), N("a_1"), rec("a_1", flag=4),
            rec("a_1", tag_as=None), M("a_1"),
            rec("a_1", tag_as=-3, tag_xs=-9), rec("a_1", tag_as=-9,
                                                  tag_xs=-3)]
    text = "".join(
        f"a_1\t{r.flag}\t{r.reference_name or '*'}\t{r.pos + 1}\t42\t*\t*\t0"
        f"\t0\tACGT\t*" + (f"\tAS:i:{r.tag_as}" if r.tag_as is not None
                           else "")
        + (f"\tXS:i:{r.tag_xs}" if r.tag_xs is not None else "") + "\n"
        for r in recs)
    labels = []
    aln = PS.concat([PS._parse_sam_plain(text.encode(), labels)], labels)
    unm_np, _ = PP.ref_tables(aln.refs, [])
    unm = PP.is_unmapped_read(torch.from_numpy(aln.flag),
                              torch.from_numpy(aln.ref),
                              torch.from_numpy(unm_np))
    uniq = PP.is_unique_read(unm, torch.from_numpy(aln.has),
                             torch.from_numpy(aln.tag_as),
                             torch.from_numpy(aln.tag_xs), level)
    assert unm.tolist() == [JP.is_unmapped_read(r) for r in recs]
    assert uniq.tolist() == [JP.is_unique_read(r, level) for r in recs]


def test_groups_split_where_names_interleave(tmp_path):
    """``a_1, a_11, a_12, a_1x_1, a_1x_2, a_2``: base ``a`` is cut in two
    by base ``a_1x``, as the JAX package's iter_groups cuts it."""
    names = ["a_2", "a_1x_2", "a_12", "a_1", "a_1x_1", "a_11", "b_1", "b_1"]
    group = [rec(n, pos=100 * i) for i, n in enumerate(names)]
    sam = tmp_path / "g.sam"
    write_sam(str(sam), group)
    records = sorted(read_sam(str(sam)), key=lambda r: r.query_name)
    want = [[r.pos for r in g] for g in JP.iter_groups(records)]
    aln = PS.read_sam(str(sam))
    got = [(aln.pos[g]).tolist() for g in PP.iter_groups(aln, device=CPU)]
    assert got == want
    assert [len(g) for g in want] == [3, 2, 1, 2]


def test_name_order_is_str_order_stable_in_file_order(tmp_path):
    """Names with shared prefixes, ``_`` against digits, bytes above
    0x7f, longer than 8 bytes, and equal names in several files."""
    rng = np.random.default_rng(3)
    pool = ["a", "a_", "a_1", "a_10", "a_1_", "a1", "ab", "é_1", "z" * 19,
            "z" * 19 + "_2", "SRR1.12_1", "SRR1.1_1", "SRR1.1_11"]
    files, recs = [], []
    for k in range(3):
        group = [rec(str(rng.choice(pool)), pos=1000 * k + i)
                 for i in range(40)]
        path = tmp_path / f"f{k}.sam"
        write_sam(str(path), group)
        files.append(str(path))
        recs += read_sam(str(path))
    want = [r.pos for r in sorted(recs, key=lambda r: r.query_name)]
    aln = PS.merge([PS.read_sam(f) for f in files])
    order = np.concatenate(PP.iter_groups(aln, device=CPU))
    assert aln.pos[order].tolist() == want
