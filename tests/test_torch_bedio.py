"""The port's bed scanners (hichap_master_tpu_torch.io.bedio: the host C++
scanners of csrc/bedparse.cpp, and the numpy plain parsers) against the
JAX package's readers, through its native scanner and its pandas path
(HICHAP_NATIVE_BED=0), on the same files.  Every comparison is exact:
values and dtypes."""

import os

import numpy as np
import pytest
import torch

from hichap_master_tpu.core import Genome as JGenome
from hichap_master_tpu.io import bedio as JB
from hichap_master_tpu_torch.core import Genome
from hichap_master_tpu_torch.io import bedio as PB
from hichap_master_tpu_torch.kernels import _build

torch.set_num_threads(1)

SIZES = {"1": 1_000_000, "2": 1_000_000, "7": 500_000, "X": 300_000}
NAMES = ["1", "chr1", "2", "chr2", "chrUn", "7", "X", "chrX", "M"]


@pytest.fixture
def genomes():
    return JGenome(SIZES), Genome(SIZES)


def _valid_line(c1, p1, c2, p2, ncols):
    f = ["x"] * ncols
    f[1], f[6], f[8], f[13] = str(c1), str(p1), str(c2), str(p2)
    return "\t".join(f)


def _valid_file(tmp_path, n=800, seed=3):
    rng = np.random.default_rng(seed)
    p = tmp_path / "mix_Valid.bed"
    lines = [_valid_line(NAMES[rng.integers(0, len(NAMES))],
                         rng.integers(0, 1_000_000),
                         NAMES[rng.integers(0, len(NAMES))],
                         rng.integers(0, 1_000_000),
                         int(rng.choice([15, 23]))) for _ in range(n)]
    p.write_text("\n".join(lines) + "\n")
    return str(p)


def _allelic_file(tmp_path, n=700, seed=5, tagless_share=0.1):
    rng = np.random.default_rng(seed)
    p = tmp_path / "alle.bed"
    tags = ["Both", "R1", "R2", "XX"]
    lines = []
    for _ in range(n):
        row = "%s\t%d\t%s\t%d" % (
            NAMES[rng.integers(0, len(NAMES))], rng.integers(0, 1_000_000),
            NAMES[rng.integers(0, len(NAMES))], rng.integers(0, 1_000_000))
        if rng.random() >= tagless_share:
            row += "\t" + tags[rng.integers(0, len(tags))]
        lines.append(row)
    p.write_text("\n".join(lines) + "\n")
    return str(p)


def _cat(parts, width):
    return [np.concatenate([pt[i] for pt in parts]) for i in range(width)]


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("jax_path", ["1", "0"], ids=["native", "pandas"])
def test_valid_bed_matches_jax(tmp_path, genomes, monkeypatch, jax_path):
    """Ragged 15/23 columns, chr prefixes, unknown chromosomes; blocks
    that end mid-file (777 bytes)."""
    jg, pg = genomes
    path = _valid_file(tmp_path)
    monkeypatch.setenv("HICHAP_NATIVE_BED", jax_path)
    want = _cat(list(JB.iter_valid_bed([path], jg, read_bytes=777)), 4)
    got = _cat(list(PB.iter_valid_bed([path], pg, read_bytes=777)), 4)
    _same(got, want)
    _same(PB.read_valid_bed([path], pg), JB.read_valid_bed([path], jg))
    assert 0 < len(got[0]) < 800


@pytest.mark.parametrize("jax_path", ["1", "0"], ids=["native", "pandas"])
@pytest.mark.parametrize("with_tag", [True, False], ids=["tag", "notag"])
def test_allelic_bed_matches_jax(tmp_path, genomes, monkeypatch, jax_path,
                                 with_tag):
    """Both/R1/R2/other tags, tag-less rows (-1), chr prefixes, unknown
    chromosomes."""
    jg, pg = genomes
    path = _allelic_file(tmp_path)
    monkeypatch.setenv("HICHAP_NATIVE_BED", jax_path)
    w = 5 if with_tag else 4
    want = JB.read_allelic_bed([path], jg, with_tag)
    got = PB.read_allelic_bed([path], pg, with_tag)
    _same(got, want)
    _same(_cat(list(PB.iter_allelic_bed([path], pg, with_tag,
                                        chunk_rows=37)), w), want)
    if with_tag:
        assert set(got[4].tolist()) == {-1, 0, 1, 2}


@pytest.mark.parametrize("chunk_rows", [1, 2, 3, 4, 5, 6, 7])
def test_allelic_chunk_rows_hold_exactly(tmp_path, genomes, chunk_rows):
    jg, pg = genomes
    path = _allelic_file(tmp_path, n=40)
    want = list(JB.iter_allelic_bed([path], jg, True, chunk_rows=chunk_rows))
    got = list(PB.iter_allelic_bed([path], pg, True, chunk_rows=chunk_rows))
    assert [len(p[0]) for p in got] == [len(p[0]) for p in want]
    assert all(len(p[0]) <= chunk_rows for p in got)
    _same(_cat(got, 5), _cat(want, 5))


def test_crlf_and_tagless_rows(tmp_path, genomes):
    jg, pg = genomes
    a = tmp_path / "crlf.bed"
    a.write_bytes(b"1\t100\t2\t200\tBoth\r\n2\t300\t1\t400\tR1\r\n"
                  b"1\t500\t1\t600\r\nchr7\t1\tX\t2\tR2")  # no final newline
    v = tmp_path / "crlf_Valid.bed"
    row = "\t".join(["r1", "1", "+", "100", "60", "100", "100", "f1",
                     "2", "-", "200", "60", "100", "200", "f2"])
    v.write_bytes((row + "\r\n" + row + "\r\n").encode())
    got = PB.read_allelic_bed([str(a)], pg, True)
    assert got[4].tolist() == [0, 1, -1, 2]
    _same(got, JB.read_allelic_bed([str(a)], jg, True))
    _same(PB.read_valid_bed([str(v)], pg), JB.read_valid_bed([str(v)], jg))
    assert len(PB.read_valid_bed([str(v)], pg)[0]) == 2


MALFORMED = (b"1\t100\t2\t200\tBoth\n"
             b"1\t1234567890123456789\t2\t5\tR1\n"      # 19 digits: dropped
             b"1\t123456789012345678\t2\t5\tR1\n"       # 18: kept
             b"1\t-42\t2\t7\tR2\n"                       # negative: kept
             b"1\t-\t2\t7\n"                             # a bare sign
             b"1\t\t2\t7\n"                              # empty position
             b"1\t12a\t2\t7\n"                           # not a number
             b"1\t10\t2\n"                               # a missing field
             b"\n\r\n"                                   # empty lines
             b"chrchr1\t1\t1\t1\n"                       # 'chr' once only
             b"2\t3\tchr2\t4\tchrBoth\textra\n")         # tag verbatim


def test_malformed_rows_dropped_as_jax_native(tmp_path, genomes,
                                              monkeypatch):
    jg, pg = genomes
    p = tmp_path / "bad.bed"
    p.write_bytes(MALFORMED)
    monkeypatch.setenv("HICHAP_NATIVE_BED", "1")
    for with_tag in (True, False):
        got = PB.read_allelic_bed([str(p)], pg, with_tag)
        _same(got, JB.read_allelic_bed([str(p)], jg, with_tag))
        _same(PB._parse_allelic_plain(MALFORMED, pg.labels, with_tag), got)
    assert got[1].tolist() == [100, 123456789012345678, -42, 3]


def test_plain_parsers_match_the_scanners(tmp_path, genomes):
    _, pg = genomes
    for path in (_valid_file(tmp_path, seed=9),
                 _allelic_file(tmp_path, seed=10)):
        buf = open(path, "rb").read() + MALFORMED
        buf = buf.replace(b"\n", b"\r\n", 50)
        _same(PB._parse_valid_plain(buf, pg.labels),
              PB._parse_valid(buf, pg.labels))
        for with_tag in (True, False):
            _same(PB._parse_allelic_plain(buf, pg.labels, with_tag),
                  PB._parse_allelic(buf, pg.labels, with_tag))


def test_empty_files(tmp_path, genomes):
    jg, pg = genomes
    p = tmp_path / "empty.bed"
    p.write_bytes(b"")
    _same(PB.read_allelic_bed([str(p)], pg, True),
          JB.read_allelic_bed([str(p)], jg, True))
    _same(PB.read_valid_bed([str(p)], pg), JB.read_valid_bed([str(p)], jg))
    assert list(PB.iter_allelic_bed([str(p)], pg, False)) == []
    _same(PB._parse_allelic_plain(b"", pg.labels, True),
          PB._parse_allelic(b"", pg.labels, True))
    _same(PB._parse_valid_plain(b"\n", pg.labels),
          PB._parse_valid(b"\n", pg.labels))


def test_line_blocks_end_at_newlines(tmp_path):
    p = tmp_path / "b.bed"
    text = b"".join(b"%d\tabc\n" % i for i in range(300))
    p.write_bytes(text + b"tail-without-newline")
    blocks = list(PB._iter_line_blocks(str(p), 64))
    assert b"".join(blocks) == text + b"tail-without-newline"
    assert all(b.endswith(b"\n") for b in blocks[:-1]) and len(blocks) > 10
    assert blocks == list(JB._iter_line_blocks(str(p), 64))


def test_discover_and_prefix(tmp_path):
    d = tmp_path / "beds"
    d.mkdir()
    for k in PB.ALLELIC_CLASSES:
        (d / f"GM_R1_Valid_{k}.bed").write_text("")
    (d / "notes.txt").write_text("")
    got = PB.discover_allelic_beds(str(d))
    assert got == JB.discover_allelic_beds(str(d))
    files = [f for v in got.values() for f in v]
    assert PB.bed_prefix(files) == JB.bed_prefix(files) == "GM_R1_"
    os.remove(d / "GM_R1_Valid_P_M.bed")
    with pytest.raises(FileNotFoundError, match="P_M"):
        PB.discover_allelic_beds(str(d))


def test_loaders_give_the_matrix_stage_its_tensors(tmp_path, genomes):
    jg, pg = genomes
    d = tmp_path / "rep"
    d.mkdir()
    src = _allelic_file(tmp_path)
    for k in PB.ALLELIC_CLASSES:
        os.link(src, d / f"C_Valid_{k}.bed")
    got = PB.allelic_classes(str(d), pg, device="cpu")
    assert list(got) == list(PB.ALLELIC_CLASSES)
    for k, cols in got.items():
        tagged = k in ("M_M", "P_P")
        want = JB.read_allelic_bed([src], jg, tagged)
        assert len(cols) == len(want)
        _same([c.numpy() for c in cols], want)
    path = _valid_file(tmp_path)
    pairs = PB.valid_pairs([path, path], pg, device="cpu")
    want = JB.read_valid_bed([path, path], jg)
    _same([c.numpy() for c in pairs], want)
    empty = tmp_path / "e.bed"
    empty.write_bytes(b"")
    z = PB.valid_pairs([str(empty)], pg, device="cpu")
    assert [t.dtype for t in z] == [torch.int32, torch.int64, torch.int32,
                                    torch.int64] and z[0].numel() == 0


def test_host_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="host build failed"):
        _build.build_host(tmp_path / "lib.so")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="host compiler not found"):
        _build.build_host(tmp_path / "lib.so")
    assert _build.host_library_path().parent == _build.BUILD_DIR
    assert _build.HOST_SOURCE.name not in {p.name for p in _build.sources()}


# ------------------------------------------------- records (filtering stage)
RECORD_CHROMS = ["1", "chr1", "10", "chr10", "2", "chrUn_gl000220", "X",
                 "HLA-A*01:01"]


def _record_text(seed=7, n=500):
    """15/23-column records: ``chr`` prefixes and chromosomes no genome
    names, negative scores, markers other than R1/R2."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        f = [f"r{i}x" + "y" * int(rng.integers(0, 20))]
        for _ in range(2):
            f += [RECORD_CHROMS[rng.integers(0, len(RECORD_CHROMS))],
                  str(rng.choice([0, 16, 256, 272])),
                  str(rng.integers(0, 10**8)), "100",
                  str(-rng.integers(0, 60)), str(rng.integers(0, 10**8)),
                  str(rng.integers(0, 4))]
        if rng.random() < 0.3:
            f += [RECORD_CHROMS[rng.integers(0, len(RECORD_CHROMS))], "0",
                  str(rng.integers(0, 10**8)), "30",
                  str(-rng.integers(0, 60)), str(rng.integers(0, 10**8)),
                  str(rng.integers(0, 4)), str(rng.choice(["R1", "R2",
                                                           "R3"]))]
        out.append("\t".join(f))
    return out


@pytest.mark.parametrize("case", ["lf", "crlf", "no_final_newline",
                                  "small_blocks"])
def test_record_scanner_matches_its_plain_version(tmp_path, case):
    lines = _record_text()
    end = "\r\n" if case == "crlf" else "\n"
    text = end.join(lines) + ("" if case == "no_final_newline" else end)
    p = tmp_path / "c_chunk0.bed"
    p.write_bytes(text.encode())
    read_bytes = 700 if case == "small_blocks" else 1 << 20
    table, plain, base, parts = PB._Labels(16, 2), [], 0, []
    for buf in PB._iter_line_blocks(str(p), read_bytes):
        got = PB._parse_record(buf, base, table)
        want = PB._parse_record_plain(buf, base, plain)
        _same(got, want)
        parts.append(got)
        base += len(buf)
    assert table.strings() == plain
    assert len(parts) > (5 if case == "small_blocks" else 0)
    rec = PB.read_records([str(p)], read_bytes)
    assert rec.labels == plain
    assert set(plain) == {c.encode() for c in RECORD_CHROMS}
    np.testing.assert_array_equal(rec.off, np.concatenate(
        [q[0] for q in parts]))
    np.testing.assert_array_equal(rec.chrom, np.concatenate(
        [q[3] for q in parts], 1))
    # the columns as Python parses the lines
    assert rec.text.tobytes() == text.encode() and len(rec) == len(lines)
    for i, ln in enumerate(lines):
        f = ln.split("\t")
        assert rec.text[rec.off[i]:rec.off[i] + rec.length[i]].tobytes() \
            == ln.encode()
        assert rec.name_len[i] == len(f[0].encode())
        assert [rec.labels[c].decode() if c >= 0 else None
                for c in rec.chrom[:, i]] == [
            f[1], f[8], f[15] if len(f) > 15 else None]
        for c in PB.RECORD_INTS:
            assert rec.col(c)[i] == (int(f[c]) if c < len(f) else 0)
        assert rec.cand[i] == (
            {"R1": 1, "R2": 2}.get(f[22], 0) if len(f) > 22 else 0)


@pytest.mark.parametrize("bad,fields", [
    ("r\t1\t0\t5\t100\t-5\t0\t0\t2\t16\t9\t100\t-7\t0", "14 fields"),
    ("r\t1\t0\t5\t100\t-5\t0\t0\t2\t16\t9\t100\t-7\t0\t0\t1", "16 fields"),
    ("r\t1\t0\t5\t100\t-5\t0\t0\t2\t16\t9e3\t100\t-7\t0\t0",
     "no integer"),
    ("r\t1\t0\t5\t100\t-5\t0\t0\t2\t16\t9\t100\t-7\t0\t0\t1\t0\t5\t30\t-3"
     "\t0\t-\tR1", "no integer"),
    ("", "1 fields")])
def test_read_records_refuses_malformed_rows(tmp_path, bad, fields):
    good = "r\t1\t0\t5\t100\t-5\t0\t0\t2\t16\t9\t100\t-7\t0\t0"
    p = tmp_path / "x.bed"
    p.write_text("\n".join([good, good, bad, good]) + "\n")
    with pytest.raises(ValueError, match=f"x.bed:3: .*{fields}"):
        PB.read_records([str(p)])


def test_read_records_of_several_files_and_empty_ones(tmp_path):
    lines = _record_text(seed=8, n=60)
    paths = []
    for k, part in enumerate((lines[:25], [], lines[25:])):
        p = tmp_path / f"f{k}.bed"
        p.write_text("".join(ln + "\n" for ln in part))
        paths.append(str(p))
    rec = PB.read_records(paths, 300)
    assert len(rec) == 60
    assert [rec.text[o:o + n].tobytes().decode()
            for o, n in zip(rec.off, rec.length)] == lines
    empty = PB.read_records([paths[1]])
    assert len(empty) == 0 and empty.chrom.shape == (3, 0)


def test_write_lines_writes_chosen_lines_verbatim(tmp_path):
    lines = _record_text(seed=9, n=300)
    p = tmp_path / "x.bed"
    p.write_bytes(("\r\n".join(lines[:150]) + "\n"
                   + "\n".join(lines[150:])).encode())     # no final newline
    rec = PB.read_records([str(p)], 500)
    rows = np.random.default_rng(0).permutation(300)[:200]
    monkey = PB.WRITE_ROWS
    try:
        PB.WRITE_ROWS = 64                  # several chunks
        with open(tmp_path / "out.bed", "wb") as f:
            PB.write_lines(f, rec.text, rec.off, rec.length, rows)
    finally:
        PB.WRITE_ROWS = monkey
    got = (tmp_path / "out.bed").read_bytes()
    assert got == "".join(lines[i] + "\n" for i in rows).encode()
    assert got == PB._gather_plain(rec.text, rec.off, rec.length, rows)
    with pytest.raises(IndexError):
        PB.write_lines(None, rec.text, rec.off, rec.length, np.array([300]))


@pytest.mark.parametrize("fmt", ["_format_rows", "_format_rows_plain"])
def test_format_rows_negative_integers_and_short_rows(tmp_path, fmt):
    """The host formatter and its numpy twin write the lines Python's
    ``str`` formatting gives."""
    rng = np.random.default_rng(2)
    n = 500
    v = rng.integers(-10**6, 10**6, n)
    v[:3] = [0, -1, 10**15]
    names = rng.integers(0, 3, n)
    tail = rng.random(n) < 0.4
    tab, lens = PB._table([b"chr1", b"10", b"X"])
    text = np.frombuffer(b"abcdefgh", np.uint8)
    off, ln = rng.integers(0, 4, n), rng.integers(1, 5, n)
    fields = [[("text", text, off, ln)], [("word", tab, lens, names)],
              [("int", v)], [("const", b"Both")], [("int", -v)]]
    monkey = PB.WRITE_ROWS
    try:
        PB.WRITE_ROWS = 128
        with open(tmp_path / "f.bed", "wb") as f:
            getattr(PB, fmt)(fields, n, f, tail=4, tail_rows=tail)
    finally:
        PB.WRITE_ROWS = monkey
    words = ["chr1", "10", "X"]
    want = "".join(
        "\t".join([b"abcdefgh"[off[i]:off[i] + ln[i]].decode(),
                   words[names[i]], str(v[i]), "Both"]
                  + ([str(-v[i])] if tail[i] else [])) + "\n"
        for i in range(n))
    assert (tmp_path / "f.bed").read_text() == want


def test_format_rows_refuses_indices_outside_its_tables(tmp_path):
    tab, lens = PB._table([b"a", b"b"])
    text = np.frombuffer(b"abc", np.uint8)
    with open(tmp_path / "f.bed", "wb") as f:
        with pytest.raises(IndexError, match="word"):
            PB._format_rows([[("word", tab, lens, np.array([0, 2]))]], 2, f)
        with pytest.raises(IndexError, match="slice"):
            PB._format_rows([[("text", text, np.array([1]), np.array([3]))]],
                            1, f)
