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
