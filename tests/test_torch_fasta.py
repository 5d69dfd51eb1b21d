"""The port's FASTA, SNP-table and site-search functions
(hichap_master_tpu_torch.io.fasta) against the JAX package's
(hichap_master_tpu/io/fasta.py) on the same files, the port on the CPU.

Everything compared is bytes, strings or integers, so the tolerance is
none: the sequences read, the FASTA written and the SNP arrays (values and
dtypes) are equal, and ``find_sites`` gives the same offsets.  The files
are crafted for the traps of Python's text mode: ``\\r\\n`` and lone
``\\r`` line ends, trailing blanks kept in a sequence, a later record of
the same name replacing an earlier one, lines before the first header,
``chr`` stripped after ``split()[0]``, an empty header, text outside ASCII;
for the SNP table, positions that only Python's ``int()`` reads, repeated
positions (the stable sort keeps file order), short lines and alleles of
several characters."""

import gzip

import numpy as np
import pytest
import torch

from hichap_master_tpu.io import fasta as J
from hichap_master_tpu_torch.io import fasta as P

torch.set_num_threads(1)

FASTAS = {
    "plain": b">chr1 desc\nACGTacgt\nNNNN\n>2\nGGCC\n",
    "crlf": b">chrX\r\nACGT\r\nAC\r\n",
    "lone_cr": b">chrX\rACGT\rAC\r>chr2\rTT",
    "blanks": b">1\nAC  \n\t\n \nGT\n\n",
    "duplicate": b">chr1\nAAAA\n>2\nCC\n>1\nGGG\n",
    "pre_header": b"junk line\nACGT\n>3 x\nTTT\n",
    "empty_record": b">1\n>2\nAC\n>3\n",
    "tabs_in_header": b">chr7\tsecond\tthird\nACGT\n",
    "utf8": ">é x\nACéGT\n>2\nAC\n".encode(),
    "no_final_newline": b">1\nACGT",
    "empty": b"",
    "long_lines": b">1\n" + b"ACGT" * 5000 + b"\n>2\n" + b"T" * 61 + b"\n",
}


def _write(path, data, gz):
    if gz:
        with gzip.open(path, "wb") as f:
            f.write(data)
    else:
        with open(path, "wb") as f:
            f.write(data)
    return str(path)


def _same_genome(a, b):
    assert list(a) == list(b)
    for c in a:
        assert a[c].dtype == b[c].dtype == np.uint8
        assert a[c].tobytes() == b[c].tobytes(), c


@pytest.mark.parametrize("gz", [False, True], ids=["fa", "fa.gz"])
@pytest.mark.parametrize("case", sorted(FASTAS))
def test_read_and_write_fasta_as_in_the_jax_package(tmp_path, case, gz):
    path = _write(tmp_path / ("g.fa" + (".gz" if gz else "")), FASTAS[case],
                  gz)
    want, got = J.read_fasta(path), P.read_fasta(path)
    _same_genome(want, got)
    J.write_fasta(str(tmp_path / "j.fa"), want)
    P.write_fasta(str(tmp_path / "p.fa"), got)
    assert (tmp_path / "p.fa").read_bytes() == (tmp_path / "j.fa").read_bytes()


def test_blocks_cut_inside_lines_read_the_same(tmp_path, monkeypatch):
    """Blocks of a few bytes: lines and ``\\r\\n`` pairs torn across blocks
    are put back together."""
    data = b"".join(FASTAS[k] for k in ("crlf", "blanks", "lone_cr",
                                        "long_lines"))
    path = _write(tmp_path / "g.fa", data, False)
    want = J.read_fasta(path)
    for size in (1, 2, 3, 7, 64):
        monkeypatch.setattr(P, "READ_BYTES", size)
        _same_genome(want, P.read_fasta(path))


@pytest.mark.parametrize("header", [b">\n", b">   \n", b">\t\r\n"])
def test_an_empty_header_raises_as_in_the_jax_package(tmp_path, header):
    path = _write(tmp_path / "g.fa", header + b"ACGT\n", False)
    with pytest.raises(IndexError):
        J.read_fasta(path)
    with pytest.raises(IndexError):
        P.read_fasta(path)


def test_text_that_is_not_utf8_raises_as_in_the_jax_package(tmp_path):
    path = _write(tmp_path / "g.fa", b">1\nAC\xffGT\n", False)
    with pytest.raises(UnicodeDecodeError):
        J.read_fasta(path)
    with pytest.raises(UnicodeDecodeError):
        P.read_fasta(path)


def test_write_fasta_wraps_tensors_on_their_device(tmp_path):
    rng = np.random.default_rng(0)
    chroms = {c: rng.choice(np.frombuffer(b"ACGTacgtN", np.uint8), n)
              for c, n in (("10", 121), ("2", 60), ("X", 0), ("1", 59))}
    J.write_fasta(str(tmp_path / "j.fa"), chroms)
    P.write_fasta(str(tmp_path / "p.fa"),
                  {c: torch.from_numpy(a) for c, a in chroms.items()})
    assert (tmp_path / "p.fa").read_bytes() == (tmp_path / "j.fa").read_bytes()
    for width in (1, 7, 50):
        J.write_fasta(str(tmp_path / "j.fa"), chroms, width)
        P.write_fasta(str(tmp_path / "p.fa"), chroms, width)
        assert (tmp_path / "p.fa").read_bytes() == (
            tmp_path / "j.fa").read_bytes()


def test_write_fasta_raises_on_bytes_that_are_not_text(tmp_path):
    chroms = {"1": np.frombuffer(b"ACGT", np.uint8),
              "2": np.frombuffer(b"AC\xffT", np.uint8)}
    with pytest.raises(ValueError):
        J.write_fasta(str(tmp_path / "j.fa"), chroms)
    with pytest.raises(ValueError, match="chromosome '2'"):
        P.write_fasta(str(tmp_path / "p.fa"), chroms)


SNPS = {
    "plain": b"chr1 10 A C G\n1\t5 A T T\nchr2 3 A G C extra\n",
    "line_ends": b"1 10 A G A\r2 7 A C G\r\n3 4 C T T\n",
    "python_ints": b"2 1_000 A C G\n3 +7 A C G\n1 -3 A C C\n1 0 T A A\n",
    "short_and_blank": b"# comment\nshort 1 2\n\n   \n1 5 A C G",
    "repeated": b"1 9 A C G\n1 3 A T T\n1 9 A G A\n1 9 A A C\n",
    "long_alleles": b"1 5 AT G C\n1 6 A GGT CC\n2 1 A C G\n",
    "utf8": "xé 4 é C G\n1 2 A C G\n".encode(),
    "chr_prefixes": b"chr1 5 A C G\n1 4 A C G\nchrX 3 A C G\nX 2 A C G\n",
}


def _same_snps(a, b):
    assert list(a) == list(b)
    for c in a:
        assert list(a[c]) == list(b[c])
        for k in a[c]:
            assert a[c][k].dtype == b[c][k].dtype, (c, k)
            assert np.array_equal(a[c][k], b[c][k]), (c, k)


@pytest.mark.parametrize("gz", [False, True], ids=["txt", "txt.gz"])
@pytest.mark.parametrize("case", sorted(SNPS))
def test_parse_snp_file_as_in_the_jax_package(tmp_path, case, gz):
    path = _write(tmp_path / ("s.txt" + (".gz" if gz else "")), SNPS[case],
                  gz)
    _same_snps(J.parse_snp_file(path), P.parse_snp_file(path))


@pytest.mark.parametrize("case", ["plain", "utf8"])
def test_the_host_paths_name_their_file_in_a_warning(tmp_path, case,
                                                     caplog):
    """Text outside ASCII leaves the C++ scan or the wrap on the device
    for Python on the host; each time a warning names the file."""
    fa = _write(tmp_path / "g.fa", FASTAS[case], False)
    txt = _write(tmp_path / "s.txt", SNPS[case], False)
    out = str(tmp_path / "p.fa")
    with caplog.at_level("WARNING"):
        P.write_fasta(out, P.read_fasta(fa))
        P.parse_snp_file(txt)
    warned = [r.getMessage() for r in caplog.records
              if r.levelname == "WARNING"]
    if case == "plain":
        assert warned == []
    else:
        assert [m for m in warned if out in m]
        assert [m for m in warned if txt in m]


def test_a_position_that_is_no_integer_raises(tmp_path):
    path = _write(tmp_path / "s.txt", b"1 5 A C G\n1 x5 A C G\n", False)
    with pytest.raises(ValueError):
        J.parse_snp_file(path)
    with pytest.raises(ValueError):
        P.parse_snp_file(path)


def test_a_drawn_snp_table_saves_and_loads_the_same(tmp_path):
    rng = np.random.default_rng(3)
    lines = [f"chr{rng.integers(1, 5)}\t{rng.integers(1, 10_000)}\t"
             f"{'ACGT'[rng.integers(4)]}\t{'ACGT'[rng.integers(4)]}\t"
             f"{'ACGT'[rng.integers(4)] * int(rng.integers(1, 3))}"
             for _ in range(20_000)]
    path = _write(tmp_path / "s.txt", ("\n".join(lines) + "\n").encode(),
                  False)
    want, got = J.parse_snp_file(path), P.parse_snp_file(path)
    _same_snps(want, got)
    J.save_snps(want, str(tmp_path / "j.npz"))
    P.save_snps(got, str(tmp_path / "p.npz"))
    _same_snps(J.load_snps(str(tmp_path / "j.npz")),
               P.load_snps(str(tmp_path / "p.npz")))


@pytest.mark.parametrize("site", ["GATC", "AAGCTT", "AA", "A", "",
                                  "GATCGATC", "gatc"])
def test_find_sites_as_in_the_jax_package(site):
    rng = np.random.default_rng(len(site))
    seq = rng.choice(np.frombuffer(b"ACGTacgtN", np.uint8), 50_000)
    seq[100:120] = np.frombuffer(b"AAAAAAGATCGATCGATCgg", np.uint8)
    want = J.find_sites(seq, site)
    got = P.find_sites(torch.from_numpy(seq), site)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(P.find_sites_plain(seq, site), want)


def test_find_sites_on_a_sequence_shorter_than_the_site():
    seq = np.frombuffer(b"GAT", np.uint8).copy()
    assert np.array_equal(P.find_sites(torch.from_numpy(seq), "GATC").numpy(),
                          J.find_sites(seq, "GATC"))
