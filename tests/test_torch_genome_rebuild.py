"""The port's genome preparation (hichap_master_tpu_torch.pipeline.
genome_rebuild) against the JAX package's on the same files, the port on
the CPU: ``genomeSize``, both haplotypes' FASTAs and fragment tables, and
the non-allelic fragment table byte for byte; ``Snps.npz`` as loaded
arrays.

The inputs are the JAX package's ``diploid_dataset`` with SNP lines added
for the traps of ``_substitute``: a repeated position (numpy keeps the last
value; the stable sort makes that the file's last line), position 0 (index
-1: the chromosome's last base), the last position, an allele of several
characters (its first byte is written), a chromosome the genome lacks; and
genomes crafted for ``enzyme_fragments``: a cut at the chromosome's end
(``L L``), sites in soft-masked bases, chromosome names whose ``sorted()``
order is not numeric, an empty chromosome, and a gzipped FASTA."""

import os

import numpy as np
import pytest
import torch

from hichap_master_tpu.pipeline import genome_rebuild as J
from hichap_master_tpu.testing.synthetic import diploid_dataset
from hichap_master_tpu_torch.io.fasta import load_snps
from hichap_master_tpu_torch.pipeline import genome_rebuild as P

torch.set_num_threads(1)
CPU = torch.device("cpu")
EXTRA_SNPS = ("1\t0\tA\tC\tG\n1\t100\tA\tTT\tC\n1\t100\tA\tG\tA\n"
              "chr2\t20000\tA\tC\tG\nchr9\t5\tA\tC\tG\n2\t1\tA\tAC\tGT\n")


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _both(tmp_path, fn, *args):
    """``fn`` of both packages with output directories j and p: the files
    written (``Snps.npz`` apart) and the npz paths."""
    out = {}
    for side, mod in (("j", J), ("p", P)):
        d = tmp_path / side
        d.mkdir()
        kw = {} if side == "j" else {"device": CPU}
        out[side] = fn(mod, str(d), kw, *args)
    trees = {s: _tree(tmp_path / s) for s in ("j", "p")}
    npz = {s: trees[s].pop("Snps.npz", None) for s in trees}
    assert sorted(trees["p"]) == sorted(trees["j"])
    for name in trees["j"]:
        assert trees["p"][name] == trees["j"][name], name
    return out, npz


def _diploid(mod, out, kw, data, enzyme):
    npz = mod.snps_integration(data["snps"], out)
    return mod.rebuild_genome(data["fasta"], npz, enzyme, out, **kw)


@pytest.mark.parametrize("enzyme", ["MboI", "HindIII", "NlaIII", "A-AGCTT"])
def test_rebuild_genome_as_in_the_jax_package(tmp_path, enzyme):
    data = diploid_dataset(np.random.default_rng(5), str(tmp_path / "data"),
                           n_pairs=20, n_snps=80)
    with open(data["snps"], "a") as f:
        f.write(EXTRA_SNPS)
    out, _ = _both(tmp_path, _diploid, data, enzyme)
    assert set(out["p"]) == set(out["j"]) == {
        "genomeSize", "Maternal", "Maternal_fragments", "Paternal",
        "Paternal_fragments"}
    want = load_snps(str(tmp_path / "j" / "Snps.npz"))
    got = load_snps(str(tmp_path / "p" / "Snps.npz"))
    assert list(got) == list(want)
    for c in want:
        for k in want[c]:
            assert got[c][k].dtype == want[c][k].dtype
            assert np.array_equal(got[c][k], want[c][k])


def test_each_pass_writes_its_own_alleles(tmp_path):
    """The maternal pass writes the maternal alleles, the paternal pass
    (on the genome the maternal pass changed) the paternal ones, a
    multi-character allele its first byte."""
    (tmp_path / "g.fa").write_bytes(b">chr1\nAAAAAAAAAA\n")
    (tmp_path / "s.txt").write_bytes(b"1 3 A C A\n1 5 A G ACGT\n")
    data = {"fasta": str(tmp_path / "g.fa"), "snps": str(tmp_path / "s.txt")}
    out, _ = _both(tmp_path, _diploid, data, "MboI")
    m = open(out["p"]["Maternal"], "rb").read().split(b"\n")[1]
    p = open(out["p"]["Paternal"], "rb").read().split(b"\n")[1]
    assert (m, p) == (b"AACAGAAAAA", b"AAAAAAAAAA")


GENOMES = {
    "cut_at_end": b">1\nACGTACATGA\n>2\nCATG\n>3\nACATGCATGCATGT\n",
    "soft_masked": b">chr10\nacgtgatcGATCnnGaTcAAGCTTaagctt\n>chr2\n"
                   b"GATCGATCGATC\n>X\n\n>chr1\nNNNN\n",
    "crlf_gz": b">chr1\r\nGATCAAGCTT\r\nCATGcatg\r\n>2\r\nGATC\r\n",
}


@pytest.mark.parametrize("enzyme", ["MboI", "NlaIII", "HindIII", "DpnI"])
@pytest.mark.parametrize("case", sorted(GENOMES))
def test_build_raw_genome_as_in_the_jax_package(tmp_path, case, enzyme):
    import gzip

    name = "genome.fa.gz" if case.endswith("gz") else "genome.fa"
    path = tmp_path / name
    if case.endswith("gz"):
        with gzip.open(path, "wb") as f:
            f.write(GENOMES[case])
    else:
        path.write_bytes(GENOMES[case])
    out, _ = _both(tmp_path, lambda mod, out, kw: mod.build_raw_genome(
        str(path), enzyme, out, **kw))
    assert set(out["p"]) == set(out["j"]) == {"genomeSize", "fragments"}


def test_a_cut_at_the_end_gives_a_fragment_L_L(tmp_path):
    (tmp_path / "g.fa").write_bytes(b">1\nACGTACATGA\n")
    P.build_raw_genome(str(tmp_path / "g.fa"), "NlaIII", str(tmp_path),
                       device=CPU)
    rows = (tmp_path / "NlaIII_g_fragments.txt").read_text().splitlines()
    assert rows == ["1\t1\t10", "1\t10\t10"]


@pytest.mark.parametrize("pos", [11, -11])
def test_a_position_past_the_end_raises_as_in_the_jax_package(tmp_path,
                                                              pos):
    (tmp_path / "g.fa").write_bytes(b">1\nACGTACGTAC\n")
    (tmp_path / "s.txt").write_text(f"1 {pos} A C G\n")
    for mod, kw in ((J, {}), (P, {"device": CPU})):
        d = tmp_path / mod.__name__.split(".")[0]
        d.mkdir()
        with pytest.raises(IndexError):
            mod.rebuild_genome(str(tmp_path / "g.fa"),
                               str(tmp_path / "s.txt"), "MboI", str(d), **kw)


def test_substitute_keeps_the_last_of_repeated_positions():
    seq = np.frombuffer(b"AAAAAAAAAA", np.uint8).copy()
    snps = {"1": {"pos": np.array([0, 10, 3, 3, 3], np.int64),
                  "m_alt": np.array(["C", "G", "T", "GA", "C"])}}
    want = {"1": seq.copy()}
    J._substitute(want, snps, "m_alt")
    got = {"1": torch.from_numpy(seq.copy())}
    P._substitute(got, snps, "m_alt")
    assert got["1"].numpy().tobytes() == want["1"].tobytes() == b"AACAAAAAAG"


def test_an_unknown_enzyme_raises_as_in_the_jax_package(tmp_path):
    (tmp_path / "g.fa").write_bytes(b">1\nACGT\n")
    for mod, kw in ((J, {}), (P, {"device": CPU})):
        with pytest.raises(ValueError, match="Unknown enzyme"):
            mod.build_raw_genome(str(tmp_path / "g.fa"), "NoSuchEnzyme",
                                 str(tmp_path), **kw)
