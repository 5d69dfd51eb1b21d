"""The port's FASTQ chunking (hichap_master_tpu_torch.pipeline.chunking.
split_reads) against the JAX package's on the same files: the chunk files'
names, the per-chunk read counts and the decompressed bytes of every chunk
are equal (the compressed bytes are not: gzip headers differ).

The inputs are crafted for the rules of the JAX package's text-mode loop:
``\\r\\n`` and lone ``\\r`` line ends, headers whose words are separated by
runs of blanks and tabs, a record cut short at the end of the file, a
header without a final newline, an empty input, a trailing blank line and a
header without ``@`` (both raise), a header outside ASCII, and chunk sizes
that divide the reads exactly (the empty chunk the JAX package opens at the
end is removed).  The port deflates in process, as gzip members on
threads, also where a ``pigz`` is on the PATH."""

import gzip
import os
import shutil
import stat

import numpy as np
import pytest

from hichap_master_tpu.pipeline import chunking as J
from hichap_master_tpu_torch.pipeline import chunking as P

RECS = b"".join(b"@r%d x\ty  z\nACGT\n+\nIIII\n" % i for i in range(10))
INPUTS = {
    "plain": RECS,
    "cut_short": RECS[:-3],
    "crlf": RECS.replace(b"\n", b"\r\n"),
    "lone_cr": RECS.replace(b"\n", b"\r"),
    "empty": b"",
    "utf8_header": "@ré a\nACé\n+\nII\n@s\nA\n+\nI".encode(),
    "header_only": b"@only",
    "blank_lines": b"@a\n\n+\n\n@b\nAC\n\nII\n",
}
RAISE = {"trailing_blank": RECS + b"\n", "no_at": b"r1\nAC\n+\nII\n"}


def _write(path, data, gz):
    if gz:
        with gzip.open(path, "wb") as f:
            f.write(data)
    else:
        path.write_bytes(data)
    return str(path)


def _run(mod, src, out, by, mate):
    shutil.rmtree(out, ignore_errors=True)
    counts = mod.split_reads(src, str(out), by, mate)
    return counts, {f: gzip.open(out / f).read()
                    for f in sorted(os.listdir(out))}


@pytest.mark.parametrize("gz", [False, True], ids=["fastq", "fastq.gz"])
@pytest.mark.parametrize("case", sorted(INPUTS))
def test_split_reads_as_in_the_jax_package(tmp_path, case, gz):
    src = _write(tmp_path / ("cell_R1_1.fastq" + (".gz" if gz else "")),
                 INPUTS[case], gz)
    for by in (1, 3, 5, 10, 100, 0):
        want = _run(J, src, tmp_path / "j", by, 1)
        got = _run(P, src, tmp_path / "p", by, 1)
        assert got == want, by


@pytest.mark.parametrize("case", sorted(RAISE))
def test_a_bad_header_raises_as_in_the_jax_package(tmp_path, case):
    src = _write(tmp_path / "x_2.fq", RAISE[case], False)
    for mod, d in ((J, "j"), (P, "p")):
        with pytest.raises(IOError, match="is not a fastq file"):
            mod.split_reads(src, str(tmp_path / d), 4, 2)


@pytest.mark.parametrize("name", ["cell_R1_1.fastq", "a_b_c_2.fq.gz",
                                  "noprefix.fastq", "x.y_z_1.fq"])
def test_chunk_names_follow_the_prefix_rule(tmp_path, name):
    src = _write(tmp_path / name, RECS, name.endswith(".gz"))
    assert _run(P, src, tmp_path / "p", 4, 2) == _run(J, src, tmp_path / "j",
                                                      4, 2)


def test_a_stale_empty_chunk_is_removed(tmp_path):
    """With 10 reads in chunks of 5, both packages remove a chunk 2 file
    left in the folder (the JAX package opens it at the end, finds no read
    and removes it)."""
    src = _write(tmp_path / "c_1.fastq", RECS, False)
    for mod, d in ((J, "j"), (P, "p")):
        (tmp_path / d).mkdir()
        (tmp_path / d / "c_chunk2_1.fastq.gz").write_bytes(b"stale")
        assert mod.split_reads(src, str(tmp_path / d), 5, 1) == [5, 5]
        assert sorted(os.listdir(tmp_path / d)) == [
            "c_chunk0_1.fastq.gz", "c_chunk1_1.fastq.gz"]


def test_gzip_members_on_threads_decompress_to_the_text(tmp_path,
                                                        monkeypatch):
    rng = np.random.default_rng(0)
    recs = b"".join(b"@read%d %d\n%s\n+\n%s\n" % (
        i, i, rng.choice(np.frombuffer(b"ACGT", np.uint8), 150).tobytes(),
        rng.integers(35, 75, 150).astype(np.uint8).tobytes())
        for i in range(3000))
    src = _write(tmp_path / "big_2.fastq.gz", recs, True)
    monkeypatch.setattr(P, "MEMBER_BYTES", 4096)
    got = _run(P, src, tmp_path / "p", 1000, 2)
    assert got == _run(J, src, tmp_path / "j", 1000, 2)
    assert got[0] == [1000, 1000, 1000]
    raw = (tmp_path / "p" / "big_chunk0_2.fastq.gz").read_bytes()
    assert raw.count(b"\x1f\x8b\x08") > 10          # many members


def test_a_pigz_on_the_path_is_not_used(tmp_path, monkeypatch):
    src = _write(tmp_path / "cell_1.fastq", INPUTS["crlf"], False)
    want = _run(J, src, tmp_path / "j", 3, 1)
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    pigz = bin_dir / "pigz"
    pigz.write_text('#!/bin/sh\nexit 1\n')        # would write nothing
    pigz.chmod(pigz.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    got = _run(P, src, tmp_path / "p", 3, 1)
    assert got[0] == [3, 3, 3, 1]
    assert got == want
