"""Port parity of the JAX package's record API of ``io/sam`` and
``io/bam``: ``AlnRecord``, ``parse_sam_line``, ``format_sam_line``,
``read_bam_header`` and ``read_sam_sorted_by_name`` (the port's name sort
on the device, host records out), against the JAX package on the same
files, on both of its paths: the in-memory sort (inputs under 32 MB) and
the native external merge (forced by setting ``_NATIVE_MERGE_MIN_BYTES``
to 0, as ``tests/test_native_io.py`` does).

Tolerance: none; records are compared field by field.  The native merge
breaks ties of equal names by the global (file, line) order and compares
bytes up to the shorter name, then lengths: the in-memory order, which the
port gives on both.  What differs, each shown here: the native path reads
a BAM member back through SAM text (an empty SEQ becomes ``*``, query
length 1), opens ``.sam.gz`` as plain text, and stops comparing a name at
a NUL byte.
"""

import gzip

import numpy as np
import pytest
import torch

import hichap_master_tpu.io.sam as JS
from hichap_master_tpu.io.bam import read_bam_header as j_header
from hichap_master_tpu.io.bam import write_bam as j_write_bam
from hichap_master_tpu_torch.io import bam as PB
from hichap_master_tpu_torch.io import sam as PS

torch.set_num_threads(1)

CPU = torch.device("cpu")
REFS = {"chr1": 10_000, "2": 5_000}
# names that share prefixes, sort by bytes past ASCII and repeat across files
NAMES = ("q1_1", "q1_2", "q10_1", "q1x_2", "q2_1", "é_2", "Z_11", "q1",
         "a" * 40 + "_2")


def _record(rng, k, name, seq=None):
    mapped = rng.random() < 0.85
    n = int(rng.integers(1, 12))
    seq = "".join(rng.choice(list("ACGTN"), n)) if seq is None else seq
    return JS.AlnRecord(
        query_name=name, flag=int(rng.choice([0, 16, 256])) if mapped else 4,
        reference_name=str(rng.choice(list(REFS))) if mapped else None,
        pos=int(rng.integers(0, 4000)) if mapped else -1,
        mapq=int(rng.integers(0, 61)), seq=seq,
        qual="".join(chr(33 + int(q)) for q in rng.integers(0, 40,
                                                            len(seq))),
        tag_as=int(rng.integers(-40, 1)) if rng.random() < 0.8 else None,
        tag_xs=int(rng.integers(-40, 1)) if rng.random() < 0.4 else None)


def _files(tmp_path, kinds, seed=0, empty_bam_seq=False):
    """One file per kind (``sam``, ``sam.gz``, ``bam``), names drawn from
    NAMES so that equal names fall in several files."""
    rng = np.random.default_rng(seed)
    paths = []
    for i, kind in enumerate(kinds):
        recs = [_record(rng, k, str(rng.choice(NAMES))) for k in range(60)]
        if kind == "bam" and empty_bam_seq:
            recs[3] = _record(rng, 3, "q1_2", seq="")
        p = str(tmp_path / f"f{i}_chunk0_1.{kind}")
        if kind == "bam":
            j_write_bam(p, recs, REFS)
        else:
            JS.write_sam(p, recs, REFS)
        paths.append(p)
    return paths


def _fields(recs):
    return [(r.query_name, r.flag, r.reference_name, r.pos, r.mapq, r.seq,
             r.qual, r.tag_as, r.tag_xs, r.is_unmapped, r.query_length)
            for r in recs]


@pytest.mark.parametrize("kinds", [("sam", "sam.gz", "bam", "sam"),
                                   ("bam", "bam")])
def test_sorted_by_name_matches_jax_in_memory(tmp_path, kinds):
    paths = _files(tmp_path, kinds, empty_bam_seq=True)
    want = JS.read_sam_sorted_by_name(paths)
    got = PS.read_sam_sorted_by_name(paths, device=CPU)
    assert len(got) == len(want) == 60 * len(kinds)
    assert _fields(got) == _fields(want)
    assert all(isinstance(r, PS.AlnRecord) for r in got)


def test_sorted_by_name_matches_jax_native_merge(tmp_path, monkeypatch):
    """The native path's order is the in-memory one: equal names across
    SAM and BAM members stay in (file, line) order."""
    paths = _files(tmp_path, ("sam", "bam", "sam", "bam"), seed=1)
    monkeypatch.setattr(JS, "_NATIVE_MERGE_MIN_BYTES", 0)
    want = JS.read_sam_sorted_by_name(paths)
    got = PS.read_sam_sorted_by_name(paths, device=CPU)
    assert _fields(got) == _fields(want)
    names = [r.query_name for r in got]
    assert len(set(names)) < len(names)  # ties were there to keep


def test_native_merge_divergences(tmp_path, monkeypatch):
    """The three differences of the JAX package's native path, each against
    the port, which keeps the in-memory semantics."""
    monkeypatch.setattr(JS, "_NATIVE_MERGE_MIN_BYTES", 0)
    # an empty BAM SEQ is read back as '*'
    paths = _files(tmp_path, ("bam",), seed=2, empty_bam_seq=True)
    want = _fields(JS.read_sam_sorted_by_name(paths))
    got = _fields(PS.read_sam_sorted_by_name(paths, device=CPU))
    diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    assert len(diff) == 1
    g, w = got[diff[0]], want[diff[0]]
    assert (g[5], g[10], w[5], w[10]) == ("", 0, "*", 1)
    assert g[:5] == w[:5] and g[7:10] == w[7:10]
    # a .sam.gz member is opened as text: its records are lost
    gz = _files(tmp_path, ("sam.gz",), seed=3)
    mem = _fields(PS.read_sam_sorted_by_name(gz, device=CPU))
    monkeypatch.setattr(JS, "_NATIVE_MERGE_MIN_BYTES", 1 << 40)
    assert mem == _fields(JS.read_sam_sorted_by_name(gz))
    monkeypatch.setattr(JS, "_NATIVE_MERGE_MIN_BYTES", 0)
    try:
        native = _fields(JS.read_sam_sorted_by_name(gz))
    except UnicodeDecodeError:
        native = None
    assert native != mem
    # a NUL byte ends the native comparison of a name
    p = tmp_path / "nul_chunk0_1.sam"
    rng = np.random.default_rng(4)
    JS.write_sam(str(p), [_record(rng, 0, "x\0b"), _record(rng, 1, "x\0a")])
    native = [r.query_name for r in JS.read_sam_sorted_by_name([str(p)])]
    monkeypatch.setattr(JS, "_NATIVE_MERGE_MIN_BYTES", 1 << 40)
    mem = [r.query_name for r in JS.read_sam_sorted_by_name([str(p)])]
    got = [r.query_name
           for r in PS.read_sam_sorted_by_name([str(p)], device=CPU)]
    assert native == ["x\0b", "x\0a"]
    assert got == mem == ["x\0a", "x\0b"]


def test_record_api_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    for k in range(50):
        r = _record(rng, k, str(rng.choice(NAMES)), seq="" if k % 7 == 0
                    else None)
        line = JS.format_sam_line(r)
        p = PS.AlnRecord(**vars(r))
        assert PS.format_sam_line(p) == line
        assert vars(PS.parse_sam_line(line)) == vars(JS.parse_sam_line(line))
        for tag in ("AS", "XS"):
            assert p.has_tag(tag) == r.has_tag(tag)
            if r.has_tag(tag):
                assert p.get_tag(tag) == r.get_tag(tag)
            else:
                with pytest.raises(KeyError):
                    p.get_tag(tag)
    for line in ("@SQ\tSN:chr1\tLN:5\n", "", "a\t0\tchr1\t5\n",
                 "a\t0\t*\t0\t0\t*\t*\t0\t0\t*\t*\r\n"):
        j = JS.parse_sam_line(line)
        p = PS.parse_sam_line(line)
        assert (p is None and j is None) or vars(p) == vars(j)
    path = _files(tmp_path, ("bam",))[0]
    with gzip.open(path, "rb") as f:
        want = j_header(f)
        rest_j = f.read()
    with gzip.open(path, "rb") as f:
        got = PB.read_bam_header(f)
        rest_p = f.read()
    assert got == want == list(REFS)
    assert rest_p == rest_j
    with gzip.open(_files(tmp_path, ("sam.gz",))[0], "rb") as f:
        with pytest.raises(ValueError, match="bad magic"):
            PB.read_bam_header(f)
