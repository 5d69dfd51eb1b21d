"""The port's alignment readers and writer (hichap_master_tpu_torch.io.sam,
io.bam, io.fasta) against the JAX package's (hichap_master_tpu.io.sam,
io.bam, io.fasta) and against their own plain twin.

Every column is text or an integer, so the tolerance is none: the port's
columns equal the JAX package's ``AlnRecord`` fields record for record
(name, flag, reference, 0-based pos, query length, sequence, AS, XS)."""

import gzip
import pickle
import struct

import numpy as np
import pytest
import torch

import hichap_master_tpu.io.bam as JB
import hichap_master_tpu.io.fasta as JF
import hichap_master_tpu.io.sam as JS
from hichap_master_tpu_torch.io import bam as PB
from hichap_master_tpu_torch.io import fasta as PF
from hichap_master_tpu_torch.io import sam as PS
from hichap_master_tpu_torch.io.bedio import _Labels

CPU = torch.device("cpu")

# SAM text with the quirks of parse_sam_line read through text mode
QUIRKS = (
    "@HD\tVN:1.0\n@SQ\tSN:chr1\tLN:100\n"
    "r1_1\t0\tchr1\t10\t42\t5M\t*\t0\t0\tACGTA\tIIIII\tAS:i:-3\tXS:i:-5\n"
    "r1_2\t16\t2\t20\t42\t5M\t*\t0\t0\tAC\tII\tXS:i:7\tAS:i:-1\tAS:i:-8\r\n"
    "r2_11\t4\t*\t0\t0\t*\t*\t0\t0\t*\t*\r"
    "short\t0\tchr1\t5\n"
    "\n"
    "r2_21\t0\tchr1\t+7\t42\t5M\t*\t0\t0\tNNNN\t*\tAS:Z:x\tAS:f:1\tAS:i:4\t\n"
    "noscore\t0\tchrX\t1\t0\t*\t*\t0\t0\tA\t*\tYT:Z:UU\txs:i:3\n"
    "@late header\n"
    "_x\t0\tchr1\t3\t9\t*\t*\t0\t0\tAAA\t*\n"
    "a_b_\t0\tchr1\t3\t9\t*\t*\t0\t0\tAAA\t*\tXS:i:-0\n"
    "é_2\t0\tchr1\t3\t9\t*\t*\t0\t0\tAC\t*\n"
    "tail_12\t256\tchr1\t99\t9\t*\t*\t0\t0\tAAA\t*")


def _columns(aln):
    """The port's columns as (name, flag, ref, pos, qlen, seq, AS, XS)
    tuples."""
    out = []
    for r in range(len(aln)):
        ref = aln.refs[aln.ref[r]].decode() if aln.ref[r] >= 0 else None
        out.append((aln.name(r).decode(), int(aln.flag[r]), ref,
                    int(aln.pos[r]), int(aln.qlen[r]), aln.seq(r).decode(),
                    int(aln.tag_as[r]) if aln.has[r] & PS.HAS_AS else None,
                    int(aln.tag_xs[r]) if aln.has[r] & PS.HAS_XS else None))
    return out


def _records(records):
    return [(r.query_name, r.flag, r.reference_name, r.pos, r.query_length,
             r.seq, r.tag_as, r.tag_xs) for r in records]


def test_sam_scanner_matches_its_plain_twin():
    buf = QUIRKS.encode()
    labels = _Labels(nbytes=4, n=1)          # grows while it scans
    block, lines = PS._parse_sam(buf, labels)
    assert block is not None and lines == len(buf.splitlines())
    plain_labels = []
    plain = PS._parse_sam_plain(buf, plain_labels)
    assert labels.strings() == plain_labels
    for k in block:
        np.testing.assert_array_equal(block[k], plain[k], err_msg=k)
    assert len(block["flag"]) == 9


@pytest.mark.parametrize("suffix", [".sam", ".sam.gz"])
def test_read_sam_matches_jax(tmp_path, suffix):
    path = tmp_path / f"a{suffix}"
    data = QUIRKS.encode()
    path.write_bytes(gzip.compress(data) if suffix == ".sam.gz" else data)
    got = _columns(PS.read_sam(str(path)))
    want = _records(JS.read_sam(str(path)))
    assert got == want
    # the quirks: "*" SEQ has length 1, the last AS wins, only :i: counts
    assert got[2][4] == 1 and got[1][6] == -8 and got[3][6] == 4
    assert got[4][6] is None and got[4][7] is None


def test_read_sam_in_blocks(tmp_path, monkeypatch):
    path = tmp_path / "a.sam"
    path.write_bytes(QUIRKS.encode() * 50)
    monkeypatch.setattr(PS, "READ_BYTES", 97)
    got = _columns(PS.read_sam(str(path)))
    assert got == _records(JS.read_sam(str(path)))


@pytest.mark.parametrize("bad", [
    "q_1\tx\tchr1\t1\t0\t*\t*\t0\t0\tA\t*\n",
    "q_1\t0\tchr1\t\t0\t*\t*\t0\t0\tA\t*\n",
    "q_1\t0\tchr1\t1\t0.5\t*\t*\t0\t0\tA\t*\n",
    "q_1\t0\tchr1\t1\t0\t*\t*\t0\t0\tA\t*\tAS:i:\n",
    "q_1\t0\tchr1\t1\t0\t*\t*\t0\t0\tA\t*\tXS:i:1e3\n"])
def test_integers_that_do_not_parse_raise_as_in_jax(tmp_path, bad):
    path = tmp_path / "bad.sam"
    path.write_text("ok_1\t0\tchr1\t1\t0\t*\t*\t0\t0\tA\t*\n" + bad)
    with pytest.raises(ValueError, match="bad.sam:2:"):
        PS.read_sam(str(path))
    with pytest.raises(ValueError):
        list(JS.read_sam(str(path)))
    with pytest.raises(ValueError):
        PS._parse_sam_plain(path.read_bytes(), [])


def test_inflate_reads_members_across_steps(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    data = [rng.integers(0, 255, n, dtype=np.uint8).tobytes()
            for n in (0, 1, 500, 70_000, 3)]
    path = tmp_path / "m.gz"
    path.write_bytes(b"".join(gzip.compress(x) for x in data))
    monkeypatch.setattr(PS, "INFLATE_STEP", 37)
    pieces = list(PS.inflate(str(path), out_bytes=1000))
    assert b"".join(pieces) == b"".join(data) and len(pieces) > 2


def test_bgzf_members_across_reads(tmp_path, monkeypatch):
    """BGZF members inflate in parallel, whatever the read step cuts; a
    member that fails its CRC and a cut member raise."""
    raw = np.random.default_rng(2).integers(0, 4, 5000, dtype=np.uint8)
    raw = raw.tobytes()
    members = [JB._bgzf_block(raw[i:i + 300]) for i in range(0, 5000, 300)]
    path = tmp_path / "a.bgz"
    path.write_bytes(b"".join(members) + JB.BGZF_EOF)
    monkeypatch.setattr(PS, "BGZF_READ", 57)
    assert b"".join(PS.inflate(str(path))) == raw
    bad = bytearray(members[3])
    bad[-8] ^= 1
    path.write_bytes(b"".join(members[:3]) + bytes(bad))
    with pytest.raises(ValueError, match="CRC"):
        b"".join(PS.inflate(str(path)))
    path.write_bytes(b"".join(members[:3]) + members[3][:-5])
    with pytest.raises(EOFError):
        b"".join(PS.inflate(str(path)))


# ------------------------------------------------------------------ BAM
def _record(name, ref_id, pos, flag, seq, tags=b"", n_cigar=0):
    """One BAM record (block_size first) with raw tag bytes."""
    l_seq = len(seq)
    codes = [JB._SEQ_CODES.index(b) for b in seq]
    nyb = bytearray((l_seq + 1) // 2)
    for k, c in enumerate(codes):
        nyb[k // 2] |= c << 4 if k % 2 == 0 else c
    body = (struct.pack("<iiBBHHHiiii", ref_id, pos, len(name) + 1, 30, 0,
                        n_cigar, flag, l_seq, -1, -1, 0)
            + name.encode() + b"\0" + b"\0" * (4 * n_cigar) + bytes(nyb)
            + b"\x1e" * l_seq + tags)
    return struct.pack("<i", len(body)) + body


def _tag(name, typ, fmt, *v):
    return name + typ + struct.pack(fmt, *v)


def _bam_bytes(records, refs=(("chr1", 1000), ("2", 500)), block=100):
    head = b"BAM\x01" + struct.pack("<i", 5) + b"@HD\t\n" + struct.pack(
        "<i", len(refs))
    for n, l in refs:
        head += struct.pack("<i", len(n) + 1) + n.encode() + b"\0" + \
            struct.pack("<i", l)
    raw = head + b"".join(records)
    return b"".join(JB._bgzf_block(raw[i:i + block])
                    for i in range(0, len(raw), block)) + JB.BGZF_EOF


BAM_RECORDS = [
    _record("a_1", 0, 9, 0, "ACGTN", _tag(b"AS", b"c", "<b", -3)),
    _record("a_2", 1, 19, 16, "",
            _tag(b"AS", b"C", "<B", 200) + _tag(b"XS", b"s", "<h", -300)),
    _record("b_11", -1, -1, 4, "ACG", n_cigar=2),
    _record("b_12", 5, 3, 0, "AC",
            _tag(b"XS", b"S", "<H", 60000) + _tag(b"AS", b"i", "<i", -7)
            + _tag(b"AS", b"I", "<I", 9)),
    _record("c_21", 0, 1, 0, "GGG",
            b"ZZZhello\0" + b"HHH0A\0" + b"XAAx" + _tag(b"Xf", b"f", "<f", 1)
            + b"XBBc" + struct.pack("<I", 3) + b"abc"
            + b"XBBs" + struct.pack("<I", 2) + b"abcd"
            + b"XBBf" + struct.pack("<I", 1) + b"abcd"
            + _tag(b"AS", b"i", "<i", 11)),
    _record("c_22", 0, 1, 0, "TT",
            _tag(b"AS", b"i", "<i", 5) + b"XQQ" + _tag(b"XS", b"i", "<i", 1)),
    _record("d" * 200 + "_2", 1, 7, 0, "ACGT" * 100,
            _tag(b"AS", b"i", "<i", -1)),
]


def test_bam_reader_matches_jax(tmp_path):
    """Records spanning 100-byte BGZF blocks, l_seq 0, B arrays, every
    integer type, an unknown tag type, refIDs outside the header."""
    path = tmp_path / "a.bam"
    path.write_bytes(_bam_bytes(BAM_RECORDS))
    got = _columns(PB.read_bam(str(path)))
    want = _records(JB.read_bam(str(path)))
    assert got == want
    assert got[1][4] == 0 and got[1][6:] == (200, -300)
    assert got[3][2] is None and got[3][6:] == (9, 60000)
    assert got[4][6] == 11 and got[5][6:] == (5, None)


def test_bam_and_sam_give_the_same_columns(tmp_path):
    sam = tmp_path / "a.sam"
    recs = [r for r in JS.read_sam(_write(tmp_path / "q.sam", QUIRKS))
            if r.seq != "*"]
    JS.write_sam(str(sam), recs)
    bam = tmp_path / "a.bam"
    JB.sam_to_bam(str(sam), str(bam))
    assert _columns(PB.read_bam(str(bam))) == _columns(PS.read_sam(str(sam)))


def _write(path, text):
    path.write_bytes(text.encode())
    return str(path)


def test_write_bam_round_trips_through_both_readers(tmp_path, monkeypatch):
    src = tmp_path / "a.sam"
    recs = [r for r in JS.read_sam(_write(tmp_path / "q.sam", QUIRKS * 40))
            if r.seq != "*"]
    JS.write_sam(str(src), recs)
    aln = PS.read_sam(str(src))
    monkeypatch.setattr(PB, "WRITE_RECORDS", 7)
    monkeypatch.setattr(PB, "PAYLOAD", 333)
    bam = tmp_path / "b.bam"
    refs = {w.decode(): 10_000 for w in aln.refs}
    PB.write_bam(str(bam), aln, refs, mapq=np.full(len(aln), 17, np.int32))
    assert _columns(PB.read_bam(str(bam))) == _columns(aln)
    back = list(JB.read_bam(str(bam)))
    assert _records(back) == _records(recs)
    assert {r.mapq for r in back} == {17}
    with gzip.open(bam, "rb") as f:
        assert f.read(4) == b"BAM\x01"
    assert bam.read_bytes().endswith(PB.BGZF_EOF)


def test_write_bam_refuses_a_reference_missing_from_the_header(tmp_path):
    aln = PS.read_sam(_write(tmp_path / "q.sam", QUIRKS))
    with pytest.raises(KeyError, match="chrX"):
        PB.write_bam(str(tmp_path / "b.bam"), aln, {"chr1": 100, "2": 50})


def test_truncated_bam_raises(tmp_path):
    raw = _bam_bytes(BAM_RECORDS, block=1 << 20)
    data = gzip.decompress(raw)
    path = tmp_path / "t.bam"
    path.write_bytes(gzip.compress(data[:-5]))
    with pytest.raises(EOFError):
        PB.read_bam(str(path))
    with pytest.raises(EOFError):
        list(JB.read_bam(str(path)))


# ----------------------------------------------------------------- SNPs
def test_load_snps_matches_jax(tmp_path):
    snps = {"1": {"pos": np.array([5, 9, 30]),
                  "ref": np.array(["A", "C", "G"]),
                  "m_alt": np.array(["A", "T", "GA"]),
                  "p_alt": np.array(["C", "C", ""])},
            "X": {"pos": np.array([2]), "ref": np.array(["T"]),
                  "m_alt": np.array(["a"]), "p_alt": np.array(["T"])}}
    npz = tmp_path / "s.npz"
    JF.save_snps(snps, str(npz))
    pkl = tmp_path / "Snps.pickle"
    with open(pkl, "wb") as f:
        pickle.dump({c: {k: (v.astype("S") if v.dtype.kind == "U" else v)
                         for k, v in d.items()} for c, d in snps.items()},
                    f, protocol=2)
    for path in (npz, pkl):
        got, want = PF.load_snps(str(path)), JF.load_snps(str(path))
        assert list(got) == list(want)
        for c in want:
            for k in want[c]:
                np.testing.assert_array_equal(got[c][k], want[c][k])
                assert got[c][k].dtype == want[c][k].dtype
    table = PF.snp_table(PF.load_snps(str(npz)), ["X", "2", "1"],
                         "Maternal", device=CPU)
    assert table.key.tolist() == [2, (2 << 40) | 5, (2 << 40) | 9,
                                  (2 << 40) | 30]
    assert table.alt.tolist() == [ord("a"), ord("A"), ord("T"), -1]
    table = PF.snp_table(PF.load_snps(str(npz)), ["1"], "Paternal",
                         device=CPU)
    assert table.alt.tolist() == [ord("C"), ord("C"), -1]
