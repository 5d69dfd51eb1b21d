"""The port's filtering stage in blocks (``block_lines``): held against the
JAX package's ``hic_filtering(block_lines=...)`` and ``allelic_filtering``
on the same files, and against the port's own one-block run, with the
port on the CPU.

* ``hic_filtering``: for every block, the seven statistics and the sorted
  valid lines equal the JAX package's (duplicates here are copies of
  whole lines, so the two packages' tie-breaks give the same lines), and
  the valid bed is byte for byte the port's one-block file; no run file
  is left, after success or after an error;
* ``allelic_filtering``: with unique read names the five files and the
  report are byte for byte the one-block run's for every block; with a
  repeated name they are equal as multisets (and to the JAX package's);
* the card (here the CPU device) never holds more than a block of
  records: a hook on the uploads of both stages records the rows each
  moves."""

import os
import shutil

import numpy as np
import pytest
import torch

import hichap_master_tpu.pipeline.filtering as JF
from hichap_master_tpu_torch.io import bedio
from hichap_master_tpu_torch.pipeline import filtering as PF
from hichap_master_tpu_torch.testing.synthetic import record_beds

torch.set_num_threads(1)

CPU = torch.device("cpu")
CLASSES = ("Bi_Allelic", "M_M", "P_P", "M_P", "P_M")
LABELS = ["1", "2", "10"]
LENGTHS = [3_000_000, 2_500_000, 2_000_000]


def _lines(path):
    with open(path, "rb") as f:
        return f.read().splitlines(keepends=True)


def _key(line):
    f = line.split(b"\t")
    return (f[1], int(f[2]), int(f[3]), f[8], int(f[9]), int(f[10]))


def _copies_as_whole_lines(raw):
    """Each repeated key's later lines made copies of its first line, so
    that any survivor carries the same bytes."""
    for hap in ("Maternal", "Paternal"):
        first = {}
        for path in PF.chunk_beds(str(raw), hap):
            out = []
            for ln in _lines(path):
                out.append(first.setdefault(_key(ln), ln))
            with open(path, "wb") as fh:
                fh.write(b"".join(out))


def _draw(tmp_path, n, chunks=3, seed=21):
    raw = tmp_path / "raw"
    record_beds(str(raw), "cell", LENGTHS, LABELS, n, chunks, seed,
                device="cpu")
    _copies_as_whole_lines(raw)
    return raw


def _runs_left(out_dir):
    return [f for f in os.listdir(out_dir) if f.startswith(".hic_filtering")]


# ------------------------------------------------------------ hic_filtering
@pytest.mark.parametrize("block", [1, 7, 100, 10**6])
def test_hic_filtering_in_blocks_matches_jax_and_one_block(tmp_path, block):
    n = 160 if block == 1 else 1200
    raw = _draw(tmp_path, n)
    one = PF.hic_filtering(str(raw), str(tmp_path / "one"), "Maternal",
                           clean=False, device=CPU)
    walls = {}
    got = PF.hic_filtering(str(raw), str(tmp_path / "p"), "Maternal",
                           clean=False, block_lines=block, device=CPU,
                           walls=walls)
    jraw = tmp_path / "jraw"
    shutil.copytree(raw, jraw)
    want = JF.hic_filtering(str(jraw), str(tmp_path / "j"), "Maternal",
                            clean=False, block_lines=block)
    assert got == want == one
    assert got["Duplicates"] > 0 and got["Valid"] > 0
    name = "cell_Maternal_Valid.bed"
    p_lines = _lines(tmp_path / "p" / name)
    assert sorted(p_lines) == sorted(_lines(tmp_path / "j" / name))
    assert p_lines == _lines(tmp_path / "one" / name)
    assert os.listdir(tmp_path / "p") == [name]
    runs = block < n
    assert ("spill" in walls) == runs and ("merge" in walls) == runs
    assert {"scan", "sort", "classify", "write"} <= set(walls)


def _bed(name, c1, s1, p1, f1, c2, s2, p2, f2, cand=None, end="\n"):
    cols = [name, c1, s1, p1, 100, -5, f1, 0, c2, s2, p2, 100, -7, f2, 0]
    if cand:
        cols += [c1, 0, p1 + 3, 30, -3, f1, 1, cand]
    return "\t".join(map(str, cols)) + end


@pytest.mark.parametrize("block", [1, 3, 7, 50, 10**6])
def test_hic_filtering_block_edges(tmp_path, block):
    """A key repeated over more than three blocks across files (its first
    line in (file, line) order survives); a chromosome label first seen in
    a late block; CRLF lines and a last line without a newline; an empty
    chunk file; 15- and 23-field records mixed."""
    raw = tmp_path / "raw"
    raw.mkdir()
    rng = np.random.default_rng(5)
    chroms = ["chr1", "chr10", "chr2"]
    files = []
    for k in range(4):
        lines = []
        for i in range(40):
            c1, c2 = rng.choice(chroms, 2)
            p1, p2 = (int(x) for x in rng.integers(1, 3000, 2))
            s1, s2 = (int(x) for x in rng.choice([0, 16], 2))
            lines.append(_bed(f"k{k}r{i}", c1, s1, p1, p1 // 400 * 400, c2,
                              s2, p2, p2 // 400 * 400,
                              cand="R1" if i % 5 == 0 else None,
                              end="\r\n" if i % 3 == 0 else "\n"))
            if i % 6 == 2:      # the same key in every file, four times
                lines.append(_bed(f"dup{k}_{i}", "chr10", 0, 77, 0, "chr2",
                                  16, 99, 3000))
        if k == 3:              # a label first seen here, last in bytes
            lines.append(_bed("late", "chrZ", 0, 5, 0, "chr1", 16, 900, 800))
            lines.append(_bed("late2", "chr0", 0, 5, 0, "chr1", 16, 900,
                              800))
        text = "".join(lines)
        if k == 1:
            text = text[:-1]                         # no final newline
        path = raw / f"x_chunk{k}.bed"
        path.write_bytes(text.encode())
        files.append(str(path))
    (raw / "x_chunk9.bed").write_bytes(b"")          # empty
    files.append(str(raw / "x_chunk9.bed"))
    one = PF.hic_filtering(str(raw), str(tmp_path / "one"), clean=False,
                           device=CPU)
    got = PF.hic_filtering(str(raw), str(tmp_path / "p"), clean=False,
                           block_lines=block, device=CPU)
    want = JF.hic_filtering(str(raw), str(tmp_path / "j"), clean=False,
                            block_lines=block)
    assert got == one == want
    assert got["Duplicates"] >= 4 * 7 - 1
    out = _lines(tmp_path / "p" / "x_Valid.bed")
    assert out == _lines(tmp_path / "one" / "x_Valid.bed")
    kept = [ln for ln in out if b"\tchr10\t0\t77\t" in ln]
    assert len(kept) == 1 and kept[0].startswith(b"dup0_2\t")
    assert sum(ln.startswith(b"late") for ln in out) == 2
    assert out[0].startswith(b"late2\t")             # chr0 sorts first
    assert not any(b"\r" in ln for ln in out)
    assert any(ln.count(b"\t") == 22 for ln in out)
    assert _runs_left(tmp_path / "p") == []


def test_hic_filtering_bad_line_in_the_third_file(tmp_path):
    raw = tmp_path / "raw"
    raw.mkdir()
    good = "r\t1\t0\t5\t100\t-5\t0\t0\t2\t16\t9\t100\t-7\t0\t0\n"
    for k in range(3):
        (raw / f"c_chunk{k}.bed").write_text(good * 20)
    (raw / "c_chunk2.bed").write_text(good * 5 + good.replace("\t9\t",
                                                              "\tx\t"))
    out = tmp_path / "p"
    with pytest.raises(ValueError, match="c_chunk2.bed:6"):
        PF.hic_filtering(str(raw), str(out), block_lines=7, device=CPU)
    assert os.listdir(out) == []
    assert len(os.listdir(raw)) == 3                 # nothing cleaned


def test_the_block_comes_from_the_environment(tmp_path, monkeypatch):
    raw = _draw(tmp_path, 300)
    one = PF.hic_filtering(str(raw), str(tmp_path / "one"), "Paternal",
                           clean=False, device=CPU)
    monkeypatch.setenv("HICHAP_FILTER_BLOCK", "40")
    assert PF.filter_block(CPU) == 40
    assert PF.filter_block(CPU, 9) == 9
    walls = {}
    got = PF.hic_filtering(str(raw), str(tmp_path / "p"), "Paternal",
                           clean=True, device=CPU, walls=walls)
    assert got == one and "spill" in walls
    name = "cell_Paternal_Valid.bed"
    assert _lines(tmp_path / "p" / name) == _lines(tmp_path / "one" / name)
    assert PF.chunk_beds(str(raw), "Paternal") == []     # cleaned
    monkeypatch.delenv("HICHAP_FILTER_BLOCK")
    assert PF.filter_block(CPU) > 10**5      # sized from the free memory


@pytest.mark.parametrize("cap_gib", [80, 2, 0.5])
def test_the_card_block_keeps_to_the_process_cap(monkeypatch, cap_gib):
    """``filter_block`` on a card sizes the block from what the process
    may still take: the free memory and the allocator's unused cache,
    within a ``set_per_process_memory_fraction`` cap (here stubbed: an
    80 GiB card, 256 MiB allocated, 3 GiB reserved, 70 GiB free)."""
    gib = 1 << 30
    total, used = 80 * gib, gib // 4
    monkeypatch.delenv("HICHAP_FILTER_BLOCK", raising=False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda i: (70 * gib, total))
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda i: used)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda i: 3 * gib)
    monkeypatch.setattr(torch.cuda, "get_per_process_memory_fraction",
                        lambda i: cap_gib * gib / total)
    monkeypatch.setattr(PF, "_host_bytes", lambda: 1 << 50)
    card = torch.device("cuda", 0)
    room = min(73 * gib - used, int(cap_gib * gib) - used)
    for per in (PF.DEVICE_BYTES_PER_RECORD, PF.JOIN_BYTES_PER_RECORD):
        block = PF.filter_block(card, device_bytes=per)
        assert block == room // 2 // per
        assert block * per <= (cap_gib * gib - used) / 2


def test_the_round_sizes_hold_the_block():
    """``_round_sizes`` never gives more than the block, with more runs
    than the block too, and takes the least keys first."""
    rank = np.arange(3)
    rng = np.random.default_rng(2)

    class Run:
        def __init__(self, keys):
            self.keys, self.pos = keys, 0

    for n_runs, block in ((3, 10), (12, 5), (40, 1), (5, 2)):
        runs = []
        for _ in range(n_runs):
            k = np.zeros(int(rng.integers(1, 30)), PF._RUN_KEYS)
            for name in PF._KEY_FIELDS:
                k[name] = rng.integers(0, 3, k.size)
            k = k[np.lexsort([k[f] for f in reversed(PF._KEY_FIELDS)])]
            runs.append(Run(k))
        taken = []
        while any(r.pos < len(r.keys) for r in runs):
            live = [r for r in runs if r.pos < len(r.keys)]
            sizes = PF._round_sizes(live, rank, block)
            assert 0 < sum(sizes) <= block
            for r, s in zip(live, sizes):
                taken += [PF._key_of(x, rank) for x in r.keys[r.pos:r.pos + s]]
                r.pos += s
            # every key not taken yet is at least the largest taken so far
            top = max(taken)
            for r in runs:
                if r.pos < len(r.keys):
                    assert PF._key_of(r.keys[r.pos], rank) >= top
        assert len(taken) == sum(len(r.keys) for r in runs)


# -------------------------------------------------------- allelic_filtering
def _valid_beds(tmp_path, n=1500, seed=23):
    raw = _draw(tmp_path, n, seed=seed)
    filt = tmp_path / "filt"
    for hap in ("Maternal", "Paternal"):
        PF.hic_filtering(str(raw), str(filt), hap, clean=False, device=CPU)
    return (str(filt / "cell_Maternal_Valid.bed"),
            str(filt / "cell_Paternal_Valid.bed"))


@pytest.mark.parametrize("block", [2, 37, 400])
@pytest.mark.parametrize("save_id", [False, True])
def test_allelic_filtering_in_blocks_is_the_one_block_run(tmp_path, block,
                                                          save_id):
    m_bed, p_bed = _valid_beds(tmp_path)
    one = PF.allelic_filtering(m_bed, p_bed, str(tmp_path / "one"), save_id,
                               device=CPU)
    walls = {}
    got = PF.allelic_filtering(m_bed, p_bed, str(tmp_path / "p"), save_id,
                               device=CPU, walls=walls, block_lines=block)
    assert got == one == JF.allelic_filtering(m_bed, p_bed,
                                              str(tmp_path / "j"), save_id)
    assert "partition" in walls
    for k in CLASSES:
        name = f"cell_Valid_{k}.bed"
        assert _lines(tmp_path / "p" / name) == \
            _lines(tmp_path / "one" / name), k
        assert sorted(_lines(tmp_path / "p" / name)) == \
            sorted(_lines(tmp_path / "j" / name)), k


def test_allelic_filtering_in_blocks_with_a_repeated_name(tmp_path, caplog):
    import logging

    m_bed, p_bed = _valid_beds(tmp_path, n=900, seed=24)
    lines = _lines(m_bed)
    with open(m_bed, "ab") as f:          # three names twice, one 30 times
        f.write(b"".join(lines[5:8]) + lines[9] * 29)
    one = PF.allelic_filtering(m_bed, p_bed, str(tmp_path / "one"),
                               device=CPU)
    with caplog.at_level(logging.INFO):
        got = PF.allelic_filtering(m_bed, p_bed, str(tmp_path / "p"),
                                   device=CPU, block_lines=20)
    assert "row-wise merge-join" in caplog.text and "names " in caplog.text
    assert got == one == JF.allelic_filtering(m_bed, p_bed,
                                              str(tmp_path / "j"))
    for k in CLASSES:
        name = f"cell_Valid_{k}.bed"
        g = sorted(_lines(tmp_path / "p" / name))
        assert g == sorted(_lines(tmp_path / "one" / name)), k
        assert g == sorted(_lines(tmp_path / "j" / name)), k


def test_splitters_bound_the_ranges():
    rng = np.random.default_rng(3)
    names = [np.array([b"r%06d" % i for i in rng.permutation(5000)[:n]],
                      "S8") for n in (3000, 2600)]
    for block in (2, 17, 500, 4000):
        cut, ids = PF._splitters(names, block)
        assert all(np.array_equal(i, np.searchsorted(cut, a, side="right"))
                   for a, i in zip(names, ids))
        size = sum(np.bincount(i, minlength=cut.size + 1) for i in ids)
        assert size.max() <= block and size.sum() == 5600
        assert np.all(cut[1:] > cut[:-1])


# ------------------------------------------------------------ device bound
def test_no_upload_of_the_filtering_stages_exceeds_the_block(tmp_path,
                                                             monkeypatch):
    """Every tensor the two stages move to the device: its rows (the last
    dimension) at most the block, and its bytes (name text) at most the
    block's lines."""
    from hichap_master_tpu_torch.pipeline import columns

    m_bed, p_bed = _valid_beds(tmp_path, n=2000, seed=25)
    raw = tmp_path / "raw"
    seen = []

    def hook(a, device):
        seen.append((np.asarray(a).dtype, np.shape(a)[-1] if np.ndim(a)
                     else 1))
        return columns.upload(a, device)

    monkeypatch.setattr(PF, "upload", hook)
    block = 150
    longest = max(len(ln) for p in (m_bed, p_bed) for ln in _lines(p))
    for hap in ("Maternal", "Paternal"):
        PF.hic_filtering(str(raw), str(tmp_path / "b"), hap, clean=False,
                         block_lines=block, device=CPU)
    PF.allelic_filtering(m_bed, p_bed, str(tmp_path / "a"), device=CPU,
                         block_lines=block)
    rows = [n for dt, n in seen if dt != np.uint8]
    text = [n for dt, n in seen if dt == np.uint8]
    assert len(rows) > 100 and max(rows) <= block
    assert text and max(text) <= block * longest
    assert bedio.RECORD_READ_BYTES > block * longest
