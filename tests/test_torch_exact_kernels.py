"""K8 (``kernels.exact_index``) and K9 (``kernels.exact_hits``) on genomes
and reads built for trouble (``testing.exact_cases``), on the CPU:

- the plain versions against a brute ``str.find`` of every read and its
  reverse complement in every chromosome, and FakeAligner's SAM against
  the JAX package's on two of those cases (a skewed genome; reads longer
  than the kernel's staging room);
- the host plans (``index_plan``, ``hits_plan``).

The kernels themselves are held to the plain versions on the card
(``chip_smoke.k89_edge_cases``).  Everything is integers, so the
tolerance is none."""

import numpy as np
import pytest
import torch

from hichap_master_tpu.pipeline import mapping as JM
from hichap_master_tpu_torch.kernels.exact_hits import (SMEM_MAX,
                                                        exact_hits_plain,
                                                        hits_plan)
from hichap_master_tpu_torch.kernels.exact_index import (K_MAX,
                                                         exact_index_plain,
                                                         index_plan)
from hichap_master_tpu_torch.pipeline import mapping as PM
from hichap_master_tpu_torch.testing.exact_cases import (LONG_READ,
                                                         SUB_TILE,
                                                         edge_cases, flat,
                                                         rc, write_case)

torch.set_num_threads(1)
CPU = torch.device("cpu")
CASES = edge_cases(1)
NAMES = [c[0] for c in CASES]


def _case(name):
    return next(c for c in CASES if c[0] == name)


def _index(chroms, k):
    g, s, e = flat(chroms)
    return exact_index_plain(torch.from_numpy(g), torch.from_numpy(s),
                             torch.from_numpy(e), k)


def _pack(reads):
    ln = np.asarray([len(r) for r in reads], np.int32)
    off = np.cumsum(ln.astype(np.int64)) - ln
    buf = np.concatenate(reads) if len(reads) else np.zeros(0, np.uint8)
    return (torch.from_numpy(buf.copy()), torch.from_numpy(off),
            torch.from_numpy(ln))


def _brute(chroms, reads):
    """(hit, count) per entry by str.find: the lowest global start and the
    occurrences capped at 2 (a read with a byte in a..z has none)."""
    text = {c: s.tobytes().decode("latin-1") for c, s in chroms.items()}
    at = dict(zip(chroms, flat(chroms)[1].tolist()))
    hit, count = [], []
    for r in reads:
        low = bool(((r >= 97) & (r <= 122)).any())
        for q in (r, rc(r)):
            q = q.tobytes().decode("latin-1")
            found = []
            for c, ref in text.items():
                s = 0
                while q and not low and len(found) < 2 and (
                        p := ref.find(q, s)) >= 0:
                    found.append(at[c] + p)
                    s = p + 1
                if q and not low and len(found) == 2:
                    # the lowest of all: every later chromosome starts
                    # past this one's hits
                    break
            hit.append(min(found) if found else -1)
            count.append(len(found))
    return hit, count


def _ascending_in_buckets(ix) -> bool:
    p = ix.pos.long() & 0xFFFFFFFF
    sizes = ix.bucket.diff()
    b = torch.repeat_interleave(torch.arange(len(sizes)), sizes)
    return bool(((b[1:] > b[:-1]) | (p[1:] > p[:-1])).all())


# ---------------------------------------------------------------- plans
@pytest.mark.parametrize("k", range(4, K_MAX + 1))
def test_index_plan_keeps_counters_in_shared_memory(k):
    """Every k of the card: at most 4,096 partitions (a block's histogram)
    and 16,384 counters a partition (64 KB), the two covering the key;
    tiles of whole sub-tiles that cover the genome, about four blocks a
    multiprocessor, and per-tile histograms of at most ~12 M entries at
    hg19."""
    for G in (k - 1, 5_000, 99_400_000, 3_100_000_000):
        plan = index_plan(G, k, 132, SUB_TILE)
        assert plan.part_bits + plan.sub_bits == 2 * k
        assert plan.parts <= 4096 and 4 << plan.sub_bits <= 65_536
        assert plan.tile % SUB_TILE == 0 and plan.tiles * plan.tile >= G
        assert (plan.tiles - 1) * plan.tile < max(G, 1)
        assert plan.parts * plan.tiles <= 12_200_000
        if G >= 99_400_000:
            assert plan.tiles >= 4 * 132 or plan.tile == 256 * SUB_TILE
    assert index_plan(65_534, 9, 1, SUB_TILE).tile > SUB_TILE
    with pytest.raises(ValueError, match="k in 1..13"):
        index_plan(10, K_MAX + 1, 132, SUB_TILE)


def test_hits_plan_sizes_the_staging_to_the_longest_read():
    """Staging for the longest read, fewer warps for long reads, and no
    more than a block holds: reads past LONG_READ are not staged (the
    kernel compares them against device memory)."""
    fixed, segment = 4_096, 32_768       # the library's values on the H100
    for longest, warps in ((0, 8), (1, 8), (150, 8), (151, 8),
                           (13_000, 8), (20_000, 4), (LONG_READ - 1, 1),
                           (LONG_READ, 1), (10 ** 6, 1)):
        w, lcap = hits_plan(longest, fixed, segment)
        assert w == warps and lcap % 16 == 0
        assert lcap >= longest or longest >= LONG_READ
        assert fixed + 2 * w * lcap < SMEM_MAX
        assert segment + 2 * lcap < SMEM_MAX
    assert hits_plan(LONG_READ, fixed, segment)[1] == LONG_READ - 1


def test_edge_genomes_are_what_they_claim():
    ix = _index(*_case("poly-A")[1:3])
    assert int(ix.bucket.diff().max()) >= 0.2 * len(ix.pos)
    _, chroms, k, _ = _case("short chromosomes")
    assert {len(s) for s in chroms.values()} >= {0, 1, k - 1, k, k + 1}
    _, chroms, k, _ = _case("tile edges, k 13")
    edges = flat(chroms)[2] % SUB_TILE
    assert {0, 1, SUB_TILE - 1, k - 1, SUB_TILE - k} <= set(edges.tolist())
    assert [c[2] for c in CASES if c[0].startswith("k ")] == list(
        range(4, 14))
    _, chroms, k, _ = _case("600 contigs")
    ends = flat(chroms)[2]
    assert len(chroms) == 600 and 4 * SUB_TILE in ends.tolist()
    assert int(ends[-1]) > 8 * SUB_TILE
    _, chroms, k, reads = _case("long reads")
    long = [r for r in reads if len(r) >= LONG_READ]
    assert len(long) == 6 and len(long[-1]) >= LONG_READ
    assert all(set(long[-1][q:q + k].tolist()) - set(b"ACGT")
               for q in range(len(long[-1]) - k + 1))


# ---------------------------------------------- plain versions vs brute
@pytest.mark.parametrize("name", NAMES)
def test_edge_cases_plain_match_str_find(name):
    """K8's plain index (ascending in each bucket, side list ascending, the
    keyed windows and side positions partition the ACGT bytes) and K9's
    plain search against ``str.find``."""
    _, chroms, k, reads = _case(name)
    ix = _index(chroms, k)
    assert _ascending_in_buckets(ix)
    assert bool((ix.side.diff() > 0).all())
    g = flat(chroms)[0]
    acgt = np.isin(g, np.frombuffer(b"ACGT", np.uint8))
    assert len(ix.pos) + len(ix.side) == int(acgt.sum())
    hit, count = exact_hits_plain(ix, *_pack(reads))
    want_hit, want_count = _brute(chroms, reads)
    assert hit.tolist() == want_hit
    assert count.tolist() == want_count


@pytest.mark.parametrize("name", ["poly-A", "long reads"])
def test_an_edge_genome_maps_as_the_jax_fake_aligner(name, tmp_path):
    """A skewed genome, and reads longer than the kernel's staging room,
    through the JAX FakeAligner and the port's (plain K8 and K9 on the
    CPU): the SAM files identical."""
    _, chroms, _, reads = _case(name)
    fa, fq = write_case(str(tmp_path), chroms, reads)
    JM.FakeAligner().map_chunk(fa, fq, str(tmp_path / "j.sam"))
    PM.FakeAligner(device=CPU).map_chunk(fa, fq, str(tmp_path / "p.sam"))
    j, p = ((tmp_path / f).read_bytes() for f in ("j.sam", "p.sam"))
    assert j == p and j.count(b"\n") >= len(reads) - 1


# ------------------------------------------------ measurement helpers
@pytest.mark.parametrize("name", ["tile edges, k 9", "600 contigs"])
def test_window_keys_are_the_plain_index_keys(name):
    """``exact_measure.window_keys`` (the keys ``torch.sort`` is timed on)
    are the keyed windows' keys in genome order: sorted stably they give
    the plain index's bucket sizes and positions."""
    from hichap_master_tpu_torch.testing.exact_measure import window_keys

    _, chroms, k, _ = _case(name)
    g, s, e = (torch.from_numpy(x) for x in flat(chroms))
    ix = exact_index_plain(g, s, e, k)
    keys = window_keys(g, s, e, k, chunk=1000)
    assert len(keys) == len(ix.pos)
    assert torch.equal(torch.bincount(keys, minlength=4 ** k),
                       ix.bucket.diff())
    order = torch.sort(keys, stable=True).indices
    pos = torch.nonzero(torch.isin(torch.arange(len(g)), ix.pos.long()))
    assert torch.equal(pos.flatten()[order], ix.pos.long())


def test_k9_bytes_counts_a_sector_a_candidate_and_whole_hits():
    """K9's bound: reads and outputs once, 16 bytes of bucket starts an
    entry, 4 bytes and the first min(L, 32) genome bytes a candidate, the
    rest of L only for each occurrence found."""
    from hichap_master_tpu_torch.testing.exact_measure import k9_bytes

    ln = np.asarray([150, 10], np.int32)
    cand = dict(count=7, first=5 * 32 + 2 * 10)
    count = [2, 0, 1, 1]
    want = 160 + 12 * 2 + 2 * 2 * 28 + 4 * 7 + 180 + 2 * (150 - 32)
    assert k9_bytes(ln, cand, count) == want
    _, chroms, k, reads = _case("short chromosomes")
    ix = _index(chroms, k)
    hit, count = exact_hits_plain(ix, *_pack(reads))
    cand = exact_hits_plain.candidates
    ln = np.asarray([len(r) for r in reads])
    assert cand["first"] <= 32 * cand["count"]
    assert k9_bytes(ln, cand, count.numpy()) < k9_bytes(
        ln, dict(cand, first=32 * cand["count"]), np.full(len(hit), 2))
