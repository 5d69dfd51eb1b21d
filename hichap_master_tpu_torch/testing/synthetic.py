"""Synthetic hg19-scale inputs for the main path.

Counterparts of the generators in ``scripts/perf_sparse_gw.py`` (hg19
lengths, genome-wide tile coordinates and values) and
``scripts/perf_hg19.py`` (dense per-chromosome batches, loop-calling band
COO, and COO with planted TADs or A/B compartments), the filtering
stage's chunk beds with their planted truth (``record_beds``), and the
bamProcess stage's alignment files with theirs (``alignment_chunks``).
The numpy
generators take a seeded ``numpy.random.Generator``; the tensor generators
draw on the target device from a seeded
``torch.Generator``, so no hg19-scale array crosses the host link.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.bedio import TAG_WORDS, _format_rows, _table

# hg19 / GRCh37 chromosome lengths, chr1..22 + X (the reference's default
# chromosome set)
HG19 = [
    249250621, 243199373, 198022430, 191154276, 180915260, 171115067,
    159138663, 146364022, 141213431, 135534747, 135006516, 133851895,
    115169878, 107349540, 102531392, 90354753, 81195210, 78077248,
    59128983, 63025520, 48129895, 51304566, 155270560,
]
HG19_NAMES = [str(i + 1) for i in range(22)] + ["X"]


def hg19_bins(res: int = 10_000) -> int:
    """Genome-wide bin count of chr1..22+X at ``res``."""
    return int(sum((l + res - 1) // res for l in HG19))


def chrom_bins(res: int) -> dict:
    """{chrom: bin count} at ``res``."""
    return {c: (l + res - 1) // res for c, l in zip(HG19_NAMES, HG19)}


def band_coords(R: int, band_tiles: int = 3, far_per_row: int = 1,
                seed: int = 0) -> np.ndarray:
    """Block coordinates [K, 2]: the diagonal band of ``band_tiles`` tile
    diagonals plus ``far_per_row`` sampled far-field tiles per block row
    (sparse inter-chromosomal content), deduplicated, brow <= bcol."""
    coords = []
    for off in range(band_tiles):
        rr = np.arange(R - off, dtype=np.int32)
        coords.append(np.stack([rr, rr + off], 1))
    rng = np.random.default_rng(seed)
    for _ in range(far_per_row):
        rr = np.arange(R, dtype=np.int32)
        cc = rng.integers(0, R, R).astype(np.int32)
        lo = np.minimum(rr, cc)
        hi = np.maximum(rr, cc)
        far = np.stack([lo, hi], 1)
        coords.append(far[hi - lo >= band_tiles])
    allc = np.concatenate(coords)
    key = allc[:, 0].astype(np.int64) * R + allc[:, 1]
    _, idx = np.unique(key, return_index=True)
    return allc[np.sort(idx)]


def gen_tiles(coords: np.ndarray, T: int, seed: int = 0, *, device,
              far_floor: float = 0.0):
    """Tile values drawn on ``device``: floor(Exp) counts with mean
    ~60 / (1 + |distance|), diagonal tiles mirrored full.  Returns
    (tiles [K, T, T] float32, brow [K] int32, bcol [K] int32).

    far_floor : mean of an extra Poisson count on every pixel of the
    far-field tiles (those off the 3-tile band), standing for the long-range
    cis and inter-chromosomal contacts the band-only generator leaves out.
    0 reproduces ``scripts/perf_sparse_gw.py``'s data, on which ICE is a
    slow diffusion along the genome: the JAX package itself ends 200
    iterations at variance ~14, far above tol 1e-5.  With 1.0 the far tiles
    hold ~35% of the contact mass and ICE converges at tol 1e-5.
    """
    device = torch.device(device)
    brow = torch.as_tensor(coords[:, 0], dtype=torch.int32, device=device)
    bcol = torch.as_tensor(coords[:, 1], dtype=torch.int32, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    K = coords.shape[0]
    li = torch.arange(T, device=device)
    tiles = torch.empty(K, T, T, device=device)
    step = 1024  # tiles per draw (bounds the temporaries)
    for k0 in range(0, K, step):
        k1 = min(K, k0 + step)
        dist = ((bcol[k0:k1] - brow[k0:k1]).long()[:, None, None] * T
                + (li[None, :] - li[:, None])[None]).abs()
        lam = 60.0 / (1.0 + dist.float())
        u = torch.rand(k1 - k0, T, T, generator=g, device=device)
        u = u * (1.0 - 1e-6) + 1e-6
        t = torch.floor(-torch.log(u) * lam)
        if far_floor > 0:
            far = (bcol[k0:k1] - brow[k0:k1]) >= 3
            bg = torch.poisson(torch.full_like(t, far_floor), generator=g)
            t = t + bg * far[:, None, None]
        tiles[k0:k1] = t
    diag = brow == bcol
    td = tiles[diag]
    tiles[diag] = torch.triu(td) + torch.triu(td, 1).transpose(-1, -2)
    return tiles, brow, bcol


def hap_batch(sizes, n_pad: int, seed: int = 0, *, device,
              background: float = 0.0) -> torch.Tensor:
    """Padded symmetric count matrices ``[C, n_pad, n_pad]`` drawn on
    ``device``: floor(Exp) counts with mean 80 / d^0.9 at distance d, zero
    beyond each chromosome's size.

    background : mean of an extra Poisson count on every pixel.  The
    floor(Exp) draw of ``scripts/perf_hg19.py`` leaves almost no contact
    beyond ~500 bins, and ICE on such a banded matrix is a slow diffusion
    along the chromosome: var < 1e-5 takes ~3,300 iterations at chr1's
    6,232 bins (40 kb).  With 0.05 (~1/4 of the mass at long range, as in
    real Hi-C) it takes ~30.
    """
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    i = torch.arange(n_pad, device=device)
    d = (i[:, None] - i[None, :]).abs() + 1.0
    lam = 80.0 / d ** 0.9
    out = torch.empty(len(sizes), n_pad, n_pad, device=device)
    for c, n in enumerate(sizes):
        u = torch.rand(n_pad, n_pad, generator=g, device=device)
        m = torch.floor(-torch.log(u * (1.0 - 1e-6) + 1e-6) * lam)
        if background > 0:
            m = m + torch.poisson(torch.full_like(m, background), generator=g)
        m = torch.triu(m) + torch.triu(m, 1).T
        valid = i < n
        out[c] = torch.where(valid[:, None] & valid[None, :], m, 0.0)
    return out


# GM12878-like allelic class mix of scripts/perf_e2e_hap.py (bi-allelic
# pairs dominate; ~23% are phased)
GM12878_MIX = {"Bi_Allelic": 20_000_000, "M_M": 3_000_000,
               "P_P": 3_000_000, "M_P": 300_000, "P_M": 300_000}


# planted structure of the allelic phase (``allelic_pairs(loops=...)``):
# loops one each LOOP_SPACING bp, anchors LOOP_SPAN bins of LOOP_RES apart
# (HICCUPS on 40 kb allelic matrices resolves little farther out), with
# LOOP_PAIRS pairs each, and DOMAIN_SHARE of the intra pairs inside
# DOMAIN-bp domains
LOOP_RES = 40_000
LOOP_SPACING = 2_500_000
LOOP_SPAN = (5, 8)
LOOP_PAIRS = 480
DOMAIN = 1_000_000
DOMAIN_SHARE = 0.3


def planted_loops(lengths, seed: int = 0) -> np.ndarray:
    """Loop anchors for ``allelic_pairs(loops=...)``: on every chromosome
    one loop each LOOP_SPACING bp from LOOP_SPACING on (none within
    LOOP_SPACING of either end), its second anchor LOOP_SPAN bins of
    LOOP_RES after the first, its kind cycling through shared (0),
    maternal only (1) and paternal only (2).  Returns ``[K, 4]`` int64 rows
    (chromosome index, anchor bin, anchor bin, kind)."""
    rng = np.random.default_rng(seed)
    step = LOOP_SPACING // LOOP_RES
    rows = []
    for ci, length in enumerate(lengths):
        for b in range(step, length // LOOP_RES - step, step):
            d = int(rng.integers(LOOP_SPAN[0], LOOP_SPAN[1] + 1))
            rows.append((ci, b, b + d, len(rows) % 3))
    return np.asarray(rows, np.int64).reshape(-1, 4)


def _loop_pairs(uniform, loops, sizes, device):
    """LOOP_PAIRS intra pairs per planted loop: each mate in its anchor
    bin, or one bin to either side (1/4 each), at a uniform offset inside
    the bin; shared loops split their pairs evenly over Bi_Allelic, M_M and
    P_P, maternal ones go to M_M and paternal ones to P_P.  Returns
    ``{class: (c, p1, p2)}``."""
    lp = torch.as_tensor(loops, device=device).repeat_interleave(LOOP_PAIRS,
                                                                 0)
    n = lp.shape[0]

    def mate(b):
        jitter = (uniform(n) < 0.5).long() + (uniform(n) < 0.5).long() - 1
        pos = ((b + jitter).double() + uniform(n)) * LOOP_RES
        return torch.minimum(pos.long().clamp_min(0), sizes[lp[:, 0]].long()
                             - 1)

    p1, p2 = mate(lp[:, 1]), mate(lp[:, 2])
    third = (uniform(n) * 3).long().clamp_max(2)
    cls = torch.where(lp[:, 3] == 0, third, lp[:, 3])  # 0 Bi, 1 M_M, 2 P_P
    return {k: (lp[cls == i, 0], p1[cls == i], p2[cls == i])
            for i, k in enumerate(("Bi_Allelic", "M_M", "P_P"))}


def allelic_pairs(lengths, counts, seed: int = 0, *, device,
                  cis_floor: float = 0.0, loops=None) -> dict:
    """Allelic pair classes drawn on ``device`` (``scripts/perf_e2e_hap.py``
    ``_gen_pairs`` and ``generate_beds``): both mates' chromosomes weighted
    by length, 75% intra pairs at a Cauchy-tailed distance (``|Cauchy| *
    200 kb``, clipped to the chromosome's end), the rest
    uniform over the genome; M_M and P_P carry tags, 40% both-side
    (``TAG_BOTH`` = 0), 30% R1 (1) and 30% R2 (2).

    ``lengths``: chromosome lengths in registry order; ``counts``: pairs
    per class.  Returns ``{class: (c1 int32, p1 int64, c2 int32, p2 int64
    [, tag int8])}``.

    cis_floor : share of the intra pairs whose second mate is drawn uniform
    over the chromosome.  0 reproduces the script, whose only long-range
    cis mass is the inter draws that land on the same chromosome (0.25 x
    its length share: ~2.6% of chr1's pairs, ~0.4% of chr21's), with a
    Cauchy (s^-2) tail otherwise: cis-only ICE at 40 kb then needs 222
    iterations on chr1 and more on the small chromosomes (tol 1e-5; cooler's
    limit is 200).  With 0.1 it takes ~65 on every chromosome tried.

    loops : ``planted_loops`` rows, or None (the default: nothing more is
    drawn, so the draws above are those of the script).  With them,
    DOMAIN_SHARE of the intra pairs draw their second mate uniform within
    the first mate's DOMAIN-bp domain, the same domains on both
    haplotypes, so that DI has boundaries to find; and each loop adds
    LOOP_PAIRS intra pairs around its anchors (``_loop_pairs``), drawn
    after every class and tagged as the other M_M and P_P pairs."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    sizes = torch.as_tensor(lengths, dtype=torch.float64, device=device)
    cumw = torch.cumsum(sizes, 0) / sizes.sum()
    last = sizes.numel() - 1

    def uniform(n):
        return torch.rand(n, generator=g, dtype=torch.float64, device=device)

    def chrom(n):
        return torch.searchsorted(cumw, uniform(n), right=True).clamp_max(last)

    def tag(n):
        u = uniform(n)
        return (u >= 0.4).to(torch.int8) + (u >= 0.7).to(torch.int8)

    out = {}
    for cls, n in counts.items():
        c1 = chrom(n)
        intra = uniform(n) < 0.75
        c2 = torch.where(intra, c1, chrom(n))
        p1 = (uniform(n) * sizes[c1]).long()
        d = torch.tan(torch.pi * (uniform(n) - 0.5)).abs() * 200_000
        d = d.clamp_max(4e18).long()
        size1 = sizes[c1].long()
        p2 = torch.where(intra, torch.minimum(p1 + d, size1 - 1),
                         (uniform(n) * sizes[c2]).long())
        if cis_floor > 0:
            far = intra & (uniform(n) < cis_floor)
            p2 = torch.where(far, (uniform(n) * sizes[c1]).long(), p2)
        if loops is not None:
            inside = intra & (uniform(n) < DOMAIN_SHARE)
            pd = p1 // DOMAIN * DOMAIN + (uniform(n) * DOMAIN).long()
            p2 = torch.where(inside, torch.minimum(pd, size1 - 1), p2)
        cols = (c1.to(torch.int32), p1, c2.to(torch.int32), p2)
        if cls in ("M_M", "P_P"):
            cols += (tag(n),)
        out[cls] = cols
    if loops is None:
        return out
    extra = _loop_pairs(uniform, loops, sizes, device)
    for cls in counts:
        if cls not in extra:
            continue
        c, p1, p2 = extra[cls]
        c = c.to(torch.int32)
        add = (c, p1, c, p2)
        if cls in ("M_M", "P_P"):
            add += (tag(c.numel()),)
        out[cls] = tuple(torch.cat([a, b]) for a, b in zip(out[cls], add))
    return out


def band_coo(rng: np.random.Generator, n: int, band: int, loops: int = 40):
    """Upper-band COO (rows, cols, vals) of one chromosome: Poisson counts
    with mean 80 / (d + 1)^0.9 for d < band, plus ``loops`` enriched pixels."""
    d = np.arange(band)
    lam = 80.0 / (d + 1.0) ** 0.9
    counts = rng.poisson(np.broadcast_to(lam, (n, band))).astype(np.float64)
    for _ in range(loops if n > band + 10 else 0):
        x = int(rng.integers(5, n - band - 5))
        e = int(rng.integers(20, band - 20))
        counts[x, e] = counts[x, e] * 8 + 60
    rows, es = np.nonzero(counts)
    cols = rows + es
    keep = cols < n
    return rows[keep], cols[keep], counts[rows, es][keep]


def _band_poisson(rng: np.random.Generator, n: int, band, factor):
    """Upper-triangle COO of Poisson counts with mean 80 / (d + 1)^0.9 at
    distance d < band, times ``factor(rows, cols)``; row-major like a
    cooler's pixel table."""
    band = n if band is None else min(int(band), n)
    x = np.arange(n)[:, None]
    e = np.arange(band)[None, :]
    lam = 80.0 / (e + 1.0) ** 0.9 * factor(x, np.minimum(x + e, n - 1))
    lam = np.where(x + e < n, lam, 0.0)
    counts = rng.poisson(lam).astype(np.float64)
    rows, es = np.nonzero(counts)
    return rows, rows + es, counts[rows, es]


def tad_coo(rng: np.random.Generator, n: int, tad: int = 20, band=None):
    """One chromosome's upper-triangle COO (rows, cols, vals) with planted
    ``tad``-bin domains: Poisson counts with mean 80 / d^0.9 (d = |i - j|
    + 1), x4 inside a domain (``scripts/perf_hg19.py``'s TAD cooler).
    ``band`` keeps only d < band bins (None: the whole triangle)."""
    return _band_poisson(rng, n, band,
                         lambda i, j: np.where(i // tad == j // tad, 4.0, 1.0))


def ab_sign(n: int, block: int = 10) -> np.ndarray:
    """The planted compartment of each bin: +1 (A) or -1 (B), alternating
    in ``block``-bin runs starting with A."""
    return np.where((np.arange(n) // block) % 2 == 0, 1.0, -1.0)


def ab_coo(rng: np.random.Generator, n: int, block: int = 10, band=None):
    """One chromosome's upper-triangle COO (rows, cols, vals) with planted
    A/B compartments ``s = ab_sign(n, block)``: Poisson counts with mean
    80 / d^0.9 times (1 + 0.5 s_i s_j), and A-A pairs a further x1.2, so
    the A side has the higher O/E and the orientation rule has a side to
    find (with a symmetric checkerboard the A/B labels are a coin flip)."""
    s = ab_sign(n, block)
    return _band_poisson(
        rng, n, band, lambda i, j: (1.0 + 0.5 * s[i] * s[j])
        * np.where((s[i] > 0) & (s[j] > 0), 1.2, 1.0))


# ------------------------------------------------------------- bed writers
def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def write_allelic_beds(dirpath: str, prefix: str, classes, labels) -> dict:
    """The allelic bed classes of ``classes`` (``{class: (c1, p1, c2,
    p2[, tag])}``, tensors or arrays; chromosome indices into ``labels``)
    as ``<prefix>Valid_<class>.bed`` files in ``dirpath``: ``chrom1 pos1
    chrom2 pos2 [tag]`` lines.  Returns {class: path}."""
    import os

    os.makedirs(dirpath, exist_ok=True)
    tab, lens = _table([str(l).encode() for l in labels])
    tags = _table(list(TAG_WORDS))
    out = {}
    for cls, cols in classes.items():
        c1, p1, c2, p2, *tag = (_host(a) for a in cols)
        fields = [[("word", tab, lens, c1)], [("int", p1)],
                  [("word", tab, lens, c2)], [("int", p2)]]
        if tag:
            fields.append([("word", *tags, tag[0])])
        out[cls] = os.path.join(dirpath, f"{prefix}Valid_{cls}.bed")
        with open(out[cls], "wb") as f:
            _format_rows(fields, len(c1), f)
    return out


def write_valid_bed(path: str, pairs, labels) -> str:
    """A 15-column valid bed of ``(c1, p1, c2, p2)`` (tensors or arrays) in
    the layout of the JAX package's test writer: read name, chrom1, strand,
    pos1, length, score, fragment-mid1 (= pos1), fragment index, chrom2,
    strand, pos2, length, score, fragment-mid2 (= pos2), fragment index."""
    c1, p1, c2, p2 = (_host(a) for a in pairs)
    tab, lens = _table([str(l).encode() for l in labels])

    def const(b):
        return [("const", b)]

    fields = [[("const", b"read"), ("int", np.arange(len(c1)))],
              [("word", tab, lens, c1)], const(b"0"), [("int", p1)],
              const(b"100"), const(b"-10"), [("int", p1)], const(b"0"),
              [("word", tab, lens, c2)], const(b"16"), [("int", p2)],
              const(b"100"), const(b"-12"), [("int", p2)], const(b"0")]
    with open(path, "wb") as f:
        _format_rows(fields, len(c1), f)
    return path


# ------------------------------------------------------------ chunk beds
# record_beds: each side's records are RECORD_DUP_SHARE exact-key copies
# (under new names, each after its original in (file, line) order) and
# originals; of the originals, RECORD_NOISE are the four kinds of Hi-C
# noise, and of the valid rest RECORD_BOTH_SHARE are pairs mapped in both
# beds (routes by RECORD_ROUTES), the others mapped in one bed only
# (scenarios by RECORD_SPECIFIC).
RECORD_DUP_SHARE = 0.05
RECORD_NOISE = (("SelfCircle", 0.01), ("DanglingEnds", 0.02),
                ("UnknownMechanism", 0.005), ("ExtraDanglingEnds", 0.01))
RECORD_BOTH_SHARE = 0.7
# final marks (mate 1, mate 2) by code 3 * m1 + m2 (0 N, 1 M, 2 P):
# NN NM NP MN MM MP PN PM PP
RECORD_ROUTES = (0.55, 0.05, 0.05, 0.05, 0.1, 0.025, 0.05, 0.025, 0.1)
# share of both-mapped pairs whose M or P mark comes through a candidate
# retry (where the marks allow one), and share carrying an unusable one
RECORD_CAND_SHARE = 0.08
# one-bed scenarios: Both; R1; R1 + usable R2 candidate (-> Both); R2;
# R2 + usable R1 candidate (-> Both); N; N + usable R1 candidate (-> R1);
# N + usable R2 candidate (-> R2); N + a candidate that changes nothing
# (another fragment, or no SNP)
RECORD_SPECIFIC = (0.15, 0.2, 0.03, 0.2, 0.03, 0.3, 0.03, 0.03, 0.03)
RECORD_FRAG = 500          # fragment width of the fragment-mid columns
RECORD_INTRA = 0.8         # intra-chromosomal share of the valid pairs
RECORD_NAME = b"SRR1658570."
_SPEC_TAG = (0, 1, 0, 2, 0, -1, 1, 2, -1)   # final tag (-1 N) by scenario


def _ints(g, lo, hi, n, device):
    return torch.randint(lo, hi, (n,), generator=g, device=device)


def _pick(g, weights, n, device):
    return torch.multinomial(torch.tensor(weights, dtype=torch.float64,
                                          device=device), n, True,
                             generator=g)


def _frag(pos):
    return pos // RECORD_FRAG * RECORD_FRAG + RECORD_FRAG // 2


def record_beds(dirpath: str, cell: str, lengths, labels, n_records: int,
                n_chunks: int = 4, seed: int = 0, *, device) -> dict:
    """Chunk beds as the JAX package's bamProcess writes them, for both
    haplotypes, drawn on ``device`` from ``seed``:
    ``<cell>_chunk<k>_Maternal.bed`` and ``<cell>_chunk<k>_Paternal.bed``
    (k < ``n_chunks``, ``n_records`` lines per haplotype in equal parts),
    15 columns, or 23 where a candidate mate follows.  Chromosome i is
    ``labels[i]`` of length ``lengths[i]`` (hg19's names order ``10``
    before ``2`` as strings).

    Each haplotype's lines are 5% exact-key copies of an earlier line under
    a new read name, some in a later chunk file (RECORD_DUP_SHARE), and
    originals: 1% self-circles, 2% dangling ends, 0.5% unknown-mechanism
    pairs (strands 0/0, 16/16, 256/16, 0/272) and 1% extra dangling ends
    (RECORD_NOISE), and valid pairs (80% intra-chromosomal, 1 kb to 10 Mb
    log-uniform).  70% of the valid pairs are mapped in both haplotypes
    under one name, their SNP counts, scores and positions (within 5 bp,
    or 20-40 bp apart) giving the final marks NN 55%, NM, NP, MN 5% each,
    MM 10%, MP 2.5%, PN 5%, PM 2.5%, PP 10% (RECORD_ROUTES); 8% of those
    reach an M or P mark through a candidate retry (maternal R1,
    paternal R2, or both R1: the reference's three cases) where their
    marks allow, and another 8% carry a candidate that changes nothing.
    The other 30% are mapped in one haplotype only, each side alike, in
    the nine scenarios of RECORD_SPECIFIC (every branch of the reference's
    ``_specific_mapping``: Both 15%, R1 20%, R1 upgraded to Both by an R2
    candidate 3%, R2 20%, R2 upgraded 3%, N 30%, N rescued to R1 3%, to R2
    3%, N with a candidate that changes nothing 3%).  Read names are
    ``SRR1658570.<id>``, so name order is not numeric order.

    Returns the truth: ``{"Maternal": stats, "Paternal": stats, "report":
    report}``, the seven statistics of ``hic_filtering`` per haplotype and
    the sixteen entries of ``allelic_filtering``'s report, with the
    port's tie-break (the first line of a key in (file, line) order)."""
    import os

    os.makedirs(dirpath, exist_ok=True)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    K = len(lengths)
    n_dup = int(round(n_records * RECORD_DUP_SHARE))
    n = n_records - n_dup                        # originals per side
    n_noise = [int(round(n * s)) for _, s in RECORD_NOISE]
    n_valid = n - sum(n_noise)
    n_both = int(round(n_valid * RECORD_BOTH_SHARE))
    lengths_t = torch.tensor(lengths, dtype=torch.int64, device=device)

    # slots: index i of either side sits at a slot of its own, spaced S
    # apart on its chromosome, so that (chrom1, pos1) is unique per side
    per = torch.floor(lengths_t.double() / lengths_t.sum() * n).long()
    per[torch.argmax(lengths_t)] += n - int(per.sum())
    S = (lengths_t - 2000) // per.clamp(min=1)
    if int(S[per > 0].min()) < 64:
        raise ValueError("record_beds: too many records for the genome")
    slot = torch.randperm(n, generator=g, device=device)
    c1 = torch.searchsorted(torch.cumsum(per, 0), slot, right=True)
    local = slot - (torch.cumsum(per, 0) - per)[c1]
    base = 1000 + local * S[c1]
    u = (torch.rand(n, generator=g, device=device, dtype=torch.float64)
         * (S[c1] // 4).double()).long()
    p1 = base + u

    # the pairs' other end, shared by both sides
    intra = torch.rand(n, generator=g, device=device) < RECORD_INTRA
    dmax = min(10_000_000, min(lengths) // 2 - 100)
    d = torch.exp(torch.rand(n, generator=g, device=device,
                             dtype=torch.float64)
                  * np.log(dmax / 1000.0)).mul(1000.0).long()
    up = p1 + d < lengths_t[c1] - 50
    c2 = torch.where(intra, c1, (c1 + 1 + _ints(g, 0, max(K - 1, 1), n,
                                                device)) % K)
    far = (torch.rand(n, generator=g, device=device, dtype=torch.float64)
           * (lengths_t[c2] - 100).double()).long() + 50
    p2 = torch.where(intra, torch.where(up, p1 + d, p1 - d), far)
    strand = torch.tensor([0, 16, 256, 272], device=device)
    s1 = strand[_pick(g, (0.49, 0.49, 0.01, 0.01), n, device)]
    s2 = strand[_pick(g, (0.49, 0.49, 0.01, 0.01), n, device)]

    # the noise (the first indices, the same on both sides; unique names)
    kind = torch.full((n,), -1, dtype=torch.int64, device=device)
    edges = np.cumsum([0] + n_noise)
    for k in range(4):
        kind[edges[k]:edges[k + 1]] = k
    noisy = kind >= 0
    e = _ints(g, 1, 501, n, device)
    fwd = torch.rand(n, generator=g, device=device) < 0.5   # p1 < p2
    c2 = torch.where(noisy, c1, c2)
    p2 = torch.where(noisy, torch.where(fwd, p1 + e, p1 - e), p2)
    f1 = _frag(p1)
    f2 = torch.where(noisy, f1, _frag(p2))
    f2 = torch.where(kind == 3, f1 + RECORD_FRAG, f2)          # ED
    facing_1 = torch.where(fwd, 0, 16)                          # DE, ED
    um = torch.tensor([[0, 0], [16, 16], [256, 16], [0, 272]],
                      device=device)[_ints(g, 0, 4, n, device)]
    s1 = torch.where(kind == 0, 16 - facing_1, s1)              # SC
    s2 = torch.where(kind == 0, facing_1, s2)
    s1 = torch.where((kind == 1) | (kind == 3), facing_1, s1)   # DE, ED
    s2 = torch.where((kind == 1) | (kind == 3), 16 - facing_1, s2)
    s1 = torch.where(kind == 2, um[:, 0], s1)                   # UM
    s2 = torch.where(kind == 2, um[:, 1], s2)

    # valid pairs: in both beds, then in one bed only
    i = torch.arange(n, device=device)
    both = (i >= edges[4]) & (i < edges[4] + n_both)
    spec = i >= edges[4] + n_both
    route = _pick(g, RECORD_ROUTES, n, device)
    m1, m2 = route // 3, route % 3
    uc = torch.rand(n, generator=g, device=device)
    cand_a = both & (m1 == 1) & (uc < RECORD_CAND_SHARE)
    cand_b = both & ~cand_a & (m2 == 2) & (uc < RECORD_CAND_SHARE)
    cand_c = both & ~cand_a & ~cand_b & (m1 == 2) & (uc < RECORD_CAND_SHARE)
    cand_x = both & ~(cand_a | cand_b | cand_c) & (
        uc >= RECORD_CAND_SHARE) & (uc < 2 * RECORD_CAND_SHARE)
    b1 = torch.where(cand_a | cand_c, 0, m1)                    # base marks
    b2 = torch.where(cand_b, 0, m2)

    def mate(base_mark, forced_same):
        """(P's offset from M's position, M's and P's scores and SNPs) of
        one mate whose base mark is ``base_mark``."""
        same = forced_same | (torch.rand(n, generator=g, device=device)
                              < 0.5)
        delta = torch.where(same, _ints(g, -5, 6, n, device),
                            _ints(g, 20, 41, n, device))
        q, r = _ints(g, 0, 2, n, device), _ints(g, 0, 3, n, device)
        s = _ints(g, 0, 3, n, device)
        hi = torch.where(same, 2 * q + 1 + r, 2 * q + r.clamp(max=1))
        msnp = torch.where(base_mark == 1, hi, torch.where(
            base_mark == 2, q, s))
        psnp = torch.where(base_mark == 2, hi, torch.where(
            base_mark == 1, q, s))
        low = _ints(g, -50, -27, n, device)
        gap = 18 + _ints(g, 0, 10, n, device)
        msc = torch.where(~same & (base_mark == 1), low + gap, low)
        psc = torch.where(~same & (base_mark == 2), low + gap, low)
        return delta, msc, msnp, psc, psnp

    d1, msc1, msnp1, psc1, psnp1 = mate(b1, cand_a | cand_c)
    d2, msc2, msnp2, psc2, psnp2 = mate(b2, cand_b)

    # one-bed scenarios, drawn for each side
    scen = {h: _pick(g, RECORD_SPECIFIC, n, device) for h in "MP"}

    def side(h):
        """Columns of side ``h`` (originals), with the candidate columns
        (has, c15, s16, p17, sc19, f20, snp21, tag)."""
        is_p = h == "P"
        q1 = p1 + torch.where(both & is_p, d1, 0)
        q2 = p2 + torch.where(both & is_p, d2, 0)
        g1, g2 = _frag(q1), _frag(q2)
        g1 = torch.where(noisy, f1, g1)
        g2 = torch.where(noisy, f2, g2)
        sc = _ints(g, -30, 1, n, device)
        sc1 = torch.where(both, psc1 if is_p else msc1, sc)
        sc2 = torch.where(both, psc2 if is_p else msc2, sc)
        sn = scen[h]
        lo = _ints(g, 1, 4, n, device)
        hi = _ints(g, 1, 4, n, device)
        # mate 1 carries SNPs in scenarios 0-2, mate 2 in 0, 3 and 4
        snp1 = torch.where(both, psnp1 if is_p else msnp1,
                           torch.where(spec & (sn <= 2), lo, 0))
        snp2 = torch.where(both, psnp2 if is_p else msnp2, torch.where(
            spec & ((sn == 0) | (sn == 3) | (sn == 4)), hi, 0))
        # candidates: the mate the tag names, its chromosome and fragment
        # (another fragment where unusable), SNPs that decide the retry
        tag = torch.zeros(n, dtype=torch.int64, device=device)
        usable = torch.ones(n, dtype=torch.bool, device=device)
        csnp = _ints(g, 1, 4, n, device)
        if not is_p:
            tag = torch.where(cand_a | cand_c | cand_x, 1, tag)
            usable = ~cand_x
            csnp = torch.where(cand_a, 2 * msnp1 + 1, csnp)
            csnp = torch.where(cand_c, 0, csnp)
        else:
            tag = torch.where(cand_b, 2, torch.where(cand_c, 1, tag))
            csnp = torch.where(cand_b, 2 * psnp2 + 1, csnp)
            csnp = torch.where(cand_c, 3, csnp)
        tag = torch.where(spec & ((sn == 2) | (sn == 7)), 2, tag)
        tag = torch.where(spec & ((sn == 4) | (sn == 6)), 1, tag)
        last = spec & (sn == 8)
        tag = torch.where(last, 1 + _ints(g, 0, 2, n, device), tag)
        zero = last & (torch.rand(n, generator=g, device=device) < 0.5)
        usable = torch.where(last, zero, usable)
        csnp = torch.where(zero, 0, csnp)
        has = tag > 0
        on1 = tag == 1
        c15 = torch.where(on1, c1, c2)
        p17 = torch.where(on1, q1, q2)
        f20 = torch.where(on1, g1, g2) + torch.where(usable, 0,
                                                     RECORD_FRAG)
        s16 = strand[_ints(g, 0, 2, n, device)]
        sc19 = _ints(g, -30, 1, n, device)
        return [q1, sc1, g1, snp1, q2, sc2, g2, snp2, has, c15, s16, p17,
                sc19, f20, csnp, tag]

    name = {"M": torch.where(both, i, n + i),
            "P": torch.where(both, i, 2 * n + i)}
    truth = {}
    for h, hap in (("M", "Maternal"), ("P", "Paternal")):
        q1, sc1, g1, snp1, q2, sc2, g2, snp2, has, c15, s16, p17, sc19, \
            f20, csnp, tag = side(h)
        cols = [name[h], c1, s1, q1, sc1, g1, snp1, c2, s2, q2, sc2, g2,
                snp2, has, c15, s16, p17, sc19, f20, csnp, tag]
        # copies: a random original each, new names, after it in line order
        src = _ints(g, 0, n, n_dup, device)
        key = torch.rand(n, generator=g, device=device, dtype=torch.float64)
        dkey = key[src] + (1 - key[src]) * torch.rand(
            n_dup, generator=g, device=device, dtype=torch.float64)
        cols = [torch.cat([a, a[src]]) for a in cols]
        cols[0][n:] = 3 * n + (n_dup if h == "P" else 0) + torch.arange(
            n_dup, device=device)
        order = torch.sort(torch.cat([key, dkey]), stable=True).indices
        _write_record_chunks(dirpath, cell, hap, [a[order] for a in cols],
                             labels, n_chunks)
        truth[hap] = dict(Total=n_records, Duplicates=n_dup, Valid=n_valid,
                          **{k: c for (k, _), c in zip(RECORD_NOISE,
                                                       n_noise)})
    truth["report"] = _record_report(route, both, spec, scen)
    return truth


def _record_report(route, both, spec, scen) -> dict:
    """The sixteen entries of ``allelic_filtering``'s report that the
    planted marks give."""
    codes = torch.bincount(route[both], minlength=9).tolist()
    tags = torch.tensor(_SPEC_TAG, device=route.device)
    sp = {}
    for h in "MP":
        t = tags[scen[h][spec]]
        sp[h] = (int((t < 0).sum()), int((t == 0).sum()), int((t > 0).sum()))
    single_m = codes[1] + codes[3] + sp["M"][2]
    single_p = codes[2] + codes[6] + sp["P"][2]
    both_m, both_p = codes[4] + sp["M"][1], codes[8] + sp["P"][1]
    total = int(both.sum()) + 2 * int(spec.sum())
    return {
        "Total_valid_pairs": total,
        "Bi_Allelic_pairs": codes[0] + sp["M"][0] + sp["P"][0],
        "Maternal_Allelic_pairs": both_m + single_m,
        "Paternal_Allelic_pairs": both_p + single_p,
        "Maternal_both_sides_pairs": both_m,
        "Paternal_both_sides_pairs": both_p,
        "Maternal_single_side_pairs": single_m,
        "Paternal_single_side_pairs": single_p,
        "Speci_Maternal_Mapping_pairs": int(spec.sum()),
        "Speci_Paternal_Mapping_pairs": int(spec.sum()),
        "Speci_Maternal_both_sides_pairs": sp["M"][1],
        "Speci_Paternal_both_sides_pairs": sp["P"][1],
        "Speci_Maternal_single_sides_pairs": sp["M"][2],
        "Speci_Paternal_single_sides_pairs": sp["P"][2],
        "Recombination_pairs": codes[5] + codes[7],
        "Allelic_Ratio": (both_m + both_p + single_m + single_p) / total
        if total else 0.0,
    }


def _write_record_chunks(dirpath, cell, hap, cols, labels, n_chunks):
    """The lines of ``cols`` (see ``record_beds``) in ``n_chunks`` files of
    equal parts."""
    import os

    tab, lens = _table([str(l).encode() for l in labels])
    tags = _table([b"", b"R1", b"R2"])
    n = len(cols[0])
    for k in range(n_chunks):
        s, e = n * k // n_chunks, n * (k + 1) // n_chunks
        (name, c1, s1, p1, sc1, f1, snp1, c2, s2, p2, sc2, f2, snp2, has,
         c15, s16, p17, sc19, f20, csnp, tag) = (
            a[s:e].cpu().numpy() for a in cols)

        def word(idx):
            return [("word", tab, lens, idx)]

        def num(v):
            return [("int", v)]

        const = [("const", b"100")]
        fields = [[("const", RECORD_NAME), ("int", name)], word(c1), num(s1),
                  num(p1), const, num(sc1), num(f1), num(snp1), word(c2),
                  num(s2), num(p2), const, num(sc2), num(f2), num(snp2),
                  word(np.where(has, c15, 0)), num(s16), num(p17), const,
                  num(sc19), num(f20), num(csnp), [("word", *tags, tag)]]
        path = os.path.join(dirpath, f"{cell}_chunk{k}_{hap}.bed")
        with open(path, "wb") as f:
            _format_rows(fields, e - s, f, tail=15, tail_rows=has)


# ------------------------------------------------------ alignment chunks
# alignment_chunks: read groups drawn from ALN_TEMPLATES, each a group of
# records in name order (tag, file g(lobal)/r(escue), kind, fragment
# letter, length) and the outcome the case tree gives it (level 1):
#   kinds  U unique, M multi (XS >= AS), W weak multi (AS > XS: multi at
#          level 1, unique at level 2), A mapped without AS, N unmapped,
#          S a scaffold hit;
#   letters a-f: records with one letter share a fragment, different
#          letters lie in different fragments (x: not placed);
#   lengths F read_len, s shorter;
#   outcome U unmapped, M multi, E "" (unknown tag set), "R a b [c mark]"
#          one row of those slots, "P row / row" the _1/_2 pair.
# The weights (the first field) are invented, as are ALN_ANCHOR,
# ALN_SPECIFIC and ALN_CIS below: no published mapping statistic stands
# behind them.  They make plain unique pairs most of the groups and give
# every branch of the case tree enough groups to test; a user's chunk
# mixes group sizes and outcomes otherwise, so groups/s, rows and the
# walls of the resolve step measured on this draw hold for this mix only.
# Only the sizes are sourced: the chunk (rebuildF -c's default), the
# read length, the fragment widths and the SNP density.
ALN_TEMPLATES = (
    (700, "1gUaF 2gUbF", "R 0 1"),
    (12, "1gNxF 2gUbF", "U"),
    (12, "1gUaF 2gNxF", "U"),
    (8, "1gUaF 2gSbF", "U"),
    (12, "1gMaF 2gUbF", "M"),
    (8, "1gUaF 2gWbF", "M"),
    (4, "1gMaF 2gNxF", "M"),
    (4, "1gNxF 2gMbF", "U"),
    (4, "1gAaF 2gUbF", "M"),
    (2, "11rUas 12rUbs", "R 0 1"),
    (10, "1gUaF 2gNxF 2rUbs", "R 0 2"),
    (6, "1gUaF 2gUcF 2rUbs", "R 0 2"),
    (4, "1gUaF 2gMcF 2rUbs", "R 0 2"),
    (4, "1gMaF 2gUcF 2rUbs", "R 0 2"),
    (3, "1gNxF 2gNxF 2rUbs", "U"),
    (3, "1gMaF 2gNxF 2rUbs", "M"),
    (3, "1gNxF 2gUaF 2rUbs", "U"),
    (3, "1gUaF 2gUbF 21rUcs", "R 2 1"),
    (3, "11rUas 12rUbs 2gUcF", "R 0 2"),
    (6, "1gNxF 11rUas 12rUbs 2gUbF", "R 1 3 2 R2"),
    (6, "1gNxF 11rUas 12rUas 2gUbF", "R 1 3 2 R1"),
    (6, "1gUdF 11rUas 12rUbs 2gUcF", "P 1 2 / 2 3"),
    (3, "1gNxF 11rMas 12rUbs 2gUbF", "U"),
    (3, "1gNxF 11rMas 12rUbs 2gUcF", "R 2 3"),
    (3, "1gNxF 11rUas 12rMbs 2gUcF", "R 1 3"),
    (2, "1gNxF 11rUas 12rUbs 2gNxF", "U"),
    (2, "1gNxF 11rNxs 12rNxs 2gUcF", "U"),
    (2, "1gNxF 11rUas 12rUbs 2gMcF", "M"),
    (2, "1gNxF 11rMas 12rNxs 2gUcF", "M"),
    (6, "1gUaF 2gNxF 21rUbs 22rUbs", "R 0 2 3 R2"),
    (6, "1gUaF 2gNxF 21rUbs 22rUas", "R 0 2 3 R1"),
    (6, "1gUaF 2gUdF 21rUbs 22rUcs", "P 0 3 / 3 2"),
    (3, "1gUaF 2gNxF 21rMbs 22rUas", "U"),
    (3, "1gUaF 2gNxF 21rMbs 22rUcs", "R 0 3"),
    (3, "1gUaF 2gNxF 21rUbs 22rMcs", "R 0 2"),
    (2, "1gNxF 2gNxF 21rUbs 22rUcs", "U"),
    (2, "1gMaF 2gNxF 21rUbs 22rUcs", "M"),
    (6, "1gNxF 1rUas 2gNxF 2rUbs", "R 1 3"),
    (2, "1gNxF 1rMas 2gNxF 2rUbs", "M"),
    (2, "1gNxF 1rUas 2gNxF 2rNxs", "U"),
    (2, "1gNxF 1rMas 2gNxF 2rNxs", "M"),
    (2, "1gNxF 1rNxs 2gNxF 2rMbs", "U"),
    (2, "1gNxF 1rUaF 2gNxF 2rUbs", "U"),
    (2, "1gUcF 1rUas 2gUdF 2rUbs", "R 1 3"),
    (4, "1gNxF 11rUas 12rUbs 2gNxF 2rUbs", "R 1 4 2 R2"),
    (4, "1gNxF 11rUas 12rUas 2gNxF 2rUcs", "R 1 4 2 R1"),
    (4, "1gNxF 11rUas 12rUbs 2gNxF 2rUcs", "P 1 2 / 2 4"),
    (2, "1gNxF 11rUas 12rUbs 2gUcF 2rUdF", "U"),
    (2, "1gNxF 11rMas 12rUbs 2gNxF 2rUcs", "R 2 4"),
    (4, "1gNxF 1rUas 2gNxF 21rUbs 22rUbs", "R 1 3 4 R2"),
    (4, "1gNxF 1rUas 2gNxF 21rUbs 22rUas", "R 1 3 4 R1"),
    (4, "1gNxF 1rUas 2gNxF 21rUbs 22rUcs", "P 1 4 / 4 3"),
    (2, "1gUdF 1rUaF 2gNxF 21rUbs 22rUcs", "U"),
    (2, "1gNxF 1rUas 2gNxF 21rUbs 22rMcs", "R 1 3"),
    (3, "1gNxF 11rUas 12rUas 2gNxF 21rUbs 22rUbs", "R 1 4 5 R2"),
    (3, "1gNxF 11rUas 12rUas 2gNxF 21rUbs 22rUcs",
     "P 1 5 2 R1 / 2 4 2 R1"),
    (3, "1gNxF 11rUas 12rUbs 2gNxF 21rUcs 22rUcs",
     "P 1 4 5 R2 / 2 4 5 R2"),
    (3, "1gNxF 11rUas 12rUbs 2gNxF 21rUcs 22rUbs",
     "P 1 5 2 R2 / 2 4 5 R1"),
    (3, "1gNxF 11rUas 12rUbs 2gNxF 21rUcs 22rUds", "P 1 2 / 5 4"),
    (2, "1gNxF 11rMas 12rUbs 2gNxF 21rUcs 22rUds", "P 2 5 / 5 4"),
    (2, "1gNxF 11rMas 12rUbs 2gNxF 21rUcs 22rMds", "R 2 4"),
    (2, "1gNxF 11rMas 12rUbs 2gNxF 21rMcs 22rUds", "R 2 5"),
    (2, "1gNxF 11rUas 12rUbs 2gNxF 21rMcs 22rUbs", "R 1 5 2 R2"),
    (2, "1gNxF 11rNxs 12rNxs 2gNxF 21rUcs 22rUds", "U"),
    (2, "1gNxF 11rUas 12rUbs 2gNxF 21rMcs 22rMds", "M"),
    (2, "1gNxF 11rMas 12rUbs 2gNxF 21rUcs 22rUcs", "R 2 4 5 R2"),
    (6, "1gUaF", "E"),
    (2, "2gUaF", "E"),
    (2, "1gUaF 2gUbF 2rUcs 2rUds", "E"),
    (2, "1gNxF 11rUas 12rUbs 2gUcF 21rUds", "E"),
    (2, "1gNxF 11rUas 12rUbs 2gUcF 2rUds 21rUes", "E"),
    (2, "1gNxF 1rUas 11rUbs 12rUcs 2gUdF 21rUes 22rUfs", "E"),
)
ALN_NAME = b"SRR1658570."
ALN_SCAFFOLD = "chrUn_gl000220"
ALN_FRAG_GAP = (40, 841)      # fragment widths: MboI-like, ~440 bp
ALN_SNP_GAP = (1, 3000)       # heterozygous SNP spacing: ~1 per 1.5 kb
ALN_ANCHOR = 0.3              # share of 2/3-read mates over a SNP (invented)
ALN_SPECIFIC = (0.9, 0.05, 0.05)  # mapped in both, M only, P only (invented)
ALN_CIS = 0.8                 # intra-chromosomal 2/3-read groups (invented)
ALN_SPREAD = 20               # fragments between letters of a 4+ group
ALN_SLOTS = 7
_ALN_KINDS = "UMWANS"
_ALN_TAGS = ("", "1", "2", "11", "12", "21", "22")
_ALN_OUT = {"E": 0, "U": 1, "M": 2, "R": 3, "P": 4}   # pipeline.pairs codes
_ALN_TAIL = (b"XN:i:0", b"XM:i:0", b"XO:i:0", b"XG:i:0", b"NM:i:0",
             b"YT:Z:UU")


def _aln_templates():
    """ALN_TEMPLATES as arrays: weights [T], sizes [T], per slot [T, 7]
    (tag code, file 0-3 = global R1, global R2, rescue R1, rescue R2,
    kind, letter (-1 unplaced), short), outcome [T] and rows [T, 2, 4]
    (slots of mates a, b, c and the marker; -1 none)."""
    import re

    T = len(ALN_TEMPLATES)
    slot = np.full((5, T, ALN_SLOTS), -1, np.int64)
    rows = np.full((T, 2, 4), -1, np.int64)
    size, out = np.zeros(T, np.int64), np.zeros(T, np.int64)
    for t, (_, recs, res) in enumerate(ALN_TEMPLATES):
        keys = []
        for j, r in enumerate(recs.split()):
            tag, where, kind, letter, ln = re.fullmatch(
                r"(\d+)([gr])([UMWANS])([a-fx])([Fs])", r).groups()
            f = (0 if where == "g" else 2) + (tag[0] == "2")
            slot[:, t, j] = (_ALN_TAGS.index(tag), f, _ALN_KINDS.index(kind),
                             "abcdefx".index(letter) if letter != "x" else -1,
                             ln == "s")
            keys.append((tag, f))
        if keys != sorted(keys):
            raise ValueError(f"template {recs!r} is not in name order")
        size[t] = len(keys)
        out[t] = _ALN_OUT[res[0]]
        for k, part in enumerate(res[1:].split("/") if res[0] in "RP"
                                 else []):
            v = part.split()
            rows[t, k, :len(v) if len(v) < 4 else 3] = [int(x) for x in
                                                        v[:3]]
            if len(v) == 4:
                rows[t, k, 3] = 1 if v[3] == "R1" else 2
    weights = np.asarray([w for w, _, _ in ALN_TEMPLATES], np.float64)
    return weights, size, slot, out, rows


def _aln_genome(g, lengths, device):
    """Fragment ends and SNPs per chromosome: (ends list, snp positions
    list, m / p alleles (codes 0-3) lists)."""
    ends, snps, m_all, p_all = [], [], [], []
    for L in lengths:
        n = int(L / 400) + 16
        gap = torch.randint(*ALN_FRAG_GAP, (n,), generator=g, device=device)
        e = torch.cumsum(gap, 0)
        e = torch.cat([e[e < L], torch.tensor([L], device=device)])
        ends.append(e)
        n = int(L / 1400) + 16
        gap = torch.randint(*ALN_SNP_GAP, (n,), generator=g, device=device)
        s = torch.cumsum(gap, 0)
        s = s[s < L]
        ref = torch.randint(0, 4, s.shape, generator=g, device=device)
        alt = (ref + torch.randint(1, 4, s.shape, generator=g,
                                   device=device)) % 4
        m_is_ref = torch.rand(s.shape, generator=g, device=device) < 0.5
        snps.append(s)
        m_all.append(torch.where(m_is_ref, ref, alt))
        p_all.append(torch.where(m_is_ref, alt, ref))
    return ends, snps, m_all, p_all


def _aln_write_genome(gdir, labels, ends, snps, m_all, p_all):
    """The fragment table of each haplotype (``MboI_<hap>_fragments.txt``,
    ``chrom start end`` lines, as ``rebuildG`` writes them) and the SNP
    npz (``Snps.npz``, ``<chrom>/{pos,ref,m_alt,p_alt}``)."""
    import os

    os.makedirs(gdir, exist_ok=True)
    tab, lens = _table([str(l).encode() for l in labels])
    c = np.concatenate([np.full(len(e), i) for i, e in enumerate(ends)])
    e = np.concatenate([_host(x) for x in ends])
    s = np.concatenate([np.concatenate([[0], _host(x)[:-1]]) for x in ends])
    frags = []
    for hap in ("Maternal", "Paternal"):
        path = os.path.join(gdir, f"MboI_{hap}_fragments.txt")
        with open(path, "wb") as f:
            _format_rows([[("word", tab, lens, c)], [("int", s)],
                          [("int", e)]], len(c), f)
        frags.append(path)
    base = np.array(list("ACGT"))
    flat = {}
    for l, pos, m, p in zip(labels, snps, m_all, p_all):
        m, p = _host(m), _host(p)
        flat[f"{l}/pos"] = _host(pos).astype(np.int64)
        # the reference allele is one of the two (heterozygous SNPs)
        flat[f"{l}/ref"] = base[np.minimum(m, p)].astype("U1")
        flat[f"{l}/m_alt"] = base[m].astype("U1")
        flat[f"{l}/p_alt"] = base[p].astype("U1")
    snp_path = os.path.join(gdir, "Snps.npz")
    np.savez(snp_path, **flat)
    return frags, snp_path


def alignment_chunks(aln_dir: str, re_dir: str, cell: str, lengths, labels,
                     n_pairs: int, chunks: int, seed: int = 0,
                     read_len: int = 150, fmt: str = "sam", *,
                     device, junctions: bool = False) -> dict:
    """Alignment files of ``n_pairs`` read groups in ``chunks`` chunks as
    the mapping stages write them (``<cell>_chunk<i>_<1|2>_<hap>.<fmt>``
    in ``aln_dir`` for the global mapping and in ``re_dir`` for the rescue
    mapping, ``fmt`` one of ``sam``, ``sam.gz``, ``bam``), with the genome
    files they need in ``<parent of aln_dir>/genome``: a fragment table per
    haplotype (MboI-like widths, ~7 M fragments on hg19) and a SNP npz
    (one heterozygous SNP per ~1.5 kb).  Groups follow ALN_TEMPLATES, an
    invented mix (see its comment; every template at least once when
    ``n_pairs`` allows); reads carry their source haplotype's allele at
    every SNP they cover, so a read
    counts its SNPs in its source haplotype's files and none in the
    other's; ALN_SPECIFIC of the groups are unmapped in one haplotype.
    Returns the planted truth: per haplotype the report of
    ``bam_extract`` (level 1) and ``rows`` (``rows15``, ``rows23``,
    ``suffixed`` (``_1``/``_2`` rows), ``snps`` (the SNP columns summed)),
    ``hits`` (groups per template), ``records`` (per haplotype),
    ``fragments`` and ``snps`` (paths).

    ``junctions=True`` (off by default: the draw is then byte for byte the
    same as without the option) plants MboI ligation junctions in the
    global mapping's reads that are unmapped in both haplotypes (template
    kind N), by ``ALN_JUNCTIONS``, an invented mix: none, one ``GATCGATC``,
    two apart, or one ``GATCGATCGATC`` (two overlapping matches, one
    non-overlapping: rescued), at uniform offsets; every other ``GATC`` of
    the reads' random bases is broken first (its C made an A, never at a
    SNP), so no read holds a junction by chance.  The bamProcess truth
    holds unchanged (no stage reads those bases), and ``rescue`` holds the
    rescue's planted truth per haplotype, both global files and all chunks
    summed: ``reads`` (unmapped global records), ``records`` (FASTQ records
    written), ``split`` (reads written as two sub-reads) and ``bases``."""
    import gzip
    import os

    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    ends, snps, m_all, p_all = _aln_genome(g, lengths, dev)
    frags, snp_path = _aln_write_genome(
        os.path.join(os.path.dirname(os.path.abspath(aln_dir)), "genome"),
        labels, ends, snps, m_all, p_all)
    C = len(lengths)
    # the fragment arrays as the loader builds them ([1, ends...]) and the
    # SNPs, concatenated, with each chromosome's offset
    arr = torch.cat([torch.cat([torch.ones(1, dtype=torch.int64,
                                           device=dev), e]) for e in ends])
    n_frag = torch.tensor([len(e) for e in ends], device=dev)
    arr_off = torch.cumsum(n_frag + 1, 0) - (n_frag + 1)
    snp_pos = torch.cat(snps)
    n_snp = torch.tensor([len(s) for s in snps], device=dev)
    snp_off = torch.cumsum(n_snp, 0) - n_snp
    snp_key = torch.cat([(i << 40) | s for i, s in enumerate(snps)])
    allele = torch.stack([torch.cat(m_all), torch.cat(p_all)])   # [2, S]

    weights, size, slot, out, rows = (torch.from_numpy(a).to(dev) for a in
                                      _aln_templates())
    T, G = len(weights), n_pairs
    t = torch.multinomial(weights, G, True, generator=g)
    t[:min(T, G)] = torch.arange(min(T, G), device=dev)
    n = size[t]
    start = torch.cumsum(n, 0) - n
    R = int(n.sum())
    rg = torch.repeat_interleave(torch.arange(G, device=dev), n)
    rj = torch.arange(R, device=dev) - start[rg]
    rt = t[rg]
    tag, file, kind, letter, short = (slot[k, rt, rj] for k in range(5))
    side = (file % 2 == 1).long()
    spec = _pick(g, ALN_SPECIFIC, G, dev)
    src = torch.randint(0, 2, (G, 2), generator=g, device=dev)[rg, side]

    # placement: a chromosome per side, fragments by letter
    wlen = torch.tensor(lengths, dtype=torch.float64, device=dev)
    chrom_a = torch.multinomial(wlen, G, True, generator=g)
    chrom_b = torch.where(
        torch.rand(G, generator=g, device=dev) < ALN_CIS, chrom_a,
        torch.multinomial(wlen, G, True, generator=g))
    big = n >= 4
    chrom_b = torch.where(big, chrom_a, chrom_b)
    chrom = torch.where(letter <= 0, chrom_a[rg], chrom_b[rg])
    nf = n_frag[chrom]
    span = (n_frag[chrom_a] - 6 * ALN_SPREAD - 1).clamp(min=1)
    i0 = 1 + (torch.rand(G, generator=g, device=dev) * span).long()
    step = torch.randint(1, ALN_SPREAD + 1, (G,), generator=g, device=dev)
    free = 1 + (torch.rand(R, generator=g, device=dev) * nf).long()
    fi = torch.where(big[rg], i0[rg] + letter.clamp(min=0) * step[rg], free)
    fi = torch.minimum(fi.clamp(min=1), nf)
    lo, hi = arr[arr_off[chrom] + fi - 1], arr[arr_off[chrom] + fi]
    pos1 = lo + 1 + (torch.rand(R, generator=g, device=dev, dtype=torch.float64)
                     * (hi - lo)).long().clamp(max=hi - lo - 1)
    qlen = torch.where(short.bool(), torch.randint(
        read_len // 4, read_len - 4, (R,), generator=g, device=dev),
        read_len)
    anchor = (~big[rg] & (letter >= 0) & (n_snp[chrom] > 0)
              & (torch.rand(R, generator=g, device=dev) < ALN_ANCHOR))
    pick = snp_off[chrom] + (torch.rand(R, generator=g, device=dev)
                             * n_snp[chrom]).long().clamp(
        max=(n_snp[chrom] - 1).clamp(min=0))
    back = (torch.rand(R, generator=g, device=dev) * qlen).long()
    pos1 = torch.where(anchor, (snp_pos[pick.clamp(
        max=max(len(snp_pos) - 1, 0))] - back).clamp(min=2), pos1)

    # sequences: random bases, each covered SNP carrying the source allele
    chromosomal = (kind <= _ALN_KINDS.index("A")) & (letter >= 0)
    c40 = chrom << 40
    k_lo = torch.searchsorted(snp_key, c40 | pos1)
    k_hi = torch.searchsorted(snp_key, c40 | (pos1 + qlen))
    cover = torch.where(chromosomal, k_hi - k_lo, 0)
    seq = torch.randint(0, 4, (R, read_len), generator=g, device=dev,
                        dtype=torch.uint8)
    if junctions:          # no GATC (codes 2 0 3 1) in the random bases
        hit = ((seq[:, :-3] == 2) & (seq[:, 1:-2] == 0) & (seq[:, 2:-1] == 3)
               & (seq[:, 3:] == 1))
        seq[:, 3:][hit] = 0
    rep = torch.repeat_interleave(torch.arange(R, device=dev), cover)
    at = k_lo[rep] + torch.arange(len(rep), device=dev) - (
        torch.cumsum(cover, 0) - cover)[rep]
    seq[rep, snp_pos[at] - pos1[rep]] = allele[src[rep], at].to(torch.uint8)
    # 0 1 2 3 -> A C G T
    seq = 65 + 2 * seq + 2 * (seq >= 2).to(torch.uint8) + 11 * (
        seq == 3).to(torch.uint8)

    # per haplotype: kinds (all N where the group is unmapped there), the
    # outcome of each group and its truth
    N = _ALN_KINDS.index("N")
    truth = {"hits": torch.bincount(t, minlength=T).tolist(), "records": R,
             "fragments": frags, "snps": snp_path}
    kinds = {}
    for h, hap in enumerate(("Maternal", "Paternal")):
        gone = spec == 2 - h
        kh = torch.where(gone[rg], N, kind)
        kinds[hap] = kh
        o = torch.where(gone & (out[t] != 0), 1, out[t])
        count = torch.where(src == h, cover, 0)
        r15 = r23 = suffixed = snp_sum = 0
        for k in range(2):
            live = (o == 4) if k else (o >= 3)
            slots = rows[t, k]
            has_c = slots[:, 2] >= 0
            r23 += int((live & has_c).sum())
            r15 += int((live & ~has_c).sum())
            suffixed += int((live & (o == 4)).sum())
            for m in range(3):
                ok = live & (slots[:, m] >= 0)
                snp_sum += int(count[(start + slots[:, m].clamp(min=0))[ok]]
                               .sum())
        unm = int(((o == 0) | (o == 1)).sum())
        multi = int((o == 2).sum())
        truth[hap] = {"Total_pairs": G, "Unmapped_pairs": unm,
                      "Multiple_pairs": multi,
                      "Unique_pairs": G - unm - multi}
        truth.setdefault("rows", {})[hap] = dict(
            rows15=r15, rows23=r23, suffixed=suffixed, snps=snp_sum)

    # the files: host columns, then per chunk, haplotype and file
    ids = _host(rg + 1)
    col = {k: _host(v) for k, v in dict(
        tag=tag, file=file, qlen=qlen, pos1=pos1, chrom=chrom,
        strand=16 * torch.randint(0, 2, (R,), generator=g, device=dev),
        score=-torch.randint(0, 31, (R,), generator=g, device=dev),
        gap=torch.randint(0, 11, (R,), generator=g, device=dev),
        qual=torch.randint(0, (1 << 16) - read_len, (R,), generator=g,
                           device=dev)).items()}
    kinds = {h: _host(v) for h, v in kinds.items()}
    seq = _host(seq).ravel()
    qual_pool = _host(torch.randint(33, 75, (1 << 16,), generator=g,
                                    device=dev, dtype=torch.uint8))
    if junctions:
        truth["rescue"] = _plant_junctions(
            g, seq, read_len, _host(file), _host(kind), kinds, dev)
    refs = ["chr" + str(l) for l in labels] + [ALN_SCAFFOLD]
    references = dict(zip(refs, [int(x) for x in lengths] + [182896]))
    header = (b"@HD\tVN:1.0\tSO:unsorted\n" + b"".join(
        f"@SQ\tSN:{r}\tLN:{v}\n".encode() for r, v in references.items())
        + b"@PG\tID:bowtie2\tPN:bowtie2\n")
    rtab = _table([b"*"] + [r.encode() for r in refs])
    ttab = _table([b"_" + x.encode() if x else b"" for x in _ALN_TAGS])
    cig = [b"%dM" % q for q in range(read_len + 1)] + [b"*"]
    cig_buf = np.frombuffer(b"".join(cig), np.uint8)
    cig_off = np.cumsum([0] + [len(x) for x in cig[:-1]])
    cig_len = np.asarray([len(x) for x in cig])
    gb = np.asarray([0, 0, 1, 1])       # file -> global (0) / rescue (1)
    for k in range(chunks):
        g0, g1 = G * k // chunks, G * (k + 1) // chunks
        r0 = int(_host(start[g0])) if g0 < G else R
        r1 = int(_host(start[g1])) if g1 < G else R
        for hap in ("Maternal", "Paternal"):
            kh = kinds[hap]
            for f in range(4):
                sel = r0 + np.flatnonzero(col["file"][r0:r1] == f)
                d = (aln_dir, re_dir)[gb[f]]
                os.makedirs(d, exist_ok=True)
                path = os.path.join(
                    d, f"{cell}_chunk{k}_{f % 2 + 1}_{hap}.{fmt}")
                kk = kh[sel]
                unm = kk == N
                cols = dict(
                    ids=ids[sel], tag=col["tag"][sel],
                    flag=np.where(unm, 4, col["strand"][sel]),
                    ref=np.where(unm, 0, np.where(
                        kk == _ALN_KINDS.index("S"), len(refs),
                        1 + col["chrom"][sel])),
                    pos=np.where(unm, 0, col["pos1"][sel]),
                    mapq=np.where(unm, 0, np.where((kk == 1) | (kk == 2),
                                                   1, 42)),
                    cigar=np.where(unm, read_len + 1, col["qlen"][sel]),
                    seq_off=sel * read_len, qlen=col["qlen"][sel],
                    qual=col["qual"][sel],
                    has_as=(kk != N) & (kk != _ALN_KINDS.index("A")),
                    tag_as=col["score"][sel],
                    has_xs=(kk == 1) | (kk == 2),
                    tag_xs=col["score"][sel] + np.where(
                        kk == 1, col["gap"][sel], -1 - col["gap"][sel]))
                if fmt == "bam":
                    _aln_bam(path, cols, ttab, refs, references, seq,
                             qual_pool)
                    continue
                fields = [
                    [("const", ALN_NAME), ("int", cols["ids"]),
                     ("word", *ttab, cols["tag"])],
                    [("int", cols["flag"])], [("word", *rtab, cols["ref"])],
                    [("int", cols["pos"])], [("int", cols["mapq"])],
                    [("text", cig_buf, cig_off[cols["cigar"]],
                      cig_len[cols["cigar"]])],
                    [("const", b"*")], [("const", b"0")], [("const", b"0")],
                    [("text", seq, cols["seq_off"], cols["qlen"])],
                    [("text", qual_pool, cols["qual"], cols["qlen"])]] + [
                    [("const", x)] for x in _ALN_TAIL] + [
                    [("const", b"AS:i:"), ("int", cols["tag_as"])],
                    [("const", b"XS:i:"), ("int", cols["tag_xs"])]]
                nf = (11 + len(_ALN_TAIL) + cols["has_as"]
                      + (cols["has_as"] & cols["has_xs"]))
                opener = (gzip.open(path, "wb", compresslevel=1)
                          if fmt == "sam.gz" else open(path, "wb"))
                with opener as fh:
                    fh.write(header)
                    _format_rows(fields, len(sel), fh, row_fields=nf)
    return truth


# alignment_chunks(junctions=True): the share of the global mapping's
# reads unmapped in both haplotypes that carry no junction, one GATCGATC,
# two apart, or one GATCGATCGATC.  Invented, as ALN_TEMPLATES is.
ALN_JUNCTIONS = (0.55, 0.3, 0.1, 0.05)
_JUNCTION = b"GATCGATC"


def _plant_junctions(g, seq, read_len, file, kind, kinds, dev) -> dict:
    """Junctions written into the host sequences ``seq`` ([R * read_len]
    ASCII) of the global records of template kind N, and the rescue's
    truth per haplotype (see ``alignment_chunks``)."""
    from ..pipeline.rescue import MIN_LEN

    N = _ALN_KINDS.index("N")
    target = np.flatnonzero((file <= 1) & (kind == N))
    T, J, L = len(target), len(_JUNCTION), read_len
    cls = _host(torch.multinomial(torch.tensor(
        ALN_JUNCTIONS, dtype=torch.float64, device=dev), max(T, 1), True,
        generator=g))[:T]
    u = _host(torch.rand((2, max(T, 1)), generator=g, device=dev,
                         dtype=torch.float64))[:, :T]
    span = np.where(cls == 2, L - 2 * J, np.where(cls == 3, L - J - 4,
                                                  L - J))
    a = (u[0] * (span + 1)).astype(np.int64)
    b = a + J + (u[1] * (L - J - a - J + 1)).astype(np.int64)
    base = target.astype(np.int64) * L
    for k in range(J):
        for at, on in ((a, cls >= 1), (b, cls == 2)):
            seq[(base + at + k)[on]] = _JUNCTION[k]
        seq[(base + a + J + k)[(cls == 3) & (k < 4)]] = _JUNCTION[k]
    one = (cls == 1) | (cls == 3)
    l1, l2 = a, L - a - J
    k1, k2 = one & (l1 >= MIN_LEN), one & (l2 >= MIN_LEN)
    out = {}
    glob = file <= 1
    for hap, kh in kinds.items():
        kh = _host(kh) if isinstance(kh, torch.Tensor) else kh
        out[hap] = dict(
            reads=int((glob & (kh == N)).sum()),
            records=int(k1.sum() + k2.sum()), split=int((k1 & k2).sum()),
            bases=int((l1 * k1).sum() + (l2 * k2).sum()))
    return out


def _aln_bam(path, cols, ttab, refs, references, seq, qual_pool):
    """One alignment file of ``alignment_chunks`` as BAM (``io.bam.
    write_bam``)."""
    import io

    from ..io.bam import write_bam
    from ..io.sam import Alignments

    n = len(cols["ids"])
    buf = io.BytesIO()
    _format_rows([[("const", ALN_NAME), ("int", cols["ids"]),
                   ("word", *ttab, cols["tag"])]], n, buf)
    names = np.frombuffer(buf.getvalue(), np.uint8)
    stop = np.flatnonzero(names == 10)
    first = np.concatenate([[0], stop[:-1] + 1]).astype(np.int64)
    zeros = np.zeros(n, np.int32)
    has = (cols["has_as"].astype(np.int8)
           | (2 * (cols["has_as"] & cols["has_xs"])).astype(np.int8))
    aln = Alignments(
        names=names, name_off=first, name_len=(stop - first).astype(np.int32),
        base_len=zeros, tag=zeros.astype(np.int8), last=zeros.astype(np.int8),
        flag=cols["flag"].astype(np.int32),
        ref=(cols["ref"] - 1).astype(np.int32),
        pos=(cols["pos"] - 1).astype(np.int64),
        qlen=cols["qlen"].astype(np.int32), seqs=seq,
        seq_off=cols["seq_off"].astype(np.int64),
        seq_len=cols["qlen"].astype(np.int32),
        tag_as=cols["tag_as"].astype(np.int64),
        tag_xs=cols["tag_xs"].astype(np.int64), has=has,
        refs=[r.encode() for r in refs])
    write_bam(path, aln, references, "@HD\tVN:1.0\tSO:unsorted\n",
              mapq=cols["mapq"].astype(np.int32),
              qual=(qual_pool, cols["qual"].astype(np.int64),
                    cols["qlen"].astype(np.int32)))


# ------------------------------------------------------- genome and reads
# genome_draw: hg19's layout of N runs, cut to three kinds of rows of the
# UCSC gap table: the telomeres (10,000 N at each end), a centromere of
# 3,000,000 N (hg19's centromere rows are 3 Mb; its place, 40% along the
# chromosome, is invented) and, on the acrocentric chromosomes, the N run
# before the first called base of hg19 (GENOME_LEAD_N; it includes the
# telomere and stands in for the short arm).  The soft-masked share
# (lowercase, RepeatMasker and TRF in the UCSC FASTA) is about half of
# hg19; its runs here alternate with unmasked runs of the same mean
# length, GENOME_MASK_RUN, which is invented.  Lines of 50 bases and
# ">chrN" headers, as the UCSC hg19.fa.
GENOME_TELOMERE = 10_000
GENOME_CENTROMERE = 3_000_000
GENOME_CENTROMERE_AT = 0.4
GENOME_LEAD_N = {"13": 19_020_000, "14": 19_000_000, "15": 20_000_000,
                 "21": 9_411_193, "22": 16_050_000}
GENOME_MASK_RUN = 300
GENOME_LINE = 50
# genome_draw(repeats=n), opt-in: n duplicated segments of REPEAT_LEN and n
# inverted repeats (a run of PALINDROME_HALF bases followed by its reverse
# complement, upper case), spread over the chromosomes by index; their
# places and sizes are invented
REPEAT_LEN = 400
PALINDROME_HALF = 100


def _ascii_bases(codes: torch.Tensor) -> torch.Tensor:
    """Codes 0-3 (uint8) as A, C, G, T (65, 67, 71, 84), in place."""
    g_or_t = (codes >= 2).to(torch.uint8)
    t = (codes == 3).to(torch.uint8)
    return codes.mul_(2).add_(65).add_(2 * g_or_t).add_(11 * t)


def _genome_chrom(g, L: int, name: str, dev) -> torch.Tensor:
    """One chromosome of ``genome_draw``: random bases, soft-masked runs,
    N runs."""
    seq = _ascii_bases(torch.randint(0, 4, (L,), generator=g, device=dev,
                                     dtype=torch.uint8))
    n_runs = 2 * (L // GENOME_MASK_RUN * 9 // 16 + 8)   # ~1.125 L bases
    runs = torch.randint(1, 2 * GENOME_MASK_RUN, (n_runs,), generator=g,
                         device=dev)
    flag = (torch.arange(n_runs, device=dev) % 2 * 32).to(torch.uint8)
    mask = torch.repeat_interleave(flag, runs)
    if mask.numel() < L:
        raise RuntimeError("genome_draw: the masked runs fall short")
    seq |= mask[:L]
    lead = GENOME_LEAD_N.get(name, GENOME_TELOMERE)
    mid = int(L * GENOME_CENTROMERE_AT)
    for a, b in ((0, lead), (L - GENOME_TELOMERE, L),
                 (mid, mid + GENOME_CENTROMERE)):
        seq[max(a, 0):min(b, L)] = ord("N")
    return seq


def _comp_table(dev) -> torch.Tensor:
    comp = torch.arange(256, device=dev, dtype=torch.uint8)
    comp[torch.tensor([65, 67, 71, 84], device=dev)] = torch.tensor(
        [84, 71, 67, 65], device=dev, dtype=torch.uint8)
    return comp


def _free_at(g, seq, width: int, dev) -> int:
    """A start whose ``width`` bytes hold no N (-1 after 100 tries)."""
    for _ in range(100):
        p = int(torch.randint(0, seq.numel() - width, (1,), generator=g,
                              device=dev))
        if not bool((seq[p:p + width] == ord("N")).any()):
            return p
    return -1


def _plant_repeats(g, seq, count: int, dev):
    """``count`` duplicated segments and ``count`` inverted repeats written
    into one chromosome, none overlapping another: ([(src, dst)],
    [start])."""
    dup, pal, taken = [], [], []
    if seq.numel() < 4 * REPEAT_LEN:
        return dup, pal

    def free(a, width):
        return all(a + width <= b or e <= a for b, e in taken)

    comp = _comp_table(dev)
    for _ in range(count):
        src = _free_at(g, seq, REPEAT_LEN, dev)
        dst = _free_at(g, seq, REPEAT_LEN, dev)
        if min(src, dst) < 0 or abs(src - dst) < REPEAT_LEN or not (
                free(src, REPEAT_LEN) and free(dst, REPEAT_LEN)):
            continue
        seq[dst:dst + REPEAT_LEN] = seq[src:src + REPEAT_LEN]
        dup.append((src, dst))
        taken += [(src, src + REPEAT_LEN), (dst, dst + REPEAT_LEN)]
    for _ in range(count):
        H = PALINDROME_HALF
        c = _free_at(g, seq, 2 * H, dev)
        if c < 0 or not free(c, 2 * H):
            continue
        taken.append((c, c + 2 * H))
        seq[c:c + H] &= 0xDF
        seq[c + H:c + 2 * H] = comp[seq[c:c + H].flip(0).long()]
        pal.append(c)
    return dup, pal


def genome_draw(fasta: str, snp_file: str, lengths, names, seed: int = 0,
                *, device, repeats: int = 0) -> dict:
    """A genome of ``lengths`` (``names`` without ``chr``) drawn on
    ``device`` and written as a FASTA (``>chr<name>``, 50 bases a line),
    with a phased SNP table (5 columns: ``chr<name>``, 1-based position,
    ref, maternal and paternal allele) at ``ALN_SNP_GAP``'s spacing (one
    heterozygous SNP per ~1.5 kb; none in N runs, so ~1.92 M on hg19; the
    reference base uppercase, one of the two alleles, the other a different
    base).  Returns ``chroms`` ({name: uint8 tensor on device}) and
    ``snps`` ({name: (positions, maternal, paternal), tensors on device,
    the alleles as ASCII codes}).  With ``repeats``, ``repeats`` duplicated
    segments and as many inverted repeats are planted (``_plant_repeats``,
    a generator of their own, so the rest of the draw is unchanged) and
    returned: ``repeats`` ({name: [(src, dst)]}, 0-based starts of the two
    copies of REPEAT_LEN bases) and ``palindromes`` ({name: [start]}, runs
    of 2 * PALINDROME_HALF bases equal to their reverse complement)."""
    import os

    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    g_rep = torch.Generator(device=dev)
    g_rep.manual_seed(seed + 7919)
    chroms, snps = {}, {}
    dups, pals = {}, {}
    rows = {k: [] for k in ("chrom", "pos", "ref", "m", "p")}
    os.makedirs(os.path.dirname(os.path.abspath(fasta)), exist_ok=True)
    from ..io.fasta import wrap

    with open(fasta, "wb") as f:
        for i, (name, L) in enumerate(zip(names, lengths)):
            seq = _genome_chrom(g, int(L), name, dev)
            if repeats:
                dups[name], pals[name] = _plant_repeats(
                    g_rep, seq, repeats // len(names) + (
                        i < repeats % len(names)), dev)
            chroms[name] = seq
            f.write(f">chr{name}\n".encode())
            f.write(wrap(seq, GENOME_LINE).cpu().numpy())
            n = int(L / 1400) + 16
            pos = torch.cumsum(torch.randint(*ALN_SNP_GAP, (n,), generator=g,
                                             device=dev), 0)
            pos = pos[pos <= L]
            ref = seq[pos - 1] & 0xDF                      # uppercase
            pos, ref = pos[ref != ord("N")], ref[ref != ord("N")]
            code = (ref == 67).long() + 2 * (ref == 71).long() + 3 * (
                ref == 84).long()
            alt = (code + torch.randint(1, 4, code.shape, generator=g,
                                        device=dev)) % 4
            m_is_ref = torch.rand(code.shape, generator=g, device=dev) < 0.5
            m = torch.where(m_is_ref, code, alt)
            p = torch.where(m_is_ref, alt, code)
            asc = lambda c: _ascii_bases(c.to(torch.uint8))  # noqa: E731
            snps[name] = (pos, asc(m.clone()), asc(p.clone()))
            for k, v in (("chrom", torch.full_like(pos, i)), ("pos", pos),
                         ("ref", code), ("m", m), ("p", p)):
                rows[k].append(_host(v))
    cols = {k: np.concatenate(v) for k, v in rows.items()}
    ntab = _table([f"chr{n}".encode() for n in names])
    btab = _table([b"A", b"C", b"G", b"T"])
    with open(snp_file, "wb") as f:
        _format_rows([[("word", *ntab, cols["chrom"])], [("int", cols["pos"])],
                      [("word", *btab, cols["ref"])],
                      [("word", *btab, cols["m"])],
                      [("word", *btab, cols["p"])]], len(cols["pos"]), f)
    out = dict(chroms=chroms, snps=snps, n_snps=len(cols["pos"]))
    if repeats:
        out.update(repeats=dups, palindromes=pals)
    return out


# fastq_pair: the read name of SRA's fastq-dump ("@<run>.<spot> <spot>
# length=<n>"), random bases, and Phred+33 qualities of Illumina 1.8+
# ('#'..'J'), drawn uniformly (invented).  Gzip level 4 (bcl2fastq's
# default compression level), written as one gzip member per
# chunking.MEMBER_BYTES, deflated on several threads.
FASTQ_RUN = b"SRR1658570."
FASTQ_QUAL = (35, 75)
FASTQ_BLOCK = 1 << 20         # reads drawn and written at a time


def _fastq_block(g, n, start, read_len, dev, mate_tag):
    """The FASTQ text of reads start .. start + n of one mate, as written
    (``mate_tag`` None) and as ``split_reads`` rewrites its headers."""
    import io

    seq = _host(_ascii_bases(torch.randint(0, 4, (n, read_len), generator=g,
                                           device=dev, dtype=torch.uint8)))
    qual = _host(torch.randint(*FASTQ_QUAL, (n, read_len), generator=g,
                               device=dev, dtype=torch.uint8))
    ids = np.arange(start + 1, start + n + 1, dtype=np.int64)
    off = np.arange(n, dtype=np.int64) * read_len
    ln = np.full(n, read_len, np.int64)
    out = []
    for tag in (None, mate_tag):
        head = [("const", b"@" + FASTQ_RUN), ("int", ids)] + (
            [("const", b"_" + tag)] if tag else [])
        buf = io.BytesIO()
        _format_rows([head + [
            ("const", b" "), ("int", ids),
            ("const", b" length=%d\n" % read_len),
            ("text", seq.ravel(), off, ln), ("const", b"\n+\n"),
            ("text", qual.ravel(), off, ln)]], n, buf)
        out.append(buf.getvalue())
    return out


def fastq_pair(out_dir: str, cell: str, n_reads: int, chunk: int,
               read_len: int = 150, seed: int = 0, *, device) -> dict:
    """Two gzipped FASTQ mates of ``n_reads`` reads, ``<cell>_1.fastq.gz``
    and ``<cell>_2.fastq.gz`` in ``out_dir``, drawn on ``device``.  Returns
    the paths (``fastq``), the uncompressed bytes per mate (``bytes``) and,
    per mate, the SHA-256 of each chunk of ``chunk`` reads as
    ``split_reads`` writes it (``digests``)."""
    import hashlib
    import os

    from ..pipeline.chunking import _GzipWriter

    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    os.makedirs(out_dir, exist_ok=True)
    paths, digests, size = [], {}, {}
    for mate in (1, 2):
        path = os.path.join(out_dir, f"{cell}_{mate}.fastq.gz")
        w = _GzipWriter(path)
        hashes, total = [], 0
        h = None
        for s in range(0, n_reads, FASTQ_BLOCK):
            n = min(FASTQ_BLOCK, n_reads - s)
            text, want = _fastq_block(g, n, s, read_len, dev, b"%d" % mate)
            w.write(text)
            total += len(text)
            # the expected chunk text, cut at chunk boundaries by records
            nl = np.flatnonzero(np.frombuffer(want, np.uint8) == 10)
            ends = np.concatenate([[0], nl[3::4] + 1])
            r0 = 0
            while r0 < n:
                if (s + r0) % chunk == 0:
                    h = hashlib.sha256()
                    hashes.append(h)
                r1 = min(n, r0 + chunk - (s + r0) % chunk)
                h.update(memoryview(want)[ends[r0]:ends[r1]])
                r0 = r1
        w.close()
        paths.append(path)
        digests[mate] = [x.hexdigest() for x in hashes]
        size[mate] = total
    return dict(fastq=paths, digests=digests, bytes=size)


# read_draw: Hi-C mates of the mapping stages drawn from the parental
# genomes, each read with its planted truth.  The name, length and
# qualities are fastq_pair's; the mix of kinds (READ_MIX, the all-N reads
# per block) is invented:
#   both        a window with no SNP and no N: maps to both haplotypes;
#   maternal,   a window over at least one SNP, from that haplotype: maps
#   paternal    to it only;
#   chimera     two windows joined by the MboI junction GATCGATC, parts of
#               at least READ_PART bases: unmapped, cut by Rescue, each
#               part mapped by ReMapping;
#   short       a chimera whose first part has 10-12 bases (Rescue's
#               MIN_LEN is 10): the part maps many times;
#   random      uniform bases: unmapped;
#   n           a window of "both" with one base set to N: unmapped;
#   multi       a window inside one copy of a duplicated segment
#               (genome_draw's repeats): maps to both copies (XS);
#   palindrome  the centre of an inverted repeat: the read is its own
#               reverse complement, so it maps twice at one place (XS);
#   all_n       N only: maps to every N run (XS), first at the first N.
# Every read but the all-N and random ones is reverse-complemented with
# probability 1/2.
READ_MIX = (("both", 0.55), ("maternal", 0.09), ("paternal", 0.09),
            ("chimera", 0.1), ("short", 0.02), ("random", 0.05),
            ("n", 0.04), ("multi", 0.05), ("palindrome", 0.01))
READ_KINDS = tuple(k for k, _ in READ_MIX) + ("all_n",)
READ_ALL_N = 1                # all-N reads per block of FASTQ_BLOCK reads
READ_PART = 32                # the shortest part of a "chimera" (a
                              # random 32-mer recurs in hg19 with odds
                              # 3e-10, a 25-mer with 6e-6)
READ_SHORT = (10, 13)         # the first part of a "short" chimera
_JUNC = torch.tensor(list(b"GATCGATC"), dtype=torch.uint8)
_DRAW_ROUNDS = 1000           # draws of the windows that failed, at most


def _clear(s, width, gen):
    """Whether the windows at ``s`` miss every planted repeat (both copies
    of a duplicated segment, every inverted repeat)."""
    if not len(gen["planted"][0]):
        return torch.ones_like(s, dtype=torch.bool)
    starts, ends = gen["planted"]
    i = torch.searchsorted(starts, s + width) - 1
    return (i < 0) | (ends[i.clamp(min=0)] <= s)


def _windows(g, n, width, gen, avoid_snps: bool):
    """``n`` global starts of windows of ``width`` bytes inside one
    chromosome, without N or planted repeat (and without SNP where
    ``avoid_snps``)."""
    dev = gen["M"].device
    out = torch.empty(n, dtype=torch.int64, device=dev)
    todo = torch.arange(n, device=dev)
    span = (gen["lens"] - width).clamp(min=0).double()
    for _ in range(_DRAW_ROUNDS):
        if not len(todo):
            return out
        c = torch.multinomial(span, len(todo), True, generator=g)
        s = gen["start"][c] + (torch.rand(len(todo), generator=g, device=dev,
                                          dtype=torch.float64)
                               * span[c]).long()
        ok = ~(gen["M"][s[:, None] + torch.arange(width, device=dev)]
               == ord("N")).any(1) & _clear(s, width, gen)
        if avoid_snps and len(gen["snp"]):
            ok &= (torch.searchsorted(gen["snp"], s + width)
                   == torch.searchsorted(gen["snp"], s))
        out[todo[ok]] = s[ok]
        todo = todo[~ok]
    if len(todo):
        raise RuntimeError("read_draw: too few windows without N")
    return out


def _snp_windows(g, n, width, gen):
    """``n`` global starts of windows of ``width`` bytes over a SNP, inside
    one chromosome, without N or planted repeat."""
    dev = gen["M"].device
    out = torch.empty(n, dtype=torch.int64, device=dev)
    todo = torch.arange(n, device=dev)
    for _ in range(_DRAW_ROUNDS):
        if not len(todo):
            return out
        i = torch.randint(0, len(gen["snp"]), (len(todo),), generator=g,
                          device=dev)
        snp = gen["snp"][i]
        s = snp - torch.randint(0, width, (len(todo),), generator=g,
                                device=dev)
        c = torch.searchsorted(gen["start"], snp, right=True) - 1
        ok = (s >= gen["start"][c]) & (s + width <= gen["end"][c])
        sc = s.clamp(min=0, max=gen["M"].numel() - width)
        ok &= ~(gen["M"][sc[:, None] + torch.arange(width, device=dev)]
                == ord("N")).any(1) & _clear(sc, width, gen)
        out[todo[ok]] = s[ok]
        todo = todo[~ok]
    if len(todo):
        raise RuntimeError("read_draw: too few windows over a SNP")
    return out


def _revcomp_rows(x: torch.Tensor, ln: torch.Tensor) -> torch.Tensor:
    """Each row's first ``ln`` bytes reverse-complemented (zero after)."""
    W = x.shape[1]
    j = torch.arange(W, device=x.device)
    src = (ln[:, None] - 1 - j).clamp(min=0)
    comp = _comp_table(x.device)
    return torch.where(j < ln[:, None], comp[x.gather(1, src).long()], 0)


def _planted_hits(hap: torch.Tensor, rows: torch.Tensor, ln: torch.Tensor,
                 cand: torch.Tensor):
    """FakeAligner's answer for reads ``rows`` ([n, W] uint8, lengths
    ``ln``) counting only the planted places ``cand`` ([n, m] global starts
    in ``hap``, -1 for none): (first hit, flag 0/16/4, two hits or more).
    The forward occurrences first, by position (the genome's order), then
    the reverse-complement ones."""
    dev = rows.device
    W = rows.shape[1]
    j = torch.arange(W, device=dev)
    inside = j < ln[:, None]
    rc = _revcomp_rows(rows, ln)
    BIG = torch.iinfo(torch.int64).max
    first = [torch.full((len(rows),), BIG, dtype=torch.int64, device=dev)
             for _ in range(2)]
    total = torch.zeros(len(rows), dtype=torch.int64, device=dev)
    for m in range(cand.shape[1]):
        p = cand[:, m]
        ok = p >= 0
        idx = (p.clamp(min=0)[:, None] + j).clamp(max=hap.numel() - 1)
        win = hap[idx]
        for t, want in enumerate((rows, rc)):
            hit = ok & ((win == want) | ~inside).all(1)
            first[t] = torch.where(hit, torch.minimum(first[t], p), first[t])
            total += hit.long()
    fwd = first[0] < BIG
    hit = torch.where(fwd, first[0], torch.where(first[1] < BIG, first[1],
                                                 -1))
    flag = torch.where(fwd, 0, torch.where(first[1] < BIG, 16, 4))
    return hit, flag, total >= 2


def _junctions(rows: torch.Tensor) -> torch.Tensor:
    """Occurrences of GATCGATC (overlapping ones too) in each row."""
    J = _JUNC.to(rows.device)
    n = rows.shape[1] - len(J) + 1
    hit = torch.ones((len(rows), max(n, 0)), dtype=torch.bool,
                     device=rows.device)
    for k in range(len(J)):
        hit &= rows[:, k:k + n] == J[k]
    return hit.sum(1)


def _read_block(g, n, L, gen, all_n: int):
    """One block of reads: (rows [n, L] uint8, kind, candidates [n, 2],
    part lengths [n, 2], part candidates [n, 2])."""
    dev = gen["M"].device
    K = torch.tensor([w for _, w in READ_MIX], dtype=torch.float64,
                     device=dev)
    kind = torch.multinomial(K, n, True, generator=g)
    kind[:all_n] = READ_KINDS.index("all_n")
    rows = torch.empty((n, L), dtype=torch.uint8, device=dev)
    cand = torch.full((n, 2), -1, dtype=torch.int64, device=dev)
    parts = torch.zeros((n, 2), dtype=torch.int64, device=dev)
    pcand = torch.full((n, 2), -1, dtype=torch.int64, device=dev)
    hap_of = torch.rand(n, generator=g, device=dev) < 0.5     # True: P
    j = torch.arange(L, device=dev)

    def take(sel, starts, width=L):
        src = torch.where(hap_of[sel, None], gen["P"][starts[:, None] + j[
            :width]], gen["M"][starts[:, None] + j[:width]])
        return src

    def idx(name):
        return torch.nonzero(kind == READ_KINDS.index(name)).flatten()

    for name in ("both", "n"):
        sel = idx(name)
        s = _windows(g, len(sel), L, gen, True)
        rows[sel] = take(sel, s)
        cand[sel, 0] = s
        if name == "n":
            at = torch.randint(0, L, (len(sel),), generator=g, device=dev)
            rows[sel, at] = ord("N")
    for name, pat in (("maternal", False), ("paternal", True)):
        sel = idx(name)
        hap_of[sel] = pat
        s = _snp_windows(g, len(sel), L, gen)
        rows[sel] = take(sel, s)
        cand[sel, 0] = s
    sel = idx("multi")
    if len(gen["dup"]):
        r = torch.randint(0, len(gen["dup"]), (len(sel),), generator=g,
                          device=dev)
        o = torch.randint(0, REPEAT_LEN - L + 1, (len(sel),), generator=g,
                          device=dev)
        a, b = gen["dup"][r, 0] + o, gen["dup"][r, 1] + o
        rows[sel] = take(sel, a)
        cand[sel, 0], cand[sel, 1] = a, b
    else:
        kind[sel] = READ_KINDS.index("random")
    sel = idx("palindrome")
    if len(gen["pal"]):
        r = torch.randint(0, len(gen["pal"]), (len(sel),), generator=g,
                          device=dev)
        s = gen["pal"][r] + PALINDROME_HALF - L // 2
        rows[sel] = take(sel, s)
        cand[sel, 0] = s
    else:
        kind[sel] = READ_KINDS.index("random")
    for name in ("chimera", "short"):
        sel = idx(name)
        J = len(_JUNC)
        if name == "chimera":
            l1 = torch.randint(READ_PART, L - J - READ_PART + 1, (len(sel),),
                               generator=g, device=dev)
        else:
            l1 = torch.randint(*READ_SHORT, (len(sel),), generator=g,
                               device=dev)
        a = _windows(g, len(sel), L, gen, False)
        b = _windows(g, len(sel), L, gen, False)
        wa, wb = take(sel, a), take(sel, b)
        l2 = L - J - l1
        out = torch.where(j < l1[:, None], wa, 0)
        at_b = (j - l1[:, None] - J).clamp(min=0)
        out = torch.where(j >= (l1 + J)[:, None], wb.gather(1, at_b), out)
        jj = (j - l1[:, None]).clamp(min=0, max=J - 1)
        inj = (j >= l1[:, None]) & (j < (l1 + J)[:, None])
        out = torch.where(inj, _JUNC.to(dev)[jj], out)
        rows[sel] = out.to(torch.uint8)
        parts[sel, 0], parts[sel, 1] = l1, l2
        pcand[sel, 0], pcand[sel, 1] = a, b
    sel = idx("random")
    rows[sel] = _ascii_bases(torch.randint(0, 4, (len(sel), L), generator=g,
                                           device=dev, dtype=torch.uint8))
    cand[sel] = -1
    rows[idx("all_n")] = ord("N")
    flip = (torch.rand(n, generator=g, device=dev) < 0.5) & (
        kind != READ_KINDS.index("random")) & (
        kind != READ_KINDS.index("all_n"))
    full = torch.full((n,), L, dtype=torch.int64, device=dev)
    rows = torch.where(flip[:, None], _revcomp_rows(rows, full), rows).to(
        torch.uint8)
    # the parts as Rescue cuts them: on a flipped read, B's reverse
    # complement first
    parts = torch.where(flip[:, None], parts.flip(1), parts)
    pcand = torch.where(flip[:, None], pcand.flip(1), pcand)
    return rows, kind, cand, parts, pcand, hap_of


def _part_rows(rows, parts):
    """The two parts of each read as Rescue cuts it at its junction:
    ([n, W] part 1, [n, W] part 2)."""
    n, L = rows.shape
    J = len(_JUNC)
    j = torch.arange(L, device=rows.device)
    p1 = torch.where(j < parts[:, :1], rows, 0)
    at = (j + parts[:, :1] + J).clamp(max=L - 1)
    p2 = torch.where(j < parts[:, 1:], rows.gather(1, at), 0)
    return p1.to(torch.uint8), p2.to(torch.uint8)


def read_draw(out_dir: str, cell: str, haplotypes: dict, snps: dict,
              n_reads: int, read_len: int = 150, seed: int = 0, *, device,
              repeats=None, palindromes=None,
              all_n: int = READ_ALL_N) -> dict:
    """Two gzipped FASTQ mates of ``n_reads`` reads (``<cell>_1.fastq.gz``
    and ``<cell>_2.fastq.gz``, written as ``fastq_pair`` writes them) drawn
    from ``haplotypes`` ({"Maternal": {name: uint8 tensor}, "Paternal":
    ...}, the genome order of the parental FASTAs) with ``snps`` ({name:
    1-based positions}) and ``genome_draw``'s ``repeats`` and
    ``palindromes``, with ``all_n`` all-N reads a block.  Returns the
    paths (``fastq``), the chromosome order and starts (``names``,
    ``starts``: global offsets), the first N of each haplotype
    (``first_n``) and, per mate, the planted truth as host
    arrays: ``kind`` (index into READ_KINDS) and, per haplotype ``M`` /
    ``P``, ``hit`` (global start of FakeAligner's first hit, -1 for none),
    ``flag`` (0, 16 or 4) and ``multi``, counted over the planted places;
    for the chimeras ``parts`` (the lengths of the two parts as Rescue cuts
    them), ``junctions`` (occurrences of the junction) and per haplotype
    ``part_hit``, ``part_flag``, ``part_multi`` ([n, 2])."""
    import io
    import os

    from ..pipeline.chunking import _GzipWriter

    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    names = list(haplotypes["Maternal"])
    gen = {h[0]: torch.cat([haplotypes[h][c] for c in names]) & 0xDF
           for h in ("Maternal", "Paternal")}
    lens = torch.tensor([haplotypes["Maternal"][c].numel() for c in names],
                        dtype=torch.int64, device=dev)
    gen["lens"] = lens
    gen["end"] = torch.cumsum(lens, 0)
    gen["start"] = gen["end"] - lens
    at = dict(zip(names, gen["start"].tolist()))
    gen["snp"] = torch.sort(torch.cat(
        [snps[c].to(dev).long() - 1 + at[c] for c in names if c in snps]
        or [torch.zeros(0, dtype=torch.int64, device=dev)])).values
    gen["dup"] = torch.tensor([(at[c] + a, at[c] + b) for c in names
                               for a, b in (repeats or {}).get(c, [])],
                              dtype=torch.int64, device=dev).reshape(-1, 2)
    gen["pal"] = torch.tensor([at[c] + a for c in names
                               for a in (palindromes or {}).get(c, [])],
                              dtype=torch.int64, device=dev)
    iv = [(a, a + REPEAT_LEN) for a in gen["dup"].flatten().tolist()] + [
        (a, a + 2 * PALINDROME_HALF) for a in gen["pal"].tolist()]
    iv.sort()
    gen["planted"] = (
        torch.tensor([a for a, _ in iv], dtype=torch.int64, device=dev),
        torch.cummax(torch.tensor([b for _, b in iv] or [0],
                                  dtype=torch.int64, device=dev), 0)
        .values[:len(iv)])
    first_n = {h: int(torch.argmax((gen[h] == ord("N")).to(torch.uint8)))
               for h in "MP"}
    os.makedirs(out_dir, exist_ok=True)
    paths, truth = [], {}
    L = read_len
    for mate in (1, 2):
        path = os.path.join(out_dir, f"{cell}_{mate}.fastq.gz")
        w = _GzipWriter(path)
        cols = {}
        for s in range(0, n_reads, FASTQ_BLOCK):
            n = min(FASTQ_BLOCK, n_reads - s)
            rows, kind, cand, parts, pcand, _ = _read_block(
                g, n, L, gen, all_n)
            qual = torch.randint(*FASTQ_QUAL, (n, L), generator=g,
                                 device=dev, dtype=torch.uint8)
            ln = torch.full((n,), L, dtype=torch.int64, device=dev)
            t = {"kind": kind, "parts": parts, "junctions": _junctions(rows)}
            p1, p2 = _part_rows(rows, parts)
            for h in "MP":
                hit, flag, multi = _planted_hits(gen[h], rows, ln, cand)
                an = kind == READ_KINDS.index("all_n")
                t[f"{h}.hit"] = torch.where(an, first_n[h], hit)
                t[f"{h}.flag"] = torch.where(an, 0, flag)
                t[f"{h}.multi"] = multi | an
                ph = [_planted_hits(gen[h], p, parts[:, i], pcand[:, i:i + 1])
                      for i, p in enumerate((p1, p2))]
                t[f"{h}.part_hit"] = torch.stack([x[0] for x in ph], 1)
                t[f"{h}.part_flag"] = torch.stack([x[1] for x in ph], 1)
                t[f"{h}.part_multi"] = torch.stack([x[2] for x in ph], 1)
            for k, v in t.items():
                cols.setdefault(k, []).append(_host(v))
            seq = _host(rows).ravel()
            ids = np.arange(s + 1, s + n + 1, dtype=np.int64)
            off = np.arange(n, dtype=np.int64) * L
            lnh = np.full(n, L, np.int64)
            buf = io.BytesIO()
            _format_rows([[("const", b"@" + FASTQ_RUN), ("int", ids),
                           ("const", b" "), ("int", ids),
                           ("const", b" length=%d\n" % L),
                           ("text", seq, off, lnh), ("const", b"\n+\n"),
                           ("text", _host(qual).ravel(), off, lnh)]], n, buf)
            w.write(buf.getvalue())
        w.close()
        paths.append(path)
        truth[mate] = {k: np.concatenate(v) for k, v in cols.items()}
    return dict(fastq=paths, names=names, starts=_host(gen["start"]),
                first_n=first_n, truth=truth)
