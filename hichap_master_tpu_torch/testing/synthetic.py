"""Synthetic hg19-scale inputs for the main path.

Counterparts of the generators in ``scripts/perf_sparse_gw.py`` (hg19
lengths, genome-wide tile coordinates and values) and
``scripts/perf_hg19.py`` (dense per-chromosome batches, loop-calling band
COO, and COO with planted TADs or A/B compartments), and the filtering
stage's chunk beds with their planted truth (``record_beds``).  The numpy
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
