"""Synthetic hg19-scale inputs for the main path.

Counterparts of the generators in ``scripts/perf_sparse_gw.py`` (hg19
lengths, genome-wide tile coordinates and values) and
``scripts/perf_hg19.py`` (dense per-chromosome batches, loop-calling band
COO, and COO with planted TADs or A/B compartments).  The numpy
generators take a seeded ``numpy.random.Generator``; the tensor generators
draw on the target device from a seeded
``torch.Generator``, so no hg19-scale array crosses the host link.
"""

from __future__ import annotations

import numpy as np
import torch

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
_BED_CHUNK = 1 << 20   # rows formatted at a time
_TAGS = (b"Both", b"R1", b"R2")


def _table(words) -> tuple:
    """([K, W] uint8 bytes, [K] lengths) of byte strings."""
    out = np.zeros((len(words), max([len(w) for w in words] + [1])),
                   np.uint8)
    for i, w in enumerate(words):
        out[i, :len(w)] = np.frombuffer(w, np.uint8)
    return out, np.asarray([len(w) for w in words], np.int64)


def _part(part, s: int, e: int) -> tuple:
    """(bytes [rows, W], kept [rows, W]) of one part of a field for rows
    s..e: ``("word", table, lengths, index)``, ``("int", values)`` (non-
    negative decimal) or ``("const", bytes)``."""
    if part[0] == "word":
        _, tab, lens, idx = part
        i = np.asarray(idx[s:e], np.int64)
        return tab[i], np.arange(tab.shape[1]) < lens[i][:, None]
    if part[0] == "int":
        v = np.asarray(part[1][s:e], np.int64)
        if v.size and int(v.min()) < 0:
            raise ValueError("bed positions must be non-negative")
        W = len(str(int(v.max()))) if v.size else 1
        d = v[:, None] // 10 ** np.arange(W - 1, -1, -1, dtype=np.int64) % 10
        width = np.where(v == 0, 1, W - np.argmax(d != 0, axis=1))
        return ((d + ord("0")).astype(np.uint8),
                np.arange(W) >= (W - width)[:, None])
    c = np.frombuffer(part[1], np.uint8)
    return (np.broadcast_to(c, (e - s, c.size)),
            np.ones((e - s, c.size), bool))


def _format_rows(fields, n: int, f) -> None:
    """Write ``n`` lines of tab-separated ``fields`` (each a list of parts,
    see ``_part``, written one after the other) to the binary file ``f``,
    a chunk of rows at a time, with no Python loop per row."""
    for s in range(0, n, _BED_CHUNK):
        e = min(n, s + _BED_CHUNK)
        blocks, keeps = [], []
        for k, parts in enumerate(fields):
            for part in parts:
                b, m = _part(part, s, e)
                blocks.append(b)
                keeps.append(m)
            blocks.append(np.full((e - s, 1), 10 if k == len(fields) - 1
                                  else 9, np.uint8))
            keeps.append(np.ones((e - s, 1), bool))
        f.write(np.concatenate(blocks, 1)[np.concatenate(keeps, 1)]
                .tobytes())


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
    tags = _table(list(_TAGS))
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
