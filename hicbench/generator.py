"""Seeded Hi-C pairs drawn on the device from a published contact law.

Every pair is a locus pair of the genome drawn at a rate per locus pair
that depends only on where its two loci lie:

* on one chromosome, ``s`` apart: ``s ** -decay`` from ``min_distance``
  up to ``plateau``, and flat at ``plateau ** -decay`` beyond it: the
  power law of Lieberman-Aiden et al. 2009 (Science 326:289, Fig. 4A,
  ``P(s) ~ s^-1.08``) and its plateau past ~90 Mb (Fig. 1F);
* on two chromosomes: the plateau's rate, the highest that Fig. 1F allows
  ("interchromosomal interactions are depleted relative to
  intrachromosomal interactions").

So the share of pairs that join two chromosomes is not a free number: it
follows from the law and the chromosomes' lengths (``trans_share``).
Closer pairs than ``min_distance`` are what a pipeline's filters drop.

A pair is drawn exactly: a chromosome by its weight, the first mate
uniform, the distance from the law, and a pair that would leave the
chromosome is drawn again (a draw again is a fixed function of the seed,
so the same seed gives the same pairs).  Mates come in either order.
Allelic classes each get their own draw, in the order of ``counts``.
M_M and P_P also carry tags, both-side (0), R1 (1) or R2 (2), in the
shares ``tags`` gives (``TAGS``, 40/30/30, where a configuration states
none).  M_P and P_M pairs join loci of the two homologs: under
``homolog="cis"`` they are drawn as any other class, by the law above;
under ``"trans"`` as two loci on separate molecules, which is what the
homologs are: each chromosome by its length, independently (the same
label allowed), each position uniform, the rule the law already applies
between chromosomes.
"""

from __future__ import annotations

import torch

CLASSES = ("Bi_Allelic", "M_M", "P_P", "M_P", "P_M")
TAGGED = ("M_M", "P_P")
HOMOLOG = ("M_P", "P_M")
# the shares of M_M and P_P pairs tagged both-side, R1 and R2 where a
# configuration states none
TAGS = {"both": 0.4, "r1": 0.3, "r2": 0.3}
HOMOLOG_LAWS = ("cis", "trans")


def _check_allelic(tags: dict, homolog: str) -> None:
    """Raise ``ValueError`` unless ``tags`` gives the shares ``both``,
    ``r1`` and ``r2``, none negative, summing to 1 (to 1e-9), and
    ``homolog`` is one of ``HOMOLOG_LAWS``."""
    if not isinstance(tags, dict) or set(tags) != set(TAGS):
        raise ValueError(f"tags must give the shares {sorted(TAGS)}, "
                         f"not {tags!r}")
    shares = [float(tags[k]) for k in TAGS]
    if min(shares) < 0 or abs(sum(shares) - 1) > 1e-9:
        raise ValueError(f"tags must be shares, none negative, that sum "
                         f"to 1: {tags!r}")
    if homolog not in HOMOLOG_LAWS:
        raise ValueError(f"homolog must be one of {HOMOLOG_LAWS}, not "
                         f"{homolog!r}")


def _law(law: dict) -> tuple:
    return (float(law["decay"]), float(law["min_distance"]),
            float(law["plateau"]))


def _below(L: float, a: float, s0: float, P: float) -> float:
    """The rate integrated over distances in [s0, min(L, P)]."""
    m = min(L, P)
    return 0.0 if m <= s0 else (m ** (1 - a) - s0 ** (1 - a)) / (1 - a)


def intra_mass(L: float, law: dict) -> float:
    """The rate summed over the locus pairs of a chromosome of ``L`` bp
    (``s ** -a`` times the ``L - s`` pairs at each distance)."""
    a, s0, P = _law(law)
    m = min(L, P)
    mass = 0.0
    if m > s0:
        mass += (L * _below(L, a, s0, P)
                 - (m ** (2 - a) - s0 ** (2 - a)) / (2 - a))
    if L > P:
        mass += P ** -a * (L - P) ** 2 / 2
    return mass


def trans_share(lengths, law: dict) -> float:
    """The share of pairs that join two chromosomes under ``law``."""
    a, _, P = _law(law)
    tot = float(sum(lengths))
    trans = P ** -a * (tot * tot - sum(float(L) ** 2 for L in lengths)) / 2
    intra = sum(intra_mass(float(L), law) for L in lengths)
    return trans / (trans + intra)


def allelic_pairs(lengths, counts, seed: int, *, device, law: dict,
                  tags: dict | None = None, homolog: str = "cis") -> dict:
    """``{class: (c1 int32, p1 int64, c2 int32, p2 int64[, tag int8])}``
    drawn on ``device`` from ``seed``; ``counts`` gives the pairs of each
    class, drawn in the order of its keys; ``tags`` the shares of M_M and
    P_P tagged both-side, R1 and R2 (``TAGS`` when None); ``homolog`` the
    law of M_P and P_M pairs.  With neither given the draw is the one the
    generator was frozen with."""
    tags = TAGS if tags is None else tags
    _check_allelic(tags, homolog)
    # a tag is 0 below the first cut, 1 below the second, 2 above it
    cut1 = float(tags["both"])
    cut2 = 1.0 - float(tags["r2"])
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    a, s0, P = _law(law)
    sizes = torch.as_tensor(lengths, dtype=torch.float64, device=device)
    last = sizes.numel() - 1
    by_length = torch.cumsum(sizes, 0) / sizes.sum()
    # a candidate (chromosome, first mate, distance) is uniform over the
    # locus pairs at the law's rate when the chromosome is drawn by its
    # length times the rate summed over its distances
    below = torch.as_tensor([_below(float(L), a, s0, P) for L in lengths],
                            dtype=torch.float64, device=device)
    beyond = P ** -a * (sizes - P).clamp_min(0)
    w = sizes * (below + beyond)
    by_mass = torch.cumsum(w, 0) / w.sum()
    t = trans_share(lengths, law)

    def uniform(n):
        return torch.rand(n, generator=g, dtype=torch.float64, device=device)

    def chrom(n, cum):
        return torch.searchsorted(cum, uniform(n), right=True).clamp_max(last)

    def intra(n):
        c = torch.empty(n, dtype=torch.int64, device=device)
        p1 = torch.empty_like(c)
        p2 = torch.empty_like(c)
        todo = torch.arange(n, device=device)
        while todo.numel():
            k = todo.numel()
            cc = chrom(k, by_mass)
            L, G1 = sizes[cc], below[cc]
            x = uniform(k) * (G1 + beyond[cc])
            pw = (s0 ** (1 - a) + (1 - a) * torch.minimum(x, G1)).clamp_min(
                1e-300)
            s = torch.where(x < G1, pw ** (1 / (1 - a)),
                            P + (x - G1) * P ** a).floor().long()
            q1 = (uniform(k) * L).long()
            q2 = q1 + s
            ok = q2 < L.long()
            idx = todo[ok]
            c[idx], p1[idx], p2[idx] = cc[ok], q1[ok], q2[ok]
            todo = todo[~ok]
        swap = uniform(n) < 0.5
        return c, torch.where(swap, p2, p1), c, torch.where(swap, p1, p2)

    def homologs(n):
        # two molecules: each locus anywhere on its genome copy
        c1, c2 = chrom(n, by_length), chrom(n, by_length)
        return (c1, (uniform(n) * sizes[c1]).long(),
                c2, (uniform(n) * sizes[c2]).long())

    def trans(n):
        c1 = torch.empty(n, dtype=torch.int64, device=device)
        c2 = torch.empty_like(c1)
        todo = torch.arange(n, device=device)
        while todo.numel():
            k = todo.numel()
            x1, x2 = chrom(k, by_length), chrom(k, by_length)
            ok = x1 != x2
            idx = todo[ok]
            c1[idx], c2[idx] = x1[ok], x2[ok]
            todo = todo[~ok]
        return (c1, (uniform(n) * sizes[c1]).long(),
                c2, (uniform(n) * sizes[c2]).long())

    out = {}
    for cls, n in counts.items():
        if homolog == "trans" and cls in HOMOLOG:
            cols = list(homologs(n))
        else:
            far = uniform(n) < t
            cols = [torch.empty(n, dtype=torch.int64, device=device)
                    for _ in range(4)]
            for sel, part in ((~far, intra(int((~far).sum()))),
                              (far, trans(int(far.sum())))):
                for col, x in zip(cols, part):
                    col[sel] = x
        cols = (cols[0].to(torch.int32), cols[1], cols[2].to(torch.int32),
                cols[3])
        if cls in TAGGED:
            u = uniform(n)
            cols += ((u >= cut1).to(torch.int8)
                     + (u >= cut2).to(torch.int8),)
        out[cls] = cols
    return out


def pooled(classes: dict) -> tuple:
    """The valid pairs of every class in one ``(c1, p1, c2, p2)``, classes
    in the order of ``classes``."""
    return tuple(torch.cat([v[i] for v in classes.values()])
                 for i in range(4))
