"""Genomes and reads built for trouble, for K8 (``kernels.exact_index``)
and K9 (``kernels.exact_hits``): chromosomes shorter than ``k`` or exactly
``k``, empty ones, chromosome edges and N runs on the kernel's sub-tile
edges and in their halo, ``k`` from 4 to 13, a genome where one key holds
more than 20% of the windows (poly-A) and one where a 400-bp segment is
copied thousands of times; reads of ``k - 1``, ``k`` and ``k + 1`` bases,
reads ending at the genome's last byte, reads across two chromosomes,
lower-case reads, palindromes, reads whose every window falls in the
skewed bucket, reads whose disjoint windows all hold an N (the kernel then
looks at every offset) and reads with no window of ``ACGT`` (the scan);
600 contigs (more than the kernels stage in shared memory), and reads
longer than K9's staging room (compared against device memory), one of
them with no window of ``ACGT``.

``edge_cases(scale)`` gives ``(name, chroms, k, reads)``: ``chroms`` an
ordered {name: uint8 array} (upper-case genome bytes, N and a few other
letters), ``reads`` a list of uint8 arrays.  ``scale`` multiplies the
lengths of the random parts (1 for the CPU tests).  ``flat(chroms)`` lays
them one after the other as ``exact_index`` takes them; ``write_case``
writes a case as FakeAligner reads it."""

from __future__ import annotations

import os

import numpy as np

SUB_TILE = 8192    # K8's positions a sub-tile (exact_index_sub_tile(); the
                   # card checks it), where the tile-edge cases cut
LONG_READ = 99_329  # the reads of "long reads" are longer: above K9's
                    # staging room (kernels.exact_hits.hits_plan)

ACGT = np.frombuffer(b"ACGT", np.uint8)
COMP = np.arange(256, dtype=np.uint8)
COMP[list(b"ACGT")] = list(b"TGCA")


def rc(s: np.ndarray) -> np.ndarray:
    """The reverse complement (bytes outside ACGT kept)."""
    return COMP[s[::-1]]


def _bases(rng, n: int) -> np.ndarray:
    return ACGT[rng.integers(0, 4, n)]


def flat(chroms: dict):
    """(genome uint8 [G], start int64 [C], end int64 [C])."""
    lens = np.asarray([len(s) for s in chroms.values()], np.int64)
    end = np.cumsum(lens)
    g = (np.concatenate(list(chroms.values())) if len(lens)
         else np.zeros(0, np.uint8))
    return g, end - lens, end


def _reads(rng, chroms: dict, k: int, extra=()) -> list:
    """Reads of k - 1, k, k + 1, 40 and 150 bases from the chromosomes
    (half reverse-complemented), the last bytes of the genome, reads
    across two chromosomes, lower-case reads, random reads, a read with an
    N every 8 bases, and ``extra``."""
    names = [c for c, s in chroms.items() if len(s)]
    out = []
    for L in (k - 1, k, k + 1, 40, 150):
        for _ in range(4):
            s = chroms[names[rng.integers(len(names))]]
            if len(s) < L:
                continue
            a = int(rng.integers(0, len(s) - L + 1))
            r = s[a:a + L].copy()
            out.append(rc(r) if rng.random() < 0.5 else r)
    last = chroms[names[-1]]
    for L in (k - 1, k, k + 1, 40):
        if len(last) >= L:
            out += [last[-L:].copy(), rc(last[-L:])]
    for a, b in zip(names, names[1:]):
        x, y = chroms[a], chroms[b]
        if len(x) >= 7 and len(y) >= 9:
            out.append(np.concatenate([x[-7:], y[:9]]))
    s = chroms[names[0]]
    if len(s) >= 30:
        low = s[:30].copy()
        low[11] |= 0x20
        out += [low, s[:30] | 0x20]
    out += [_bases(rng, 150), _bases(rng, k + 1)]
    if len(s) >= 60:
        n8 = s[:60].copy()
        n8[3::8] = ord("N")
        out.append(n8)
    out += [np.asarray(x, np.uint8) for x in extra]
    return out


def _all_n_windows(k: int) -> np.ndarray:
    """3k + 1 bases whose windows at 0, k, 2k and 2k + 1 (the kernel's
    bounded seed set) each hold an N, with one window of ACGT at 1."""
    r = np.frombuffer(b"ACGT" * k, np.uint8)[:3 * k + 1].copy()
    r[[0, k + 1, 2 * k + 1]] = ord("N")
    return r


def _tile_edges(rng, k: int, scale: int):
    """Chromosome edges at sub-tile edges and a few bytes on either side,
    N runs across and just inside them (in the k - 1 bytes of halo)."""
    T = SUB_TILE
    cuts = [T - k, 2 * T - 1, 3 * T, 4 * T + 1, 5 * T + k - 1, 6 * T + k,
            7 * T - 7]
    cuts = sorted(set(c + (i // 7) * 7 * T for i, c in enumerate(
        cuts * scale)))
    g = _bases(rng, cuts[-1] + T + 5)
    for m in range(1, len(g) // T):
        d = int(rng.integers(-k, k + 1))
        w = int(rng.integers(1, 2 * k))
        g[max(m * T + d - w // 2, 0):m * T + d + w - w // 2] = ord("N")
    g[T * 2 + 3] = ord("R")
    planted = _all_n_windows(k)
    g[T // 2:T // 2 + len(planted)] = planted
    at = [0] + cuts + [len(g)]
    chroms = {f"t{i}": g[a:b] for i, (a, b) in enumerate(zip(at, at[1:]))}
    return chroms, [planted]


def _short_chroms(rng, scale):
    k = 6
    body = _bases(rng, 3000 * scale)
    pal = _bases(rng, 10)
    pal = np.concatenate([pal, rc(pal)])
    body[500:520] = pal
    chroms = {"a": _bases(rng, k - 1), "b": _bases(rng, k), "e": body[:0],
              "c": _bases(rng, k + 1), "d": _bases(rng, 1), "f": body,
              "g": _bases(rng, k)}
    return [("short chromosomes", chroms, k,
             _reads(rng, chroms, k, [pal, chroms["b"], chroms["g"]]))]


def _tile_cases(rng, scale):
    out = []
    for k in (13, 9):
        chroms, extra = _tile_edges(rng, k, scale)
        out.append((f"tile edges, k {k}", chroms, k,
                    _reads(rng, chroms, k, extra)))
    return out


def _k_range(rng, scale):
    g = _bases(rng, 20_000 * scale)
    for a in rng.integers(0, len(g) - 50, 12):
        g[a:a + int(rng.integers(1, 40))] = ord("N")
    third = len(g) // 3
    chroms = {"x": g[:third], "y": g[third:2 * third], "z": g[2 * third:]}
    return [(f"k {k}", chroms, k, _reads(rng, chroms, k,
                                         [_all_n_windows(k)]))
            for k in range(4, 14)]


def _poly_a(rng, scale):
    """One key (A x k) holds more than 20% of the windows."""
    k = 10
    n = 10_000 * scale
    chroms = {"p": np.concatenate([_bases(rng, n), np.full(
        n // 2, ord("A"), np.uint8), _bases(rng, n // 4), np.full(
        n // 4, ord("A"), np.uint8)]), "q": _bases(rng, n // 2)}
    return [("poly-A", chroms, k, _reads(rng, chroms, k, [
        np.full(30, ord("A"), np.uint8), np.full(k + 1, ord("A"), np.uint8),
        np.full(k - 1, ord("T"), np.uint8)]))]


def _repeat(rng, scale):
    """A 400-bp segment copied 2,000 x scale times, 0-29 random bases
    between the copies."""
    k = 12
    seg = _bases(rng, 400)
    n = 2_000 * scale
    copies = np.concatenate([np.tile(seg, (n, 1)), ACGT[rng.integers(
        0, 4, (n, 29))]], 1)
    r = copies[np.arange(429) < 400 + rng.integers(0, 30, n)[:, None]]
    chroms = {"r": r, "s": _bases(rng, 5_000 * scale)}
    return [("repeat 400 x 2,000", chroms, k, _reads(
        rng, chroms, k, [seg[100:250], rc(seg[:150]), seg[7:7 + k]]))]


def _contigs(rng, scale):
    """600 contigs of 1-300 bases (some shorter than k), more than the
    kernels stage in shared memory (256), one ending on a sub-tile edge,
    N runs in some."""
    k = 11
    lens = rng.integers(1, 301, 600 * scale)
    lens[:5] = (k - 1, k, k + 1, 1, 2)
    cum = np.cumsum(lens)
    j = int(np.searchsorted(cum, 4 * SUB_TILE))
    lens[j] += 4 * SUB_TILE - cum[j]          # contig j ends on the edge
    chroms = {}
    for i, n in enumerate(lens.tolist()):
        s = _bases(rng, n)
        if n > 40 and i % 7 == 0:
            a = int(rng.integers(0, n - 20))
            s[a:a + int(rng.integers(1, 20))] = ord("N")
        chroms[f"ctg{i}"] = s
    return [("600 contigs", chroms, k, _reads(rng, chroms, k))]


def _long_reads(rng, scale):
    """Reads longer than LONG_READ: a forward and a reverse-complement
    occurrence, one with its last byte changed, one with a lower-case
    byte, one across the two chromosomes and one with an N every 8 bases
    (no window of ACGT: the scan), which occurs."""
    k = 13
    n = 130_000 * scale
    u, v = _bases(rng, n), _bases(rng, n)
    v[20_000:20_000 + LONG_READ + 7][3::8] = ord("N")
    chroms = {"u": u, "v": v}
    L = LONG_READ + 11
    fwd = u[5_000:5_000 + L].copy()
    changed = fwd.copy()
    changed[-1] = ACGT[(np.searchsorted(ACGT, changed[-1]) + 1) % 4]
    low = fwd.copy()
    low[L // 2] |= 0x20
    extra = [fwd, rc(u[1_000:1_000 + L + 200]), changed, low,
             np.concatenate([u[-L // 2:], v[:L // 2]]),
             v[20_000:20_000 + LONG_READ + 7].copy()]
    return [("long reads", chroms, k, _reads(rng, chroms, k, extra))]


BUILDERS = (_short_chroms, _tile_cases, _k_range, _poly_a, _repeat,
            _contigs, _long_reads)


def edge_cases(scale: int = 1, seed: int = 31) -> list:
    """The edge genomes and their reads (see the module's docstring)."""
    cases = []
    for i, build in enumerate(BUILDERS):
        cases += build(np.random.default_rng([seed, i]), scale)
    return cases


def skewed_cases(poly_a_scale: int, repeat_scale: int,
                 seed: int = 31) -> list:
    """The poly-A and repeated-segment cases alone, each at its scale."""
    return (_poly_a(np.random.default_rng([seed, 3]), poly_a_scale)
            + _repeat(np.random.default_rng([seed, 4]), repeat_scale))



def write_case(out_dir: str, chroms: dict, reads: list) -> tuple:
    """The case as FakeAligner reads it: ``g.fa`` (a chromosome a record,
    one line) and ``r.fastq`` (the non-empty reads, quality I).  Returns
    the two paths."""
    fa, fq = os.path.join(out_dir, "g.fa"), os.path.join(out_dir, "r.fastq")
    with open(fa, "wb") as f:
        for c, s in chroms.items():
            f.write(b">" + c.encode() + b"\n" + s.tobytes() + b"\n")
    with open(fq, "wb") as f:
        for i, r in enumerate(r for r in reads if len(r)):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, r.tobytes(), b"I" * len(r)))
    return fa, fq
