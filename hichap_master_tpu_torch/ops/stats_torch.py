"""λ-chunked Poisson + BH-FDR and the compacted loop post-filter on tensors.

Counterpart of ``hichap_master_tpu/ops/stats_jax.py``: chunk assignment
against the 2^(k/3) edge grid, Poisson survival at the chunk's upper edge
(regularized lower incomplete gamma, ``torch.special.gammainc``), per-chunk
BH via one lexicographic sort and a segmented reverse running minimum, on
the tensors' device.  Values are float32 (the survival itself is evaluated
in float64 and rounded once).  Semantics match the float64 host path
``ops.stats.poisson_bh_chunked``; float32 can flip a q-value sitting exactly
at the significance edge, so ``HICHAP_HOST_STATS=1`` keeps the host path
(``models/loops``).
"""

from __future__ import annotations

import torch

# 2^(127/3) ~ 5.4e12, far above any expected count: a fixed edge grid
_MAXBIN = 128


def _edges(device) -> torch.Tensor:
    """[0, 2^(0/3), ..., 2^(127/3)] rounded once to float32."""
    return torch.cat([
        torch.zeros(1, dtype=torch.float64, device=device),
        torch.exp2(torch.arange(_MAXBIN, dtype=torch.float64,
                                device=device) / 3.0)]).float()


def _segmented_reverse_cummin(vals: torch.Tensor,
                              segs: torch.Tensor) -> torch.Tensor:
    """Running minimum from the end of each run of equal ``segs`` (input
    sorted by segment), as a log-depth doubling scan: after the step with
    offset 2^k every entry holds the min over the next 2^(k+1) entries of
    its own run."""
    v = vals.clone()
    n = v.shape[0]
    off = 1
    while off < n:
        same = segs[:-off] == segs[off:]
        v[:-off] = torch.where(same, torch.minimum(v[:-off], v[off:]),
                               v[:-off])
        off *= 2
    return v


def _lexsort(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """Permutation sorting by ``primary`` then ``secondary`` (stable in the
    original order among full ties), like ``lexsort((secondary, primary))``."""
    o1 = torch.sort(secondary, stable=True).indices
    o2 = torch.sort(primary[o1], stable=True).indices
    return o1[o2]


def _pv_seg(o, e, valid):
    """Poisson survival + λ-chunk per pixel; dead pixels get pv = 1 and
    segment -1."""
    o = o.to(torch.float32)
    e = e.to(torch.float32)
    edges = _edges(o.device)
    c = torch.searchsorted(edges, e, right=True) - 1
    ok = valid & (c >= 0) & (c < _MAXBIN)
    ok = ok & (e != edges[torch.clamp(c, 0, _MAXBIN)])
    rv = edges[torch.clamp(c, 0, _MAXBIN - 1) + 1]
    # the survival is evaluated in float64 and rounded once: a float32
    # incomplete gamma is only good to ~6e-5 relative
    sf = torch.special.gammainc(torch.floor(o).double() + 1.0, rv.double())
    pv = torch.where(ok, sf.float(), torch.ones_like(o))
    return pv, torch.where(ok, c, torch.full_like(c, -1))


def _bh_segmented(pv: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Per-segment BH q-values (segment -1 is dead and gets q = 1)."""
    order = _lexsort(seg, pv)
    ps = pv[order]
    ss = seg[order]
    # ss is sorted, so each run's bounds are binary searches of its value
    start = torch.searchsorted(ss, ss)
    seg_size = torch.searchsorted(ss, ss, right=True) - start
    rank = torch.arange(ps.shape[0], device=pv.device) - start + 1
    ranked = ps * seg_size.to(ps.dtype) / rank.to(ps.dtype)
    qs = torch.clamp(_segmented_reverse_cummin(ranked, ss), 0.0, 1.0)
    qs = torch.where(ss >= 0, qs, torch.ones_like(qs))
    out = torch.empty_like(ps)
    out[order] = qs
    return out


def poisson_bh_chunked(o, e, valid):
    """pv, qv for every pixel; invalid or unchunked pixels get 1.0."""
    pv, seg = _pv_seg(o, e, valid)
    return pv, _bh_segmented(pv, seg)


def poisson_bh_chunked_batch(o, e, valid):
    """``poisson_bh_chunked`` over a leading chromosome axis ``[G, P2]``:
    the chromosome folds into the segment key, and BH over disjoint
    segments equals the per-chromosome result exactly."""
    G, P2 = o.shape
    pv, seg = _pv_seg(o, e, valid)
    g = torch.arange(G, device=o.device)[:, None]
    segf = torch.where(seg >= 0, g * _MAXBIN + seg, -1).reshape(-1)
    qv = _bh_segmented(pv.reshape(-1), segf).reshape(G, P2)
    return pv, qv


def _post_prep(resolved, bek, bey, epad, xpad, vpad, o_map, pE, biases,
               gap_cs, ns, *, ww: int, e_off: int, x_off: int):
    """Per-pixel quantities ``[G, P2]`` for the post-filter: observed counts
    from the packed raw map, expected-by-distance, bias product, the shared
    flavor mask and the ±5-bin gap-neighborhood keep (bounds [p-5, p+5)
    clipped to [0, N-1))."""
    G = epad.shape[0]
    ep = epad.long()
    xp = xpad.long()
    Xp = o_map.shape[-1]
    o = torch.gather(o_map.reshape(G, -1), 1, (ep + e_off) * Xp + xp + x_off)
    em = torch.gather(pE, 1, torch.clamp(ep - ww, 0, pE.shape[1] - 1))
    yp = xp + ep
    bias_xy = torch.gather(biases, 1, xp) * torch.gather(biases, 1, yp)
    mask = vpad & resolved & (bek != 0) & (bey != 0)
    n = ns.long()[:, None]

    def has_gap(p):
        lo = torch.where(p > 5, p - 5, 0)
        hi = torch.where(p + 5 < n, p + 5, n - 1)
        return (torch.gather(gap_cs, 1, hi) - torch.gather(gap_cs, 1, lo)) > 0

    gk = ~(has_gap(xp) | has_gap(yp))
    return o, em, bias_xy, mask, gk


def _flavor_e(bs, be, em, bias_xy, mask):
    """Per-flavor expected value and validity (background ratio x biases)."""
    nz = be != 0
    brv = torch.where(nz, bs / torch.where(nz, be, torch.ones_like(be)),
                      torch.zeros_like(bs))
    e = em * brv * bias_xy
    return e, mask & (brv != 0) & (e > 0)


def _flavor_compact(qv, pv, val, gk, o, e, xpad, yp, sig, *, cap_out: int):
    """Survivor selection and fixed-size compaction for one flavor."""
    G, P2 = qv.shape
    surv = val & (qv <= sig) & gk
    ar = torch.arange(P2, dtype=torch.int32, device=qv.device)
    idx = torch.sort(torch.where(surv, ar, P2), dim=1).values[:, :cap_out]
    safe = torch.clamp(idx, 0, P2 - 1).long()
    fold = o / torch.where(e == 0, torch.ones_like(e), e)

    def take(a):
        return torch.gather(a, 1, safe)

    return (surv.sum(1), idx, take(xpad), take(yp), take(o), take(fold),
            take(pv), take(qv))


def loop_post_compact_batch(resolved, bsk, bek, bsy, bey, epad, xpad, vpad,
                            o_map, pE, biases, gap_cs, ns, sig, *, ww: int,
                            e_off: int, x_off: int, cap_out: int):
    """The loop post-escalation stage for a same-shape chromosome group,
    on device: background-ratio masks, expected scaling by balance biases,
    Poisson survival, per-chunk BH, q <= sig, ±5-bin gap-neighborhood
    removal.  Returns, per flavor (K, Y), only the compacted survivors:
    (count, idx, xi, yi, o, fold, p, q), each ``[G, cap_out]`` (count
    ``[G]``; a count above ``cap_out`` means the buffer overflowed).

    resolved..bey : [G, P2] escalation outputs
    epad/xpad/vpad: [G, P2] pixel coordinates and validity
    o_map         : [G, E, Xp] packed raw band map
    pE            : [G, num - ww] expected-by-distance curve
    biases        : [G, >= n + 1] per-bin balance biases (1/weights)
    gap_cs        : [G, >= n + 1] exclusive prefix count of gap bins
    ns            : [G] bin counts; sig : significance level
    """
    o, em, bias_xy, mask, gk = _post_prep(
        resolved, bek, bey, epad, xpad, vpad, o_map, pE, biases, gap_cs, ns,
        ww=ww, e_off=e_off, x_off=x_off)
    yp = (epad + xpad).to(torch.int32)
    xpad = xpad.to(torch.int32)

    def flavor(bs, be):
        e, val = _flavor_e(bs, be, em, bias_xy, mask)
        pv, qv = poisson_bh_chunked_batch(o, e, val)
        return _flavor_compact(qv, pv, val, gk, o, e, xpad, yp, sig,
                               cap_out=cap_out)

    return flavor(bsk, bek), flavor(bsy, bey)


def loop_post_compact(resolved, bsk, bek, bsy, bey, epad, xpad, vpad, o_map,
                      pE, biases, gap_cs, n, sig, **kw):
    """``loop_post_compact_batch`` for one chromosome (``[P2]`` inputs,
    ``[E, Xp]`` map, ``[n + 1]`` biases and gap prefix)."""
    outs = loop_post_compact_batch(
        resolved[None], bsk[None], bek[None], bsy[None], bey[None],
        epad[None], xpad[None], vpad[None], o_map[None], pE[None],
        biases[None], gap_cs[None], torch.as_tensor(n).reshape(1), sig, **kw)
    return tuple(tuple(a[0] for a in fl) for fl in outs)
