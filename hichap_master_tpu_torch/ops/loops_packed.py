"""Packed-band loop stencils: donut/lower-left sums in O(band) memory.

Counterpart of ``hichap_master_tpu/ops/loops_packed.py``.  Everything works
in the packed layout ``D[e, x] = M[x, x + e]`` (logical (e, x) stored at
``[e + e_lo, x + x_pad]``).  With ``R`` the prefix of D over e and the
anti-diagonal prefix ``W[e, x] = sum_{k >= 0} R[e - k, x + k]``, every
rectangle of the contact matrix is four statically shifted reads of W
(``rect_map``), so the whole HICCUPS escalation ladder is a few hundred
shifted adds over ``[E, Xp]`` maps.

Functions take a leading chromosome axis ``[C, ...]`` (the ``_batch``
names); the unbatched names run a batch of one.  ``escalation_packed_maps``
and its batch form are the plain PyTorch version of K3
(``kernels/escalation.py``); ``escalation_packed`` and its batch form are
the JAX package's entry points of the ladder with its arguments, and run
K3 (the kernels on CUDA tensors, the plain version on CPU tensors).

Arithmetic order follows the JAX package's CPU programs step for step
(including the base-16 blocked prefix XLA uses for ``cumsum``), so on the
same float32 inputs the maps agree bit for bit and loop calls match the
reference exactly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_SCAN_BASE = 16  # block length of the blocked prefix over e


def pack_margins(maxww: int):
    """(e_lo, e_hi, x_pad): margins that keep every shifted read of the
    ladder inside the packed map."""
    e_lo = 2 * maxww + 2
    e_hi = 2 * maxww + 2
    x_pad = maxww + 2
    return e_lo, e_hi, x_pad


def _scatter_add(C: int, E: int, Xp: int, er, xr, vals) -> torch.Tensor:
    """``zeros([C, E, Xp]).at[c, er, xr].add(vals)`` for [C, P] indices."""
    flat = (er.long() * Xp + xr.long()
            + torch.arange(C, device=er.device)[:, None] * (E * Xp))
    out = torch.zeros(C * E * Xp, dtype=torch.float32, device=er.device)
    out.index_add_(0, flat.reshape(-1), vals.reshape(-1))
    return out.reshape(C, E, Xp)


def pack_coo(rows, cols, vals, B: int, Xp: int, e_lo: int,
             x_pad: int) -> torch.Tensor:
    """Scatter upper-band COO into the packed layout ``[B + 2 e_lo, Xp]``;
    out-of-band entries (e < 0 or e >= B) add nothing."""
    rows = torch.as_tensor(rows).to(torch.int32)
    cols = torch.as_tensor(cols).to(torch.int32)
    vals = torch.as_tensor(vals).to(torch.float32)
    e = cols - rows
    ok = (e >= 0) & (e < B)
    er = torch.where(ok, e + e_lo, 0)
    xr = torch.where(ok, rows + x_pad, 0)
    v = torch.where(ok, vals, torch.zeros_like(vals))
    return _scatter_add(1, B + 2 * e_lo, Xp, er[None], xr[None], v[None])[0]


def pack_raw_bal_batch(row, d, bv, w, *, B: int, Xp: int, e_lo: int,
                       x_pad: int, ww: int):
    """Packed raw and balanced band maps ``[C, E, Xp]`` from the band COO.

    row, d, bv : [C, cap] bin, diagonal offset (>= 0) and raw value
    w          : [C, n] balance weights, NaN at filtered bins
    Raw keeps d > 0, balanced keeps d >= ww with values ``bv * w[x] *
    w[x + d]`` (NaN -> 0).
    """
    e = d.to(torch.int32)
    x = row.to(torch.int32)
    bv = bv.to(torch.float32)
    C = x.shape[0]
    ok = e < B
    er = torch.where(ok, e + e_lo, 0)
    xr = torch.where(ok, x + x_pad, 0)
    nmax = w.shape[-1] - 1
    wx = torch.gather(w, 1, torch.clamp(x, 0, nmax).long())
    wy = torch.gather(w, 1, torch.clamp(x + e, 0, nmax).long())
    wv = torch.nan_to_num(bv * wx * wy)
    zero = torch.zeros_like(bv)
    E = B + 2 * e_lo
    D_raw = _scatter_add(C, E, Xp, er, xr,
                         torch.where(ok & (e > 0), bv, zero))
    D_bal = _scatter_add(C, E, Xp, er, xr,
                         torch.where(ok & (e >= ww), wv, zero))
    return D_raw, D_bal


def pack_raw_bal(row, d, bv, w, **kw):
    D_raw, D_bal = pack_raw_bal_batch(row[None], d[None], bv[None], w[None],
                                      **kw)
    return D_raw[0], D_bal[0]


def _derive_pixels_core(row, d, keep, npix, *, ww: int, dmax: int,
                        P2: int):
    """One body for the masked and unmasked derivations: entries with d in
    [ww, dmax] (and ``keep``, when given) in COO order, padded to P2."""
    cap = row.shape[-1]
    e = d.to(torch.int32)
    sel = (e >= ww) & (e <= dmax)
    if keep is not None:
        sel = sel & keep.to(torch.bool)
    ar = torch.arange(cap, dtype=torch.int32, device=row.device)
    idx = torch.sort(torch.where(sel, ar, cap), dim=-1).values[:, :P2]
    safe = torch.clamp(idx, 0, cap - 1).long()
    vp = (torch.arange(P2, device=row.device)[None, :]
          < torch.as_tensor(npix, device=row.device)[:, None])
    zero = torch.zeros((), dtype=torch.int32, device=row.device)
    ep = torch.where(vp, torch.gather(e, 1, safe), zero)
    xp = torch.where(vp, torch.gather(row.to(torch.int32), 1, safe), zero)
    return ep, xp, vp


def derive_pixels_batch(row, d, npix, *, ww: int, dmax: int, P2: int):
    """Candidate pixels (epad, xpad, vpad) ``[C, P2]`` derived from the band
    COO: entries with d in [ww, dmax] in COO order, padded to P2."""
    return _derive_pixels_core(row, d, None, npix, ww=ww, dmax=dmax, P2=P2)


def derive_pixels(row, d, npix, **kw):
    ep, xp, vp = derive_pixels_batch(row[None], d[None],
                                     torch.as_tensor(npix).reshape(1), **kw)
    return ep[0], xp[0], vp[0]


def derive_pixels_masked_batch(row, d, keep, npix, *, ww: int, dmax: int,
                               P2: int):
    """``derive_pixels_batch`` with a keep mask ``[C, cap]`` over the band
    order (the allelic prefilter, ``models.loops._allelic_prefilter``)."""
    return _derive_pixels_core(row, d, keep, npix, ww=ww, dmax=dmax, P2=P2)


def derive_pixels_masked(row, d, keep, npix, **kw):
    ep, xp, vp = derive_pixels_masked_batch(
        row[None], d[None], keep[None], torch.as_tensor(npix).reshape(1),
        **kw)
    return ep[0], xp[0], vp[0]


def _prefix_rows(D: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix over dim -2 in float32, as a base-16 blocked scan:
    sequential within blocks of 16 rows, block totals prefixed the same way
    and added back (the order XLA's CPU ``cumsum`` uses)."""
    E = D.shape[-2]
    if E <= _SCAN_BASE:
        out = D.clone()
        for i in range(1, E):
            out[..., i, :] = out[..., i - 1, :] + D[..., i, :]
        return out
    nb = -(-E // _SCAN_BASE)
    Dp = F.pad(D, (0, 0, 0, nb * _SCAN_BASE - E))
    blocks = Dp.reshape(*D.shape[:-2], nb, _SCAN_BASE, D.shape[-1])
    inner = blocks.clone()
    for i in range(1, _SCAN_BASE):
        inner[..., i, :] = inner[..., i - 1, :] + blocks[..., i, :]
    incl = _prefix_rows(inner[..., _SCAN_BASE - 1, :])
    excl = F.pad(incl[..., :-1, :], (0, 0, 1, 0))
    out = inner + excl.unsqueeze(-2)
    return out.reshape(*D.shape[:-2], nb * _SCAN_BASE, D.shape[-1])[
        ..., :E, :]


def anti_diagonal_prefix(D: torch.Tensor) -> torch.Tensor:
    """``W[e, x] = R[e, x] + W[e - 1, x + 1]`` with R the prefix of D over
    e (zero beyond the last column); any leading dims."""
    R = _prefix_rows(D)
    W = torch.empty_like(R)
    W[..., 0, :] = R[..., 0, :]
    for e in range(1, R.shape[-2]):
        W[..., e, :-1] = R[..., e, :-1] + W[..., e - 1, 1:]
        W[..., e, -1] = R[..., e, -1]
    return W


def _shift2(W: torch.Tensor, de: int, dx: int) -> torch.Tensor:
    """``T[..., e, x] = W[..., e + de, x + dx]`` with zero fill."""
    E, X = W.shape[-2:]
    out = torch.zeros_like(W)
    es0, es1 = max(de, 0), min(E + de, E)
    xs0, xs1 = max(dx, 0), min(X + dx, X)
    if es0 >= es1 or xs0 >= xs1:
        return out
    out[..., es0 - de:es1 - de, xs0 - dx:xs1 - dx] = W[..., es0:es1,
                                                       xs0:xs1]
    return out


def rect_map(W: torch.Tensor, r0: int, r1: int, c0: int,
             c1: int) -> torch.Tensor:
    """Rectangle-sum map over the packed domain (same indexing as W)."""
    return (_shift2(W, c1 - r0, r0) - _shift2(W, c1 - r1 - 1, r1 + 1)
            - _shift2(W, c0 - 1 - r0, r0)
            + _shift2(W, c0 - 1 - r1 - 1, r1 + 1))


def donut_map(W: torch.Tensor, w: int, pw: int) -> torch.Tensor:
    return (rect_map(W, -w, w, -w, w)
            - rect_map(W, 0, 0, -w, w)
            - rect_map(W, -w, w, 0, 0)
            - rect_map(W, -pw, pw, -pw, pw)
            + rect_map(W, 0, 0, -pw, pw)
            + rect_map(W, -pw, pw, 0, 0))


def lowerleft_map(W: torch.Tensor, w: int, pw: int) -> torch.Tensor:
    return rect_map(W, 1, w, -w, -1) - rect_map(W, 1, pw, -pw, -1)


def pixel_cells(e_pix, x_pix, valid, e_lo: int, x_pad: int, E: int,
                Xp: int):
    """Flat cell index ``[C, P]`` of each pixel in its chromosome's map
    (invalid pixels point at the dead cell 0) and the candidate-cell mask
    ``[C, E, Xp]`` (uint8; duplicate pixels mark one cell)."""
    C = e_pix.shape[0]
    zero = torch.zeros((), dtype=torch.long, device=e_pix.device)
    er = torch.where(valid, e_pix.long() + e_lo, zero)
    xr = torch.where(valid, x_pix.long() + x_pad, zero)
    cell = er * Xp + xr
    mask = torch.zeros(C, E * Xp, dtype=torch.uint8, device=e_pix.device)
    # every writer of a cell writes the same value (invalid pixels write 0
    # at cell 0, which no valid pixel reaches: er >= e_lo > 0)
    mask.scatter_(1, cell, valid.to(torch.uint8))
    return cell, mask.reshape(C, E, Xp)


def escalation_packed_maps_batch(D_raw, D_bal, D_exp, e_pix, x_pix, valid,
                                 ww: int, maxww: int, pw: int, B: int,
                                 e_lo: int, x_pad: int):
    """Escalation ladder in map space over ``[C, E, Xp]`` maps.

    Per chromosome: a candidate cell resolves at the first window width
    w in [ww, maxww] whose lower-left raw count is >= 16; once fewer than
    10% of the remaining cells resolve at a level, later levels are
    abandoned.  Returns (resolved, bS_K, bE_K, bS_Y, bE_Y) per pixel
    ``[C, P]``: donut and lower-left backgrounds, balanced and expected, at
    the resolving level (0 where unresolved).
    """
    C, E, Xp = D_raw.shape
    cell, pixmask = pixel_cells(e_pix, x_pix, valid, e_lo, x_pad, E, Xp)
    W_raw, W_bal, W_exp = anti_diagonal_prefix(
        torch.stack([D_raw, D_bal, D_exp]).to(torch.float32)).unbind(0)

    remaining = pixmask.bool()
    stopped = torch.zeros(C, dtype=torch.bool, device=D_raw.device)
    resolved_map = torch.zeros_like(remaining)
    acc = [torch.zeros(C, E, Xp, device=D_raw.device) for _ in range(4)]
    for w in range(ww, maxww + 1):
        reads = lowerleft_map(W_raw, w, pw)
        newly = remaining & (reads >= 16) & ~stopped[:, None, None]
        ini = torch.clamp(torch.where(stopped, 0, remaining.sum((1, 2))),
                          min=1)
        ratio = newly.sum((1, 2)).double() / ini.double()
        remaining = remaining & ~newly
        stopped = stopped | (ratio < 0.1)
        resolved_map = resolved_map | newly
        for a_i, v in enumerate((donut_map(W_bal, w, pw),
                                 donut_map(W_exp, w, pw),
                                 lowerleft_map(W_bal, w, pw),
                                 lowerleft_map(W_exp, w, pw))):
            acc[a_i] = acc[a_i] + torch.where(newly, v, torch.zeros_like(v))

    def at_pixels(m):
        return torch.gather(m.reshape(C, E * Xp), 1, cell)

    resolved = at_pixels(resolved_map) & valid
    return (resolved,) + tuple(at_pixels(a) for a in acc)


def escalation_packed_maps(D_raw, D_bal, D_exp, e_pix, x_pix, valid,
                           *args):
    """``escalation_packed_maps_batch`` for one chromosome."""
    out = escalation_packed_maps_batch(D_raw[None], D_bal[None], D_exp[None],
                                       e_pix[None], x_pix[None], valid[None],
                                       *args)
    return tuple(o[0] for o in out)


def escalation_packed_batch(D_raw, D_bal, D_exp, e_pix, x_pix, valid,
                            ww: int, maxww: int, pw: int, B: int, e_lo: int,
                            x_pad: int):
    """The escalation ladder over ``[C, E, Xp]`` packed maps and ``[C, P]``
    candidate pixels, the stopping rule per chromosome: K3
    (``kernels.escalation.escalation_batch``).  Returns (resolved, bS_K,
    bE_K, bS_Y, bE_Y) per pixel."""
    from ..kernels.escalation import escalation_batch

    return escalation_batch(D_raw, D_bal, D_exp, e_pix, x_pix, valid, ww,
                            maxww, pw, B, e_lo, x_pad)


def escalation_packed(D_raw, D_bal, D_exp, e_pix, x_pix, valid, ww: int,
                      maxww: int, pw: int, B: int, e_lo: int, x_pad: int):
    """``escalation_packed_batch`` for one chromosome (``[E, Xp]`` maps,
    ``[P]`` pixels): K3 (``kernels.escalation.escalation``)."""
    from ..kernels.escalation import escalation

    return escalation(D_raw, D_bal, D_exp, e_pix, x_pix, valid, ww, maxww,
                      pw, B, e_lo, x_pad)
