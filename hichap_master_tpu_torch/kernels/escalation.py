"""K3 — the HICCUPS escalation ladder over a batch of chromosomes.

Replaces the Pallas kernel ``_ladder_kernel`` driven by ``escalation_pallas``
(``hichap_master_tpu/kernels/pallas_escalation.py``), vmapped over a size
bucket in ``hichap_master_tpu/models/loops.py``, together with the
anti-diagonal prefix maps it reads.  A call is three steps:

1. ``prefix_maps``: the raw, balanced and expected maps' anti-diagonal
   prefix ``W [3, C, E, Xp]``, bit for bit ``ops.loops_packed.
   anti_diagonal_prefix`` (two CUDA kernels: the column prefix in the
   blocked order, then the diagonal pass in place);
2. ``ladder``: per candidate cell the first level t whose lower-left raw
   count is >= 16 and the four backgrounds at t, a per-chromosome histogram
   of t over distinct cells and the number of candidate cells;
3. ``resolve_pixels``: the stop level (<10% of the remaining cells resolve
   at a level) from the histogram, then ``resolved = t <= stop level`` and
   the backgrounds gathered at the pixels.

The semantics are those of the map-space ladder ``ops.loops_packed.
escalation_packed_maps_batch``, the whole call's plain PyTorch version.

CUDA source: ``csrc/escalation.cu`` (see its note).
"""

from __future__ import annotations

import torch

from ..ops.loops_packed import (anti_diagonal_prefix, donut_map,
                                escalation_packed_maps_batch, lowerleft_map,
                                pixel_cells)
from . import _build

UNRESOLVED = 127  # level sentinel; the ladder must have fewer levels
MAX_ROWS = 4096   # the prefix kernel's blocked scan holds 256 block totals

escalation_plain = escalation_packed_maps_batch


def _check_maps(D_raw, D_bal, D_exp):
    if D_raw.dim() != 3 or D_bal.shape != D_raw.shape \
            or D_exp.shape != D_raw.shape:
        raise ValueError("D_raw, D_bal, D_exp must be [C, E, Xp] alike")
    if D_raw.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no escalation kernel for device {D_raw.device}")
    for t in (D_bal, D_exp):
        if t.device != D_raw.device:
            raise ValueError("all inputs must be on one device")


# ----------------------------------------------------------- prefix maps
def prefix_maps_plain(D_raw, D_bal, D_exp):
    """Plain PyTorch version of the prefix kernels."""
    return anti_diagonal_prefix(
        torch.stack([D_raw, D_bal, D_exp]).to(torch.float32))


def prefix_maps(D_raw, D_bal, D_exp):
    """Anti-diagonal prefix maps ``W [3, C, E, Xp]`` (float32) of the raw,
    balanced and expected ``[C, E, Xp]`` maps.  CPU tensors take the plain
    version; CUDA tensors launch the two prefix kernels (read the maps in
    place when they are contiguous float32) or raise."""
    _check_maps(D_raw, D_bal, D_exp)
    if D_raw.device.type == "cpu":
        return prefix_maps_plain(D_raw, D_bal, D_exp)
    C, E, Xp = D_raw.shape
    if E > MAX_ROWS:
        raise ValueError(f"prefix maps of {E} rows; the kernel takes "
                         f"{MAX_ROWS} at most")
    D = [d.to(torch.float32).contiguous() for d in (D_raw, D_bal, D_exp)]
    W = torch.empty(3, C, E, Xp, dtype=torch.float32, device=D_raw.device)
    lib = _build.load()
    _build.check(lib.escalation_prefix(
        D[0].data_ptr(), D[1].data_ptr(), D[2].data_ptr(), W.data_ptr(), C,
        E, Xp, _build.stream_ptr(D_raw.device)), "escalation_prefix")
    prefix_maps.launches += 1
    return W


prefix_maps.launches = 0


# ---------------------------------------------------------------- ladder
def ladder_plain(W, pixmask, ww: int, maxww: int, pw: int):
    """Plain PyTorch version of the ladder kernel, from the map functions:
    per cell the first level whose lower-left raw count is >= 16 (127 if
    none; uint8), the four backgrounds at that level, the per-chromosome
    histogram of levels over candidate cells and the candidate count."""
    C = W.shape[1]
    n_levels = maxww - ww + 1
    cand = pixmask.bool()
    t = torch.full(pixmask.shape, UNRESOLVED, dtype=torch.uint8,
                   device=W.device)
    a = [torch.zeros(pixmask.shape, device=W.device) for _ in range(4)]
    hist = torch.zeros(C, n_levels, dtype=torch.int32, device=W.device)
    for li in range(n_levels):
        w = ww + li
        newly = (cand & (t == UNRESOLVED)
                 & (lowerleft_map(W[0], w, pw) >= 16))
        t = torch.where(newly, li, t)
        for k, v in enumerate((donut_map(W[1], w, pw),
                               donut_map(W[2], w, pw),
                               lowerleft_map(W[1], w, pw),
                               lowerleft_map(W[2], w, pw))):
            a[k] = torch.where(newly, v, a[k])
        hist[:, li] = newly.sum((1, 2))
    return t, a, hist, cand.sum((1, 2)).to(torch.int32)


def ladder(W, pixmask, ww: int, maxww: int, pw: int):
    """The ladder over prefix maps ``W [3, C, E, Xp]`` and the candidate
    mask ``pixmask [C, E, Xp]`` (uint8).  Returns ``(t [C, E, Xp] uint8,
    [bS_K, bE_K, bS_Y, bE_Y] [C, E, Xp], hist [C, levels], total [C])``;
    the kernel writes t and the backgrounds at candidate cells only (other
    cells are unspecified).  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    n_levels = maxww - ww + 1
    if not 0 < n_levels < UNRESOLVED:
        # the last level index must stay below the sentinel
        raise ValueError(f"ladder of {n_levels} levels; need 1..126")
    if W.dim() != 4 or W.shape[0] != 3 or tuple(pixmask.shape) != \
            tuple(W.shape[1:]):
        raise ValueError("W must be [3, C, E, Xp] and pixmask [C, E, Xp]")
    if W.device.type == "cpu":
        return ladder_plain(W, pixmask, ww, maxww, pw)
    if W.device.type != "cuda" or pixmask.device != W.device:
        raise RuntimeError(f"no ladder kernel for {W.device} / "
                           f"{pixmask.device}")
    if W.dtype != torch.float32 or pixmask.dtype != torch.uint8:
        raise TypeError("W must be float32 and pixmask uint8")
    C, E, Xp = pixmask.shape
    W, pixmask = W.contiguous(), pixmask.contiguous()
    dev = W.device
    t_map = torch.empty(C, E, Xp, dtype=torch.uint8, device=dev)
    a = [torch.empty(C, E, Xp, dtype=torch.float32, device=dev)
         for _ in range(4)]
    hist = torch.zeros(C, n_levels, dtype=torch.int32, device=dev)
    total = torch.zeros(C, dtype=torch.int32, device=dev)
    lib = _build.load()
    _build.check(lib.escalation_ladder(
        W[0].data_ptr(), W[1].data_ptr(), W[2].data_ptr(),
        pixmask.data_ptr(), t_map.data_ptr(), a[0].data_ptr(),
        a[1].data_ptr(), a[2].data_ptr(), a[3].data_ptr(), hist.data_ptr(),
        total.data_ptr(), C, E, Xp, ww, maxww, pw, _build.stream_ptr(dev)),
        "escalation_ladder")
    ladder.launches += 1
    return t_map, a, hist, total


ladder.launches = 0


def stop_levels(hist: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """Last counted level per chromosome from the level histogram
    ``[C, L]`` and the candidate-cell count ``[C]``: levels run until the
    first one at which fewer than 10% of the remaining cells resolve
    (that level still counts)."""
    cnt = hist.double()
    before = torch.cumsum(cnt, 1) - cnt
    remaining = torch.clamp(total.double()[:, None] - before, min=1.0)
    low = (cnt / remaining) < 0.1
    # level l counts while no earlier level was low
    earlier_low = torch.cumsum(low.int(), 1) - low.int()
    return (earlier_low == 0).sum(1) - 1


def resolve_pixels(t_map, a, hist, total, cell, valid):
    """From the ladder's per-cell levels ``t_map [C, E, Xp]``, backgrounds
    ``a`` (4 x [C, E, Xp]), level histogram and candidate count to
    per-pixel outputs: a pixel is resolved when its cell's level is at or
    below its chromosome's stop level; backgrounds are 0 elsewhere, as in
    the plain ladder."""
    C = t_map.shape[0]
    sw = stop_levels(hist, total)

    def at_pixels(m):
        return torch.gather(m.reshape(C, -1), 1, cell)

    tv = at_pixels(t_map)
    resolved = valid & (tv != UNRESOLVED) & (tv <= sw[:, None])
    zero = torch.zeros((), dtype=torch.float32, device=t_map.device)
    return (resolved,) + tuple(torch.where(resolved, at_pixels(m), zero)
                               for m in a)


# ------------------------------------------------------------- the call
def escalation_batch(D_raw, D_bal, D_exp, e_pix, x_pix, valid, ww: int,
                     maxww: int, pw: int, B: int, e_lo: int, x_pad: int):
    """Escalation ladder for ``[C, E, Xp]`` packed maps and ``[C, P]``
    pixels; returns (resolved, bS_K, bE_K, bS_Y, bE_Y) per pixel, the
    backgrounds 0 at unresolved pixels.  CPU tensors take the plain
    version; CUDA tensors launch the prefix and ladder kernels or raise."""
    n_levels = maxww - ww + 1
    if not 0 < n_levels < UNRESOLVED:
        raise ValueError(f"ladder of {n_levels} levels; need 1..126")
    _check_maps(D_raw, D_bal, D_exp)
    C, E, Xp = D_raw.shape
    if e_pix.shape != x_pix.shape or e_pix.shape != valid.shape \
            or e_pix.dim() != 2 or e_pix.shape[0] != C:
        raise ValueError("e_pix, x_pix, valid must be [C, P]")
    if D_raw.device.type == "cpu":
        return escalation_plain(D_raw, D_bal, D_exp, e_pix, x_pix, valid,
                                ww, maxww, pw, B, e_lo, x_pad)
    for t in (e_pix, x_pix, valid):
        if t.device != D_raw.device:
            raise ValueError("all inputs must be on one device")

    cell, pixmask = pixel_cells(e_pix, x_pix, valid, e_lo, x_pad, E, Xp)
    W = prefix_maps(D_raw, D_bal, D_exp)
    t_map, a, hist, total = ladder(W, pixmask, ww, maxww, pw)
    return resolve_pixels(t_map, a, hist, total, cell, valid)


def escalation(D_raw, D_bal, D_exp, e_pix, x_pix, valid, *args):
    """``escalation_batch`` for one chromosome."""
    out = escalation_batch(D_raw[None], D_bal[None], D_exp[None],
                           e_pix[None], x_pix[None], valid[None], *args)
    return tuple(o[0] for o in out)
