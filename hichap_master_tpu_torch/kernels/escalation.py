"""K3 — the HICCUPS escalation ladder over a batch of chromosomes.

Replaces the Pallas kernel ``_ladder_kernel`` driven by ``escalation_pallas``
(``hichap_master_tpu/kernels/pallas_escalation.py``), vmapped over a size
bucket in ``hichap_master_tpu/models/loops.py``.  The lower-left raw read
count grows with the window width, so each candidate cell has a first
resolving level t; the kernel writes t and the four backgrounds at t, plus a
per-chromosome histogram of t over distinct cells.  The stop level (<10% of
the remaining cells resolve at a level) is a scan over that histogram, and
``resolved = t <= stop level``: the semantics of the map-space ladder
``ops.loops_packed.escalation_packed_maps_batch``, which is this kernel's
plain PyTorch version.

CUDA source: ``csrc/escalation.cu`` (one thread per map cell; see its note).
The anti-diagonal prefix maps are computed in PyTorch before the launch.
"""

from __future__ import annotations

import torch

from ..ops.loops_packed import (anti_diagonal_prefix,
                                escalation_packed_maps_batch, pixel_cells)
from . import _build

UNRESOLVED = 127  # level sentinel; the ladder must have fewer levels

escalation_plain = escalation_packed_maps_batch


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


def escalation_batch(D_raw, D_bal, D_exp, e_pix, x_pix, valid, ww: int,
                     maxww: int, pw: int, B: int, e_lo: int, x_pad: int):
    """Escalation ladder for ``[C, E, Xp]`` packed maps and ``[C, P]``
    pixels; returns (resolved, bS_K, bE_K, bS_Y, bE_Y) per pixel.  Values
    at unresolved pixels are unspecified.  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    n_levels = maxww - ww + 1
    if not 0 < n_levels < UNRESOLVED:
        # the last level index must stay below the sentinel
        raise ValueError(f"ladder of {n_levels} levels; need 1..126")
    if D_raw.dim() != 3 or D_bal.shape != D_raw.shape \
            or D_exp.shape != D_raw.shape:
        raise ValueError("D_raw, D_bal, D_exp must be [C, E, Xp] alike")
    C, E, Xp = D_raw.shape
    if e_pix.shape != x_pix.shape or e_pix.shape != valid.shape \
            or e_pix.dim() != 2 or e_pix.shape[0] != C:
        raise ValueError("e_pix, x_pix, valid must be [C, P]")
    if D_raw.device.type == "cpu":
        return escalation_plain(D_raw, D_bal, D_exp, e_pix, x_pix, valid,
                                ww, maxww, pw, B, e_lo, x_pad)
    if D_raw.device.type != "cuda":
        raise RuntimeError(f"no escalation kernel for device {D_raw.device}")
    for t in (D_bal, D_exp, e_pix, x_pix, valid):
        if t.device != D_raw.device:
            raise ValueError("all inputs must be on one device")

    cell, pixmask = pixel_cells(e_pix, x_pix, valid, e_lo, x_pad, E, Xp)
    W = anti_diagonal_prefix(
        torch.stack([D_raw, D_bal, D_exp]).to(torch.float32)).contiguous()
    t_map = torch.empty(C, E, Xp, dtype=torch.int32, device=D_raw.device)
    a = [torch.empty(C, E, Xp, dtype=torch.float32, device=D_raw.device)
         for _ in range(4)]
    hist = torch.zeros(C, n_levels, dtype=torch.int32, device=D_raw.device)
    lib = _build.load()
    _build.check(lib.escalation_ladder(
        W[0].data_ptr(), W[1].data_ptr(), W[2].data_ptr(),
        pixmask.data_ptr(), t_map.data_ptr(), a[0].data_ptr(),
        a[1].data_ptr(), a[2].data_ptr(), a[3].data_ptr(), hist.data_ptr(),
        C, E, Xp, ww, maxww, pw, _build.stream_ptr(D_raw.device)),
        "escalation_ladder")
    escalation_batch.launches += 1
    return resolve_pixels(t_map, a, hist, pixmask, cell, valid)


escalation_batch.launches = 0


def resolve_pixels(t_map, a, hist, pixmask, cell, valid):
    """From the kernel's per-cell level map ``t_map [C, E, Xp]``, background
    maps ``a`` (4 x [C, E, Xp]) and level histogram to per-pixel outputs:
    a pixel is resolved when its cell's level is at or below its
    chromosome's stop level."""
    C = t_map.shape[0]
    sw = stop_levels(hist, pixmask.sum((1, 2)))

    def at_pixels(m):
        return torch.gather(m.reshape(C, -1), 1, cell)

    tv = at_pixels(t_map)
    resolved = valid & (tv != UNRESOLVED) & (tv <= sw[:, None])
    return (resolved,) + tuple(at_pixels(m) for m in a)


def escalation(D_raw, D_bal, D_exp, e_pix, x_pix, valid, *args):
    """``escalation_batch`` for one chromosome."""
    out = escalation_batch(D_raw[None], D_bal[None], D_exp[None],
                           e_pix[None], x_pix[None], valid[None], *args)
    return tuple(o[0] for o in out)
