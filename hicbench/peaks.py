"""The card's peaks and the least time work could take on it: a frozen
copy of ``chip_smoke.bound``, the bytes that one call of
K2 (the block-sparse marginal) and of K7 (the scattered marginal) has to
move, counted from the layout of the cell's 10 kb matrix, and the bytes
of one vote of K6 (the imputation vote), counted from the reference's
own un-imputed matrix and queries (a frozen copy of
``chip_smoke.k6_cum_reads`` and the rule beside it).

Each input is counted read once and each output written once per call,
whatever the kernel reads again, so the count is that of the function and
not of one implementation of it.
"""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM (80 GB HBM3): memory bandwidth and the
# float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# queries whose disk windows ``k6_bytes`` searches at once
K6_QUERY_BLOCK = 1 << 15


def bound_s(n_bytes: float, flops: float = 0.0,
            peak: float = F32_FLOPS) -> float:
    """The least seconds the card could take for work that moves
    ``n_bytes`` and does ``flops`` at ``peak`` operations/s."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / peak)


def k2_bytes(layout: dict) -> int:
    """One call of the block-sparse marginal ``y = M @ b`` over the dense
    tiles: the tiles at the width the layout stores them
    (``value_bytes``, as ``k7_bytes`` counts the scattered values), their
    block row and column (int32), the vector b and the output y (float32,
    padded to the tile grid)."""
    K, T, R = layout["tiles"], layout["T"], layout["R"]
    return (K * T * T * layout["value_bytes"] + 2 * K * 4
            + 2 * R * T * 4)


def k7_bytes(layout: dict) -> int:
    """One call of the scattered marginal over the directed remainder: each
    pixel's column (int32) and value (``value_bytes``), the row bounds
    (int32, padded to the tile grid), the vector b and the output."""
    P, RT = layout["scattered"], layout["R"] * layout["T"]
    return P * (4 + layout["value_bytes"]) + (RT + 1) * 4 + 2 * RT * 4


def hybrid_layout(rows, cols, vals, n: int, T: int = 128,
                  min_tile_occ: int = 256) -> dict:
    """What K2 and K7 work on for a symmetric matrix given as its
    upper-triangle pixels (rows <= cols, cooler bins, ``n`` of them), split
    as the port's hybrid layout splits it: the ``T x T`` tiles that hold
    at least ``min_tile_occ`` pixels are dense, the rest is scattered,
    stored in both orientations without the diagonal; integer counts up
    to 65,535 are stored in two bytes, in the tiles and in the scattered
    part alike."""
    import torch

    R = -(-n // T)
    bid = (rows // T) * R + cols // T
    uniq, inv, occ = torch.unique(bid, return_inverse=True,
                                  return_counts=True)
    dense = occ >= min_tile_occ
    sc = ~dense[inv] & (rows != cols) & (vals != 0)
    return {"T": T, "R": R, "n": n, "tiles": int(dense.sum()),
            "diag_tiles": int((dense & (uniq // R == uniq % R)).sum()),
            "scattered": 2 * int(sc.sum()),
            "value_bytes": 2 if float(vals.max()) <= 0xFFFF else 4}


def k6_bytes(vote: dict) -> int:
    """One vote over a resolution's queries (``reference.haplotype``'s
    ``vote_inputs[res]``): the un-imputed matrix's columns (int32, one an
    entry of its directed table) and row pointer (int32, ``S + 1``), the
    queries (three int64 columns), the disk's row offsets and column
    bounds (int32) and the outputs, a hit flag (one byte) and a target
    (int32) a query; of the matrix's running sum (int64, one more than
    its entries) only the positions that a disk window holding an entry
    reads at its two ends, each position once.  A window is one disk row
    of a query whose window lies inside ``[0, S)`` on its row and both
    candidate columns; an empty window sums to 0 with no read."""
    import torch

    keys, S, L = vote["keys"], int(vote["S"]), int(vote["L"])
    rk, cs, cc = vote["queries"]
    dev = keys.device
    di, lo, hi = (torch.as_tensor(a, dtype=torch.int64, device=dev)
                  for a in vote["disk"])
    Q, nnz = rk.numel(), keys.numel()
    inb = torch.ones(Q, dtype=torch.bool, device=dev)
    for x in (rk, cs, cc):
        inb &= (x >= L) & (x + L + 1 <= S)
    r = rk[inb].long()
    need = torch.zeros(nnz + 1, dtype=torch.bool, device=dev)
    for col in (cs, cc):
        c = col[inb].long()
        for s in range(0, r.numel(), K6_QUERY_BLOCK):
            q = slice(s, s + K6_QUERY_BLOCK)
            base = (r[q, None] + di) * S + c[q, None]
            a = torch.searchsorted(keys, base + lo)
            b = torch.searchsorted(keys, base + hi + 1)
            held = b > a
            need[a[held]] = True
            need[b[held]] = True
    return (4 * nnz + 4 * (S + 1) + 3 * 8 * Q + 3 * 4 * di.numel()
            + (1 + 4) * Q + 8 * int(need.sum()))
