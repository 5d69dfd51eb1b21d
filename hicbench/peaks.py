"""The card's peaks and the least time work could take on it: a frozen
copy of ``chip_smoke.bound``, and the bytes that one call of
K2 (the block-sparse marginal) and of K7 (the scattered marginal) has to
move, counted from the layout of the cell's 10 kb matrix.

Each input is counted read once and each output written once per call,
whatever the kernel reads again, so the count is that of the function and
not of one implementation of it.
"""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM (80 GB HBM3): memory bandwidth and the
# float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


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
