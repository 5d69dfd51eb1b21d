"""K2 — the symmetric block-sparse marginal ``y = M @ b``.

Replaces the Pallas kernel ``_marginal_kernel`` driven by
``block_sym_matvec_pallas`` (``hichap_master_tpu/kernels/pallas_sparse_ice.py``).
Layout (``ops/sparse.py``): tiles ``[K, T, T]`` at block coordinates
``brow <= bcol``; diagonal tiles are stored mirrored-full, off-diagonal
tiles also contribute their transpose to block row ``bcol``.

Two phases, in the kernel and in its plain version alike: every tile's
row partial ``tile @ b[bcol]`` and, off the diagonal, its column partial
``tile^T @ b[brow]`` go to slots of a scratch ``[S, T]``; then each block
row sums its slots one after the other, in the order that
``sparse_marginal_order`` lays out from ``brow`` and ``bcol`` alone (by
block row, then tile).  So one layout gives the same bits on every run.
A caller that runs many matvecs over one layout builds the order once and
passes it as ``order=``.

CUDA source: ``csrc/sparse_marginal.cu`` (a block per tile that reads the
tile once for both partials, then a block per block row; no atomics).
"""

from __future__ import annotations

import dataclasses

import torch

from . import _build


@dataclasses.dataclass(frozen=True)
class MarginalOrder:
    """The fixed summation order of K2 over one layout.

    slots : [2, K] int32, the slot of tile k's row partial (``slots[0]``)
    and of its column partial (``slots[1]``, -1 for a diagonal tile);
    row_ptr : [R+1] int32, block row r sums slots ``row_ptr[r]`` to
    ``row_ptr[r+1]`` in turn; n_slots : S = 2K - diagonal tiles; max_len :
    the most slots of one block row."""

    slots: torch.Tensor
    row_ptr: torch.Tensor
    n_slots: int
    max_len: int

    @property
    def K(self) -> int:
        return int(self.slots.shape[1])

    @property
    def R(self) -> int:
        return int(self.row_ptr.shape[0]) - 1


def sparse_marginal_order(brow: torch.Tensor, bcol: torch.Tensor,
                          R: int) -> MarginalOrder:
    """The order of K2's block-row sums for the tiles at ``brow``/``bcol``
    (``[K]`` integers in ``[0, R)``), built on their device: a slot per
    tile for its row partial and one per off-diagonal tile for its column
    partial, ordered by (target block row, tile index, side)."""
    if brow.shape != bcol.shape or brow.dim() != 1:
        raise ValueError("brow and bcol must be [K]")
    dev = brow.device
    K = brow.shape[0]
    br = brow.to(torch.int64)
    bc = bcol.to(torch.int64)
    if K and bool(((br < 0) | (bc < 0) | (br >= R) | (bc >= R)).any()):
        raise ValueError(f"block coordinates must lie in [0, {R})")
    off = (br != bc).nonzero().squeeze(1)
    target = torch.cat([br, bc[off]])
    tile = torch.cat([torch.arange(K, device=dev), off])
    # within one block row a tile has at most one side, so (row, tile)
    # keys are distinct and the order is (row, tile, side)
    pos = torch.argsort(target * max(K, 1) + tile)
    slot = torch.empty_like(pos)
    slot[pos] = torch.arange(pos.numel(), device=dev)
    slots = torch.full((2, K), -1, dtype=torch.int32, device=dev)
    slots[0] = slot[:K].to(torch.int32)
    slots[1, off] = slot[K:].to(torch.int32)
    counts = torch.bincount(target, minlength=R)
    row_ptr = torch.zeros(R + 1, dtype=torch.int32, device=dev)
    row_ptr[1:] = torch.cumsum(counts, 0).to(torch.int32)
    return MarginalOrder(slots=slots, row_ptr=row_ptr,
                         n_slots=int(target.numel()),
                         max_len=int(counts.max()) if R else 0)


def _check_order(order: MarginalOrder, K: int, R: int, device) -> None:
    if order.K != K or order.R != R:
        raise ValueError(f"an order for K = {order.K}, R = {order.R} given "
                         f"to K = {K}, R = {R}")
    if order.slots.device != device or order.row_ptr.device != device:
        raise ValueError(f"the order must lie on {device}")


def _sum_in_order(part: torch.Tensor, order: MarginalOrder) -> torch.Tensor:
    """``y [R, T]``: each block row's slots of ``part`` added one after the
    other from 0, as the reduce kernel adds them.  A row past its last
    slot adds a zero row, which leaves its sum as it is (a sum from +0 is
    never -0)."""
    R, T = order.R, part.shape[1]
    start = order.row_ptr[:-1].long()
    n = order.row_ptr[1:].long() - start
    j = torch.arange(order.max_len, device=part.device)
    idx = torch.where(j < n[:, None], start[:, None] + j, order.n_slots)
    part = torch.cat([part, part.new_zeros(1, T)])
    y = torch.zeros(R, T, dtype=part.dtype, device=part.device)
    for i in range(order.max_len):
        y += part[idx[:, i]]
    return y


def block_sym_matvec_plain(tiles: torch.Tensor, brow: torch.Tensor,
                           bcol: torch.Tensor, b: torch.Tensor, *, R: int,
                           T: int, order: MarginalOrder | None = None
                           ) -> torch.Tensor:
    """Plain PyTorch version of K2, in its two phases: the partials by one
    einsum per side into their slots, then the block-row sums in the
    order's sequence.  bfloat16 tiles contract with bf16-rounded ``b`` and
    float32 accumulation."""
    if order is None:
        order = sparse_marginal_order(brow, bcol, R)
    _check_order(order, tiles.shape[0], R, tiles.device)
    xb = b.reshape(R, T)
    if tiles.dtype == torch.bfloat16:
        t = tiles.float()
        xb = xb.bfloat16().float()
    else:
        t = tiles
    br = brow.long()
    bc = bcol.long()
    part = torch.empty(order.n_slots, T, dtype=t.dtype, device=b.device)
    part[order.slots[0].long()] = torch.einsum("kij,kj->ki", t, xb[bc])
    off = (order.slots[1] >= 0).nonzero().squeeze(1)
    part[order.slots[1, off].long()] = torch.einsum(
        "kij,ki->kj", t[off], xb[br[off]])
    return _sum_in_order(part, order).reshape(R * T)


def block_sym_matvec(tiles: torch.Tensor, brow: torch.Tensor,
                     bcol: torch.Tensor, b: torch.Tensor, *, R: int,
                     T: int, order: MarginalOrder | None = None
                     ) -> torch.Tensor:
    """``y [R*T] = M @ b`` for the symmetric block layout.

    tiles : [K, T, T] float32 or bfloat16; brow, bcol : [K] int32 with
    brow <= bcol; b : [R*T] float32; order : what
    ``sparse_marginal_order(brow, bcol, R)`` gives, built here when not
    given.  The result is the same bits for the same inputs on every run.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (T = 128) or raise.
    """
    if tiles.dim() != 3 or tiles.shape[1:] != (T, T):
        raise ValueError(f"tiles must be [K, {T}, {T}], got "
                         f"{tuple(tiles.shape)}")
    K = tiles.shape[0]
    if brow.shape != (K,) or bcol.shape != (K,):
        raise ValueError("brow and bcol must be [K]")
    if b.shape != (R * T,):
        raise ValueError(f"b must be [{R * T}], got {tuple(b.shape)}")
    if tiles.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"tiles must be float32 or bfloat16, got "
                        f"{tiles.dtype}")
    if tiles.device.type == "cpu":
        return block_sym_matvec_plain(tiles, brow, bcol, b, R=R, T=T,
                                      order=order)
    if tiles.device.type != "cuda":
        raise RuntimeError(f"no block-sparse marginal kernel for device "
                           f"{tiles.device}")
    if T != 128:
        raise ValueError(f"the CUDA block-sparse marginal takes T = 128, "
                         f"got {T}")
    for name, t, dt in (("brow", brow, torch.int32),
                        ("bcol", bcol, torch.int32),
                        ("b", b, torch.float32)):
        if t.device != tiles.device or t.dtype != dt:
            raise TypeError(f"{name} must be {dt} on {tiles.device}")
    if (not tiles.is_contiguous() or not b.is_contiguous()
            or tiles.data_ptr() % 16 or b.data_ptr() % 16):
        raise ValueError("tiles and b must be contiguous and 16-byte "
                         "aligned")
    brow = brow.contiguous()
    bcol = bcol.contiguous()
    if order is None:
        order = sparse_marginal_order(brow, bcol, R)
    _check_order(order, K, R, tiles.device)
    part = torch.empty(order.n_slots, T, dtype=torch.float32,
                       device=b.device)
    y = torch.empty(R * T, dtype=torch.float32, device=b.device)
    lib = _build.load()
    _build.check(lib.sparse_marginal(
        tiles.data_ptr(), brow.data_ptr(), bcol.data_ptr(),
        order.slots.data_ptr(), order.row_ptr.data_ptr(), b.data_ptr(),
        part.data_ptr(), y.data_ptr(), K, R, T,
        int(tiles.dtype == torch.bfloat16),
        _build.stream_ptr(tiles.device)), "sparse_marginal")
    block_sym_matvec.launches += 1
    return y


block_sym_matvec.launches = 0
