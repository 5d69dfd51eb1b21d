"""K2 — the symmetric block-sparse marginal ``y = M @ b``.

Replaces the Pallas kernel ``_marginal_kernel`` driven by
``block_sym_matvec_pallas`` (``hichap_master_tpu/kernels/pallas_sparse_ice.py``).
Layout (``ops/sparse.py``): tiles ``[K, T, T]`` at block coordinates
``brow <= bcol``; diagonal tiles are stored mirrored-full, off-diagonal
tiles also contribute their transpose to block row ``bcol``.

CUDA source: ``csrc/sparse_marginal.cu`` (one block per tile, one read of
the tile for both contributions, f32 atomics into ``y``; see its note).
"""

from __future__ import annotations

import torch

from . import _build


def block_sym_matvec_plain(tiles: torch.Tensor, brow: torch.Tensor,
                           bcol: torch.Tensor, b: torch.Tensor, *, R: int,
                           T: int) -> torch.Tensor:
    """Plain PyTorch version of K2: one einsum per triangle, then the
    block-row reduction with ``index_add_``.  bfloat16 tiles contract with
    bf16-rounded ``b`` and float32 accumulation."""
    xb = b.reshape(R, T)
    if tiles.dtype == torch.bfloat16:
        t = tiles.float()
        xb = xb.bfloat16().float()
    else:
        t = tiles
    br = brow.long()
    bc = bcol.long()
    cr = torch.einsum("kij,kj->ki", t, xb[bc])
    cc = torch.einsum("kij,ki->kj", t, xb[br])
    off = (br != bc).to(cr.dtype)
    y = torch.zeros(R, T, dtype=cr.dtype, device=b.device)
    y.index_add_(0, br, cr)
    y.index_add_(0, bc, cc * off[:, None])
    return y.reshape(R * T)


def block_sym_matvec(tiles: torch.Tensor, brow: torch.Tensor,
                     bcol: torch.Tensor, b: torch.Tensor, *, R: int,
                     T: int) -> torch.Tensor:
    """``y [R*T] = M @ b`` for the symmetric block layout.

    tiles : [K, T, T] float32 or bfloat16; brow, bcol : [K] int32 with
    brow <= bcol; b : [R*T] float32.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (T = 128) or raise.
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
        return block_sym_matvec_plain(tiles, brow, bcol, b, R=R, T=T)
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
    y = torch.zeros(R * T, dtype=torch.float32, device=b.device)
    lib = _build.load()
    _build.check(lib.sparse_marginal(
        tiles.data_ptr(), brow.data_ptr(), bcol.data_ptr(), b.data_ptr(),
        y.data_ptr(), K, T, int(tiles.dtype == torch.bfloat16),
        _build.stream_ptr(tiles.device)), "sparse_marginal")
    block_sym_matvec.launches += 1
    return y


block_sym_matvec.launches = 0
