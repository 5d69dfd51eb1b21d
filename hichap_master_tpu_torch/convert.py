"""Carry the JAX package's state across to the port's tensors.

The functions take plain objects by their fields (anything ``np.asarray``
accepts: numpy arrays, or JAX arrays, whose ``__array__`` copies them to the
host), so this module needs no import of the JAX package: a
``hichap_master_tpu.ops.sparse.BlockMatrix``, a
``hichap_master_tpu.core.ContactBatch``, a
``hichap_master_tpu.ops.hmm.GMMHMM`` or a weight vector from either
package go straight onto the given device, and both packages compute on
identical data.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.hmm import GMMHMM
from .ops.sparse import AsymBlocks, BlockMatrix


def tensor(a, device, dtype=None) -> torch.Tensor:
    """Any array-like as a tensor on ``device`` (a copy, never a view of
    the source's memory)."""
    return torch.from_numpy(np.array(a, copy=True)).to(device=device,
                                                       dtype=dtype)


def block_matrix(bm, device, dtype=torch.float32) -> BlockMatrix:
    """An object with ``.tiles/.brow/.bcol/.n/.T/.R`` as the port's
    BlockMatrix with tensor fields (tiles in ``dtype``, coordinates int32)."""
    return BlockMatrix(tiles=tensor(bm.tiles, device, dtype),
                       brow=tensor(bm.brow, device, torch.int32),
                       bcol=tensor(bm.bcol, device, torch.int32),
                       n=int(bm.n), T=int(bm.T), R=int(bm.R))


def asym_blocks(ab, device, dtype=torch.float32) -> AsymBlocks:
    """An object with ``.U/.L/.brow/.bcol/.n/.T/.R`` (the JAX package's
    ``AsymBlocks``) as the port's, with tensor fields on ``device``."""
    return AsymBlocks(U=tensor(ab.U, device, dtype),
                      L=tensor(ab.L, device, dtype),
                      brow=tensor(ab.brow, device, torch.int32),
                      bcol=tensor(ab.bcol, device, torch.int32),
                      n=int(ab.n), T=int(ab.T), R=int(ab.R))


def contact_batch(cb, device, dtype=torch.float32):
    """A ``core.ContactBatch`` (or any object with ``.data [C, N, N]`` and
    ``.n_bins [C]``, as the JAX package's) as (data, n_bins) tensors."""
    return (tensor(cb.data, device, dtype),
            tensor(cb.n_bins, device, torch.int32))


def weights(w, device) -> torch.Tensor:
    """A weight vector (NaN at filtered bins) as a float32 tensor."""
    return tensor(w, device, torch.float32)


def gmmhmm(model) -> GMMHMM:
    """An object with ``.A/.pi/.means/.varis/.weights`` (the JAX package's
    ``GMMHMM``) as the port's, fields float64 numpy copies."""
    return GMMHMM(*(np.array(getattr(model, f), np.float64, copy=True)
                    for f in ("A", "pi", "means", "varis", "weights")))
