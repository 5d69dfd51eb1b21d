"""Column helpers shared by the pipeline stages: host arrays to the
device, the stable multi-key order, read names as sortable words.

``name_words`` and ``lex_order`` together give Python's ``str`` order of
read names (and, over the name's length last, its stable sort): each name
becomes big-endian int64 words with the sign bit flipped, so signed word
order is unsigned byte order, and one chain of stable sorts orders the
rows.  ``pipeline.filtering`` joins the two haplotypes' beds by it and
``pipeline.pairs`` groups a chunk's alignments by it.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def lex_order(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """The permutation that sorts rows by ``keys`` (most significant
    first), ties kept in row order: stable sorts chained from the last
    key."""
    perm = torch.arange(len(keys[0]), device=keys[0].device)
    for k in reversed(keys):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def name_words(names: torch.Tensor, off: torch.Tensor, upto: torch.Tensor,
               W: int) -> List[torch.Tensor]:
    """Bytes ``[0, upto)`` of the names at ``off`` in ``names`` as W
    big-endian int64 words, zero padded, sign bit flipped (signed word
    order = unsigned byte order)."""
    w = torch.zeros((W, len(off)), dtype=torch.int64, device=off.device)
    last = max(names.numel() - 1, 0)
    for j in range(8 * W):
        b = torch.where(j < upto, names[(off + j).clamp(max=last)].long()
                        if names.numel() else 0, 0)
        k, r = divmod(j, 8)
        w[k] += (b - 128) * (1 << 56) if r == 0 else b << (8 * (7 - r))
    return list(w)
