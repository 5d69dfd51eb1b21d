"""Shape helpers shared by the port (counterpart of
``hichap_master_tpu/core/contacts.py``, copied so the port imports nothing
of the JAX package)."""

from __future__ import annotations


def pad_to_bucket(n: int, bucket: int = 128) -> int:
    """Round up to a multiple of ``bucket`` (at least one bucket)."""
    return max(bucket, ((n + bucket - 1) // bucket) * bucket)


def pad_to_shape(n: int, bucket: int = 128) -> int:
    """Round up to the shape ladder: 256 -> 2048 in powers of two, then
    x1.5 steps (3072, 4608, 6912, 10368, ...), each ``bucket``-aligned.

    The JAX package pads to this ladder to bound its compiled shapes; the
    port pads the compartment and TAD batches to the same sizes, so both
    packages group the same chromosomes and subspace PCA starts from a
    block of the same shape."""
    n = max(int(n), 1)
    p = 256
    while p < n and p < 2048:
        p *= 2
    while p < n:
        p = -(-p * 3 // 2)            # ceil x1.5
        p = -(-p // bucket) * bucket  # keep the alignment
    return p
