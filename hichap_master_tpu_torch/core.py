"""Shape helpers shared by the port (counterpart of
``hichap_master_tpu/core/contacts.py``, copied so the port imports nothing
of the JAX package)."""

from __future__ import annotations


def pad_to_bucket(n: int, bucket: int = 128) -> int:
    """Round up to a multiple of ``bucket`` (at least one bucket)."""
    return max(bucket, ((n + bucket - 1) // bucket) * bucket)
