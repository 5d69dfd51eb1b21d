"""Tensor ops of the port (counterparts of ``hichap_master_tpu.ops``)."""
