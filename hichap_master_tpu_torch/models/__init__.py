"""Analysis models of the port (counterparts of ``hichap_master_tpu.models``)."""
