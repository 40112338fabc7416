"""Training losses of the port (counterparts of ``cruse_tpu/losses``)."""
