"""Core pieces of the port: the counterparts of ``thunder_tpu/core/``."""
