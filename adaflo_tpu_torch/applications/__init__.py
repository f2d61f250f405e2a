"""Applications of the port (adaflo_tpu/applications/ counterparts)."""
