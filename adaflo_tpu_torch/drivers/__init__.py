"""PyTorch counterparts of adaflo_tpu.drivers (lattice branches)."""
