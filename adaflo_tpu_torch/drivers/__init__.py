"""PyTorch counterparts of the JAX package's drivers (adaflo_tpu/drivers/)."""
