"""Two-phase flow on the uniform lattice: the conservative level set."""

from adaflo_tpu_torch.twophase.level_set_okz import LevelSetOKZSolver

__all__ = ["LevelSetOKZSolver"]
