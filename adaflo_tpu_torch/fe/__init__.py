from adaflo_tpu_torch.fe.basis import (
    LagrangeBasis1D,
    gauss_lobatto_points,
    gauss_quadrature,
)
from adaflo_tpu_torch.fe.space import ScalarSpace

__all__ = [
    "LagrangeBasis1D",
    "gauss_lobatto_points",
    "gauss_quadrature",
    "ScalarSpace",
]
