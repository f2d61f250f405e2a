"""Boundary-condition registry shared by all solvers.

Counterpart of the reference's BoundaryDescriptor + FlowBaseAlgorithm setter
API (include/adaflo/flow_base_algorithm.h:46-62, 163-275):
Dirichlet velocity, open (pressure) boundaries with/without tangential
constraints, pressure-fix point, no-slip, symmetry (no-normal-flux),
normal-flux-only, fluid-type (inflow level-set values), periodicity per
direction.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Set

from adaflo_tpu_torch.functions import Function, as_function


@dataclass
class BoundaryDescriptor:
    dirichlet_conditions_u: Dict[int, Function] = field(default_factory=dict)
    open_conditions_p: Dict[int, Function] = field(default_factory=dict)
    pressure_fix: Dict[int, Optional[Function]] = field(default_factory=dict)
    no_slip: Set[int] = field(default_factory=set)
    symmetry: Set[int] = field(default_factory=set)
    normal_flux: Set[int] = field(default_factory=set)
    fluid_type: Dict[int, Function] = field(default_factory=dict)
    periodic_axes: Set[int] = field(default_factory=set)


class FlowBaseAlgorithm:
    """BC setter mixin; solvers inherit this (flow_base_algorithm.h:163-275)."""

    def __init__(self) -> None:
        self.boundary = BoundaryDescriptor()

    def set_velocity_dirichlet_boundary(self, boundary_id: int, fn) -> None:
        fn = as_function(fn)
        if fn is not None:
            self.boundary.dirichlet_conditions_u[boundary_id] = fn

    def set_open_boundary(self, boundary_id: int, pressure_fn=None) -> None:
        from adaflo_tpu_torch.functions import ZeroFunction

        self.boundary.open_conditions_p[boundary_id] = (
            as_function(pressure_fn) or ZeroFunction()
        )

    def set_open_boundary_with_normal_flux(
        self, boundary_id: int, pressure_fn=None, inflow_fluid_type: int = 0
    ) -> None:
        """(flow_base_algorithm.cc:140-171); inflow_fluid_type +/-1 pins the
        two-phase concentration on the boundary to that fluid."""
        self.set_open_boundary(boundary_id, pressure_fn)
        self.boundary.normal_flux.add(boundary_id)
        if inflow_fluid_type:
            from adaflo_tpu_torch.functions import ConstantFunction

            assert inflow_fluid_type in (-1, 1)
            self.boundary.fluid_type[boundary_id] = ConstantFunction(
                float(inflow_fluid_type)
            )

    def fix_pressure_constant(self, boundary_id: int, pressure_fn=None) -> None:
        self.boundary.pressure_fix[boundary_id] = as_function(pressure_fn)

    def set_no_slip_boundary(self, boundary_id: int) -> None:
        self.boundary.no_slip.add(boundary_id)

    def set_symmetry_boundary(self, boundary_id: int) -> None:
        self.boundary.symmetry.add(boundary_id)

    def set_normal_flux_boundary(self, boundary_id: int) -> None:
        self.boundary.normal_flux.add(boundary_id)

    def set_fluid_type_boundary(self, boundary_id: int, fn) -> None:
        self.boundary.fluid_type[boundary_id] = as_function(fn)

    def set_periodic_direction(self, axis: int) -> None:
        """Structured-mesh periodicity: the lattice wraps along `axis`
        (replaces the reference's periodicity constraints,
        flow_base_algorithm.h:267-275 + navier_stokes.cc:243-272)."""
        self.boundary.periodic_axes.add(axis)
