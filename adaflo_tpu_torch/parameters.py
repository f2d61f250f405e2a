"""Runtime configuration: the full parameter tree of the reference.

Declares/parses every runtime option of the reference's FlowParameters
(source/parameters.cc:61-419, parse 450-614): dimension,
refinements, FE degree, augmented Taylor-Hood, physical type, convective-form
beta, linearization scheme, linear-solver settings, preconditioner selection,
output options, two-phase physics, and the time-stepping block. Reads .prm or
.json files.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from adaflo_tpu_torch.prm import ParameterHandler, PrmError


class PhysicalType(enum.Enum):
    incompressible = "incompressible"
    incompressible_stationary = "incompressible stationary"
    stokes = "stokes"


class Linearization(enum.Enum):
    coupled_implicit_newton = "coupled implicit Newton"
    coupled_implicit_picard = "coupled implicit Picard"
    coupled_velocity_semi_implicit = "coupled velocity semi-implicit"
    coupled_velocity_explicit = "coupled velocity explicit"
    projection = "projection"


class VelocityPreconditioner(enum.Enum):
    u_ilu = "ilu"
    u_ilu_scalar = "ilu scalar"
    u_amg_linear = "amg linear"
    u_amg = "amg"


class PressurePreconditioner(enum.Enum):
    p_mass_ilu = "ilu"
    p_mass_diag = "diagonal"


class Scheme(enum.Enum):
    implicit_euler = "implicit_euler"
    explicit_euler = "explicit_euler"
    crank_nicolson = "crank_nicolson"
    bdf_2 = "bdf_2"


_BETA_CONVECTIVE = {
    "skew-symmetric": 0.5,
    "convective": 0.0,
    "conservative": 1.0,
}


@dataclass
class TimeSteppingParameters:
    """Mirror of the reference's TimeSteppingParameters
    (include/adaflo/time_stepping.h:34-55)."""

    time_step_scheme: Scheme = Scheme.bdf_2
    start_time: float = 0.0
    end_time: float = 1.0
    time_step_size_start: float = 1e-2
    time_stepping_cfl: float = 0.8
    time_stepping_coef2: float = 10.0
    time_step_tolerance: float = 1e-2
    time_step_size_max: float = 1.0
    time_step_size_min: float = 0.1


@dataclass
class FlowParameters:
    # Navier-Stokes
    dimension: int = 2
    global_refinements: int = 1
    adaptive_refinements: int = 0
    use_anisotropic_refinement: bool = False
    use_simplex_mesh: bool = False
    velocity_degree: int = 2
    augmented_taylor_hood: bool = False
    viscosity: float = 1.0
    density: float = 1.0
    damping: float = 0.0  # stored with flipped sign like the reference
    physical_type: PhysicalType = PhysicalType.incompressible
    beta_convective_term_momentum_balance: float = 0.5
    # Solver
    max_nl_iteration: int = 10
    tol_nl_iteration: float = 1e-6
    linearization: Linearization = Linearization.coupled_implicit_newton
    tau_grad_div: float = 0.0
    max_lin_iteration: int = 500
    tol_lin_iteration: float = 1e-3
    rel_lin_iteration: bool = True
    precondition_velocity: VelocityPreconditioner = VelocityPreconditioner.u_amg_linear
    precondition_pressure: PressurePreconditioner = PressurePreconditioner.p_mass_ilu
    iterations_before_inner_solvers: int = 50
    # Output options
    output_filename: str = ""
    output_verbosity: int = 2
    output_frequency: float = 1.0
    print_solution_fields: int = 0
    output_wall_times: bool = False
    output_memory: bool = False
    # Two phase
    density_diff: float = 0.0
    viscosity_diff: float = 0.0
    surface_tension: float = 1.0
    gravity: float = 0.0
    epsilon: float = 1.0
    diffusion_length: float = 0.1
    contact_angle: float = 0.0
    pressure_constraint: bool = True
    concentration_subdivisions: int = 2
    curvature_correction: int = 0
    interpolate_grad_onto_pressure: bool = False
    surface_tension_from_heaviside: bool = True
    approximate_projections: bool = False
    ch_do_newton: bool = True
    do_iteration: bool = False
    n_reinit_steps: int = 2
    n_initial_reinit_steps: int = 0
    convection_stabilization: bool = False
    # Time stepping
    start_time: float = 0.0
    end_time: float = 1.0
    time_step_size_start: float = 1e-2
    time_stepping_cfl: float = 0.8
    time_stepping_coef2: float = 10.0
    time_step_tolerance: float = 1e-2
    time_step_size_max: float = 1.0
    time_step_size_min: float = 0.1
    time_step_scheme: Scheme = Scheme.bdf_2

    # TPU-build-only knobs (no reference counterpart)
    dtype: str = "float64"

    @staticmethod
    def declare_parameters(prm: ParameterHandler) -> None:
        """Parameter tree mirroring source/parameters.cc:61-419."""
        prm.enter_subsection("Navier-Stokes")
        prm.declare_entry("dimension", "2")
        prm.declare_entry("global refinements", "1")
        prm.declare_entry("anisotropic refinement", "0")
        prm.declare_entry("simplex mesh", "0")
        prm.declare_entry("adaptive refinements", "0")
        prm.declare_entry("velocity degree", "2")
        prm.declare_entry("augmented Taylor-Hood elements", "0")
        prm.declare_entry("viscosity", "1.")
        prm.declare_entry("density", "1.")
        prm.declare_entry("damping", "0")
        prm.declare_entry(
            "physical type",
            "incompressible",
            "incompressible|incompressible stationary|stokes",
        )
        prm.declare_entry(
            "formulation convective term momentum balance",
            "skew-symmetric",
            "skew-symmetric|convective|conservative",
        )
        prm.enter_subsection("Solver")
        prm.declare_entry("NL max iterations", "10")
        prm.declare_entry("NL tolerance", "1e-6")
        prm.declare_entry(
            "linearization scheme",
            "coupled implicit Newton",
            "coupled implicit Newton|coupled implicit Picard|"
            "coupled velocity semi-implicit|coupled velocity explicit|projection",
        )
        prm.declare_entry("tau grad div", "0.")
        prm.declare_entry("lin max iterations", "500")
        prm.declare_entry("lin tolerance", "1.e-3")
        prm.declare_entry("lin relative tolerance", "1")
        prm.declare_entry(
            "lin velocity preconditioner",
            "amg linear",
            "ilu|ilu scalar|amg linear|amg",
        )
        prm.declare_entry("lin pressure mass preconditioner", "ilu", "ilu|diagonal")
        prm.declare_entry("lin its before inner solvers", "50")
        prm.leave_subsection()
        prm.leave_subsection()

        prm.enter_subsection("Output options")
        prm.declare_entry("output filename", "")
        prm.declare_entry("output verbosity", "2")
        prm.declare_entry("output frequency", "1")
        prm.declare_entry("output vtk files", "0")
        prm.declare_entry("output wall times", "0")
        prm.declare_entry("output memory", "0")
        prm.leave_subsection()

        prm.enter_subsection("Two phase")
        prm.declare_entry("density", "-1.")
        prm.declare_entry("density difference", "0.")
        prm.declare_entry("viscosity", "-1.")
        prm.declare_entry("viscosity difference", "0.")
        prm.declare_entry("surface tension", "1.")
        prm.declare_entry("epsilon", "1")
        prm.declare_entry("gravity", "0")
        prm.declare_entry("diffusion length", "0.1")
        prm.declare_entry("contact angle", "0")
        prm.declare_entry("pressure constraint", "1")
        prm.declare_entry("concentration subdivisions", "2")
        prm.declare_entry("curvature correction", "0")
        prm.declare_entry("grad pressure compatible", "0")
        prm.declare_entry("localize surface tension", "1")
        prm.declare_entry("approximate projections", "0")
        prm.declare_entry("Cahn-Hilliard do Newton", "1")
        prm.declare_entry("full nonlinear iteration", "0")
        prm.declare_entry("number reinit steps", "2")
        prm.declare_entry("number initial reinit steps", "0")
        prm.declare_entry("convection stabilization", "0")
        prm.leave_subsection()

        prm.enter_subsection("Time stepping")
        prm.declare_entry("start time", "0.")
        prm.declare_entry("end time", "1.")
        prm.declare_entry("step size", "1.e-2")
        prm.declare_entry("CFL number", "0.8")
        prm.declare_entry("CFL number capillary", "10")
        prm.declare_entry("tolerance", "1.e-2")
        prm.declare_entry("max step size", "1.")
        prm.declare_entry("min step size", ".1")
        prm.declare_entry(
            "scheme",
            "bdf_2",
            "explicit_euler|implicit_euler|crank_nicolson|bdf_2",
        )
        prm.leave_subsection()

    @classmethod
    def from_file(cls, parameter_file: str) -> "FlowParameters":
        prm = ParameterHandler()
        cls.declare_parameters(prm)
        if parameter_file.endswith(".json"):
            prm.parse_input_from_json(parameter_file)
        elif parameter_file.endswith(".prm"):
            prm.parse_input(parameter_file)
        else:
            raise PrmError(f"Cannot handle parameter file '{parameter_file}'")
        self = cls()
        self._parse(prm)
        return self

    @classmethod
    def from_string(cls, text: str) -> "FlowParameters":
        prm = ParameterHandler()
        cls.declare_parameters(prm)
        prm.parse_input_string(text)
        self = cls()
        self._parse(prm)
        return self

    def _parse(self, prm: ParameterHandler) -> None:
        """Semantics mirror source/parameters.cc:450-614."""
        prm.enter_subsection("Navier-Stokes")
        self.dimension = prm.get_integer("dimension")
        self.global_refinements = prm.get_integer("global refinements")
        self.adaptive_refinements = prm.get_integer("adaptive refinements")
        self.use_anisotropic_refinement = prm.get_integer("anisotropic refinement") > 0
        if self.use_anisotropic_refinement:
            # deal.II tensor cells can split along one axis only; the Morton
            # forest here refines isotropically. The flag's only other
            # effect is a damping rescale inside the matrix-based LS solver
            # (level_set_okz_matrix.cc:646-649), which maps onto the
            # matrix-free path. Fail loudly rather than silently run an
            # isotropic mesh the user didn't ask for.
            raise PrmError(
                "'anisotropic refinement' is not supported: mesh adaptation "
                "is isotropic (2:1 Morton forest); unset the flag"
            )
        self.use_simplex_mesh = prm.get_integer("simplex mesh") > 0
        self.velocity_degree = prm.get_integer("velocity degree")
        if self.velocity_degree <= 1:
            raise PrmError("velocity degree must be > 1")
        self.augmented_taylor_hood = prm.get_integer("augmented Taylor-Hood elements") > 0
        self.viscosity = prm.get_double("viscosity")
        self.density = prm.get_double("density")
        # sign convention as in the reference: negative = damping
        self.damping = -prm.get_double("damping")
        self.physical_type = PhysicalType(prm.get("physical type"))
        if self.physical_type == PhysicalType.stokes:
            self.density = 0.0
        self.beta_convective_term_momentum_balance = _BETA_CONVECTIVE[
            prm.get("formulation convective term momentum balance")
        ]

        prm.enter_subsection("Solver")
        self.max_nl_iteration = prm.get_integer("NL max iterations")
        self.tol_nl_iteration = prm.get_double("NL tolerance")
        self.linearization = Linearization(prm.get("linearization scheme"))
        if (
            self.physical_type == PhysicalType.incompressible_stationary
            and self.linearization != Linearization.coupled_implicit_newton
        ):
            raise PrmError(
                "Only coupled implicit Newton linearization available for "
                "stationary equation"
            )
        self.tau_grad_div = prm.get_double("tau grad div")
        if self.tau_grad_div < 0:
            raise PrmError("Invalid parameter value for tau grad div")
        self.max_lin_iteration = prm.get_integer("lin max iterations")
        self.tol_lin_iteration = prm.get_double("lin tolerance")
        self.rel_lin_iteration = prm.get_integer("lin relative tolerance") > 0
        self.precondition_velocity = VelocityPreconditioner(
            prm.get("lin velocity preconditioner")
        )
        self.precondition_pressure = PressurePreconditioner(
            prm.get("lin pressure mass preconditioner")
        )
        self.iterations_before_inner_solvers = prm.get_integer(
            "lin its before inner solvers"
        )
        prm.leave_subsection()
        prm.leave_subsection()

        prm.enter_subsection("Output options")
        self.output_filename = prm.get("output filename")
        self.output_verbosity = prm.get_integer("output verbosity")
        self.output_frequency = prm.get_double("output frequency")
        self.print_solution_fields = min(prm.get_integer("output vtk files"), 1)
        self.output_wall_times = prm.get_integer("output wall times") > 0
        self.output_memory = prm.get_integer("output memory") > 0
        prm.leave_subsection()

        prm.enter_subsection("Two phase")
        if prm.get_double("density") > 0:
            self.density = prm.get_double("density")
        self.density_diff = prm.get_double("density difference")
        if self.physical_type == PhysicalType.stokes:
            self.density = self.density_diff = 0.0
        if prm.get_double("viscosity") > 0:
            self.viscosity = prm.get_double("viscosity")
        self.viscosity_diff = prm.get_double("viscosity difference")
        self.surface_tension = prm.get_double("surface tension")
        self.gravity = prm.get_double("gravity")
        self.epsilon = prm.get_double("epsilon")
        self.diffusion_length = prm.get_double("diffusion length")
        self.contact_angle = prm.get_double("contact angle")
        # parsed for prm-tree parity; dead in the reference as well
        # (parameters.cc:565 stores it, nothing reads it — drivers choose
        # whether to fix the pressure constant via the API instead)
        self.pressure_constraint = prm.get_integer("pressure constraint") > 0
        if self.diffusion_length <= 0:
            raise PrmError("Diffusion length must be positive")
        if self.epsilon <= 0:
            raise PrmError("epsilon must be positive")
        self.concentration_subdivisions = prm.get_integer("concentration subdivisions")
        self.curvature_correction = prm.get_integer("curvature correction")
        self.interpolate_grad_onto_pressure = (
            prm.get_integer("grad pressure compatible") > 0
        )
        self.surface_tension_from_heaviside = (
            prm.get_integer("localize surface tension") > 0
        )
        self.approximate_projections = prm.get_integer("approximate projections") > 0
        self.ch_do_newton = prm.get_integer("Cahn-Hilliard do Newton") > 0
        self.do_iteration = prm.get_integer("full nonlinear iteration") > 0
        self.n_reinit_steps = prm.get_integer("number reinit steps")
        self.n_initial_reinit_steps = prm.get_integer("number initial reinit steps")
        self.convection_stabilization = prm.get_integer("convection stabilization") > 0
        prm.leave_subsection()

        prm.enter_subsection("Time stepping")
        self.start_time = prm.get_double("start time")
        self.end_time = prm.get_double("end time")
        self.time_step_size_start = prm.get_double("step size")
        self.time_stepping_cfl = prm.get_double("CFL number")
        self.time_stepping_coef2 = prm.get_double("CFL number capillary")
        # parsed for prm-tree parity; dead in the reference as well
        # (time_stepping.h:52 stores it in TimeSteppingParameters, the
        # implementation never reads it)
        self.time_step_tolerance = prm.get_double("tolerance")
        self.time_step_size_max = prm.get_double("max step size")
        self.time_step_size_min = prm.get_double("min step size")
        # no adaptive time stepping in case the start step was large
        if self.time_step_size_min > self.time_step_size_start:
            self.time_step_size_max = self.time_step_size_min = (
                self.time_step_size_start
            )
        self.time_step_scheme = Scheme(prm.get("scheme"))
        prm.leave_subsection()

    def time_stepping_parameters(self) -> TimeSteppingParameters:
        return TimeSteppingParameters(
            time_step_scheme=self.time_step_scheme,
            start_time=self.start_time,
            end_time=self.end_time,
            time_step_size_start=self.time_step_size_start,
            time_stepping_cfl=self.time_stepping_cfl,
            time_stepping_coef2=self.time_stepping_coef2,
            time_step_tolerance=self.time_step_tolerance,
            time_step_size_max=self.time_step_size_max,
            time_step_size_min=self.time_step_size_min,
        )

    @property
    def pressure_degree(self) -> int:
        return self.velocity_degree - 1

    @property
    def use_variable_coefficients(self) -> bool:
        return self.density_diff != 0 or self.viscosity_diff != 0
