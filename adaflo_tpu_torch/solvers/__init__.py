from adaflo_tpu_torch.solvers.krylov import SolverResult, bicgstab, cg, fgmres, gmres

__all__ = ["SolverResult", "bicgstab", "cg", "fgmres", "gmres"]
