"""Matrix-free operators of the conservative (OKZ) level-set method.

PyTorch counterpart of ``adaflo_tpu/ops/level_set.py`` (the reference's four
operator classes, level_set_okz_advance_concentration.cc,
level_set_okz_compute_normal.cc, level_set_okz_compute_curvature.cc,
level_set_okz_reinitialization.cc, plus the shared projection operator,
level_set_okz.cc:239-313, and the surface-tension force, cc:317-409):

- LS advection: rhs = -(c w + u . grad c + BDF old terms), system
  (c w + u . grad c) with the frozen per-q-point convection, optionally with
  the residual-based artificial viscosity and its boundary-flux term;
- normal projection: rhs (v, grad c); system = the damped-Helmholtz
  projection operator, mass + 4 max(h/sub, eps_used/eps)^2 Laplacian;
- curvature: rhs (v, -div(n/|n|)) with dof-level normalization, same system;
- OKZ reinitialization: compression-diffusion steps with the normal frozen at
  the first reinit step;
- the surface-tension and gravity force with the per-q-point density and
  viscosity of the two phases.

The concentration space is FE_Q_iso_Q1 (hat functions on a subdivided
lattice) at the QIterated(Gauss 2, subdivisions) rule; everything runs as
sum-factorized contractions and lattice gathers/scatters on the solver's
device. Only the uniform-lattice branch of the JAX class is ported: forest,
simplex, extruded and mapped spaces raise NotImplementedError (ROADMAP.md
queue 1, items 12b and 15).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from adaflo_tpu_torch.fe.basis import iterated_gauss_quadrature
from adaflo_tpu_torch.fe.constraints import Constraints
from adaflo_tpu_torch.fe.space import ScalarSpace
from adaflo_tpu_torch.ops.lattice import LatticeOps
from adaflo_tpu_torch.ops.tensor import CellEvaluator
from adaflo_tpu_torch.parameters import FlowParameters


def _edq(a, b):
    """sum_d a[e, d, q] b[e, d, q] -> (e, q)."""
    return torch.einsum("edq,edq->eq", a, b)


class LevelSetOperators:
    def __init__(
        self,
        parameters: FlowParameters,
        ls_space: ScalarSpace,
        u_space: ScalarSpace,
        p_space: ScalarSpace,
        constraints_ls: Constraints,
        constraints_normals: Constraints,
        constraints_curvature: Constraints,
        epsilon_used: float,
        cell_diameter: float,
        minimal_edge_length: float,
        dtype: torch.dtype = torch.float64,
        device=None,
    ) -> None:
        for flag in ("is_forest", "is_simplex", "is_mapped", "is_extruded"):
            if getattr(ls_space, flag, False):
                raise NotImplementedError(
                    "the level-set operators are ported for the uniform "
                    "lattice only (ROADMAP.md queue 1, items 12b and 15)"
                )
        self.parameters = parameters
        self.ls_space = ls_space
        self.u_space = u_space
        self.p_space = p_space
        self.con_ls = constraints_ls
        self.con_nrm = constraints_normals
        self.con_curv = constraints_curvature
        self.dim = ls_space.dim
        self.dtype = dtype
        mesh = ls_space.mesh
        sub = parameters.concentration_subdivisions
        self.subdiv = sub

        q_ls = iterated_gauss_quadrature(sub, 2)
        nq_ns = parameters.velocity_degree + 1
        kw = dict(dtype=dtype, device=device)
        self.ev_ls = CellEvaluator(self.dim, ls_space.basis, q_ls, mesh.h, **kw)
        self.device = self.ev_ls.device
        self.ev_u_lsq = CellEvaluator(self.dim, u_space.basis, q_ls, mesh.h, **kw)
        # NS quadrature (Gauss velocity_degree+1) for the force
        self.ev_ls_nsq = CellEvaluator(self.dim, ls_space.basis, nq_ns, mesh.h, **kw)
        self.ev_p_nsq = CellEvaluator(self.dim, p_space.basis, nq_ns, mesh.h, **kw)
        self.ev_u_nsq = CellEvaluator(self.dim, u_space.basis, nq_ns, mesh.h, **kw)
        self.lat_ls = LatticeOps.for_space(ls_space)
        self.lat_u = LatticeOps.for_space(u_space)
        self.n_q = self.ev_ls.n_q

        self.epsilon_used = epsilon_used
        self.cell_diameter = cell_diameter
        self.minimal_edge_length = minimal_edge_length
        # reinit diffusion: max(eps_used, h/sub) (reinit.cc:82-86)
        self.reinit_diffusion = max(epsilon_used, cell_diameter / sub)
        # projection damping: 4 max(h/sub, eps_used/eps)^2 (okz.cc:270-281)
        self.projection_damping = 4.0 * max(
            epsilon_used / parameters.epsilon, cell_diameter / sub
        ) ** 2

        # residual-based artificial viscosity of the advection equation
        # (adv.cc:344-369 per-cell viscosity, 420-474 volume terms, 569-620
        # boundary-flux correction)
        self.stabilization = bool(getattr(parameters, "convection_stabilization", False))
        if self.stabilization:
            # diameter_on_coarse_grid of a hyper-rectangle = its diagonal
            self.omega_diameter = float(np.linalg.norm(mesh.lengths))
            self._stab_faces = self._build_stab_faces()

        # interpolation of the concentration space onto the pressure support
        # points (level_set_base.cc:65-137), for the grad-pressure-compatible
        # surface tension: (n_p_local, n_ls_local)
        Vp1, _ = ls_space.basis.tabulate(p_space.basis.nodes)
        P = Vp1
        for _ in range(self.dim - 1):
            P = np.kron(Vp1, P)
        self.interp_ls_to_p = torch.as_tensor(P, dtype=dtype, device=self.device)

    # -- gather/scatter helpers -----------------------------------------
    def _zeros(self, *shape):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def _gather_ls(self, c, con: Optional[Constraints] = None):
        if con is not None:
            c = con.resolve(c)
        return self.lat_ls.gather(c)

    def _scatter_ls(self, r_cells, con: Optional[Constraints] = None):
        r = self.lat_ls.scatter_add(r_cells)
        if con is not None:
            r = con.condense(r)
        return r

    def _gather_nrm(self, nv, con: Optional[Constraints] = None):
        return torch.stack(
            [self._gather_ls(nv[d], con) for d in range(self.dim)], dim=1
        )

    def _scatter_nrm(self, r_cells, con: Optional[Constraints] = None):
        return torch.stack(
            [self._scatter_ls(r_cells[:, d, :], con) for d in range(self.dim)]
        )

    @staticmethod
    def _identity_rows(out, src, con: Constraints, scale=None):
        """out[..., cd] = (scale[cd] *) src[..., cd] on the constrained dofs."""
        cd = con.constrained_dofs
        if not len(cd):
            return out
        idx = torch.as_tensor(cd, device=out.device)
        out = out.clone()
        vals = src[..., idx]
        out[..., idx] = vals if scale is None else scale[idx] * vals
        return out

    # -- lumped mass / diagonals ----------------------------------------
    def lumped_mass(self):
        """Lumped LS mass diagonal (level_set_okz_preconditioner.h:31-76)."""
        ones = torch.ones(
            (self.ls_space.mesh.n_cells, self.n_q), dtype=self.dtype, device=self.device
        )
        return self._scatter_ls(self.ev_ls.integrate_values(ones))

    def projection_diagonal(self):
        """Exact diagonal of the projection operator (mass + damped
        Laplacian), applied to unit local vectors four at a time."""
        E = self.ls_space.mesh.n_cells
        n_loc = self.ls_space.n_local
        damping = self.projection_damping
        batch = 4
        units = torch.eye(n_loc, dtype=self.dtype, device=self.device)
        diag_loc = self._zeros(E, n_loc)
        ev = self.ev_ls
        for b0 in range(0, n_loc, batch):
            b1 = min(b0 + batch, n_loc)
            pc = units[b0:b1, None, :].expand(b1 - b0, E, n_loc)
            r = ev.integrate_values(ev.values(pc))
            r = r + ev.integrate_gradients(damping * ev.gradients(pc))
            for k in range(b0, b1):
                diag_loc[:, k] = r[k - b0, :, k]
        return self.lat_ls.scatter_add(diag_loc)

    # -- advection (adv.cc:288-397, 217-258) ----------------------------
    def _build_stab_faces(self):
        """Per boundary face (axis, side): the h-free local matrix
        T[i, j] = sum_qf phi_i (n . d_a phi_j) w of the stabilization's
        boundary-flux correction (adv.cc:569-620), and a per-cell scale
        prod_{b != a} h_b / h_a on the cells whose (axis, side) face lies on
        the domain boundary, 0 elsewhere."""
        mesh = self.ls_space.mesh
        basis = self.ls_space.basis
        pts, wts = iterated_gauss_quadrature(self.subdiv, 2)
        V1, _ = basis.tabulate(pts)
        Ve, De = basis.tabulate(np.array([0.0, 1.0]))
        d = self.dim
        h = np.asarray(mesh.h, np.float64)
        faces = {}
        for a in range(d):
            for side in (0, 1):
                mats_phi, mats_dn, wlist = [], [], []
                # kron order: slowest (z) axis first, x last
                for b in reversed(range(d)):
                    if b == a:
                        mats_phi.append(Ve[side : side + 1, :])
                        mats_dn.append(De[side : side + 1, :])
                    else:
                        mats_phi.append(V1)
                        mats_dn.append(V1)
                        wlist.append(wts)
                Phi, Dn = mats_phi[0], mats_dn[0]
                for mp_, md_ in zip(mats_phi[1:], mats_dn[1:]):
                    Phi = np.kron(Phi, mp_)
                    Dn = np.kron(Dn, md_)
                wf = wlist[0] if wlist else np.ones(1)
                for w2 in wlist[1:]:
                    wf = np.kron(wf, w2)
                sign = -1.0 if side == 0 else 1.0
                T = (Phi * wf[:, None]).T @ (sign * Dn)
                rest = [b for b in range(d) if b != a]
                m = np.zeros(tuple(reversed(mesh.n_cells_axis)), np.float64)
                idx = [slice(None)] * d
                idx[d - 1 - a] = 0 if side == 0 else mesh.n_cells_axis[a] - 1
                m[tuple(idx)] = float(np.prod(h[rest]) / h[a])
                faces[(a, side)] = (
                    torch.as_tensor(T, dtype=self.dtype, device=self.device),
                    torch.as_tensor(m.reshape(-1), dtype=self.dtype, device=self.device),
                )
        return faces

    def _stab_face_term(self, c_loc, nu_art):
        """(E, n_loc) local dofs -> (E, n_loc) boundary flux
        sum_faces oint phi_i (n . nu grad v) dS."""
        out = torch.zeros_like(c_loc)
        for T, m in self._stab_faces.values():
            out = out + (m * nu_art)[:, None] * (c_loc @ T.T)
        return out

    def advection_rhs(
        self, c, c_old, c_old_old, u, u_old, u_old_old, tw, bdf2_old_old, old_dt=None
    ):
        """Returns (rhs, evaluated_convection (E, dim, n_q), nu_art): nu_art
        is the per-cell artificial viscosity, None when convection
        stabilization is off (adv.cc:344-369)."""
        ev = self.ev_ls
        cc = self._gather_ls(c)
        co = self._gather_ls(c_old)
        coo = self._gather_ls(c_old_old)
        c_val = ev.values(cc)
        c_grad = ev.gradients(cc)
        co_val = ev.values(co)
        coo_val = ev.values(coo)
        u_val = self.ev_u_lsq.values(self._gather_u(u))  # (E, dim, n_q)

        nu_art = None
        if self.stabilization:
            co_grad = ev.gradients(co)
            coo_grad = ev.gradients(coo)
            u_sum = self.ev_u_lsq.values(self._gather_u(u_old)) + self.ev_u_lsq.values(
                self._gather_u(u_old_old)
            )
            dt_safe = max(float(old_dt), 1e-30)
            dc_dt = (co_val - coo_val) / dt_safe
            resid = torch.abs(dc_dt + 0.25 * _edq(u_sum, co_grad + coo_grad))
            max_res = resid.max(dim=-1).values  # (E,)
            max_vel = torch.sqrt((u_sum * u_sum).sum(dim=1)).max(dim=-1).values
            # global max velocity at the same quadrature (the reference's
            # get_maximal_velocity over the current velocity, adv.cc:548-551)
            gmax = torch.sqrt((u_val * u_val).sum(dim=1)).max()
            scaling = torch.clamp(gmax * 2.0 * self.omega_diameter, min=1e-30)
            nu_art = (
                0.03 * max_vel * self.cell_diameter
                * torch.clamp(max_res / scaling, max=1.0)
            )

        old_value = tw.weight_old * co_val
        if bdf2_old_old:
            old_value = old_value + tw.weight_old_old * coo_val
        residual = -(c_val * tw.weight + _edq(u_val, c_grad) + old_value)
        r_cells = ev.integrate_values(residual)
        if nu_art is not None:
            r_cells = r_cells + ev.integrate_gradients(-nu_art[:, None, None] * c_grad)
            r_cells = r_cells + self._stab_face_term(cc, nu_art)
        return self._scatter_ls(r_cells, self.con_ls), u_val, nu_art

    def _gather_u(self, u):
        return torch.stack([self.lat_u.gather(u[d]) for d in range(self.dim)], dim=1)

    def advection_vmult(self, dc, evaluated_convection, tw, mass_diag, nu_art=None):
        """(v, w dc + u* . grad dc) (+ the stabilization terms, adv.cc:246-257
        and 420-474); constrained rows get the mass diagonal (adv.cc:476-479)."""
        ev = self.ev_ls
        cc = self._gather_ls(dc, self.con_ls)
        grad = ev.gradients(cc)
        res = ev.values(cc) * tw.weight + _edq(evaluated_convection, grad)
        r_cells = ev.integrate_values(res)
        if nu_art is not None:
            r_cells = r_cells + ev.integrate_gradients(nu_art[:, None, None] * grad)
            r_cells = r_cells - self._stab_face_term(cc, nu_art)
        out = self._scatter_ls(r_cells, self.con_ls)
        return self._identity_rows(out, dc, self.con_ls, mass_diag)

    # -- normal (normal.cc:82-156, 207-278) ------------------------------
    def normal_rhs(self, c):
        grad = self.ev_ls.gradients(self._gather_ls(c))  # (E, dim, n_q)
        return self._scatter_nrm(self.ev_ls.integrate_values(grad), self.con_nrm)

    def _projection_cells(self, cc):
        ev = self.ev_ls
        damping = self.projection_damping
        return ev.integrate_values(ev.values(cc)) + ev.integrate_gradients(
            damping * ev.gradients(cc)
        )

    def projection_vmult_block(self, nv):
        """The projection operator applied to a (dim, n) block field."""
        r = self._projection_cells(self._gather_nrm(nv, self.con_nrm))
        return self._identity_rows(self._scatter_nrm(r, self.con_nrm), nv, self.con_nrm)

    def projection_vmult_scalar(self, kappa):
        r = self._projection_cells(self._gather_ls(kappa, self.con_curv))
        out = self._scatter_ls(r, self.con_curv)
        return self._identity_rows(out, kappa, self.con_curv)

    # -- curvature (curv.cc:212-259) -------------------------------------
    def curvature_rhs(self, normal_field):
        """(v, -div(n/|n|)) with the normalization at dof level
        (curv.cc:212-259: values >= 1e-2 in norm -> unit, else 0)."""
        nc = self._gather_nrm(normal_field)  # (E, dim, n_loc), plain read
        norm = torch.sqrt((nc * nc).sum(dim=1, keepdim=True))
        nc = torch.where(norm > 1e-2, nc / torch.clamp(norm, min=1e-30), 0.0)
        grad = self.ev_ls.gradients(nc)  # (E, dim, dim, n_q)
        div = torch.diagonal(grad, dim1=1, dim2=2).sum(-1)
        return self._scatter_ls(self.ev_ls.integrate_values(-div), self.con_curv)

    # -- reinitialization (reinit.cc:53-189) ------------------------------
    def reinit_rhs(self, c, normal_field, first_step: bool, evaluated_normal, diffuse_only: bool):
        """Returns (rhs, evaluated_normal); evaluated_normal (E, dim, n_q) is
        refreshed when first_step."""
        ev = self.ev_ls
        cc = self._gather_ls(c)
        grad = ev.gradients(cc)
        diffusion = self.reinit_diffusion
        if diffuse_only:
            r = ev.integrate_gradients(-diffusion * grad)
            return self._scatter_ls(r, self.con_ls), evaluated_normal
        val = ev.values(cc)
        if first_step:
            n_val = ev.values(self._gather_nrm(normal_field))
            nn = torch.sqrt((n_val * n_val).sum(dim=1, keepdim=True))
            evaluated_normal = n_val / torch.clamp(nn, min=1e-4)
        n = evaluated_normal
        coef = 0.5 * (1.0 - val * val) - diffusion * _edq(n, grad)
        r = ev.integrate_gradients(n * coef[:, None, :])
        return self._scatter_ls(r, self.con_ls), evaluated_normal

    def reinit_vmult(self, dc, evaluated_normal, dtau_inv, diffuse_only: bool, mass_diag):
        ev = self.ev_ls
        cc = self._gather_ls(dc, self.con_ls)
        grad = ev.gradients(cc)
        diffusion = self.reinit_diffusion
        if diffuse_only:
            g = diffusion * grad
        else:
            n = evaluated_normal
            g = n * (diffusion * _edq(n, grad))[:, None, :]
        r = ev.integrate_values(dtau_inv * ev.values(cc)) + ev.integrate_gradients(g)
        out = self._scatter_ls(r, self.con_ls)
        return self._identity_rows(out, dc, self.con_ls, mass_diag)

    # -- surface tension force + variable coefficients (okz.cc:317-432) ---
    def compute_force(self, heaviside, curvature):
        """Returns (user_rhs_u (dim, n_u), rho_q (E, n_q_ns), mu_q) at the
        NS quadrature; rho_q and mu_q are None with equal phases."""
        par = self.parameters
        hv = self.lat_ls.gather(heaviside)  # plain read
        kv = self.lat_ls.gather(curvature)
        h_val = self.ev_ls_nsq.values(hv)
        kappa = self.ev_ls_nsq.values(kv)

        use_var = par.density_diff != 0 or par.viscosity_diff != 0
        rho_q = mu_q = None
        if use_var:
            rho_q = par.density + par.density_diff * h_val
            mu_q = par.viscosity + par.viscosity_diff * h_val

        if par.interpolate_grad_onto_pressure:
            hp = hv @ self.interp_ls_to_p.T  # (E, n_p_local)
            grad_h = self.ev_p_nsq.gradients(hp)
        else:
            grad_h = self.ev_ls_nsq.gradients(hv)

        force = (par.surface_tension * kappa)[:, None, :] * grad_h
        gravity_term = par.gravity * (rho_q if use_var else par.density)
        force = force.clone()
        force[:, self.dim - 1, :] -= gravity_term

        r = self.ev_u_nsq.integrate_values(force)  # (E, dim, n_loc_u)
        rows = [self.lat_u.scatter_add(r[:, d, :]) for d in range(self.dim)]
        return torch.stack(rows), rho_q, mu_q
