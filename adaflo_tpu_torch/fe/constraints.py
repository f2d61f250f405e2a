"""Affine constraints as precomputed gather/scatter index maps.

PyTorch counterpart of ``adaflo_tpu/fe/constraints.py`` (deal.II
AffineConstraints as used by the reference, source/navier_stokes.cc:228-360):
Dirichlet rows, periodicity and hanging nodes are static index/weight arrays,
built on the host with numpy; applying them to a device vector is an indexed
read and an indexed write.

Semantics mirror deal.II matrix-free exactly:
- ``resolve`` = read_dof_values: constrained entries replaced by their
  (homogeneous) constraint expansion; Dirichlet entries read 0.
- plain gather (residuals) uses the raw vector, honoring inhomogeneous
  boundary values written into the solution (navier_stokes_matrix.cc:659-666).
- ``condense`` = distribute_local_to_global: slave-row contributions
  accumulate into master rows, constrained rows end at zero.
- ``distribute``: writes the constraint values into a vector (homogeneous:
  Dirichlet rows zeroed, slaves = weighted masters).

Every device-side method returns a new tensor and leaves its arguments
untouched, like the functional updates of the JAX package; it acts on the
last axis, so a batch of vectors (..., n_dofs) takes one call.
"""

from __future__ import annotations

import numpy as np
import torch

from adaflo_tpu_torch.ops.lattice import segment_sum, segment_table


class Constraints:
    """Constraints for one scalar dof vector of length n_dofs.

    Vector-valued fields (velocity) keep one Constraints object per
    component, matching the per-component masks the structured boundary
    conditions produce (symmetry planes constrain only the normal
    component)."""

    def __init__(self, n_dofs: int) -> None:
        self.n_dofs = n_dofs
        self._dirichlet = np.zeros(n_dofs, dtype=bool)
        # general affine rows: slave -> sum_k weight * master
        self._slaves: list[np.ndarray] = []
        self._masters: list[np.ndarray] = []
        self._weights: list[np.ndarray] = []
        self._closed = False
        self._dev: dict = {}

    # -- construction ------------------------------------------------------
    def add_dirichlet(self, dofs: np.ndarray) -> None:
        assert not self._closed
        self._dirichlet[np.asarray(dofs, dtype=np.int64)] = True

    def add_affine(
        self, slaves: np.ndarray, masters: np.ndarray, weights: np.ndarray
    ) -> None:
        assert not self._closed
        self._slaves.append(np.asarray(slaves, dtype=np.int64))
        self._masters.append(np.asarray(masters, dtype=np.int64))
        self._weights.append(np.asarray(weights, dtype=np.float64))

    def close(self) -> None:
        if self._closed:
            return
        if self._slaves:
            self.slave = np.concatenate(self._slaves)
            self.master = np.concatenate(self._masters)
            self.weight = np.concatenate(self._weights)
            # a dof that is Dirichlet wins over an affine row
            keep = ~self._dirichlet[self.slave]
            self.slave = self.slave[keep]
            self.master = self.master[keep]
            self.weight = self.weight[keep]
            self._dedup_first()
            self._resolve_chains()
            self._dedup_sum()
            self.vslave = self.slave.copy()
            self.vmaster = self.master.copy()
            self.vweight = self.weight.copy()
            # homogeneous table: Dirichlet masters read zero
            keep = ~self._dirichlet[self.master]
            self.slave = self.slave[keep]
            self.master = self.master[keep]
            self.weight = self.weight[keep]
            vanished = np.setdiff1d(np.unique(self.vslave), np.unique(self.slave))
            self._dirichlet[vanished] = True
        else:
            self.slave = np.empty(0, dtype=np.int64)
            self.master = np.empty(0, dtype=np.int64)
            self.weight = np.empty(0, dtype=np.float64)
            self.vslave = self.slave
            self.vmaster = self.master
            self.vweight = self.weight
        self.dirichlet_dofs = np.flatnonzero(self._dirichlet)
        is_constrained = self._dirichlet.copy()
        is_constrained[self.vslave] = True
        self.constrained_dofs = np.flatnonzero(is_constrained)
        self.is_constrained = is_constrained
        self.slave_unique, seg = np.unique(self.slave, return_inverse=True)
        self._multi_master = len(self.slave_unique) != len(self.slave)
        self.vslave_unique, vseg = np.unique(self.vslave, return_inverse=True)
        # the affine rows' sums as segment sums in a fixed order (an atomic
        # index_add_ on the card sums in the order its updates land): the
        # terms of each slave row (resolve, distribute_values) and the
        # slave terms that reach each master (condense)
        self._seg_table = segment_table(seg, len(self.slave_unique))
        self._vseg_table = segment_table(vseg, len(self.vslave_unique))
        self.master_unique, mseg = np.unique(self.master, return_inverse=True)
        self._master_table = segment_table(mseg, len(self.master_unique))
        self._closed = True

    def _dedup_first(self) -> None:
        key = self.slave * (self.n_dofs + 1) + self.master
        _, first = np.unique(key, return_index=True)
        first.sort()
        self.slave = self.slave[first]
        self.master = self.master[first]
        self.weight = self.weight[first]

    def _dedup_sum(self) -> None:
        key = self.slave * (self.n_dofs + 1) + self.master
        ukey, inv = np.unique(key, return_inverse=True)
        w = np.zeros(len(ukey))
        np.add.at(w, inv, self.weight)
        self.slave = (ukey // (self.n_dofs + 1)).astype(np.int64)
        self.master = (ukey % (self.n_dofs + 1)).astype(np.int64)
        self.weight = w
        nz = np.abs(self.weight) > 1e-13
        self.slave, self.master, self.weight = (
            self.slave[nz],
            self.master[nz],
            self.weight[nz],
        )

    def _resolve_chains(self) -> None:
        """Substitute masters that are themselves constrained, until every
        master is free or Dirichlet (hanging-node closures can chain)."""
        for _ in range(20):
            uslaves = np.unique(self.slave)
            bad_slave = np.isin(self.master, uslaves)
            if not bad_slave.any():
                return
            keep = ~bad_slave
            need = np.unique(self.master[bad_slave])
            rows: dict[int, tuple[np.ndarray, np.ndarray]] = {}
            for s in need:
                sel = self.slave == s
                rows[int(s)] = (self.master[sel], self.weight[sel])
            new_s = [self.slave[keep]]
            new_m = [self.master[keep]]
            new_w = [self.weight[keep]]
            for s, m, w in zip(
                self.slave[bad_slave], self.master[bad_slave], self.weight[bad_slave]
            ):
                mm, mw = rows[int(m)]
                new_s.append(np.full(len(mm), s, dtype=np.int64))
                new_m.append(mm)
                new_w.append(w * mw)
            self.slave = np.concatenate(new_s)
            self.master = np.concatenate(new_m)
            self.weight = np.concatenate(new_w)
        raise RuntimeError("constraint chain did not resolve in 20 passes")

    @property
    def n_constrained(self) -> int:
        return len(self.constrained_dofs)

    # -- device copies of the index tables -----------------------------------
    def _t(self, name: str, like: torch.Tensor) -> torch.Tensor:
        """Index/weight table `name` on the device of `like` (weights also
        in its dtype), built once per device."""
        key = (name, like.device, like.dtype if name.endswith("weight") else None)
        t = self._dev.get(key)
        if t is None:
            arr = getattr(self, name)
            if name.endswith("weight"):
                t = torch.as_tensor(arr, dtype=like.dtype, device=like.device)
            else:
                t = torch.as_tensor(
                    np.asarray(arr, np.int64), device=like.device
                )
            self._dev[key] = t
        return t

    def _expand(self, u, slave, master, weight, table, slave_unique, multi):
        vals = self._t(weight, u) * u[..., self._t(master, u)]
        if multi:
            u[..., self._t(slave_unique, u)] = segment_sum(vals, self._t(table, u))
        else:
            u[..., self._t(slave, u)] = vals

    # -- device-side application ---------------------------------------------
    def resolve(self, u):
        """read_dof_values semantics: homogeneous expansion of constraints."""
        assert self._closed
        if not len(self.slave) and not len(self.dirichlet_dofs):
            return u
        u = u.clone()
        if len(self.slave):
            self._expand(
                u, "slave", "master", "weight", "_seg_table", "slave_unique",
                self._multi_master,
            )
        if len(self.dirichlet_dofs):
            u[..., self._t("dirichlet_dofs", u)] = 0.0
        return u

    def condense(self, r):
        """distribute_local_to_global tail: move slave-row sums to masters,
        zero all constrained rows."""
        assert self._closed
        if not len(self.constrained_dofs):
            return r
        r = r.clone()
        if len(self.slave):
            add = self._t("weight", r) * r[..., self._t("slave", r)]
            r[..., self._t("master_unique", r)] += segment_sum(
                add, self._t("_master_table", r)
            )
        r[..., self._t("constrained_dofs", r)] = 0.0
        return r

    def distribute(self, u):
        """Write constraint values into the vector (homogeneous)."""
        return self.resolve(u)

    def distribute_values(self, u):
        """Make a SOLUTION vector conforming: slaves <- weighted masters
        using the VALUE table, which keeps Dirichlet masters. Dirichlet rows
        are left untouched."""
        assert self._closed
        if not len(self.vslave):
            return u
        u = u.clone()
        self._expand(
            u, "vslave", "vmaster", "vweight", "_vseg_table", "vslave_unique", True
        )
        return u

    def set_identity(self, dst, src):
        """vmult tail: dst[constrained] = src[constrained]
        (navier_stokes_matrix.cc:247-256)."""
        if not len(self.constrained_dofs):
            return dst
        idx = self._t("constrained_dofs", dst)
        dst = dst.clone()
        dst[..., idx] = src[..., idx]
        return dst
