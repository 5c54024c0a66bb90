"""Multi-field DG systems on (sub)domains of a polytopal mesh.

Counterpart of ``polydeal_tpu/fem/system.py`` (the reference's hp
FESystem/FE_Nothing machinery, examples/darcy_stokes.cc:600-608,
oseen.cc:475-478): each field (velocity, a pressure, ...) carries a scalar
basis shared by its ``n_components`` components, the sorted polytopes of
its subdomain and a contiguous slab of global dofs, polytope-major, then
component, then basis function.  A field inactive on a polytope has no
dofs there; restricting assembly to a field's domain is a numpy index
selection at setup.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["Field", "SystemSpace"]


@dataclass(frozen=True)
class Field:
    """One unknown field of a coupled system: local polytope k of its
    sorted ``polys`` owns dofs [offset + k block, offset + (k+1) block),
    block = n_components * basis.n_basis, components major."""

    name: str
    basis: object
    n_components: int
    polys: np.ndarray

    def __post_init__(self):
        p = np.asarray(self.polys, dtype=np.int64)
        if not (np.diff(p) > 0).all():
            raise ValueError("field polys must be sorted unique")
        object.__setattr__(self, "polys", p)

    @property
    def block(self) -> int:
        return self.n_components * self.basis.n_basis

    @property
    def n_polys(self) -> int:
        return self.polys.shape[0]

    @property
    def n_dofs(self) -> int:
        return self.n_polys * self.block


class SystemSpace:
    """Dof layout of a list of fields over one polytopal mesh: the global
    vector is concat(field_0 dofs, field_1 dofs, ...)."""

    def __init__(self, ah, fields: list[Field]):
        self.ah = ah
        self.fields = {f.name: f for f in fields}
        self._order = [f.name for f in fields]
        self._offsets = {}
        off = 0
        for f in fields:
            self._offsets[f.name] = off
            off += f.n_dofs
        self.n_dofs = off
        # global polytope id -> field-local polytope index (or -1)
        self._local = {}
        for f in fields:
            loc = np.full(ah.n_poly, -1, dtype=np.int64)
            loc[f.polys] = np.arange(f.n_polys)
            self._local[f.name] = loc

    def offset(self, name: str) -> int:
        return self._offsets[name]

    def dof_slice(self, name: str) -> slice:
        o = self._offsets[name]
        return slice(o, o + self.fields[name].n_dofs)

    def local_poly(self, name: str) -> np.ndarray:
        """[n_poly_global] -> field-local polytope index (-1 = inactive)."""
        return self._local[name]

    def unpack(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """A global vector's field slice as [n_polys, n_components,
        n_basis]."""
        f = self.fields[name]
        return x[self.dof_slice(name)].reshape(
            f.n_polys, f.n_components, f.basis.n_basis)

    def pack(self, parts: dict) -> torch.Tensor:
        """Per-field tensors (any shape, flattened) concatenated into a
        global vector, in field order."""
        return torch.cat([parts[name].reshape(-1) for name in self._order])
