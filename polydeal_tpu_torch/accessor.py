"""Polytope accessor/iterator — API parity with the reference.

A jax-free copy of ``polydeal_tpu/accessor.py`` (``tests/test_torch_io.py``
runs both on the same handlers).

Mirrors ``AgglomerationAccessor`` / ``AgglomerationIterator`` (reference
include/agglomeration_accessor.h:324-841, agglomeration_iterator.h:25-155)
as lightweight views over the handler's arrays.  These are *host-side
conveniences* for inspection, tests, and setup logic — the compute path
never iterates polytopes (it consumes the arrays directly).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["Polytope", "polytope_iterators"]


@dataclass(frozen=True)
class Polytope:
    """View of one polytope (reference AgglomerationAccessor)."""

    handler: object
    index: int

    def id(self) -> int:
        return self.index

    def n_faces(self) -> int:
        return self.handler.n_faces(self.index)

    def neighbor(self, f: int) -> "Polytope | None":
        """Neighbor across face f, or None at the boundary
        (reference accessor:335-422)."""
        nb = self.handler.poly_faces.neighbor(self.index, f)
        return None if nb < 0 else Polytope(self.handler, int(nb))

    def at_boundary(self, f: int | None = None) -> bool:
        pf = self.handler.poly_faces
        if f is not None:
            return pf.at_boundary(self.index, f)
        return any(pf.at_boundary(self.index, k)
                   for k in range(self.n_faces()))

    def neighbor_of_agglomerated_neighbor(self, f: int) -> int:
        """Index of the face of neighbor(f) that points back here
        (reference accessor:426-481)."""
        nb = self.handler.poly_faces.neighbor(self.index, f)
        if nb < 0:
            raise ValueError("boundary face has no neighbor")
        back = self.handler.poly_faces.neighbors[nb]
        return int(np.where(back == self.index)[0][0])

    def diameter(self) -> float:
        return float(self.handler.diameters[self.index])

    def volume(self) -> float:
        """Bounding-box volume (reference accessor:618-632 returns the
        bbox volume for master cells)."""
        return float(self.handler.volumes[self.index])

    def measure(self) -> float:
        """True polytope measure from the composite quadrature."""
        return float(self.handler.vol_weights[self.index].sum())

    def get_bounding_box(self):
        return (self.handler.bbox_lo[self.index],
                self.handler.bbox_hi[self.index])

    def get_dof_indices(self) -> np.ndarray:
        return self.handler.dof_indices(self.index)

    def cells(self) -> np.ndarray:
        """Fine cells agglomerated into this polytope (master + slaves)."""
        row = self.handler.poly2cells[self.index]
        return row[row >= 0]

    def n_background_cells(self) -> int:
        return int(self.handler.poly_n_cells[self.index])

    def children(self, parent_map: np.ndarray) -> np.ndarray:
        """Finer-level polytope ids given a parent map from the R-tree
        hierarchy (reference accessor:801-808)."""
        return np.where(np.asarray(parent_map) == self.index)[0]


def polytope_iterators(handler):
    """Iterate all polytopes (reference polytope_iterators(),
    agglomeration_handler.h:341-352)."""
    for p in range(handler.n_poly):
        yield Polytope(handler, p)
