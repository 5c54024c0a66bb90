"""Post-processing on torch tensors: error norms, field evaluation,
fine-grid interpolation.

Counterpart of ``polydeal_tpu/postprocess.py`` (the reference's
``compute_global_error`` and ``interpolate_to_fine_grid``,
poly_utils.h:708-1750): batched evaluations of the polytopal modal basis
at the fine cells' quadrature points, on the device of the field.
"""

from __future__ import annotations

import numpy as np
import torch

from polydeal_tpu_torch.assembly.sipg import VolumeTables, build_volume_tables
from polydeal_tpu_torch.handler import AgglomerationHandler

__all__ = [
    "evaluate_at_quadrature",
    "compute_global_error",
    "interpolate_to_fine_grid",
    "interpolate_field_to_fine_grid",
]


def _tables(ah, u, vol):
    """f64 tables on u's device, as the JAX package's default."""
    if vol is None:
        vol = build_volume_tables(ah, device=u.device)
    return vol


def evaluate_at_quadrature(ah: AgglomerationHandler, u: torch.Tensor,
                           vol: VolumeTables | None = None):
    """(u_h, grad u_h) at the composite quadrature points, per fine
    cell."""
    vol = _tables(ah, u, vol)
    c2p = torch.as_tensor(vol.cell2poly, dtype=torch.long, device=u.device)
    ub = u.reshape(ah.n_poly, ah.n_basis).to(vol.B.dtype)[c2p]  # [n_c, nb]
    vals = torch.einsum("cqi,ci->cq", vol.B, ub)
    grads = torch.einsum("cqid,ci->cqd", vol.G, ub)
    return vals, grads


def compute_global_error(
    ah: AgglomerationHandler,
    u: torch.Tensor,
    exact_fn,
    exact_grad_fn=None,
    vol: VolumeTables | None = None,
):
    """Global L2 error and (optionally) H1 seminorm error against an exact
    solution (reference poly_utils.h:1647-1750).  Returns (l2, h1semi) as
    0-dim tensors, h1semi None without a gradient; ``exact_fn`` maps real
    points [..., dim] to values [...], ``exact_grad_fn`` to [..., dim]."""
    vol = _tables(ah, u, vol)
    vals, grads = evaluate_at_quadrature(ah, u, vol)
    diff = vals - exact_fn(vol.x)
    l2 = torch.sqrt(torch.sum(vol.w * diff**2))
    h1 = None
    if exact_grad_fn is not None:
        gdiff = grads - exact_grad_fn(vol.x)
        h1 = torch.sqrt(torch.sum(vol.w * torch.sum(gdiff**2, dim=-1)))
    return l2, h1


def interpolate_to_fine_grid(
    ah: AgglomerationHandler,
    u: torch.Tensor,
    degree: int | None = None,
    family: str = "dgq",
    n_components: int = 1,
    basis=None,
):
    """Interpolate a polytopal DG field onto a DG space on the fine
    background mesh (reference poly_utils.h:1145-1458).  ``family='dgq'``:
    nodal values at Gauss-Lobatto points; ``'dgp'``: modal Legendre
    coefficients by per-cell L2 projection.  Both are exact.
    ``n_components > 1`` reads u as [n_poly, n_components, n_basis]; the
    result is [n_cells, n_components, n_fine_basis] (squeezed for
    scalars).  ``basis`` overrides the source basis (default the
    handler's)."""
    from polydeal_tpu_torch.fem.basis import _gauss_lobatto_01, make_basis
    from polydeal_tpu_torch.fem.quadrature import tensor_gauss

    basis = basis or ah.basis
    if degree is None:
        degree = basis.degree
    fine = make_basis(family, ah.dim, degree)
    dt, dev = torch.float64, u.device
    if family == "dgq":
        nodes1d = _gauss_lobatto_01(degree + 1)
        E = fine.exponents
        unit_pts = np.stack([nodes1d[E[:, d]] for d in range(ah.dim)],
                            axis=-1)
        W = None  # pure interpolation at the nodes
    elif family == "dgp":
        # exact L2 projection on the unit cell: with the orthonormal
        # Legendre basis the projector is B_fine^T diag(w)
        unit_pts, wts = tensor_gauss(ah.dim, degree + 1)
        W = (fine.eval(torch.as_tensor(unit_pts, dtype=dt, device=dev))
             * torch.as_tensor(wts, dtype=dt, device=dev)[:, None])
    else:
        raise NotImplementedError(f"unsupported target family {family}")
    real = ah.mesh.map_points(unit_pts)  # [n_c, n_pts, dim]
    unit_in_poly = ah.to_unit(ah.cell2poly, real)
    B = basis.eval(torch.as_tensor(unit_in_poly, dtype=dt, device=dev))
    c2p = torch.as_tensor(ah.cell2poly, dtype=torch.long, device=dev)
    ub = u.to(dt).reshape(ah.n_poly, n_components, basis.n_basis)[c2p]
    vals = torch.einsum("cni,cdi->cdn", B, ub)  # [n_c, comp, n_pts]
    if W is not None:
        vals = torch.einsum("cdq,qj->cdj", vals, W)
    return vals[:, 0] if n_components == 1 else vals


def interpolate_field_to_fine_grid(space, ah, x, name: str,
                                   degree: int | None = None,
                                   family: str = "dgq"):
    """One field of a multi-field solution on the fine grid: [n_cells,
    n_components, n_fine_basis], zero outside the field's subdomain.
    ``space`` is a system space: ``space.fields[name]`` has ``polys``,
    ``n_components`` and ``basis``, and ``space.unpack(x, name)`` gives the
    field's [n_polys_f, comp, nb] blocks."""
    f = space.fields[name]
    ub = space.unpack(x, name)
    full = ub.new_zeros((ah.n_poly,) + tuple(ub.shape[1:]))
    full[torch.as_tensor(np.asarray(f.polys), device=ub.device)] = ub
    out = interpolate_to_fine_grid(ah, full.reshape(-1), degree=degree,
                                   family=family,
                                   n_components=f.n_components,
                                   basis=f.basis)
    return out if f.n_components > 1 else out[:, None, :]
