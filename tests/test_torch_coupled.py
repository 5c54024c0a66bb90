"""The port's coupled models against the JAX package's, at f64 on the
CPU: Stokes' exact linear flow (1e-12); darcy_stokes' pure-Stokes,
pure-Darcy and BJS-interface exactness (1e-10); darcy_stokes at n = 8
dense (errors to 1e-8 relative), block-Jacobi GMRES and MG-GMRES (JAX's
iteration counts, x within 1e-8 of JAX's); the coarse domain ids read
from ``domain_id`` (a split that is not y = 1/2); oseen dense and MG at
n = 8 and ``run_curved`` at n = 16 (the JAX curved test's smallest size);
the piston at the JAX test's size (the same iterations, u_min/u_max to
1e-8); an hp solve (1e-10).  Each JAX model is built once per file."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import polydeal_tpu as pd  # noqa: E402
import polydeal_tpu_torch as tpd  # noqa: E402
from polydeal_tpu.agglomeration import RTreeAgglomerator  # noqa: E402
from polydeal_tpu.fem import hp as jhp  # noqa: E402
from polydeal_tpu.models import darcy_stokes as jds  # noqa: E402
from polydeal_tpu.models import oseen as jos  # noqa: E402
from polydeal_tpu.models import piston as jpiston  # noqa: E402
from polydeal_tpu_torch.agglomeration import (  # noqa: E402
    RTreeAgglomerator as TRTreeAgglomerator,
    agglomerate_by_partition,
)
from polydeal_tpu_torch.fem import hp as thp  # noqa: E402
from polydeal_tpu_torch.handler import AgglomerationHandler  # noqa: E402
from polydeal_tpu_torch.models import darcy_stokes as tds  # noqa: E402
from polydeal_tpu_torch.models import oseen as tos  # noqa: E402
from polydeal_tpu_torch.models import piston as tpiston  # noqa: E402
from polydeal_tpu_torch.models import stokes as tstokes  # noqa: E402

CPU = torch.device("cpu")
TOL = 1e-8


def _rel(a, b):
    return abs(a - b) / abs(a)


def _xclose(xa, xb, tol=TOL):
    xa = np.asarray(xa)
    assert np.abs(xa - xb.numpy()).max() <= tol * np.abs(xa).max()


# ---------------------------------------------------------------- Stokes
def test_stokes_exact_linear_flow():
    """u = (y, x), p = 0: reproduced to round-off (the JAX test's
    configuration: n = 4, p = 1, 4 agglomerates)."""
    m = tpd.hyper_cube(2, 4)
    c2p = agglomerate_by_partition(m.cell_centers(), m.neighbors, 4)
    ah = AgglomerationHandler(m, c2p, degree=1)
    u_ex = lambda x: torch.stack([x[..., 1], x[..., 0]], dim=-1)
    f = lambda x: torch.zeros_like(x)
    U, P, meta = tstokes.solve_stokes_dense(ah, f, u_ex, device=CPU)
    assert tstokes.velocity_errors(ah, meta, U, u_ex) < 1e-12
    assert tstokes.divergence_norm(ah, meta, U) < 1e-12
    assert tstokes.pressure_errors(ah, meta, P,
                                   lambda x: torch.zeros_like(x[..., 0])) \
        < 1e-12


# ---------------------------------------------------------- darcy_stokes
def _setup(n=8, block=2, all_domain=None, degree=2):
    mesh = tpd.hyper_cube(2, n)
    centers = mesh.cell_centers()
    m = n // block
    bx = np.minimum((centers[:, 0] * m).astype(int), m - 1)
    by = np.minimum((centers[:, 1] * m).astype(int), m - 1)
    c2p = bx * m + by
    ah = AgglomerationHandler(mesh, c2p, degree=degree)
    pcy = np.zeros(ah.n_poly)
    np.add.at(pcy, c2p, centers[:, 1])
    pcy /= np.bincount(c2p)
    if all_domain is None:
        domain_id = (pcy < 0.5).astype(int)
    else:
        domain_id = np.full(ah.n_poly, all_domain)
    return ah, domain_id


def _field_err(sys_, x, name, exact):
    sp, meta = sys_.space, sys_.meta
    vol = meta["vol_v" if name == "u"
               else ("vol_pS" if name == "pS" else "vol_pD")]
    cells = meta["cells_s"] if name in ("u", "pS") else meta["cells_d"]
    rows = meta["rows_s"] if name in ("u", "pS") else meta["rows_d"]
    C = sp.unpack(x, name)[torch.as_tensor(rows)]
    c = torch.as_tensor(cells)
    vals = torch.einsum("cqi,cdi->cqd", vol.B[c], C)
    ex = exact(vol.x[c])
    if ex.dim() == vals.dim() - 1:
        ex = ex[..., None]
    return float(torch.sqrt(torch.einsum("cq,cqd->", vol.w[c],
                                         (vals - ex) ** 2)))


_zero_s = lambda x: torch.zeros_like(x)
_zero = lambda x: torch.zeros_like(x[..., 0])
_zero_n = lambda x, n: torch.zeros_like(x[..., 0])


def test_darcy_stokes_pure_stokes_exactness():
    ah, dom = _setup(all_domain=0)
    NU = tds.NU
    u_ex = lambda x: torch.stack([x[..., 0] ** 2, -2 * x[..., 0] * x[..., 1]],
                                 dim=-1)
    p_ex = lambda x: x[..., 0] - 0.5
    f_S = lambda x: torch.stack([-2 * NU + torch.ones_like(x[..., 0]),
                                 torch.zeros_like(x[..., 0])], dim=-1)
    s = tds.build_darcy_stokes(ah, dom, u_dirichlet=u_ex, f_S=f_S, f_D=_zero,
                               g_D=_zero_n, device=CPU)
    x = tds.solve_darcy_stokes_dense(s)
    assert _field_err(s, x, "u", u_ex) < 1e-10
    assert _field_err(s, x, "pS", p_ex) < 1e-10


def test_darcy_stokes_pure_darcy_exactness():
    ah, dom = _setup(all_domain=1)
    pD_ex = lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - 2.0 / 3.0
    gD = lambda x, n: -(2 * x[..., 0] * n[..., 0] + 2 * x[..., 1] * n[..., 1])
    s = tds.build_darcy_stokes(
        ah, dom, degree_pD=2, u_dirichlet=_zero_s, f_S=_zero_s,
        f_D=lambda x: torch.full_like(x[..., 0], -4.0), g_D=gD, device=CPU)
    x = tds.solve_darcy_stokes_dense(s)
    assert _field_err(s, x, "pD", pD_ex) < 1e-10


def test_darcy_stokes_bjs_interface_exactness():
    G = math.sqrt(tds.NU) / 0.5
    ah, dom = _setup()
    u_ex = lambda x: torch.stack([x[..., 1] - 0.5 + G,
                                  torch.ones_like(x[..., 0])], dim=-1)
    s = tds.build_darcy_stokes(ah, dom, u_dirichlet=u_ex, f_S=_zero_s,
                               f_D=_zero, g_D=lambda x, n: n[..., 1],
                               device=CPU)
    x = tds.solve_darcy_stokes_dense(s)
    mean_ex = -0.25 - 0.125
    assert _field_err(s, x, "u", u_ex) < 1e-10
    assert _field_err(s, x, "pS",
                      lambda xx: torch.full_like(xx[..., 0], -0.5 - mean_ex)
                      ) < 1e-10
    assert _field_err(s, x, "pD", lambda xx: -xx[..., 1] - mean_ex) < 1e-10


@pytest.fixture(scope="module")
def darcy8():
    sj, xj = jds.run(8, 2)
    st, xt = tds.run(8, 2, device=CPU)
    return sj, xj, st, xt


def test_darcy_stokes_dense_matches_jax(darcy8):
    sj, xj, st, xt = darcy8
    ea, eb = jds.errors(sj, xj), tds.errors(st, xt)
    assert all(_rel(a, b) <= TOL for a, b in zip(ea, eb)), (ea, eb)
    _xclose(xj, xt, 1e-10)


def test_darcy_stokes_iterative_matches_jax(darcy8):
    sj, xj, st, xt = darcy8
    ra = jds.solve_darcy_stokes_iterative(sj, rtol=1e-11)
    rb = tds.solve_darcy_stokes_iterative(st, rtol=1e-11)
    assert rb.iterations == int(ra.iterations)
    _xclose(ra.x, rb.x)
    _xclose(xj, rb.x)


def test_darcy_stokes_mg_matches_jax(darcy8):
    sj, xj, st, xt = darcy8
    ra = jds.solve_darcy_stokes_mg(sj, pd.hyper_cube(2, 8), 8, 2, rtol=1e-11)
    rb = tds.solve_darcy_stokes_mg(st, tpd.hyper_cube(2, 8), 8, 2,
                                   rtol=1e-11)
    assert rb.iterations == int(ra.iterations) == 49
    _xclose(ra.x, rb.x)
    _xclose(xj, rb.x)


def test_coarse_domain_ids_read_domain_id():
    """The coarse levels' subdomains come from the system's domain_id
    through the parents: on run()'s y = 1/2 split they equal the
    centroid rule of the JAX package, on a vertical split x < 1/2 they
    follow it (where a y rule would not), and a split the hierarchy cuts
    through raises.  MG-GMRES on the vertical split reaches the dense
    solution."""
    n, block = 8, 2
    mesh = tpd.hyper_cube(2, n)
    hs, ps = tds.block_hierarchy(mesh, n, block, 2)
    cen = mesh.cell_centers()

    def centroid(h, d):
        c = np.zeros(h.n_poly)
        np.add.at(c, h.cell2poly, cen[:, d])
        return c / np.bincount(h.cell2poly)

    doms = tds.coarse_domain_ids((centroid(hs[-1], 1) < 0.5).astype(int), ps)
    for h, d in zip(hs, doms):
        assert np.array_equal(d, (centroid(h, 1) < 0.5).astype(int))
    domx = (centroid(hs[-1], 0) < 0.5).astype(int)
    doms = tds.coarse_domain_ids(domx, ps)
    for h, d in zip(hs, doms):
        assert np.array_equal(d, (centroid(h, 0) < 0.5).astype(int))
        assert not np.array_equal(d, (centroid(h, 1) < 0.5).astype(int))
    with pytest.raises(ValueError):
        tds.coarse_domain_ids((centroid(hs[-1], 1) < 0.25).astype(int), ps)

    s = tds.build_darcy_stokes(hs[-1], domx, device=CPU)
    xd = tds.solve_darcy_stokes_dense(s)
    r = tds.solve_darcy_stokes_mg(s, mesh, n, block, rtol=1e-11)
    assert r.iterations < 200
    assert float((r.x - xd).abs().max()) <= 1e-8 * float(xd.abs().max())


# ----------------------------------------------------------------- oseen
@pytest.fixture(scope="module")
def oseen8():
    n = 8
    ja = jos.run(n, 2)
    tb = tos.run(n, 2, device=CPU)
    return ja, tb


def test_oseen_dense_matches_jax(oseen8):
    (sa, xa, ma), (sb, xb, mb) = oseen8
    ea, eb = jos.oseen_errors(sa, xa, ma), tos.oseen_errors(sb, xb, mb)
    assert all(_rel(a, b) <= TOL for a, b in zip(ea, eb)), (ea, eb)
    _xclose(xa, xb, 1e-10)


@pytest.mark.parametrize("structure", ["diag", "tri"])
def test_oseen_mg_matches_jax(oseen8, structure):
    """MG-GMRES at n = 8 (JAX's docstring: 70 iterations with 'diag')."""
    (sa, xa, ma), (sb, xb, mb) = oseen8
    n = 8
    from polydeal_tpu.mesh.fine_mesh import hyper_rectangle

    mesh_j = hyper_rectangle(2, [n, n], lo=[-0.5, 0.0], hi=[1.5, 2.0])
    _, opa, rhsa, _ = jos.build_oseen(sa.ah, ma["domain_id"])
    ra = jos.solve_oseen_mg(sa, opa, rhsa, ma, mesh_j, n, 2, rtol=1e-11,
                            structure=structure)
    opb, rhsb = mb["system"]
    rb = tos.solve_oseen_mg(sb, opb, rhsb, mb, tos._rectangle(n), n, 2,
                            rtol=1e-11, structure=structure)
    if structure == "diag":
        assert rb.iterations == int(ra.iterations) == 70
    else:
        # 'tri' (the JAX package's documented negative result) sits where
        # rounding moves its count: the JAX package itself takes 75
        # iterations under this suite's XLA -O0 and 77 at XLA's default
        # optimisation level, where the port takes 77; held within 3
        assert abs(rb.iterations - int(ra.iterations)) <= 3
    _xclose(ra.x, rb.x)
    _xclose(xb, rb.x)


def test_oseen_run_curved_matches_jax():
    sa, xa, ma = jos.run_curved(16, 2)
    sb, xb, mb = tos.run_curved(16, 2, device=CPU)
    assert np.array_equal(ma["domain_id"], mb["domain_id"])
    ea, eb = jos.oseen_errors(sa, xa, ma), tos.oseen_errors(sb, xb, mb)
    assert all(_rel(a, b) <= TOL for a, b in zip(ea, eb)), (ea, eb)


# ---------------------------------------------------------------- piston
def test_piston_matches_jax():
    a, _ = jpiston.solve_piston(n=10, degree=1, rtol=1e-8, verbose=False)
    b, _ = tpiston.solve_piston(n=10, degree=1, rtol=1e-8, verbose=False,
                                device=CPU)
    for key in ("n_cells", "n_poly", "n_dofs", "iterations"):
        assert a[key] == b[key], key
    assert abs(a["u_min"] - b["u_min"]) <= 1e-8
    assert abs(a["u_max"] - b["u_max"]) <= 1e-8
    assert -0.05 <= b["u_min"] and b["u_max"] <= 1.05


# -------------------------------------------------------------------- hp
def test_hp_poisson_matches_jax():
    """Two degree buckets (p = 1 left, 2 right) on an R-tree
    agglomeration: the JAX test's configuration with a quadratic
    solution; the same solution to 1e-10, and a linear one exact."""
    n = 8
    mj, mt = pd.hyper_cube(2, n), tpd.hyper_cube(2, n)
    c2p = RTreeAgglomerator.build(mj.cell_centers()).extract_agglomerates(2)
    assert np.array_equal(
        c2p, TRTreeAgglomerator.build(mt.cell_centers())
        .extract_agglomerates(2))
    aj = pd.AgglomerationHandler(mj, c2p, degree=1, n_quad=3)
    at = AgglomerationHandler(mt, c2p, degree=1, n_quad=3)
    cx = np.zeros(at.n_poly)
    np.add.at(cx, c2p, mt.cell_centers()[:, 0])
    cx /= np.bincount(c2p)
    degrees = np.where(cx < 0.5, 1, 2)
    ja = jhp.build_hp_poisson(
        aj, degrees, f_fn=lambda x: jnp.full(x.shape[:-1], -2.0),
        g_fn=lambda x: x[..., 0] ** 2 + x[..., 1])
    tb = thp.build_hp_poisson(
        at, degrees, f_fn=lambda x: torch.full_like(x[..., 0], -2.0),
        g_fn=lambda x: x[..., 0] ** 2 + x[..., 1], device=CPU)
    xa = jhp.solve_hp_dense(*ja)
    xb = thp.solve_hp_dense(*tb)
    _xclose(xa, xb, 1e-10)
    u = lambda x: x[..., 0] ** 2 + x[..., 1]
    assert _rel(jhp.hp_l2_error(aj, ja[0], degrees, xa, u),
                thp.hp_l2_error(at, tb[0], degrees, xb, u)) <= TOL
    fa = jhp.interpolate_hp_to_fine_grid(ja[0], aj, xa)
    fb = thp.interpolate_hp_to_fine_grid(tb[0], at, xb)
    _xclose(fa, fb, 1e-10)
    lin = lambda x: 1.0 + 2 * x[..., 0] - x[..., 1]
    sp, op, rhs = thp.build_hp_poisson(
        at, degrees, f_fn=lambda x: torch.zeros_like(x[..., 0]), g_fn=lin,
        device=CPU)
    x = thp.solve_hp_dense(sp, op, rhs)
    assert thp.hp_l2_error(at, sp, degrees, x, lin) < 1e-11
    with pytest.raises(ValueError):
        thp.build_hp_poisson(at, np.full(at.n_poly, 3), f_fn=lin,
                             device=CPU)
