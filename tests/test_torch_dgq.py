"""TensorDGQ and P_k beyond p = 3 through the banded R3MG path, against
the JAX package on the CPU at f64.

The direct banded assembly computes a level's blocks with K3-K5 only for
the P_p basis at p 1-3 (``ops/sipg_kernels.kernel_blocks``); every other
basis takes the einsum branch with the handler's basis, as the JAX
package's ``assemble_sipg_banded_direct`` takes its XLA branch.  K1 and K2
run those levels' nb (8 and 27 for Q1 and Q2 in 3D, 35 for P_4) through
their runtime-nb build on a card, and their plain versions here.

Cases: Q1 on the flagship's hyper_cube(3, 8) R-tree hierarchy (lex,
trim 3: levels 8/64/512), Q2 and P_4 on hyper_cube(3, 4) (levels 8/64).
Each band equals the JAX package's ``use_pallas=False`` band to 1e-12
relative, whole and built by lane slab; the Q1 flagship with
``IMAJOR_MIN_P`` = 0 (every level on the plain K1/K2 at nb = 8) and the
P_4 one take the JAX package's CG iterations to solutions equal to 1e-9;
the Q1 system sharded at world size 1 on gloo (the fine slab on K1/K2
halo's plain versions at nb = 8), from the whole setup and shard-locally,
takes the unsharded no-FMG solve's iterations within one.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import polydeal_tpu as pd  # noqa: E402
from polydeal_tpu.agglomeration import RTreeAgglomerator  # noqa: E402
from polydeal_tpu.assembly.sipg import (  # noqa: E402
    assemble_rhs_direct,
    assemble_sipg_banded_direct,
    build_banded_groups,
)
from polydeal_tpu.solvers import (  # noqa: E402
    build_multigrid,
    build_rtree_hierarchy,
    detect_grid_shapes,
)
from polydeal_tpu_torch.assembly import sipg as tsipg  # noqa: E402
from polydeal_tpu_torch.models import sharded as tsharded  # noqa: E402
from polydeal_tpu_torch.models.flagship import (  # noqa: E402
    CHEBYSHEV_DEGREE,
    N_SMOOTH,
    SMOOTHING_RANGE,
    flagship_hierarchy,
    setup_flagship,
    solve_flagship,
)
from polydeal_tpu_torch.ops import _build  # noqa: E402
from polydeal_tpu_torch.ops.sipg_kernels import kernel_blocks  # noqa: E402
from polydeal_tpu_torch.parallel.banded import (  # noqa: E402
    ShardedBandedSystem,
)
from polydeal_tpu_torch.parallel.sharding import (  # noqa: E402
    init_group,
    leave_group,
)
from polydeal_tpu_torch.solvers import multigrid as tmg  # noqa: E402

CPU = torch.device("cpu")
# (family, degree, n): nb 8, 27 and 35
CASES = {"q1": ("dgq", 1, 8), "q2": ("dgq", 2, 4), "p4": ("dgp", 4, 4)}
NB = {"q1": 8, "q2": 27, "p4": 35}


def _close(a, b, tol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * np.abs(a).max()


@pytest.fixture(scope="module")
def jax_case():
    """The JAX package's flagship hierarchy of a case (R-tree, lex, trim
    3), its fine band by the einsum branch and rhs, and -- on request --
    its CG solve with R3MG as the port's flagship runs it (FMG, rtol
    1e-8); built once a case."""
    cache = {}

    def get(key, solve=False):
        if key not in cache:
            family, degree, n = CASES[key]
            mesh = pd.hyper_cube(3, n)
            agg = RTreeAgglomerator.build(mesh.cell_centers())
            lv0 = max(1, agg.n_levels - 1 - 3)
            handlers, parents = build_rtree_hierarchy(
                mesh, agg, list(range(lv0, agg.n_levels - 1)),
                degree=degree, family=family, relabel="lex")
            ah = handlers[-1]
            offs = tmg.band_offsets(ah)
            groups = build_banded_groups(ah, offs, jnp.float64)
            A0 = assemble_sipg_banded_direct(ah, groups, offsets=offs,
                                             use_pallas=False)
            u_ex = lambda x: jnp.prod(jnp.sin(jnp.pi * x), axis=-1)
            b = assemble_rhs_direct(
                ah, groups, lambda x: 3 * jnp.pi**2 * u_ex(x), u_ex)
            cache[key] = dict(handlers=handlers, parents=parents, A0=A0,
                              b=b, offsets=offs,
                              grid_shapes=detect_grid_shapes(handlers,
                                                             parents))
        c = cache[key]
        if solve and "x" not in c:
            mg = build_multigrid(
                c["handlers"], c["parents"], c["A0"], dtype=jnp.float64,
                grid_shapes=c["grid_shapes"],
                chebyshev_degree=CHEBYSHEV_DEGREE, n_smooth=N_SMOOTH,
                smoothing_range=SMOOTHING_RANGE, level_assembly="banded",
                coarse_solver="inv", fused_smoother=False)
            res = mg.solve_cg(c["b"], rtol=1e-8, maxiter=100, fmg=True)
            c.update(x=np.asarray(res.x), iterations=int(res.iterations))
        return c

    return get


def _port_fine(key):
    family, degree, n = CASES[key]
    handlers, _, _ = flagship_hierarchy(n, degree, "rtree", "lex", family)
    return handlers[-1]


def test_kernel_rule():
    """K3-K5 compute P_p blocks at p 1-3 in f32 and f64 only, and K5 alone
    at 2D p 4-5 (the JAX package's Pallas split there); TensorDGQ, P_0, 3D
    P_p at p >= 4 and 2D P_p at p >= 6 take the einsums."""
    for dim in (2, 3):
        for p in (1, 2, 3):
            for dt in (torch.float32, torch.float64):
                assert kernel_blocks("dgp", dim, p, dt) == {
                    "volume", "face", "boundary"}
        for p in (1, 2):
            assert not kernel_blocks("dgq", dim, p, torch.float32)
        assert not kernel_blocks("dgp", dim, 0, torch.float32)
    for p in (4, 5):
        for dt in (torch.float32, torch.float64):
            assert kernel_blocks("dgp", 2, p, dt) == {"boundary"}
        assert not kernel_blocks("dgp", 2, p, torch.bfloat16)
    for p in (4, 5, 6):
        for dt in (torch.float32, torch.float64):
            assert not kernel_blocks("dgp", 3, p, dt)
    for p in (6, 7):
        for dt in (torch.float32, torch.float64):
            assert not kernel_blocks("dgp", 2, p, dt)
    assert not kernel_blocks("dgp", 3, 1, torch.bfloat16)


@pytest.mark.parametrize("key", list(CASES))
def test_banded_direct_matches_jax(jax_case, key, monkeypatch):
    """The port's fine band (both layouts) equals the JAX package's einsum
    band, with no K3-K5 wrapper called: the rule sends these bases to the
    einsums before any launch."""
    ref = jax_case(key)
    ah = _port_fine(key)
    assert ah.n_basis == NB[key]
    offs = tmg.band_offsets(ah)
    assert np.array_equal(offs, ref["offsets"])

    def refuse(*a, **k):
        raise AssertionError("a K3-K5 wrapper was called")

    for name in ("volume_blocks", "face_group_blocks", "boundary_blocks"):
        monkeypatch.setattr(tsipg, name, refuse)
    groups = tsipg.build_banded_groups(ah, offs, torch.float64, device=CPU)
    A = tsipg.assemble_sipg_banded_direct(ah, groups, offs)
    _close(ref["A0"].data, A.data.numpy())
    Ai = tsipg.assemble_sipg_banded_direct(ah, groups, offs,
                                           layout="imajor")
    _close(np.asarray(ref["A0"].with_imajor().data_i), Ai.data_i.numpy())
    # an explicit basis equal to the handler's gives the same band
    B = tsipg.assemble_sipg_banded_direct(ah, groups, offs, basis=ah.basis)
    assert torch.equal(A.data, B.data)


@pytest.mark.parametrize("key", ["q1", "p4"])
def test_slab_bands_match_jax(jax_case, key):
    """The band built by two lane slabs (``build_banded_groups(lanes=)``)
    equals the JAX band's lanes of each slab."""
    ref = np.asarray(jax_case(key)["A0"].data)
    ah = _port_fine(key)
    offs = tmg.band_offsets(ah)
    per = ah.n_poly // 2
    for r in range(2):
        g = tsipg.build_banded_groups(ah, offs, torch.float64, device=CPU,
                                      lanes=(r * per, (r + 1) * per))
        As = tsipg.assemble_sipg_banded_direct(ah, g, offs)
        _close(ref[..., r * per:(r + 1) * per], As.data.numpy())


def test_dgq_flagship_matches_jax(jax_case, monkeypatch):
    """Q1 at n=8 with every level on the i-major copy: the whole V-cycle
    runs the plain versions of K1 and K2 at nb = 8 (a card launches their
    runtime-nb build there); JAX's iterations, x within 1e-9."""
    ref = jax_case("q1", solve=True)
    monkeypatch.setattr(tmg, "IMAJOR_MIN_P", 0)
    before = dict(_build.launches)
    fs = setup_flagship(n=8, family="dgq", device=CPU, dtype=torch.float64,
                        precond_dtype=None)
    assert fs.level_sizes == [8, 64, 512]
    assert all(e.data_i is not None and e.n_basis == 8 for e in fs.mg.ells)
    assert all(fs.mg._fused_ok(e, fs.b) for e in fs.mg.ells[1:])
    _close(np.asarray(ref["b"]), fs.b.numpy())
    res = solve_flagship(fs)
    assert res.iterations == ref["iterations"] == 19
    assert np.abs(res.x.numpy() - ref["x"]).max() <= 1e-9
    assert float(res.residual) <= 1e-8 * float(fs.b.norm())
    assert _build.launches == before  # CPU tensors: plain versions only


def test_p4_flagship_matches_jax(jax_case):
    """P_4 (nb = 35) at n=4: JAX's iterations, x within 1e-9."""
    ref = jax_case("p4", solve=True)
    fs = setup_flagship(n=4, degree=4, device=CPU, dtype=torch.float64,
                        precond_dtype=None)
    assert fs.handlers[-1].n_basis == 35
    res = solve_flagship(fs)
    assert res.iterations == ref["iterations"]
    assert np.abs(res.x.numpy() - ref["x"]).max() <= 1e-9


def test_dgq_sharded_world_size_one(tmp_path):
    """The Q1 n=8 system sharded at world size 1 on a gloo group, from the
    whole setup and shard-locally (the fine slab's tables and band through
    the einsums): within one iteration of the unsharded no-FMG solve, the
    shard-local system's iterations equal to the whole setup's."""
    fs = setup_flagship(n=8, family="dgq", device=CPU, dtype=torch.float64,
                        precond_dtype=None)
    ru = fs.mg.solve_cg(fs.b, rtol=1e-8, maxiter=100)
    group = init_group(0, 1, device=CPU,
                       store_path=os.path.join(tmp_path, "store"))
    try:
        ss = ShardedBandedSystem.from_multigrid(fs.mg, group)
        assert ss.levels[-1].nb == 8 and ss.levels[-1].T > 0
        x, k, res = ss.solve_cg(fs.b, rtol=1e-8, maxiter=100)
        sl = ShardedBandedSystem.setup_local(
            fs.handlers, fs.parents, group, device=CPU,
            grid_shapes=fs.grid_shapes, dtype=torch.float64,
            chebyshev_degree=CHEBYSHEV_DEGREE, n_smooth=N_SMOOTH,
            smoothing_range=SMOOTHING_RANGE, coarse_solver="inv",
            rhs=(tsharded._f_poisson, tsharded._u_exact))
        _close(fs.b.numpy(), sl.b_local.numpy())
        xl, kl, _ = sl.solve_cg(sl.b_local, rtol=1e-8, maxiter=100)
        del ss, sl
    finally:
        leave_group()
    assert abs(k - ru.iterations) <= 1
    assert res <= 1e-8 * float(fs.b.norm())
    assert np.abs(x.numpy() - ru.x.numpy()).max() <= 1e-7
    assert kl == k
    assert np.abs(xl.numpy() - x.numpy()).max() <= 1e-9
