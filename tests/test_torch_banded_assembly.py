"""The port's other banded assemblies and ``chained_cost`` against the JAX
package's.

``assemble_sipg_banded`` (standard tables, one segment sum into the band
slots), ``assemble_sipg_banded_t`` (entity-last tables of
``transpose_tables``) and ``assemble_sipg_banded_gather`` (the padded
gather maps of ``banded_gather_maps``) are plain torch, as the JAX
package's are XLA: held to the JAX band in 2D and 3D at p=1 and p=2 on the
R-tree fine level, f64, within 1e-12 of its largest entry, and to the
port's direct assembly (K3-K5's plain versions).  The host index arrays
(``transpose_tables``' static part, ``banded_gather_maps``) equal the JAX
package's exactly, the transposed tables within 1e-13.  ``chained_cost``
is held as ``tests/test_postprocess_io.py`` holds the JAX one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import polydeal_tpu as pd  # noqa: E402
from polydeal_tpu.agglomeration import (  # noqa: E402
    RTreeAgglomerator as JRTree,
)
from polydeal_tpu.assembly import sipg as jsipg  # noqa: E402
from polydeal_tpu.solvers import build_rtree_hierarchy as j_rtree  # noqa
from polydeal_tpu_torch.agglomeration import RTreeAgglomerator  # noqa: E402
from polydeal_tpu_torch.assembly import sipg  # noqa: E402
from polydeal_tpu_torch.mesh import hyper_cube  # noqa: E402
from polydeal_tpu_torch.solvers import multigrid  # noqa: E402
from polydeal_tpu_torch.utils.timer import chained_cost  # noqa: E402

CPU = torch.device("cpu")
SHAPES = [(2, 8, 1), (2, 8, 2), (3, 4, 1), (3, 4, 2)]


def _fine(dim, n, p):
    """The fine level of the R-tree hierarchy on hyper_cube(dim, n) in both
    packages: (JAX handler, port handler, band offsets)."""
    m = pd.hyper_cube(dim, n)
    agg = JRTree.build(m.cell_centers())
    jh, _ = j_rtree(m, agg, list(range(1, agg.n_levels - 1)), degree=p)
    m2 = hyper_cube(dim, n)
    agg2 = RTreeAgglomerator.build(m2.cell_centers())
    th, _ = multigrid.build_rtree_hierarchy(
        m2, agg2, list(range(1, agg2.n_levels - 1)), degree=p)
    return jh[-1], th[-1], multigrid.band_offsets(th[-1])


@pytest.fixture(scope="module", params=SHAPES,
                ids=lambda s: "dim{}-n{}-p{}".format(*s))
def level(request):
    """Per shape: the handlers, offsets, both packages' entity-last tables
    and the JAX bands of the three assemblies."""
    jah, ah, offs = _fine(*request.param)
    jvol = jsipg.build_volume_tables(jah)
    jfaces = jsipg.build_face_tables(jah)
    jt = jsipg.transpose_tables(jvol, jfaces)
    jbands = dict(
        plain=jsipg.assemble_sipg_banded(jah, offsets=offs),
        t=jsipg.assemble_sipg_banded_t(jah, *jt, offsets=offs),
        gather=jsipg.assemble_sipg_banded_gather(jah, *jt, offsets=offs))
    vol = sipg.build_volume_tables(ah, device=CPU)
    faces = sipg.build_face_tables(ah, device=CPU)
    tt = sipg.transpose_tables(vol, faces)
    return dict(jah=jah, ah=ah, offs=offs, jt=jt, tt=tt,
                jbands={k: np.asarray(v.data) for k, v in jbands.items()},
                faces=(vol, faces))


def _close(got, ref, tol=1e-12):
    return np.abs(np.asarray(got) - ref).max() <= tol * np.abs(ref).max()


def test_assemble_sipg_banded(level):
    ah, offs = level["ah"], level["offs"]
    vol, faces = level["faces"]
    A = sipg.assemble_sipg_banded(ah, offsets=offs, vol=vol, faces=faces,
                                  device=CPU)
    assert np.array_equal(A.offsets, offs)
    assert _close(A.data.numpy(), level["jbands"]["plain"])
    # the mesh's own offsets by default
    A0 = sipg.assemble_sipg_banded(ah, device=CPU)
    assert np.array_equal(A0.offsets, offs)
    assert torch.equal(A0.data, A.data)
    # the direct assembly (K3-K5's plain versions) computes the same band
    D = sipg.assemble_sipg_banded_direct(
        ah, sipg.build_banded_groups(ah, offs, device=CPU), offs)
    assert _close(A.data.numpy(), D.data.numpy())


def test_assemble_sipg_banded_t(level):
    ah, offs = level["ah"], level["offs"]
    A = sipg.assemble_sipg_banded_t(ah, *level["tt"], offsets=offs)
    assert _close(A.data.numpy(), level["jbands"]["t"])


def test_assemble_sipg_banded_gather(level):
    ah, offs = level["ah"], level["offs"]
    A = sipg.assemble_sipg_banded_gather(ah, *level["tt"], offsets=offs)
    assert _close(A.data.numpy(), level["jbands"]["gather"])
    # the maps passed in give the same band
    maps = sipg.banded_gather_maps(ah, level["tt"][3], offs)
    A2 = sipg.assemble_sipg_banded_gather(ah, *level["tt"], offsets=offs,
                                          maps=maps)
    assert torch.equal(A2.data, A.data)


def test_transpose_tables_and_gather_maps(level):
    """The host index arrays equal the JAX package's exactly; the
    entity-last tables agree within 1e-13."""
    jvol_t, jfi_t, jfb_t, jst = level["jt"]
    vol_t, fi_t, fb_t, st = level["tt"]
    assert set(st) == set(jst)
    for k in st:
        assert np.array_equal(st[k], jst[k])
    for mine, theirs in ((vol_t, jvol_t), (fi_t, jfi_t), (fb_t, jfb_t)):
        assert set(mine) == set(theirs)
        for k, v in mine.items():
            ref = np.asarray(theirs[k])
            assert tuple(v.shape) == ref.shape
            assert np.abs(v.numpy() - ref).max() <= 1e-13 * max(
                np.abs(ref).max(), 1.0)
    maps = sipg.banded_gather_maps(level["ah"], st, level["offs"])
    jmaps = jsipg.banded_gather_maps(level["jah"], jst, level["offs"])
    assert len(maps) == len(jmaps)
    for (idx, mask), (jidx, jmask) in zip(maps, jmaps):
        assert np.array_equal(idx, np.asarray(jidx))
        assert np.array_equal(mask, np.asarray(jmask))


def test_assemble_sipg_banded_without_boundary():
    """``include_boundary=False`` drops the Nitsche terms, as the JAX
    package's does."""
    jah, ah, offs = _fine(2, 8, 1)
    ref = np.asarray(jsipg.assemble_sipg_banded(
        jah, offsets=offs, include_boundary=False).data)
    A = sipg.assemble_sipg_banded(ah, offsets=offs, include_boundary=False,
                                  device=CPU)
    assert _close(A.data.numpy(), ref)


def test_chained_cost_methodology():
    """chained_cost returns the per-application slope, free of the fixed
    cost of one call."""
    x0 = torch.ones((64, 64))
    c = chained_cost(lambda x: x @ x * 1e-3 + x, x0, n_small=4, n_large=32,
                     reps=2)
    assert c > 0.0
    assert c < 0.05  # a 64x64 matmul is far under 50 ms a step


def test_chained_cost_operands():
    """Loop-invariant operands are passed through to every step."""
    calls = []

    def step(x, a, b):
        calls.append(1)
        return x * a + b

    x0 = torch.zeros(8, dtype=torch.float64)
    c = chained_cost(step, x0, torch.tensor(0.5, dtype=torch.float64),
                     torch.ones(8, dtype=torch.float64), n_small=2,
                     n_large=6, reps=1)
    assert np.isfinite(c)
    # warm-up chain, then per length: a warm run and one timed run
    assert len(calls) == 6 + 2 * (2 + 6)
