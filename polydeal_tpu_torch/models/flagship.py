"""The flagship solve: 3D SIPG Poisson on an R-tree hierarchy, R3MG-
preconditioned CG.

Counterpart of ``bench_poisson("rtree", ...)`` in the repo's ``bench.py``,
without its timing harness.  Defaults are the flagship configuration:
p=1 on ``hyper_cube(3, 64)`` (262,144 cells, 1,048,576 DoF), an R-tree
hierarchy with the ``lex`` relabel trimmed to the 3 extraction levels
below the fine DG level (grid-reshape transfers where detected), the fine
band assembled directly, degree-5 Chebyshev smoothing with one sweep on
bf16 band copies, an explicit-inverse coarse solve, and CG to rtol 1e-8
from a full-multigrid start.

``hierarchy="structured"`` is ``bench_poisson("structured", ...)``'s arm:
lexicographic blocks of the grid (``multigrid.build_structured_hierarchy``)
from side ``max(2, n >> TRIM)`` up, so levels 512/4096/32768/262144 at
n=64, 7 band offsets on every level, grid-reshape transfers, nothing
packed.  Its levels are numbered lexicographically by construction, so
its ``relabel`` is ``"lex"`` and any other raises.  It is also the hierarchy that
``bench.py``'s ``bench_sharded`` shards (``models/sharded.py``).

``relabel=None`` is ``bench.py``'s ``BENCH_RELABEL=none`` arm: every level
keeps the R-tree's leaf-rank numbering, so the fine band has many offsets
(37 at n=64) while a lane touches at most 7.  Every level but the
coarsest with at least ``multigrid.PACK_MIN_P`` polytopes is then packed
(``sparse.BlockPacked``; one rule on every device,
``multigrid.level_pack_plan``), the fine one assembled straight into the
packed format, and K6/K7 serve those levels, each keeping its f32 band
for smoothing (no bf16 copy).

Usage::

    fs = setup_flagship(n=64, device=torch.device("cuda"))
    res = solve_flagship(fs)
    fs = setup_flagship(n=64, relabel=None, device=torch.device("cuda"))
    fs = setup_flagship(n=64, hierarchy="structured",
                        device=torch.device("cuda"))

On a CUDA device the kernel library is built or loaded, and CUDA, cuBLAS
and cuSOLVER initialised, before the first setup clock starts
(``ops/_build.prepare_device``); ``setup_phases`` reports those seconds as
``kernel_load`` and ``cuda_init``, apart from the phases.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from polydeal_tpu_torch.agglomeration.rtree import RTreeAgglomerator
from polydeal_tpu_torch.assembly.sipg import (
    assemble_rhs_direct,
    assemble_sipg_banded_direct,
    build_banded_groups,
)
from polydeal_tpu_torch.mesh.fine_mesh import hyper_cube
from polydeal_tpu_torch.ops import _build
from polydeal_tpu_torch.solvers import multigrid
from polydeal_tpu_torch.solvers.cg import CGResult
from polydeal_tpu_torch.sparse import BlockPacked

__all__ = ["Flagship", "setup_flagship", "solve_flagship"]

# the flagship configuration (bench.py's defaults)
TRIM = 3  # extraction levels kept below the fine DG level
CHEBYSHEV_DEGREE = 5
N_SMOOTH = 1
SMOOTHING_RANGE = 20.0


@dataclass
class Flagship:
    handlers: list
    mg: multigrid.Multigrid
    b: torch.Tensor  # flat fine-level rhs
    band_offsets: np.ndarray
    grid_shapes: list | None
    # seconds of the phases hierarchy, groups (and the fine pack plan),
    # assemble0 and mg_setup; and, before them and in none of them,
    # kernel_load and cuda_init (0.0 off CUDA)
    setup_phases: dict
    relabel: str | None  # "lex", or None for the leaf-rank numbering
    format: str  # the fine level's: "packed" or "banded"
    hierarchy: str = "rtree"  # or "structured"

    @property
    def n_dofs(self) -> int:
        return self.handlers[-1].n_dofs

    @property
    def level_sizes(self) -> list:
        return [h.n_poly for h in self.handlers]


def setup_flagship(
    n: int = 64,
    degree: int = 1,
    *,
    device: torch.device,
    dtype=torch.float32,
    precond_dtype=torch.bfloat16,
    coarse_solver: str = "inv",
    relabel: str | None = "lex",
    hierarchy: str = "rtree",
) -> Flagship:
    """Build the hierarchy (``"rtree"``, or ``"structured"``), the tables,
    the fine band, the rhs and the multigrid on ``device``.  Every level is
    packed or banded by :func:`multigrid.level_pack_plan`; the fine one is
    assembled straight into its format.

    Float32 products stay full float32: TF32 would corrupt the f32 einsum
    assembly and the transfers, so it is switched off here for the
    process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    first_use = _build.prepare_device(device)
    dim = 3
    t0 = time.perf_counter()
    mesh = hyper_cube(dim, n)
    if hierarchy == "structured":
        if relabel != "lex":
            raise ValueError("the structured hierarchy is numbered "
                             f"lexicographically: relabel {relabel!r} is not "
                             "'lex'")
        handlers, parents, grid_shapes = (
            multigrid.build_structured_hierarchy(
                mesh, n, degree=degree, coarsest_side=max(2, n >> TRIM)))
    elif hierarchy == "rtree":
        agg = RTreeAgglomerator.build(mesh.cell_centers())
        lv0 = max(1, agg.n_levels - 1 - TRIM)
        handlers, parents = multigrid.build_rtree_hierarchy(
            mesh, agg, list(range(lv0, agg.n_levels - 1)), degree=degree,
            relabel=relabel)
        grid_shapes = (multigrid.detect_grid_shapes(handlers, parents)
                       if relabel else None)
    else:
        raise ValueError(f"unknown hierarchy: {hierarchy!r}")
    ah = handlers[-1]
    t_hier = time.perf_counter() - t0

    ft = ah.faces
    interior = ~ft.is_boundary
    diffs = (ft.poly_out - ft.poly_in)[interior].astype(np.int64)
    band_offsets = np.unique(np.concatenate(
        [diffs, -diffs, np.zeros(1, dtype=np.int64)]))
    if relabel == "lex" and len(band_offsets) > 2 * dim + 3:
        raise RuntimeError("the lex relabel should give a narrow band, not "
                           f"{len(band_offsets)} offsets")
    t1 = time.perf_counter()
    groups = build_banded_groups(ah, band_offsets, dtype, device=device)
    pp = multigrid.level_pack_plan(ah, band_offsets)
    packed = pp is not None
    plan = oid = None
    if packed:
        plan, oid = pp[0], torch.as_tensor(pp[1], device=device)
    sync()
    t_groups = time.perf_counter() - t1

    t2 = time.perf_counter()
    A0 = assemble_sipg_banded_direct(ah, groups, offsets=band_offsets,
                                     pack_plan=plan, pack_oid=oid)
    u_ex = lambda x: torch.prod(torch.sin(math.pi * x), dim=-1)
    f = lambda x: dim * math.pi**2 * u_ex(x)
    b = assemble_rhs_direct(ah, groups, f, u_ex)
    del groups
    sync()
    t_asm0 = time.perf_counter() - t2

    t3 = time.perf_counter()
    mg = multigrid.build_multigrid(
        handlers, parents, A0, chebyshev_degree=CHEBYSHEV_DEGREE,
        n_smooth=N_SMOOTH, smoothing_range=SMOOTHING_RANGE,
        grid_shapes=grid_shapes, precond_dtype=precond_dtype, dtype=dtype,
        coarse_solver=coarse_solver, level_assembly="banded", device=device)
    sync()
    t_mg = time.perf_counter() - t3
    if packed and not isinstance(mg.ells[-1], BlockPacked):
        raise RuntimeError("the packed path is not engaged")
    return Flagship(
        handlers=handlers, mg=mg, b=b, band_offsets=band_offsets,
        grid_shapes=grid_shapes,
        setup_phases=dict(hierarchy=t_hier, groups=t_groups,
                          assemble0=t_asm0, mg_setup=t_mg, **first_use),
        relabel=relabel, format="packed" if packed else "banded",
        hierarchy=hierarchy)


def solve_flagship(fs: Flagship, rtol: float = 1e-8, fmg: bool = True,
                   maxiter: int = 100) -> CGResult:
    """R3MG-preconditioned CG on the flagship system."""
    return fs.mg.solve_cg(fs.b, rtol=rtol, maxiter=maxiter, fmg=fmg)
