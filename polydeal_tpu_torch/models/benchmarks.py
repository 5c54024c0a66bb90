"""Agglomeration-construction timings, the reference's
examples/benchmarks_3D.cc.

Counterpart of ``polydeal_tpu/models/benchmarks.py``: times the mesh and
its connectivity, the R-tree build and extraction, the rcb and greedy
partitions and the handler build (host work, numpy and the root
``csrc/`` library), as the reference's timing printouts
(benchmarks_3D.cc:139-176).

    python -m polydeal_tpu_torch.models.benchmarks --n 32
"""

from __future__ import annotations

import argparse


def run(n: int = 32, dim: int = 3, degree: int = 1, verbose: bool = True):
    from polydeal_tpu_torch.agglomeration import (
        RTreeAgglomerator,
        agglomerate_by_partition,
    )
    from polydeal_tpu_torch.handler import AgglomerationHandler
    from polydeal_tpu_torch.mesh import hyper_cube
    from polydeal_tpu_torch.utils.timer import Timer

    t = Timer()
    with t.scope("mesh build"):
        mesh = hyper_cube(dim, n)
    with t.scope("connectivity"):
        mesh.neighbors

    with t.scope("rtree build"):
        agg = RTreeAgglomerator.build(mesh.cell_centers())
    with t.scope("rtree extract"):
        c2p_rtree = agg.extract_agglomerates(agg.n_levels - 2)

    n_agg = int(c2p_rtree.max()) + 1
    with t.scope("partition rcb"):
        c2p_rcb = agglomerate_by_partition(
            mesh.cell_centers(), mesh.neighbors, n_agg, strategy="rcb")
    with t.scope("partition greedy"):
        c2p_greedy = agglomerate_by_partition(
            mesh.cell_centers(), mesh.neighbors, n_agg, strategy="greedy")

    with t.scope("handler (rtree)"):
        ah = AgglomerationHandler(mesh, c2p_rtree, degree=degree)

    if verbose:
        print(f"cells: {mesh.n_cells}  agglomerates: {n_agg} "
              f"(rcb {c2p_rcb.max()+1}, greedy {c2p_greedy.max()+1})")
        print(f"polytopal faces (fine-face rows): {ah.faces.n_faces}")
        print(t.summary())
    return t


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--dim", type=int, default=3)
    ap.add_argument("--degree", type=int, default=1)
    args = ap.parse_args()
    run(n=args.n, dim=args.dim, degree=args.degree)


if __name__ == "__main__":
    main()
