"""Mesh-quality study, the reference's examples/metrics.cc.

Counterpart of ``polydeal_tpu/models/metrics_study.py``: builds several
agglomerations of one grid and prints the quality metric table
(uniformity, circle ratio, box ratio, coverage; reference
metrics.cc:311-356).  Host work only.  The polygon CSV export needs
``io.py``, which is not ported yet (ROADMAP Queue 1 item 9).

    python -m polydeal_tpu_torch.models.metrics_study --n 16 --degree 1
"""

from __future__ import annotations

import argparse


def run(n: int = 16, dim: int = 2, degree: int = 1, distort: float = 0.0,
        verbose: bool = True):
    from polydeal_tpu_torch.agglomeration import (
        RTreeAgglomerator,
        agglomerate_by_partition,
    )
    from polydeal_tpu_torch.handler import AgglomerationHandler
    from polydeal_tpu_torch.mesh import distort_random, hyper_cube
    from polydeal_tpu_torch.metrics import compute_quality_metrics

    m0 = hyper_cube(dim, n)
    mesh = distort_random(m0, distort, seed=1) if distort else m0
    agg = RTreeAgglomerator.build(m0.cell_centers())
    configs = {
        "rtree": agg.extract_agglomerates(agg.n_levels - 2),
        "rcb": agglomerate_by_partition(
            m0.cell_centers(), m0.neighbors, m0.n_cells // (2**dim)),
        "greedy": agglomerate_by_partition(
            m0.cell_centers(), m0.neighbors, m0.n_cells // (2**dim),
            strategy="greedy"),
    }
    results = {}
    for name, c2p in configs.items():
        ah = AgglomerationHandler(mesh, c2p, degree=degree)
        q = compute_quality_metrics(ah)
        results[name] = q
        if verbose:
            print(f"{name:8s} polytopes={ah.n_poly:5d} "
                  f"uniformity={q['mean_uniformity']:.4f} "
                  f"circle={q['mean_circle_ratio']:.4f} "
                  f"box={q['mean_box_ratio']:.4f} "
                  f"coverage={q['coverage']:.4f}")
    return results


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--dim", type=int, default=2)
    ap.add_argument("--degree", type=int, default=1)
    ap.add_argument("--distort", type=float, default=0.0)
    args = ap.parse_args()
    run(n=args.n, dim=args.dim, degree=args.degree, distort=args.distort)


if __name__ == "__main__":
    main()
