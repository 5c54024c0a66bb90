"""Smoke test of the PyTorch + CUDA port on one GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each must pass; nothing falls back to the CPU):
  1. require a CUDA device (exit 2 without one) and the port's package;
  2. build the CUDA kernels from polydeal_tpu_torch/csrc/;
  3. check K1 (banded SpMV) and K2 (fused Chebyshev step/residual, all
     three modes) against their plain PyTorch versions at the flagship's
     fine-level shapes, for f32, bf16 and f64 bands, and time both, beside
     a torch.sparse CSR product of the same band (K1's library yardstick);
     check K3-K5 (volume, face group and boundary SIPG blocks) against
     their plain versions on seeded tables at the flagship's fine-level
     shapes (p=1, C=1), at a coarse level's (C>1, split over blocks), at
     p=2 (nb=10), and at 8 lanes at p=2 and p=3 (a lane's points over point
     ranks, entry ranks sharing staged point values), in f32 and f64, and
     time both; hold set_condition (csrc/graph_loop.cu, the device loops'
     condition) to its meaning: a WHILE program counting a device counter
     to n stops at n = 0, 1 and 37 with n + 1 tests of its condition
     counted, two launches alike, and time what a test adds to a loop
     iteration beside an empty kernel node;
  4. a small f64 flagship solve (n=16, every level on the kernels) on the
     card against the same solve on the CPU;
  5. the flagship R3MG Poisson solve at n=64, p=1 (1,048,576 DoF) on the
     card, set up through K3-K5 on every level, which must reach rtol 1e-8
     in 18-22 CG iterations through K1 and K2; then K3-K5 against their
     plain versions on every level's real f32 tables, timed per level
     beside their bounds, with each level's C, q and launch plan (G, S),
     and two launches of K3 and K4 bitwise equal on the fine level (S = 1)
     and the coarsest (S > 1);
  6. the same flagship without the relabel (relabel=None, bench.py's
     BENCH_RELABEL=none arm): the fine level assembled straight into the
     packed format, levels 4096 and 32768 packed, K6 (packed SpMV) and K7
     (fused packed Chebyshev) on all three; it must reach rtol 1e-8 in
     18-22 iterations, its f32 solution mapped to cell order within 1e-4 of
     phase 5's f64 one; then K6/K7 against their plain versions on every
     packed level's real pack (all three K7 modes, f32 and f64), timed
     beside a torch.sparse CSR product of the same pack; then a small f64
     packed solve (n=16) on the card against the same solve on the CPU;
  7. the monodomain at bench.py's bench_monodomain configuration (3D,
     n_refinements=6: 1,048,576 DoF, p=1, lex relabel, BDF2 with dt=5e-5,
     one BDF1 step then 20 BDF2 steps, R3MG-preconditioned CG to rtol
     1e-8): 2-5 CG iterations a step, u finite with max u at quadrature in
     (0.01, 2.0), K0-K5 launched, and the integrals of u and u^2 within
     1e-3 of an f64 run of the same steps on the card; then a small f64
     monodomain (n_refinements=3, five steps) on the card against the CPU;
     K3-K5 on the monodomain's levels (8-262144 lanes, the hierarchy
     rebuilt as the solver builds it) as on phase 5's.
  8. the sharded solve (ShardedBandedSystem) at world size 1 on a real
     NCCL group: bench.py's bench_sharded configuration (the structured
     n=64 flagship, f32 with bf16 band copies), unsharded (no FMG) and
     sharded, each cold and then warm: both reach rtol 1e-8 in 21-25
     iterations, within one of each other, the sharded f32 solution within
     1e-4 of an f64 solve; unsharded_ms, sharded_ms and their ratio.  Phase
     5's lex and phase 6's relabel=None systems are sharded the same way
     before they go (each within one iteration of its unsharded no-FMG
     solve and 1e-4 of phase 5's f64 solution; the packed one through K6
     and K7 halo).  K1, K2, K6 and K7 halo against their plain versions on
     the sharded path's own slabs (the rows of the JSON line, with CSR
     products of the slabs beside K1/K6 halo) and on 4-way lane cuts of
     real bands (lex fine f32 and bf16, structured 32768-lane f32 and bf16,
     relabel=None fine pack), each also in f64, the cuts side by side
     against the whole level's product; a small f64 sharded solve (n=16)
     on the card against the CPU.  Fails unless all four halo kernels were
     launched.
  9. the general block-COO path and the scalar models (models/poisson.py,
     models/diffusion_reaction.py: the table assembly into a BlockMatrix,
     Multigrid.setup banding every level): (a) solve_poisson 3D p=1 f64 on
     the R-tree hierarchy at n=16 and 32, held to the JAX package's
     iterations (+-1) and L2/H1 errors (1e-8 relative; constants from
     tools/jax_coo_constants.py), then at n=64 (1,048,576 DoF, levels 8 to
     262144, 7-37 band offsets, every level banded, K0, fused K0, K1 and K2
     launched), its rates from n=32 against the JAX 16 -> 32 rates (H1
     within 0.1) and 19 +- 1 iterations (no JAX constant at n=64); (g)
     the fine BlockMatrix assembled three times bitwise equal and two more
     solves with the same iterations; (f) K1, K2 (three modes), K0 and
     fused K0 against their plain versions on its real f64 bands (262144
     and 32768 lanes, 4096 for K0) and their f32 casts, timed
     beside their bounds and a CSR torch.mv; (b) the same in f32 at rtol
     1e-8, within 1e-4 of (a)'s solution; (c) p=2 at n=16 and n=32
     (327,680 DoF) against the JAX package; (d) the diffusion-reaction
     convergence study at n=16/32/64 (the JAX errors at 16 and 32 to 1e-8,
     rates); (e) the partition + block-Jacobi CG arm (2D p=2 n=128) and a
     Galerkin-coarsened R3MG (3D n=32) against the JAX package; (h) 2D
     n=16 Poisson and diffusion-reaction, f64, card against CPU (same
     iterations, solutions within 1e-12).
 10. SA-AMG, GMRES and the coupled models (constants JAX_COUPLED from
     tools/jax_coupled_constants.py): (a) solve_poisson(solver="amg") 3D
     p=1 at n=16/32, the JAX package's iterations (+-1) and L2/H1 (1e-8),
     then at n=64 (1,048,576 DoF) R3MG's 19 +- 1 iterations against AMG's
     (more), the solutions within 1e-7, AMG's host setup and solve seconds
     and the peak RSS printed; the diffusion-reaction partition arm at
     n=16/32 (2D); (b) darcy_stokes run(n, 2) at n = 8/16/32/64 (errors
     within 1e-8 of JAX's) and MG-GMRES (rtol 1e-11) at the recorded
     49/92/103/109 (+-2), within 1e-6 of the dense solve, then n=128
     (36,864 DoF, a 10.9 GB dense solve) printed; its n=64 solve is the
     path the counters read (K0 and fused K0 launched); (c) oseen run(16,
     2) and run_curved(16, 2) errors (1e-8), MG-GMRES at n = 16/32/64
     within 1e-6 of dense, JAX's count at 16 (+-2); (d) Stokes' exact
     linear flow (1e-10), the piston at n=16 (iterations +-1, extrema
     1e-8), an hp dense solve (1e-10); (e) K0 and fused K0 against their
     plain versions on the coupled fine bands (darcy u nb=12, darcy pD
     nb=3, the oseen proxy nb=6; f64 and f32), two launches bitwise equal,
     timed beside a CSR torch.mv.
 11. phase 5's system again: (a) the matrix-free fine level
     (assembly/matfree.MatrixFreeLaplace) against the assembled fine
     bands, f64 (1e-12) and f32 (1e-5) apply and diagonal, its f32 apply
     timed beside its byte bound; the flagship composition with it
     (build_multigrid(matfree_fine=True), coarse levels through K3-K5, K1,
     K2 and fused K0): phase 5's iterations +-2, within 1e-4 of phase 5's
     f64 solution, setup and solve seconds and the peak device memory of
     both compositions printed; (b) bf16 smoothing vectors
     (setup_flagship(vector_dtype=torch.bfloat16)): the lex and
     relabel=None flagships converged within 200 iterations, within 1e-4
     of the f64 solution; K6 and K6 halo with bf16 x against their plain
     versions (1 bf16 ulp), two launches bitwise equal, traced beside
     their bounds, on the relabel=None arm's fine pack and its sharded
     fine slab; that arm sharded at world size 1 on phase 8's NCCL group,
     within one iteration of its unsharded no-FMG solve; (c) write_vtu and
     write_matrix_market on the 3D n=16 system, read back.
 12. the last modules, at world size 1 on phase 8's NCCL group: (a) the
     flat block-COO ShardedSystem on phase 9's n=64 COO Poisson system
     (1,048,576 DoF, f64, every level through to_block_matrix), held to
     its unsharded solve: iterations +-1, x within 1e-8; the fine
     ShardedMatrix's blocks, bytes and halo rows (0) and the warm solve's
     seconds; (b) shard-local setup of bench_sharded's system: its fine
     band built as 4 lane slabs on K3-K5 (each table with only the lanes
     the slab needs) against the global build, bitwise where every launch
     plan is the whole level's, else within 1e-6 of the largest entry,
     with last_setup_stats; then ShardedBandedSystem.setup_local at world
     size 1 held as phase 8 holds from_multigrid (21-25 iterations, within
     one of the unsharded no-FMG solve, f32 within 1e-4 of f64; K3-K5 and
     K1/K2 halo launched); (c) models/sharded.dryrun (the 2D packed
     R-tree f64 solve sharded against the host solve, then the flat 2D
     n=8 one; K6/K7 halo launched); (d) assemble_sipg_banded and
     assemble_sipg_banded_gather at n=64 p=1 against the direct band (f64
     1e-12, f32 1e-5 relative), seconds and peak device MB; (e)
     chained_cost of K1 on the lex fine band beside its CUDA-event time.
 13. the captured solves (solvers/graphs: CUDA graphs replayed, the
     default on the card) against the eager loop (capture=False), on the
     systems phases 5-8 built, in those phases: the lex flagship (phase
     5), relabel=None (phase 6) and its world-size-1 sharded system
     (solve_cg_async), the monodomain's 20 BDF2 steps through steps_scan
     (phase 7), the structured sharded system (phase 8, solve_cg_async).
     Per arm: both solves' iterations (must be equal), the max-norm
     relative difference of the solutions (1e-6) and of the graph f32
     solution against the phase's f64 one (1e-4; the monodomain's not
     gated, as phase 7's), warm host-clock medians over 11 calls in turns
     with their range, one traced eager call (device busy over the span,
     idle share; the trace must hold records of the port's kernels),
     bodies run and host reads per call (each captured solve is one
     device program, its loops WHILE nodes on the device: the run fails
     unless a call reads the host once, the 20 monodomain steps included,
     and runs the body once an iteration, by the device's count of the
     loop's tests), capture seconds and the graph pool's MB; the
     captured body must hold launches of the port's kernels, and one
     replay of it on its own after the solve is traced: its trace must
     hold records of them, x must stay bitwise (the body is masked once
     the loop has stopped), and its busy time times the bodies run over
     the program's span by CUDA events bounds the program's idle share;
     the monodomain's integrals of u and u^2 within 1e-6 of the eager
     ones.  Phases 4-12 solve through the graphs (CG over every
     hierarchy Multigrid.graph_ok admits, SA-AMG's CG, GMRES), so their
     launch counts include the programs' runs (each adds its launches
     once it has read the iterations).  A device program is not traced
     whole: the profiler drops the records of kernels inside WHILE
     bodies, a plain torch program's too (tools/while_probe.py --fault).
 14. the remaining one-program solves (solvers/graphs.GMRESLoop, SA-AMG's
     captured CG, and CG over block-ELL, matrix-free and bf16-vector
     hierarchies) against the eager loops, as phase 13 holds its arms, on
     the systems of phases 10 and 11: darcy_stokes MG-GMRES at n=64 and
     n=128, its block-Jacobi GMRES at n=32 (at its 12000-step cap), oseen
     MG-GMRES at n=64, SA-AMG on phase 10's n=64 COO Poisson system, the
     matrix-free composition and the bf16-vector lex flagship of phase
     11; and a 2D n=32 R-tree hierarchy whose permuted fine level is
     block-ELL.  Per arm: equal iterations, solutions within 1e-12 (f64)
     or 1e-6 (f32) of each other, the MG-GMRES ones within 1e-6 of the
     dense solve (phase 10's checks hold on the captured path too), warm
     medians (range; one warm call each where an eager solve takes
     seconds), the traced eager solve where its launches are few enough
     to trace (idle share; records of the port's kernels, or any device
     operation where the arm has none), the body's capture and its traced
     replay as in phase 13 (GMRES: the Arnoldi step), steps run and host
     reads (one a solve, both loops of GMRES on the device), capture
     seconds and the graph pool's MB.
 15. the sharded solves as one device program: (a) in phase 12, the flat
     block-COO ShardedSystem on phase 9's n=64 COO system captured (the
     default on the card) against its eager solve, as phase 13 holds its
     arms (equal iterations, x within 1e-12, whether bitwise, 3 warm
     calls each); (b) one captured program on
     the world-size-1 NCCL group holding an exchange to self, an
     all_reduce (PreMulSum by 2, so that it changes its input at one rank)
     and an all_gather_into_tensor, replayed on new input, held bitwise to
     the same calls run eagerly and to what each collective writes, its
     traced device operations listed; (c) with two or more cards visible,
     tools/nccl_capture_probe.py at min(4, count) ranks (both sharded
     systems captured across the cards against their eager solves),
     which fails the run on a mismatch or a timeout; on one card a line
     says it needs two.
 16. bases without a K3-K5 or specialised K1/K2 build: the flagship on
     the TensorDGQ basis at p=1 and n=64 (2,097,152 DoF, nb = 8), at p=2
     and n=32 (nb = 27) and on P_4 at n=32 (nb = 35), each assembled by
     the einsums (no K3-K5 launch), f32 with bf16 smoothing copies and
     captured: rtol 1e-8 through K1 and K2's runtime-nb build
     (csrc/banded_any_nb.cu), the iterations within 6 of an f64 solve of
     the same system and the solution within 5e-3 of it (an f32 band of
     these bases cannot carry 1e-4: F32_X_TOL16); each sharded at
     world size 1 (K1/K2 halo's runtime-nb build, within one iteration of
     the unsharded no-FMG solve); K1 (f32 and f64, beside a CSR torch.mv of
     the band), K2 (the bf16 smoothing copy and f64, each mode bitwise over
     two launches) and K1/K2 halo (4-way cuts, f32 and f64, bitwise) on the
     fine bands against their plain versions, traced cold beside their
     bounds; and the Q1 n=32 f64 solve within one iteration and 1e-8 (L2
     error, relative) of the JAX package's (tools/jax_dgq_constants.py).
 17. the 2D high-order monodomain (MonodomainConfig(dim=2, degree=p), the
     command line's defaults: dt 1e-4, stimulus radius 0.1), where K5
     alone computes the blocks it computes in the JAX package (the
     boundary blocks of every level; the volume and face blocks by the
     einsums): p=4 at n_refinements=9 (262,144 fine polytopes, 3,932,160
     DoF) with the lex relabel (K1/K2 at nb = 15 on their runtime-nb build
     from 32768 lanes, fused K0 below) and with relabel=None (K6/K7 on the
     packed levels), p=5 at n_refinements=8 (1,376,256 DoF, nb = 21) lex;
     f32, captured, 1 BDF1 and MONO_STEPS BDF2 steps cold then warm: 2-5
     CG iterations a step, max u at quadrature in (0.01, 2.0), the
     integrals of u and u^2 within 1e-3 of an f64 lex run of the same
     steps, K5 launched once a level at the build and K3/K4 never; setup
     phases, steps/s and DoF*steps/s; K1 and K2 (f32 band and a bf16
     copy, bitwise) against their plain versions on the lex fine bands,
     K0 on every K0 level (timed on the largest), K6/K7 on every packed
     level, K5 on every
     lex level's real tables; then f64 at n_refinements=5 for p=4 and 5
     against the JAX package (tools/jax_mono2d_constants.py): the same CG
     iterations per step (BDF1 and 5 BDF2), the integrals within 1e-9.
     Phase 3 holds K5 at the 2D p=4 and p=5 fine boundary shapes too.
K0 (o-major banded SpMV) and fused K0 (its Chebyshev step/residual, all
three modes) are held against their plain versions on the real bands of
phases 5-7 once each exists (phase 3's check, on real bands): the
4096-lane lex flagship level in f32 and as its bf16 smoother copy, the
19-offset 512-lane level without the relabel, the monodomain's 64-, 512-
and 4096-lane levels (and, for K0, its fine band), each also in f64,
two launches of every mode bitwise equal, and plans the library cannot
run refused (``ops/banded.omajor_plan`` gives the one each launch
passes); with CUDA-event, host-clock and traced device
time per call beside the traced empty kernel on K0's grid (the launch
floor).  Phases 9, 10, 16 and 17 hold them the same way on their bands
(16 and 17: every level under 32768 lanes).  K2 is held the
same way on the real i-major bands it serves: the lex flagship's 32768-
and 262144-lane bf16 smoother copies and the monodomain's f32 32768- and
262144-lane levels.  Phases 5 and 7 fail unless fused K0 was launched,
and phase 7 if K0's plain product ran beyond the eigenvalue estimates.
Every K1 and K1 halo row prints K1's launch plan (W lanes a thread, S
offset groups a block: ``ops/banded.k1_plan``), and the K1 checks of
phases 3 and 9 (f) hold two launches bitwise equal; phase 8's 4-way cuts
time slab 1 beside its CSR product.
A profiler trace that comes back without the traced kernel's records is
taken again, up to three times, and then read by CUDA events queued behind
a sleep kernel; the run prints how many traces came back so.
Prints the card, a JSON line of per-kernel results, and last
{"ok": true, "device": {...}}.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))

# monodomain: BDF2 steps after the BDF1 one (bench.py's n_steps), and those
# of its f64 reference run
MONO_STEPS = 20
MONO_STEPS_F64 = 20

# flagship fine level: nb=4 (p=1, 3D), 7 offsets of the lex-relabelled
# 64^3 grid, R_pad = 28, P = 64^3
NB, P_FINE = 4, 64**3
OFFSETS_FINE = (-4096, -64, -1, 0, 1, 64, 4096)
TOL = {"float32": 1e-5, "bfloat16": 1e-5, "float64": 1e-12}
# K3-K5: the bound the JAX package holds its Pallas assembly to in f32
# (tests/test_ops.py:182); f64 sums differ by rounding only
SIPG_TOL = {"float32": 2e-5, "float64": 1e-12}

# bound(nbytes, flops, dtype): the least time of a kernel's work on the
# card, profile_sipg.bound; main() imports it once the checkout is found
bound = None


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def events_ms(torch, fn, reps):
    """Mean ms per call of ``fn`` over ``reps`` calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_pair(torch, kernel, plain, reps=50):
    """Mean ms per call of kernel and plain version, in turns (plain,
    kernel, kernel, plain), after one warm-up each."""
    kernel()
    plain()
    torch.cuda.synchronize()
    p1, k1, k2, p2 = (events_ms(torch, f, reps)
                      for f in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def time_one(torch, fn, reps=50):
    """Mean ms per call of ``fn``, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    return events_ms(torch, fn, reps)


def csr_of_slots(torch, data_i, q, live, nb, R_pad, n_cols=None):
    """A band of n_slots row blocks per i-slab (data_i [nb * R_pad, P]) as
    a torch.sparse CSR matrix on flat (p, i) rows and (q, j) columns: slot
    k of lane p multiplies x[:, q[k, p]] where ``live[k, p]``; x has
    ``n_cols`` lanes (default P; a halo slab's x_ext has P + 2T)."""
    dev = data_i.device
    n_slots, P = q.shape
    D = data_i.view(nb, R_pad, P)[:, :n_slots * nb].reshape(nb, n_slots, nb,
                                                            P)
    i = torch.arange(nb, device=dev).view(nb, 1, 1, 1)
    j = torch.arange(nb, device=dev).view(1, 1, nb, 1)
    p = torch.arange(P, device=dev).view(1, 1, 1, P)
    qq = q.view(1, n_slots, 1, P)
    mask = live.view(1, n_slots, 1, P).expand(nb, n_slots, nb, P)
    rows = (p * nb + i).expand_as(mask)[mask]
    cols = (qq * nb + j).expand_as(mask)[mask]
    with warnings.catch_warnings():  # "CSR support is in beta state"
        warnings.simplefilter("ignore", UserWarning)
        A = torch.sparse_coo_tensor(torch.stack([rows, cols]), D[mask],
                                    (P * nb, (n_cols or P) * nb),
                                    check_invariants=False)
        return A.coalesce().to_sparse_csr()


def csr_of_band(torch, data_i, offsets, nb, R_pad, P):
    """The i-major band as a CSR matrix, dropping blocks whose column
    leaves [0, P)."""
    dev = data_i.device
    q = (torch.tensor(offsets, device=dev).view(-1, 1)
         + torch.arange(P, device=dev).view(1, P))
    return csr_of_slots(torch, data_i, q, (q >= 0) & (q < P), nb, R_pad)


def csr_of_pack(torch, e):
    """A BlockPacked's pack as a CSR matrix: active slots only."""
    P = e.n_block_rows
    o = e.oid.long()
    q = (torch.arange(P, device=o.device).view(1, P)
         + e.offsets_t.long()[o.clamp(min=0)])
    live = (o >= 0) & (q >= 0) & (q < P)
    return csr_of_slots(torch, e.data_i, q, live, e.n_basis, e.plan.R_pad)


def check_set_condition(torch, dev, n_time=1000):
    """set_condition (csrc/graph_loop.cu) held to its plain meaning: a
    device program ``init`` then WHILE(c < n) { c += 1 } (the body a
    torch-captured program, then set_condition) stops at c = n and counts
    n + 1 tests of its condition, for n = 0, 1 and 37, two launches
    alike.  Timed at n = ``n_time``: ``ms`` is what a test adds to a loop
    iteration (set_condition and the WHILE node's next iteration): the
    loop less the same body run n times as a chain of child nodes in one
    graph, no condition; ``plain_ms`` a loop iteration of the eager
    loop's condition (the body replayed, the flag read on the host);
    ``floor_ms`` an empty kernel node in a graph (the library's empty
    kernel, n in one captured program).  Bound: the bytes it moves (the
    flag, the count read and written) over the memory rate."""
    from polydeal_tpu_torch.ops import _build
    from polydeal_tpu_torch.solvers import graphs

    pool = torch.cuda.graph_pool_handle()

    def counting(n):
        c = torch.zeros((), dtype=torch.int64, device=dev)
        flag = torch.zeros((), dtype=torch.bool, device=dev)
        tests = torch.zeros((), dtype=torch.int64, device=dev)

        def init(_):
            c.zero_()
            flag.copy_(c < n)

        def body(_):
            c.add_(1)
            flag.copy_(c < n)

        pi = graphs.capture(None, init, device=dev, pool=pool)
        pb = graphs.capture(None, body, device=dev, pool=pool)

        def build(ch):
            ch.child(pi)
            ch.loop(flag, lambda b: b.child(pb), tests)

        return c, flag, tests, pi, pb, graphs.LoopProgram(build, dev)

    got, err = {}, 0
    for n in (0, 1, 37):
        c, _, tests, _, _, prog = counting(n)
        got[n] = []
        for _ in range(2):
            tests.zero_()
            prog.launch()
            got[n].append((int(c), int(tests)))
        err = max(err, *(abs(v - n) + abs(t - (n + 1)) for v, t in got[n]))
    c, flag, tests, pi, pb, prog = counting(n_time)

    def chained(ch):
        ch.child(pi)
        for _ in range(n_time):
            ch.child(pb)

    chain = graphs.LoopProgram(chained, dev)

    def plain():
        pi.graph.replay()
        while bool(flag):
            pb.graph.replay()

    lib = _build.load_library()

    def empties(_):
        s = _build.stream_handle(dev)
        for _ in range(n_time):
            lib.pd_empty_kernel(1, 32, s)

    floor = graphs.capture(None, empties, device=dev, pool=pool)
    loop_ms, chain_ms = time_pair(torch, prog.launch, chain.launch, reps=5)
    plain_ms = time_one(torch, plain, reps=3)
    floor_ms = time_one(torch, floor.graph.replay, reps=5)
    row = dict(max_abs_err=float(err), ms=(loop_ms - chain_ms) / n_time,
               plain_ms=plain_ms / n_time, bound_ms=17 / 3.35e12 * 1e3,
               bound_by="bytes", library_ms=None,
               floor_ms=floor_ms / n_time, iteration_ms=loop_ms / n_time)
    log(f"  set_condition: WHILE(c < n) {{ c += 1 }} stopped at (c, tests) "
        f"{got} for n = 0, 1, 37 (two launches each); at n = {n_time} a "
        f"loop iteration {row['iteration_ms'] * 1e3:.3f} us, of it a test "
        f"of the condition {row['ms'] * 1e3:.3f} us (the body chained "
        f"{chain_ms / n_time * 1e3:.3f} us); the eager loop's condition "
        f"{row['plain_ms'] * 1e3:.3f} us an iteration; an empty kernel node "
        f"{row['floor_ms'] * 1e3:.3f} us")
    if err != 0 or int(c) != n_time:
        fail(f"set_condition: the device loop stopped at {got}, not at "
             f"(n, n + 1)")
    return row


def check_kernels(torch, dev):
    """Phase 3, K1/K2: against their plain versions; returns per-kernel
    results at the main path's dtypes (K1 on the f32 CG operator, K2 on
    the bf16 smoother copies)."""
    from polydeal_tpu_torch.ops import (
        banded_cheb_step_t, banded_cheb_step_t_ref, banded_matvec_t_imajor,
        banded_matvec_t_imajor_ref, banded_residual_t, banded_residual_t_ref)
    from polydeal_tpu_torch.ops.banded import imajor_band, k1_plan

    n_off = len(OFFSETS_FINE)
    R_pad = -(-n_off * NB // 8) * 8
    gen = torch.Generator(device=dev).manual_seed(0)
    offs = torch.tensor(OFFSETS_FINE, dtype=torch.int32, device=dev)

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.float64).to(dtype)

    out = {k: dict(max_abs_err=0.0) for k in ("K1", "K2")}

    def record(name, label, got, ref, tol):
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        parts = ("x'", "d'") if len(got) == 2 else ("y",)
        for part, g, r in zip(parts, got, ref):
            err = float((g - r).abs().max())
            rel = err / float(r.abs().max())
            log(f"  {name} {label} {part}: max_abs_err={err:.3e} "
                f"rel={rel:.3e} (tol {tol:g})")
            if not rel <= tol:
                fail(f"{name} {label} disagrees with its plain version: "
                     f"rel {rel:.3e} > {tol:g}")
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)

    band = n_off * NB * NB * P_FINE  # band entries read per call
    vec = NB * P_FINE  # entries of one vector
    for dname, ddt, vdt in (("float32", torch.float32, torch.float32),
                            ("bfloat16", torch.bfloat16, torch.float32),
                            ("float64", torch.float64, torch.float64)):
        tol = TOL[dname]
        data_i = rnd(NB * R_pad, P_FINE, dtype=ddt)
        x, b, d = (rnd(NB, P_FINE, dtype=vdt) for _ in range(3))
        dinv = 1.0 + rnd(NB, P_FINE, dtype=vdt).abs()
        c1, c2 = 0.37, 1.21
        kb = imajor_band(data_i, offs, NB)
        k1 = lambda: banded_matvec_t_imajor(data_i, offs, NB, x, band=kb)
        p1 = lambda: banded_matvec_t_imajor_ref(data_i, offs, NB, x)
        record("K1", f"{dname} band", k1(), p1(), tol)
        plan = k1_plan(kb, x)
        if not torch.equal(k1(), k1()):
            fail(f"two K1 launches on the {dname} band differ")
        log(f"  K1 {dname} band plan: W={plan.W}, S={plan.S}, "
            f"{plan.blocks} blocks of {plan.threads}; two launches bitwise "
            f"equal")
        cases = {
            "step0": (lambda: banded_cheb_step_t(data_i, offs, NB, x, None, b,
                                                 dinv, c1, c2),
                      lambda: banded_cheb_step_t_ref(data_i, offs, NB, x,
                                                     None, b, dinv, c1, c2)),
            "step": (lambda: banded_cheb_step_t(data_i, offs, NB, x, d, b,
                                                dinv, c1, c2),
                     lambda: banded_cheb_step_t_ref(data_i, offs, NB, x, d, b,
                                                    dinv, c1, c2)),
            "residual": (lambda: banded_residual_t(data_i, offs, NB, x, b),
                         lambda: banded_residual_t_ref(data_i, offs, NB, x,
                                                       b)),
        }
        for mode, (kf, pf) in cases.items():
            record("K2", f"{dname} band {mode}", kf(), pf(), tol)
        torch.cuda.synchronize()
        ms1, pms1 = time_pair(torch, k1, p1)
        ms2, pms2 = time_pair(torch, *cases["step"])
        log(f"  {dname} band: K1 {ms1:.4f} ms (plain {pms1:.4f} ms); "
            f"K2 step {ms2:.4f} ms (plain {pms2:.4f} ms)")
        esz, vsz = data_i.element_size(), x.element_size()
        if dname == "float32":
            # K1's library yardstick: the same band as a CSR matrix times x
            A = csr_of_band(torch, data_i, OFFSETS_FINE, NB, R_pad, P_FINE)
            xf = x.T.contiguous().view(-1)
            lib = lambda: torch.mv(A, xf)
            yl = lib().view(P_FINE, NB).T
            err = float((yl - k1()).abs().max()) / float(yl.abs().max())
            if not err <= tol:
                fail(f"CSR product disagrees with K1: rel {err:.3e}")
            lms = time_one(torch, lib)
            log(f"  K1 library yardstick (torch.sparse CSR, nnz "
                f"{A.values().numel()}): {lms:.4f} ms, rel diff {err:.3e}")
            del A, xf
            b_ms, b_by = bound(band * esz + 2 * vec * vsz, 2 * band, dname)
            out["K1"].update(ms=ms1, plain_ms=pms1, library_ms=lms,
                             bound_ms=b_ms, bound_by=b_by,
                             plan=dict(W=plan.W, S=plan.S))
        if dname == "bfloat16":
            # reads the band and x, b, d, dinv; writes x', d'
            b_ms, b_by = bound(band * esz + 6 * vec * vsz,
                               2 * band + 6 * vec, "float32")
            out["K2"].update(ms=ms2, plain_ms=pms2, library_ms=None,
                             bound_ms=b_ms, bound_by=b_by)
        del data_i, x, b, d, dinv
    return out


def check_sipg_kernels(torch, dev):
    """Phase 3, K3-K5: against their plain versions on seeded tables at
    SIPG_SHAPES (``models/profile_sipg.py``), f32 and f64, each timed by
    ``profile_sipg.cold_ms`` (device time, L2 evicted); at the 2D p = 4
    and 5 shapes, where K5 alone is built, K5 only, bitwise over two
    launches.  Returns per-kernel results at the flagship's fine-level
    shapes in f32 (the main path's tables), and K5's at the 2D shapes
    (``"boundary_blocks 2d p4"``, ``"... 2d p5"``).  The reference is the plain version evaluated in f64 on the
    same inputs, so that an f32 row measures the kernel's rounding alone:
    the 8-lane rows sum 9,000-65,000 points a lane, where the f32 plain
    version's own rounding nears the tolerance (printed beside)."""
    from polydeal_tpu_torch.models import profile_sipg as ps
    from polydeal_tpu_torch.ops import sipg_kernels as sk

    def f64(d):
        return {k: v.double() for k, v in d.items()}

    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for label, (dim, deg, P, vq, fq, bq, off) in ps.SIPG_SHAPES.items():
        pc = 10.0 * (deg + dim) * (deg + 1)
        for dname in ("float32", "float64"):
            dt = getattr(torch, dname)
            (vol, face, bdry), ext, lo = ps.sipg_tables(dev, dt, dim, P,
                                                        (vq, fq, bq), gen)
            vol = vol and dict(pts=vol["pts_in"], w=vol["w"])
            built = sk.kernel_blocks("dgp", dim, deg, dt)
            cases = {
                "volume_blocks": (
                    lambda: sk.volume_blocks(vol, ext, deg, dim),
                    lambda up=False: (
                        sk.volume_blocks_ref(f64(vol), ext.double(), deg, dim)
                        if up else sk.volume_blocks_ref(vol, ext, deg, dim)),
                    ("volume", vq)),
                "face_group_blocks": (
                    lambda: sk.face_group_blocks(face, ext, lo, off, deg,
                                                 dim, pc),
                    lambda up=False: (
                        sk.face_group_blocks_ref(f64(face), ext.double(),
                                                 lo.double(), off, deg, dim,
                                                 pc) if up else
                        sk.face_group_blocks_ref(face, ext, lo, off, deg,
                                                 dim, pc)),
                    ("face", fq)),
                "boundary_blocks": (
                    lambda: sk.boundary_blocks(bdry, ext, deg, dim, pc),
                    lambda up=False: (
                        sk.boundary_blocks_ref(f64(bdry), ext.double(), deg,
                                               dim, pc) if up else
                        sk.boundary_blocks_ref(bdry, ext, deg, dim, pc)),
                    ("boundary", bq)),
            }
            for name, (kf, pf, (kind, Cq)) in cases.items():
                if kind not in built:  # 2D p = 4-5: K5 alone
                    continue
                C, q = Cq
                got, ref = ps.blocks(kf()).double(), ps.blocks(pf(up=True))
                own = ps.blocks(pf()).double()
                torch.cuda.synchronize()
                scale = float(ref.abs().max())
                err = float((got - ref).abs().max())
                rel = err / scale
                rel_own = float((own - ref).abs().max()) / scale
                ms, pms = ps.cold_ms(kf), ps.cold_ms(pf, reps=3)
                nbytes, flops = ps.sipg_work(kind, dim, deg, C, q, P,
                                             dt.itemsize)
                b_ms, b_by = bound(nbytes, flops, dname)
                pl = sk.sipg_launch_plan(P, C, q,
                                         sk.sipg_form(kind, dim, deg, dt))
                log(f"  {name} {label} {dname} (P={P}, C={C}, q={q}; "
                    f"lanes/block {pl.lanes}, ranks {pl.ranks}, G {pl.G}, "
                    f"S {pl.S}): max_abs_err={err:.3e} rel={rel:.3e} (tol "
                    f"{SIPG_TOL[dname]:g}; the {dname} plain version's "
                    f"{rel_own:.3e}); {ms:.4f} ms (plain {pms:.4f}; bound "
                    f"{b_ms:.4f}, {b_by}: {nbytes / 1e6:.1f} MB, "
                    f"{flops / 1e9:.3f} GFLOP)")
                if not rel <= SIPG_TOL[dname]:
                    fail(f"{name} {label} {dname} disagrees with its plain "
                         f"version: rel {rel:.3e}")
                if built == {"boundary"}:  # bitwise over two launches
                    again = ps.blocks(kf()).double()
                    if not torch.equal(got, again):
                        fail(f"two {name} launches at {label} {dname} "
                             f"differ")
                    log(f"  {name} {label} {dname}: two launches bitwise "
                        f"equal")
                    del again
                if dname == "float32" and (label == "fine"
                                           or built == {"boundary"}):
                    key = name if label == "fine" else f"{name} {label}"
                    out[key] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                    bound_ms=b_ms, bound_by=b_by,
                                    library_ms=None)
                del got, ref, own
            del vol, face, bdry
            torch.cuda.empty_cache()
    return out


def level_sipg_check(torch, handlers, dev, label):
    """After a main path: K3-K5 against their plain versions on every
    level's real f32 tables of ``handlers``; per level and kind the
    kernels' device time (``profile_sipg.cold_ms``), bound, share, C, q and
    the launch plans (lanes a block, G, S); two launches of K3 and of K4
    bitwise equal on the finest level (S = 1) and on the coarsest (S >
    1)."""
    from polydeal_tpu_torch.models import profile_sipg as ps
    from polydeal_tpu_torch.ops import sipg_kernels as sk

    for li, h in enumerate(handlers):
        t, pc = ps.level_tables(h, torch.float32, dev)
        deg, dim = h.degree, h.dim
        kern = ps.kernel_calls(t, pc, deg, dim)
        plain = ps.kernel_calls(t, pc, deg, dim, plain=True)
        built = sk.kernel_blocks("dgp", dim, deg, torch.float32)
        worst = 0.0
        for kind in (k for k in ps.KINDS if k in built):
            for kf, pf in zip(kern[kind], plain[kind]):
                got, ref = ps.blocks(kf()), ps.blocks(pf())
                rel = float((got - ref).abs().max()) / float(
                    ref.abs().max())
                worst = max(worst, rel)
                # K3 and K4, or K5 where it is built alone
                bitwise = kind != "boundary" or built == {"boundary"}
                if li in (0, len(handlers) - 1) and bitwise:
                    if not torch.equal(got, ps.blocks(kf())):
                        fail(f"{label} P={h.n_poly}: two {kind} launches "
                             "differ")
                del got, ref
        rows = ps.level_rows(t, pc, deg, dim)
        S = {}
        for kind, r in rows.items():
            plans = set()
            for g in ps.table_groups(t)[kind]:
                C, q, P = g["w"].shape
                pl = sk.sipg_launch_plan(P, C, q, sk.sipg_form(
                    kind, dim, deg, g["w"].dtype))
                plans.add((pl.lanes, pl.G, pl.S))
            S[kind] = max(s_ for _, _, s_ in plans)
            log(f"{ps.format_row(label, kind, r)}; plan (lanes a block, G, "
                f"S) {', '.join(map(str, sorted(plans)))}")
        same = ""
        if li in (0, len(handlers) - 1):
            same = "; two launches of " + " and ".join(
                f"{name} (S {S[kind]})" for kind, name in (
                    ("volume", "K3"), ("face", "K4"), ("boundary", "K5"))
                if kind in S and (kind != "boundary" or len(S) == 1)) + (
                " bitwise equal")
        log(f"  {label} P={h.n_poly}: worst rel err {worst:.3e}{same}")
        if not worst <= SIPG_TOL["float32"]:
            fail(f"K3-K5 disagree with their plain versions on {label} "
                 f"level P={h.n_poly}: rel {worst:.3e}")
        del t
        torch.cuda.empty_cache()


def small_solve_check(torch, dev, **kw):
    """Phase 4 (and phase 6 with relabel=None): f64 flagship at n=16 with
    every level on the kernels, on the card, against the same solve on the
    CPU (plain versions)."""
    from polydeal_tpu_torch.models.flagship import (setup_flagship,
                                                    solve_flagship)
    from polydeal_tpu_torch.solvers import multigrid

    saved = multigrid.IMAJOR_MIN_P, multigrid.PACK_MIN_P
    # i-major copies (K1/K2) on banded levels; every wide level but the
    # coarsest packed (K6/K7)
    multigrid.IMAJOR_MIN_P = multigrid.PACK_MIN_P = 0
    try:
        res = {}
        for name, device in (("cpu", torch.device("cpu")), ("cuda", dev)):
            fs = setup_flagship(n=16, device=device, dtype=torch.float64,
                                precond_dtype=None, **kw)
            r = solve_flagship(fs)
            res[name] = (r.iterations, r.x.cpu(),
                         float(r.residual) / float(fs.b.norm()))
    finally:
        multigrid.IMAJOR_MIN_P, multigrid.PACK_MIN_P = saved
    (ic, xc, rc), (ig, xg, rg) = res["cpu"], res["cuda"]
    diff = float((xc - xg).abs().max()) / float(xc.abs().max())
    log(f"  n=16 f64 {kw or ''}: levels {level_formats(fs)}; cpu {ic} iters "
        f"(rel res {rc:.3e}), cuda {ig} iters (rel res {rg:.3e}), "
        f"max |x_cuda - x_cpu| / max |x| = {diff:.3e}")
    # a summation-order change may move the stopping test by one iteration;
    # the solutions then agree to the solver tolerance
    if abs(ic - ig) > 1 or not diff <= 1e-6 or not rg <= 1e-8:
        fail("small f64 solve on the card disagrees with the CPU")
    return level_formats(fs)


def level_formats(fs) -> list:
    """Per level of ``fs.mg``, coarse to fine: (P, "banded", n_off) or (P,
    "packed", n_off, K, R_pad, max |offset|)."""
    out = []
    for e in fs.mg.ells:
        if hasattr(e, "plan"):
            offs = e.plan.offsets
            out.append((e.n_block_rows, "packed", len(offs), e.plan.K,
                        e.plan.R_pad, max(abs(o) for o in offs)))
        else:
            out.append((e.n_block_rows, "banded", len(e.offsets)))
    return out


def cell_order(torch, fs, x):
    """The fine-level solution [P * nb] as [n_cells, nb] on the host, row c
    holding the coefficients of cell c's polytope.  The fine level has one
    cell per polytope, so every numbering of it has the same basis and the
    rows compare across numberings."""
    h = fs.handlers[-1]
    c2p = torch.as_tensor(h.cell2poly, dtype=torch.long)
    return x.detach().cpu().double().reshape(h.n_poly, h.n_basis)[c2p]


def packed_work(e, step: bool, vsz: int):
    """(bytes, operations, active slots per lane) of one K6 call (x in, y
    out) or K7 step (x, b, d, dinv in, x', d' out; six operations per
    vector entry) on pack ``e``: the active slots' blocks, oid and the
    vectors, each read or written once."""
    nb, P = e.n_basis, e.n_block_rows
    active = int((e.oid >= 0).sum())
    band = active * nb * nb
    n_vec = 6 if step else 2
    nbytes = band * e.data_i.element_size() + e.oid.numel() * 4 + (
        n_vec * nb * P * vsz)
    return nbytes, 2 * band + (6 * nb * P if step else 0), active / P


def check_packed_levels(torch, fs, dev):
    """Phase 6: K6 and K7 (three modes) against their plain versions on
    every packed level's real pack with seeded vectors, f32 (1e-5) and f64
    (the band as f64, 1e-12); timed, beside a CSR product of the same pack
    in f32.  Returns the fine level's f32 results per kernel."""
    from polydeal_tpu_torch.ops import fused_cheb as fc
    from polydeal_tpu_torch.ops import packed as pk

    gen = torch.Generator(device=dev).manual_seed(2)
    out = {}
    for e in fs.mg.ells:
        if not hasattr(e, "plan"):
            continue
        nb, P = e.n_basis, e.n_block_rows
        oid, offs = e.oid, e.offsets_t
        for dname, tol in (("float32", 1e-5), ("float64", 1e-12)):
            errs = {"K6": 0.0, "K7": 0.0}
            dt = getattr(torch, dname)
            di = e.data_i.to(dt)
            x, b, d = (torch.randn(nb, P, generator=gen, device=dev,
                                   dtype=torch.float64).to(dt)
                       for _ in range(3))
            dinv = 1.0 + torch.rand(nb, P, generator=gen, device=dev,
                                    dtype=torch.float64).to(dt)
            c1, c2 = 0.37, 1.21
            k6 = lambda: pk.packed_matvec_t(di, oid, offs, nb, x)
            p6 = lambda: pk.packed_matvec_t_ref(di, oid, offs, nb, x)
            k7 = {"step0": (lambda: fc.packed_cheb_step_t(
                di, oid, offs, nb, x, None, b, dinv, c1, c2),
                lambda: fc.packed_cheb_step_t_ref(
                    di, oid, offs, nb, x, None, b, dinv, c1, c2)),
                "step": (lambda: fc.packed_cheb_step_t(
                    di, oid, offs, nb, x, d, b, dinv, c1, c2),
                    lambda: fc.packed_cheb_step_t_ref(
                        di, oid, offs, nb, x, d, b, dinv, c1, c2)),
                "residual": (lambda: fc.packed_residual_t(
                    di, oid, offs, nb, x, b),
                    lambda: fc.packed_residual_t_ref(
                        di, oid, offs, nb, x, b))}
            pairs = [("K6", "", k6, p6)] + [("K7", m, kf, pf)
                                            for m, (kf, pf) in k7.items()]
            for name, mode, kf, pf in pairs:
                got, ref = kf(), pf()
                got = got if isinstance(got, tuple) else (got,)
                ref = ref if isinstance(ref, tuple) else (ref,)
                for g, r in zip(got, ref):
                    err = float((g - r).abs().max())
                    rel = err / float(r.abs().max())
                    if not rel <= tol:
                        fail(f"{name} {mode} at level P={P} {dname} "
                             f"disagrees with its plain version: rel "
                             f"{rel:.3e} > {tol:g}")
                    errs[name] = max(errs[name], rel)
                    if dname == "float32" and P == fs.n_dofs // nb:
                        out.setdefault(name, dict(max_abs_err=0.0))
                        out[name]["max_abs_err"] = max(
                            out[name]["max_abs_err"], err)
            torch.cuda.synchronize()
            if dname == "float64":
                log(f"  level P={P} f64: worst rel err K6/K7 "
                    f"{errs['K6']:.3e} / {errs['K7']:.3e} (tol {tol:g})")
                continue
            ms6, pms6 = time_pair(torch, k6, p6)
            ms7, pms7 = time_pair(torch, *k7["step"])
            A = csr_of_pack(torch, e)
            xf = x.T.contiguous().view(-1)
            yl = torch.mv(A, xf).view(P, nb).T
            lerr = float((yl - k6()).abs().max()) / float(yl.abs().max())
            if not lerr <= tol:
                fail(f"CSR product disagrees with K6 at P={P}: rel "
                     f"{lerr:.3e}")
            lms = time_one(torch, lambda: torch.mv(A, xf))
            nnz = A.values().numel()
            del A, xf, yl
            by6, op6, act = packed_work(e, False, 4)
            by7, op7, _ = packed_work(e, True, 4)
            b6, bb6 = bound(by6, op6, "float32")
            b7, bb7 = bound(by7, op7, "float32")
            log(f"  level P={P} f32 (K={e.plan.K}, {len(e.plan.offsets)} "
                f"offsets, {act:.3f} active slots per lane): K6 {ms6:.4f} "
                f"ms (plain {pms6:.4f}, CSR {lms:.4f} with nnz {nnz}, bound "
                f"{b6:.4f} {bb6}: {by6 / 1e6:.1f} MB); K7 step {ms7:.4f} ms "
                f"(plain {pms7:.4f}, bound {b7:.4f} {bb7}: "
                f"{by7 / 1e6:.1f} MB); worst rel err K6/K7 "
                f"{errs['K6']:.3e} / {errs['K7']:.3e} (tol {tol:g})")
            if P == fs.n_dofs // nb:
                out["K6"].update(ms=ms6, plain_ms=pms6, bound_ms=b6,
                                 bound_by=bb6, library_ms=lms)
                out["K7"].update(ms=ms7, plain_ms=pms7, bound_ms=b7,
                                 bound_by=bb7, library_ms=None)
            del di, x, b, d, dinv
        torch.cuda.empty_cache()
    return out


def k0_work(band, data, vsz: int, fused: bool = False):
    """(bytes, operations) of one K0 call on ``band``'s offsets with
    ``data``: the band entries this band's offsets reach (a lane whose
    column leaves [0, P) reads none) once, x read once, y written once;
    fused, x, b, d and dinv read and x', d' written (six operations per
    vector entry)."""
    nb, P = band.n_basis, band.n_block_rows
    live = sum(max(0, P - abs(int(o))) for o in band.offsets) * nb * nb
    n_vec = 6 if fused else 2
    return (live * data.element_size() + n_vec * nb * P * vsz,
            2 * live + (6 * nb * P if fused else 0))


def host_us(torch, fn, reps=1000):
    """Host-clock microseconds per call of ``fn`` over ``reps`` calls back
    to back with one synchronise at the end: the wrapper's host work where
    it outruns the device."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e6


# profiler traces taken, those that came back without the traced kernel's
# records, and readings that fell back to queued_events_us
TRACES = {"taken": 0, "empty": 0, "by_events": 0}


def queued_events_us(torch, fn, n=50, before=None):
    """Device microseconds per call of ``fn`` by a CUDA event pair around
    each of ``n`` calls, queued behind a sleep kernel so that the device
    runs them back to back and the pairs time its work, not the host's
    launches; ``before`` (if any) runs ahead of each call, outside its
    pair.  The sleep is doubled until it outlasts the host's queueing."""
    sleep = 2 * 10**7  # cycles: about 10 ms at the H100's clock
    while True:
        hold_, first = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(n)]
        torch.cuda.synchronize()
        hold_.record()
        torch.cuda._sleep(sleep)
        first.record()
        t = time.perf_counter()
        for start, end in pairs:
            if before is not None:
                before()
            start.record()
            fn()
            end.record()
        queued_ms = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        if hold_.elapsed_time(first) > queued_ms:
            return sum(s.elapsed_time(e) for s, e in pairs) / n * 1e3
        sleep *= 2


def traced_us(torch, fn, kernel, n=50, tries=3, before=None):
    """Device microseconds per launch of ``kernel`` (a substring of its
    name) over ``n`` calls of ``fn`` (each after ``before``, if any), from
    a torch.profiler trace.  A trace that came back without the kernel's
    records is taken again, up to ``tries`` times; if none holds them (the
    profiler lost the device's records: the kernel's launch is counted by
    its wrapper all the same), the reading is ``queued_events_us``', which
    times the whole call, and the run says so."""
    def calls():
        if before is not None:
            before()
        fn()

    calls()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        TRACES["taken"] += 1
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                calls()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and kernel in e.name]
        if spans:
            return sum(spans) / len(spans)
        TRACES["empty"] += 1
    TRACES["by_events"] += 1
    us = queued_events_us(torch, fn, n, before)
    log(f"  ({tries} traces of {n} calls held no {kernel} launch: "
        f"{us:.2f} us a call by queued CUDA events instead)")
    return us


L2_BYTES = 50 * 2**20  # the H100's L2 cache
ROOF_LIMIT = 1.10  # share of its bound above which a reading is refused


def cold_traced_us(torch, fn, kernel, nbytes, bound_ms, label, n=50,
                   tries=3):
    """``traced_us`` held to the kernel's bound.  Where the call's
    ``nbytes`` exceed L2, L2 is evicted before every call (a 128 MB write),
    so each launch reads its operands from HBM, as on the main path, where
    other levels run between two launches on one band; such a launch
    cannot beat its bound, so a reading above ``ROOF_LIMIT`` of it is
    traced again, and the smoke fails if all ``tries`` traces read so.
    A smaller working set is traced back to back, unchecked."""
    if nbytes <= L2_BYTES:
        return traced_us(torch, fn, kernel, n)
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")
    seen = []
    for _ in range(tries):
        dus = traced_us(torch, fn, kernel, n, before=flush.zero_)
        if bound_ms * 1e3 / dus <= ROOF_LIMIT:
            return dus
        seen.append(round(dus, 2))
    fail(f"{label}: {tries} traces read {seen} us a launch, above "
         f"{ROOF_LIMIT:.0%} of its bound {bound_ms * 1e3:.2f} us with L2 "
         f"evicted")


def hold(label, got, ref, tol):
    """Max abs error of a kernel's outputs against its plain version's,
    failing beyond ``tol`` relative to the largest entry; (err, rel)."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    err = rel = 0.0
    for g, r in zip(got, ref):
        e = float((g - r).abs().max())
        err, rel = max(err, e), max(rel, e / float(r.abs().max()))
    if not rel <= tol:
        fail(f"{label} disagrees with its plain version: rel {rel:.3e} > "
             f"{tol:g}")
    return err, rel


def cheb_vectors(torch, gen, nb, P, dtype):
    """Seeded x, b, d and dinv (in [1, 2)) [nb, P] on the generator's
    device."""
    dev = gen.device
    x, b, d = (torch.randn(nb, P, generator=gen, device=dev,
                           dtype=torch.float64).to(dtype) for _ in range(3))
    dinv = 1.0 + torch.rand(nb, P, generator=gen, device=dev,
                            dtype=torch.float64).to(dtype)
    return x, b, d, dinv


def band_types(torch, t):
    """A band's two checked types: its own (f32 for an f64 band) and
    f64."""
    return (t.float() if t.dtype == torch.float64 else t), t.double()


def k0_floor_us(torch, plan):
    """Traced device microseconds of an empty kernel launched on K0's grid
    (``plan``: threads a block, blocks) the way K0 launches: the floor
    beside K0's byte bound."""
    from polydeal_tpu_torch.ops import _build

    lib = _build.load_library()
    dev = torch.device("cuda", torch.cuda.current_device())
    empty = lambda: lib.pd_empty_kernel(plan.blocks, plan.threads,
                                        _build.stream_handle(dev))
    if empty() != 0:
        fail(f"the empty kernel on K0's grid {plan} did not launch")
    return traced_us(torch, empty, "empty_kernel")


def k0_refuses(torch, label, kb, x):
    """K0's library returns -2, and launches nothing, for plans it cannot
    run at the band ``kb``: a batch other than its path's, 48 threads a
    block."""
    import copy

    from polydeal_tpu_torch.ops import _build
    from polydeal_tpu_torch.ops.banded import launch_product

    before = dict(_build.launches)
    for bad in (kb.plan._replace(batch=kb.plan.batch + 1),
                kb.plan._replace(threads=48)):
        other = copy.copy(kb)
        other.args = (*kb.args[:4], bad.path, bad.threads, bad.batch)
        try:
            launch_product(other, x)
        except RuntimeError as e:
            if str(e).endswith(": -2"):
                continue
            raise
        fail(f"K0 on {label}: the library ran the plan {bad}")
    if dict(_build.launches) != before:
        fail(f"K0 on {label}: a refused plan counted a launch")


def check_k0(torch, label, band, out, fused=True, timed=True):
    """K0 against its plain version on a real o-major band, in the band's
    type (f32 for an f64 band; f32 vectors for a bf16 or f32 band) and as
    f64, 1e-5 / 1e-12 relative to the largest entry, two launches bitwise
    equal, and plans it cannot run refused (``k0_refuses``); with
    ``fused``, fused K0's three modes the same way,
    on the same band.  With ``timed``, each is timed beside the plain
    version and, for an f32 or f64 band, a torch.sparse CSR product of the
    same band.  Each call goes through the band's kept launch arguments,
    as ``BlockBanded``'s do, and is timed traced (device time per launch:
    the row's ``ms``), by CUDA events back to back, by the host clock (the
    wrapper's work per call, which back to back outruns a launch of a few
    microseconds) and by ``queued_events_us`` (traced_us' fallback,
    checked here); beside them the traced empty kernel on K0's grid (the
    launch floor, ``floor_ms``).  Adds each timed case to ``out`` (label
    -> row; fused rows end in " fused")."""
    from polydeal_tpu_torch.ops import fused_cheb as fc
    from polydeal_tpu_torch.ops.banded import (banded_matvec_t_omajor,
                                               banded_matvec_t_omajor_ref,
                                               omajor_band)
    from polydeal_tpu_torch.sparse import BlockBanded

    dev = band.data.device
    nb, P = band.n_basis, band.n_block_rows
    offs = band.offsets_t
    gen = torch.Generator(device=dev).manual_seed(4)
    c1, c2 = 0.37, 1.21
    for data in band_types(torch, band.data):
        dname = str(data.dtype).split(".")[-1]
        vdt = torch.float64 if dname == "float64" else torch.float32
        pdt = "float64" if dname == "float64" else "float32"
        tol = TOL[dname]
        kb = omajor_band(data, offs)
        plan = kb.plan
        x, b, d, dinv = cheb_vectors(torch, gen, nb, P, vdt)
        k0_refuses(torch, f"{label} {dname}", kb, x)
        kf = lambda: banded_matvec_t_omajor(data, offs, x, band=kb)
        pf = lambda: banded_matvec_t_omajor_ref(data, offs, x)
        got = kf()
        err, rel = hold(f"K0 on {label} {dname}", got, pf(), tol)
        twice_equal(torch, f"K0 on {label} {dname}", {"product": (kf, pf)})
        modes = {
            "step": (lambda: fc.banded_cheb_step_t_omajor(
                data, offs, x, d, b, dinv, c1, c2, band=kb),
                lambda: fc.banded_cheb_step_t_omajor_ref(
                    data, offs, x, d, b, dinv, c1, c2)),
            "step0": (lambda: fc.banded_cheb_step_t_omajor(
                data, offs, x, None, b, dinv, c1, c2, band=kb),
                lambda: fc.banded_cheb_step_t_omajor_ref(
                    data, offs, x, None, b, dinv, c1, c2)),
            "residual": (lambda: fc.banded_residual_t_omajor(
                data, offs, x, b, band=kb),
                lambda: fc.banded_residual_t_omajor_ref(
                    data, offs, x, b))}
        ferr = frel = 0.0
        if fused:
            for mode, (mf, mp) in modes.items():
                e, r = hold(f"fused K0 {mode} on {label} {dname}", mf(),
                            mp(), tol)
                ferr, frel = max(ferr, e), max(frel, r)
            twice_equal(torch, f"fused K0 on {label} {dname}", modes)
        plan_s = (f"plan build={plan.build} path={plan.path} "
                  f"threads={plan.threads} blocks={plan.blocks} "
                  f"batch={plan.batch}")
        if not timed:
            log(f"  K0{' and fused K0' if fused else ''} {label} {dname} "
                f"(P={P}, nb={nb}, {len(band.offsets)} offsets): "
                f"rel {max(rel, frel):.3e} (tol {tol:g}), two launches "
                f"bitwise equal; {plan_s}")
            del data, x, b, d, dinv, got, kb
            continue
        ms, pms = time_pair(torch, kf, pf)
        hus, dus = host_us(torch, kf), traced_us(torch, kf, "omajor_kernel")
        qus = queued_events_us(torch, kf)
        floor = k0_floor_us(torch, plan)
        nbytes, flops = k0_work(band, data, x.element_size())
        b_ms, b_by = bound(nbytes, flops, pdt)
        lms = None
        if dname in ("float32", "float64"):
            bi = BlockBanded(data, band.offsets, P).with_imajor()
            A = csr_of_band(torch, bi.data_i, band.offsets.tolist(), nb,
                            bi.data_i.shape[0] // nb, P)
            xf = x.T.contiguous().view(-1)
            yl = torch.mv(A, xf).view(P, nb).T
            lerr = float((yl - got).abs().max()) / float(yl.abs().max())
            if not lerr <= tol:
                fail(f"CSR product disagrees with K0 on {label}: rel "
                     f"{lerr:.3e}")
            lms = time_one(torch, lambda: torch.mv(A, xf))
            del A, xf, yl, bi
        out[f"{label} {dname}"] = dict(
            max_abs_err=err, ms=dus / 1e3, plain_ms=pms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lms, events_ms=ms, host_us=hus,
            queued_us=qus, floor_ms=floor / 1e3, plan=plan._asdict())
        log(f"  K0 {label} {dname} (P={P}, {len(band.offsets)} offsets, "
            f"max |offset| {int(abs(band.offsets).max())}): "
            f"max_abs_err={err:.3e} rel={rel:.3e} (tol {tol:g}), two "
            f"launches bitwise equal; "
            f"{ms:.4f} ms by events, host {hus:.2f} us/call, traced "
            f"{dus:.2f} us/launch, queued events {qus:.2f} us/call (plain "
            f"{pms:.4f}, CSR "
            f"{'-' if lms is None else f'{lms:.4f}'}; bound {b_ms:.4f} "
            f"{b_by}: {nbytes / 1e6:.2f} MB; empty kernel on its grid "
            f"{floor:.2f} us traced); {plan_s}")
        if fused:
            kf, pf = modes["step"]
            ms, pms = time_pair(torch, kf, pf)
            hus, dus = (host_us(torch, kf),
                        traced_us(torch, kf, "omajor_kernel"))
            qus = queued_events_us(torch, kf)
            nbytes, flops = k0_work(band, data, x.element_size(), True)
            b_ms, b_by = bound(nbytes, flops, pdt)
            out[f"{label} {dname} fused"] = dict(
                max_abs_err=ferr, ms=dus / 1e3, plain_ms=pms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, events_ms=ms, host_us=hus,
                queued_us=qus, floor_ms=floor / 1e3, plan=plan._asdict())
            log(f"  fused K0 {label} {dname}: step0/step/residual "
                f"max_abs_err={ferr:.3e} rel={frel:.3e} (tol {tol:g}), two "
                f"launches bitwise equal; step "
                f"{ms:.4f} ms by events, host {hus:.2f} us/call, traced "
                f"{dus:.2f} us/launch, queued events {qus:.2f} us/call "
                f"(plain {pms:.4f}; bound {b_ms:.4f} {b_by}: "
                f"{nbytes / 1e6:.2f} MB; floor {floor:.2f} us)")
        del data, x, b, d, dinv, got, kb


def twice_equal(torch, label, calls):
    """Each kernel call of ``calls`` (mode -> (kernel call, plain call))
    launched twice: equal bits, or the run fails."""
    for mode, (kf, _) in calls.items():
        a, b = kf(), kf()
        a, b = (a if isinstance(a, tuple) else (a,),
                b if isinstance(b, tuple) else (b,))
        if not all(torch.equal(u, v) for u, v in zip(a, b)):
            fail(f"two launches of {label} {mode} differ")


def traced_name(nb, name):
    """The name (substring) a trace finds K1's or K2's kernel by: ``name``
    for a specialised build, the runtime-nb kernel's at any other nb."""
    from polydeal_tpu_torch.ops.banded import KERNEL_NB

    return name if nb in KERNEL_NB else "any_nb_kernel"


def check_k2(torch, label, band, out, bitwise=False):
    """K2's three modes against their plain versions on a real i-major
    band, in the band's type (f32 for an f64 band; f32 vectors for a bf16
    or f32 band) and as f64, 1e-5 / 1e-12 relative to the largest entry,
    through the band's kept launch arguments; the step traced (device
    time per launch, with L2 evicted where the band exceeds it: the row's
    ``ms``, held to its bound by ``cold_traced_us``) and timed by CUDA
    events back to back beside the plain version, with its bound: the
    band's n_off*nb*nb*P entries and six vectors once; with ``bitwise``
    each mode launched twice, equal bits.
    Adds each case to ``out`` (label -> row)."""
    from polydeal_tpu_torch.ops import fused_cheb as fc
    from polydeal_tpu_torch.ops.banded import imajor_band

    di0 = band.data_i
    nb, P, offs = band.n_basis, di0.shape[1], band.offsets_t
    n_off = len(band.offsets)
    gen = torch.Generator(device=di0.device).manual_seed(5)
    c1, c2 = 0.37, 1.21
    for di in band_types(torch, di0):
        dname = str(di.dtype).split(".")[-1]
        vdt = torch.float64 if dname == "float64" else torch.float32
        tol = TOL[dname]
        kb = imajor_band(di, offs, nb)
        x, b, d, dinv = cheb_vectors(torch, gen, nb, P, vdt)
        modes = {
            "step": (lambda: fc.banded_cheb_step_t(
                di, offs, nb, x, d, b, dinv, c1, c2, band=kb),
                lambda: fc.banded_cheb_step_t_ref(
                    di, offs, nb, x, d, b, dinv, c1, c2)),
            "step0": (lambda: fc.banded_cheb_step_t(
                di, offs, nb, x, None, b, dinv, c1, c2, band=kb),
                lambda: fc.banded_cheb_step_t_ref(
                    di, offs, nb, x, None, b, dinv, c1, c2)),
            "residual": (lambda: fc.banded_residual_t(di, offs, nb, x, b,
                                                      band=kb),
                         lambda: fc.banded_residual_t_ref(di, offs, nb, x,
                                                          b))}
        err = rel = 0.0
        for mode, (kf, pf) in modes.items():
            e, r = hold(f"K2 {mode} on {label} {dname}", kf(), pf(), tol)
            err, rel = max(err, e), max(rel, r)
        if bitwise:
            twice_equal(torch, f"K2 on {label} {dname}", modes)
        ms, pms = time_pair(torch, *modes["step"])
        ent = n_off * nb * nb * P
        nbytes = ent * di.element_size() + 6 * nb * P * x.element_size()
        b_ms, b_by = bound(nbytes, 2 * ent + 6 * nb * P,
                           "float64" if dname == "float64" else "float32")
        dus = cold_traced_us(torch, modes["step"][0],
                             traced_name(nb, "fused_kernel"), nbytes, b_ms,
                             f"K2 on {label} {dname}")
        out[f"{label} {dname}"] = dict(
            max_abs_err=err, ms=dus / 1e3, plain_ms=pms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None, events_ms=ms)
        log(f"  K2 {label} {dname} (P={P}, {n_off} offsets): step0/step/"
            f"residual max_abs_err={err:.3e} rel={rel:.3e} (tol {tol:g}); "
            f"step traced {dus:.2f} us/launch, {b_ms * 1e3 / dus:.1%} of "
            f"its bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB); "
            f"{ms:.4f} ms by events back to back; plain {pms:.4f}")
        del di, x, b, d, dinv, kb


def mono_steps(solver, n_steps):
    """One BDF1 step, then ``n_steps`` BDF2 steps (bench_monodomain's
    order); returns (u, w, iterations per step, the BDF2 steps' wall
    seconds, synchronised)."""
    import torch

    dt = solver.cfg.dt
    u, w = solver.initial_state()
    sync = torch.cuda.synchronize if u.is_cuda else (lambda: None)
    u1, w1, it1 = solver.step(u, u, w, 0.0, True)
    sync()
    t0 = time.perf_counter()
    uf, _, wf, its = solver.steps_scan(u1, u, w1, dt, n_steps)
    sync()
    return uf, wf, [it1] + its, time.perf_counter() - t0


def integrals(solver, u):
    """(int u, int u^2) over the fine mesh: independent of the numbering."""
    uq = solver.u_at_quad(u).double()
    w = solver.w_t.double()
    return float((w * uq).sum()), float((w * uq * uq).sum())


def small_mono_check(torch, dev):
    """The monodomain at n_refinements=3 (levels 8/64/512, all on K0), f64,
    one BDF1 and four BDF2 steps, on the card against the CPU: the same
    iterations per step and u within 1e-10."""
    from polydeal_tpu_torch.models.monodomain import (MonodomainSolver,
                                                      bench_config)

    res = {}
    for name, device in (("cpu", torch.device("cpu")), ("cuda", dev)):
        s = MonodomainSolver.build(bench_config(3), dtype=torch.float64,
                                   relabel="lex", device=device)
        u, w, its, _ = mono_steps(s, 4)
        res[name] = (its, u.cpu(), w.cpu())
    (ic, uc, wc), (ig, ug, wg) = res["cpu"], res["cuda"]
    du = float((uc - ug).abs().max())
    dw = float((wc - wg).abs().max())
    log(f"  n_refinements=3 f64: iterations cpu {ic}, cuda {ig}; "
        f"max |u_cuda - u_cpu| = {du:.3e} (max |u| {float(uc.abs().max()):.3e}"
        f"), max |w_cuda - w_cpu| = {dw:.3e}")
    if ic != ig or not du <= 1e-10:
        fail("small f64 monodomain on the card disagrees with the CPU")


def phase7(torch, dev, k0, k2):
    """Phase 7: the monodomain at bench_monodomain's configuration on the
    card, its f64 run, K0, fused K0 and K2 on its real bands and the small
    card-against-CPU check; returns the launch counts of the f32 run
    (setup, a cold and a warm pass of the steps)."""
    from polydeal_tpu_torch.models.monodomain import (MonodomainSolver,
                                                      bench_config)
    from polydeal_tpu_torch.ops import _build

    log("phase 7: monodomain, bench_monodomain's configuration, on the card")
    _build.reset_launches()
    ms = MonodomainSolver.build(bench_config(6), relabel="lex", device=dev)
    mono_steps(ms, MONO_STEPS)  # cold
    u, w, its, wall = mono_steps(ms, MONO_STEPS)
    counts = dict(_build.launches)
    n_dofs = ms.handler.n_dofs
    formats = [(e.n_block_rows, "banded" if e.data_i is None else
                "banded+i-major", len(e.offsets)) for e in ms.mg.ells]
    phases = {k: round(v, 3) for k, v in ms.setup_phases.items()}
    uq_max = float(ms.u_at_quad(u).max())
    log(f"  levels (P, format, offsets): {formats}, {n_dofs} DoF")
    log(f"  setup phases (s): {phases}")
    log(f"  {MONO_STEPS} warm BDF2 steps: {wall:.4f} s, "
        f"{MONO_STEPS / wall:.2f} steps/s, "
        f"{n_dofs * MONO_STEPS / wall:.1f} DoF*steps/s")
    log(f"  CG iterations per step (BDF1, then BDF2): {its}, mean over the "
        f"BDF2 steps {sum(its[1:]) / MONO_STEPS:.3f}")
    log(f"  max u at quadrature {uq_max:.6f}")
    log(f"  launches over setup + 2 passes of the steps: {counts}")
    if tuple(u.shape) != (n_dofs,) or not bool(torch.isfinite(u).all()):
        fail("monodomain u has the wrong shape or non-finite values")
    if n_dofs != 1048576:
        fail(f"monodomain has {n_dofs} DoF, not 1,048,576")
    if not 0.01 < uq_max < 2.0:
        fail(f"monodomain max u {uq_max:.4f} outside (0.01, 2.0)")
    if not all(2 <= i <= 5 for i in its):
        fail(f"monodomain CG iterations {its} outside 2-5 per step")
    for name in ("banded_matvec_omajor", "banded_fused_omajor",
                 "banded_matvec_imajor", "banded_fused_cheb", "volume_blocks",
                 "face_group_blocks", "boundary_blocks"):
        if counts[name] <= 0:
            fail(f"kernel {name} was never launched on the monodomain path")
    # every K0 level smooths through fused K0: its plain product serves the
    # eigenvalue estimates only (Multigrid.setup: 26 products a level)
    eig = 26 * sum(e.data_i is None for e in ms.mg.ells[1:])
    if counts["banded_matvec_omajor"] > eig:
        fail(f"K0's plain product ran {counts['banded_matvec_omajor']} times,"
             f" more than the {eig} of the eigenvalue estimates")
    # the f32 state the f64 run is held to: the same steps
    u32 = (u if MONO_STEPS_F64 == MONO_STEPS
           else mono_steps(ms, MONO_STEPS_F64)[0])
    m32 = integrals(ms, u32)
    mono_row = mono_arm(torch, ms)
    for e in ms.mg.ells[1:4]:  # 64, 512 and 4096 lanes: K0's levels
        check_k0(torch, f"monodomain {e.n_block_rows}-lane", e, k0)
    check_k0(torch, "monodomain fine (block-Jacobi operator)", ms.A, k0,
             fused=False)
    for e in ms.mg.ells[4:]:  # 32768 and 262144 lanes: K2's levels
        check_k2(torch, f"monodomain {e.n_block_rows}-lane", e, k2)
    del ms, u, w
    torch.cuda.empty_cache()
    from polydeal_tpu_torch.models.profile_sipg import mono_handlers
    level_sipg_check(torch, mono_handlers(bench_config(6)), dev,
                     "monodomain")

    ref = MonodomainSolver.build(bench_config(6), dtype=torch.float64,
                                 relabel="lex", device=dev)
    u64, _, its64, wall64 = mono_steps(ref, MONO_STEPS_F64)
    m64 = integrals(ref, u64)
    del ref
    torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(m32, m64)]
    # not gated: a sharp Heaviside of the ionic model may flip at single
    # quadrature points between f32 and f64
    dmax = float((u32.double() - u64).abs().max())
    log(f"  f64 run ({MONO_STEPS_F64} BDF2 steps, {wall64:.4f} s): "
        f"iterations {its64}; int u {m64[0]:.9e} (f32 {m32[0]:.9e}, rel "
        f"{rel[0]:.3e}), int u^2 {m64[1]:.9e} (f32 {m32[1]:.9e}, rel "
        f"{rel[1]:.3e}); max |u_32 - u_64| {dmax:.3e} (max |u_64| "
        f"{float(u64.abs().max()):.3e})")
    if not max(rel) <= 1e-3:
        fail(f"monodomain f32 integrals differ from the f64 run by {rel}")
    # phase 13's monodomain arm against the same f64 run (not gated, as
    # above)
    mono_row["diff_f32_f64"] = float(
        (mono_row.pop("u_graph").double() - u64).abs().max()) / float(
            u64.abs().max())
    log(f"  phase 13, monodomain: graph u after {MONO_STEPS} BDF2 steps "
        f"against the f64 run: {mono_row['diff_f32_f64']:.3e} (max norm, "
        f"relative)")
    small_mono_check(torch, dev)
    return counts


def ring_ext(torch, x, r, per, T):
    """x_ext of lane slab r of a global x [nb, P]: the slab's lanes with the
    T lanes on each side that its ring neighbours own (wrapped at the
    ends), as the sharded solve's halo exchange gives them."""
    cols = torch.arange(r * per - T, (r + 1) * per + T,
                        device=x.device) % x.shape[1]
    return x[:, cols].contiguous()


class Slab:
    """One shard's slab of a level for the halo kernels: its i-major band
    (and a pack's oid), offsets, nb, lanes and halo width T, with the kept
    launch arguments the sharded solve keeps."""

    def __init__(self, torch, data_i, offs, nb, T, oid=None):
        from polydeal_tpu_torch.ops.banded import imajor_band
        from polydeal_tpu_torch.ops.packed import packed_band

        self.data_i, self.offs, self.nb, self.T, self.oid = (data_i, offs, nb,
                                                             T, oid)
        self.per = data_i.shape[1]
        self.packed = oid is not None
        self.kb = (packed_band(data_i, oid, offs, nb) if self.packed
                   else imajor_band(data_i, offs, nb))

    def calls(self, x_ext, b, d, dinv, c1=0.37, c2=1.21):
        """{mode: (kernel call, plain call)}: the product (K1 or K6 halo),
        and the fused step, first step and residual (K2 or K7 halo)."""
        from polydeal_tpu_torch.ops import banded as bd
        from polydeal_tpu_torch.ops import fused_cheb as fc
        from polydeal_tpu_torch.ops import packed as pk

        T, kb = self.T, self.kb
        if self.packed:
            a = (self.data_i, self.oid, self.offs, self.nb)
            prod = (pk.packed_matvec_t_halo, pk.packed_matvec_t_halo_ref)
            step = (fc.packed_cheb_step_t_halo,
                    fc.packed_cheb_step_t_halo_ref)
            res = (fc.packed_residual_t_halo, fc.packed_residual_t_halo_ref)
        else:
            a = (self.data_i, self.offs, self.nb)
            prod = (bd.banded_matvec_t_halo, bd.banded_matvec_t_halo_ref)
            step = (fc.banded_cheb_step_t_halo,
                    fc.banded_cheb_step_t_halo_ref)
            res = (fc.banded_residual_t_halo, fc.banded_residual_t_halo_ref)
        return {
            "product": (lambda: prod[0](*a, x_ext, tile=T, band=kb),
                        lambda: prod[1](*a, x_ext, tile=T)),
            "step": (lambda: step[0](*a, x_ext, d, b, dinv, c1, c2, tile=T,
                                     band=kb),
                     lambda: step[1](*a, x_ext, d, b, dinv, c1, c2, tile=T)),
            "step0": (lambda: step[0](*a, x_ext, None, b, dinv, c1, c2,
                                      tile=T, band=kb),
                      lambda: step[1](*a, x_ext, None, b, dinv, c1, c2,
                                      tile=T)),
            "residual": (lambda: res[0](*a, x_ext, b, tile=T, band=kb),
                         lambda: res[1](*a, x_ext, b, tile=T)),
        }

    def work(self, vsz: int, step: bool):
        """(bytes, operations) of one product (x_ext in, y out) or fused
        step (x_ext, b, d, dinv in, x', d' out; six operations a vector
        entry): the band entries the kernel reads (a pack's active slots
        and its oid), each once."""
        nb, per = self.nb, self.per
        if self.packed:
            ent = int((self.oid >= 0).sum()) * nb * nb
            extra = self.oid.numel() * 4
        else:
            ent, extra = len(self.offs) * nb * nb * per, 0
        n_vec = 5 if step else 1
        nbytes = (ent * self.data_i.element_size() + extra
                  + nb * (per + 2 * self.T) * vsz + n_vec * nb * per * vsz)
        return nbytes, 2 * ent + (6 * nb * per if step else 0)

    def csr(self, torch):
        """The slab's product as a CSR matrix whose columns are x_ext's."""
        dev, per, T = self.data_i.device, self.per, self.T
        p = torch.arange(per, device=dev).view(1, per)
        if self.packed:
            o = self.oid.long()
            q = T + p + self.offs.long()[o.clamp(min=0)]
            live = o >= 0
        else:
            q = T + p + self.offs.long().view(-1, 1)
            live = torch.ones_like(q, dtype=torch.bool)
        return csr_of_slots(torch, self.data_i, q, live, self.nb,
                            self.data_i.shape[0] // self.nb,
                            n_cols=per + 2 * T)


HALO_KERNELS = {False: ("K1 halo", "K2 halo", "banded_matvec_imajor",
                        "banded_fused_kernel"),
                True: ("K6 halo", "K7 halo", "packed_matvec_kernel",
                       "packed_fused_kernel")}


def check_halo_slab(torch, label, slab, gen, library=False):
    """A halo kernel's modes against their plain versions on one slab, with
    seeded vectors (x_ext's halo from the same draw), in the slab's vector
    type (f32 for a bf16 or f32 band), 1e-5 / 1e-12 relative; the product
    and the step timed by CUDA events beside the plain version, traced
    (device time per launch, ``cold_traced_us``) and beside their bound;
    with ``library``, a
    CSR product of the slab with its halo columns too (the product's
    library yardstick); K1 halo's launch plan (W, S).  Returns each
    kernel's row (name -> row)."""
    from polydeal_tpu_torch.ops.banded import k1_plan

    dname = str(slab.data_i.dtype).split(".")[-1]
    vdt = torch.float64 if dname == "float64" else torch.float32
    pdt = "float64" if dname == "float64" else "float32"
    nb, per, T = slab.nb, slab.per, slab.T
    x_ext = torch.randn(nb, per + 2 * T, generator=gen, device=gen.device,
                        dtype=torch.float64).to(vdt)
    _, b, d, dinv = cheb_vectors(torch, gen, nb, per, vdt)
    calls = slab.calls(x_ext, b, d, dinv)
    errs = {}
    for mode, (kf, pf) in calls.items():
        errs[mode] = hold(f"{label} {mode} {dname}", kf(), pf(), TOL[dname])
    pname, fname, ptrace, ftrace = HALO_KERNELS[slab.packed]
    if not slab.packed:
        ptrace, ftrace = traced_name(nb, ptrace), traced_name(nb, ftrace)
    line, rows = [], {}
    for name, mode, trace in ((pname, "product", ptrace),
                              (fname, "step", ftrace)):
        kf, pf = calls[mode]
        ms, pms = time_pair(torch, kf, pf, reps=20)
        nbytes, flops = slab.work(x_ext.element_size(), mode == "step")
        b_ms, b_by = bound(nbytes, flops, pdt)
        dus = cold_traced_us(torch, kf, trace, nbytes, b_ms,
                             f"{name} on {label} {dname}", n=20)
        lms = None
        if library and mode == "product":
            A = slab.csr(torch)
            xf = x_ext.T.contiguous().view(-1)
            yl = torch.mv(A, xf).view(per, nb).T
            lerr = float((yl - kf()).abs().max()) / float(yl.abs().max())
            if not lerr <= TOL[dname]:
                fail(f"CSR product disagrees with {name} on {label}: rel "
                     f"{lerr:.3e}")
            lms = time_one(torch, lambda: torch.mv(A, xf))
            del A, xf, yl
        err = max(e for m, (e, _) in errs.items()
                  if (m == "product") == (mode == "product"))
        rows[name] = dict(max_abs_err=err, ms=dus / 1e3, plain_ms=pms,
                          bound_ms=b_ms, bound_by=b_by, library_ms=lms,
                          events_ms=ms)
        if name == "K1 halo":
            plan = k1_plan(slab.kb, x_ext, T)
            rows[name]["plan"] = plan_of(slab.kb, plan, x_ext, T)
            line.append(f"K1 halo plan {rows[name]['plan']}")
        line.append(f"{name} {mode} traced {dus:.2f} us/launch, "
                    f"{b_ms * 1e3 / dus:.1%} of its bound {b_ms:.4f} ms "
                    f"({b_by}: {nbytes / 1e6:.1f} MB), events {ms:.4f} ms, "
                    f"plain {pms:.4f}"
                    + ("" if lms is None else f", CSR {lms:.4f}"))
    worst = max(r for _, r in errs.values())
    log(f"  {label} {dname} (per={per}, T={T}): all modes worst rel "
        f"{worst:.3e} (tol {TOL[dname]:g}); " + "; ".join(line))
    del x_ext, b, d, dinv, calls
    return rows


def check_halo_cuts(torch, label, e, n_cut=4, bitwise=False):
    """The halo kernels on ``n_cut`` lane slabs of the real level ``e`` (a
    band with its i-major copy, or a pack: repacked with a far tail where
    its plan reaches beyond a slab, as the sharded solve does), with x_ext
    taken from one seeded global x ring-wrapped at the ends: every mode of
    every slab against its plain version (``check_halo_slab``, timed on
    slab 1 beside the slab's CSR product, but for a bf16 band), and the
    slabs' products side by side (plus a far tail's product) against the
    unsharded K1 or K6 product of the whole level.  In the level's type
    and as f64; with ``bitwise`` every mode of every slab launched twice,
    equal bits.  Returns slab 1's rows by type (dtype name -> kernel name
    -> row)."""
    from polydeal_tpu_torch.parallel.banded import _shard_ready, _tile_for

    P, nb = e.n_block_rows, e.n_basis
    per = P // n_cut
    ready = _shard_ready(e, per)
    T = _tile_for(ready, per)
    packed = hasattr(ready, "plan")
    gen = torch.Generator(device=ready.data_i.device).manual_seed(8)
    rows = {}
    for data in (ready.data_i, ready.data_i.double()):
        dname = str(data.dtype).split(".")[-1]
        vdt = torch.float64 if dname == "float64" else torch.float32
        x = torch.randn(nb, P, generator=gen, device=gen.device,
                        dtype=torch.float64).to(vdt)
        ys = []
        for r in range(n_cut):
            lanes = slice(r * per, (r + 1) * per)
            slab = Slab(torch, data[:, lanes].contiguous(), ready.offsets_t,
                        nb, T, ready.oid[:, lanes].contiguous() if packed
                        else None)
            x_ext = ring_ext(torch, x, r, per, T)
            _, b, d, dinv = cheb_vectors(torch, gen, nb, per, vdt)
            calls = slab.calls(x_ext, b, d, dinv)
            for mode, (kf, pf) in calls.items():
                hold(f"{label} slab {r} {mode} {dname}", kf(), pf(),
                     TOL[dname])
            if bitwise:
                twice_equal(torch, f"{label} slab {r} {dname}", calls)
            ys.append(calls["product"][0]())
            if r == 1:  # cuSPARSE takes no bf16 matrix with f32 vectors
                rows[dname] = check_halo_slab(
                    torch, f"{label} slab 1 of {n_cut}", slab, gen,
                    library=data.dtype != torch.bfloat16)
            del slab, x_ext, b, d, dinv, calls
        y = torch.cat(ys, dim=1)
        if packed:
            from polydeal_tpu_torch.ops.packed import packed_matvec_t
            whole = packed_matvec_t(e.data_i.to(data.dtype), e.oid,
                                    e.offsets_t, nb, x)
            y = y + ready.far_matvec_t(x)
        else:
            from polydeal_tpu_torch.ops.banded import banded_matvec_t_imajor
            whole = banded_matvec_t_imajor(data, ready.offsets_t, nb, x)
        err, rel = hold(f"{label} {n_cut} slabs side by side against the "
                        f"whole level's product {dname}", y, whole,
                        TOL[dname])
        log(f"  {label} {dname}: {n_cut} slabs of {per} lanes, T={T}"
            + (f", far tail {ready.far_rows.size} blocks"
               if packed and ready.far_data is not None else "")
            + f"; side by side against the whole level's product: rel "
            f"{rel:.3e}")
        del x, ys, y, whole
    torch.cuda.empty_cache()
    return rows


def shard_flagship(torch, label, fs, group, x64, by_cell=False, tol=1e-4):
    """A flagship system sharded at world size 1 against its unsharded
    no-FMG solve: both reach rtol 1e-8, within one iteration of each other,
    and the f32 sharded solution lies within ``tol`` of ``x64`` (an f64
    solution of the same system; by cell with ``by_cell``).  Returns (the
    sharded system, the launch counts of its solve)."""
    from polydeal_tpu_torch.ops import _build
    from polydeal_tpu_torch.parallel.banded import ShardedBandedSystem

    bnorm = float(fs.b.norm())
    ru = fs.mg.solve_cg(fs.b, rtol=1e-8, maxiter=100)
    ss = ShardedBandedSystem.from_multigrid(fs.mg, group)
    torch.cuda.synchronize()
    _build.reset_launches()
    x, k, res = ss.solve_cg(fs.b, rtol=1e-8, maxiter=100)
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    xs = cell_order(torch, fs, x) if by_cell else x.double()
    diff = float((xs - x64).abs().max()) / float(x64.abs().max())
    halo = {n: c for n, c in counts.items() if n.endswith("_halo")}
    log(f"  {label} sharded at world size 1: levels (kind, per, T) "
        f"{[(lv.kind, lv.per, lv.T) for lv in ss.levels]}, replicated "
        f"bottom {ss.rep_mg.n_levels} level(s); {k} iterations (unsharded "
        f"no-FMG {ru.iterations}), relative residual {res / bnorm:.3e} "
        f"(unsharded {float(ru.residual) / bnorm:.3e}); max |x_sharded - "
        f"x_f64| / max |x_f64| = {diff:.3e}; halo launches {halo}")
    if tuple(x.shape) != (fs.n_dofs,) or not bool(torch.isfinite(x).all()):
        fail(f"{label} sharded solution has the wrong shape or non-finite "
             f"values")
    if not (res <= 1e-8 * bnorm and float(ru.residual) <= 1e-8 * bnorm):
        fail(f"{label}: a solve missed rtol 1e-8")
    if abs(k - ru.iterations) > 1:
        fail(f"{label}: sharded {k} iterations, unsharded {ru.iterations}")
    if not diff <= tol:
        fail(f"{label} sharded f32 solution differs from the f64 one by "
             f"{diff:.3e}")
    return ss, counts


def small_sharded_check(torch, dev, group):
    """The structured n=16 f64 system sharded at world size 1 on the card
    (its kernels) against the same on the CPU (plain versions): the same
    iterations, solutions within 1e-10."""
    from polydeal_tpu_torch.models.sharded import setup_sharded, solve_sharded

    res = {}
    for name, device, grp in (("cpu", torch.device("cpu"), None),
                              ("cuda", dev, group)):
        sh = setup_sharded(16, device=device, group=grp, dtype=torch.float64,
                           precond_dtype=None)
        x, k, r = solve_sharded(sh)
        res[name] = (k, x.cpu(), r / float(sh.b.norm()))
    (ic, xc, rc), (ig, xg, rg) = res["cpu"], res["cuda"]
    diff = float((xc - xg).abs().max())
    log(f"  n=16 structured f64 sharded: cpu {ic} iterations (rel res "
        f"{rc:.3e}), cuda {ig} (rel res {rg:.3e}), max |x_cuda - x_cpu| = "
        f"{diff:.3e}")
    if ic != ig or not diff <= 1e-10:
        fail("small f64 sharded solve on the card disagrees with the CPU")


def phase8(torch, dev, group, rows):
    """Phase 8, bench_sharded's configuration: the structured n=64 flagship
    unsharded and sharded at world size 1, each cold and then warm; the f64
    solve it is held to; K1 halo and K2 halo on the main path's slabs (the
    rows) and on 4-way cuts of the 32768-lane band; the small card-against-
    CPU check.  Returns the launch counts of the sharded solves."""
    from polydeal_tpu_torch.models.flagship import setup_flagship
    from polydeal_tpu_torch.models.sharded import min_ms
    from polydeal_tpu_torch.ops import _build
    from polydeal_tpu_torch.parallel.banded import ShardedBandedSystem

    log("phase 8: sharded solve at world size 1 (bench_sharded's "
        "configuration)")
    fst = setup_flagship(n=64, hierarchy="structured", device=dev)
    bnorm = float(fst.b.norm())
    ru = fst.mg.solve_cg(fst.b, rtol=1e-8, maxiter=100)  # cold
    unsharded_ms = min_ms(lambda: fst.mg.solve_cg(fst.b, rtol=1e-8,
                                                  maxiter=100), dev)
    ss = ShardedBandedSystem.from_multigrid(fst.mg, group)
    torch.cuda.synchronize()
    _build.reset_launches()
    x, k, res = ss.solve_cg(fst.b, rtol=1e-8, maxiter=100)  # cold
    sharded_ms = min_ms(lambda: ss.solve_cg_local(
        fst.b, rtol=1e-8, maxiter=100), dev)
    counts = dict(_build.launches)
    log(f"  levels {fst.level_sizes}, band offsets "
        f"{fst.band_offsets.tolist()}, {fst.n_dofs} DoF; sharded levels "
        f"(kind, per, T) {[(lv.kind, lv.per, lv.T) for lv in ss.levels]}")
    log(f"  unsharded (no FMG): {ru.iterations} iterations, relative "
        f"residual {float(ru.residual) / bnorm:.3e}; sharded: {k} "
        f"iterations, relative residual {res / bnorm:.3e}")
    log(f"  unsharded_ms {unsharded_ms:.3f}, sharded_ms {sharded_ms:.3f}, "
        f"ratio {sharded_ms / unsharded_ms:.4f} (least of 3 warm solves "
        f"each)")
    log(f"  launches over the sharded cold + 3 warm solves: {counts}")
    if tuple(x.shape) != (fst.n_dofs,) or not bool(torch.isfinite(x).all()):
        fail("sharded solution has the wrong shape or non-finite values")
    for it, r, name in ((ru.iterations, float(ru.residual), "unsharded"),
                        (k, res, "sharded")):
        if not r <= 1e-8 * bnorm:
            fail(f"{name} structured solve missed rtol 1e-8")
        if not 21 <= it <= 25:
            fail(f"{name} structured solve took {it} iterations, outside "
                 f"21-25")
    if abs(k - ru.iterations) > 1:
        fail(f"sharded {k} iterations, unsharded {ru.iterations}")
    for name in ("banded_matvec_halo", "banded_fused_halo"):
        if counts[name] <= 0:
            fail(f"kernel {name} was never launched on the sharded path")
    ref = setup_flagship(n=64, hierarchy="structured", device=dev,
                         dtype=torch.float64, precond_dtype=None)
    r64 = ref.mg.solve_cg(ref.b, rtol=1e-8, maxiter=100)
    diff = float((x.double() - r64.x).abs().max()) / float(
        r64.x.abs().max())
    log(f"  f64 unsharded solve: {r64.iterations} iterations; max "
        f"|x_sharded_f32 - x_f64| / max |x_f64| = {diff:.3e}")
    sharded_arm(torch, "structured sharded (world size 1)", ss, fst.b,
                r64.x, lambda x: x.double())
    del ref, r64
    torch.cuda.empty_cache()
    if not diff <= 1e-4:
        fail(f"sharded f32 solution differs from the f64 one by {diff:.3e}")
    # the main path's own slabs: the fine level's f32 band (CG's product)
    # and its bf16 copy (the smoother's fused steps)
    fine, pl = ss.levels[-1], ss.params[-1]
    gen = torch.Generator(device=dev).manual_seed(9)
    rows["K1 halo"] = check_halo_slab(torch, "structured fine slab", Slab(
        torch, pl["data_i"], pl["offsets_t"], fine.nb, fine.T), gen,
        library=True)["K1 halo"]
    rows["K2 halo"] = check_halo_slab(
        torch, "structured fine slab bf16 copy", Slab(
            torch, pl["lo_data_i"], pl["offsets_t"], fine.nb, fine.T),
        gen)["K2 halo"]
    del ss, x
    torch.cuda.empty_cache()
    check_halo_cuts(torch, "structured 32768-lane", fst.mg.ells[2])
    check_halo_cuts(torch, "structured 32768-lane bf16 copy",
                    fst.mg.lo_ells[2])
    del fst
    torch.cuda.empty_cache()
    small_sharded_check(torch, dev, group)
    return counts


# Phase 9's reference numbers: the JAX package on the CPU in float64,
# printed by `JAX_PLATFORMS=cpu python tools/jax_coo_constants.py`
# (iterations; L2 and H1 errors against the manufactured solution)
JAX_COO = {
    "poisson_3d_p1_n16": dict(iterations=12, l2=0.07502740465533374,
                              h1=0.4539264909298265),
    "poisson_3d_p1_n32": dict(iterations=16, l2=0.02333237656792849,
                              h1=0.15964059153189242),
    "poisson_3d_p2_n16": dict(iterations=19, l2=0.00041938644389233765,
                              h1=0.015696880527529253),
    "poisson_3d_p2_n32": dict(iterations=20, l2=2.988259911722032e-05,
                              h1=0.003306858071487926),
    "dr_3d_p1_n16": dict(iterations=12, l2=0.07308616534835945),
    "dr_3d_p1_n32": dict(iterations=16, l2=0.022619463828097142),
    "poisson_2d_p2_n128_metis_cg": dict(iterations=476,
                                        l2=1.1047127716885137e-06,
                                        h1=0.0005459963142448804),
    "galerkin_3d_p1_n32": dict(iterations=22, l2=0.02333237656791932),
}
COO_TOL = 1e-8  # relative, L2 and H1 (BASELINE.md's gate)


def hold_jax(label, key, r, its=1, tol=COO_TOL, tol_l2=None):
    """A card run's iterations (within ``its``) and L2/H1 errors (relative
    ``tol``; ``tol_l2`` for L2 where given) against the JAX constants."""
    ref = JAX_COO[key]
    errs = {k: abs(r[k] - ref[k]) / ref[k] for k in ("l2", "h1") if k in ref}
    log(f"  {label}: {r['iterations']} iterations (JAX {ref['iterations']})"
        f", " + ", ".join(f"{k} {r[k]!r} (rel diff {e:.2e})"
                          for k, e in errs.items()))
    if abs(r["iterations"] - ref["iterations"]) > its:
        fail(f"{label}: {r['iterations']} iterations, JAX "
             f"{ref['iterations']}")
    for k, e in errs.items():
        lim = tol_l2 if (k == "l2" and tol_l2 is not None) else tol
        if not e <= lim:
            fail(f"{label}: {k} differs from the JAX package's by {e:.3e} "
                 f"> {lim:g}")


def rate(a, b):
    import math

    return math.log2(a / b)


def plan_of(kb, plan, x, halo=None):
    """K1's launch plan as a row's ``plan``: W lanes a thread, S offset
    groups, R rows a thread and CB row chunks a block; at an nb without a
    specialised build held to ``ops/banded.any_nb_plan``, the plan's
    Python statement."""
    from polydeal_tpu_torch.ops.banded import KERNEL_NB, any_nb_plan

    if kb.nb not in KERNEL_NB:
        want = any_nb_plan(kb.nb, kb.n_off, kb.P, kb.dtype, x.dtype,
                           ldx=x.shape[1], halo=halo or 0)
        if tuple(plan) != tuple(want):
            fail(f"K1's runtime-nb plan {plan} is not any_nb_plan's {want}")
    return dict(W=plan.W, S=plan.S, R=plan.rows, CB=plan.chunks)


def check_k1(torch, label, band, out):
    """K1 against its plain version on a real i-major band, in the band's
    type (f32 for an f64 band) and as f64, 1e-5 / 1e-12 relative to
    the largest entry, through the band's kept launch arguments; traced
    (device time per launch, L2 evicted where the band exceeds it, held to
    its bound by ``cold_traced_us``), by CUDA events beside the plain
    version, and a torch.sparse CSR product of the same band; its launch
    plan (W, S) printed, two launches bitwise equal.  Adds each case to
    ``out`` (label -> row)."""
    from polydeal_tpu_torch.ops.banded import (banded_matvec_t_imajor,
                                               banded_matvec_t_imajor_ref,
                                               imajor_band, k1_plan)

    di0 = band.data_i
    nb, P, offs = band.n_basis, di0.shape[1], band.offsets_t
    n_off, R_pad = len(band.offsets), di0.shape[0] // band.n_basis
    gen = torch.Generator(device=di0.device).manual_seed(6)
    for di in band_types(torch, di0):
        dname = str(di.dtype).split(".")[-1]
        vdt = torch.float64 if dname == "float64" else torch.float32
        tol = TOL[dname]
        kb = imajor_band(di, offs, nb)
        x = cheb_vectors(torch, gen, nb, P, vdt)[0]
        kf = lambda: banded_matvec_t_imajor(di, offs, nb, x, band=kb)
        pf = lambda: banded_matvec_t_imajor_ref(di, offs, nb, x)
        got = kf()
        err, rel = hold(f"K1 on {label} {dname}", got, pf(), tol)
        if not torch.equal(got, kf()):
            fail(f"two K1 launches on {label} {dname} differ")
        plan = k1_plan(kb, x)
        ms, pms = time_pair(torch, kf, pf)
        ent = n_off * nb * nb * P
        nbytes = ent * di.element_size() + 2 * nb * P * x.element_size()
        pdt = "float64" if dname == "float64" else "float32"
        b_ms, b_by = bound(nbytes, 2 * ent, pdt)
        dus = cold_traced_us(torch, kf, traced_name(nb, "imajor_kernel"),
                             nbytes, b_ms, f"K1 on {label} {dname}")
        A = csr_of_band(torch, di, band.offsets.tolist(), nb, R_pad, P)
        xf = x.T.contiguous().view(-1)
        yl = torch.mv(A, xf).view(P, nb).T
        lerr = float((yl - got).abs().max()) / float(yl.abs().max())
        if not lerr <= tol:
            fail(f"CSR product disagrees with K1 on {label}: rel "
                 f"{lerr:.3e}")
        lms = time_one(torch, lambda: torch.mv(A, xf))
        del A, xf, yl
        out[f"{label} {dname}"] = dict(
            max_abs_err=err, ms=dus / 1e3, plain_ms=pms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lms, events_ms=ms,
            plan=plan_of(kb, plan, x))
        log(f"  K1 {label} {dname} (P={P}, {n_off} offsets; plan "
            f"{out[f'{label} {dname}']['plan']}; two launches bitwise equal): "
            f"max_abs_err={err:.3e} rel={rel:.3e} (tol {tol:g}); traced "
            f"{dus:.2f} us/launch, {b_ms * 1e3 / dus:.1%} of its bound "
            f"{b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB); {ms:.4f} ms by "
            f"events; plain {pms:.4f}; CSR torch.mv {lms:.4f}")
        del di, x, kb, got


def phase9(torch, dev):
    """Phase 9: the general block-COO path and the scalar models on the
    card (see the module docstring).  Returns (the launch counts of the
    n=64 Poisson solve, its kernels' rows, its system and solution for
    phase 12)."""
    from polydeal_tpu_torch.agglomeration import RTreeAgglomerator
    from polydeal_tpu_torch.assembly.sipg import (assemble_rhs,
                                                  assemble_sipg_matrix)
    from polydeal_tpu_torch.mesh import hyper_cube
    from polydeal_tpu_torch.models.diffusion_reaction import (
        convergence_study, solve_diffusion_reaction)
    from polydeal_tpu_torch.models.poisson import solve_poisson
    from polydeal_tpu_torch.ops import _build
    from polydeal_tpu_torch.postprocess import compute_global_error
    from polydeal_tpu_torch.solvers import (build_multigrid,
                                            build_rtree_hierarchy)

    import math

    t_phase = time.perf_counter()
    log("phase 9: the general COO path and the scalar models")
    # (a) Poisson, 3D, p=1, R-tree + R3MG, f64: n=16 and 32 against the
    # JAX package, then n=64 (1,048,576 DoF), the path the counters read
    res = {}
    for n in (16, 32):
        res[n] = solve_poisson(dim=3, n=n, degree=1, device=dev,
                               verbose=False)
        hold_jax(f"(a) poisson 3D p=1 n={n} f64", f"poisson_3d_p1_n{n}",
                 res[n])
        res[n] = {k: res[n][k] for k in ("l2", "h1", "iterations")}
    _build.reset_launches()
    ra = solve_poisson(dim=3, n=64, degree=1, device=dev, verbose=False)
    counts = dict(_build.launches)
    log(f"  (a) poisson 3D p=1 n=64 f64: {ra['n_dofs']} DoF; levels "
        f"(polytopes, format, band offsets) {ra['levels']}")
    log(f"  (a) host seconds: setup {ra['t_setup']:.3f}, assembly "
        f"{ra['t_assembly']:.3f}, MG setup + solve {ra['t_solve']:.3f}; "
        f"{ra['iterations']} iterations, relative residual "
        f"{ra['residual'] / float(ra['b'].norm()):.3e}; l2 {ra['l2']!r}, "
        f"h1 {ra['h1']!r}")
    log(f"  (a) launches over setup + solve: {counts}")
    x64 = ra["x"]
    if tuple(x64.shape) != (ra["n_dofs"],) or not bool(
            torch.isfinite(x64).all()):
        fail("COO Poisson solution has the wrong shape or non-finite values")
    if ra["n_dofs"] != 1048576 or len(ra["levels"]) != 6:
        fail(f"COO Poisson: {ra['n_dofs']} DoF on levels {ra['levels']}")
    if not all(f.startswith("banded") for _, f, _ in ra["levels"]):
        fail(f"a COO Poisson level is not banded: {ra['levels']}")
    if not ra["residual"] <= 1e-9 * float(ra["b"].norm()) * 1.01:
        fail("COO Poisson missed rtol 1e-9")
    for name in ("banded_matvec_imajor", "banded_fused_cheb",
                 "banded_matvec_omajor", "banded_fused_omajor"):
        if counts[name] <= 0:
            fail(f"kernel {name} was never launched on the COO path")
    # no JAX constant at n=64 (see PERF.md section 4): the H1 rate from
    # n=32 within 0.1 of the JAX rate 16 -> 32 (1.508); the L2 rate, still
    # rising towards p + 1 = 2 (JAX 0.59, 1.20, 1.69 from n=4 to 32), at
    # least the JAX rate less 0.1 and at most 2.1; the iterations those of
    # the card's proof run (19) within 1
    r_l2 = rate(res[32]["l2"], ra["l2"])
    r_h1 = rate(res[32]["h1"], ra["h1"])
    j16, j32 = JAX_COO["poisson_3d_p1_n16"], JAX_COO["poisson_3d_p1_n32"]
    jr_l2, jr_h1 = rate(j16["l2"], j32["l2"]), rate(j16["h1"], j32["h1"])
    log(f"  (a) rates 32 -> 64: L2 {r_l2:.4f}, H1 {r_h1:.4f} (JAX 16 -> 32:"
        f" {jr_l2:.4f}, {jr_h1:.4f})")
    if not (jr_l2 - 0.1 <= r_l2 <= 2.1 and abs(r_h1 - jr_h1) <= 0.1):
        fail("COO Poisson n=64 rates leave the JAX sequence's range")
    if not abs(ra["iterations"] - 19) <= 1:
        fail(f"COO Poisson n=64 took {ra['iterations']} iterations")

    # (g) determinism: two assemblies of the fine BlockMatrix bitwise
    # equal, two solves of the same system the same iterations
    ah = ra["handlers"][-1]
    A2 = assemble_sipg_matrix(ah, device=dev)
    A3 = assemble_sipg_matrix(ah, device=dev)
    same = (torch.equal(A2.data, A3.data) and torch.equal(A2.data,
                                                           ra["A"].data))
    del A2, A3
    its = [ra["mg"].solve_cg(ra["b"], rtol=1e-9).iterations
           for _ in range(2)]
    log(f"  (g) fine BlockMatrix assembled three times bitwise equal: "
        f"{same}; two more solves: {its} iterations")
    if not same or its != [ra["iterations"]] * 2:
        fail("the COO path is not deterministic on the card")

    # phase 12 (a) shards (a)'s system on the flat block-COO path
    keep9 = dict(mg=ra["mg"], b=ra["b"], x=ra["x"],
                 iterations=ra["iterations"])
    # (f) K1, K2 (three modes), K0 and fused K0 on (a)'s real bands: the
    # path's own f64 bands, and their f32 casts
    mg = ra["mg"]
    rows = {"K1": {}, "K2": {}, "K0": {}}
    for e in mg.ells:
        if e.data_i is not None:
            lab = f"COO {e.n_block_rows}-lane {len(e.offsets)}-offset"
            check_k1(torch, lab, e, rows["K1"])
            check_k2(torch, lab, e, rows["K2"])
        elif e.n_block_rows == 4096:
            check_k0(torch, f"COO 4096-lane {len(e.offsets)}-offset", e,
                     rows["K0"])
    del mg, ah
    ra = {k: ra[k] for k in ("l2", "h1", "iterations")}
    torch.cuda.empty_cache()

    # (b) the same configuration in f32, rtol 1e-8, against (a)'s solution
    rb = solve_poisson(dim=3, n=64, degree=1, dtype=torch.float32,
                       rtol=1e-8, device=dev, verbose=False)
    diff = float((rb["x"].double() - x64).abs().max()) / float(
        x64.abs().max())
    log(f"  (b) poisson n=64 f32: {rb['iterations']} iterations, l2 "
        f"{rb['l2']:.6e}; max |x_f32 - x_f64| / max |x_f64| = {diff:.3e}")
    del rb, x64
    torch.cuda.empty_cache()
    if not diff <= 1e-4:
        fail(f"COO f32 solution differs from the f64 one by {diff:.3e}")

    # (c) p=2 (nb = 10, K2's NB=10 on the 32768-lane band)
    rc = solve_poisson(dim=3, n=16, degree=2, device=dev, verbose=False)
    hold_jax("(c) poisson 3D p=2 n=16 f64", "poisson_3d_p2_n16", rc)
    _build.reset_launches()
    rc = solve_poisson(dim=3, n=32, degree=2, device=dev, verbose=False)
    c_counts = dict(_build.launches)
    log(f"  (c) poisson 3D p=2 n=32 f64: {rc['n_dofs']} DoF, levels "
        f"{rc['levels']}; {rc['iterations']} iterations, l2 {rc['l2']!r}, "
        f"h1 {rc['h1']!r}; host seconds setup {rc['t_setup']:.3f}, "
        f"assembly {rc['t_assembly']:.3f}, MG setup + solve "
        f"{rc['t_solve']:.3f}")
    if "poisson_3d_p2_n32" in JAX_COO:
        hold_jax("(c) poisson 3D p=2 n=32 f64", "poisson_3d_p2_n32", rc)
    if rc["n_dofs"] != 327680 or c_counts["banded_fused_cheb"] <= 0:
        fail("the p=2 COO solve did not run K2 at 327,680 DoF")
    del rc
    torch.cuda.empty_cache()

    # (d) diffusion-reaction convergence study, 3D, p=1
    errs, rates = convergence_study(dim=3, degree=1, sizes=(16, 32, 64),
                                    verbose=False, device=dev)
    log(f"  (d) diffusion-reaction L2 at n=16/32/64: {errs}; rates {rates}")
    for n, e in zip((16, 32), errs):
        ref = JAX_COO[f"dr_3d_p1_n{n}"]["l2"]
        if not abs(e - ref) / ref <= COO_TOL:
            fail(f"diffusion-reaction n={n} L2 {e!r}, JAX {ref!r}")
    jr = rate(JAX_COO["dr_3d_p1_n16"]["l2"], JAX_COO["dr_3d_p1_n32"]["l2"])
    if not abs(rates[0] - jr) <= 0.1 or not jr - 0.1 <= rates[1] <= 2.1:
        fail(f"diffusion-reaction rates {rates}, JAX 16 -> 32 {jr:.4f}")

    # (e) the other arms: block-Jacobi CG on the partition, the COO SpMV.
    # Its L2 error, 1.1e-6, moves with the algebraic error that rtol 1e-9
    # leaves and so with the reduction order: relative to the JAX
    # package's it reads 6.6e-8 in the port on the CPU and 4.23e-8 on the
    # card (476 iterations, as JAX); held to 2e-7
    re_ = solve_poisson(dim=2, n=128, degree=2, strategy="metis",
                        solver="cg", device=dev, verbose=False)
    hold_jax("(e) poisson 2D p=2 n=128 metis + block-Jacobi CG",
             "poisson_2d_p2_n128_metis_cg", re_, tol_l2=2e-7)
    mesh = hyper_cube(3, 32)
    agg = RTreeAgglomerator.build(mesh.cell_centers())
    hs, ps = build_rtree_hierarchy(mesh, agg,
                                   list(range(1, agg.n_levels - 1)))
    u = lambda x: torch.prod(torch.sin(math.pi * x), dim=-1)
    A = assemble_sipg_matrix(hs[-1], device=dev)
    b = assemble_rhs(hs[-1], lambda x: 3 * math.pi**2 * u(x), u,
                     device=dev)
    r = build_multigrid(hs, ps, A, mode="galerkin", device=dev).solve_cg(
        b, rtol=1e-9)
    l2 = float(compute_global_error(hs[-1], r.x, u)[0])
    hold_jax("(e) Galerkin R3MG 3D p=1 n=32", "galerkin_3d_p1_n32",
             dict(iterations=r.iterations, l2=l2))
    del A, b, r, hs
    torch.cuda.empty_cache()

    # (h) card against CPU, f64, small
    for name, fn in (("poisson", solve_poisson),
                     ("diffusion-reaction", solve_diffusion_reaction)):
        got = {d.type: fn(dim=2, n=16, device=d, verbose=False)
               for d in (torch.device("cpu"), dev)}
        xc, xg = got["cpu"]["x"], got["cuda"]["x"].cpu()
        dx = float((xc - xg).abs().max()) / float(xc.abs().max())
        log(f"  (h) {name} 2D n=16 f64: iterations cpu "
            f"{got['cpu']['iterations']}, cuda {got['cuda']['iterations']};"
            f" max |x_cuda - x_cpu| / max |x| = {dx:.3e}")
        if got["cpu"]["iterations"] != got["cuda"]["iterations"] or \
                not dx <= 1e-12:
            fail(f"small {name} on the card disagrees with the CPU")
    log(f"  phase 9 took {time.perf_counter() - t_phase:.1f} s")
    # the JSON rows: each kernel at the widest band it served, in f64 (the
    # path's type), with the worst error over its cases
    out = {}
    for key, cases in (("K1", rows["K1"]), ("K2", rows["K2"]),
                       ("K0", {k: v for k, v in rows["K0"].items()
                               if not k.endswith("fused")}),
                       ("K0 fused", {k: v for k, v in rows["K0"].items()
                                     if k.endswith("fused")})):
        f64 = [k for k in cases if "float64" in k]
        main = max(f64, key=lambda k: int(k.split()[1].split("-")[0]))
        out[key] = dict(cases[main], case=f"poisson {main}", max_abs_err=max(
            r["max_abs_err"] for r in cases.values()))
    return counts, out, keep9


# Phase 10's reference numbers: the JAX package on the CPU in float64,
# printed by `JAX_PLATFORMS=cpu python tools/jax_coupled_constants.py`
JAX_COUPLED = {
    "amg_poisson_3d_p1_n16": dict(n_dofs=16384, iterations=29,
                                  l2=0.0750274046553536,
                                  h1=0.4539264909294495),
    "amg_poisson_3d_p1_n32": dict(n_dofs=131072, iterations=42,
                                  l2=0.023332376567958526,
                                  h1=0.15964059153215437),
    "dr_partition_2d_n16": dict(n_dofs=192, iterations=1,
                                l2=0.1513360635470188),
    "dr_partition_2d_n32": dict(n_dofs=768, iterations=1,
                                l2=0.053608865950191126),
    "darcy_n8": dict(n_dofs=144, u_l2=0.056707246115525196,
                     u_h1=0.46507805250321155, pS_l2=0.04990136301719278,
                     pD_l2=0.057186480451021156, mg_iterations=49),
    "darcy_n16": dict(n_dofs=576, u_l2=0.03612397695063006,
                      u_h1=0.2443558545859147, pS_l2=0.025910691094422313,
                      pD_l2=0.03694115686779079, mg_iterations=92),
    "darcy_n32": dict(n_dofs=2304, u_l2=0.01626329666616923,
                      u_h1=0.11375371784957954, pS_l2=0.011265714061982176,
                      pD_l2=0.017845789714896695, mg_iterations=103),
    "darcy_n64": dict(n_dofs=9216, u_l2=0.005574937094664417,
                      u_h1=0.04076617802081959, pS_l2=0.0039109979295395055,
                      pD_l2=0.006260585360370239, mg_iterations=109),
    "oseen_n16": dict(n_dofs=960, u_l2=0.24924683252891833,
                      u_h1=4.238398051898277, p_l2=0.5742698286533473,
                      mg_iterations=130),
    "oseen_curved_n16": dict(n_dofs=1080, u_l2=0.27273422516763973,
                             u_h1=4.660005189225814, p_l2=0.5888595542051563),
    "piston_n16": dict(n_poly=3556, n_dofs=14224, iterations=16,
                       u_min=0.01320954669275505, u_max=0.988985889445128),
    "hp": dict(n_dofs=72, l2=0.005362539284798911, x_norm=3.729248102781793),
}
# darcy_stokes MG-GMRES iterations over n = 8/16/32/64, the JAX package's
# recorded trajectory (docs/MIGRATION.md:143) at its tests' tolerance
# (tests/test_darcy_stokes.py:158); the card is held to each +-2
DARCY_ITS = {8: 49, 16: 92, 32: 103, 64: 109}
COUPLED_RTOL = 1e-11


def hold_rel(label, got, ref, tol):
    """``got`` within ``tol`` relative of ``ref`` (each a dict of the same
    keys), printed."""
    errs = {k: abs(got[k] - ref[k]) / abs(ref[k]) for k in ref}
    log(f"  {label}: " + ", ".join(f"{k} {got[k]!r} (rel diff {e:.2e})"
                                   for k, e in errs.items()))
    for k, e in errs.items():
        if not e <= tol:
            fail(f"{label}: {k} differs from the JAX package's by {e:.3e} "
                 f"> {tol:g}")


def bitwise_k0(torch, label, band):
    """Two launches of K0 and of fused K0's step on ``band`` (its own
    type) bitwise equal."""
    from polydeal_tpu_torch.ops import fused_cheb as fc
    from polydeal_tpu_torch.ops.banded import (banded_matvec_t_omajor,
                                               omajor_band)

    data = band.data
    vdt = torch.float64 if data.dtype == torch.float64 else torch.float32
    gen = torch.Generator(device=data.device).manual_seed(7)
    x, b, d, dinv = cheb_vectors(torch, gen, band.n_basis, band.n_block_rows,
                                 vdt)
    kb = omajor_band(data, band.offsets_t)
    runs = [(banded_matvec_t_omajor(data, band.offsets_t, x, band=kb),
             fc.banded_cheb_step_t_omajor(data, band.offsets_t, x, d, b,
                                          dinv, 0.37, 1.21, band=kb))
            for _ in range(2)]
    same = torch.equal(runs[0][0], runs[1][0]) and all(
        torch.equal(p, q) for p, q in zip(runs[0][1], runs[1][1]))
    if not same:
        fail(f"two K0 / fused K0 launches on {label} differ")


def phase10(torch, dev):
    """Phase 10: SA-AMG, GMRES and the coupled models on the card (see the
    module docstring).  Returns (the launch counts of darcy_stokes'
    MG-GMRES solve at n=64, the K0 and fused K0 rows of the coupled
    bands)."""
    import resource

    import numpy as np

    from polydeal_tpu_torch.mesh import hyper_cube
    from polydeal_tpu_torch.models import darcy_stokes as ds
    from polydeal_tpu_torch.models import oseen as os_
    from polydeal_tpu_torch.models.diffusion_reaction import (
        solve_diffusion_reaction)
    from polydeal_tpu_torch.models.piston import solve_piston
    from polydeal_tpu_torch.models.poisson import solve_poisson
    from polydeal_tpu_torch.ops import _build
    from polydeal_tpu_torch.solvers import block_nullspace, build_amg

    t_phase = time.perf_counter()
    log("phase 10: AMG, GMRES and the coupled models")
    # (a) SA-AMG: solve_poisson(solver="amg") against the JAX package at
    # n=16/32, then R3MG against AMG at n=64 (1,048,576 DoF)
    for n in (16, 32):
        r = solve_poisson(dim=3, n=n, degree=1, solver="amg", device=dev,
                          verbose=False)
        ref = JAX_COUPLED[f"amg_poisson_3d_p1_n{n}"]
        log(f"  (a) poisson 3D p=1 n={n} amg: {r['iterations']} iterations "
            f"(JAX {ref['iterations']}); host seconds MG setup + solve "
            f"{r['t_solve']:.3f}")
        if abs(r["iterations"] - ref["iterations"]) > 1:
            fail(f"AMG n={n}: {r['iterations']} iterations, JAX "
                 f"{ref['iterations']}")
        hold_rel(f"(a) poisson amg n={n}", r, {k: ref[k] for k in ("l2",
                                                                   "h1")},
                 COO_TOL)
    rm = solve_poisson(dim=3, n=64, degree=1, device=dev, verbose=False)
    A, b, ah = rm["A"], rm["b"], rm["handlers"][-1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    amg = build_amg(A, nullspace=block_nullspace(ah))
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    ra = amg.solve_cg(b, rtol=1e-9)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    dx = float((ra.x - rm["x"]).abs().max())
    log(f"  (a) n=64 ({rm['n_dofs']} DoF): R3MG {rm['iterations']} "
        f"iterations, AMG {ra.iterations} ({amg.n_levels} levels, sizes "
        f"{[m.shape[0] for m in amg.As]}); AMG host setup {t_setup:.3f} s, "
        f"solve {t_solve:.3f} s (R3MG setup + solve {rm['t_solve']:.3f} s); "
        f"peak RSS {rss:.2f} GiB; max |x_amg - x_r3mg| = {dx:.3e}")
    if not abs(rm["iterations"] - 19) <= 1:
        fail(f"R3MG n=64 took {rm['iterations']} iterations")
    if not ra.iterations > rm["iterations"]:
        fail("AMG took no more iterations than R3MG at n=64")
    if not float(ra.residual) <= 1e-9 * float(b.norm()) * 1.01 or \
            not dx <= 1e-7:
        fail(f"AMG n=64 disagrees with R3MG: {dx:.3e}")
    # phase 14: the same AMG solve eager against captured (no kernel of
    # the port: the trace's device operations are BlockMatrix gathers,
    # products and sums)
    graph_arm(torch, "SA-AMG 3D p=1 n=64",
              lambda: xi(amg.solve_cg(b, rtol=1e-9, capture=False)),
              lambda: xi(amg.solve_cg(b, rtol=1e-9)),
              amg._loops[(1e-9, 300, b.dtype)][0], reps=1, tol=1e-12,
              trace_eager=False, cold_eager=False, records=any_op,
              phase="14", store=ARMS14)
    del rm, A, b, ah, amg, ra
    torch.cuda.empty_cache()
    for n in (16, 32):
        r = solve_diffusion_reaction(dim=2, n=n, strategy="metis",
                                     device=dev, verbose=False)
        ref = JAX_COUPLED[f"dr_partition_2d_n{n}"]
        log(f"  (a) diffusion-reaction partition n={n}: {r['iterations']} "
            f"iterations (JAX {ref['iterations']})")
        if abs(r["iterations"] - ref["iterations"]) > 1:
            fail(f"diffusion-reaction partition n={n} iterations")
        hold_rel(f"(a) diffusion-reaction partition n={n}", r,
                 {"l2": ref["l2"]}, COO_TOL)

    # (b) darcy_stokes: the dense solve against JAX's errors, MG-GMRES at
    # the recorded trajectory and within 1e-6 of the dense solve
    counts = None
    bands = {}
    for n in (8, 16, 32, 64, 128):
        t0 = time.perf_counter()
        s, xd = ds.run(n, 2, device=dev)
        torch.cuda.synchronize()
        t_dense = time.perf_counter() - t0
        e = ds.errors(s, xd)
        key = f"darcy_n{n}"
        if key in JAX_COUPLED:
            ref = JAX_COUPLED[key]
            hold_rel(f"(b) darcy n={n} dense", dict(
                u_l2=e[0], u_h1=e[1], pS_l2=e[2], pD_l2=e[3]),
                {k: ref[k] for k in ("u_l2", "u_h1", "pS_l2", "pD_l2")},
                COO_TOL)
        mesh = hyper_cube(2, n)
        if n == 64:
            _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = ds.solve_darcy_stokes_mg(s, mesh, n, 2, rtol=COUPLED_RTOL)
        torch.cuda.synchronize()
        t_mg = time.perf_counter() - t0
        if n == 64:
            counts = dict(_build.launches)
        dx = float((r.x - xd).abs().max()) / float(xd.abs().max())
        log(f"  (b) darcy n={n} ({s.space.n_dofs} DoF): MG-GMRES "
            f"{r.iterations} iterations (recorded "
            f"{DARCY_ITS.get(n, '-')}), {t_mg:.3f} s setup + solve "
            f"(setup {r.setup_s:.3f}, captured solve {r.solve_s:.3f}); dense "
            f"build + solve {t_dense:.3f} s; max |x_mg - x_dense| / max "
            f"|x_dense| = {dx:.3e}; errors {e}")
        if n in DARCY_ITS and abs(r.iterations - DARCY_ITS[n]) > 2:
            fail(f"darcy n={n}: {r.iterations} MG-GMRES iterations, "
                 f"recorded {DARCY_ITS[n]}")
        if not dx <= 1e-6:
            fail(f"darcy n={n}: MG-GMRES differs from the dense solve by "
                 f"{dx:.3e}")
        if n == 32:
            # phase 14: block-Jacobi GMRES(60) at solve_darcy_stokes_
            # iterative's rtol, cut to 20 restarts: it meets no rtol 1e-10
            # within its default 200 either (12000 steps, ~50 s eager), so
            # both paths run every step to the cap
            gmres_arm(torch, "darcy n=32 block-Jacobi GMRES (20 restarts)",
                      ds._regularized(s), s.op.block_jacobi(), s.rhs,
                      dict(restart=60, rtol=1e-10, max_restarts=20), xd,
                      reps=1, trace_eager=False, cold_eager=False,
                      gate_dense=False, records=any_op)
        if n in (64, 128):
            M = ds.mg_block_preconditioner(s, mesh, n, 2,
                                           ps_mode="mass+stab",
                                           structure="tri")
            gmres_arm(torch, f"darcy n={n} MG-GMRES", ds._regularized(s), M,
                      s.rhs, dict(restart=200, rtol=COUPLED_RTOL,
                                  max_restarts=40), xd,
                      reps=1, trace_eager=n == 64)
            if n == 64:
                bands["darcy u"] = M.mgs["u"].ells[-1]
                bands["darcy pD"] = M.mgs["pD"].ells[-1]
                log(f"  (b) darcy n=64 launches over MG setup + solve: "
                    f"{counts}")
            del M
        del s, xd, r
        torch.cuda.empty_cache()
    for name in ("banded_matvec_omajor", "banded_fused_omajor"):
        if counts[name] <= 0:
            fail(f"kernel {name} was never launched by darcy's MG-GMRES")

    # (c) oseen: dense errors against JAX (straight and curved split), the
    # MG-GMRES trajectory within 1e-6 of the dense solve
    for n in (16, 32, 64):
        space, xd, meta = os_.run(n, 2, device=dev)
        e = os_.oseen_errors(space, xd, meta)
        if n == 16:
            ref = JAX_COUPLED["oseen_n16"]
            hold_rel("(c) oseen n=16 dense", dict(u_l2=e[0], u_h1=e[1],
                                                  p_l2=e[2]),
                     {k: ref[k] for k in ("u_l2", "u_h1", "p_l2")}, COO_TOL)
        op, rhs = meta["system"]
        mesh = os_._rectangle(n)
        _build.reset_launches()
        t0 = time.perf_counter()
        r = os_.solve_oseen_mg(space, op, rhs, meta, mesh, n, 2,
                               rtol=COUPLED_RTOL)
        torch.cuda.synchronize()
        t_mg = time.perf_counter() - t0
        oseen_counts = {k: v for k, v in _build.launches.items() if v}
        dx = float((r.x - xd).abs().max()) / float(xd.abs().max())
        jits = JAX_COUPLED.get(f"oseen_n{n}", {}).get("mg_iterations", "-")
        log(f"  (c) oseen n={n} ({space.n_dofs} DoF): MG-GMRES "
            f"{r.iterations} iterations (JAX {jits}), {t_mg:.3f} s (setup "
            f"{r.setup_s:.3f}, captured solve {r.solve_s:.3f}); max "
            f"|x_mg - x_dense| / max |x_dense| = {dx:.3e}; errors {e}")
        if not dx <= 1e-6:
            fail(f"oseen n={n}: MG-GMRES differs from the dense solve by "
                 f"{dx:.3e}")
        if jits != "-" and abs(r.iterations - jits) > 2:
            fail(f"oseen n={n}: {r.iterations} iterations, JAX {jits}")
        if n == 64:
            log(f"  (c) oseen n=64 launches over MG setup + solve: "
                f"{oseen_counts}")
            M = os_.oseen_mg_preconditioner(space, op, meta, mesh, n, 2)
            bands["oseen proxy"] = M.mgs[2].ells[-1]
            gmres_arm(torch, "oseen n=64 MG-GMRES",
                      os_._regularized(space, op, meta), M, rhs,
                      dict(restart=200, rtol=COUPLED_RTOL, max_restarts=40),
                      xd, reps=1, trace_eager=False, cold_eager=False)
            del M
        del space, xd, meta, op, rhs, r
        torch.cuda.empty_cache()
    space, xc, meta = os_.run_curved(16, 2, device=dev)
    e = os_.oseen_errors(space, xc, meta)
    ref = JAX_COUPLED["oseen_curved_n16"]
    hold_rel("(c) oseen curved n=16 dense", dict(u_l2=e[0], u_h1=e[1],
                                                 p_l2=e[2]),
             {k: ref[k] for k in ("u_l2", "u_h1", "p_l2")}, COO_TOL)
    del space, xc, meta

    # (d) Stokes' exact linear flow, the piston, hp
    from polydeal_tpu_torch.agglomeration import agglomerate_by_partition
    from polydeal_tpu_torch.fem import hp
    from polydeal_tpu_torch.handler import AgglomerationHandler
    from polydeal_tpu_torch.models import stokes

    m = hyper_cube(2, 4)
    h = AgglomerationHandler(
        m, agglomerate_by_partition(m.cell_centers(), m.neighbors, 4),
        degree=1)
    u_ex = lambda x: torch.stack([x[..., 1], x[..., 0]], dim=-1)
    U, _, meta = stokes.solve_stokes_dense(h, lambda x: torch.zeros_like(x),
                                           u_ex, device=dev)
    ev = stokes.velocity_errors(h, meta, U, u_ex)
    ed = stokes.divergence_norm(h, meta, U)
    log(f"  (d) Stokes exact flow: velocity L2 {ev:.3e}, div {ed:.3e}")
    if not (ev <= 1e-10 and ed <= 1e-10):
        fail("Stokes misses its exact linear flow")
    out, _ = solve_piston(n=16, device=dev, verbose=False)
    ref = JAX_COUPLED["piston_n16"]
    log(f"  (d) piston n=16: {out['n_dofs']} DoF, {out['iterations']} "
        f"iterations (JAX {ref['iterations']}), u in [{out['u_min']!r}, "
        f"{out['u_max']!r}] (JAX [{ref['u_min']!r}, {ref['u_max']!r}])")
    if abs(out["iterations"] - ref["iterations"]) > 1 or max(
            abs(out[k] - ref[k]) for k in ("u_min", "u_max")) > 1e-8:
        fail("the piston disagrees with the JAX package")
    from polydeal_tpu_torch.agglomeration import RTreeAgglomerator

    m = hyper_cube(2, 8)
    c2p = RTreeAgglomerator.build(m.cell_centers()).extract_agglomerates(2)
    h = AgglomerationHandler(m, c2p, degree=1, n_quad=3)
    cx = np.bincount(c2p, weights=m.cell_centers()[:, 0]) / np.bincount(c2p)
    degrees = np.where(cx < 0.5, 1, 2)
    u = lambda x: x[..., 0] ** 2 + x[..., 1]
    sp_, op, rhs = hp.build_hp_poisson(
        h, degrees, f_fn=lambda x: torch.full_like(x[..., 0], -2.0), g_fn=u,
        device=dev)
    x = hp.solve_hp_dense(sp_, op, rhs)
    hold_rel("(d) hp dense", dict(
        l2=hp.hp_l2_error(h, sp_, degrees, x, u),
        x_norm=float(torch.linalg.vector_norm(x))),
        {k: JAX_COUPLED["hp"][k] for k in ("l2", "x_norm")}, 1e-10)

    # (e) K0 and fused K0 on the coupled real bands (nb = 12, 3, 6), f64
    # and f32, two launches bitwise equal
    rows = {}
    for label, band in bands.items():
        log(f"  (e) {label} fine band: nb={band.n_basis}, "
            f"P={band.n_block_rows}, offsets {band.offsets.tolist()}")
        for data in band_types(torch, band.data):
            bitwise_k0(torch, f"{label} {data.dtype}",
                       type(band)(data, band.offsets, band.n_block_cols))
        check_k0(torch, f"{label} nb={band.n_basis}", band, rows)
    log(f"  phase 10 took {time.perf_counter() - t_phase:.1f} s")
    out = {}
    for key, cases in (("K0", {k: v for k, v in rows.items()
                               if not k.endswith("fused")}),
                       ("K0 fused", {k: v for k, v in rows.items()
                                     if k.endswith("fused")})):
        main = [k for k in cases if "darcy u" in k and "float64" in k][0]
        out[key] = dict(cases[main], case=main, max_abs_err=max(
            r["max_abs_err"] for r in cases.values()))
    return counts, out


def bf16_ulp_hold(torch, label, got, ref):
    """``got`` within 1 bf16 ulp of ``ref`` elementwise, plus 1e-5 of the
    largest entry where the two f32 sums, in another order, differ before
    their one rounding to bf16 (terms that cancel); returns the max abs
    error."""
    g, r = got.double(), ref.double()
    big = torch.maximum(g.abs(), r.abs())
    ulp = torch.exp2(torch.floor(torch.log2(torch.where(
        big > 0, big, torch.ones_like(big)))) - 7)
    err = (g - r).abs()
    if got.dtype != torch.bfloat16 or not bool(
            (err <= ulp + 1e-5 * float(r.abs().max())).all()):
        fail(f"{label}: {got.dtype} result beyond 1 bf16 ulp of its plain "
             f"version (max abs err {float(err.max()):.3e})")
    return float(err.max())


def k6_bf16_row(torch, label, kernel, plain, nbytes, flops, trace):
    """K6 or K6 halo with bf16 x against its plain version (1 bf16 ulp),
    two launches bitwise equal, timed by CUDA events beside the plain
    version and traced beside its bound; the row of the JSON line (no
    library call: no PyTorch call multiplies an f32 sparse matrix by a bf16
    vector)."""
    y1, y2, ref = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    if not torch.equal(y1, y2):
        fail(f"{label}: two launches differ")
    err = bf16_ulp_hold(torch, label, y1, ref)
    ms, pms = time_pair(torch, kernel, plain, reps=20)
    b_ms, b_by = bound(nbytes, flops, "float32")
    dus = cold_traced_us(torch, kernel, trace, nbytes, b_ms, label, n=20)
    log(f"  {label}: within 1 bf16 ulp of its plain version (max abs err "
        f"{err:.3e}), two launches bitwise equal; traced {dus:.2f} us a "
        f"launch, {b_ms * 1e3 / dus:.1%} of its bound {b_ms:.4f} ms ({b_by}:"
        f" {nbytes / 1e6:.1f} MB), events {ms:.4f} ms, plain {pms:.4f} ms")
    return dict(max_abs_err=err, ms=dus / 1e3, plain_ms=pms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, events_ms=ms)


def peak_mb(torch, base):
    """(peak, resident) MB of device memory above ``base`` bytes since the
    last peak reset."""
    torch.cuda.synchronize()
    return ((torch.cuda.max_memory_allocated() - base) / 1e6,
            (torch.cuda.memory_allocated() - base) / 1e6)


def matfree_check(torch, dev, keep):
    """(a) of phase 11: the matrix-free operator of phase 5's fine level
    against its assembled bands (f64 and f32 apply on a seeded x, the
    diagonals), its apply timed by CUDA events beside its byte bound, then
    the flagship's composition with the matrix-free fine level
    (``build_multigrid(matfree_fine=True)`` on phase 5's handlers, parents
    and b), its solve held to phase 5's iterations (+-2) and f64 solution
    (1e-4).  Returns the composition's launch counts."""
    from polydeal_tpu_torch.assembly.matfree import MatrixFreeLaplace
    from polydeal_tpu_torch.models import flagship as fl
    from polydeal_tpu_torch.ops import _build
    from polydeal_tpu_torch.solvers import multigrid

    h = keep["handlers"][-1]
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(h.n_dofs, generator=gen, device=dev, dtype=torch.float64)
    ops = {}
    for dt, A, tol in ((torch.float64, keep["A64"], 1e-12),
                       (torch.float32, keep["A32"], 1e-5)):
        op = ops[dt] = MatrixFreeLaplace(h, dtype=dt, device=dev)
        xd = x.to(dt)
        for what, got, ref in (("apply", op.apply(xd), A.matvec(xd)),
                               ("diagonal", op.diagonal(), A.diagonal())):
            rel = float((got - ref).abs().max()) / float(ref.abs().max())
            log(f"  matrix-free {what} {str(dt)[6:]} against the assembled "
                f"fine band: rel {rel:.3e} (tol {tol:g})")
            if not rel <= tol:
                fail(f"matrix-free {what} {dt} disagrees with the band: "
                     f"{rel:.3e}")
    op = ops[torch.float32]
    del ops
    x32 = x.float()
    geo = sum(t.numel() * t.element_size() for t in vars(op.geom).values()
              if isinstance(t, torch.Tensor))
    ms = time_one(torch, lambda: op.apply(x32), reps=10)
    b_ms, b_by = bound(geo + 2 * 4 * h.n_dofs, 0, "float32")
    xt = x32.view(-1, h.n_basis).T.contiguous()
    log(f"  matrix-free f32 apply at {h.n_dofs} DoF: {ms:.4f} ms a call by "
        f"CUDA events, bound {b_ms:.4f} ms ({b_by}: geometry "
        f"{geo / 1e6:.1f} MB read once, x and y); the assembled band's "
        f"product: K1 in the transposed layout "
        f"{time_one(torch, lambda: keep['A32'].matvec_t(xt)):.4f} ms, flat "
        f"with its two layout copies "
        f"{time_one(torch, lambda: keep['A32'].matvec(x32)):.4f} ms")
    del op, x, x32, xt
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    mg = multigrid.build_multigrid(
        keep["handlers"], keep["parents"], None,
        chebyshev_degree=fl.CHEBYSHEV_DEGREE, n_smooth=fl.N_SMOOTH,
        smoothing_range=fl.SMOOTHING_RANGE, grid_shapes=keep["grid_shapes"],
        precond_dtype=torch.bfloat16, dtype=torch.float32,
        coarse_solver="inv", level_assembly="banded", matfree_fine=True,
        device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    b = keep["b"]
    res = mg.solve_cg(b, rtol=1e-8, fmg=True)  # the capture and a solve
    counts = dict(_build.launches)
    # an eager solve counts its matrix-free applies (a replay runs no
    # Python)
    fine_op, n_apply = mg.ells[-1].op, [0]
    apply0 = fine_op.apply

    def counted(u):
        n_apply[0] += 1
        return apply0(u)

    fine_op.apply = counted
    mg.solve_cg(b, rtol=1e-8, fmg=True, capture=False)
    fine_op.apply = apply0
    peak, resident = peak_mb(torch, base)
    x = res.x
    bnorm = float(b.norm())
    rel = float(res.residual) / bnorm
    diff = float((x.double() - keep["x64"]).abs().max()) / float(
        keep["x64"].abs().max())
    kinds = [type(e).__name__ for e in mg.ells]
    p5, r5 = keep["mem5"]
    log(f"  matrix-free fine level over assembled coarse levels {kinds}: "
        f"setup {setup_s:.3f} s (warm solves: phase 14's arm below; "
        f"{n_apply[0]} matrix-free applies in an eager one), "
        f"{res.iterations} iterations (assembled: {keep['its']}), relative "
        f"residual {rel:.3e}; max |x - x_f64| / max |x_f64| = {diff:.3e}")
    log(f"  device memory above the baseline, setup + 2 solves (one "
        f"captured, one eager): matrix-free "
        f"composition peak {peak:.1f} MB, resident {resident:.1f} MB; "
        f"assembled (phase 5) peak {p5:.1f} MB, resident {r5:.1f} MB")
    log(f"  launches over setup + 2 solves: {counts}")
    if tuple(x.shape) != (h.n_dofs,) or not bool(torch.isfinite(x).all()):
        fail("matrix-free solution has the wrong shape or non-finite values")
    if not rel <= 1e-8 or abs(res.iterations - keep["its"]) > 2:
        fail(f"matrix-free solve: {res.iterations} iterations, relative "
             f"residual {rel:.3e} (assembled {keep['its']})")
    if not diff <= 1e-4:
        # the f32 band is sensitive to gamma's rounding (PERF.md): compare
        # the operator's gamma with the plain assembly's, face by face
        op = MatrixFreeLaplace(h, dtype=torch.float32, device=dev)
        ft = h.faces.interior()
        g_ref = (op.penalty_constant / torch.as_tensor(
            ft.h_f, dtype=torch.float32, device=dev))
        g_mf = op.penalty_constant / op.geom.fi_hf
        log(f"  gamma: {int((g_ref != g_mf).sum())} of {g_ref.numel()} "
            f"interior faces differ from the plain assembly's")
        fail(f"matrix-free f32 solution differs from the f64 one by "
             f"{diff:.3e}")
    for name in ("banded_matvec_imajor", "banded_fused_cheb",
                 "banded_fused_omajor", "volume_blocks", "face_group_blocks",
                 "boundary_blocks"):
        if counts[name] <= 0:
            fail(f"kernel {name} was never launched on the matrix-free "
                 f"composition")
    # phase 14: eager against captured (f32; the eager solve is ~250
    # applies at ~28 ms and was run above, so one warm call each)
    graph_arm(torch, "matrix-free flagship composition n=64",
              lambda: xi(mg.solve_cg(b, rtol=1e-8, fmg=True,
                                     capture=False)),
              lambda: xi(mg.solve_cg(b, rtol=1e-8, fmg=True)),
              mg.cg_loop(1e-8, 200, torch.float32), x64=keep["x64"],
              reps=1, trace_eager=False, cold_eager=False, phase="14",
              store=ARMS14)
    del mg, res, x, fine_op
    torch.cuda.empty_cache()
    return counts


def bf16_flagship(torch, dev, relabel, keep):
    """(b) of phase 11, one arm: the n=64 flagship with bf16 smoothing
    vectors (``setup_flagship(vector_dtype=torch.bfloat16)``), cold and
    warm, converged within 200 iterations, its f32 solution within 1e-4 of
    phase 5's f64 one (by cell without the relabel).  Returns (the
    flagship, its launch counts)."""
    from polydeal_tpu_torch.models.flagship import (setup_flagship,
                                                    solve_flagship)
    from polydeal_tpu_torch.ops import _build

    _build.reset_launches()
    fs = setup_flagship(n=keep["n"], relabel=relabel,
                        vector_dtype=torch.bfloat16, device=dev)
    res = solve_flagship(fs, maxiter=200)  # cold
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = solve_flagship(fs, maxiter=200)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t1
    counts = dict(_build.launches)
    rel = float(res.residual) / float(fs.b.norm())
    if relabel is None:
        x, x64 = cell_order(torch, fs, res.x), keep["x64_cells"]
    else:
        x, x64 = res.x.double(), keep["x64"]
    diff = float((x - x64).abs().max()) / float(x64.abs().max())
    label = f"bf16-vector flagship relabel={relabel}"
    log(f"  {label}: levels {level_formats(fs)}; smoothing vectors "
        f"{[str(d.dtype)[6:] for d in fs.mg.lo_dinvs[1:]]}; warm solve "
        f"{solve_s:.4f} s, {res.iterations} iterations (f32 vectors: "
        f"{keep['its']}), relative residual {rel:.3e}; max |x - x_f64| / "
        f"max |x_f64| = {diff:.3e}")
    log(f"  launches over setup + 2 solves: {counts}")
    if not bool(torch.isfinite(res.x).all()):
        fail(f"{label}: non-finite solution")
    if not rel <= 1e-8 or res.iterations >= 200:
        fail(f"{label} did not converge within 200 iterations (relative "
             f"residual {rel:.3e})")
    if not diff <= 1e-4:
        fail(f"{label}: f32 solution differs from the f64 one by {diff:.3e}")
    if relabel == "lex":
        # phase 14: eager against captured (f32 vectors' tolerance)
        graph_arm(torch, "bf16-vector lex flagship n=64",
                  lambda: xi(solve_flagship(fs, maxiter=200,
                                            capture=False)),
                  lambda: xi(solve_flagship(fs, maxiter=200)),
                  fs.mg.cg_loop(1e-8, 200, torch.float32), x64=keep["x64"],
                  phase="14", store=ARMS14)
    return fs, counts


def io_check(torch, dev):
    """(c) of phase 11: ``write_matrix_market`` and ``write_vtu`` on the 3D
    n=16 p=1 system (one cell a polytope; its f64 SIPG matrix assembled on
    the card), written to a temporary directory and read back: the matrix
    read by scipy multiplies a seeded x as the card's BlockMatrix does, the
    VTU's counts and cell arrays are what was written."""
    import xml.etree.ElementTree as ET

    import numpy as np
    import scipy.io
    import scipy.sparse

    from polydeal_tpu_torch.assembly.sipg import assemble_sipg_matrix
    from polydeal_tpu_torch.handler import AgglomerationHandler
    from polydeal_tpu_torch.io import write_matrix_market, write_vtu
    from polydeal_tpu_torch.mesh.fine_mesh import hyper_cube

    mesh = hyper_cube(3, 16)
    ah = AgglomerationHandler(mesh, np.arange(mesh.n_cells), degree=1)
    A = assemble_sipg_matrix(ah, device=dev)
    x = torch.randn(ah.n_dofs, generator=torch.Generator(
        device=dev).manual_seed(12), device=dev, dtype=torch.float64)
    y = A.matvec(x).cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        nnz = write_matrix_market(A, os.path.join(tmp, "A.mtx"))
        mm_s = time.perf_counter() - t0
        M = scipy.sparse.csr_matrix(scipy.io.mmread(
            os.path.join(tmp, "A.mtx")))
        rel = float(np.abs(M @ x.cpu().numpy() - y).max() / np.abs(y).max())
        u = np.sin(np.arange(mesh.n_cells) * 0.1)
        write_vtu(mesh, os.path.join(tmp, "mesh.vtu"), cell_data={
            "u": u, "polytope": ah.cell2poly.astype(float)})
        root = ET.parse(os.path.join(tmp, "mesh.vtu")).getroot()
    piece = root.find("UnstructuredGrid/Piece")
    arrays = {a.get("Name"): np.array(a.text.split(), dtype=float)
              for a in piece.iter("DataArray") if a.get("Name")}
    ok = (int(piece.get("NumberOfPoints")) == mesh.n_vertices
          and int(piece.get("NumberOfCells")) == mesh.n_cells
          and arrays["connectivity"].size == 8 * mesh.n_cells
          and np.allclose(arrays["u"], u, rtol=1e-8, atol=1e-9)
          and np.array_equal(arrays["polytope"], ah.cell2poly))
    log(f"  io: MatrixMarket of the n=16 system, {M.shape[0]} rows, {nnz} "
        f"entries in {mm_s:.2f} s, read back: max |M x - A x| / max |A x| = "
        f"{rel:.3e}; VTU {mesh.n_cells} hexes, {mesh.n_vertices} points, "
        f"read back {'as written' if ok else 'WRONG'}")
    if M.shape != (ah.n_dofs, ah.n_dofs) or M.nnz != nnz or not rel <= 1e-14:
        fail("the MatrixMarket file does not read back as the matrix")
    if not ok:
        fail("the VTU file does not read back as written")


def phase11(torch, dev, group, keep):
    """Phase 11: (a) the matrix-free fine level (``matfree_check``); (b)
    bf16 smoothing vectors: the lex and relabel=None flagships with
    ``vector_dtype=torch.bfloat16``, K6 and K6 halo with bf16 x against
    their plain versions on the relabel=None arm's fine pack and its
    sharded fine slab, and that arm sharded at world size 1 on phase 8's
    NCCL group, within one iteration of its unsharded no-FMG solve; (c) io.
    Returns (the launch counts of the bf16 K6 and K6 halo paths, their
    rows)."""
    from polydeal_tpu_torch.ops import _build
    from polydeal_tpu_torch.ops import packed as pk
    from polydeal_tpu_torch.parallel.banded import ShardedBandedSystem

    t_phase = time.perf_counter()
    log("phase 11: the matrix-free fine level, bf16 smoothing vectors, io")
    matfree_check(torch, dev, keep)

    fs, _ = bf16_flagship(torch, dev, "lex", keep)
    del fs
    torch.cuda.empty_cache()
    fs, counts_k6 = bf16_flagship(torch, dev, None, keep)
    if counts_k6["packed_matvec_bf16"] <= 0:
        fail("K6 with bf16 x was never launched on the relabel=None path")
    rows = {}
    e = fs.mg.ells[-1]
    nb, P = e.n_basis, e.n_block_rows
    gen = torch.Generator(device=dev).manual_seed(13)
    xb = torch.randn(nb, P, generator=gen, device=dev).bfloat16()
    nbytes, flops, _ = packed_work(e, False, 2)
    rows["K6 bf16"] = k6_bf16_row(
        torch, f"K6 bf16 x on the {P}-lane fine pack",
        lambda: pk.packed_matvec_t(e.data_i, e.oid, e.offsets_t, nb, xb,
                                   band=e._band(xb)),
        lambda: pk.packed_matvec_t_ref(e.data_i, e.oid, e.offsets_t, nb, xb),
        nbytes, flops, "packed_matvec_kernel")
    # the bf16 pack's instantiation (on no path: packs keep their f32 band)
    eb = e.data_i.bfloat16()
    err = bf16_ulp_hold(
        torch, "K6 bf16 x on the fine pack in bf16",
        pk.packed_matvec_t(eb, e.oid, e.offsets_t, nb, xb),
        pk.packed_matvec_t_ref(eb, e.oid, e.offsets_t, nb, xb))
    log(f"  K6 bf16 x on the fine pack in bf16: within 1 bf16 ulp of its "
        f"plain version (max abs err {err:.3e})")
    del eb

    bnorm = float(fs.b.norm())
    ru = fs.mg.solve_cg(fs.b, rtol=1e-8, maxiter=200)
    ss = ShardedBandedSystem.from_multigrid(fs.mg, group)
    torch.cuda.synchronize()
    _build.reset_launches()
    x, k, res = ss.solve_cg(fs.b, rtol=1e-8, maxiter=200)
    torch.cuda.synchronize()
    counts_halo = dict(_build.launches)
    diff = float((cell_order(torch, fs, x) - keep["x64_cells"]).abs().max()
                 ) / float(keep["x64_cells"].abs().max())
    log(f"  bf16-vector relabel=None flagship sharded at world size 1: "
        f"lo_vec {ss.lo_vec}, levels (kind, per, T) "
        f"{[(lv.kind, lv.per, lv.T) for lv in ss.levels]}; {k} iterations "
        f"(unsharded no-FMG {ru.iterations}), relative residual "
        f"{res / bnorm:.3e}; max |x - x_f64| / max |x_f64| = {diff:.3e}; "
        f"halo launches "
        f"{ {n: c for n, c in counts_halo.items() if 'halo' in n} }")
    if ss.lo_vec != torch.bfloat16:
        fail(f"sharded bf16 system runs {ss.lo_vec} vectors")
    if not (res <= 1e-8 * bnorm and float(ru.residual) <= 1e-8 * bnorm):
        fail("a bf16 sharded or unsharded solve missed rtol 1e-8 within 200 "
             "iterations")
    if abs(k - ru.iterations) > 1:
        fail(f"bf16 sharded {k} iterations, unsharded {ru.iterations}")
    if not diff <= 1e-4:
        fail(f"bf16 sharded f32 solution differs from the f64 one by "
             f"{diff:.3e}")
    if counts_halo["packed_matvec_halo_bf16"] <= 0:
        fail("K6 halo with bf16 x was never launched on the sharded path")
    fine, pl = ss.levels[-1], ss.params[-1]
    slab = Slab(torch, pl["data_i"], pl["offsets_t"], fine.nb, fine.T,
                pl["oid"])
    x_ext = torch.randn(fine.nb, fine.per + 2 * fine.T, generator=gen,
                        device=dev).bfloat16()
    nbytes, flops = slab.work(2, False)
    rows["K6 halo bf16"] = k6_bf16_row(
        torch, f"K6 halo bf16 x on the sharded fine slab (per={fine.per}, "
        f"T={fine.T})", lambda: pk.packed_matvec_t_halo(
            slab.data_i, slab.oid, slab.offs, slab.nb, x_ext, tile=slab.T,
            band=slab.kb),
        lambda: pk.packed_matvec_t_halo_ref(
            slab.data_i, slab.oid, slab.offs, slab.nb, x_ext, tile=slab.T),
        nbytes, flops, "packed_matvec_kernel")
    del ss, fine, pl, slab, fs, x, ru
    torch.cuda.empty_cache()
    io_check(torch, dev)
    log(f"  phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return {"K6 bf16": counts_k6, "K6 halo bf16": counts_halo}, rows



def flat_sharded_check(torch, group, keep9, smi):
    """(a) of phase 12: phase 9's n=64 COO Poisson system (six banded f64
    levels, 1,048,576 DoF) through the flat block-COO ShardedSystem at
    world size 1, held to its unsharded ``mg.solve_cg``: iterations within
    one, x within 1e-8."""
    from polydeal_tpu_torch.parallel.sharding import ShardedSystem

    mg, b = keep9["mg"], keep9["b"]
    bnorm = float(b.norm())
    t0 = time.perf_counter()
    ss = ShardedSystem.from_multigrid(mg, group)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # eager (phase 15 (a) below holds the captured solve to this one)
    eager = lambda: ss.solve_cg(b, rtol=1e-9, maxiter=100, capture=False)
    x, k, res = eager()  # cold
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    x, k, res = eager()  # warm
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t1
    fine, pl = ss.levels[-1], ss.params[-1]
    nnz = pl["data"].shape[0]
    nbytes = pl["data"].numel() * pl["data"].element_size()
    diff = float((x - keep9["x"]).abs().max())
    log(f"  (a) flat ShardedSystem on phase 9's n=64 COO system "
        f"(1,048,576 DoF, f64) at world size 1: {len(ss.levels)} levels, "
        f"the fine ShardedMatrix {nnz} blocks a shard ({nbytes / 1e6:.1f} "
        f"MB), halo rows {sum(fine.n_sends)}, nested transfers "
        f"{[lv.nested_transfer for lv in ss.levels[1:]]}; setup "
        f"{setup_s:.3f} s, warm eager solve {solve_s:.4f} s, {k} iterations "
        f"(unsharded {keep9['iterations']}), relative residual "
        f"{res / bnorm:.3e}; max |x_flat - x_unsharded| = {diff:.3e} "
        f"[{smi}]")
    if tuple(x.shape) != tuple(keep9["x"].shape) or not bool(
            torch.isfinite(x).all()):
        fail("flat sharded solution has the wrong shape or non-finite "
             "values")
    if abs(k - keep9["iterations"]) > 1 or not res <= 1e-9 * bnorm * 1.01:
        fail(f"flat sharded solve: {k} iterations (unsharded "
             f"{keep9['iterations']}), relative residual {res / bnorm:.3e}")
    if sum(fine.n_sends) != 0:
        fail("the flat sharded system ships halo rows at world size 1")
    if not diff <= 1e-8:
        fail(f"flat sharded solution differs from the unsharded one by "
             f"{diff:.3e}")
    # phase 15 (a): the same solve captured (the default on the card)
    # against the eager one: equal iterations, x bitwise equal where no
    # product picks another cuBLAS algorithm in the graph, else 1e-12
    graph_arm(torch, "flat ShardedSystem n=64 COO (world size 1)",
              lambda: eager()[:2],
              lambda: ss.solve_cg(b, rtol=1e-9, maxiter=100)[:2],
              ss._compiled(1e-9, 100, True, b.dtype)[0], reps=3, tol=1e-12,
              trace_eager=False, cold_eager=False, records=any_op,
              extra=lambda xe, xg: {"bitwise": float(torch.equal(xe, xg))},
              phase="15", store=ARMS15)


def sipg_plans(torch, tables, degree, dim):
    """(kind, C, Q, lanes, ranks, G, S) of every K3-K5 launch the direct
    assembly makes over ``tables``."""
    from polydeal_tpu_torch.ops.sipg_kernels import (sipg_form,
                                                     sipg_launch_plan)

    out = []
    named = [("volume", tables["vol"])] + [
        ("face", g) for g in tables["groups"].values()]
    if tables["bdry"] is not None:
        named.append(("boundary", tables["bdry"]))
    for kind, g in named:
        C, Q, P = g["w"].shape
        pl = sipg_launch_plan(P, C, Q, sipg_form(kind, dim, degree,
                                                 g["w"].dtype))
        out.append((kind, C, Q, pl.lanes, pl.ranks, pl.G, pl.S))
    return out


def slab_setup_check(torch, dev, smi, n=64):
    """(b) 1-2 of phase 12: the fine band of bench_sharded's system
    (structured n=64, p=1, f32) built as 4 lane slabs [r per, (r + 1) per)
    in this process on K3-K5, each table with only the lanes the slab
    needs (a face group also its faces into the slab and their out
    sides' boxes), against the global build: bitwise where every K3-K5
    launch plan of the slab is the whole level's, else within 1e-6 of the
    band's largest entry; and last_setup_stats of the slabs against the
    global build."""
    from polydeal_tpu_torch.assembly import sipg
    from polydeal_tpu_torch.models.flagship import flagship_hierarchy
    from polydeal_tpu_torch.solvers.multigrid import band_offsets

    handlers, _, _ = flagship_hierarchy(n, 1, "structured", "lex")
    ah = handlers[-1]
    offs = band_offsets(ah)
    P, n_slabs = ah.n_poly, 4
    per = P // n_slabs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = sipg.build_banded_groups(ah, offs, torch.float32, device=dev)
    gstats = dict(sipg.last_setup_stats)
    A = sipg.assemble_sipg_banded_direct(ah, g, offs)
    torch.cuda.synchronize()
    t_global = time.perf_counter() - t0
    plans = sipg_plans(torch, g, 1, 3)
    del g
    scale = float(A.data.abs().max())
    worst, cases, t_slabs = 0.0, [], 0.0
    for r in range(n_slabs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gs = sipg.build_banded_groups(ah, offs, torch.float32, device=dev,
                                      lanes=(r * per, (r + 1) * per))
        st = dict(sipg.last_setup_stats)
        As = sipg.assemble_sipg_banded_direct(ah, gs, offs)
        torch.cuda.synchronize()
        t_slabs += time.perf_counter() - t0
        same = sipg_plans(torch, gs, 1, 3) == plans
        del gs
        ref = A.data[..., r * per:(r + 1) * per]
        err = float((As.data - ref).abs().max())
        bitwise = torch.equal(As.data, ref)
        worst = max(worst, err)
        cases.append("bitwise" if bitwise else f"{err / scale:.1e}")
        if same and not bitwise:
            fail(f"slab {r} of the fine band is not bitwise equal to the "
                 f"global build under the same launch plans (max err "
                 f"{err:.3e})")
        if not err <= 1e-6 * scale:
            fail(f"slab {r} of the fine band differs from the global build "
                 f"by {err:.3e} (max |band| {scale:.3e})")
        plans_are = "the same as" if same else "other than"
        log(f"  (b) slab {r}: lanes [{r * per}, {(r + 1) * per}), tables "
            f"of at most {st['max_lanes']} lanes; launch plans {plans_are} "
            f"the whole level's; {'bitwise equal' if bitwise else 'max err'}"
            f"{'' if bitwise else f' {err:.3e}'}; last_setup_stats {st}")
        del As, ref
    log(f"  (b) fine band (P={P}, {len(offs)} offsets, f32) as {n_slabs} "
        f"slabs against the global build: {cases}; global build "
        f"last_setup_stats {gstats}; seconds (tables + K3-K5): global "
        f"{t_global:.3f}, the {n_slabs} slabs {t_slabs:.3f} [{smi}]")
    del A
    torch.cuda.empty_cache()
    return handlers


def local_sharded_check(torch, dev, group, smi, n=64):
    """(b) 3 of phase 12: bench_sharded's system built shard-locally at
    world size 1 (ShardedBandedSystem.setup_local: tables and bands by
    slab through K3-K5, the sharded power iteration) and solved, held as
    phase 8 holds from_multigrid: 21-25 iterations, within one of the
    unsharded no-FMG solve, the f32 solution within 1e-4 of an f64 solve.
    Fails unless K3-K5 and K1/K2 halo were launched.  Returns the launch
    counts of the setup and solve."""
    from polydeal_tpu_torch.models.flagship import setup_flagship
    from polydeal_tpu_torch.models.sharded import setup_local
    from polydeal_tpu_torch.ops import _build

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    sh = setup_local(n, device=dev, group=group)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    x, k, res = sh.ss.solve_cg(sh.b, rtol=1e-8, maxiter=100)
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    peak, resident = peak_mb(torch, base)
    ss = sh.ss
    bnorm = float(sh.b.norm())
    lams = [(lv.per, lv.hi / 1.2) for lv in ss.levels]
    del sh, ss
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fst = setup_flagship(n=n, hierarchy="structured", device=dev)
    torch.cuda.synchronize()
    setup_g = time.perf_counter() - t0
    ru = fst.mg.solve_cg(fst.b, rtol=1e-8, maxiter=100)
    lam_g = [float(h) / 1.2 for h in fst.mg.his[1:]]
    del fst
    torch.cuda.empty_cache()
    ref = setup_flagship(n=n, hierarchy="structured", device=dev,
                         dtype=torch.float64, precond_dtype=None)
    r64 = ref.mg.solve_cg(ref.b, rtol=1e-8, maxiter=100)
    diff = float((x.double() - r64.x).abs().max()) / float(
        r64.x.abs().max())
    del ref, r64
    torch.cuda.empty_cache()
    log(f"  (b) shard-local setup at world size 1: {setup_s:.3f} s "
        f"(setup_flagship {setup_g:.3f} s), device peak {peak:.1f} MB, "
        f"resident {resident:.1f} MB; lambda_max (per, value) {lams} "
        f"(Multigrid.setup {lam_g}); {k} iterations (unsharded no-FMG "
        f"{ru.iterations}), relative residual {res / bnorm:.3e}; max "
        f"|x_local_f32 - x_f64| / max |x_f64| = {diff:.3e}; launches "
        f"{counts} [{smi}]")
    if not bool(torch.isfinite(x).all()):
        fail("shard-local solution has non-finite values")
    if not res <= 1e-8 * bnorm:
        fail("shard-local solve missed rtol 1e-8")
    if not 21 <= k <= 25 or abs(k - ru.iterations) > 1:
        fail(f"shard-local solve took {k} iterations (unsharded "
             f"{ru.iterations})")
    if not diff <= 1e-4:
        fail(f"shard-local f32 solution differs from the f64 one by "
             f"{diff:.3e}")
    for name in ("volume_blocks", "face_group_blocks", "boundary_blocks",
                 "banded_matvec_halo", "banded_fused_halo"):
        if counts[name] <= 0:
            fail(f"kernel {name} was never launched on the shard-local "
                 f"path")
    return counts


def dryrun_check(torch, dev, group, smi):
    """(c) of phase 12: models/sharded.dryrun at world size 1 (it raises on
    a failed hold); fails unless K6 and K7 halo served its packed fine
    level."""
    from polydeal_tpu_torch.models.sharded import dryrun
    from polydeal_tpu_torch.ops import _build

    _build.reset_launches()
    t0 = time.perf_counter()
    r = dryrun(dev, group)
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    log(f"  (c) dryrun at world size 1 ({time.perf_counter() - t0:.2f} s): "
        f"levels {r['levels']}, sharded {r['meta']}; {r['iterations']} "
        f"iterations (host {r['host_iterations']}), max |x - x_host| = "
        f"{r['max_abs_diff']:.3e}, relative residual "
        f"{r['residual'] / r['bnorm']:.3e}; comm_bytes_per_spmv(8) "
        f"{r['comm']}; flat: {r['flat_iterations']} iterations (host "
        f"{r['flat_host_iterations']}), max diff "
        f"{r['flat_max_abs_diff']:.3e}; launches {counts} [{smi}]")
    for name in ("packed_matvec_halo", "packed_fused_halo"):
        if counts[name] <= 0:
            fail(f"kernel {name} was never launched on the dry run")
    return counts


def other_assemblies_check(torch, dev, handlers, smi):
    """(d) of phase 12: assemble_sipg_banded (standard tables, one segment
    sum into the band slots) and assemble_sipg_banded_gather (entity-last
    tables, padded gather maps) at n=64 p=1 (the structured fine level,
    262,144 polytopes) against assemble_sipg_banded_direct's band: f64
    within 1e-12 of its largest entry, f32 within 1e-5; seconds and peak
    device MB of each."""
    import numpy as np

    from polydeal_tpu_torch.assembly import sipg
    from polydeal_tpu_torch.solvers.multigrid import band_offsets

    ah = handlers[-1]
    offs = band_offsets(ah)
    for dt, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        ref = sipg.assemble_sipg_banded_direct(
            ah, sipg.build_banded_groups(ah, offs, dt, device=dev), offs)
        scale = float(ref.data.abs().max())

        def plain():
            return sipg.assemble_sipg_banded(ah, offsets=offs, dtype=dt,
                                             device=dev)

        def gather():
            vol = sipg.build_volume_tables(ah, dt, device=dev)
            faces = sipg.build_face_tables(ah, dt, device=dev)
            tt = sipg.transpose_tables(vol, faces)
            del vol, faces
            return sipg.assemble_sipg_banded_gather(ah, *tt, offsets=offs)

        for name, fn in (("assemble_sipg_banded", plain),
                         ("assemble_sipg_banded_gather", gather)):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            A = fn()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            peak, _ = peak_mb(torch, base)
            err = float((A.data - ref.data).abs().max())
            dname = str(dt).split(".")[-1]
            log(f"  (d) {name} n=64 p=1 {dname}: {secs:.3f} s (tables "
                f"included), device peak {peak:.1f} MB; max |A - A_direct| "
                f"/ max |A_direct| = {err / scale:.3e} (tol {tol:g}) "
                f"[{smi}]")
            if not np.array_equal(A.offsets, ref.offsets) or not (
                    err <= tol * scale):
                fail(f"{name} {dname} differs from the direct band by "
                     f"{err / scale:.3e}")
            del A
            torch.cuda.empty_cache()
        del ref
        torch.cuda.empty_cache()


def chained_k1_check(torch, band, k1_row, smi):
    """(e) of phase 12: chained_cost of K1 on the lex flagship's fine band
    (phase 5's, f32), beside a CUDA-event reading of the same call (phase
    3's method) and phase 3's traced K1 time at the flagship's shapes."""
    from polydeal_tpu_torch.utils.timer import chained_cost

    gen = torch.Generator(device=band.data_i.device).manual_seed(12)
    x = torch.randn(band.n_basis, band.n_block_rows, generator=gen,
                    device=gen.device, dtype=torch.float32)
    per = chained_cost(lambda v: band.matvec_t(v), x, n_small=8,
                       n_large=64, reps=3) * 1e3
    ev = time_one(torch, lambda: band.matvec_t(x))
    log(f"  (e) K1 on the lex flagship fine band (P={band.n_block_rows}, "
        f"{len(band.offsets)} offsets, f32): chained_cost {per:.4f} ms per "
        f"application (CUDA graphs of 8 and 64), CUDA events {ev:.4f} ms "
        f"per call, phase 3 traced {k1_row.get('ms', float('nan')):.4f} ms "
        f"[{smi}]")
    if not per > 0:
        fail(f"chained_cost of K1 is {per} ms")


def phase12(torch, dev, group, keep, keep9, kres):
    """Phase 12: the last modules of the port on the card (see the module
    docstring): the flat ShardedSystem, the shard-local setup, the dry
    run, the other banded assemblies and chained_cost."""
    t_phase = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log("phase 12: flat ShardedSystem, shard-local setup, dry run, the "
        "other banded assemblies, chained_cost")
    flat_sharded_check(torch, group, keep9, smi)
    keep9.clear()
    torch.cuda.empty_cache()
    handlers = slab_setup_check(torch, dev, smi)
    local_sharded_check(torch, dev, group, smi)
    dryrun_check(torch, dev, group, smi)
    other_assemblies_check(torch, dev, handlers, smi)
    del handlers
    chained_k1_check(torch, keep["A32"], kres.get("K1", {}), smi)
    log(f"  phase 12 took {time.perf_counter() - t_phase:.1f} s")


# phase 13: the captured (CUDA graph) solves against the eager ones, per
# arm, in the phases whose systems they reuse; REPS13 warm solves each
REPS13 = 11
ARMS = {}


def xi(res):
    """(x, iterations) of a CGResult."""
    return res.x, res.iterations


def mono_arm(torch, ms):
    """Phase 13's monodomain arm: MONO_STEPS BDF2 steps through
    ``steps_scan`` from one BDF1 state, eager and captured; the integrals
    of u and u^2 within 1e-6 of the eager ones.  Returns its row, with the
    graph's u (``u_graph``) for phase 7's f64 comparison."""
    cfg = ms.cfg
    u, w = ms.initial_state()
    u1, w1, _ = ms.step(u, u, w, 0.0, True)
    last = {}

    def run(capture):
        uf, _, _, its = ms.steps_scan(u1, u, w1, cfg.dt, MONO_STEPS,
                                      capture=capture)
        last[capture] = uf
        return uf, its

    def extra(xe, xg):
        me, mg_ = integrals(ms, xe), integrals(ms, xg)
        return {"int_u_rel": abs(mg_[0] - me[0]) / abs(me[0]),
                "int_u2_rel": abs(mg_[1] - me[1]) / abs(me[1])}

    row = graph_arm(torch, f"monodomain ({MONO_STEPS} BDF2 steps)",
                    lambda: run(False), lambda: run(None),
                    ms.mg.cg_loop(cfg.solver.rtol, cfg.solver.max_iterations,
                                  torch.float32), extra=extra)
    if not all(i == 3 for i in row["iterations_graph"]):
        log(f"  (monodomain graph iterations per step "
            f"{row['iterations_graph']}, not 3 each)")
    if not max(row["int_u_rel"], row["int_u2_rel"]) <= 1e-6:
        fail(f"phase 13, monodomain: graph integrals differ from the eager "
             f"ones by {row['int_u_rel']:.3e}, {row['int_u2_rel']:.3e}")
    row["u_graph"] = last[None]
    return row


def sharded_arm(torch, label, ss, b, x64, to64):
    """Phase 13's arm of a ShardedBandedSystem at world size 1: the eager
    ``solve_cg_local`` against ``solve_cg_async`` (captured), its x slab
    flattened for the comparisons."""
    flat = lambda x: x.T.reshape(-1)

    def graph():
        x, k, _ = ss.solve_cg_async(b, rtol=1e-8, maxiter=100)
        return flat(x), int(k)

    def eager():
        x, k, _ = ss.solve_cg_local(b, rtol=1e-8, maxiter=100,
                                    capture=False)
        return flat(x), k

    return graph_arm(torch, label, eager, graph,
                     ss._compiled(1e-8, 100, True, b.dtype)[0], x64=x64,
                     to64=to64)


def graph_arm(torch, label, eager, graph, loop, x64=None, to64=None,
              extra=None, reps=REPS13, tol=1e-6, trace_eager=True,
              cold_eager=True, eager_reads=None, records=None, phase="13",
              store=None):
    """Phase 13 (or 14), one arm: ``eager()`` and ``graph()`` each solve
    the same system and return (x, iterations: an int or a list per step),
    ``loop`` is the graph path's ``solvers/graphs`` loop (``CGLoop`` or
    ``GMRESLoop``).  After a cold call of each (of the graph only without
    ``cold_eager``: an eager solve of seconds that has nothing to warm),
    ``reps`` warm calls in turns on the host clock (synchronised), then
    the graph solve's device span (CUDA events around one call) and one
    traced replay of its loop's body on its own after the solve (the
    body the WHILE node runs: masked once the loop has stopped, so it
    must leave x as it was, bitwise), and, with ``trace_eager``, one
    traced eager solve (device busy time over the traced span).  A
    device program is not traced whole: see the comment below.  The
    graph solve must take the eager iterations to a solution within
    ``tol`` (max norm, relative), and within 1e-4 of ``x64``
    (``to64(x)`` where given: an f64 solution of the same system), as
    one device program a call: one host read, and the body run once an
    iteration (``loop.total``: the device's count of the loop's tests).
    The body's capture must have recorded launches of the port's kernels
    (``loop.body.launches``), and the body's trace, like the eager one,
    must hold records of them (``records(name)`` picks them; by default
    the banded and packed kernels'; ``any_op``: an arm that runs none,
    whose traces must hold device operations).
    ``eager_reads(per, iterations)`` counts the eager solve's host reads
    (default: CG's).  ``extra(x_eager, x_graph)`` adds numbers
    to the row, which goes to ``store`` (default ``ARMS``)."""
    import statistics

    from polydeal_tpu_torch.models.profile_flagship import _traced

    if records is None:
        records = lambda name: "banded" in name or "packed" in name

    def sync_call(fn):
        out = fn()
        torch.cuda.synchronize()
        return out

    if cold_eager:
        sync_call(eager)
    xg, ig = sync_call(graph)  # the capture, where not already made
    times = {"eager": [], "graph": []}
    before = dict(loop.total)
    for _ in range(reps):
        for name, fn in (("eager", eager), ("graph", graph)):
            t0 = time.perf_counter()
            out = sync_call(fn)
            times[name].append(time.perf_counter() - t0)
            if name == "eager":
                xe, ie = out
            else:
                xg, ig = out
    per = {k: (loop.total[k] - before[k]) / reps for k in before}
    # the device program's span, untraced
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    sync_call(graph)
    ev[1].record()
    torch.cuda.synchronize()
    span_ms = ev[0].elapsed_time(ev[1])
    # a device program is not traced whole: torch.profiler (CUPTI, CUDA
    # 12.8) drops the records of kernels inside WHILE bodies, a plain
    # torch program's too (tools/while_probe.py --fault); the body it runs
    # is traced on its own, replayed once after the solve
    body = loop.body
    held = sum(n for k, n in body.launches.items() if records(k))
    x_stop = loop.state.x.clone()
    bspan, bbusy, b_ops, bops = _traced(body.graph.replay, top=None)
    masked_ok = bool(torch.equal(loop.state.x, x_stop))
    n_body = per["replays"]
    traced = dict(body=dict(
        span_ms=bspan, busy_ms=bbusy, idle_share=1.0 - bbusy / bspan,
        device_ops=b_ops, launches_held=held,
        kernel_records=sum(o["count"] for o in bops if records(o["name"]))),
        program=dict(span_ms=span_ms, bodies=n_body,
                     idle_share_at_most=1.0 - n_body * bbusy / span_ms))
    if trace_eager:
        span, busy, n_ops, ops = _traced(eager, top=None)
        traced["eager"] = dict(span_ms=span, busy_ms=busy,
                               idle_share=1.0 - busy / span,
                               device_ops=n_ops,
                               kernel_records=sum(o["count"] for o in ops
                                                  if records(o["name"])))
    n_it = sum(ie) if isinstance(ie, list) else ie
    # cg_solve reads its loop condition once an iteration, once more to
    # stop, and k once at the end
    reads = (eager_reads or (lambda p, n: n + 2 * p["runs"]))(per, n_it)
    row = dict(
        iterations_eager=ie, iterations_graph=ig,
        diff_graph_eager=float((xg.double() - xe.double()).abs().max())
        / float(xe.double().abs().max()),
        **{f"{k}_s": dict(median=statistics.median(v), min=min(v),
                          max=max(v)) for k, v in times.items()},
        traced=traced, reps=reps,
        runs_per_call=per["runs"],
        host_reads_graph_per_call=per["host_reads"],
        host_reads_eager_per_call=reads,
        masked_replay_bitwise=masked_ok,
        capture_s=sum(p.seconds for p in loop.captured),
        pool_mb=sum(p.pool_bytes for p in loop.captured) / 2**20)
    if "cycles" in per:
        row["cycles_per_call"] = per["cycles"]
    if x64 is not None:
        row["diff_f32_f64"] = float(
            ((to64(xg) if to64 else xg.double()) - x64).abs().max()) / float(
                x64.abs().max())
    ext = extra(xe, xg) if extra is not None else {}
    row.update(ext)
    (ARMS if store is None else store)[label] = row
    med = {k: row[f"{k}_s"]["median"] for k in times}
    tag = f"phase {phase}, {label}"
    log(f"  {tag}: iterations eager {ie}, graph {ig}; max |x_g - x_e| / "
        f"max |x_e| = {row['diff_graph_eager']:.3e}"
        + (f", f32 vs f64 {row['diff_f32_f64']:.3e}" if x64 is not None
           else ""))
    log(f"    warm host-clock s over {reps}: eager median {med['eager']:.5f}"
        f" ({row['eager_s']['min']:.5f}-{row['eager_s']['max']:.5f}), graph "
        f"median {med['graph']:.5f} ({row['graph_s']['min']:.5f}-"
        f"{row['graph_s']['max']:.5f})")
    for name, t in traced.items():
        if name == "program":
            log(f"    device program: {t['span_ms']:.3f} ms by events, "
                f"{t['bodies']:.0f} bodies at the traced body's busy time: "
                f"idle share at most {t['idle_share_at_most']:.1%} (the "
                f"start's and the reads' time counted idle)")
            continue
        log(f"    traced {name}: busy {t['busy_ms']:.3f} ms of "
            f"{t['span_ms']:.3f} ms, idle share {t['idle_share']:.1%}, "
            f"{t['device_ops']} device operations, {t['kernel_records']} "
            f"records of the port's kernels"
            + (f"; its capture recorded {t['launches_held']} launches of "
               f"them; x unchanged bitwise: {masked_ok}" if name == "body"
               else ""))
    log(f"    per call: {per['runs']:.0f} run(s)"
        + (f", {per['cycles']:.1f} cycle(s)" if "cycles" in per else "")
        + f", bodies {per['replays']:.1f}, host reads graph "
        f"{per['host_reads']:.1f} eager {reads:.1f}; capture "
        f"{row['capture_s']:.3f} s, graph pool {row['pool_mb']:.1f} MB"
        + "".join(f"; {k} {v:.3e}" for k, v in ext.items()))
    if ig != ie:
        fail(f"{tag}: graph iterations {ig}, eager {ie}")
    # one device program a solve (a scan of steps: one in all), read once
    if per["host_reads"] != 1:
        fail(f"{tag}: the graph solve read the host {per['host_reads']} "
             f"times a call, not once")
    if per["replays"] != n_it:
        fail(f"{tag}: the graph solve ran {per['replays']} bodies a call "
             f"for {n_it} iterations")
    if not row["diff_graph_eager"] <= tol:
        fail(f"{tag}: graph solution differs from the eager one by "
             f"{row['diff_graph_eager']:.3e} > {tol:g}")
    if x64 is not None and not row["diff_f32_f64"] <= 1e-4:
        fail(f"{tag}: graph f32 solution differs from the f64 one by "
             f"{row['diff_f32_f64']:.3e}")
    for name, t in traced.items():
        if name != "program" and t["kernel_records"] <= 0:
            fail(f"{tag}: the {name}'s trace holds no record of the port's "
                 f"kernels")
    if records is not any_op and held <= 0:
        fail(f"{tag}: the captured body recorded no launch of the port's "
             f"kernels")
    if not masked_ok:
        fail(f"{tag}: a body replayed after the loop stopped changed x")
    return row


# phase 14: the remaining one-program solves (GMRES, SA-AMG's CG, the
# block-ELL, matrix-free and bf16-vector hierarchies), captured against
# eager, per arm, in the phases whose systems they reuse
ARMS14 = {}


def any_op(name):
    """Every device operation counts as a record (the arms that run no
    kernel of the port)."""
    return True


def gmres_arm(torch, label, A, M, b, kw, x_dense, reps, trace_eager=True,
              cold_eager=True, gate_dense=True, records=None):
    """Phase 14, one GMRES arm: ``gmres_solve(capture=False)`` against a
    ``GMRESLoop`` on the same (A, M, b), through :func:`graph_arm` (f64:
    1e-12); the graph solution against the dense one (1e-6, MG-GMRES's
    phase-10 check, where ``gate_dense``)."""
    from polydeal_tpu_torch.solvers.gmres import gmres_solve
    from polydeal_tpu_torch.solvers.graphs import GMRESLoop

    loop = GMRESLoop(A, M, b, **kw)

    def eager():
        r = gmres_solve(A, b, M=M, capture=False, **kw)
        return r.x, r.iterations

    def graph():
        r = loop.solve(b)
        return r.x, r.iterations

    def extra(xe, xg):
        return {"diff_graph_dense": float((xg - x_dense).abs().max())
                / float(x_dense.abs().max())}

    # gmres_solve reads active once a step and once more a cycle, go once
    # a cycle and once more, then the total and the residual
    row = graph_arm(torch, label, eager, graph, loop, extra=extra,
                    reps=reps, tol=1e-12, trace_eager=trace_eager,
                    cold_eager=cold_eager,
                    eager_reads=lambda p, n: n + 2 * p["cycles"] + 3,
                    records=records, phase="14", store=ARMS14)
    if gate_dense and not row["diff_graph_dense"] <= 1e-6:
        fail(f"phase 14, {label}: the graph solution differs from the "
             f"dense solve by {row['diff_graph_dense']:.3e}")
    return row


def ell_arm(torch, dev, n=32):
    """Phase 14's block-ELL arm: the 2D R-tree hierarchy at ``n`` (levels
    from extraction level 2) with its fine polytopes renumbered by a
    seeded permutation (tests/test_torch_coo_multigrid.py's, there at
    n=16), so the fine level has more than 96 band offsets and goes to
    block-ELL, run flat; f64 R3MG-CG to rtol 1e-9, eager against
    captured."""
    import math

    import numpy as np

    import polydeal_tpu_torch as tpd
    from polydeal_tpu_torch.agglomeration import RTreeAgglomerator
    from polydeal_tpu_torch.assembly import sipg as tsipg
    from polydeal_tpu_torch.solvers import multigrid as tmg
    from polydeal_tpu_torch.sparse import BlockELL

    m = tpd.hyper_cube(2, n)
    agg = RTreeAgglomerator.build(m.cell_centers())
    hs, ps = tmg.build_rtree_hierarchy(m, agg, list(range(2, agg.n_levels
                                                          - 1)), degree=1)
    perm = np.random.default_rng(3).permutation(hs[-1].n_poly)
    hs = hs[:-1] + [tpd.AgglomerationHandler(m, perm[hs[-1].cell2poly],
                                             degree=1)]
    ps = ps[:-1] + [np.asarray(ps[-1])[np.argsort(perm)]]
    u = lambda x: torch.prod(torch.sin(math.pi * x), dim=-1)
    A = tsipg.assemble_sipg_matrix(hs[-1], device=dev)
    b = tsipg.assemble_rhs(hs[-1], lambda x: 2 * math.pi**2 * u(x), u,
                           device=dev)
    mg = tmg.build_multigrid(hs, ps, A, device=dev)
    kinds = [type(e).__name__ for e in mg.ells]
    log(f"  phase 14, block-ELL arm: 2D n={n} permuted R-tree hierarchy, "
        f"levels {[h.n_poly for h in hs]} {kinds}, {hs[-1].n_dofs} DoF")
    if not isinstance(mg.ells[-1], BlockELL) or not mg.graph_ok():
        fail(f"phase 14: the permuted fine level is {kinds[-1]}, graph_ok "
             f"{mg.graph_ok()}")
    graph_arm(torch, f"ELL-level COO 2D n={n}",
              lambda: xi(mg.solve_cg(b, capture=False)),
              lambda: xi(mg.solve_cg(b)),
              mg.cg_loop(1e-9, 200, torch.float64), tol=1e-12, phase="14",
              store=ARMS14)


# phase 15: the sharded solves as one device program, NCCL inside the
# captures; (a) runs in phase 12 on phase 9's system
ARMS15 = {}


def nccl_capture_check(torch, dev, group, smi):
    """(b) of phase 15: one captured program (``solvers/graphs.capture``)
    on the world-size-1 NCCL group that runs the three operations the
    sharded solves put into their programs -- an ``exchange`` to self (one
    batched send/receive pair), an ``all_reduce`` and an
    ``all_gather_into_tensor`` -- replayed on new input and held bitwise
    to the same calls run eagerly; one traced replay lists its device
    operations.  Each result lands where only its collective writes: the
    exchange and the all-gather fill fresh buffers, and the all-reduce
    (at one rank a sum is the identity) pre-multiplies by 2 (NCCL's
    PreMulSum), so its result is twice its input only if the replay ran
    it."""
    import torch.distributed as dist

    from polydeal_tpu_torch.models.profile_flagship import _traced
    from polydeal_tpu_torch.parallel.sharding import exchange
    from polydeal_tpu_torch.solvers.graphs import capture

    gen = torch.Generator(device=dev).manual_seed(15)
    x = torch.randn((4096, 4), generator=gen, dtype=torch.float64,
                    device=dev)
    n = dist.get_world_size(group)

    def compute():
        send, recv = 2.0 * x, torch.empty_like(x)
        exchange(group, [(send, 0, recv, 0, 0)])
        s = (x * x).sum().reshape(1)
        dist.all_reduce(s, op=dist._make_nccl_premul_sum(2.0), group=group)
        g = x.new_empty((n * x.shape[0], x.shape[1]))
        dist.all_gather_into_tensor(g, x + 1.0, group=group)
        return recv, s, g

    outs = [torch.zeros_like(t) for t in compute()]

    def commit(res):
        for o, t in zip(outs, res):
            o.copy_(t)

    prog = capture(compute, commit, device=dev,
                   pool=torch.cuda.graph_pool_handle())
    x.copy_(torch.randn(x.shape, generator=gen, dtype=x.dtype, device=dev))
    prog.replay()
    torch.cuda.synchronize()
    want = compute()
    torch.cuda.synchronize()
    same = [torch.equal(o, w) for o, w in zip(outs, want)]
    # what the replayed collectives wrote: 2x received, x . x doubled on
    # each of the n ranks and summed, x + 1 gathered
    ran = [torch.equal(outs[0], 2.0 * x),
           torch.equal(outs[1], 2.0 * n * (x * x).sum().reshape(1)),
           torch.equal(outs[2], (x + 1.0).repeat(n, 1))]
    # the device operations of 5 replays; a trace that comes back without
    # device records is taken again, up to three times
    names = None
    for _ in range(3):
        TRACES["taken"] += 1
        try:
            _, _, n_ops, ops = _traced(
                lambda: [prog.replay() for _ in range(5)], top=None)
            names = sorted({o["name"][:60] for o in ops})
            break
        except RuntimeError:
            TRACES["empty"] += 1
    log(f"  (b) NCCL inside a capture at world size 1: exchange to self, "
        f"all_reduce, all_gather_into_tensor replayed on new input, bitwise "
        f"equal to the eager calls {same}, each the collective's own result "
        f"{ran}; capture {prog.seconds:.3f} s, "
        f"pool {prog.pool_bytes / 2**20:.1f} MB; 5 traced replays: "
        + (f"{n_ops} device operations: {names}" if names is not None
           else "3 traces held no device record") + f" [{smi}]")
    if not all(same) or not all(ran):
        fail(f"phase 15 (b): the captured collectives differ from the eager "
             f"ones {same} or from their own results {ran}")
    return dict(bitwise=same, ran=ran, capture_s=prog.seconds,
                device_ops=names)


def cross_gpu_check(torch, smi):
    """(c) of phase 15: with two or more cards visible, the probe
    ``tools/nccl_capture_probe.py`` at min(4, count) ranks (both sharded
    systems captured across the cards, held to their eager solves); it
    fails the run on a mismatch or a timeout.  With one card nothing runs."""
    count = torch.cuda.device_count()
    if count < 2:
        log(f"  (c) the cross-GPU check needs two cards ({count} visible): "
            f"not run; PERF.md holds the 4-GPU run of "
            f"tools/nccl_capture_probe.py --nproc 4")
        return None
    nproc = min(4, count)
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "nccl_capture_probe.py"),
         "--nproc", str(nproc), "--n", "64", "--timeout", "600"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    lines = r.stdout.strip().splitlines()
    log(f"  (c) tools/nccl_capture_probe.py --nproc {nproc} --n 64: exit "
        f"{r.returncode}: {lines[-1] if lines else r.stderr[-2000:]}")
    if r.returncode != 0:
        fail(f"phase 15 (c): the {nproc}-GPU probe failed (exit "
             f"{r.returncode})")
    return json.loads(lines[-1])


def phase15(torch, dev, group, smi):
    """Phase 15 (b) and (c), then the arms (a) ran in phase 12."""
    log("phase 15: the sharded solves as one device program")
    rows = dict(nccl_capture=nccl_capture_check(torch, dev, group, smi),
                cross_gpu=cross_gpu_check(torch, smi), arms=ARMS15)
    log("phase 15: " + json.dumps(rows))


# phase 16: the TensorDGQ basis and P_4 through the banded R3MG path, K1,
# K2 and their halo entries at nb 8, 27 and 35 on their runtime-nb build

# the JAX package's f64 flagship with the TensorDGQ basis on the CPU
# (tools/jax_dgq_constants.py; 44.7 s on the CPU)
JAX_DGQ = {"q1_n32": dict(n_dofs=262144, iterations=18,
                          l2=0.00028394390472855514)}
# (label, family, degree, n): fine nb 8, 27 and 35; every level's blocks
# by the einsums (ops/sipg_kernels.kernel_blocks)
DGQ_CASES = (("Q1", "dgq", 1, 64), ("Q2", "dgq", 2, 32), ("P4", "dgp", 4, 32))
# An f32 band of these bases lies further from the f64 solution than the
# P_1 flagship's (1e-5, phase 5).  On the CPU's plain versions
# (tools/f32_band_drift.py): the f32 Q1 solve 6.6e-4 from f64 at n=32
# (1.5e-4 at n=16), Q2 1.0e-4 and P_4 3.2e-4 at n=16, growing ~4x a
# refinement; the f64 Q1 band rounded to f32 alone moves it 2.6e-4, and
# the f64 solve on the f32-assembled band 6.3e-4, so no f32 band reaches
# 1e-4 at these sizes; the f32 CG stops a few iterations later.  The f32
# solves are held to their f64 ones within these, the f64 solve to the
# JAX package's
F32_X_TOL16 = 5e-3
F32_ITS16 = 6
ANY_NB = ("banded_matvec_imajor_any_nb", "banded_fused_cheb_any_nb")
ANY_NB_HALO = ("banded_matvec_halo_any_nb", "banded_fused_halo_any_nb")


def dgq_case(torch, dev, group, label, family, degree, n):
    """One case of phase 16: the flagship on ``family``'s basis at
    ``degree`` and ``n``, f32 with bf16 smoothing copies and captured (the
    card's default), cold then warm, through K1 and K2's runtime-nb build
    and no K3-K5; held to an f64 solve of the same system (iterations
    within :data:`F32_ITS16`, x within :data:`F32_X_TOL16`); sharded at world size 1 (K1/K2 halo's
    runtime-nb build); then K1, K2 (bf16 smoothing copy, bitwise) and the
    halo entries (4-way cuts, bitwise) against their plain versions on the
    fine band.  Returns the kernels' rows (kernel -> row, worst error of
    its cases) and the launch counts of the solves and of the sharded
    solve."""
    from polydeal_tpu_torch.models.flagship import (setup_flagship,
                                                    solve_flagship)
    from polydeal_tpu_torch.ops import _build

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    _build.reset_launches()
    fs = setup_flagship(n=n, degree=degree, family=family, device=dev)
    res = solve_flagship(fs)  # cold: captures the programs
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = solve_flagship(fs)  # warm
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t
    counts = dict(_build.launches)
    nb = fs.handlers[-1].n_basis
    rel = float(res.residual) / float(fs.b.norm())
    phases = {k: round(v, 3) for k, v in fs.setup_phases.items()}
    log(f"  {label} (family {family}, p={degree}, nb={nb}) n={n}: levels "
        f"{fs.level_sizes}, {fs.n_dofs} DoF, {len(fs.band_offsets)} fine "
        f"offsets; setup phases (s) {phases}; warm solve {solve_s:.4f} s, "
        f"{res.iterations} iterations, relative residual {rel:.3e}; "
        f"runtime-nb launches over setup + 2 solves "
        f"{ {k: counts[k] for k in ANY_NB} }")
    if tuple(res.x.shape) != (fs.n_dofs,) or not bool(
            torch.isfinite(res.x).all()):
        fail(f"phase 16 {label}: the solution has the wrong shape or "
             f"non-finite values")
    if not rel <= 1e-8:
        fail(f"phase 16 {label}: relative residual {rel:.3e} > 1e-8")
    for name in ANY_NB:
        if counts[name] <= 0:
            fail(f"phase 16 {label}: {name} was never launched")
    for name in ("volume_blocks", "face_group_blocks", "boundary_blocks"):
        if counts[name]:
            fail(f"phase 16 {label}: {name} launched on a basis the rule "
                 f"gives the einsums")
    ref = setup_flagship(n=n, degree=degree, family=family, device=dev,
                         dtype=torch.float64, precond_dtype=None)
    res64 = solve_flagship(ref)
    true64 = float((ref.b - ref.mg.ells[-1].matvec(res64.x)).norm()) / float(
        ref.b.norm())
    diff = float((res.x.double() - res64.x).abs().max()) / float(
        res64.x.abs().max())
    log(f"  {label} f64 solve: {res64.iterations} iterations, true relative "
        f"residual {true64:.3e}; max |x_f32 - x_f64| / max |x_f64| = "
        f"{diff:.3e}")
    if abs(res.iterations - res64.iterations) > F32_ITS16:
        fail(f"phase 16 {label}: f32 {res.iterations} iterations, f64 "
             f"{res64.iterations}")
    if not true64 <= 1.01e-8:
        fail(f"phase 16 {label}: f64 true relative residual {true64:.3e}")
    if not diff <= F32_X_TOL16:
        fail(f"phase 16 {label}: the f32 solution differs from the f64 one "
             f"by {diff:.3e}")
    del ref
    torch.cuda.empty_cache()
    ss, counts_h = shard_flagship(torch, f"phase 16 {label} flagship", fs,
                                  group, res64.x, tol=F32_X_TOL16)
    del ss, res64
    for name in ANY_NB_HALO:
        if counts_h[name] <= 0:
            fail(f"phase 16 {label}: {name} was never launched on the "
                 f"sharded solve")
    # K0 and fused K0 on every level under 32768 lanes: the f32 band (the
    # eigenvalue estimates' products) and the bf16 smoothing copy
    for e, lo in zip(fs.mg.ells[1:], fs.mg.lo_ells[1:]):
        if e.data_i is None:
            check_k0(torch, f"{label} {e.n_block_rows}-lane", e, {},
                     timed=False)
            check_k0(torch, f"{label} {e.n_block_rows}-lane bf16 copy", lo,
                     {}, timed=False)
    k1, k2 = {}, {}
    fine = fs.mg.ells[-1]
    check_k1(torch, f"{label} fine", fine, k1)
    check_k2(torch, f"{label} fine bf16 copy", fs.mg.lo_ells[-1], k2,
             bitwise=True)
    halo = check_halo_cuts(torch, f"{label} fine", fine, bitwise=True)
    del fs, fine, res
    torch.cuda.empty_cache()

    def worst(cases, main):
        return dict(cases[main], max_abs_err=max(
            c["max_abs_err"] for c in cases.values()))

    rows = {"K1": worst(k1, f"{label} fine float32"),
            "K2": worst(k2, f"{label} fine bf16 copy bfloat16"),
            "K1 halo": worst({d: r["K1 halo"] for d, r in halo.items()},
                             "float32"),
            "K2 halo": worst({d: r["K2 halo"] for d, r in halo.items()},
                             "float32")}
    log(f"  {label} took {time.perf_counter() - t0:.1f} s")
    return nb, rows, counts, counts_h


def phase16(torch, dev, group, build_s):
    """Phase 16 (see the module docstring).  Returns (label, nb, rows,
    launch counts of the solves, of the sharded solve) a case."""
    import math

    from polydeal_tpu_torch.models.flagship import (setup_flagship,
                                                    solve_flagship)
    from polydeal_tpu_torch.postprocess import compute_global_error

    log(f"phase 16: TensorDGQ and P_4 through the banded R3MG path, K1/K2 "
        f"and their halo entries on their runtime-nb build (kernel build "
        f"{build_s:.2f} s)")
    t0 = time.perf_counter()
    out = [(label, *dgq_case(torch, dev, group, label, family, degree, n))
           for label, family, degree, n in DGQ_CASES]
    # Q1 at n=32 in f64 against the JAX package's constant
    fs = setup_flagship(n=32, family="dgq", device=dev, dtype=torch.float64,
                        precond_dtype=None)
    r = solve_flagship(fs)
    u_ex = lambda x: torch.prod(torch.sin(math.pi * x), dim=-1)
    l2 = float(compute_global_error(fs.handlers[-1], r.x, u_ex)[0])
    ref = JAX_DGQ["q1_n32"]
    dl2 = abs(l2 - ref["l2"]) / ref["l2"]
    log(f"  Q1 n=32 f64: {r.iterations} iterations (JAX {ref['iterations']})"
        f", L2 error {l2!r} (JAX {ref['l2']!r}, rel diff {dl2:.2e})")
    if fs.n_dofs != ref["n_dofs"] or abs(
            r.iterations - ref["iterations"]) > 1:
        fail(f"phase 16: Q1 n=32 took {r.iterations} iterations at "
             f"{fs.n_dofs} DoF, JAX {ref['iterations']}")
    if not dl2 <= COO_TOL:
        fail(f"phase 16: Q1 n=32 L2 error differs from JAX's by {dl2:.3e}")
    del fs, r
    torch.cuda.empty_cache()
    log(f"  phase 16 took {time.perf_counter() - t0:.1f} s")
    return out


# Phase 17: the 2D high-order monodomain (MonodomainConfig(dim=2,
# degree=p), the command line's defaults otherwise), where K5 computes the
# boundary blocks at 2D p = 4-5 and the einsums the volume and face blocks.
# The JAX package's numbers at n_refinements=5, lex, f64, one BDF1 and five
# BDF2 steps: printed by tools/jax_mono2d_constants.py
JAX_MONO2D = {
    "p4_n5": dict(n_dofs=15360, iterations=[4, 4, 4, 4, 4, 4],
                  int_u=0.0017231683815484508, int_u2=0.0001830987714734614),
    "p5_n5": dict(n_dofs=21504, iterations=[4, 4, 4, 4, 4, 4],
                  int_u=0.0017314907317214968,
                  int_u2=0.00018403636461233682),
}
MONO2D_JAX_STEPS = 5
MONO2D_TOL = 1e-9  # relative, the integrals against JAX's in f64
# (label, degree, n_refinements, numbering): 3,932,160 and 1,376,256 DoF
MONO2D_CASES = (("p4 lex", 4, 9, "lex"), ("p4 relabel=None", 4, 9, None),
                ("p5 lex", 5, 8, "lex"))


def mono2d_config(degree, n_ref):
    from polydeal_tpu_torch.config import MonodomainConfig

    return MonodomainConfig(dim=2, n_refinements=n_ref, degree=degree)


def mono2d_case(torch, dev, smi, label, degree, n_ref, relabel, ref64):
    """One f32 run of phase 17: built and run captured on the card (1 BDF1
    and MONO_STEPS BDF2 steps, cold then warm), held to the f64 run
    ``ref64`` (label -> integrals; made here for a lex case); K5 launched on
    every level at the build, K3 and K4 on none; the kernels on its real
    bands against their plain versions.  Returns (launch counts of the
    build and both passes, the kernels' rows)."""
    from types import SimpleNamespace

    from polydeal_tpu_torch.models.monodomain import MonodomainSolver
    from polydeal_tpu_torch.ops import _build

    t0 = time.perf_counter()
    cfg = mono2d_config(degree, n_ref)
    _build.reset_launches()
    ms = MonodomainSolver.build(cfg, relabel=relabel, device=dev)
    built = dict(_build.launches)
    mono_steps(ms, MONO_STEPS)  # cold: captures the step programs
    u, _, its, wall = mono_steps(ms, MONO_STEPS)
    counts = dict(_build.launches)
    n_dofs, nb = ms.handler.n_dofs, ms.handler.n_basis
    fine = ms.mg.ells[-1]
    formats = level_formats(SimpleNamespace(mg=ms.mg))
    # the fine band's bytes: its blocks (nb^2 a slot, n_off slots for a
    # band, K for a pack) and the array a kernel streams (R_pad padding)
    arr = fine.data_i if fine.data_i is not None else fine.data
    slots = formats[-1][3] if formats[-1][1] == "packed" else formats[-1][2]
    uq_max = float(ms.u_at_quad(u).max())
    log(f"  {label} (p={degree}, nb={nb}, n_refinements={n_ref}): levels "
        f"(P, format, offsets[, K, R_pad, max |offset|]) {formats}, "
        f"{n_dofs} DoF; the f32 fine band's blocks "
        f"{nb * nb * slots * fine.n_block_rows * 4 / 1e6:.1f} MB ({nb}*{nb}"
        f"*{slots}*{fine.n_block_rows}*4 B), its array "
        f"{arr.numel() * arr.element_size() / 1e6:.1f} MB")
    log(f"  {label} setup phases (s): "
        f"{ {k: round(v, 3) for k, v in ms.setup_phases.items()} }")
    log(f"  {label} {MONO_STEPS} warm BDF2 steps: {wall:.4f} s, "
        f"{MONO_STEPS / wall:.2f} steps/s, "
        f"{n_dofs * MONO_STEPS / wall:.1f} DoF*steps/s [{smi}]")
    log(f"  {label} CG iterations per step (BDF1, then BDF2): {its}; max u "
        f"at quadrature {uq_max:.6f}; launches at the build {built}; over "
        f"the build and both passes {counts}")
    if n_dofs != (4**n_ref) * nb:
        fail(f"phase 17 {label}: {n_dofs} DoF")
    if tuple(u.shape) != (n_dofs,) or not bool(torch.isfinite(u).all()):
        fail(f"phase 17 {label}: u has the wrong shape or non-finite values")
    if not all(2 <= i <= 5 for i in its):
        fail(f"phase 17 {label}: CG iterations {its} outside 2-5 per step")
    if not 0.01 < uq_max < 2.0:
        fail(f"phase 17 {label}: max u {uq_max:.4f} outside (0.01, 2.0)")
    # K5 on every level's boundary blocks, and no K3 or K4: the JAX rule
    if built["boundary_blocks"] != len(ms.mg.ells):
        fail(f"phase 17 {label}: K5 launched {built['boundary_blocks']} "
             f"times at the build of {len(ms.mg.ells)} levels")
    for name in ("volume_blocks", "face_group_blocks"):
        if counts[name]:
            fail(f"phase 17 {label}: {name} launched at p={degree}")
    path = (("banded_matvec_imajor_any_nb", "banded_fused_cheb_any_nb",
             "banded_fused_omajor") if relabel else
            ("packed_matvec", "packed_fused_cheb"))
    for name in path:
        if counts[name] <= 0:
            fail(f"phase 17 {label}: {name} was never launched")
    m32 = integrals(ms, u)
    if relabel and label not in ref64:
        ref = MonodomainSolver.build(cfg, dtype=torch.float64,
                                     relabel=relabel, device=dev)
        u64, _, its64, wall64 = mono_steps(ref, MONO_STEPS)
        ref64[label.split()[0]] = (integrals(ref, u64), its64, wall64)
        del ref, u64
        torch.cuda.empty_cache()
    m64, its64, wall64 = ref64[label.split()[0]]
    rel = [abs(a - b) / abs(b) for a, b in zip(m32, m64)]
    log(f"  {label} against the f64 lex run of the same steps ({wall64:.4f}"
        f" s, iterations {its64}): int u {m32[0]:.9e} (f64 {m64[0]:.9e}, "
        f"rel {rel[0]:.3e}), int u^2 {m32[1]:.9e} (f64 {m64[1]:.9e}, rel "
        f"{rel[1]:.3e})")
    if not max(rel) <= 1e-3:
        fail(f"phase 17 {label}: f32 integrals differ from f64 by {rel}")
    rows = {}
    if relabel:
        k1, k2 = {}, {}
        check_k1(torch, f"mono2d {label} fine", fine, k1)
        check_k2(torch, f"mono2d {label} fine", fine, k2, bitwise=True)
        # the smoother runs on the f32 band; a bf16 copy as the flagship's
        check_k2(torch, f"mono2d {label} fine bf16 copy", SimpleNamespace(
            data_i=fine.data_i.to(torch.bfloat16), n_basis=nb,
            offsets=fine.offsets, offsets_t=fine.offsets_t), k2,
            bitwise=True)
        rows["K1"] = k1[f"mono2d {label} fine float32"]
        rows["K2"] = k2[f"mono2d {label} fine float32"]
        # K0 on every level under 32768 lanes, timed on the largest
        k0 = {}
        levels = [e for e in ms.mg.ells[1:] if e.data_i is None]
        for e in levels:
            check_k0(torch, f"mono2d {label} {e.n_block_rows}-lane", e, k0,
                     timed=e is levels[-1])
        big = f"mono2d {label} {levels[-1].n_block_rows}-lane float32"
        rows["K0"], rows["K0 fused"] = k0[big], k0[f"{big} fused"]
    else:
        rows.update(check_packed_levels(torch, SimpleNamespace(
            mg=ms.mg, n_dofs=n_dofs), dev))
    del ms, u
    torch.cuda.empty_cache()
    if relabel:
        from polydeal_tpu_torch.models.profile_sipg import mono_handlers
        level_sipg_check(torch, mono_handlers(cfg, relabel), dev,
                         f"mono2d {label}")
    log(f"  {label} took {time.perf_counter() - t0:.1f} s")
    return counts, rows


def phase17(torch, dev, smi):
    """Phase 17 (see the module docstring).  Returns (launch counts and
    kernel rows of the p4 lex run, launch counts of the p5 lex run)."""
    from polydeal_tpu_torch.models.monodomain import MonodomainSolver

    log("phase 17: the 2D high-order monodomain (K5 at 2D p = 4-5)")
    t0 = time.perf_counter()
    ref64, out = {}, {}
    for label, degree, n_ref, relabel in MONO2D_CASES:
        out[label] = mono2d_case(torch, dev, smi, label, degree, n_ref,
                                 relabel, ref64)
    # f64 at the constants' size against the JAX package
    for key, degree in (("p4_n5", 4), ("p5_n5", 5)):
        jx = JAX_MONO2D[key]
        s = MonodomainSolver.build(mono2d_config(degree, 5),
                                   dtype=torch.float64, relabel="lex",
                                   device=dev)
        u, _, its, _ = mono_steps(s, MONO2D_JAX_STEPS)
        m = integrals(s, u)
        rel = [abs(a - b) / abs(b) for a, b in zip(
            m, (jx["int_u"], jx["int_u2"]))]
        log(f"  {key} f64 ({s.handler.n_dofs} DoF): iterations {its} (JAX "
            f"{jx['iterations']}); int u {m[0]!r} (JAX {jx['int_u']!r}, rel "
            f"{rel[0]:.2e}), int u^2 {m[1]!r} (JAX {jx['int_u2']!r}, rel "
            f"{rel[1]:.2e})")
        if s.handler.n_dofs != jx["n_dofs"] or its != jx["iterations"]:
            fail(f"phase 17 {key}: iterations {its} at {s.handler.n_dofs} "
                 f"DoF, JAX {jx['iterations']} at {jx['n_dofs']}")
        if not max(rel) <= MONO2D_TOL:
            fail(f"phase 17 {key}: integrals differ from JAX's by {rel}")
        del s, u
        torch.cuda.empty_cache()
    log(f"  phase 17 took {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; the port's kernels "
              "run only on a GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "polydeal_tpu_torch")):
        print("chip_smoke: run from the root of a checkout (the "
              "polydeal_tpu_torch package is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    global bound
    from polydeal_tpu_torch.models.flagship import (setup_flagship,
                                                    solve_flagship)
    from polydeal_tpu_torch.models.profile_sipg import bound, ptxas_summary
    from polydeal_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}; {smi}")

    log("phase 2: build kernels")
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    log(f"  built in {build_s:.2f} s; by source (each in its own nvcc, all "
        f"at once): " + ", ".join(
            line[3:] for line in _build.last_build_log().splitlines()
            if line.startswith("== ")))
    for line in ptxas_summary(_build.last_build_log()):
        log(f"  ptxas: {line}")
    # phase 8's process group: NCCL, one rank, through a FileStore
    from polydeal_tpu_torch.parallel.sharding import init_group, leave_group
    store_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    group = init_group(0, 1, device=dev,
                       store_path=os.path.join(store_dir, "store"))

    log("phase 3: kernels against their plain versions (flagship shapes)")
    kres = check_kernels(torch, dev)
    kres["set_condition"] = check_set_condition(torch, dev)
    torch.cuda.empty_cache()
    kres.update(check_sipg_kernels(torch, dev))

    log("phase 4: small f64 solve, card against CPU")
    small_solve_check(torch, dev)

    log("phase 5: flagship n=64, p=1 on the card")
    torch.cuda.synchronize()
    base5 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    fs = setup_flagship(n=64, device=dev)
    res = solve_flagship(fs)  # cold
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = solve_flagship(fs)  # warm
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t1
    counts = dict(_build.launches)
    mem5 = peak_mb(torch, base5)
    bnorm = float(fs.b.norm())
    rel = float(res.residual) / bnorm
    x = res.x
    phases = {k: round(v, 3) for k, v in fs.setup_phases.items()}
    log(f"  levels {fs.level_sizes}, band offsets {fs.band_offsets.tolist()},"
        f" {fs.n_dofs} DoF")
    log(f"  setup phases (s): {phases}")
    log(f"  warm solve: {solve_s:.4f} s, {res.iterations} iterations, "
        f"relative residual {rel:.3e}")
    log(f"  kernel build: {build_s:.2f} s; launches over setup + 2 solves: "
        f"{counts}")
    if tuple(x.shape) != (fs.n_dofs,) or not bool(torch.isfinite(x).all()):
        fail("flagship solution has the wrong shape or non-finite values")
    if not rel <= 1e-8:
        fail(f"flagship relative residual {rel:.3e} > 1e-8")
    if not 18 <= res.iterations <= 22:
        fail(f"flagship took {res.iterations} iterations, outside 18-22")
    for name in ("banded_matvec_imajor", "banded_fused_cheb",
                 "banded_matvec_omajor", "banded_fused_omajor",
                 "volume_blocks", "face_group_blocks", "boundary_blocks",
                 "set_condition"):
        if counts[name] <= 0:
            fail(f"kernel {name} was never launched on the main path")

    # Reference: the same system solved in f64.  The f32 solve's residual
    # above is CG's recursive one; an f32 vector cannot have a small TRUE
    # residual here (A amplifies its rounding by lambda_max: rounding the
    # f64 solution to f32 alone leaves ~1e-3 at n=64), so the f32 solution
    # is held to the f64 one instead.
    ref = setup_flagship(n=64, device=dev, dtype=torch.float64,
                         precond_dtype=None)
    res64 = solve_flagship(ref)
    true64 = float((ref.b - ref.mg.ells[-1].matvec(res64.x)).norm()) / float(
        ref.b.norm())
    diff = float((x.double() - res64.x).abs().max()) / float(
        res64.x.abs().max())
    log(f"  f64 reference solve: {res64.iterations} iterations, true "
        f"relative residual {true64:.3e}; max |x_f32 - x_f64| / max |x_f64|"
        f" = {diff:.3e}")
    if not true64 <= 1.01e-8:
        fail(f"f64 reference true relative residual {true64:.3e} > 1e-8")
    if not diff <= 1e-4:
        fail(f"f32 flagship solution differs from the f64 one by {diff:.3e}")
    graph_arm(torch, "lex flagship",
              lambda: xi(solve_flagship(fs, capture=False)),
              lambda: xi(solve_flagship(fs)),
              fs.mg.cg_loop(1e-8, 100, torch.float32), x64=res64.x)
    # phase 6 holds the packed solve to the same f64 solution, by cell
    x64_cells = cell_order(torch, ref, res64.x)
    # phase 11 reuses phase 5's system: its hierarchy, rhs, fine bands
    # (f32 and f64) and solutions
    keep = dict(n=64, handlers=fs.handlers, parents=fs.parents,
                grid_shapes=fs.grid_shapes, b=fs.b, its=res.iterations,
                A32=fs.mg.ells[-1], A64=ref.mg.ells[-1], x64=res64.x,
                x64_cells=x64_cells, mem5=mem5)
    del ref
    torch.cuda.empty_cache()
    log("phase 8 on phase 5's system: the lex flagship sharded")
    shard_flagship(torch, "lex flagship", fs, group, res64.x)
    del res64
    check_halo_cuts(torch, "lex flagship fine", fs.mg.ells[-1])
    check_halo_cuts(torch, "lex flagship fine bf16 copy", fs.mg.lo_ells[-1])
    level_sipg_check(torch, fs.handlers, dev, "lex flagship")
    # K0 and fused K0 serve the 4096-lane level (no i-major copy): its f32
    # band (the FMG residuals) and the bf16 copy the smoother runs on; K2
    # the bf16 copies of the 32768- and 262144-lane levels
    if fs.mg.ells[1].data_i is not None:
        fail("the 4096-lane lex level carries an i-major copy")
    k0, k2 = {}, {}
    check_k0(torch, "lex flagship 4096-lane", fs.mg.ells[1], k0)
    check_k0(torch, "lex flagship 4096-lane bf16 copy", fs.mg.lo_ells[1], k0)
    for e in fs.mg.lo_ells[2:]:
        check_k2(torch, f"lex flagship {e.n_block_rows}-lane bf16 copy", e,
                 k2)
    del fs, res, x
    torch.cuda.empty_cache()

    log("phase 6: flagship n=64, p=1 without the relabel (packed levels)")
    _build.reset_launches()
    fsp = setup_flagship(n=64, relabel=None, device=dev)
    resp = solve_flagship(fsp)  # cold
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    resp = solve_flagship(fsp)  # warm
    torch.cuda.synchronize()
    solve_p = time.perf_counter() - t1
    counts6 = dict(_build.launches)
    relp = float(resp.residual) / float(fsp.b.norm())
    formats = level_formats(fsp)
    log(f"  levels (P, format, offsets[, K, R_pad, max |offset|]): {formats}")
    phases = {k: round(v, 3) for k, v in fsp.setup_phases.items()}
    log(f"  setup phases (s): {phases}")
    log(f"  warm solve: {solve_p:.4f} s, {resp.iterations} iterations, "
        f"relative residual {relp:.3e}")
    log(f"  launches over setup + 2 solves: {counts6}")
    xp = resp.x
    if tuple(xp.shape) != (fsp.n_dofs,) or not bool(
            torch.isfinite(xp).all()):
        fail("packed flagship solution has the wrong shape or non-finite "
             "values")
    want = [(512, "banded"), (4096, "packed"), (32768, "packed"),
            (262144, "packed")]
    if [f[:2] for f in formats] != want:
        fail(f"packed flagship levels are {formats}, want {want}")
    if not relp <= 1e-8:
        fail(f"packed flagship relative residual {relp:.3e} > 1e-8")
    if not 18 <= resp.iterations <= 22:
        fail(f"packed flagship took {resp.iterations} iterations, outside "
             f"18-22")
    dp = float((cell_order(torch, fsp, xp) - x64_cells).abs().max()) / float(
        x64_cells.abs().max())
    log(f"  max |x_packed_f32 - x_lex_f64| / max |x_lex_f64| by cell = "
        f"{dp:.3e}")
    if not dp <= 1e-4:
        fail(f"packed f32 solution differs from the f64 lex one by {dp:.3e}")
    graph_arm(torch, "relabel=None flagship",
              lambda: xi(solve_flagship(fsp, capture=False)),
              lambda: xi(solve_flagship(fsp)),
              fsp.mg.cg_loop(1e-8, 100, torch.float32), x64=x64_cells,
              to64=lambda x: cell_order(torch, fsp, x))
    for name in ("volume_blocks", "face_group_blocks", "boundary_blocks",
                 "packed_matvec", "packed_fused_cheb"):
        if counts6[name] <= 0:
            fail(f"kernel {name} was never launched on the packed path")
    log("phase 8 on phase 6's system: the relabel=None flagship sharded")
    ssp, counts6s = shard_flagship(torch, "relabel=None flagship", fsp,
                                   group, x64_cells, by_cell=True)
    sharded_arm(torch, "relabel=None sharded (world size 1)", ssp, fsp.b,
                x64_cells, lambda x: cell_order(torch, fsp, x))
    for name in ("packed_matvec_halo", "packed_fused_halo"):
        if counts6s[name] <= 0:
            fail(f"kernel {name} was never launched on the sharded packed "
                 f"path")
    # the sharded path's own fine slab (f32: a pack keeps no bf16 copy)
    fine, pl = ssp.levels[-1], ssp.params[-1]
    halo_rows = check_halo_slab(
        torch, "relabel=None fine slab", Slab(
            torch, pl["data_i"], pl["offsets_t"], fine.nb, fine.T,
            pl["oid"]), torch.Generator(device=dev).manual_seed(10),
        library=True)
    del ssp, fine, pl
    check_halo_cuts(torch, "relabel=None fine pack", fsp.mg.ells[-1])
    del resp, xp, x64_cells
    kres.update(check_packed_levels(torch, fsp, dev))
    check_k0(torch, "relabel=None 512-lane", fsp.mg.ells[0], k0)
    del fsp
    torch.cuda.empty_cache()
    formats16 = small_solve_check(torch, dev, relabel=None)
    if not all(f[1] == "packed" for f in formats16[1:]):
        fail(f"small packed solve levels are {formats16}")

    counts7 = phase7(torch, dev, k0, k2)
    counts8 = phase8(torch, dev, group, halo_rows)
    counts9, rows9, keep9 = phase9(torch, dev)
    counts10, rows10 = phase10(torch, dev)
    counts11, rows11 = phase11(torch, dev, group, keep)
    phase12(torch, dev, group, keep, keep9, kres)
    del keep, keep9
    log("phase 13: captured solves against eager ones (arms run in phases "
        "5-8): " + json.dumps(ARMS))
    ell_arm(torch, dev)
    log("phase 14: the remaining one-program solves against eager ones "
        "(arms run in phases 10, 11 and here): " + json.dumps(ARMS14))
    phase15(torch, dev, group, smi)
    out16 = phase16(torch, dev, group, build_s)
    out17 = phase17(torch, dev, smi)
    leave_group()
    shutil.rmtree(store_dir, ignore_errors=True)
    kres.update(halo_rows)
    for key, rows, main_row in (
            ("K0", {k: r for k, r in k0.items() if not k.endswith("fused")},
             "monodomain 4096-lane float32"),
            ("K0 fused", {k: r for k, r in k0.items() if k.endswith("fused")},
             "monodomain 4096-lane float32 fused"),
            ("K2", k2, "lex flagship 262144-lane bf16 copy bfloat16")):
        worst = max(r["max_abs_err"] for r in rows.values())
        kres[key] = dict(rows[main_row], max_abs_err=max(
            worst, kres.get(key, {}).get("max_abs_err", 0.0)))

    banded, sipg, packed, k1, packed_bf16, omajor, loops = (
        "polydeal_tpu_torch/csrc/banded.cu", "polydeal_tpu_torch/csrc/sipg.cu",
        "polydeal_tpu_torch/csrc/packed.cu",
        "polydeal_tpu_torch/csrc/banded_matvec.cu",
        "polydeal_tpu_torch/csrc/packed_bf16.cu",
        "polydeal_tpu_torch/csrc/banded_omajor.cu",
        "polydeal_tpu_torch/csrc/graph_loop.cu")
    rows = [("banded_matvec_imajor", "K1", k1,
             "polydeal_tpu/ops/banded.py:65"),
            ("banded_matvec_omajor", "K0", omajor,
             "polydeal_tpu/ops/banded.py:176"),
            ("banded_fused_omajor", "K0 fused", omajor,
             "polydeal_tpu/ops/banded.py:176"),
            ("banded_fused_cheb", "K2", banded,
             "polydeal_tpu/ops/fused_cheb.py:210"),
            ("volume_blocks", "volume_blocks", sipg,
             "polydeal_tpu/ops/sipg_kernels.py:428"),
            ("face_group_blocks", "face_group_blocks", sipg,
             "polydeal_tpu/ops/sipg_kernels.py:167"),
            ("boundary_blocks", "boundary_blocks", sipg,
             "polydeal_tpu/ops/sipg_kernels.py:324"),
            ("packed_matvec", "K6", packed,
             "polydeal_tpu/ops/packed.py:185"),
            ("packed_fused_cheb", "K7", packed,
             "polydeal_tpu/ops/fused_cheb.py:122"),
            ("banded_matvec_halo", "K1 halo", k1,
             "polydeal_tpu/ops/banded.py:267"),
            ("banded_fused_halo", "K2 halo", banded,
             "polydeal_tpu/ops/fused_cheb.py:417"),
            ("packed_matvec_halo", "K6 halo", packed,
             "polydeal_tpu/ops/packed.py:313"),
            ("packed_fused_halo", "K7 halo", packed,
             "polydeal_tpu/ops/fused_cheb.py:438"),
            # the loop condition of the JAX package's lax.while_loop (no
            # Pallas kernel): the device loops' set_condition
            ("set_condition", "set_condition", loops,
             "polydeal_tpu/solvers/cg.py:87")]
    # launches: each kernel's count on its path (K1-K5 phase 5, K6/K7
    # phase 6, K0 and fused K0 phase 7, K1/K2 halo phase 8's sharded
    # solves, K6/K7 halo the sharded relabel=None solve)
    path = {"K6": counts6, "K7": counts6, "K0": counts7, "K0 fused": counts7,
            "K1 halo": counts8, "K2 halo": counts8, "K6 halo": counts6s,
            "K7 halo": counts6s}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [dict(name=name, route="cuda", source=src, replaces=rpl,
                    launches=path.get(key, counts)[name],
                    **{k: kres[key][k] for k in keys + ("plan", "floor_ms")
                       if k in kres[key]})
               for name, key, src, rpl in rows]
    # phase 9's path (the COO Poisson solve at n=64) runs K1, K2, K0 and
    # fused K0 on its own bands: a row each, its launches that path's
    kernels += [dict(name=f"{name}_coo", route="cuda", source=src,
                     replaces=rpl, launches=counts9[name],
                     case=rows9[key]["case"],
                     **{k: rows9[key][k] for k in keys + ("plan",)
                        if k in rows9[key]})
                for name, key, src, rpl in rows if key in rows9]
    # phase 10's path (darcy_stokes' MG-GMRES at n=64: the field-block
    # V-cycles on nb = 12 and nb = 3 bands) runs K0 and fused K0: a row
    # each, on the velocity block's fine band
    kernels += [dict(name=f"{name}_coupled", route="cuda", source=src,
                     replaces=rpl, launches=counts10[name],
                     case=rows10[key]["case"],
                     **{k: rows10[key][k] for k in keys + ("plan",)
                        if k in rows10[key]})
                for name, key, src, rpl in rows if key in rows10]
    # phase 11's path: K6 with bf16 x on the relabel=None bf16-vector solve,
    # K6 halo with bf16 x on its sharded solve
    kernels += [dict(name=name, route="cuda", source=packed_bf16,
                     replaces=rpl, launches=counts11[key][name],
                     **{k: rows11[key][k] for k in keys})
                for name, key, rpl in (
                    ("packed_matvec_bf16", "K6 bf16",
                     "polydeal_tpu/ops/packed.py:185"),
                    ("packed_matvec_halo_bf16", "K6 halo bf16",
                     "polydeal_tpu/ops/packed.py:313"))]
    # phase 16's paths: K1 and K2 at nb 8, 27 and 35 on the runtime-nb
    # build, launched by each case's solves; their halo entries by its
    # sharded solve
    any_nb = "polydeal_tpu_torch/csrc/banded_any_nb.cu"
    for label, nb, rows16, c16, c16h in out16:
        for key, name, rpl in (
                ("K1", "banded_matvec_imajor_any_nb",
                 "polydeal_tpu/ops/banded.py:65"),
                ("K2", "banded_fused_cheb_any_nb",
                 "polydeal_tpu/ops/fused_cheb.py:210"),
                ("K1 halo", "banded_matvec_halo_any_nb",
                 "polydeal_tpu/ops/banded.py:267"),
                ("K2 halo", "banded_fused_halo_any_nb",
                 "polydeal_tpu/ops/fused_cheb.py:417")):
            kernels.append(dict(
                name=f"{name}_{label.lower()}", route="cuda", source=any_nb,
                replaces=rpl, launches=(c16h if "halo" in key else c16)[name],
                nb=nb, **{k: rows16[key][k] for k in keys + ("plan",)
                          if k in rows16[key]}))
    # phase 17's paths: K5 at 2D p = 4 and 5 (phase 3's seeded fine
    # boundary tables), launched at the lex runs' builds; K1 and K2 at nb
    # 15 and 21 on the runtime-nb build (the lex runs' fine bands), K6 and
    # K7 at nb 15 (the relabel=None run's fine pack)
    for label, key, deg in (("p4 lex", "boundary_blocks 2d p4", 4),
                            ("p5 lex", "boundary_blocks 2d p5", 5)):
        kernels.append(dict(
            name=f"boundary_blocks_2d_p{deg}", route="cuda", source=sipg,
            replaces="polydeal_tpu/ops/sipg_kernels.py:324",
            launches=out17[label][0]["boundary_blocks"],
            **{k: kres[key][k] for k in keys}))
    for label in ("p4 lex", "p5 lex"):
        c17, rows17 = out17[label]
        for key, name, src, rpl in (
                ("K1", "banded_matvec_imajor_any_nb", any_nb,
                 "polydeal_tpu/ops/banded.py:65"),
                ("K2", "banded_fused_cheb_any_nb", any_nb,
                 "polydeal_tpu/ops/fused_cheb.py:210"),
                ("K0 fused", "banded_fused_omajor", omajor,
                 "polydeal_tpu/ops/banded.py:176")):
            kernels.append(dict(
                name=f"{name}_mono2d_{label.split()[0]}", route="cuda",
                source=src, replaces=rpl, launches=c17[name],
                **{k: rows17[key][k] for k in keys + ("plan",)
                   if k in rows17[key]}))
    c17, rows17 = out17["p4 relabel=None"]
    for key, name, rpl in (("K6", "packed_matvec",
                            "polydeal_tpu/ops/packed.py:185"),
                           ("K7", "packed_fused_cheb",
                            "polydeal_tpu/ops/fused_cheb.py:122")):
        kernels.append(dict(name=f"{name}_mono2d_p4", route="cuda",
                            source=packed, replaces=rpl, launches=c17[name],
                            **{k: rows17[key][k] for k in keys}))
    log(f"profiler traces: {TRACES['taken']} taken, {TRACES['empty']} held "
        f"no record of the traced kernel, {TRACES['by_events']} readings by "
        f"queued CUDA events instead")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
