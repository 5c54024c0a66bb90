"""Cardiac monodomain with the Bueno-Orovio minimal ventricular model.

Counterpart of ``polydeal_tpu/models/monodomain.py`` (the reference's
examples/monodomain_DG3D.cc): chi C_m du/dt = div(sigma grad u) - chi
I_ion(u, w) + I_app, three gating variables w integrated pointwise at the
quadrature points (explicitly) and the diffusion implicit, BDF1/BDF2 IMEX.
The state is lane-aligned as in the JAX package: the basis table is
[C, q, nb, P], the gating state [3, C, q, P].

Every level is assembled directly in the banded layout as sigma*K +
mass_coeff*M (the mass in the diagonal band row) through the SIPG block
kernels K3-K5, and each step solves with R3MG-preconditioned CG from a
zero start.  On the card the levels below ``multigrid.IMAJOR_MIN_P``
polytopes smooth through fused K0, the larger ones through K2 (K1 for the
CG operator).  On the card each step runs as captured programs (the
JAX package's jitted ``step1``/``step2``, ``solvers/graphs``): one
device program a step, the CG a WHILE loop on the device, so a step reads
the host once (its iterations), and
:meth:`MonodomainSolver.steps_scan` launches the step's program once a
step with the time and the iteration counts on the device (its
``lax.scan``), and reads the host once in all.

Usage::

    cfg = MonodomainConfig(dim=3, n_refinements=6, dt=5e-5)
    solver = MonodomainSolver.build(cfg, device=torch.device("cuda"))
    u, w, iters = solver.run(n_steps=20)

or ``python -m polydeal_tpu_torch.models.monodomain --device cpu``.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from polydeal_tpu_torch.agglomeration.rtree import RTreeAgglomerator
from polydeal_tpu_torch.assembly.sipg import (
    assemble_mass_banded_direct,
    assemble_sipg_banded_direct,
    build_banded_groups,
)
from polydeal_tpu_torch.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from polydeal_tpu_torch.config import BuenoOrovioParams, MonodomainConfig
from polydeal_tpu_torch.mesh.fine_mesh import hyper_cube
from polydeal_tpu_torch.ops import _build
from polydeal_tpu_torch.solvers import multigrid
from polydeal_tpu_torch.solvers.cg import (
    block_jacobi_preconditioner,
    cg_solve,
)
from polydeal_tpu_torch.sparse import BlockBanded

__all__ = ["MonodomainSolver", "run_monodomain", "bench_config",
           "ionic_rates",
           "ionic_rates_t", "ionic_current", "ionic_current_t",
           "ionic_current_parts"]


def _hs(u, theta):
    """Sharp Heaviside H(u - theta)."""
    return (u > theta).to(u.dtype)


def _h(u, theta, k):
    """Smooth Heaviside 0.5 (1 + tanh(k (u - theta)))."""
    return 0.5 * (1.0 + torch.tanh(k * (u - theta)))


def _rates(u, p: BuenoOrovioParams):
    a0 = (1.0 - _hs(u, p.V1)) / (
        _hs(u, p.V1m) * (p.tau1pp - p.tau1p) + p.tau1p)
    a1 = (1.0 - _hs(u, p.V2)) / (
        _h(u, p.V2m, p.k2) * (p.tau2pp - p.tau2p) + p.tau2p)
    a2 = 1.0 / (_hs(u, p.V2) * (p.tau3pp - p.tau3p) + p.tau3p)
    b0 = -_hs(u, p.V1) / p.tau1plus
    b1 = -_hs(u, p.V2) / p.tau2plus
    b2 = torch.zeros_like(u)
    wi0 = 1.0 - _hs(u, p.V1m)
    wi1 = (_hs(u, p.Vo) * (p.w_star_inf - 1.0 + u / p.tau2inf) + 1.0
           - u / p.tau2inf)
    wi2 = _h(u, p.V3, p.k3)
    return (a0, a1, a2), (b0, b1, b2), (wi0, wi1, wi2)


def ionic_rates(u, p: BuenoOrovioParams):
    """(alpha[..., 3], beta[..., 3], w_inf[..., 3]) at u, any shape."""
    return tuple(torch.stack(r, dim=-1) for r in _rates(u, p))


def ionic_rates_t(u, p: BuenoOrovioParams):
    """ionic_rates with the gating axis FIRST ([3, ...]: lane-aligned when
    u is [..., P])."""
    return tuple(torch.stack(r, dim=0) for r in _rates(u, p))


def ionic_current_parts(u, w0, w1, w2, p: BuenoOrovioParams):
    """I_ion from separate gating components (layout-agnostic)."""
    i_fi = (-_hs(u, p.V1) * (u - p.V1) * (p.Vhat - u) * w0) / p.taufi
    i_so = ((1.0 - _hs(u, p.V2)) * (u - p.Vo)) / (
        _hs(u, p.Vo) * (p.tauopp - p.tauop) + p.tauop
    ) + _hs(u, p.V2) / (
        _h(u, p.Vso, p.kso) * (p.tausopp - p.tausop) + p.tausop)
    i_si = -(_hs(u, p.V2) * w1 * w2) / p.tausi
    return i_fi + i_so + i_si


def ionic_current(u, w, p: BuenoOrovioParams):
    """I_ion(u, w), gating state [..., 3] (reference Iion,
    monodomain_DG3D.cc:1258-1278)."""
    return ionic_current_parts(u, w[..., 0], w[..., 1], w[..., 2], p)


def ionic_current_t(u, w_first, p: BuenoOrovioParams):
    """ionic_current with gating state [3, ...] (axis first)."""
    return ionic_current_parts(u, w_first[0], w_first[1], w_first[2], p)


class _PhaseClock:
    """Host-clock seconds per setup phase, synchronising a CUDA device at
    each lap so that a phase holds its own device work."""

    def __init__(self, device):
        dev = torch.device(device)
        self._sync = (torch.cuda.synchronize if dev.type == "cuda"
                      else (lambda: None))
        self.phases = {}
        self._t = time.perf_counter()

    def lap(self, name: str) -> None:
        self._sync()
        t = time.perf_counter()
        self.phases[name] = t - self._t
        self._t = t


@dataclass
class MonodomainSolver:
    """The discrete operators and the IMEX step.  ``mg`` is the R3MG
    preconditioner (None on the block-Jacobi path, which runs CG on the
    fine o-major band ``A``)."""

    cfg: MonodomainConfig
    handler: object
    mg: multigrid.Multigrid | None
    B_t: torch.Tensor  # [C, q, nb, P] basis values at quadrature
    w_t: torch.Tensor  # [C, q, P] quadrature weights (JxW)
    stim_t: torch.Tensor  # [C, q, P] stimulus mask
    A: BlockBanded  # finest-level band (block-Jacobi path)
    jacobi: Callable | None = None  # block-Jacobi M^{-1} when mg is None
    # seconds (host clock, synchronised): hierarchy, transfers, assembly
    # (every level's tables and band), mg_setup, tables (fine quadrature);
    # and, before them and in none of them, kernel_load and cuda_init
    # (ops/_build.prepare_device; 0.0 off CUDA)
    setup_phases: dict = field(default_factory=dict)
    # the captured step (_StepGraphs), made at the first captured step
    _graphs: object = field(default=None, init=False, repr=False,
                            compare=False)

    @classmethod
    def build(cls, cfg: MonodomainConfig, dtype=torch.float32, mesh=None,
              relabel=None, *, device) -> "MonodomainSolver":
        """Hierarchy, per-level bands, multigrid and quadrature tables on
        ``device``.  ``relabel='lex'`` renumbers every level in sliced-
        lexicographic order (2 dim + 1 band offsets, grid transfers).
        Float32 products stay full float32 (no TF32) for the process."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        first_use = _build.prepare_device(device)
        clock = _PhaseClock(device)
        p = cfg.ionic
        if mesh is None:
            mesh = hyper_cube(cfg.dim, 2**cfg.n_refinements)
        agg = RTreeAgglomerator.build(mesh.cell_centers())
        levels = (list(range(cfg.multigrid.starting_level, agg.n_levels - 1))
                  or [1])
        handlers, parents = multigrid.build_rtree_hierarchy(
            mesh, agg, levels, degree=cfg.degree, relabel=relabel)
        ah = handlers[-1]
        grid_shapes = (multigrid.detect_grid_shapes(handlers, parents)
                       if relabel else None)
        clock.lap("hierarchy")

        bdf = 1.0 if cfg.time_stepping_scheme == "BDF1" else 1.5
        mass_coeff = bdf * p.chi * p.Cm / cfg.dt

        transfers = [
            multigrid.Transfer(
                E=multigrid.build_embedding(handlers[l], handlers[l + 1],
                                            parents[l], dtype=dtype,
                                            device=device),
                parent=parents[l], n_coarse=handlers[l].n_poly,
                grid_shape=None if grid_shapes is None else grid_shapes[l])
            for l in range(len(handlers) - 1)
        ]
        clock.lap("transfers")

        # per-level banded assembly: sigma*K + mass_coeff*M with the mass
        # added into the diagonal band row (reference operator
        # utils.h:1128-1137), before any packing or i-major copy
        matrices = []
        for li, h in enumerate(handlers):
            ft = h.faces
            interior = ~ft.is_boundary
            diffs = (ft.poly_out - ft.poly_in)[interior].astype(np.int64)
            offs = np.unique(np.concatenate(
                [diffs, -diffs, np.zeros(1, dtype=np.int64)]))
            groups = build_banded_groups(h, offs, dtype, device=device)
            K = assemble_sipg_banded_direct(h, groups, offsets=offs)
            Md = assemble_mass_banded_direct(h, groups)
            A_l = BlockBanded(K.data * p.sigma, K.offsets,
                              K.n_block_cols).add_to_diagonal_band(
                                  mass_coeff * Md)
            if li == len(handlers) - 1:
                fine_groups, A_fine = groups, A_l
            if li > 0:
                A_l = multigrid.maybe_pack_level(h, A_l)
            matrices.append(A_l)
        clock.lap("assembly")

        mg = jacobi = None
        if cfg.multigrid.preconditioner == "agglomg" and len(matrices) > 1:
            mg = multigrid.Multigrid.setup(
                matrices, transfers,
                chebyshev_degree=cfg.multigrid.chebyshev_degree,
                n_smooth=cfg.multigrid.n_smoothing_steps,
                smoothing_range=cfg.multigrid.smoothing_range)
        else:
            jacobi = block_jacobi_preconditioner(A_fine.diag_blocks())
        clock.lap("mg_setup")

        # lane-aligned quadrature tables straight from the slot-padded
        # volume group (cells ordered by polytope lane)
        vol = fine_groups["vol"]
        B_t = ah.basis.eval_t(vol["pts"]).to(dtype)  # [C, q, nb, P]
        ext_t, lo_t = fine_groups["ext_t"], fine_groups["lo_t"]
        real = lo_t[None, None] + vol["pts"] * ext_t[None, None]
        # [C, q, dim, P] -> distance from the origin corner
        dist = torch.sqrt(torch.sum(real**2, dim=2))  # [C, q, P]
        stim_t = (dist < cfg.stimulus_radius).to(dtype)
        clock.lap("tables")
        return cls(cfg=cfg, handler=ah, mg=mg, B_t=B_t, w_t=vol["w"],
                   stim_t=stim_t, A=A_fine, jacobi=jacobi,
                   setup_phases={**clock.phases, **first_use})

    # ------------------------------------------------------------------
    def initial_state(self):
        """(u, w): u = 0 [n_dofs], w = (1, 1, 0) resting state
        [3, C, q, P]."""
        u = torch.zeros(self.handler.n_dofs, dtype=self.B_t.dtype,
                        device=self.B_t.device)
        w = torch.stack([torch.ones_like(self.w_t), torch.ones_like(self.w_t),
                         torch.zeros_like(self.w_t)], dim=0)
        return u, w

    def u_at_quad(self, u: torch.Tensor) -> torch.Tensor:
        """[C, q, P] potential at quadrature points."""
        ah = self.handler
        ut = u.reshape(ah.n_poly, ah.n_basis).T  # [nb, P]
        return torch.einsum("cqip,ip->cqp", self.B_t, ut)

    def _rhs_t(self, u_n, u_nm1, w, t, bdf2: bool):
        """(rhs [nb, P], w_np1) of one IMEX step at the device time ``t``
        (f64, 0-dim): the gating update and the right-hand side."""
        cfg, p = self.cfg, self.cfg.ionic
        dt = cfg.dt
        uq_n = self.u_at_quad(u_n)
        uq_nm1 = self.u_at_quad(u_nm1) if bdf2 else None
        u_star = 2.0 * uq_n - uq_nm1 if bdf2 else uq_n  # BDF2 extrapolation

        # gating update (pointwise at quadrature points, reference
        # update_w_and_ion), state [3, C, q, P]
        a, b, winf = ionic_rates_t(u_star, p)
        w_np1 = w + dt * ((b - a) * w + a * winf)

        i_ion = ionic_current_t(u_star, w_np1, p)
        # the stimulus switch on the device, as the JAX package's jnp.where
        stim = torch.where(t < cfg.end_time_current, cfg.applied_current,
                           0.0)
        i_app = stim * self.stim_t

        u_hist = (2.0 * uq_n - 0.5 * uq_nm1) if bdf2 else uq_n
        integrand = (p.chi * p.Cm / dt) * u_hist - p.chi * i_ion + i_app
        # rhs directly in the transposed layout: no scatters, no gathers
        r_t = torch.einsum("cqip,cqp,cqp->ip", self.B_t, self.w_t, integrand)
        return r_t.contiguous(), w_np1

    def _bdf2(self, first_step: bool) -> bool:
        return self.cfg.time_stepping_scheme == "BDF2" and not first_step

    def _capture(self, capture, u) -> bool:
        """The step's path (see :meth:`step`)."""
        ok = self.mg is not None and self.mg.graph_ok()
        if capture is None:
            return u.device.type == "cuda" and ok
        if capture and not ok:
            raise ValueError("captured steps need the multigrid path on a "
                             "banded or packed hierarchy")
        return capture

    def step(self, u_n, u_nm1, w, t, first_step: bool,
             capture: bool | None = None):
        """One IMEX BDF step at time ``t`` (a float or a 0-dim tensor);
        returns (u_np1, w_np1, CG iterations).

        On the card the multigrid path runs the step as captured programs
        (``solvers/graphs``; the JAX package's jitted ``step1``/``step2``):
        the gating update, the right-hand side and the CG start as one
        program for the BDF1 step and one for the BDF2 step, then the
        hierarchy's captured CG iteration in a WHILE loop on the device:
        one device program and one host read (the iterations) a step.
        ``capture=False`` runs it eagerly; the block-Jacobi path and the
        CPU always do."""
        cfg = self.cfg
        bdf2 = self._bdf2(first_step)
        if self._capture(capture, u_n):
            g = self._step_graphs()
            g.load(u_n, u_nm1, w, t)
            n = g.loop.run(g.start(bdf2))
            return g.u_next(), g.w_next.clone(), n
        t = torch.as_tensor(t, dtype=torch.float64, device=u_n.device)
        r_t, w_np1 = self._rhs_t(u_n, u_nm1, w, t, bdf2)
        rhs = r_t.T.reshape(-1)
        if self.mg is not None:
            res = self.mg.solve_cg(rhs, rtol=cfg.solver.rtol,
                                   maxiter=cfg.solver.max_iterations,
                                   capture=False)
        else:
            res = cg_solve(self.A.matvec, rhs, M=self.jacobi,
                           rtol=cfg.solver.rtol,
                           maxiter=cfg.solver.max_iterations)
        return res.x, w_np1, res.iterations

    def _step_graphs(self) -> "_StepGraphs":
        if self._graphs is None:
            self._graphs = _StepGraphs(self)
        return self._graphs

    def steps_scan(self, u, u_prev, w, t0, n_steps: int,
                   capture: bool | None = None):
        """``n_steps`` BDF steps from time ``t0`` (the JAX package's
        ``lax.scan`` loop).  Returns (u, u_prev, w, iterations per step).

        Captured (as :meth:`step`): the state stays in the step programs'
        buffers, the time advances on the device (t0 + k dt), and each
        step is one device program launched with no host read between
        steps: the BDF2 start, the CG loop, then a program that stores
        the step's iterations and moves the state on.  The iterations
        per step are read once, at the end."""
        if self._capture(capture, u):
            g = self._step_graphs()
            g.load(u, u_prev, w, t0)
            start, advance = g.scan_programs(n_steps)
            # n_steps launches, then the one host read
            iters = g.loop.launch(start, (advance,), times=n_steps,
                                  per_run=g.iters[:n_steps])
            return (g.u_n.clone(), g.u_nm1.clone(), g.w.clone(), iters)
        dt = self.cfg.dt
        iters = []
        for k in range(n_steps):
            u_new, w, it = self.step(u, u_prev, w, t0 + k * dt, False,
                                     capture=False)
            u_prev, u = u, u_new
            iters.append(it)
        return u, u_prev, w, iters

    def run(self, n_steps=None, callback=None, checkpoint_dir=None,
            checkpoint_every=0, resume=False, capture: bool | None = None):
        """Time loop with optional checkpoint/resume (``checkpoint.py``):
        a checkpoint holds the full BDF2 history (u, u_prev, w), so a
        resumed run replays the uninterrupted one bitwise.  Each step is
        :meth:`step` (``capture`` as there), the callbacks and checkpoints
        on the host between them.  Returns (u, w, iterations per
        step)."""
        cfg = self.cfg
        if n_steps is None:
            n_steps = int(round(cfg.final_time / cfg.dt))
        u, w = self.initial_state()
        u_prev = u
        start = 0
        if (resume and checkpoint_dir is not None
                and latest_step(checkpoint_dir) is not None):
            start, state = restore_checkpoint(checkpoint_dir)
            dev = self.B_t.device
            u, u_prev, w = (torch.as_tensor(state[k], device=dev)
                            for k in ("u", "u_prev", "w"))
        iters = []
        for k in range(start, n_steps):
            t = k * cfg.dt
            u_new, w, it = self.step(u, u_prev, w, t, k == 0,
                                     capture=capture)
            u_prev, u = u, u_new
            iters.append(it)
            if callback is not None and (k + 1) % cfg.output_frequency == 0:
                callback(k + 1, t + cfg.dt, u, w)
            if (checkpoint_dir is not None and checkpoint_every > 0
                    and (k + 1) % checkpoint_every == 0):
                save_checkpoint(checkpoint_dir, k + 1,
                                dict(u=u, u_prev=u_prev, w=w))
        return u, w, iters


class _StepGraphs:
    """The monodomain step as captured programs on static buffers: the
    state (u_n, u_nm1, w), the time t0 + k dt (t0 f64 and k int64 on the
    device), one start program per BDF order (the gating update, the
    right-hand side and ``cg_init`` into the hierarchy's ``CGLoop``, whose
    iteration program the steps share) and, for
    :meth:`MonodomainSolver.steps_scan`, one program that stores the
    step's CG iterations at ``iters[k]`` (a unique index, the step
    counter) and moves the state on by a step, with the device program
    start, CG loop, advance."""

    def __init__(self, solver: "MonodomainSolver"):
        cfg = solver.cfg
        self.solver = solver
        u, w = solver.initial_state()
        self.loop = solver.mg.cg_loop(cfg.solver.rtol,
                                      cfg.solver.max_iterations, u.dtype)
        self.u_n, self.u_nm1, self.w = u, torch.zeros_like(u), w
        self.w_next = torch.zeros_like(w)
        self.t0 = torch.zeros((), dtype=torch.float64, device=u.device)
        self.k = torch.zeros((), dtype=torch.int64, device=u.device)
        self._starts = {}
        self.iters = None  # CG iterations per step of a scan, int32
        self._scan = None  # the advance program

    def load(self, u_n, u_nm1, w, t) -> None:
        self.u_n.copy_(u_n)
        self.u_nm1.copy_(u_nm1)
        self.w.copy_(w)
        if isinstance(t, torch.Tensor):
            self.t0.copy_(t)
        else:
            self.t0.fill_(float(t))
        self.k.zero_()

    def start(self, bdf2: bool):
        if bdf2 not in self._starts:
            s = self.solver

            def rhs():
                t = self.t0 + self.k.to(torch.float64) * s.cfg.dt
                r_t, w_np1 = s._rhs_t(self.u_n, self.u_nm1, self.w, t, bdf2)
                self.w_next.copy_(w_np1)
                return r_t

            self._starts[bdf2] = self.loop.start_program(rhs)
        return self._starts[bdf2]

    def u_next(self) -> torch.Tensor:
        """The CG solution as a new flat vector."""
        return self.loop.state.x.T.clone(
            memory_format=torch.contiguous_format).reshape(-1)

    def scan_programs(self, n_steps: int):
        """(the BDF2 start, the advance program) of a scan of ``n_steps``,
        whose step is the device program start, the CG loop, then
        iters[k] <- the CG's k, u_nm1 <- u_n <- x, w <- w_next, k += 1.
        ``iters`` holds at least ``n_steps`` entries; a longer scan than
        the last makes it anew, with its advance."""
        start = self.start(True)
        if self.iters is None or self.iters.numel() < n_steps:
            nb = self.solver.handler.n_basis
            self.iters = torch.zeros(max(32, n_steps), dtype=torch.int32,
                                     device=self.u_n.device)

            def commit(_):
                self.iters.index_copy_(0, self.k.reshape(1),
                                       self.loop.state.k.reshape(1))
                self.u_nm1.copy_(self.u_n)
                self.u_n.view(-1, nb).copy_(self.loop.state.x.T)
                self.w.copy_(self.w_next)
                self.k.add_(1)

            self._scan = self.loop.add_program(None, commit)
        return start, self._scan


def bench_config(n_refinements: int = 6,
                 n_steps: int = 20) -> MonodomainConfig:
    """``bench.py``'s ``bench_monodomain`` configuration (the reference's
    examples/monodomain_DG3D.cc): 3D, p=1, BDF2 at dt=5e-5 to ``n_steps``
    dt, stimulus 300 until 2 dt within radius 0.2 of the origin, CG to rtol
    1e-8 preconditioned by R3MG with the config's defaults (Chebyshev
    degree 3, 3 sweeps, smoothing range 20; LU coarse solve).  At
    ``n_refinements=6``: 262,144 cells, 1,048,576 DoF."""
    dt = 5e-5
    cfg = MonodomainConfig(
        dim=3, n_refinements=n_refinements, degree=1,
        time_stepping_scheme="BDF2", dt=dt, final_time=n_steps * dt,
        end_time_current=2 * dt, applied_current=300.0,
        stimulus_radius=0.2)
    cfg.solver.rtol = 1e-8
    return cfg


def run_monodomain(cfg: MonodomainConfig | None = None, verbose=True, *,
                   device, dtype=torch.float32, **kw):
    cfg = cfg or MonodomainConfig(**kw)
    solver = MonodomainSolver.build(cfg, dtype=dtype, device=device)

    def cb(step, t, u, w):
        if verbose:
            uq = solver.u_at_quad(u)
            print(f"step {step:5d} t={t:.5f}  max u = {float(uq.max()):.4f}")

    u, w, iters = solver.run(callback=cb)
    return solver, u, w, iters


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dim", type=int, default=2)
    ap.add_argument("--refinements", type=int, default=5)
    ap.add_argument("--degree", type=int, default=1)
    ap.add_argument("--scheme", default="BDF2", choices=("BDF1", "BDF2"))
    ap.add_argument("--dt", type=float, default=1e-4)
    ap.add_argument("--final-time", type=float, default=2e-3)
    ap.add_argument("--preconditioner", default="agglomg",
                    choices=("agglomg", "jacobi"))
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, cpu, ...)")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--prm", type=str, default=None,
                    help="config file in 'a.b = v' format")
    args = ap.parse_args(argv)
    if args.prm:
        from polydeal_tpu_torch.config import from_text

        with open(args.prm) as f:
            cfg = from_text(f.read())
    else:
        cfg = MonodomainConfig(
            dim=args.dim, n_refinements=args.refinements, degree=args.degree,
            time_stepping_scheme=args.scheme, dt=args.dt,
            final_time=args.final_time,
        )
        cfg.multigrid.preconditioner = args.preconditioner
    run_monodomain(cfg, device=torch.device(args.device),
                   dtype=getattr(torch, args.dtype))


if __name__ == "__main__":
    main()
