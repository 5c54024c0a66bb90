"""Configuration layer — the ParameterAcceptor/.prm analogue.

The reference drives its monodomain application through a deal.II
ParameterHandler `.prm` file with ~50 parameters
(reference examples/monodomain_DG3D.cc:161-341,
examples/parameters_monodomain.prm).  Here the same axes are plain frozen
dataclasses with (de)serialization to a flat ``section.key = value`` text
format, so existing .prm-style workflows translate directly.

Port note: a copy of ``polydeal_tpu/config.py``.  That module holds no jax,
but importing it loads ``polydeal_tpu/__init__.py``, which imports jax, so
the port carries its own; tests/test_torch_host.py holds the two equal.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields

__all__ = ["SolverConfig", "MultigridConfig", "BuenoOrovioParams",
           "MonodomainConfig", "to_text", "from_text"]


@dataclass
class SolverConfig:
    """Outer Krylov solve (reference SolverControl)."""

    rtol: float = 1e-8
    atol: float = 0.0
    max_iterations: int = 1000


@dataclass
class MultigridConfig:
    """R3MG preconditioner knobs (reference monodomain_DG3D.cc:180-186)."""

    preconditioner: str = "agglomg"  # 'agglomg' (R3MG) | 'jacobi' | 'none'
    starting_level: int = 1
    chebyshev_degree: int = 3
    n_smoothing_steps: int = 3
    smoothing_range: float = 20.0
    mode: str = "direct"  # 'direct' | 'galerkin'


@dataclass
class BuenoOrovioParams:
    """Bueno-Orovio minimal ventricular model constants — same names and
    defaults as the reference (monodomain_DG3D.cc:188-218)."""

    chi: float = 1.0
    Cm: float = 1.0
    sigma: float = 1e-4
    V1: float = 0.3
    V1m: float = 0.015
    V2: float = 0.015
    V2m: float = 0.03
    V3: float = 0.9087
    Vhat: float = 1.58
    Vo: float = 0.006
    Vso: float = 0.65
    tauop: float = 6e-3
    tauopp: float = 6e-3
    tausop: float = 43e-3
    tausopp: float = 0.2e-3
    tausi: float = 2.8723e-3
    taufi: float = 0.11e-3
    tau1plus: float = 1.4506e-3
    tau2plus: float = 0.28
    tau2inf: float = 0.07
    tau1p: float = 0.06
    tau1pp: float = 1.15
    tau2p: float = 0.07
    tau2pp: float = 0.02
    tau3p: float = 2.7342e-3
    tau3pp: float = 0.003
    w_star_inf: float = 0.94
    k2: float = 65.0
    k3: float = 2.0994
    kso: float = 2.0


@dataclass
class MonodomainConfig:
    """Full monodomain run configuration (the .prm surface)."""

    dim: int = 2
    n_refinements: int = 5  # fine grid = 2^n per direction
    degree: int = 1
    time_stepping_scheme: str = "BDF2"  # 'BDF1' | 'BDF2'
    dt: float = 1e-4
    final_time: float = 2e-3
    end_time_current: float = 2e-3
    applied_current: float = 300.0
    stimulus_radius: float = 0.1
    output_frequency: int = 10
    ionic: BuenoOrovioParams = field(default_factory=BuenoOrovioParams)
    solver: SolverConfig = field(default_factory=SolverConfig)
    multigrid: MultigridConfig = field(default_factory=MultigridConfig)


def to_text(cfg, prefix: str = "") -> str:
    """Serialize a (nested) dataclass config to 'a.b = v' lines."""
    lines = []
    for f in fields(cfg):
        v = getattr(cfg, f.name)
        key = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(v):
            lines.append(to_text(v, prefix=key + "."))
        else:
            lines.append(f"{key} = {v!r}")
    return "\n".join(lines)


def from_text(text: str, cls=MonodomainConfig):
    """Parse 'a.b = v' lines back into a config dataclass."""
    import ast

    cfg = cls()
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        key, _, val = line.partition("=")
        parts = key.strip().split(".")
        obj = cfg
        for p in parts[:-1]:
            obj = getattr(obj, p)
        cur = getattr(obj, parts[-1])
        if dataclasses.is_dataclass(cur):
            raise ValueError(f"cannot assign scalar to section {key}")
        setattr(obj, parts[-1], ast.literal_eval(val.strip()))
    return cfg
