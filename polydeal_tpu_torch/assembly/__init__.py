from polydeal_tpu_torch.assembly.sipg import (
    assemble_mass_banded_direct,
    assemble_rhs_direct,
    assemble_sipg_banded_direct,
    build_banded_groups,
    default_penalty_constant,
    dirichlet_face_mask,
)

__all__ = [
    "default_penalty_constant",
    "dirichlet_face_mask",
    "build_banded_groups",
    "assemble_rhs_direct",
    "assemble_sipg_banded_direct",
    "assemble_mass_banded_direct",
]
