"""Hand-written CUDA kernels of the port, each beside its plain version."""

from polydeal_tpu_torch.ops.banded import (
    banded_matvec_t_imajor,
    banded_matvec_t_imajor_ref,
    banded_matvec_t_omajor,
    banded_matvec_t_omajor_ref,
)
from polydeal_tpu_torch.ops.fused_cheb import (
    banded_cheb_step_t,
    banded_cheb_step_t_omajor,
    banded_cheb_step_t_omajor_ref,
    banded_cheb_step_t_ref,
    banded_residual_t,
    banded_residual_t_omajor,
    banded_residual_t_omajor_ref,
    banded_residual_t_ref,
    packed_cheb_step_t,
    packed_cheb_step_t_ref,
    packed_residual_t,
    packed_residual_t_ref,
)
from polydeal_tpu_torch.ops.packed import (
    PackPlan,
    build_pack_plan,
    packed_matvec_t,
    packed_matvec_t_ref,
)
from polydeal_tpu_torch.ops.sipg_kernels import (
    boundary_blocks,
    boundary_blocks_ref,
    face_group_blocks,
    face_group_blocks_ref,
    volume_blocks,
    volume_blocks_ref,
)

__all__ = [
    "banded_matvec_t_imajor",
    "banded_matvec_t_imajor_ref",
    "banded_matvec_t_omajor",
    "banded_matvec_t_omajor_ref",
    "banded_cheb_step_t",
    "banded_cheb_step_t_ref",
    "banded_residual_t",
    "banded_residual_t_ref",
    "banded_cheb_step_t_omajor",
    "banded_cheb_step_t_omajor_ref",
    "banded_residual_t_omajor",
    "banded_residual_t_omajor_ref",
    "PackPlan",
    "build_pack_plan",
    "packed_matvec_t",
    "packed_matvec_t_ref",
    "packed_cheb_step_t",
    "packed_cheb_step_t_ref",
    "packed_residual_t",
    "packed_residual_t_ref",
    "volume_blocks",
    "volume_blocks_ref",
    "face_group_blocks",
    "face_group_blocks_ref",
    "boundary_blocks",
    "boundary_blocks_ref",
]
