"""Hand-written CUDA kernels of the port, each beside its plain version."""

from polydeal_tpu_torch.ops.banded import (
    banded_matvec_t_imajor,
    banded_matvec_t_imajor_ref,
)
from polydeal_tpu_torch.ops.fused_cheb import (
    banded_cheb_step_t,
    banded_cheb_step_t_ref,
    banded_residual_t,
    banded_residual_t_ref,
)

__all__ = [
    "banded_matvec_t_imajor",
    "banded_matvec_t_imajor_ref",
    "banded_cheb_step_t",
    "banded_cheb_step_t_ref",
    "banded_residual_t",
    "banded_residual_t_ref",
]
