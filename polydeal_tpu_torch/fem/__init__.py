from polydeal_tpu_torch.fem.basis import LegendreDGP, TensorDGQ, make_basis
from polydeal_tpu_torch.fem.quadrature import (
    face_quadrature,
    gauss_legendre_1d,
    tensor_gauss,
)

__all__ = ["gauss_legendre_1d", "tensor_gauss", "face_quadrature",
           "LegendreDGP", "TensorDGQ", "make_basis"]
