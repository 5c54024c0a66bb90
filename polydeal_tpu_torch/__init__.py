"""polydeal_tpu_torch — the PyTorch + CUDA port of polydeal_tpu.

A second package beside the JAX one (which stays the reference).  It
mirrors that package's module paths and names, imports torch, numpy and
scipy and never jax, and threads an explicit ``device`` from each entry
point.  Host setup (mesh, R-tree, handler, quadrature) is a jax-free copy
of the JAX package's numpy code; the device path is torch, and each TPU
kernel on the ported path is a hand-written CUDA kernel (``ops/``,
``csrc/``) beside its plain PyTorch version.

Ported so far: the flagship R3MG Poisson solve (``models/flagship.py``),
the monodomain, the sharded solve, and the general block-COO path with
the scalar models (``models/poisson.py``, ``models/diffusion_reaction.py``).
"""

__version__ = "0.1.0"

from polydeal_tpu_torch.fem.basis import LegendreDGP, TensorDGQ, make_basis
from polydeal_tpu_torch.fem.quadrature import gauss_legendre_1d, tensor_gauss
from polydeal_tpu_torch.handler import AgglomerationHandler
from polydeal_tpu_torch.mesh.fine_mesh import (
    FineMesh,
    distort_random,
    hyper_cube,
)

__all__ = [
    "gauss_legendre_1d",
    "tensor_gauss",
    "LegendreDGP",
    "TensorDGQ",
    "make_basis",
    "FineMesh",
    "hyper_cube",
    "distort_random",
    "AgglomerationHandler",
]
