from polydeal_tpu_torch.mesh.fine_mesh import (
    FineMesh,
    distort_random,
    hyper_cube,
    hyper_rectangle,
)

__all__ = ["FineMesh", "hyper_cube", "hyper_rectangle", "distort_random"]
