from polydeal_tpu_torch.mesh.fine_mesh import (
    FineMesh,
    distort_random,
    hyper_cube,
    hyper_rectangle,
)
from polydeal_tpu_torch.mesh.simplex import (
    SimplexMesh,
    triangulated_hyper_cube,
)

__all__ = ["FineMesh", "hyper_cube", "hyper_rectangle", "distort_random",
           "SimplexMesh", "triangulated_hyper_cube"]
