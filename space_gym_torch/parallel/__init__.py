"""Multi-process scale-out on torch.distributed (mesh, shardings, distributed init)."""
from .distributed import init_distributed, local_lane_slice  # noqa: F401
from .mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    place,
    state_shardings,
    trainer_state_shardings,
)
