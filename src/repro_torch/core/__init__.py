"""DEVFT — the paper's contribution: developmental stages, DGLG grouping,
DBLF fusion, cross-stage knowledge transfer."""
from repro_torch.core.devft import DevFTController, Submodel, build_submodel  # noqa: F401
from repro_torch.core.fusion import fuse_stack, layer_add, layer_sub  # noqa: F401
from repro_torch.core.grouping import (  # noqa: F401
    even_grouping,
    layer_vectors,
    make_groups,
    random_grouping,
    similarity_matrix,
    spectral_grouping,
)
from repro_torch.core.stages import (  # noqa: F401
    StageSchedule,
    allocate_stack_capacities,
    capacity_schedule,
    make_schedule,
)
from repro_torch.core.transfer import broadcast_lora, transfer_stage  # noqa: F401
