"""FGOP structure used by the registry: stream descriptors and the
paper's control-overhead model (section 4), implicit masks, ordered region
dependences and criticality planning."""
from repro_torch.core.streams import (  # noqa: F401
    StreamDescriptor,
    StreamDim,
    rect,
    inductive,
    command_count,
    commands_per_iteration,
    average_stream_length,
)
from repro_torch.core.masking import (  # noqa: F401
    lane_mask,
    tail_mask,
    tri_mask,
    masked_fill,
    vector_utilization,
)
from repro_torch.core.dependence import (  # noqa: F401
    Region,
    OrderedDep,
    RegionGraph,
    fuse_scan,
)
from repro_torch.core.criticality import (  # noqa: F401
    RegionCost,
    plan_split,
)
