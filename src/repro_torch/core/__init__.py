"""FGOP structure used by the registry: stream descriptors (paper
section 4), implicit masks, ordered region dependences and criticality
planning."""
from repro_torch.core.masking import (  # noqa: F401
    lane_mask,
    tail_mask,
    tri_mask,
    masked_fill,
    vector_utilization,
)
