"""FGOP structure used by the registry: stream descriptors (paper
section 4), ordered region dependences and criticality planning."""
