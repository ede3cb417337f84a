"""FGOP stream descriptors (paper section 4) used by the registry specs."""
