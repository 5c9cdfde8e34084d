"""Brain models: the deterministic linear-regression and CCA models."""
