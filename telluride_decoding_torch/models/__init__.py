"""Brain models; only the deterministic CCA model is ported so far."""
