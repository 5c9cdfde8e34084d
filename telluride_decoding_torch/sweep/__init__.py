"""Jackknife x regularization sweeps from per-file moments (port of
telluride_decoding_tpu/sweep)."""

from telluride_decoding_torch.sweep.engine import (
    ContextSpec,
    SweepResult,
    cca_jackknife_sweep,
    cohort_summary,
    default_mesh,
    multi_subject_sweep,
    pad_and_stack,
    per_file_stats,
    ridge_jackknife_sweep,
)
from telluride_decoding_torch.sweep.checkpoint import (
    SweepCheckpoint,
    run_sweep_with_checkpoints,
)
