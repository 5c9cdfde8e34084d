"""Cohort sweeps over several processes (port of
telluride_decoding_tpu/parallel, its host half)."""
