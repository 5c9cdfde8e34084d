"""Deterministic solvers: CCA and scaled LDA."""
