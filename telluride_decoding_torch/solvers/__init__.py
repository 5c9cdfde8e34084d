"""Deterministic solvers: ridge, CCA and scaled LDA."""
