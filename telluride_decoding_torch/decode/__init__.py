"""Attention decoding: correlation statistics, reductions and LDA."""
