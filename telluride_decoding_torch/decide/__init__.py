"""Attention decision rules."""
