"""Data assembly: the device part of per-file moment accumulation."""
