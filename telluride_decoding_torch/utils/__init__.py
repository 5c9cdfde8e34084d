"""Host helpers: stage timing, device traces and TensorBoard events."""
