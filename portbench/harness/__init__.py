"""The drivers of each kind of cell and what they share."""
