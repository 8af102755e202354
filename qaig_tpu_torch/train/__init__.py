"""Checkpoint loaders shared with the (later) training slices."""
