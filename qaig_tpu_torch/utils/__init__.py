"""Checkpoint I/O and image writing for the port."""
