"""Datasets and the batch loader (counterpart of ``qaig_tpu/data``)."""
