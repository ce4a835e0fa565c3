"""Datasets (port of okvis_tpu.datasets): the synthetic world."""
