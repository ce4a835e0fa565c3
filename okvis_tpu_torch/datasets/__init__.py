"""Datasets (port of okvis_tpu.datasets): the EuRoC ASL loader, PNG reading
and writing, and the synthetic world."""
