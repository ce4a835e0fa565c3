"""Trajectory evaluation (port of okvis_tpu.eval)."""
