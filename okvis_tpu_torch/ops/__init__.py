"""Matching ops and the hand-written CUDA kernels (port of okvis_tpu.ops)."""
