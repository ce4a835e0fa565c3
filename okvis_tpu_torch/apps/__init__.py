"""Command-line applications (port of okvis_tpu.apps): the EuRoC driver and
its sweep over the benchmark's sequences."""
