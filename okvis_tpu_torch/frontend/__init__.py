"""Vision frontend (port of okvis_tpu.frontend): detection, BRISK description,
stereo matching and triangulation."""
