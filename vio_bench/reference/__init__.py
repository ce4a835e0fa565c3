"""The plain reference the benchmark holds the port's outputs to.

Plain PyTorch and NumPy; it imports neither JAX nor the port. It works again
from the images and IMU readings that `vio_bench/world.py` made and handed to
both sides: `detect` (Harris keypoints and BRISK descriptors), `hamming`
(distance matrices), `geometry` (ATE and the optimized window against the
rendered truth).
"""
