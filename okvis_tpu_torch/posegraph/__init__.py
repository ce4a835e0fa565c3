"""Pose-graph / loop-closure layer (port of okvis_tpu.posegraph; the
reference release has none):

- ``graph``: padded host-side pose-graph container (SoA numpy, id<->slot maps)
- ``optimize``: the SE(3) pose-graph solver: analytic per-edge Jacobian
  blocks, fixed-order per-node sums, block-Jacobi PCG or a dense Cholesky,
  Levenberg-Marquardt with accept/reject
- ``place_recognition``: brute-force binary-descriptor keyframe retrieval,
  one Hamming kernel launch a query
- ``loop_closure``: geometric verification (descriptor matching + 3D-2D
  RANSAC) producing a relative-pose loop constraint
- ``manager``: odometry edges, loop detection, optimization, drift
  correction, redundant-keyframe culling
"""

from . import graph, loop_closure, manager, optimize, place_recognition  # noqa: F401
