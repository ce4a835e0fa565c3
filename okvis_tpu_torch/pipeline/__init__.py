"""The host pipeline (port of okvis_tpu.pipeline, the reference's
okvis_multisensor_processing)."""

from .queues import ShutdownError, ThreadSafeQueue  # noqa: F401
from .synchronizer import FrameSynchronizer, ImuFrameSynchronizer  # noqa: F401
from .threaded_vio import StateEstimate, ThreadedVio  # noqa: F401
