"""Sliding-window estimator (port of okvis_tpu.estimator): the Estimator's
host bookkeeping over the port's device programs, and the marginalization
math."""

from .estimator import Estimator, LandmarkRecord, Observation, StateRecord  # noqa: F401
from .marginalization import MargResult, marginalize_system, pinv_sym  # noqa: F401
