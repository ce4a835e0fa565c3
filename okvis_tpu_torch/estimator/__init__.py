"""Sliding-window estimator (port of okvis_tpu.estimator): so far the
marginalization math; the Estimator class is not ported yet."""

from .marginalization import MargResult, marginalize_system, pinv_sym  # noqa: F401
