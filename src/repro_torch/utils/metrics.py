"""Thin compatibility shim over ``repro_torch.obs.registry``, as the
reference's ``repro/utils/metrics.py`` is over its ``obs.registry``:
``MetricsLogger`` *is* ``JsonlLogger``.  New code imports from
``repro_torch.obs`` directly.
"""
from __future__ import annotations

from repro_torch.obs.registry import (JsonlLogger as MetricsLogger,
                                      read_metrics, step_time_summary)

__all__ = ["MetricsLogger", "read_metrics", "step_time_summary"]
