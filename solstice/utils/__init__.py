"""Auxiliary subsystems: logging, metrics, profiling, checkpoint/resume.

Equivalents of the reference's observability surface
(solr/Logging.h LOG_INFO/LOG_WARNING/LOG_ERROR macros; the viewer FPS
counter) plus the subsystems the reference lacks but a production
renderer needs (SURVEY.md section 5): structured per-step metrics,
jax.profiler integration, and Orbax-backed checkpoint/resume of long
renders and inverse-rendering optimizations.
"""

from solstice.utils.logging import get_logger, log_error, log_info, log_warning, set_verbosity
from solstice.utils.metrics import MetricsLogger, RaysMeter
from solstice.utils.profiling import cost_summary, render_phase, trace
from solstice.utils.checkpoint import (
    CheckpointManager,
    RenderState,
    latest_step,
    restore_render_state,
    save_render_state,
)

__all__ = [
    "CheckpointManager",
    "MetricsLogger",
    "RaysMeter",
    "RenderState",
    "cost_summary",
    "get_logger",
    "latest_step",
    "log_error",
    "log_info",
    "log_warning",
    "render_phase",
    "restore_render_state",
    "save_render_state",
    "set_verbosity",
    "trace",
]
