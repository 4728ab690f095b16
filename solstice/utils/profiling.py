"""Tracing and roofline profiling (SURVEY.md section 5: the reference
relied on external nvprof/NSight; here they are jax.profiler traces,
jax.named_scope phase annotation, and Compiled.cost_analysis()
rooflines).

* :func:`render_phase` — name a render phase (raygen/cull/traverse/
  shade/compact) so it shows up in profiler timelines and HLO.
* :func:`trace` — context manager around ``jax.profiler.trace`` writing
  a TensorBoard-compatible trace directory.
* :func:`cost_summary` — lower+compile a jitted function and report the
  XLA cost analysis (FLOPs, bytes accessed) plus roofline estimates
  against the card's published peaks (``PEAKS``) or supplied ones.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import jax

__all__ = ["render_phase", "trace", "cost_summary", "PEAKS"]


def render_phase(name: str):
    """Scope a render phase for profiler/HLO attribution.

    Usage::

        with render_phase("traverse"):
            hit = scene_closest_hit(...)
    """
    return jax.named_scope(f"solr/{name}")


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace viewable in TensorBoard/Perfetto."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


# Published peaks per card, keyed by JAX's exact ``device_kind``:
# (float32 FLOP/s outside the tensor cores, device-memory bytes/s).
# Source: NVIDIA H100 data sheet, SXM part, dense, at the 700 W limit.
# A card set below that limit cannot hold these rates; report its
# power limit beside any share of them.
PEAKS = {
    "NVIDIA H100 80GB HBM3": (67e12, 3.35e12),
}


def cost_summary(
    fn,
    *args,
    static_argnames=(),
    peaks: Optional[tuple] = None,
    device_kind: Optional[str] = None,
    **kwargs,
) -> Dict[str, Any]:
    """Compile ``fn(*args, **kwargs)`` and return its XLA cost analysis.

    Returns a dict with ``flops``, ``bytes_accessed``, ``transcendentals``
    (when XLA reports them), plus ``roofline_s`` — the max of compute
    time (flops/peak_flops) and memory time (bytes/peak_bw) — and
    ``bound`` ("compute" or "memory").
    """
    jitted = jax.jit(fn, static_argnames=static_argnames)
    lowered = jitted.lower(*args, **kwargs)
    compiled = lowered.compile()
    raw = compiled.cost_analysis()
    out: Dict[str, Any] = {
        "flops": float(raw.get("flops", 0.0)),
        "bytes_accessed": float(raw.get("bytes accessed", 0.0)),
        "transcendentals": float(raw.get("transcendentals", 0.0)),
    }
    if peaks is None:
        kind = device_kind or jax.devices()[0].device_kind
        if kind not in PEAKS:
            raise KeyError(
                f"no published peaks for device kind {kind!r}: add a row "
                "to PEAKS with its source, or pass peaks="
            )
        peaks = PEAKS[kind]
    peak_flops, peak_bw = peaks
    t_compute = out["flops"] / peak_flops if peak_flops else 0.0
    t_memory = out["bytes_accessed"] / peak_bw if peak_bw else 0.0
    out["roofline_s"] = max(t_compute, t_memory)
    out["bound"] = "compute" if t_compute >= t_memory else "memory"
    out["peak_flops"] = peak_flops
    out["peak_bytes_per_s"] = peak_bw
    return out
