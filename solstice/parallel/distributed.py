"""Multi-host process bring-up (SURVEY.md section 5 "distributed
communication backend": the reference is single-device with no comm
layer; here the backend is jax.distributed + XLA collectives, which XLA
hands to NCCL on GPUs).

``initialize_distributed`` wires ``jax.distributed.initialize`` from
arguments or the SOLR_COORDINATOR / SOLR_NUM_PROCESSES /
SOLR_PROCESS_ID environment, with bounded retry — coordinator races at
bring-up are the usual multi-host flake.  Nothing is auto-detected:
without a coordinator the launch is single-process.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import jax

__all__ = ["initialize_distributed", "is_distributed", "process_info"]

_INITIALIZED = False


def is_distributed() -> bool:
    return jax.process_count() > 1


def process_info() -> dict:
    """Identity of this process in the job (for logs/metrics)."""
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    retries: int = 3,
    retry_wait_s: float = 5.0,
) -> dict:
    """Initialize the multi-host runtime; safe to call on single host.

    Resolution order per field: explicit argument > SOLR_COORDINATOR /
    SOLR_NUM_PROCESSES / SOLR_PROCESS_ID environment.  A single-process
    launch (no coordinator given) is a no-op, so the same entry point
    serves laptop, 1-host, and N-host runs.

    Returns :func:`process_info` after bring-up.
    """
    global _INITIALIZED
    if _INITIALIZED:
        return process_info()

    coordinator_address = coordinator_address or os.environ.get(
        "SOLR_COORDINATOR"
    )
    env_np = os.environ.get("SOLR_NUM_PROCESSES")
    env_pid = os.environ.get("SOLR_PROCESS_ID")
    if num_processes is None and env_np is not None:
        num_processes = int(env_np)
    if process_id is None and env_pid is not None:
        process_id = int(env_pid)

    if coordinator_address is None:
        return process_info()  # single-process launch

    from solstice.utils.logging import log_info, log_warning

    last = None
    for attempt in range(retries):
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
            )
            _INITIALIZED = True
            info = process_info()
            log_info(1, "distributed up: %s", info)
            return info
        except Exception as e:  # coordinator race / transient RPC
            last = e
            log_warning(
                "jax.distributed.initialize failed (attempt %d/%d): %s",
                attempt + 1, retries, e,
            )
            time.sleep(retry_wait_s * (attempt + 1))
    raise RuntimeError(
        f"multi-host bring-up failed after {retries} attempts"
    ) from last
