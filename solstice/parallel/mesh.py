"""Device-mesh construction.

The renderer's parallel axis is rays/tiles ("tiles"); scenes are
replicated.  On several hosts the same axis spans hosts x cards, which
is the right layout because there is NO inter-tile communication in the
forward pass (rays are independent) and only one psum/reduce-scatter of
scene-parameter grads per step in the backward.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_mesh", "make_host_chip_mesh", "device_count",
           "HOST_AXIS", "CHIP_AXIS"]

TILE_AXIS = "tiles"
HOST_AXIS = "host"
CHIP_AXIS = "chip"


def device_count() -> int:
    return len(jax.devices())


def make_mesh(
    n_devices: Optional[int] = None,
    axis_name: str = TILE_AXIS,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """1-D mesh over all (or the first n) devices.

    A renderer needs a single sharding axis; host/card hierarchy is
    handled by device order (jax.devices() enumerates the cards of
    process 0 first, so contiguous tile blocks stay host-local and the
    image gather crosses hosts only once).
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def make_host_chip_mesh(
    n_hosts: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """2-D ('host', 'chip') mesh: the multi-host layout.

    Rows group the cards of one process (host); tile sharding over BOTH
    axes (``P((HOST_AXIS, CHIP_AXIS))``) keeps contiguous tile blocks
    host-local — the forward pass has no cross-tile traffic, so only the
    per-step gradient reduce-scatter and the final image gather cross
    hosts.

    ``n_hosts`` overrides process grouping for single-process testing
    (e.g. 8 virtual CPU devices as 2 hosts x 4 chips).
    """
    if devices is None:
        devices = jax.devices()
    devices = list(devices)
    if n_hosts is None:
        n_hosts = max(d.process_index for d in devices) + 1
    if len(devices) % n_hosts:
        raise ValueError(
            f"{len(devices)} devices do not split into {n_hosts} hosts"
        )
    per_host = len(devices) // n_hosts
    if max(d.process_index for d in devices) > 0:
        # Real multi-process: order by (process, local id).
        devices = sorted(devices, key=lambda d: (d.process_index, d.id))
    grid = np.asarray(devices).reshape(n_hosts, per_host)
    return Mesh(grid, (HOST_AXIS, CHIP_AXIS))
