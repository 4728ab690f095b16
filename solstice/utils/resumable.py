"""Resumable tile-granular rendering + the failure-detection contract
(SURVEY.md section 5 "failure detection / elastic recovery": long
multi-host renders must be resumable at tile granularity; fault
injection = kill-one-host in the scaling harness; VERDICT r03 missing
#5).

Design: a frame renders as ROW-BAND CHUNKS.  After every chunk the
partial accumulation buffer and the next-chunk index checkpoint through
:class:`solstice.utils.checkpoint.CheckpointManager` (atomic rotating
writes), and a heartbeat file is touched.  A killed worker therefore
loses at most one chunk of work; the supervisor (tools/fault_injection.
py) detects the stalled heartbeat and relaunches the worker, which
resumes from its newest checkpoint.  Determinism: with a fixed key the
resumed render is bit-identical to an uninterrupted one (asserted by
tests/test_fault_injection.py), because each chunk's rays depend only
on (camera, cfg, chunk row range) — never on wall-clock or prior
chunks.

The row-band shape is deliberately the same unit the data-parallel
path shards over (solstice.parallel.render: contiguous row blocks), so
"host i renders rows [i*H/N, (i+1)*H/N)" and "host i checkpoints its
band chunk-by-chunk" compose: a multi-host render is N independent
resumable bands plus one final gather, and killing one host never
invalidates another host's progress.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from solstice.utils.checkpoint import CheckpointManager, RenderState

__all__ = ["resumable_render", "touch_heartbeat", "heartbeat_age"]


def _fingerprint(scene, camera, cfg, row0: int, n_rows: int) -> str:
    """Content hash of everything a chunk's pixels depend on.

    A checkpoint dir left over from a previous render of a DIFFERENT
    (scene, camera, cfg, row range) must not be resumed — restoring
    iteration == n_chunks would silently return the stale image without
    rendering anything (ADVICE r04 medium #1).  Large leaves hash a
    64 KB prefix plus their float sum: cheap at 1M tris, and any edit
    that changes geometry/materials/camera perturbs one or the other.
    """
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    h.update(repr(cfg).encode())
    h.update(f"rows:{row0}:{n_rows}".encode())
    for leaf in jax.tree_util.tree_leaves((scene, camera)):
        a = np.asarray(leaf)
        h.update(str((a.shape, a.dtype.str)).encode())
        b = a.tobytes()
        h.update(b[:65536])
        if a.size and np.issubdtype(a.dtype, np.number):
            h.update(np.asarray(a, np.float64).sum().tobytes())
    return h.hexdigest()


def touch_heartbeat(path: str) -> None:
    with open(path, "w") as f:
        f.write(str(time.time()))


def heartbeat_age(path: str) -> Optional[float]:
    """Seconds since the worker last made progress; None = no beat yet."""
    try:
        return time.time() - os.path.getmtime(path)
    except OSError:
        return None


@functools.partial(jax.jit, static_argnames=("cfg", "n_rows"))
def _render_rows(scene, camera, cfg, row0, n_rows, key):
    """Rays for rows [row0, row0 + n_rows) of the frame, traced through
    the SAME tiled packet path the full-frame renderer uses."""
    from solstice.ops.camera import camera_rays
    from solstice.ops.render import trace_rays_tiled

    o, d = camera_rays(camera, cfg, key)

    def band(a):
        return jax.lax.dynamic_slice_in_dim(
            a, row0 * cfg.width, n_rows * cfg.width
        )

    color, t = trace_rays_tiled(scene, band(o), band(d), cfg, key)
    return (
        color.reshape(n_rows, cfg.width, 4),
        t.reshape(n_rows, cfg.width),
    )


def resumable_render(
    scene,
    camera,
    cfg,
    directory: str,
    rows_per_chunk: int = 32,
    key=None,
    row0: int = 0,
    n_rows: Optional[int] = None,
    heartbeat: Optional[str] = None,
    chunk_sleep_s: float = 0.0,
    log=None,
    cleanup: bool = False,
):
    """Render rows [row0, row0 + n_rows) in checkpointed chunks.

    Returns (image (n_rows, W, 4), depth (n_rows, W)).  On entry the
    newest checkpoint in ``directory`` (if any) restores the partial
    accumulation and the render continues from the first incomplete
    chunk — kill the process at ANY point and a relaunch produces the
    identical image.  ``chunk_sleep_s`` artificially slows chunks so
    fault-injection tests can kill mid-frame deterministically.

    A ``fingerprint`` sidecar records a hash of (scene, camera, cfg,
    row range); a directory whose fingerprint mismatches is stale (the
    inputs changed since the interrupted render) and is restarted from
    scratch instead of silently returning the old image (ADVICE r04
    medium #1).  ``cleanup=True`` removes the checkpoint directory
    after the frame completes — for auto-derived directories the caller
    never asked to keep.
    """
    h = cfg.height if n_rows is None else n_rows
    if h % rows_per_chunk:
        raise ValueError(f"{h} rows not divisible by {rows_per_chunk}")
    n_chunks = h // rows_per_chunk
    fp = _fingerprint(scene, camera, cfg, row0, h)
    fp_path = os.path.join(directory, "fingerprint")
    try:
        with open(fp_path) as f:
            stale = f.read().strip() != fp
    except OSError:
        stale = False
    if stale:
        import shutil

        if log:
            log(event="stale_checkpoint_discarded", directory=directory)
        shutil.rmtree(directory, ignore_errors=True)
    ckpt = CheckpointManager(directory, keep_n=2)
    os.makedirs(directory, exist_ok=True)
    with open(fp_path, "w") as f:
        f.write(fp)
    # RenderState.params is a generic pytree slot; the depth buffer
    # rides there so DoF post-fx stays correct across a resume.
    template = RenderState(
        params=jnp.zeros((h, cfg.width), jnp.float32),  # depth
        opt_state=None,
        rng_key=(jax.random.PRNGKey(0) if key is None else key),
        accum=jnp.zeros((h, cfg.width, 4), jnp.float32),
        iteration=jnp.int32(0),
    )
    state, at = ckpt.restore(template)
    start_chunk = int(state.iteration)
    accum = state.accum
    depth = state.params
    if log and at is not None:
        log(event="resumed", from_chunk=start_chunk)

    for c in range(n_chunks):
        r0 = c * rows_per_chunk
        if c < start_chunk:
            continue  # completed before a restart; color+depth restored
        # The caller's key (None = deterministic camera rays) is used
        # directly; the checkpoint's rng_key slot just records it so a
        # resumed process can assert it passed the same one.
        band_img, band_t = _render_rows(
            scene, camera, cfg, row0 + r0, rows_per_chunk, key,
        )
        accum = jax.lax.dynamic_update_slice_in_dim(accum, band_img, r0, 0)
        depth = jax.lax.dynamic_update_slice_in_dim(depth, band_t, r0, 0)
        accum.block_until_ready()
        ckpt.save(c + 1, RenderState(
            params=depth, opt_state=None, rng_key=template.rng_key,
            accum=accum, iteration=jnp.int32(c + 1),
        ))
        if heartbeat:
            touch_heartbeat(heartbeat)
        if log:
            log(event="chunk_done", chunk=c, rows=rows_per_chunk)
        if chunk_sleep_s:
            time.sleep(chunk_sleep_s)
    if cleanup:
        import shutil

        shutil.rmtree(directory, ignore_errors=True)
    return accum, depth
