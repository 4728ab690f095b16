"""Checkpoint / resume for long renders and inverse-rendering runs
(SURVEY.md section 5: the reference checkpoints only the *scene* via the
IRT FileMarshaller and loses the progressive accumulation buffer on
every camera move; training state did not exist there at all).

This module persists the full optimization/render state:

* scene parameters (the north-star gradient targets),
* optimizer state (any optax state pytree),
* the RNG key,
* the progressive accumulation buffer + iteration counter,

as a single ``.npz`` per step — arrays keyed by pytree path, restored
into a caller-supplied template (same treedef), so no pickled code ever
executes on load.  :class:`CheckpointManager` adds rotating retention
and atomic writes so an interrupted save never corrupts the latest
checkpoint.  Scene GEOMETRY persistence stays in solstice.io.irt; this
is the training-state side.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Dict, Optional

import jax
import numpy as np

from solstice.types import pytree_dataclass

__all__ = [
    "RenderState",
    "save_render_state",
    "restore_render_state",
    "latest_step",
    "CheckpointManager",
]


@pytree_dataclass
class RenderState:
    """Resumable state of a progressive render / optimization run."""

    params: Any  # scene.params pytree (or any parameter pytree)
    opt_state: Any  # optax state pytree (or None)
    rng_key: Any  # jax PRNG key
    accum: Any  # (H, W, 4) progressive accumulation buffer (or None)
    iteration: Any  # () int32 progressive/optimizer step


def _flatten(tree) -> Dict[str, np.ndarray]:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    out = {}
    for path, leaf in flat:
        key = jax.tree_util.keystr(path)
        out[key] = np.asarray(leaf)
    return out


def save_render_state(path: str, state: RenderState) -> str:
    """Atomically write ``state`` to ``path`` (.npz)."""
    arrays = _flatten(state)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def restore_render_state(path: str, template: RenderState) -> RenderState:
    """Load a checkpoint into the structure of ``template``.

    The template supplies the treedef (and target dtypes/sharding via
    jnp.asarray); every leaf present in the file must match a template
    path and vice versa — a mismatch raises rather than silently
    resuming with stale defaults.
    """
    import jax.numpy as jnp

    with np.load(path) as data:
        stored = {k: data[k] for k in data.files}
    flat, treedef = jax.tree_util.tree_flatten_with_path(template)
    leaves = []
    seen = set()
    for p, leaf in flat:
        key = jax.tree_util.keystr(p)
        if key not in stored:
            raise KeyError(f"checkpoint {path!r} is missing leaf {key!r}")
        seen.add(key)
        leaves.append(jnp.asarray(stored[key], dtype=np.asarray(leaf).dtype))
    extra = set(stored) - seen
    if extra:
        raise KeyError(
            f"checkpoint {path!r} has leaves not in the template: "
            f"{sorted(extra)[:5]}"
        )
    return jax.tree_util.tree_unflatten(treedef, leaves)


_CKPT_RE = re.compile(r"^ckpt_(\d+)\.npz$")


def latest_step(directory: str) -> Optional[int]:
    """Highest step with a complete checkpoint in ``directory``."""
    if not os.path.isdir(directory):
        return None
    steps = [
        int(m.group(1))
        for f in os.listdir(directory)
        if (m := _CKPT_RE.match(f))
    ]
    return max(steps) if steps else None


class CheckpointManager:
    """Rotating checkpoint directory (reference analog: none — the IRT
    path saves a single scene file; here long runs keep the newest
    ``keep_n`` training states and resume from the latest)."""

    def __init__(self, directory: str, keep_n: int = 3):
        self.directory = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.npz")

    def save(self, step: int, state: RenderState) -> str:
        p = save_render_state(self.path(step), state)
        self._prune()
        return p

    def restore(self, template: RenderState, step: Optional[int] = None):
        """Returns (state, step) for ``step`` or the latest; (template,
        None) when the directory holds no checkpoint yet."""
        if step is None:
            step = latest_step(self.directory)
        if step is None:
            return template, None
        return restore_render_state(self.path(step), template), step

    def _prune(self) -> None:
        steps = sorted(
            int(m.group(1))
            for f in os.listdir(self.directory)
            if (m := _CKPT_RE.match(f))
        )
        for s in steps[: -self.keep_n]:
            try:
                os.unlink(self.path(s))
            except OSError:
                pass
