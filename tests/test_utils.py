"""Auxiliary subsystems: logging, metrics, profiling, checkpoint/resume
(SURVEY.md section 5)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest


def test_utils_package_imports():
    """Regression for round-1 ADVICE: the package advertised modules
    that did not exist, so `import solstice.utils` raised."""
    import solstice.utils as u

    for name in u.__all__:
        assert getattr(u, name) is not None


class TestMetrics:
    def test_jsonl_logging(self, tmp_path):
        from solstice.utils import MetricsLogger

        p = str(tmp_path / "run.jsonl")
        with MetricsLogger(p) as m:
            m.log(rays_per_s=1.5e8, live_occupancy=0.5)
            m.log(step=7, loss=jnp.float32(0.25))
        lines = [json.loads(s) for s in open(p)]
        assert lines[0]["step"] == 0 and lines[0]["rays_per_s"] == 1.5e8
        assert lines[1]["step"] == 7 and lines[1]["loss"] == 0.25

    def test_rays_meter(self):
        from solstice.utils import RaysMeter

        meter = RaysMeter()
        assert meter.tick(1000) is None  # first tick has no interval
        rate = meter.tick(1000)
        assert rate is not None and rate > 0
        assert meter.total_rays == 2000

    def test_grad_norms_and_occupancy(self):
        from solstice.utils.metrics import grad_norms, occupancy

        g = {"a": jnp.ones((4,)), "b": (jnp.zeros((2, 2)),)}
        norms = grad_norms(g)
        assert any(v == 2.0 for v in norms.values())
        assert occupancy(np.array([True, False, True, False])) == 0.5


class TestProfiling:
    def test_render_phase_scopes(self):
        from solstice.utils import render_phase

        @jax.jit
        def f(x):
            with render_phase("traverse"):
                return x * 2.0

        assert float(f(jnp.float32(3.0))) == 6.0

    def test_cost_summary(self):
        from solstice.utils import cost_summary

        def f(a, b):
            return a @ b

        a = jnp.ones((128, 128), jnp.float32)
        # The CPU has no published peaks: pass them explicitly.
        info = cost_summary(f, a, a, peaks=(1e11, 5e10))
        assert info["flops"] > 0
        assert info["roofline_s"] > 0
        assert info["bound"] in ("compute", "memory")

    def test_cost_summary_unknown_device_raises(self):
        from solstice.utils import cost_summary

        a = jnp.ones((8, 8), jnp.float32)
        with pytest.raises(KeyError):
            cost_summary(lambda x: x * 2.0, a, device_kind="cpu")

    def test_h100_peaks_keyed_by_device_kind(self):
        from solstice.utils.profiling import PEAKS

        assert PEAKS["NVIDIA H100 80GB HBM3"] == (67e12, 3.35e12)


class TestCheckpoint:
    def _state(self, it=0):
        from solstice.utils import RenderState

        return RenderState(
            params={"c": jnp.arange(3.0), "r": jnp.float32(2.0)},
            opt_state=(jnp.zeros((3,)),),
            rng_key=jax.random.PRNGKey(it),
            accum=jnp.ones((4, 4, 4)) * it,
            iteration=jnp.int32(it),
        )

    def test_roundtrip(self, tmp_path):
        from solstice.utils import restore_render_state, save_render_state

        s = self._state(3)
        p = str(tmp_path / "ck.npz")
        save_render_state(p, s)
        r = restore_render_state(p, self._state(0))
        assert int(r.iteration) == 3
        np.testing.assert_array_equal(np.asarray(r.accum),
                                      np.asarray(s.accum))
        np.testing.assert_array_equal(np.asarray(r.rng_key),
                                      np.asarray(s.rng_key))

    def test_structure_mismatch_raises(self, tmp_path):
        from solstice.utils import (
            RenderState, restore_render_state, save_render_state,
        )

        p = str(tmp_path / "ck.npz")
        save_render_state(p, self._state(1))
        bad = RenderState(
            params={"c": jnp.arange(3.0)},  # missing "r"
            opt_state=(jnp.zeros((3,)),),
            rng_key=jax.random.PRNGKey(0),
            accum=jnp.ones((4, 4, 4)),
            iteration=jnp.int32(0),
        )
        with pytest.raises(KeyError):
            restore_render_state(p, bad)

    def test_manager_rotation_and_latest(self, tmp_path):
        from solstice.utils import CheckpointManager, latest_step

        mgr = CheckpointManager(str(tmp_path), keep_n=2)
        for step in (1, 5, 9):
            mgr.save(step, self._state(step))
        assert latest_step(str(tmp_path)) == 9
        assert not os.path.exists(mgr.path(1))  # pruned
        restored, step = mgr.restore(self._state(0))
        assert step == 9 and int(restored.iteration) == 9

    def test_manager_empty_dir(self, tmp_path):
        from solstice.utils import CheckpointManager

        mgr = CheckpointManager(str(tmp_path / "fresh"))
        template = self._state(0)
        state, step = mgr.restore(template)
        assert step is None and state is template

    def test_resume_continues_bitwise(self, tmp_path):
        """Interrupted inverse-rendering run resumes bitwise-identically
        (VERDICT round 1 item 7)."""
        from solstice.utils import CheckpointManager, RenderState

        def opt_step(state):
            # Toy gradient step with RNG use, standing in for the real
            # train loop (same pytree mechanics).
            key, sub = jax.random.split(state.rng_key)
            noise = jax.random.normal(sub, state.params["c"].shape)
            c = state.params["c"] - 0.1 * (state.params["c"] + noise)
            return RenderState(
                params={"c": c, "r": state.params["r"]},
                opt_state=state.opt_state,
                rng_key=key,
                accum=state.accum + 1.0,
                iteration=state.iteration + 1,
            )

        s = self._state(0)
        for _ in range(4):
            s = opt_step(s)

        mgr = CheckpointManager(str(tmp_path))
        s2 = self._state(0)
        for i in range(2):
            s2 = opt_step(s2)
        mgr.save(int(s2.iteration), s2)
        resumed, _ = mgr.restore(self._state(0))
        for _ in range(2):
            resumed = opt_step(resumed)
        np.testing.assert_array_equal(
            np.asarray(resumed.params["c"]), np.asarray(s.params["c"])
        )
        np.testing.assert_array_equal(
            np.asarray(resumed.rng_key), np.asarray(s.rng_key)
        )
