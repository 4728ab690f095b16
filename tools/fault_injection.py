#!/usr/bin/env python
"""Kill-one-host fault-injection harness (SURVEY.md section 5 failure
detection; VERDICT r03 missing #5 / next-round item 6).

Topology: N "hosts" render one frame as N contiguous row bands (the
same unit the data-parallel path shards — solstice.parallel.render),
each band resumable at chunk granularity (solstice.utils.resumable).
The supervisor:

  1. launches one worker process per host;
  2. SIGKILLs one worker mid-frame (after its first heartbeat);
  3. detects the stalled heartbeat (failure detection),
     relaunches the worker (elastic recovery), which resumes from its
     newest checkpoint — completed chunks are NEVER re-rendered;
  4. gathers the bands and asserts the killed-and-recovered frame is
     BIT-IDENTICAL to an uninterrupted reference render.

Run standalone:   python tools/fault_injection.py
As a harness check it runs UNCONDITIONALLY inside bench_scaling.py
(opt out with SOLR_SCALING_NO_FAULT=1) and in
tests/test_fault_injection.py.

Exit code 0 and one JSON line on success.
"""

import json
import os
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# The harness runs on the CPU: its workers must never contend for a
# card.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

WIDTH = int(os.environ.get("SOLR_FAULT_RES", 64))
HEIGHT = WIDTH
N_HOSTS = 2
ROWS_PER_CHUNK = 8


def _build():
    import solstice as st

    b = st.SceneBuilder()
    m = b.add_material(color=(0.7, 0.4, 0.2, 1.0), specular=0.3)
    mirror = b.add_material(color=(0.9, 0.9, 0.9, 1.0), reflection=0.5)
    floor = b.add_material(color=(0.5, 0.5, 0.55, 1.0))
    b.add_plane(st.types.PlaneAxis.XZ, (0.0, -1.0, 0.0), (10.0, 10.0),
                floor)
    for i in range(5):
        b.add_sphere((i - 2.0, 0.0, 2.0 + (i % 2)), 0.5,
                     m if i % 2 else mirror)
    b.add_light((0.0, 6.0, -2.0), intensity=1.0)
    scene = b.build()
    cam = st.Camera.create(position=(0.0, 0.8, -4.0),
                           angles=(0.15, 0.0, 0.0), fov=1.0)
    cfg = st.RenderConfig(width=WIDTH, height=HEIGHT, max_bounces=2)
    return scene, cam, cfg


def worker(host_id: int, workdir: str, slow: bool):
    """One 'host': render rows [host_id * H/N, ...) resumably."""
    import numpy as np

    from solstice.utils.resumable import resumable_render

    scene, cam, cfg = _build()
    band = HEIGHT // N_HOSTS
    hb = os.path.join(workdir, f"heartbeat_{host_id}")
    ckdir = os.path.join(workdir, f"ckpt_host{host_id}")
    img, _depth = resumable_render(
        scene, cam, cfg, ckdir,
        rows_per_chunk=ROWS_PER_CHUNK,
        row0=host_id * band, n_rows=band,
        heartbeat=hb,
        chunk_sleep_s=0.4 if slow else 0.0,
    )
    np.save(os.path.join(workdir, f"band_{host_id}.npy"),
            np.asarray(img))


def supervise(workdir: str, kill_host: int = 1, stall_timeout: float = 6.0):
    """Launch N_HOSTS workers, kill one mid-frame, detect the stall,
    relaunch, verify.  Returns the result dict."""
    import numpy as np

    os.makedirs(workdir, exist_ok=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu", SOLR_FAULT_RES=str(WIDTH))

    def launch(h, slow):
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             str(h), workdir] + (["--slow"] if slow else []),
            env=env,
        )

    # Reference frame: uninterrupted run in a separate directory.
    refdir = os.path.join(workdir, "ref")
    os.makedirs(refdir, exist_ok=True)
    ref_procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             str(h), refdir],
            env=env,
        )
        for h in range(N_HOSTS)
    ]
    for p in ref_procs:
        assert p.wait(timeout=300) == 0

    # Fault run: kill one slow worker after its first heartbeat.
    procs = {h: launch(h, slow=(h == kill_host)) for h in range(N_HOSTS)}
    hb = os.path.join(workdir, f"heartbeat_{kill_host}")
    t0 = time.time()
    while not os.path.exists(hb):
        if time.time() - t0 > 120:
            raise RuntimeError("worker never heartbeat")
        time.sleep(0.1)
    time.sleep(0.6)  # let it get mid-chunk
    procs[kill_host].send_signal(signal.SIGKILL)
    procs[kill_host].wait()
    kill_t = time.time()

    # Failure detection: the heartbeat stops advancing.
    from solstice.utils.resumable import heartbeat_age

    while True:
        age = heartbeat_age(hb)
        if age is not None and age > stall_timeout * 0.5:
            break
        if time.time() - kill_t > 60:
            raise RuntimeError("stall never detected")
        time.sleep(0.2)
    detect_s = time.time() - kill_t

    from solstice.utils.checkpoint import latest_step

    resumed_from = latest_step(
        os.path.join(workdir, f"ckpt_host{kill_host}")
    ) or 0

    # Elastic recovery: relaunch the dead host (fast this time).
    procs[kill_host] = launch(kill_host, slow=False)
    for h, p in procs.items():
        assert p.wait(timeout=300) == 0, f"host {h} failed"

    bands = [
        np.load(os.path.join(workdir, f"band_{h}.npy"))
        for h in range(N_HOSTS)
    ]
    ref = [
        np.load(os.path.join(refdir, f"band_{h}.npy"))
        for h in range(N_HOSTS)
    ]
    fault_img = np.concatenate(bands)
    ref_img = np.concatenate(ref)
    identical = bool(np.array_equal(fault_img, ref_img))
    n_chunks = (HEIGHT // N_HOSTS) // ROWS_PER_CHUNK
    result = {
        "fault_injection_ok": identical,
        "killed_host": kill_host,
        "detect_s": round(detect_s, 2),
        "resumed_from_chunk": int(resumed_from),
        "chunks_per_host": n_chunks,
        "work_preserved": bool(0 < resumed_from),
        "bit_identical_to_uninterrupted": identical,
    }
    if not identical:
        result["max_abs_diff"] = float(np.abs(fault_img - ref_img).max())
    return result


def main():
    if "--worker" in sys.argv:
        i = sys.argv.index("--worker")
        worker(int(sys.argv[i + 1]), sys.argv[i + 2],
               slow="--slow" in sys.argv)
        return
    import tempfile

    workdir = tempfile.mkdtemp(prefix="solr_fault_")
    result = supervise(workdir)
    print(json.dumps(result))
    if not result["fault_injection_ok"] or not result["work_preserved"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
