"""PyTorch port, the moving-frame slice as a whole: ``Scene.run_frames`` on
the port (device="cpu": every kernel's plain twin) against the JAX package's
``Scene.run_frames`` under the same production config (Pallas kernels in
interpret mode), over 3 moving frames (orbit + 'w', render scale 0.5, B4 on
the path) then 2 still frames; the ``FrameStats`` rows; the browser viewer.

Tolerances. A moving image: at most 1% of pixels more than 2e-3 from the JAX
package's (the images are tonemapped LDR in [0, 1]; both packages quantise
the motion-phase sources to bf16 identically, so what remains is float32
last bits, and rarely a history gate flipped by one, which moves a pixel by
a whole tap weight). A still image after the stop: RMSE < 1e-4, the bar of
tests/test_torch_scene.py (the reset cuts the moving history off).
"""

import csv
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from voxelrt import Scene as JScene
from voxelrt.app import testing
from voxelrt.utils.profiling import FrameStats as JFrameStats

from voxelrt_torch.config import RenderConfig as TCfg
from voxelrt_torch.scene import Scene as TScene
from voxelrt_torch.utils.profiling import FrameStats

import torch  # noqa: E402

# One thread per test process: the suite runs several processes side by
# side, and the tensors here are small.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = ([{"orbit": (0.01, 0.002), "move_keys": ["w"], "dt": 0.02}] * 3
          + [{"dt": 0.02}] * 2)
MOVING = [True, True, True, False, False]


def _cfgs():
    j = testing.production_test_config(use_physical_sky=False,
                                       use_clouds=False)
    return j, TCfg(**{f.name: getattr(j, f.name)
                      for f in dataclasses.fields(j)})


def _build(scene):
    """A small scene through the reference's 8-method API."""
    scene.set_floor(-0.3, (0.9, 0.85, 0.8))
    scene.set_directional_light((1, 1.5, 0.5), 0.05, (1.0, 0.95, 0.9))
    scene.set_background_color((0.3, 0.4, 0.6))
    rng = np.random.default_rng(4)
    idx = np.stack(np.meshgrid(np.arange(-8, 8), [0], np.arange(-8, 8),
                               indexing="ij"), -1).reshape(-1, 3)
    scene.set_voxel(idx, 1, (0.7, 0.6, 0.5))
    pil = idx[rng.random(len(idx)) < 0.1]
    for k in range(1, 5):
        scene.set_voxel(pil + [0, k, 0], 2 if k == 4 else 50,
                        (0.2, 0.5, 0.9))
    scene.camera.set_pose((0.45, 0.55, 1.2), (0.0, 0.05, 0.0))
    return scene


def _run(scene, stats, **kw):
    imgs = []
    last = scene.run_frames([dict(f) for f in FRAMES],
                            on_frame=lambda i, img: imgs.append(
                                np.array(img)), stats=stats, **kw)
    return imgs, last


@pytest.fixture(scope="module")
def runs():
    jc, tc = _cfgs()
    with open(os.devnull, "w") as null:
        jstats, tstats = JFrameStats(out=null), FrameStats(out=null)
        jimgs, _ = _run(_build(JScene(config=jc, quiet=True)), jstats)
        ts = _build(TScene(config=tc, quiet=True, device="cpu"))
        timgs, tlast = _run(ts, tstats)
    return dict(jimgs=jimgs, timgs=timgs, tlast=tlast, jrows=jstats.rows,
                trows=tstats.rows, tscene=ts)


@pytest.mark.parametrize("i", range(5))
def test_run_frames_image_matches_jax(runs, i):
    a, b = runs["timgs"][i], runs["jimgs"][i]
    assert a.shape == b.shape == (64, 32, 3) and np.isfinite(a).all()
    assert a.std() > 0.05
    if MOVING[i]:
        far = (np.abs(a - b) > 2e-3).any(-1).mean()
        assert far <= 0.01, f"moving frame {i}: {far:.2%} of pixels differ"
    else:
        rmse = float(np.sqrt(np.mean((a - b) ** 2)))
        assert rmse < 1e-4, f"still frame {i}: RMSE {rmse}"


def test_run_frames_stats_rows_match_jax(runs):
    trows, jrows = runs["trows"], runs["jrows"]
    assert [r["moving"] for r in trows] == MOVING
    assert [r["moving"] for r in jrows] == MOVING
    assert [r["frame"] for r in trows] == [r["frame"] for r in jrows] == [
        1, 2, 3, 4, 5]
    assert [r["spp"] for r in trows] == [r["spp"] for r in jrows]
    # the rate is rounded to 0.01 Mrays/s, which a tiny frame can fall below
    assert all(r["wall_ms"] > 0 and r["mrays_per_s"] >= 0 for r in trows)
    # on_frame's last image is what run_frames returns
    np.testing.assert_array_equal(runs["tlast"], runs["timgs"][-1])
    # the motion policy's state: history restarted at the stop, 2 still spp
    st = runs["tscene"].renderer.state
    assert st.spp == 2 and st.frame == 5
    assert float(st.history[..., 3].max()) == 2.0


def test_run_frames_sync_lag_and_render_stats(tmp_path):
    """sync_lag=1 records one row per frame, in dispatch order, with the
    synchronous path's moving flags; ``render`` records one row per chunk;
    the CSV gets a header and every row."""
    _, tc = _cfgs()
    csv_path = str(tmp_path / "stats.csv")
    with open(os.devnull, "w") as null:
        stats = FrameStats(out=null, csv_path=csv_path)
        scene = _build(TScene(config=tc, quiet=True, device="cpu"))
        r = scene.renderer
        r.prepare_data()
        r.render(spp=4, chunk=2, stats=stats, log_every=10 ** 9)
        assert len(stats.rows) == 2
        assert [row["spp"] for row in stats.rows] == [2, 4]
        img = r.run_frames([dict(f) for f in FRAMES], stats=stats, sync_lag=1)
    rows = stats.rows[2:]
    assert [row["moving"] for row in rows] == MOVING
    assert [row["frame"] for row in rows] == sorted(row["frame"]
                                                    for row in rows)
    assert all(row["wall_ms"] > 0 for row in stats.rows)
    assert img is not None and img.shape == (64, 32, 3)
    assert np.isfinite(img).all()
    assert r.run_frames([{"dt": 0.02}], fetch_final=False) is None
    with open(csv_path) as fh:
        lines = list(csv.reader(fh))
    assert lines[0] == ["frame", "spp", "wall_ms", "mrays_per_s", "moving"]
    assert [ln[4] for ln in lines[1:]] == ["0", "0", "1", "1", "1", "0", "0"]


def _get(port, path):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:  # non-2xx still has a status
        return e.code, e.headers.get("Content-Type"), e.read()


def test_viewer_serves_frames_and_input(tmp_path, monkeypatch):
    """The port's viewer over real HTTP on an ephemeral port: the
    page, a PNG frame, input, /stat reporting a moving stretch, a 404, a
    screenshot on 'p', and the loop ending at max_frames."""
    from voxelrt_torch.app.viewer import serve

    monkeypatch.chdir(tmp_path)
    _, tc = _cfgs()
    scene = _build(TScene(config=dataclasses.replace(tc, image_res=(64, 48)),
                          quiet=True, device="cpu"))
    csv_path = str(tmp_path / "viewer.csv")
    port_box, done, failure = [], threading.Event(), []

    def run():
        try:
            serve(scene, port=0, max_frames=16, stats_csv=csv_path,
                  ready_cb=port_box.append)
        except BaseException as e:
            failure.append(e)
            raise
        finally:
            done.set()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    deadline = time.time() + 240
    while not port_box and time.time() < deadline and not done.is_set():
        time.sleep(0.05)
    assert port_box, f"viewer never bound a port: {failure}"
    port = port_box[0]

    code, ctype, body = _get(port, "/")
    assert code == 200 and "text/html" in ctype and b"frame.png" in body
    assert b'width="64"' in body and b'height="48"' in body

    png = b""
    while time.time() < deadline and not done.is_set():
        code, ctype, png = _get(port, "/frame.png")
        if png:
            break
        time.sleep(0.1)
    assert code == 200 and ctype == "image/png"
    assert png[:8] == b"\x89PNG\r\n\x1a\n", "no frame produced"

    # press and hold W (and the screenshot key) until /stat says moving
    code, _, body = _get(port, "/input?keys=wp&dx=0.01&dy=0.0&fov=55")
    assert code == 200 and body == b"ok"
    assert _get(port, "/input?keys=w&dx=abc")[0] == 400
    saw_moving = False
    while time.time() < deadline and not done.is_set():
        stat = json.loads(_get(port, "/stat")[2])
        assert set(stat) == {"spp", "ms", "moving"}
        if stat["moving"]:
            saw_moving = True
            break
        time.sleep(0.1)
    _get(port, "/input?keys=&dx=0&dy=0")
    assert _get(port, "/nope")[0] == 404

    done.wait(timeout=240)
    t.join(timeout=10)
    assert done.is_set() and not t.is_alive(), "viewer loop did not end"
    assert not failure, failure
    assert saw_moving, "moving flag never surfaced in /stat"
    with open(csv_path) as fh:
        rows = list(csv.DictReader(fh))
    assert len(rows) == 16
    assert {r["moving"] for r in rows} == {"0", "1"}
    assert all(float(r["wall_ms"]) > 0 for r in rows)
    shots = os.listdir(tmp_path / "screenshot")
    assert shots and all(s.startswith("viewer-") and s.endswith(".png")
                         for s in shots)
    # the server is gone: the port no longer answers
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=2)


def test_moving_path_imports_no_jax():
    """A fresh interpreter that imports every module of the moving path, the
    viewer and the camera-path tool holds neither jax nor the JAX package."""
    code = (
        "import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "import voxelrt_torch.app.viewer, voxelrt_torch.app.headless\n"
        "import voxelrt_torch.ops.resample, voxelrt_torch.render.temporal\n"
        "import voxelrt_torch.utils.profiling, voxelrt_torch.interop\n"
        "import camera_path_bench_torch\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'voxelrt')]\n"
        "assert not bad, bad\n"
        "assert callable(voxelrt_torch.app.viewer.serve)\n"
        % (ROOT, os.path.join(ROOT, "tools")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_entry_points_default_to_the_card():
    """run_frames and the viewer resolve no device to the CUDA card and
    raise without one, like every other entry point of the port."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card path cannot run")
    with pytest.raises(RuntimeError, match="CUDA"):
        TScene(quiet=True).run_frames([{"dt": 0.02}])
