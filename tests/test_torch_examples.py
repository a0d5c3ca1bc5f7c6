"""PyTorch port: the golden images of the example scenes, on the port.

Every scene of tests/test_examples_golden.py is built from its unedited
``examples/*.py`` through ``voxelrt_torch.app.examples.build_example``
(``example2_restir``: example2 with ReSTIR-PT on, 8 taps of radius 6, the
golden test's settings), rendered on the CPU
(the kernels' plain PyTorch versions) at 128x72, 16 spp, fixed seed, the
sky scenes with the reduced ``TINY_SKY`` knobs and an empty temporary sky
cache (so the port computes the sky itself), and held to
``tests/golden/examples/<name>.png`` at the golden bar, RMSE 0.015.

The goldens are renders of the JAX package on the CPU: its portable
traversal and explicit shadow dispatch, and its own sky precompute. The port
renders the kernel formulation (in-kernel NEE, bf16-packed sky words), so
the gap is float32 rounding, the bf16 sky quantisation (0.4% relative) and,
in the sky scenes, the cloud texels whose density lookups flip on a
last-bit difference (see tests/test_torch_sky.py).
"""

import os

import numpy as np
import pytest

from voxelrt.utils.image import read_png

from voxelrt_torch.app.examples import NAMES, build_example

from test_examples_golden import GOLDEN_DIR, RES, RMSE_TOL, SPP, TINY_SKY

import torch  # noqa: E402

# One thread per test process: the suite runs several processes side by
# side, and the tensors here are small.
torch.set_num_threads(1)

# The four scenes that take longest on the CPU are cases of
# tests/test_torch_examples_large.py, so that each file stays short.
LARGE = ("example6", "example7", "example9", "example10")


def check_example_golden(name, tmp_path):
    golden = read_png(os.path.join(GOLDEN_DIR, f"{name}.png"))
    over = {}
    if name.endswith("_restir"):  # tests/test_examples_golden.py:60-61
        over = dict(use_restir_pt=True, restir_taps=8, restir_radius=6.0)
    scene = build_example(name.removesuffix("_restir"), "cpu", RES,
                          sky_cache_dir=str(tmp_path), **over)
    if scene._use_physical_sky:
        import dataclasses

        scene.config = dataclasses.replace(scene.config, **TINY_SKY)
    img = np.asarray(scene.finish(spp=SPP, save=False))
    assert img.shape == golden.shape and np.isfinite(img).all()
    if scene._use_physical_sky:
        assert len(os.listdir(tmp_path)) == 1  # the port computed the sky
    rmse = float(np.sqrt(np.mean((img - golden) ** 2)))
    print(f"{name}: RMSE {rmse:.5f} against the golden")
    assert rmse < RMSE_TOL, f"{name}: RMSE {rmse:.4f} >= {RMSE_TOL}"


@pytest.mark.parametrize("name", [n for n in NAMES if n not in LARGE]
                         + ["example2_restir"])
def test_example_golden_on_port(name, tmp_path):
    check_example_golden(name, tmp_path)


def test_example_runner_tool(tmp_path, capsys):
    """tools/run_example_torch.py end to end on the CPU: arguments, the
    render, the PNG and the JSON line."""
    import json
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(GOLDEN_DIR), os.pardir,
                                    os.pardir, "tools"))
    import run_example_torch as tool

    a = tool.parse_args(["example7", "--device", "cpu", "--res", "128x72",
                         "--spp", "4"])
    assert (a.name, a.device, a.res, a.spp) == ("example7", "cpu", (128, 72), 4)
    with pytest.raises(SystemExit):
        tool.parse_args(["example11"])
    out = str(tmp_path / "main.png")
    tool.main(["main", "--device", "cpu", "--res", "64x36", "--spp", "2",
               "--out", out])
    fig = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert fig["name"] == "main" and fig["device"] == "cpu"
    assert fig["launches"]["traverse"] == 0  # the CPU launches no kernel
    assert np.allclose(read_png(out).mean(), fig["mean"], atol=5e-3)
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):  # no card, no quiet step back
            tool.run_example("main", None, (64, 36), 1, save=False)
