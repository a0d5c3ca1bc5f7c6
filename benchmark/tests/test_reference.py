"""The plain reference against the program on the CPU at a tiny size: the
recorded scene equals the one the program builds, and a run's checked
pixels equal the reference's bit for bit (the program's kernels run as
their plain twins here)."""

import time

import numpy as np
import pytest

from benchmark.harness import runner
from benchmark.tests.cells import ROOT, cells_of_kind, tiny_cell

CELLS = cells_of_kind("progressive_still")


@pytest.mark.parametrize("name", ["example6", "example9"])
def test_recorded_scene_is_the_programs(name):
    from benchmark.reference import scene as rscene
    from voxelrt_torch.app.examples import build_example

    rec = rscene.record_example(rscene.examples_dir(ROOT), name)
    sc = build_example(name, "cpu", (64, 32))
    assert np.array_equal(rec.material, sc.world.material)
    assert np.array_equal(rec.color, sc.world.color)
    assert np.array_equal(rec.packed_voxels(),
                          sc.world.device_arrays()["voxels"])
    assert rec.floor_height == sc._floor_height
    assert np.array_equal(rec.light_direction, sc._light_direction)
    assert np.array_equal(rec.light_color, sc._light_color)
    assert np.array_equal(rec.background_color, sc._background_color)
    assert rec.use_physical_sky == sc._use_physical_sky
    assert rec.exposure == sc.config.exposure


@pytest.mark.parametrize("name,traffic", [
    *(pytest.param(n, {}, id=n) for n in CELLS),
    # one sample a launch, the RenderConfig default: every launch's resolve
    # blends a single sample
    pytest.param(CELLS[0], {"samples_per_launch": 1},
                 id="one-sample-launches"),
])
def test_program_equals_reference(name, traffic):
    cell = tiny_cell(name, **traffic)
    result, lines = runner.run(cell, 2 ** 31 + 977, 0.0, False, "cpu",
                               time.perf_counter())
    assert result["correct"], lines
    assert result["failed"] == 0
    assert result["attempted"] == 64 * 32
    assert all(c["value"] == 0.0 for c in result["checks"].values())


def test_reference_camera_is_the_programs():
    from benchmark.reference.scene import camera_matrices
    from voxelrt_torch.camera import Camera

    proj, view = Camera(up=(0, 1, 0)).matrices(np.radians(50.0), 16 / 9)
    rp, rv = camera_matrices(16 / 9)
    assert np.array_equal(proj, rp) and np.array_equal(view, rv)


def test_reference_imports_nothing_of_the_program():
    import ast
    import glob
    import os

    for path in glob.glob(os.path.join(ROOT, "benchmark", "reference",
                                       "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in (
                    "voxelrt_torch", "voxelrt", "jax", "jaxlib", "flax"), (
                    path, n)


def test_pixels_are_drawn_from_the_seed():
    from benchmark.harness.progressive_still import choose_pixels

    a = choose_pixels(2 ** 33 + 5, (1280, 720), 2048)
    assert np.array_equal(a, choose_pixels(2 ** 33 + 5, (1280, 720), 2048))
    assert len(set(a.tolist())) == 2048 and a.max() < 1280 * 720
    assert not np.array_equal(a, choose_pixels(7, (1280, 720), 2048))
