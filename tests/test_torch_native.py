"""PyTorch port: ``voxelrt_torch.utils.native`` (the loader of the native
runtime, native/voxelrt_native.cpp) and ``utils.image.read_png``. The
pure-Python fallbacks are held to the JAX package's and to PIL on every
host; the native paths are held to the fallbacks where the extension is
built (``make -C native``) and skip otherwise, as tests/test_native.py
does."""

import io
import os
import sys
import tempfile
import time

import numpy as np
import pytest
import torch
from PIL import Image

from voxelrt.utils import native as jnative
from voxelrt.world import build_occupancy_pyramid as jax_build

from voxelrt_torch.utils import image, native
from voxelrt_torch.world import VoxelWorld, build_occupancy_pyramid

torch.set_num_threads(1)


@pytest.fixture
def fallback(monkeypatch):
    """Both packages' loaders with the extension taken away."""
    monkeypatch.setattr(native, "_load", lambda: None)
    monkeypatch.setattr(jnative, "_load", lambda: None)


@pytest.fixture
def built():
    if not native.have_native():
        pytest.skip("voxelrt_native not built (make -C native)")


def _img(h=33, w=47, seed=2):
    return np.random.default_rng(seed).integers(0, 255, (h, w, 3),
                                                dtype=np.uint8)


def test_fallback_png_roundtrip(fallback, tmp_path):
    img = _img()
    png = native.encode_png(img, 47, 33)
    assert png == jnative.encode_png(img, 47, 33)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(png))), img)
    # write_png / read_png: (W, H, 3) float v-up in, the same out
    wh3 = img[::-1].transpose(1, 0, 2).astype(np.float32) / 255.0
    path = image.write_png(str(tmp_path / "a.png"), wh3)
    assert np.array_equal(image.read_png(path), wh3)
    assert np.array_equal(image._read_png_minimal(path), img)


def test_image_encoder_is_python_when_native_is_built(monkeypatch):
    """The served frames' encoder stays Python's zlib whatever is built:
    a built extension changes the occupancy build and the screenshot
    writer only."""
    class Built:
        def encode_png(self, *a):
            raise AssertionError("image.encode_png reached the extension")

    monkeypatch.setattr(native, "_load", lambda: Built())
    monkeypatch.setattr(jnative, "_load", lambda: None)
    img = _img(seed=3)
    assert image.encode_png(img, 47, 33) == jnative.encode_png(img, 47, 33)


def test_loader_leaves_sys_path_alone(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_native", None)
    before = list(sys.path)
    native._load()
    assert sys.path == before
    assert native.load_extension(str(tmp_path)) is None


def test_fallback_occupancy(fallback):
    rng = np.random.default_rng(1)
    for res, lods in [(32, 5), (64, 6)]:
        mat = (rng.random((res,) * 3) < 0.07).astype(np.int8)
        words = native.build_occupancy(mat, res, lods)
        assert words.dtype == np.uint32
        assert np.array_equal(words, build_occupancy_pyramid(mat != 0, lods))
        assert np.array_equal(words, jax_build(mat != 0, lods))
        w = VoxelWorld(1.0 / res, res, 0.0)
        w.material = mat
        assert np.array_equal(w.device_arrays()["occ_words"], words)


def test_native_occupancy_matches_numpy(built):
    rng = np.random.default_rng(1)
    for res, lods in [(32, 5), (64, 6)]:
        mat = (rng.random((res,) * 3) < 0.07).astype(np.int8)
        assert np.array_equal(native.build_occupancy(mat, res, lods),
                              build_occupancy_pyramid(mat != 0, lods))


def test_native_png_decodes_as_the_fallback(built, monkeypatch):
    img = _img()
    png = native.encode_png(img, 47, 33)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(png))), img)
    monkeypatch.setattr(native, "_load", lambda: None)
    slow = native.encode_png(img, 47, 33)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(slow))),
                          np.asarray(Image.open(io.BytesIO(png))))


def test_native_frame_writer(built):
    fw = native.frame_writer()
    img = np.zeros((8, 8, 3), np.uint8)
    with tempfile.TemporaryDirectory() as d:
        for i in range(3):
            fw.submit(os.path.join(d, f"f{i}.png"), img.tobytes(), 8, 8)
        fw.drain()
        # drain returns once the queue is empty; the last job may still be
        # being written
        deadline = time.time() + 10
        while fw.written() < 3 and time.time() < deadline:
            time.sleep(0.01)
        assert fw.written() == 3
        assert sorted(os.listdir(d)) == ["f0.png", "f1.png", "f2.png"]
