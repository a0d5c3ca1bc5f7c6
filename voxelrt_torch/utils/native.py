"""Loader for the optional C++ runtime extension (native/voxelrt_native.cpp,
host code that both packages share; the PyTorch port's copy of
voxelrt/utils/native.py).

Falls back to the pure-Python implementations when the extension is not
built; ``have_native()`` reports which one runs. Build with
``make -C native``. The extension is loaded by its file path, so
``sys.path`` is left alone.

The port routes the occupancy build through it (``world.device_arrays``)
and the viewer's screenshots through its writer thread. The viewer's
served frames are encoded by ``utils.image.encode_png``, in Python: on the
viewer's 1280x720 frames at level 3 the native encoder showed no steady
win over it (PERF.md, section 6).
"""

from __future__ import annotations

import importlib.machinery
import importlib.util
import os

from voxelrt_torch.utils.image import encode_png as _encode_png_python

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native")

_native = None
_tried = False


def load_extension(directory: str):
    """The ``voxelrt_native`` module built into ``directory``, or None."""
    for suffix in importlib.machinery.EXTENSION_SUFFIXES:
        path = os.path.join(directory, "voxelrt_native" + suffix)
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location("voxelrt_native",
                                                          path)
            try:
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
            except ImportError:
                return None
            return mod
    return None


def _load():
    global _native, _tried
    if _tried:
        return _native
    _tried = True
    _native = load_extension(NATIVE_DIR)
    return _native


def have_native() -> bool:
    return _load() is not None


def build_occupancy(material_xyz, res: int, n_lods: int):
    """Native-or-numpy occupancy pyramid build. material_xyz: int8 [x][y][z]."""
    import numpy as np

    nat = _load()
    if nat is not None:
        words = nat.build_occupancy(
            np.ascontiguousarray(material_xyz, dtype=np.int8).tobytes(),
            res, n_lods,
        )
        return np.frombuffer(words, dtype=np.uint32).copy()
    from voxelrt_torch.world import build_occupancy_pyramid

    return build_occupancy_pyramid(material_xyz != 0, n_lods)


def encode_png(rgb_topdown, w: int, h: int, level: int = 6) -> bytes:
    """Native-or-python PNG encode; rgb rows top-down, (h, w, 3) uint8."""
    nat = _load()
    if nat is not None:
        return nat.encode_png(rgb_topdown.tobytes(), w, h, level)
    return _encode_png_python(rgb_topdown, w, h, level)


def frame_writer():
    """Async frame writer (native worker thread) or None."""
    nat = _load()
    return nat.FrameWriter() if nat is not None else None
