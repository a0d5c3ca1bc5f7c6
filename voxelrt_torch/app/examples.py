"""Build the scenes of ``examples/*.py`` on the port, without editing them.

Every example builds its scene at import through ``_common.make_scene`` and
fills it in ``initialize_voxels()`` (or ``initialize()`` + ``draw()``).
``build_example`` replaces ``_common.make_scene`` with a maker of the port's
``Scene`` for the time of the import, runs the fill functions, and puts the
original back; the example module is imported afresh on every call, so its
module-level random generators start from their seeds each time.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import sys

EXAMPLES_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "examples")
NAMES = ("main",) + tuple(f"example{i}" for i in range(1, 11))


def build_example(name, device=None, image_res=None, quiet=True,
                  sky_cache_dir=".skycache", **config_over):
    """The port's Scene of ``examples/<name>.py``, filled and ready for
    ``finish`` or ``run_frames``. ``device=None`` is the CUDA card.
    ``config_over``: RenderConfig fields to replace after the example set
    its own (for example ``samples_per_launch=16`` or the sky knobs)."""
    if name not in NAMES:
        raise ValueError(f"unknown example {name!r}: one of {NAMES}")
    from voxelrt_torch.scene import Scene

    if EXAMPLES_DIR not in sys.path:
        sys.path.insert(0, EXAMPLES_DIR)
    import _common

    def make_scene(argv=None, **kw):
        if image_res is not None:
            kw["image_res"] = tuple(image_res)
        return Scene(quiet=quiet, device=device, sky_cache_dir=sky_cache_dir,
                     **kw)

    saved = _common.make_scene
    _common.make_scene = make_scene
    sys.modules.pop(name, None)
    try:
        mod = importlib.import_module(name)
        if hasattr(mod, "initialize_voxels"):
            mod.initialize_voxels()
        else:
            mod.initialize()
            if hasattr(mod, "draw"):
                mod.draw()
        scene = mod.scene
    finally:
        _common.make_scene = saved
        sys.modules.pop(name, None)
    if config_over:
        scene.config = dataclasses.replace(scene.config, **config_over)
    return scene
