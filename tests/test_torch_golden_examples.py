"""PyTorch port: the full-width goldens of the example scenes besides
example6, and of example2 with ReSTIR-PT, that ``chip_smoke.py`` phases 17
and 33 hold the card to; and the JAX package's function that makes them,
run here at 128×72 against the port's CPU path.

``tests/golden/torch_fullres/<name>_1280x720_16spp.png`` (``main``,
``example1``-``example5``, ``example7``-``example10``) is the example,
unedited, rendered by the JAX package on the CPU on its default route
(``use_pallas_dda=False``: the portable traversal, the explicit shadow
dispatch, float32 sky maps) at its default ``RenderConfig`` (1280×720)
with ``samples_per_launch=16``: one launch of 16 samples from the Scene's
default seed. example7 and example10 are lit by their sky at the
``TINY_SKY`` knobs of tests/test_examples_golden.py, computed by the JAX
package and shipped as ``<name>_sky_tiny.npz`` (the ``sky_<key>.npz`` it
wrote); both packages load it from a temporary cache.
``example2_restir_1280x720_4spp.png`` is example2 with ReSTIR-PT at the JAX
defaults (32 taps of radius 24, one sample a launch), 4 spp through
``Scene.finish``. A ``.json`` beside each golden records the route, the
config fields changed, the seed, the seconds and the peak host memory.
Remake them with ``python tests/test_torch_golden.py --regen examples
[NAME ...] [--jobs N]`` (``tests/test_torch_golden.py``).

Bars against the JAX package here: RMSE 1e-4, the repo's bar for images
against the JAX package, but for the two gaps that are routes, each shown
to be what it is:

* example7 and example10, held here on example10: the port reads the sky
  maps bf16-packed, the JAX package's TPU route, where the JAX package on
  the CPU reads them as float32 (ROADMAP.md §3 item 4). With the JAX
  package's maps rounded to bf16 as ``pack_rgb_bf16`` rounds them, the
  port must sit on its image at RMSE 1e-4 (measured 9.3e-7); against the
  float32 route every pixel must lie within 2/255 and the RMSE below
  5e-4 (measured 1.78e-4, 28.5% of pixels within 1e-4, the largest
  difference 0.0011: a bf16 step of the maps, 2^-9 of a value, spread
  over the sky's pixels). The bar leaves that gap room to move with the
  scene and no room for a fault that moves a pixel past 2/255.
* example9: B1, like the JAX package's Pallas kernel it ports, steps two
  axes at once where two of a ray's exits from a cell are equal to the last
  bit (the ray passes through a voxel edge) and returns the two-axis
  normal; the JAX package's portable traversal, its CPU default route,
  steps them one at a time in an order its own rounding decides. Every
  pixel beyond 1e-4 of the JAX package's image must be one with a sample
  on which B1 returned a two-axis normal, and the image without those
  pixels must meet RMSE 1e-4 (ROADMAP.md §3 item 6).
"""

import json
import os

import numpy as np
import pytest
import torch

from test_examples_golden import TINY_SKY
from test_torch_golden import (EXAMPLE_SKIES, EXAMPLES, RESTIR_EXAMPLE,
                               example_config, example_golden,
                               example_sky_golden, example_spp, port_hits,
                               render_example_jax, render_example_port,
                               tie_pixels, two_axis_lanes)

torch.set_num_threads(1)

RES = (128, 72)
BAR = 1e-4  # images against the JAX package
SKY_ROUTE_RMSE = 5e-4  # the float32 sky maps' route, see the docstring
GOLDENS = EXAMPLES + (RESTIR_EXAMPLE,)


@pytest.mark.parametrize("name", GOLDENS)
def test_example_golden_reads_as_an_image(name):
    """Each golden is a 720-row, 1280-column RGB PNG, read as the (W, H, 3)
    image ``Scene.finish`` returns; its record names the route, the config
    fields and the seed; a sky scene's sky ships beside it with its key.
    No render."""
    from voxelrt_torch.utils.image import read_png

    path = example_golden(name)
    with open(path, "rb") as fh:
        head = fh.read(26)
    assert head[:8] == b"\x89PNG\r\n\x1a\n"
    assert (int.from_bytes(head[16:20], "big"),
            int.from_bytes(head[20:24], "big")) == (1280, 720)
    assert head[25] == 2  # colour type RGB
    img = read_png(path)
    assert img.shape == (1280, 720, 3) and img.dtype == np.float32
    assert img.std() > 0.01
    with open(path[:-len(".png")] + ".json") as fh:
        record = json.load(fh)
    base, config = example_config(name)
    assert record["example"] == base and record["seed"] == 0
    assert record["res"] == [1280, 720] and record["spp"] == example_spp(name)
    assert record["config"] == config
    assert "use_pallas_dda=False" in record["route"]
    assert record["seconds"] > 0 and record["peak_host_gib"] > 0
    if base in EXAMPLE_SKIES:
        sky = example_sky_golden(base)
        assert record["sky"] == os.path.basename(sky)
        with open(sky[:-len(".npz")] + ".json") as fh:
            sky_record = json.load(fh)
        assert sky_record["example"] == base
        assert {k: sky_record["knobs"][k] for k in TINY_SKY} == TINY_SKY
        with np.load(sky) as z:
            assert z["scatt"].shape == z["trans"].shape == (128, 128, 3)
    else:
        assert record["sky"] is None


def _figures(port, ref):
    diff = np.abs(port - ref).max(-1)
    return dict(rmse=float(np.sqrt(np.mean((port - ref) ** 2))),
                within_1e4=float((diff <= BAR).mean()),
                beyond_2_255=int((diff > 2 / 255).sum()),
                largest=float(diff.max()))


@pytest.mark.parametrize("name,over", [
    ("example1", {}),
    (RESTIR_EXAMPLE, dict(restir_taps=8, restir_radius=6.0)),
])
def test_golden_function_matches_port(name, over):
    """``render_example_jax``, the goldens' function, at 128×72 on the JAX
    package's CPU default route against the port's CPU path: RMSE 1e-4
    (example2 with ReSTIR at the golden test's 8 taps of radius 6)."""
    port = render_example_port(name, RES, **over)
    ref = render_example_jax(name, RES, **over)
    f = _figures(port, ref)
    print(f"{name} at {RES}: {json.dumps(f)}")
    assert np.isfinite(port).all() and f["rmse"] < BAR


def test_golden_function_sky_scene_gap_is_the_bf16_sky_maps(monkeypatch):
    """example10 at 128×72: against the JAX package's CPU route (float32
    sky maps) every pixel within 2/255 and RMSE below ``SKY_ROUTE_RMSE``;
    against the same with the maps rounded to bf16 as the port reads them,
    RMSE 1e-4 (see the module docstring)."""
    from voxelrt.sky import atmos as jatmos

    name = "example10"
    port = render_example_port(name, RES)
    f32 = _figures(port, render_example_jax(name, RES))
    prepare = jatmos.prepare_sky

    def prepare_bf16(*args, **kwargs):
        sky = prepare(*args, **kwargs)

        def bf16(x):
            b = np.asarray(x, np.float32).view(np.uint32)
            b = ((b + ((b >> 16) & 1) + np.uint32(0x7FFF)) >> 16) << 16
            return b.view(np.float32)

        return sky._replace(
            skybox_scattering=bf16(sky.skybox_scattering),
            skybox_transmittance=bf16(sky.skybox_transmittance))

    monkeypatch.setattr(jatmos, "prepare_sky", prepare_bf16)
    bf = _figures(port, render_example_jax(name, RES))
    print(f"{name} at {RES}: float32 maps {json.dumps(f32)}, bf16-rounded "
          f"maps {json.dumps(bf)}")
    assert f32["beyond_2_255"] == 0 and f32["rmse"] < SKY_ROUTE_RMSE
    assert bf["rmse"] < BAR


def test_golden_function_example9_gap_is_b1_edge_ties():
    """example9 at 128×72 against the JAX package's CPU default route: the
    pixels beyond 1e-4 are pixels with a sample on which B1 returned a
    two-axis normal (two exits from a cell equal to the last bit), and the
    image without those pixels meets RMSE 1e-4 (see the module
    docstring)."""
    with port_hits() as hits:
        port = render_example_port("example9", RES)
    ref = render_example_jax("example9", RES)
    tie_px = tie_pixels(hits, RES)
    diff = np.abs(port - ref).max(-1)
    f = _figures(port, ref)
    rest = np.sqrt(np.mean(np.where(tie_px[..., None], 0.0,
                                    port - ref) ** 2))
    print(f"example9 at {RES}: {json.dumps(f)}; "
          f"{sum(int(two_axis_lanes(h).sum()) for h in hits)} hits with "
          f"a two-axis normal in {int(tie_px.sum())} pixels; "
          f"{int((diff > BAR).sum())} pixels beyond 1e-4, RMSE without the "
          f"tie pixels {rest:.3e}")
    assert np.isfinite(port).all()
    assert not (diff > BAR)[~tie_px].any()
    assert rest < BAR
    assert tie_px.sum() <= 16


def test_path_frames_tool_splits_an_example_still(tmp_path, monkeypatch):
    """``tools/path_frames_torch.py stages --scene``, the split of a still
    launch by stage, end to end on the CPU at 32×18 against itself:
    example10 lit by its shipped sky, every stage of a still launch (no B4)
    in order, no value apart."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import path_frames_torch as pf

    drive = pf.drive
    monkeypatch.setattr(pf, "drive", lambda device, scene=None, res=None:
                        drive(device, scene, res or (32, 18)))
    out = tmp_path / "stages.json"
    pf.stages("cpu", "cpu", str(out), "example10")
    with open(out) as fh:
        got = json.load(fh)
    assert got["scene"] == "example10"
    stages = [r["stage"] for r in got["rows"]]
    assert stages[0] == "trace" and stages[-1] == "tonemap"
    assert "b4" not in stages and "filter" in stages
    assert all(r["chain"]["unequal"] == 0 == r["own"]["unequal"]
               for r in got["rows"])
