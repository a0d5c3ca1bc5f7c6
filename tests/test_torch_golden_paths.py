"""PyTorch port: the full-width goldens of example6's camera path and of its
ReSTIR render, which ``chip_smoke.py`` phases 30 and 31 hold the card to.

The goldens (``tests/golden/torch_fullres/``) are made by the JAX package
on the CPU at 1280×720 through ``tests/test_torch_golden.py --regen path``
and ``--regen restir``, on the port's route (the JAX package's Pallas
kernels in interpret mode: bf16 sky maps, B4's taps on bf16 sources):

* ``example6_path_f24.png`` and ``example6_path_f30.png``: frames 24 (the
  last moving one, 640×360 active, upsampled) and 30 (the last still one
  after the reset) of ``Scene.run_frames`` over 24 frames of orbit (0.01,
  0.002) + 'w' at dt 0.02, then 6 still ones, one sample a frame;
* ``example6_restir_1280x720_4spp.png``: example6 with ReSTIR-PT at the JAX
  defaults (32 taps of radius 24, one sample a launch), 4 spp through
  ``Scene.finish``.

Here each golden is only read, and the generator's own functions run at
128×72 against the port's CPU path at the bars of
tests/test_torch_frames.py (a moving frame: at most 1% of pixels more than
2e-3 apart; a still one: RMSE < 1e-4) and tests/test_torch_restir_frames.py
(RMSE < 1e-4).
"""

import numpy as np
import pytest
import torch

import test_torch_golden as tg

torch.set_num_threads(1)

SMALL = (128, 72)
SMALL_FRAMES = [tg.MOVE, tg.MOVE, tg.HOLD]


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


@pytest.mark.parametrize("path", [tg.PATH_GOLDENS[n] for n in tg.PATH_KEEP]
                         + [tg.RESTIR_GOLDEN],
                         ids=["path_f24", "path_f30", "restir"])
def test_golden_reads_as_a_fullres_image(path):
    """A 720-row, 1280-column RGB PNG, read as the (W, H, 3) image the
    port's ``Scene`` returns; a lit frame, not a constant."""
    from voxelrt_torch.utils.image import read_png

    with open(path, "rb") as fh:
        head = fh.read(24)
    assert head[:8] == b"\x89PNG\r\n\x1a\n"
    assert (int.from_bytes(head[16:20], "big"),
            int.from_bytes(head[20:24], "big")) == tg.FULLRES_RES
    img = read_png(path)
    assert img.shape == tg.FULLRES_RES + (3,) and img.dtype == np.float32
    assert img[::-1].transpose(1, 0, 2).shape == (720, 1280, 3)
    assert 0.05 < img.mean() < 0.95 and img.std() > 0.05


def test_path_generator_matches_port():
    """``render_example6_path_jax`` at 128×72 over two moving frames and a
    still one after the reset, against the port's ``Scene.run_frames`` on
    the CPU."""
    from voxelrt_torch.app.examples import build_example

    keep = (2, 3)
    ref = tg.render_example6_path_jax(SMALL, SMALL_FRAMES, keep)
    assert sorted(ref) == list(keep)
    imgs = []
    build_example("example6", "cpu", SMALL).run_frames(
        [dict(f) for f in SMALL_FRAMES],
        on_frame=lambda i, img: imgs.append(np.array(img)))
    far = float((np.abs(imgs[1] - ref[2]) > 2e-3).any(-1).mean())
    rmse = _rmse(imgs[2], ref[3])
    print(f"moving frame 2: {far:.4%} of pixels beyond 2e-3; still frame 3: "
          f"RMSE {rmse:.3e}")
    assert far <= 0.01
    assert rmse < 1e-4


def test_restir_generator_matches_port():
    """``render_example6_restir_jax`` at 128×72 (32 taps of radius 24 reach
    across a third of the image), against the port's ``Scene.finish`` on
    the CPU."""
    from voxelrt_torch.app.examples import build_example

    ref = tg.render_example6_restir_jax(SMALL)
    img = build_example("example6", "cpu", SMALL, use_restir_pt=True).finish(
        spp=tg.RESTIR_SPP, save=False)
    rmse = _rmse(img, ref)
    print(f"ReSTIR {SMALL}, {tg.RESTIR_SPP} spp: RMSE {rmse:.3e}, "
          f"{(np.abs(img - ref).max(-1) <= 1e-4).mean():.4%} of pixels "
          f"within 1e-4")
    assert img.shape == ref.shape and np.isfinite(img).all()
    assert rmse < 1e-4
