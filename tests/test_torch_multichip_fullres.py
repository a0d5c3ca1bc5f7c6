"""PyTorch port at full width, the twin of tests/test_multichip_fullres.py:
``app/testing.tiny_config(image_res=(1280, 720), grid_res=128)``, one
launch of ``pipeline.accumulate_n`` with key 3, on the CPU.

* (a) The port's one-device frame against the JAX package's. Tolerance:
  at least 99.9% of colour pixels have all three channels within rtol =
  atol = 1e-4 of the JAX package's, the rest are finite, and the frame is
  lit (mean > 1e-3). Not every pixel: the port traces with B1's twin and
  the JAX package on the CPU with its portable traversal, and the two
  disagree on about 3 rays in 921,600 (``chip_smoke.py`` phase 24), each of
  which moves its pixel by more than 1e-4; float32 last bits (XLA's CPU
  transcendentals against torch's) stay far inside 1e-4.
* (b) The same frame partitioned over 'dp' = 8 (``parallel/sharding.py``,
  160-row blocks of the (1280, 720) buffers, on the CPU eight times): every
  field of the gathered state ``torch.equal`` to (a)'s port frame, the
  port's bar for partitioned frames. The twin of
  ``test_gspmd_fullres_matches_single_device``.
* (c) ``test_gspmd_production_path_matches_single_device`` (64×32 at dp=8)
  has its port twin already and is not repeated here: the port always
  traces with B1 (its twin on the CPU), so its production path is its only
  path, and tests/test_torch_sharding_pipeline.py:124
  (``test_multichip_dp_only_exact``: 64×32 at dp=8, still, ReSTIR and the
  sorted route, every field equal to one device's) and :287
  (``test_dp8_matches_jax_one_device``: the dp=8 frame against the JAX
  package's one-device frame) hold it. The physical sky and clouds at dp=8
  run on the card, example6 in ``chip_smoke.py`` phase 28.
* (d) A moving frame under a dp=8 mesh moves nothing between devices, the
  port's form of ``test_moving_frame_replicated_policy_zero_collectives``:
  the port runs a moving frame unpartitioned on the scene's device, where
  the JAX package replicates it. On a mesh of the CPU every device is the
  same one, so what is counted is what ``parallel/sharding.py`` asks to
  move, whatever the devices: the halo rows and trace gathers of
  ``tools/multichip_report_torch.py``'s ``Traffic`` counters, every tensor
  ``_move`` copies to a block's device, and the scene replicas. All read 0
  for the moving frame; the same counters read more than 0 for a still
  frame on the same mesh, so a zero is not a counter that sees nothing."""

import jax
import numpy as np
import pytest
import torch

from voxelrt.app import testing as jtesting
from voxelrt.render import pipeline as jpl

from tools import multichip_report_torch as mrt
from voxelrt_torch.app import testing
from voxelrt_torch.ops import prng
from voxelrt_torch.parallel import sharding
from voxelrt_torch.render import pipeline as tpl

from test_torch_sharding_pipeline import assert_state_equal

torch.set_num_threads(1)

FULL = dict(image_res=(1280, 720), grid_res=128)
DP = 8


@pytest.fixture(scope="module")
def jax_color():
    cfg = jtesting.tiny_config(**FULL)
    s = jpl.accumulate_n(cfg, jtesting.make_scene_data(cfg),
                         jtesting.make_params(cfg), jpl.init_state(cfg),
                         jax.random.PRNGKey(3), False, 1.0, 1)
    return np.asarray(s.color)


@pytest.fixture(scope="module")
def port():
    """The port's scene and its one-device frame."""
    cfg = testing.tiny_config(**FULL)
    sd, p = testing.make_scene_data(cfg, "cpu"), testing.make_params(cfg,
                                                                     "cpu")
    one = tpl.accumulate_n(cfg, sd, p, tpl.init_state(cfg, "cpu"),
                           prng.key(3), False, 1.0, 1)
    return cfg, sd, p, one


def test_fullres_matches_jax(port, jax_color):
    one = port[3]
    have = one.color.numpy()
    assert have.shape == jax_color.shape == (1280, 720, 3)
    ok = np.isclose(have, jax_color, rtol=1e-4, atol=1e-4).all(-1)
    print(f"1280x720: {ok.mean():.6f} of {ok.size} pixels within 1e-4 of "
          f"the JAX package's, {int((~ok).sum())} outside")
    assert ok.mean() >= 0.999, ok.mean()
    assert np.isfinite(have).all()
    assert have.mean() > 1e-3


def test_fullres_dp8_matches_one_device(port):
    cfg, sd, p, one = port
    mesh = sharding.make_mesh(["cpu"] * DP, dp=DP)
    parts = sharding.sharded_accumulate_n(
        cfg, sd, p, tpl.init_state(cfg, "cpu"), prng.key(3), False, 1.0, 1,
        mesh)
    assert [b.color.shape[0] for b in parts] == [1280 // DP] * DP
    assert_state_equal(one, sharding.gather_state(parts))


class _Moves:
    """What ``parallel/sharding.py`` moves inside a ``with`` block: the
    ``Traffic`` counters, plus the bytes of every tensor ``_move`` copies
    and the number of scene or params replicas made."""

    def __init__(self, monkeypatch):
        self.monkeypatch = monkeypatch

    def __enter__(self):
        self.traffic = mrt.Traffic().__enter__()
        self.moved_bytes, self.replicas = 0, 0
        move, replicate = sharding._move, sharding.replicate

        def move_counted(x, device):
            self.moved_bytes += x.numel() * x.element_size()
            return move(x, device)

        def replicate_counted(tree, mesh):
            self.replicas += 1
            return replicate(tree, mesh)

        self.monkeypatch.setattr(sharding, "_move", move_counted)
        self.monkeypatch.setattr(sharding, "replicate", replicate_counted)
        return self

    def __exit__(self, *exc):
        self.monkeypatch.undo()
        self.traffic.__exit__(*exc)

    @property
    def halo_bytes(self):
        return sum(e["bytes"] for e in self.traffic.blocks)


@pytest.mark.parametrize("before", ["fresh", "after_moving"])
def test_moving_frame_moves_nothing(monkeypatch, before):
    cfg = testing.tiny_config(image_res=(128, 64), grid_res=64)
    sd, p = testing.make_scene_data(cfg, "cpu"), testing.make_params(cfg,
                                                                     "cpu")
    mesh = sharding.make_mesh(["cpu"] * DP, dp=DP)

    def state():
        st = tpl.init_state(cfg, "cpu")
        if before == "after_moving":
            st = tpl.accumulate_n(cfg, sd, p, st, prng.key(1), True, 0.5, 1)
        return st

    want = tpl.accumulate_n(cfg, sd, p, state(), prng.key(0), True, 0.5, 1)
    st = state()
    with _Moves(monkeypatch) as moved:
        got = sharding.sharded_accumulate_n(cfg, sd, p, st, prng.key(0),
                                            True, 0.5, 1, mesh)
    assert isinstance(got, tpl.RenderState)
    assert got.color.device == sd.occ_words.device
    assert (moved.moved_bytes, moved.halo_bytes, moved.traffic.gather_bytes,
            moved.replicas) == (0, 0, 0, 0)
    assert_state_equal(want, got)
    assert got.color.std() > 0.01

    # the same counters on a still frame on the same mesh
    with _Moves(monkeypatch) as moved:
        sharding.sharded_accumulate_n(cfg, sd, p, tpl.init_state(cfg, "cpu"),
                                      prng.key(0), False, 1.0, 1, mesh)
    assert moved.moved_bytes > 0 and moved.halo_bytes > 0
    assert moved.replicas > 0
    assert len(moved.traffic.blocks) == DP
