"""PyTorch port, the shade kernel (``ops/shade_kernel.py`` +
``csrc/shade.cu``): which routes take it, and on the card one depth of it
against its plain twin ``render/pathtracer.py`` ``shade_depth_eager``.

On the card the twin runs the eager route of a real launch of example6 and
example9 at 64×32 (16 samples) and the wavefront's state at depths 0, 1
and 3 is taken as it enters the shading (``tools/shade_kernel_torch.py``
``capture``); from it, each version shades the same depth. Every output is
compared by its bits: at most 0.1% of the lanes may differ, by 1e-5
relative at most (a device function's last bit), the lanes that do not
trace keep their state, and the mask handed in (B1's at that depth) is
left as it was."""

import functools

import pytest
import torch

from voxelrt_torch.config import RenderConfig
from voxelrt_torch.ops import shade_kernel
from voxelrt_torch.ops.bsdf import ALL_FEATURES, MatFeatures
from voxelrt_torch.render import pathtracer

# One thread per test process: the suite runs several processes side by
# side.
torch.set_num_threads(1)

RES = (64, 32)
K = 16


@pytest.mark.parametrize("device,over,applies", [
    ("cuda", {}, True),
    ("cpu", {}, False),
    ("cuda", dict(use_physical_sky=True), True),
    ("cuda", dict(rng_draws="table"), True),
    ("cuda", dict(use_restir_pt=True), False),
    ("cuda", dict(sort_rays=True), False),
    ("cuda", dict(nee_in_kernel=False), False),
    ("cuda", dict(nee_in_kernel=False, use_directional_light=False), True),
    ("cuda", dict(nee_transmittance="per_ray", use_physical_sky=True), False),
    ("cuda", dict(nee_transmittance="per_ray"), True),
])
def test_which_routes_take_the_kernel(device, over, applies):
    cfg = RenderConfig(**over)
    assert shade_kernel.shade_kernel_applies(cfg, device) is applies
    assert shade_kernel.shade_kernel_applies(
        cfg, torch.device(device)) is applies


@pytest.mark.parametrize("feat,bits", [
    (ALL_FEATURES, 31), (MatFeatures(*[False] * 5), 0),
    (MatFeatures(True, False, False, True, False), 9),
    (MatFeatures(False, True, True, False, True), 22)])
def test_feature_bits(feat, bits):
    assert shade_kernel.feature_bits(feat) == bits


# --- on the card -------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _captured(name, baked):
    from tools import shade_kernel_torch as skt

    return skt.capture(skt.renderer(name, RES), (0, 1, 3),
                       all_features=not baked)


@pytest.mark.cuda
@pytest.mark.parametrize("baked", [True, False])
@pytest.mark.parametrize("depth", [0, 1, 3])
@pytest.mark.parametrize("name", ["example6", "example9"])
def test_kernel_matches_the_eager_twin_on_card(name, depth, baked):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the shade kernel is a CUDA kernel")
    from tools import shade_kernel_torch as skt

    cfg, got = _captured(name, baked)
    scene, params, hit, knee_vis, snap, draws = got[depth]
    n = hit.closest.shape[0]
    eager = pathtracer.PathState(**vars(snap))
    pathtracer.shade_depth_eager(cfg, scene, params, depth, hit, knee_vis,
                                 eager, *draws)
    kern = skt.own(snap)
    mask_in = kern.tracing
    shade_kernel.shade_depth(
        cfg, params, scene.mat_params, depth, hit, knee_vis, kern, *draws,
        pathtracer.center_transmittance(cfg, scene, params),
        pathtracer.mat_features(cfg))
    torch.cuda.synchronize()
    # the mask handed to B1 at this depth stays as it was
    assert kern.tracing is not mask_in
    assert torch.equal(mask_in, snap.tracing)
    assert 0 < int(snap.tracing.sum()) < n or depth == 0
    off, worst = skt.differ(eager, kern)
    assert int(off.sum()) <= n // 1000 and worst <= 1e-5, (int(off.sum()),
                                                             worst)
    dead = ~snap.tracing
    for (fname, a), (_, b) in zip(skt.fields(snap), skt.fields(kern)):
        assert torch.equal(skt.bits(a)[dead], skt.bits(b)[dead]), fname
