"""PyTorch port, kernel B4 (temporal resample): ``ops/resample`` and
``render/temporal._moving_taps`` against the JAX package on the inputs of
tests/test_resample.py (64x48 at render scale 0.5, seed 5), for both tap
filters and both passes (depth gate without extra = diffuse, extra without
depth gate = specular).

The JAX side runs its Pallas kernel in interpret mode; the port runs the
kernel's plain twin on the CPU. Tolerances: the packed bf16 words are exact.
Twin against Pallas kernel, and gather path against gather path, share their
sources and their arithmetic, so outputs agree to rtol 1e-5 / atol 1e-6 on
at least 99.5% of pixels; the rest is a normal or depth gate flipped by a
last-bit difference (``rsqrt``, a division), which moves a pixel by a whole
tap weight. Twin against the port's own gather path differs by the bf16
quantisation of the sources: the bars of tests/test_resample.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_resample import _Params, _setup

from voxelrt.config import RenderConfig as JCfg
from voxelrt.ops import resample as jrs
from voxelrt.render import temporal as jtemporal

from voxelrt_torch.config import RenderConfig as TCfg
from voxelrt_torch.ops import _cuda
from voxelrt_torch.ops import resample as trs
from voxelrt_torch.render import temporal as ttemporal

# One thread per test process: the suite runs several processes side by
# side, and the tensors here are small.
torch.set_num_threads(1)

VARIANTS = [(f, g, e) for f in ("bilinear", "catmullrom")
            for g, e in ((True, False), (False, True))]
IDS = [f"{f}-{'diffuse' if g else 'specular'}" for f, g, e in VARIANTS]


class _TParams:
    proj_inv = torch.tensor(np.asarray(_Params.proj_inv))


def _t(x):
    return torch.tensor(np.asarray(x))


def _run_jax(mode, filt, gate_depth, extra_on):
    cfg = JCfg(image_res=(64, 48), use_pallas_dda=True, pallas_interpret=True,
               motion_resample=mode, motion_filter=filt)
    color, history, gbuffer, tx, rp, cd, cn, sd = _setup(5)
    return jtemporal._moving_taps(cfg, _Params, color, history, gbuffer, tx,
                                  rp, cd, cn, 0.5, gate_depth=gate_depth,
                                  extra=(sd if extra_on else None))


def _run_torch(mode, filt, gate_depth, extra_on):
    cfg = TCfg(image_res=(64, 48), motion_resample=mode, motion_filter=filt)
    color, history, gbuffer, tx, rp, cd, cn, sd = _setup(5)
    gb = {k: _t(v) for k, v in gbuffer.items()}
    return ttemporal._moving_taps(cfg, _TParams, _t(color), _t(history), gb,
                                  _t(tx), _t(rp), _t(cd), _t(cn), 0.5,
                                  gate_depth=gate_depth,
                                  extra=(_t(sd) if extra_on else None))


def _outside(a, b, rtol, atol):
    """Share of pixels with any component outside the tolerance."""
    a, b = np.asarray(a), np.asarray(b)
    bad = ~np.isclose(a, b, rtol=rtol, atol=atol)
    if bad.ndim == 3:
        bad = bad.any(-1)
    return float(bad.mean())


def _hold(t_out, j_out, extra_on, rtol, atol, max_frac, label):
    names = ("current", "w_sum", "hist", "extra")
    for name, a, b in zip(names, t_out, j_out):
        if name == "extra" and not extra_on:
            assert a is None and b is None
            continue
        frac = _outside(a.numpy(), b, rtol, atol)
        assert frac <= max_frac, f"{label} {name}: {frac:.3%} outside"


def test_pack2_bf16_words_exact():
    rng = np.random.default_rng(0)
    a = (rng.normal(size=4096) * 10.0 ** rng.integers(-30, 30, 4096)).astype(
        np.float32)
    b = rng.normal(size=4096).astype(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan,
                        3.4028235e38, -3.4028235e38, 1e-45, -1e-45,
                        1.0039062, 1.0117188, -1.0039062, 65280.0],
                       np.float32)
    # every bit pattern near the rounding carry into the sign bit as well
    carry = np.array([0x7F7FFFFF, 0x7FFFFFFF, 0xFFFFFFFF, 0xFFFF8000,
                      0x7FFF7FFF, 0x00008000, 0x00018000, 0x80008000],
                     np.uint32).view(np.float32)
    a[:len(special)] = special
    b[:len(special)] = special[::-1]
    a[100:100 + len(carry)] = carry
    b[200:200 + len(carry)] = carry
    want = np.asarray(jrs.pack2_bf16(jnp.asarray(a), jnp.asarray(b)))
    got = trs.pack2_bf16(torch.tensor(a), torch.tensor(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


def test_moving_transforms_and_packing_match_jax():
    """The packed-image forms the moving filters add: transforms to rtol
    1e-6 (explicit multiply-adds in the same order; a division's last bit),
    the octahedral encode and the material-word decode exactly."""
    from voxelrt.camera import look_at_matrix, perspective_matrix
    from voxelrt.ops import packing as jpack, transforms as jtr
    from voxelrt_torch.ops import packing as tpack, transforms as ttr

    rng = np.random.default_rng(2)
    proj = np.asarray(perspective_matrix(0.9, 16 / 9, 0.01, 10.0), np.float32)
    view = np.asarray(look_at_matrix((0.4, 0.5, 2.0), (0, 0, 0), (0, 1, 0)),
                      np.float32)
    pos = (rng.normal(size=(16, 8, 3)) * 0.5).astype(np.float32)
    lin = np.concatenate([[0.0], -rng.random(127) * 9.0 - 0.02]).astype(
        np.float32).reshape(16, 8)
    jv = jtr.world_to_view(jnp.asarray(pos), jnp.asarray(view))
    tv = ttr.world_to_view(_t(pos), _t(view))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(
        ttr.view_to_screen(tv, _t(proj)).numpy(),
        np.asarray(jtr.view_to_screen(jv, jnp.asarray(proj))), rtol=1e-6,
        atol=1e-7)
    np.testing.assert_allclose(
        ttr.delinearize_depth(_t(lin), _t(proj)).numpy(),
        np.asarray(jtr.delinearize_depth(jnp.asarray(lin),
                                         jnp.asarray(proj))), rtol=1e-6)
    nrm = rng.normal(size=(16, 8, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    enc = tpack.encode_unit_vector_3x16(_t(nrm))
    assert enc.dtype == torch.float16 and enc.shape == (16, 8, 2)
    want = np.asarray(jpack.encode_unit_vector_3x16(jnp.asarray(nrm)))
    assert (enc.numpy() == want).mean() >= 0.99
    words = rng.integers(0, 2 ** 32, size=(16, 8), dtype=np.uint64)
    tm, ta = tpack.decode_material_word(_t(words.astype(np.int64)))
    jm, ja = jpack.decode_material_word(jnp.asarray(words.astype(np.uint32)))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


@pytest.mark.parametrize("filt,gate_depth,extra_on", VARIANTS, ids=IDS)
def test_twin_matches_pallas_kernel(filt, gate_depth, extra_on):
    t_out = _run_torch("pallas", filt, gate_depth, extra_on)
    j_out = _run_jax("pallas", filt, gate_depth, extra_on)
    _hold(t_out, j_out, extra_on, 1e-5, 1e-6, 0.005, "twin vs pallas")


@pytest.mark.parametrize("filt,gate_depth,extra_on", VARIANTS, ids=IDS)
def test_gather_path_matches_jax(filt, gate_depth, extra_on):
    t_out = _run_torch("xla", filt, gate_depth, extra_on)
    j_out = _run_jax("xla", filt, gate_depth, extra_on)
    _hold(t_out, j_out, extra_on, 1e-5, 1e-6, 0.005, "gather vs gather")


@pytest.mark.parametrize("filt,gate_depth,extra_on", VARIANTS, ids=IDS)
def test_twin_matches_gather_path_within_bf16(filt, gate_depth, extra_on):
    cur_p, ws_p, hist_p, ex_p = _run_torch("pallas", filt, gate_depth,
                                           extra_on)
    cur_x, ws_x, hist_x, ex_x = _run_torch("xla", filt, gate_depth, extra_on)

    def close(a, b, rtol, atol, name):
        frac = float((~np.isclose(a.numpy(), b.numpy(), rtol=rtol,
                                  atol=atol)).mean())
        assert frac <= 0.01, f"{name}: {frac:.2%} outside tolerance"

    close(ws_p, ws_x, 1e-5, 1e-3, "w_sum")
    close(cur_p, cur_x, 0.01, 0.02, "current")
    close(hist_p, hist_x, 0.01, 0.03, "hist")
    if extra_on:
        close(ex_p, ex_x, 0.01, 0.05, "extra")


def test_dispatch_rule_follows_config_not_device():
    """Above the texel limit, and for motion_resample='xla', the gather path
    runs; the kernel path otherwise. The wrapper is reached exactly then."""
    calls = []
    orig = ttemporal.temporal_taps

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    ttemporal.temporal_taps = spy
    try:
        _run_torch("pallas", "bilinear", True, False)
        assert len(calls) == 1
        _run_torch("xla", "bilinear", True, False)
        assert len(calls) == 1
        saved = trs.MAX_TEXELS
        trs.MAX_TEXELS = 32 * 24 - 1
        try:
            _run_torch("pallas", "bilinear", True, False)
        finally:
            trs.MAX_TEXELS = saved
        assert len(calls) == 1
    finally:
        ttemporal.temporal_taps = orig
    assert trs.MAX_TEXELS == jrs.MAX_TEXELS == 530_000
    # the CPU path launches no kernel
    assert _cuda.LAUNCHES["temporal_taps"] == 0


def test_no_in_bounds_tap_clamps_to_floor():
    """A pixel whose taps are all out of bounds (or whose history coords are
    not finite) has lo > hi in the clamp: the result is (0, 0, 0, 1) and an
    extra of 0, with w_sum 0, in the twin as in the Pallas kernel."""
    n = 8 * 8
    rng = np.random.default_rng(1)
    cur = rng.random((2, n)).astype(np.float32).view(np.int32)
    hist = rng.random((2, n)).astype(np.float32).view(np.int32)
    pn = rng.random(n).astype(np.float32).view(np.int32)
    ex = rng.random(n).astype(np.float32)
    m = 6
    fxc = np.linspace(0.0, 7.0, m).astype(np.float32)
    fyc = np.linspace(7.0, 0.0, m).astype(np.float32)
    fxh = np.array([np.nan, np.inf, -np.inf, -50.0, 1e9, 3.0], np.float32)
    fyh = np.array([3.0, 3.0, 3.0, 3.0, 3.0, 400.0], np.float32)
    cd = np.ones(m, np.float32)
    cn = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (m, 1))
    for cat in (False, True):
        cur_t, ws_t, hist_t, ex_t = trs.temporal_taps(
            _t(cur), _t(hist), _t(pn), None, _t(ex), _t(fxc), _t(fyc),
            _t(fxh), _t(fyh), _t(cd), _t(cn), 8, 8, cat, False)
        cur_j, ws_j, hist_j, ex_j = jrs.temporal_taps(
            jnp.asarray(cur), jnp.asarray(hist), jnp.asarray(pn), None,
            jnp.asarray(ex), jnp.asarray(fxc), jnp.asarray(fyc),
            jnp.asarray(fxh), jnp.asarray(fyh), jnp.asarray(cd),
            jnp.asarray(cn), ires_x=8, ires_y=8, catmullrom=cat,
            gate_depth=False, interpret=True)
        assert (ws_t.numpy() == 0.0).all()
        np.testing.assert_array_equal(
            hist_t.numpy(), np.tile([[0.0, 0.0, 0.0, 1.0]], (m, 1)))
        assert (ex_t.numpy() == 0.0).all()
        np.testing.assert_array_equal(hist_t.numpy(), np.asarray(hist_j))
        np.testing.assert_array_equal(ex_t.numpy(), np.asarray(ex_j))
        np.testing.assert_allclose(cur_t.numpy(), np.asarray(cur_j),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("filt,gate_depth,extra_on", VARIANTS, ids=IDS)
def test_cuda_kernel_matches_twin(filt, gate_depth, extra_on):
    """On a CUDA card: the hand-written kernel against its twin on the same
    device, same inputs. Both run the same float32 operations in the same
    order (the kernel is built without multiply-add contraction), so at
    least 99.9% of lanes agree to 1e-6 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    color, history, gbuffer, tx, rp, cd, cn, sd = _setup(5)
    cfg = TCfg(image_res=(64, 48), motion_filter=filt)
    gb = {k: _t(v).to(dev) for k, v in gbuffer.items()}
    seen = []
    orig = ttemporal.temporal_taps

    def spy(*a, **k):
        seen.append((a, k))
        return orig(*a, **k)

    ttemporal.temporal_taps = spy
    before = _cuda.LAUNCHES["temporal_taps"]
    try:
        k_out = ttemporal._moving_taps(
            cfg, dataclasses.make_dataclass("P", ["proj_inv"])(
                _TParams.proj_inv.to(dev)),
            _t(color).to(dev), _t(history).to(dev), gb, _t(tx).to(dev),
            _t(rp).to(dev), _t(cd).to(dev), _t(cn).to(dev), 0.5,
            gate_depth=gate_depth,
            extra=(_t(sd).to(dev) if extra_on else None))
    finally:
        ttemporal.temporal_taps = orig
    assert _cuda.LAUNCHES["temporal_taps"] == before + 1
    a, k = seen[0]
    p_out = trs.temporal_taps_plain(*a, k["ires_x"], k["ires_y"],
                                    k["catmullrom"], k["gate_depth"])
    shapes = ((64, 48, 3), (64, 48), (64, 48, 4), (64, 48))
    for kk, pp, shp in zip(k_out, p_out, shapes):
        if kk is None:
            assert pp is None
            continue
        frac = _outside(kk.cpu().numpy(), pp.reshape(shp).cpu().numpy(),
                        1e-6, 1e-9)
        assert frac <= 0.001, frac
