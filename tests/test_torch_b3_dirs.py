"""PyTorch port, kernel B3 at directions: ``bilinear_fetch_dirs`` (one sky
map) and ``bilinear_fetch_dirs2`` (both maps from their interleaved table),
which fold the sky's projection into the kernel.

- Their plain twins are bitwise equal to the eager composition that the sky
  fetches ran before the kernel took the projection over (jitter,
  ``project_sky_soa``, ``* res - 0.5``, then B3's plain twin on each map),
  on directions that include both poles, x = z = 0, the azimuth seam, NaN
  and infinite components, with and without the jitter: on the CPU a port
  image stays what it was bit for bit.
- The port's bilinear escape fetch agrees with the JAX package's (Pallas
  in interpret mode) at the bars of ``tests/test_torch_ops.py``: every
  lane within 1e-3, 98% within 1e-5 (see there); that file holds the
  transmittance lookup at those bars.
- The interleaved table's layout, and the same table from ``make_sky`` and
  ``interop.sky_from_jax_arrays``.

``tests/test_torch_ops.py::test_b2_b3_kernels_match_twins_on_card`` holds
each kernel against its twin on a card, int32 bits, on these edge-case
directions too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelrt.config import RenderConfig as JCfg
from voxelrt.ops import texfetch as jtf
from voxelrt.ops.v3 import V3 as JV3
from voxelrt.sky import atmos as jatmos

from voxelrt_torch import interop
from voxelrt_torch.config import RenderConfig as TCfg
from voxelrt_torch.ops import texfetch as ttf
from voxelrt_torch.ops.v3 import V3 as TV3
from voxelrt_torch.ops.v3 import vnormalize
from voxelrt_torch.sky import atmos as tatmos

# One thread per test process: the suite runs several processes side by
# side, and the tensors here are small.
torch.set_num_threads(1)

RES = 64
PI = 3.141592653589793


def _map(rng):
    img = rng.random((RES, RES, 3)).astype(np.float32)
    return img, ttf.pack_rgb_bf16(img)


def _edge_dirs():
    """Directions where the projection's branches meet: both poles with
    every sign of zero, x = z = 0 off the poles, the azimuth seam (x = ±0
    and tiny x with z > 0), NaN and ±inf in each component, the zero
    vector, and lengths far from 1."""
    out = []
    for sx in (0.0, -0.0):
        for sz in (0.0, -0.0):
            for y in (1.0, -1.0, 0.5, -0.5, 0.0, -0.0):
                out.append((sx, y, sz))
    for x in (0.0, -0.0, 1e-30, -1e-30, 1e-45):
        for z in (0.7, -0.7):
            out.append((x, 0.3, z))
    for c in range(3):
        for v in (np.nan, np.inf, -np.inf):
            d = [0.3, 0.4, 0.5]
            d[c] = v
            out.append(tuple(d))
    out += [(0.0, 0.0, 0.0), (1e20, 1.0, 1.0), (1e-20, 1e-20, 1e-20),
            (3e38, 3e38, 3e38)]
    return np.array(out, np.float32)


def _dirs(rng, n=2048):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    e = _edge_dirs()
    d[: len(e)] = e
    u = rng.random((n, 3)).astype(np.float32)
    u[len(e): len(e) + 3] = [np.nan, np.inf, -np.inf]
    return d, u


def _tv3(a):
    """(N, 3) numpy -> V3 of strided column views, as the path holds them."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return TV3(t[:, 0], t[:, 1], t[:, 2])


def _words(w):
    return torch.from_numpy(w.view(np.int32).copy())


def _replaced(words, d, res, u3=None):
    """The eager fetch the sky module ran before the direction entries:
    atmos.sample_skybox's jitter (sampling.normalize) and
    atmos.project_sky_soa written out, then B3's plain twin."""
    if u3 is not None:
        d = vnormalize(d + u3 * 0.0015)
    fres = 1.0 / res
    inv = torch.rsqrt(torch.clamp(d.x * d.x + d.z * d.z, min=1e-20))
    azimuth = PI + torch.atan2(d.x * inv, -(d.z * inv))
    elevation = PI * 0.5 - torch.acos(torch.clamp(d.y, -1.0, 1.0))
    cx = azimuth / (2.0 * PI)
    cy = 0.5 + 0.5 * torch.sign(elevation) * torch.sqrt(
        2.0 / PI * torch.abs(elevation))
    su = cx * (1.0 - fres) + 0.5 * fres
    sv = cy * (1.0 - fres) + 0.5 * fres
    return ttf.bilinear_fetch_packed_plain(
        words, (su * res - 0.5).contiguous(), (sv * res - 0.5).contiguous(),
        res)


def _bits_equal(a, b):
    np.testing.assert_array_equal(a.contiguous().view(torch.int32).numpy(),
                                  b.contiguous().view(torch.int32).numpy())


@pytest.mark.parametrize("jitter", [False, True], ids=["plain", "jittered"])
def test_dirs_twin_is_the_replaced_composition(jitter):
    rng = np.random.default_rng(11 + jitter)
    _, w = _map(rng)
    d, u = _dirs(rng)
    words = _words(w)
    u3 = _tv3(u) if jitter else None
    want = _replaced(words, _tv3(d), RES, u3)
    _bits_equal(ttf.bilinear_fetch_dirs_plain(words, _tv3(d), RES, u3), want)
    # the wrapper takes the twin for CPU tensors
    _bits_equal(ttf.bilinear_fetch_dirs(words, _tv3(d), RES, u3), want)


def test_dirs2_twin_is_the_replaced_composition():
    rng = np.random.default_rng(13)
    _, ws = _map(rng)
    _, wt = _map(rng)
    d, u = _dirs(rng)
    s, t = _words(ws), _words(wt)
    want_s = _replaced(s, _tv3(d), RES, _tv3(u))
    want_t = _replaced(t, _tv3(d), RES, _tv3(u))
    got = ttf.bilinear_fetch_dirs2_plain(s, t, _tv3(d), RES, _tv3(u))
    _bits_equal(got[0], want_s)
    _bits_equal(got[1], want_t)
    got = ttf.bilinear_fetch_dirs2(s, t, ttf.interleave_words(s, t), _tv3(d),
                                   RES, _tv3(u))
    _bits_equal(got[0], want_s)
    _bits_equal(got[1], want_t)


def test_sky_fetches_route_through_direction_entries(monkeypatch):
    """The sky module's bilinear fetches reach B3 through the direction
    entries only, and give the replaced composition's bits; a one-lane view
    of a (1, 3) tensor (the cone centre) included."""
    rng = np.random.default_rng(14)
    scatt, _ = _map(rng)
    trans, _ = _map(rng)
    sky = tatmos.make_sky(scatt, trans, np.zeros(3), np.zeros((1, 1, 3)),
                          "cpu")
    cfg = TCfg(skybox_res=RES, use_physical_sky=True, sky_fetch="bilinear")
    d, u = _dirs(rng)
    calls = []
    for mod, name in ((tatmos, "bilinear_fetch_dirs"),
                      (tatmos, "bilinear_fetch_dirs2"),
                      (ttf, "bilinear_fetch_packed")):
        orig = getattr(mod, name)

        def spy(*a, _name=name, _orig=orig, **k):
            calls.append(_name)
            return _orig(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    s, t = tatmos.sample_skybox(cfg, sky, _tv3(d), _tv3(u))
    _bits_equal(torch.stack(list(s), -1),
                _replaced(sky.packed_scatt, _tv3(d), RES, _tv3(u)))
    _bits_equal(torch.stack(list(t), -1),
                _replaced(sky.packed_trans, _tv3(d), RES, _tv3(u)))
    s_only, none = tatmos.sample_skybox(cfg, sky, _tv3(d), _tv3(u),
                                        want_trans=False)
    assert none is None
    _bits_equal(torch.stack(list(s_only), -1), torch.stack(list(s), -1))
    one = torch.tensor([[0.3, 0.8, -0.2]])
    d1 = TV3(one[..., 0], one[..., 1], one[..., 2])
    tr = tatmos.sample_skybox_transmittance(cfg, sky, d1)
    _bits_equal(torch.stack(list(tr), -1), _replaced(sky.packed_trans, d1,
                                                     RES))
    assert calls == ["bilinear_fetch_dirs2", "bilinear_fetch_dirs",
                     "bilinear_fetch_dirs"]


def _jax_both(rng, n):
    scatt, ws = _map(rng)
    trans, wt = _map(rng)
    jsky = jatmos.SkyData(jnp.asarray(scatt), jnp.asarray(trans),
                          jnp.zeros(3), jnp.zeros((1, 1, 3)), jnp.asarray(ws),
                          jnp.asarray(wt))
    tsky = tatmos.make_sky(scatt, trans, np.zeros(3), np.zeros((1, 1, 3)),
                           "cpu")
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:2] = [(0.0, 1.0, 0.0), (0.0, -1.0, 0.0)]
    u = rng.random((n, 3)).astype(np.float32)
    jd = JV3(*(jnp.asarray(d[:, i]) for i in range(3)))
    ju = JV3(*(jnp.asarray(u[:, i]) for i in range(3)))
    return jsky, tsky, jd, ju, _tv3(d), _tv3(u)


def _held(j, t, share=0.99):
    """Every lane within 1e-3 relative, ``share`` of them within 1e-5 (a
    last-ulp projection difference, acos/atan2 near the poles, times a
    random map's texel-to-texel gradient; tests/test_torch_ops.py's bars)."""
    tight = np.ones(np.asarray(j[0]).shape, bool)
    for a, b in zip(j, t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-3,
                                   atol=1e-6)
        tight &= np.isclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)
    assert tight.mean() > share, tight.mean()


def test_bilinear_escape_fetch_matches_jax():
    rng = np.random.default_rng(15)
    jsky, tsky, jd, ju, td, tu = _jax_both(rng, 2048)
    jcfg = JCfg(skybox_res=RES, use_physical_sky=True, use_pallas_dda=True,
                pallas_interpret=True, sky_fetch="bilinear")
    tcfg = TCfg(skybox_res=RES, use_physical_sky=True, sky_fetch="bilinear")
    js, jt = jatmos.sample_skybox(jcfg, jsky, jd, ju, scattered=True)
    ts, tt = tatmos.sample_skybox(tcfg, tsky, td, tu)
    # The jitter's normalisation adds a source of last-bit differences: XLA's
    # CPU rsqrt is not torch's, and 31% of the jittered components differ in
    # their last bit. 98.5-99.3% of lanes lie within 1e-5 over four seeds
    # (99.2% at this one), so the tight bar here is 98%.
    _held(js, ts, 0.98)
    _held(jt, tt, 0.98)


def test_interleaved_table_layout():
    rng = np.random.default_rng(17)
    _, ws = _map(rng)
    _, wt = _map(rng)
    s, t = _words(ws), _words(wt)
    st = ttf.interleave_words(s, t)
    assert st.dtype == torch.int32 and st.shape == (2 * s.shape[0],)
    rec = st.view(-1, 4)
    _bits_equal(rec[:, :2].reshape(-1), s)
    _bits_equal(rec[:, 2:].reshape(-1), t)
    with pytest.raises(ValueError):
        ttf.interleave_words(s, t[:-2])


@pytest.mark.parametrize("with_words", [True, False],
                         ids=["jax_words", "maps_only"])
def test_make_sky_and_interop_give_the_same_table(with_words):
    rng = np.random.default_rng(18)
    scatt, ws = _map(rng)
    trans, wt = _map(rng)
    made = tatmos.make_sky(scatt, trans, np.zeros(3), np.zeros((1, 1, 3)),
                           "cpu")
    fields = dict(skybox_scattering=scatt, skybox_transmittance=trans,
                  cloud_ambient=np.zeros(3), trans_lut=np.zeros((1, 1, 3)),
                  packed_scatt=np.asarray(jtf.pack_rgb_bf16(scatt))
                  if with_words else None,
                  packed_trans=np.asarray(jtf.pack_rgb_bf16(trans))
                  if with_words else None)
    got = interop.sky_from_jax_arrays(fields, "cpu")
    for f in ("packed_scatt", "packed_trans", "packed_st"):
        _bits_equal(getattr(got, f), getattr(made, f))
    _bits_equal(made.packed_st, ttf.interleave_words(_words(ws), _words(wt)))
