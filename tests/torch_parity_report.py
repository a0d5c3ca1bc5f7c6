"""Print how far the PyTorch port's CPU path is from the JAX package on the
inputs of tests/test_torch_render.py (production_test_config: 64x32
pixels, 32^3 grid, 64^2 sky, Pallas kernels in interpret mode), of
tests/test_torch_resample.py (kernel B4's twin and the gather path, 64x48 at
render scale 0.5) and of tests/test_torch_frames.py (``Scene.run_frames``
over 3 moving and 2 still frames). The tests hold these figures to their
bars; this script reports the figures.

    JAX_PLATFORMS=cpu python tests/torch_parity_report.py
"""

import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from test_torch_render import _pack, build_both  # noqa: E402

from voxelrt.render import pathtracer as jpt  # noqa: E402
from voxelrt.render import pipeline as jpl  # noqa: E402
from voxelrt_torch.ops import prng  # noqa: E402
from voxelrt_torch.render import pathtracer as tpt  # noqa: E402
from voxelrt_torch.render import pipeline as tpl  # noqa: E402


def gap(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return dict(rmse=float(np.sqrt(np.mean((a - b) ** 2))),
                max_abs=float(np.abs(a - b).max()))


def main():
    cfg, sd, p, tcfg, tsd, tp = build_both()
    out = {}
    u, v = jpl._pixel_grid(*cfg.image_res)
    jo = jax.jit(jpt.trace_sample, static_argnums=(0, 6, 7))(
        cfg, sd, p, jax.random.PRNGKey(3), u, v, False, 1.0)
    tc1 = dataclasses.replace(tcfg, samples_per_launch=1)
    tu, tv, _ = tpl.wavefront_constants(tc1, 1.0, "cpu")
    skeys, jit = tpl.sample_keys_of(prng.key(3), 1)
    to = tpt.trace_sample(tcfg, tsd, tp, tu, tv, skeys[0],
                          (jit[0][0], jit[0][1]))
    for name in ("diffuse", "specular"):
        a, b = _pack(jo[name]), torch.stack(list(to[name]), -1).numpy()
        out[f"trace_sample {name}"] = dict(
            agree_1e4=float(np.isclose(b, a, rtol=1e-4, atol=1e-6)
                            .all(-1).mean()),
            bit_equal=float((a == b).all(-1).mean()), **gap(a, b))
    for spl in (1, 4):
        jc = dataclasses.replace(cfg, samples_per_launch=spl)
        tc = dataclasses.replace(tcfg, samples_per_launch=spl)
        st = jpl.accumulate_n(jc, sd, p, jpl.init_state(jc),
                              jax.random.PRNGKey(5), False, 1.0, 2 * spl)
        jimg = jpl.fetch_image(jc, st, jnp.float32(2.0), 1.0)
        ts = tpl.accumulate_n(tc, tsd, tp, tpl.init_state(tc, "cpu"),
                              prng.key(5), False, 1.0, 2 * spl)
        out[f"accumulate_n image, spl {spl}"] = gap(
            jimg, tpl.fetch_image(tc, ts, 2.0).numpy())
    out.update(moving_gaps())
    for k, val in out.items():
        print(k, json.dumps(val))


def moving_gaps():
    """B4's twin and the gather path against the JAX package per variant
    (share of pixels outside rtol 1e-5 / atol 1e-6, per output), and the
    run_frames images per frame (share of pixels beyond 2e-3, RMSE)."""
    import test_torch_frames as tf
    import test_torch_resample as tr

    out = {}
    for mode, label in (("pallas", "B4 twin vs Pallas kernel"),
                        ("xla", "gather path vs JAX gather path")):
        for (filt, gate, extra), vid in zip(tr.VARIANTS, tr.IDS):
            t_out = tr._run_torch(mode, filt, gate, extra)
            j_out = tr._run_jax(mode, filt, gate, extra)
            out[f"{label}, {vid}"] = {
                name: tr._outside(a.numpy(), b, 1e-5, 1e-6)
                for name, a, b in zip(("current", "w_sum", "hist", "extra"),
                                      t_out, j_out) if a is not None}
    jc, tc = tf._cfgs()
    with open(os.devnull, "w") as null:
        jimgs, _ = tf._run(tf._build(tf.JScene(config=jc, quiet=True)),
                           tf.JFrameStats(out=null))
        timgs, _ = tf._run(tf._build(tf.TScene(config=tc, quiet=True,
                                               device="cpu")),
                           tf.FrameStats(out=null))
    for i, (a, b) in enumerate(zip(timgs, jimgs)):
        out[f"run_frames frame {i} ({'moving' if tf.MOVING[i] else 'still'})"
            ] = dict(beyond_2e3=float((np.abs(a - b) > 2e-3).any(-1).mean()),
                     **gap(a, b))
    return out


if __name__ == "__main__":
    main()
