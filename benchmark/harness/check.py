"""The comparison that decides ``correct`` for progressive stills.

Every still that the run rendered (the finished ones and the last,
unfinished one) is traced again by the plain reference
(``benchmark/reference``) for the checked pixels, from the scene the
example script defines, the seed and the chunks that went into the still;
then each pixel's HDR colour and tonemapped value are held against the
program's. A pixel's gaps are the worst of its channels:

* the HDR gap, |program - reference| over the reference's value or
  ``hdr_floor`` where that is larger;
* the tonemapped gap, |program - reference| (0 to 1).

A pixel whose HDR gap passes ``off_gap`` is a failed answer. Three numbers
are compared, each the worst over the stills of the run:

* ``hdr_mean_rel_gap``: the mean HDR gap of the checked pixels;
* ``ldr_mean_abs_gap``: the mean tonemapped gap;
* ``off_share``: the share of the checked pixels that failed.

Means and a share, not the worst pixel: a sound change of rounding flips
now and then a path's decision (a voxel edge, a lobe, the roulette), and
the one sample moves its pixel by as much as the control moves every
pixel. ``reference_stills`` with a ``dtype`` below float32 gives the
control: the reference with its samples' radiance, their mean and the blend
in that lower precision, to be put in the program's place.
"""

from __future__ import annotations

import os

import torch

NUMBERS = ("hdr_mean_rel_gap", "ldr_mean_abs_gap", "off_share")


def reference_stills(cell, seed, stills, pixels, device,
                     dtype=torch.float32):
    """The reference's (hdr, ldr) of ``pixels`` for each still, a list of
    its chunks' (key data, launches)."""
    from benchmark.harness.spec import ROOT
    from benchmark.reference import render, scene as rscene

    cfg_file, traffic = cell["config"], cell["traffic"]
    rec = rscene.record_example(rscene.examples_dir(ROOT),
                                cfg_file["example"])
    cfg = render.make_config(cfg_file["render_config"],
                             traffic["image_res"],
                             traffic["samples_per_launch"])
    cfg, sd, params = render.prepare(
        cfg, rec, os.path.join(ROOT, cfg_file["sky_dir"]), device)
    key = render.render_key(seed)
    pix = torch.as_tensor(pixels, dtype=torch.int64, device=device)
    keys = [[lk for key_data, n in chunks
             for lk in render.chunk_launch_keys(key, key_data, n)]
            for chunks in stills]
    out = render.render_stills(cfg, sd, params, rec.exposure, pix, keys,
                               dtype=dtype)
    return [(hdr.cpu(), ldr.cpu()) for hdr, ldr in out]


def gaps(prog, ref, hdr_floor):
    """Per pixel (hdr relative gap, ldr absolute gap), each the worst of
    its channels, of one still."""
    (ph, pl), (rh, rl) = prog, ref
    rel = ((ph - rh).abs() / rh.abs().clamp(min=hdr_floor)).amax(-1)
    ab = (pl - rl).abs().amax(-1)
    # a NaN in the program's answer is as wrong as an answer can be
    rel = torch.where(torch.isnan(rel), torch.inf, rel)
    ab = torch.where(torch.isnan(ab), torch.inf, ab)
    return rel, ab


def compare(outputs, refs, check):
    """({number: value}, attempted, failed) of a run's outputs, a list of
    (hdr, ldr) a still, against the reference's: each number the worst over
    the stills, every checked pixel of every still an answer."""
    worst = dict.fromkeys(NUMBERS, 0.0)
    attempted = failed = 0
    for out, ref in zip(outputs, refs, strict=True):
        rel, ab = gaps(out, ref, check["hdr_floor"])
        off = rel > check["off_gap"]
        attempted += rel.numel()
        failed += int(off.sum())
        for n, v in (("hdr_mean_rel_gap", rel.double().mean()),
                     ("ldr_mean_abs_gap", ab.double().mean()),
                     ("off_share", off.double().mean())):
            worst[n] = max(worst[n], float(v))
    return worst, attempted, failed


def judge(cell, seed, captured, device):
    """(correct, attempted, failed, checks) of what a run captured: the
    runner's ``pixels`` and ``stills``, a list of (chunks, hdr, ldr)."""
    check = cell["check"]
    stills = captured["stills"]
    refs = reference_stills(cell, seed, [c for c, _, _ in stills],
                            captured["pixels"], device)
    worst, attempted, failed = compare([(h, l) for _, h, l in stills],
                                       refs, check)
    limits = check["limits"]
    checks = {n: {"value": worst[n], "limit": limits[n]} for n in NUMBERS}
    correct = bool(stills) and all(worst[n] <= limits[n] for n in NUMBERS)
    return correct, attempted, failed, checks
