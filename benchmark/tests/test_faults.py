"""The comparison has to fail what is wrong. On the CPU at a tiny size:
the control (the reference computed in bfloat16, put in the program's
place) comes out as not correct, and so does a run driven through the
harness with the timed path broken underneath, once for each fault that a
still can have: a launch that returns its state unchanged; half of a
launch's samples left out, the mean taken over the rest; the answer altered
where it is produced, every sample's radiance made 1% brighter as it is
traced. (The exchange between chips is not a fault of these one-chip
cells.) A single pixel off is not among them: the comparison judges means
and a share over the checked pixels, since a sound change of rounding also
moves a pixel now and then by a flipped sample."""

import time

import pytest
import torch

from benchmark.harness import check, runner
from benchmark.harness.progressive_still import Run
from benchmark.tests.cells import cells_of_kind, tiny_cell

CELLS = cells_of_kind("progressive_still")


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = tiny_cell(name)
    run = Run(cell, 5, "cpu")
    run.setup()
    run.window(0.0)
    run.run_chunk()  # a finished still and a second one begun
    captured = run.close()
    pixels = captured["pixels"]
    stills = [c for c, _, _ in captured["stills"]]
    refs = check.reference_stills(cell, 5, stills, pixels, "cpu")
    prog, _, failed = check.compare(
        [(h, l) for _, h, l in captured["stills"]], refs, cell["check"])
    assert failed == 0 and prog == dict.fromkeys(check.NUMBERS, 0.0)
    ctrl = check.reference_stills(cell, 5, stills, pixels, "cpu",
                                  dtype=torch.bfloat16)
    worst, _, failed = check.compare(ctrl, refs, cell["check"])
    limits = cell["check"]["limits"]
    assert failed > 0
    assert any(worst[n] > limits[n] for n in check.NUMBERS), worst


def _unchanged(monkeypatch):
    from voxelrt_torch.render import pipeline

    monkeypatch.setattr(pipeline, "accumulate",
                        lambda cfg, scene, params, state, *a, **k: state)


def _half_the_samples(monkeypatch):
    """The second half of a launch's samples replaced by the first half:
    the launch's mean is the mean of the first half alone."""
    from voxelrt_torch.render import pipeline

    orig = pipeline.trace_sample

    def traced(cfg, *args, **kw):
        out = orig(cfg, *args, **kw)
        half = out["diffuse"].x.shape[0] // 2
        for key in ("diffuse", "specular"):
            for c in out[key]:
                c[half:] = c[:half]
        return out

    monkeypatch.setattr(pipeline, "trace_sample", traced)


def _altered_answer(monkeypatch):
    """Every sample's radiance made 1% brighter where it is traced."""
    from voxelrt_torch.render import pipeline

    orig = pipeline.trace_sample

    def traced(cfg, *args, **kw):
        out = orig(cfg, *args, **kw)
        for key in ("diffuse", "specular"):
            for c in out[key]:
                c.mul_(1.01)
        return out

    monkeypatch.setattr(pipeline, "trace_sample", traced)


FAULTS = {"state_unchanged": _unchanged, "half_the_samples": _half_the_samples,
          "altered_answer": _altered_answer}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    cell = tiny_cell(name)
    FAULTS[fault](monkeypatch)
    result, lines = runner.run(cell, 2 ** 32 + 11, 0.0, False, "cpu",
                               time.perf_counter())
    assert result["correct"] is False, lines
    assert result["failed"] > 0
