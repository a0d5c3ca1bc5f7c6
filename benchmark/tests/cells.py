"""Cells at a size a CPU test can hold."""

import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def tiny_cell(name, **traffic):
    """The cell ``name`` at a size a CPU test can hold: 64x32 pixels, 4
    samples a launch, 8-sample chunks, a new still every 16, every pixel
    checked."""
    from benchmark.harness import spec

    cell = spec.cell(name)
    t = dict(cell["traffic"], image_res=[64, 32], samples_per_launch=4,
             chunk_spp=8, reset_spp=16)
    t.update(traffic)
    cell["traffic"] = t
    cell["check"] = dict(cell["check"], pixels=64 * 32)
    return cell
