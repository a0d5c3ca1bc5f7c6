"""Cells at a size a CPU test can hold."""

import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cells_of_kind(kind):
    """The names of ``BENCHMARK.json``'s workloads whose traffic is of
    ``kind``, in the order the file lists them: a cell added as an entry
    and data files is tested with no edit here."""
    from benchmark.harness import spec

    bench = spec.benchmark()
    return [w["name"] for w in bench["workloads"]
            if spec.cell(w["name"], bench)["traffic"]["kind"] == kind]


def tiny_cell(name, **traffic):
    """The cell ``name`` at a size a CPU test can hold: 64x32 pixels, the
    cell's own samples a launch up to 4, 8-sample chunks, a new still every
    16, every pixel checked."""
    from benchmark.harness import spec

    cell = spec.cell(name)
    k = min(int(cell["traffic"]["samples_per_launch"]), 4)
    t = dict(cell["traffic"], image_res=[64, 32], samples_per_launch=k,
             chunk_spp=8, reset_spp=16)
    t.update(traffic)
    cell["traffic"] = t
    cell["check"] = dict(cell["check"], pixels=64 * 32)
    return cell
