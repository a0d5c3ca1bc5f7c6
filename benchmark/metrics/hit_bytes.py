"""Kernel H's least bytes for one launch, from what the program counted
(its counter ``hit.lanes``: the lanes, with the stage and whether B1 takes
in-kernel NEE as attributes; B1's ``b1.alive`` of the same dispatch: the
lanes that trace) and ``voxelrt_torch/csrc/hit.cu``'s argument layout.

Each byte a lane needs is counted once in the launch that needs it:

* ``prepare``: every lane's mask (1 B); for a lane that traces, its
  position and direction (24 B) and B1's inputs written: the grid-space
  origin (12 B), tmax (4 B) and, with NEE, the floor crossing (4 B);
* ``merge``: every lane's mask and its Hit written (closest 4 B, normal and
  albedo 12 B each, the emissive flag 1 B, the material id 4 B); for a lane
  that traces, its position and direction (24 B) and B1's distance, cell,
  normal and colour word (32 B).

A lane that does not trace needs none of its rays' or B1's values, so they
are not counted for it.
"""

HIT_BYTES = 4 + 12 + 12 + 1 + 4


def launch_bytes(lanes, alive, stage, nee):
    """The bytes of one launch of ``stage`` ('prepare' or 'merge') over
    ``lanes`` lanes, ``alive`` of them tracing."""
    if stage == "prepare":
        return lanes + alive * (24 + 12 + 4 + (4 if nee else 0))
    return lanes * (1 + HIT_BYTES) + alive * (24 + 32)
