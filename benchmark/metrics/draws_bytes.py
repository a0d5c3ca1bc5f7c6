"""Kernel D's least bytes for one launch, from what the program counted
(its counter ``draws.lanes``: the lanes, with the slot count and whether the
sample keys come a lane as attributes) and ``voxelrt_torch/csrc/draws.cu``'s
argument layout.

Each input byte is counted once and each output byte once: a lane's pixel
(two float32, 8 B) and, where the keys come a lane, its sample key (two
int64, 16 B); each slot's uniform (float32, 4 B a lane). A key shared by
every lane is an argument of the launch and is read from no memory.
"""


def launch_bytes(lanes, slots, lane_keys):
    """The bytes of one launch of ``lanes`` lanes and ``slots`` slots."""
    return lanes * (8 + (16 if lane_keys else 0) + 4 * slots)
