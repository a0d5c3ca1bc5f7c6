"""A frozen copy of the port's ``voxelrt_torch/ops/tonemap.py``, taken when
the benchmark was defined, less what the plain reference does not call.

Tonemapping and display transform (renderer/math_utils.py:160-186,
renderer/pathtracer.py:634-662); the PyTorch port of voxelrt/ops/tonemap.py.
"""

from __future__ import annotations

import torch

from .sampling import smoothstep


def uchimura(x):
    """Uchimura 2017 'HDR theory and practice' (renderer/math_utils.py:163-186)."""
    P = 1.0  # max display brightness
    a = 1.0  # contrast
    m = 0.22  # linear section start
    l = 0.4  # linear section length
    c = 1.33  # black
    b = 0.0  # pedestal

    l0 = ((P - m) * l) / a
    S0 = m + l0
    S1 = m + a * l0
    C2 = (a * P) / (P - S1)
    CP = -C2 / P

    w0 = 1.0 - smoothstep(0.0, m, x)
    w2 = torch.where(x >= m + l0, 1.0, 0.0)  # ti.math.step
    w1 = 1.0 - w0 - w2

    T = m * torch.pow(torch.clamp(x, min=0.0) / m, c) + b
    S = P - (P - S1) * torch.exp(CP * (x - S0))
    L = m + a * (x - m)

    return T * w0 + L * w1 + S * w2


