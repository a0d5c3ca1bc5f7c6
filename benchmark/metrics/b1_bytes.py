"""B1's least bytes for one dispatch, from what the dispatch was handed (the
bytes side of the program's ``tools/torch_measure.py`` ``b1_bound_ms``,
copied here so that the yardstick stays as it is).

Each input byte is counted once and each output byte once, whatever the
kernel reads again: the alive mask for every ray; origin and direction (24
B), a per-ray tmax (4 B) and the NEE inputs u0, u1 and the floor crossing
(12 B) only for the alive rays, since a dead ray reads nothing more; tmin
(4 B) and the 12 NEE scalars (48 B) once; the tables once; every output
once for every ray: in shadow mode the distance alone (4 B), else the
distance, cell, normal, advances, colour word and active flag (40 B) and
with NEE the verdict (4 B). The lists and the shadow rays that B1's passes
hand each other are the kernel's own traffic and are not counted. The
operations side of ``b1_bound_ms`` is left out: it multiplies B1's own
advance count, which moves with B1's implementation.
"""


def dispatch_bytes(n, n_alive, mask_bytes, tmax_per_ray, nee, any_hit,
                   table_bytes):
    """The bytes of one dispatch of ``n`` rays, ``n_alive`` of them alive;
    ``mask_bytes``: the alive mask's bytes a ray (0 without a mask)."""
    per_alive = 4 * 6 + (4 if tmax_per_ray else 0) + (4 * 3 if nee else 0)
    out_per_ray = 4 * (1 if any_hit else 10 + (1 if nee else 0))
    return (n * mask_bytes + n_alive * per_alive + n * out_per_ray + 4
            + (48 if nee else 0) + table_bytes)
