"""setup_s: wall seconds from the start of the process (before ``import
torch``) to the first timed launch: CUDA start-up, the kernels' build or
load, ``build_example`` and ``prepare_data``, and the warm-up (end to end,
host clock)."""


def read(rec):
    return rec["setup"].get("setup_s")
