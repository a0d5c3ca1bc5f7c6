"""The benchmark of the PyTorch/CUDA port, ``voxelrt_torch``; run a cell
with ``python3 benchmark/run.py --workload NAME --seed N --seconds S
--trace 0|1`` from the repo root."""
