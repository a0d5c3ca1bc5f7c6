"""PyTorch port: the golden images of the four example scenes that take
longest on the CPU (example6, example7 and example10 with their physical
sky, and example9), through the port; the other seven and the bars are in
tests/test_torch_examples.py."""

import pytest

from test_torch_examples import LARGE, check_example_golden

import torch  # noqa: E402

# One thread per test process: the suite runs several processes side by
# side, and the tensors here are small.
torch.set_num_threads(1)


@pytest.mark.parametrize("name", LARGE)
def test_example_golden_on_port_large(name, tmp_path):
    check_example_golden(name, tmp_path)
