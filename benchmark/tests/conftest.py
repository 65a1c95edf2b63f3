"""The benchmark's CPU tests: the harness, its statistics and its
comparison, driven at a tiny size through the port's plain versions."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# a tiny size of every cell: the port runs its plain versions on the CPU
TINY = {"config": {"settings": {"image_width": 16, "spp_per_chunk": 2,
                                "num_chunks": 2, "max_depth": 6,
                                "ray_batch": 64}},
        "traffic": {"check_pixels": 48, "spp": 2, "ray_batch": 64,
                    "target_spp": 4, "profile_requests": 1}}
SEED = 2**31 + 4242  # a seed needs more than 32 signed bits


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
