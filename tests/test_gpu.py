"""The reference checks of chip_smoke.py as tests, for a GPU machine:

    python -m pytest tests/test_gpu.py -m gpu --gpu

They skip wherever JAX has no GPU."""

import pytest

import chip_smoke


@pytest.mark.gpu
def test_default_precision_tracks_highest_precision(gpu):
    chip_smoke.reference_precision()


@pytest.mark.gpu
def test_gpu_matches_cpu_at_highest_precision(gpu):
    chip_smoke.reference_cpu()
