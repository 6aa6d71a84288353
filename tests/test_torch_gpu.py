"""The CUDA geodesic kernel on the card (marker `gpu`; skips without one).

Repeats chip_smoke.py's phases 3 and 4 at 32x32: the kernel against its
plain PyTorch version on the same CUDA inputs under the parity
contracts, and a depth-sorted kernel trace bitwise equal to the raster
one.  Run on a machine with a GPU (and without jax, which the suite's
conftest imports):

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def test_kernel_matches_plain_on_card(cuda):
    from blackhole_tpu_torch.render import trace_kernel

    before = trace_kernel.launches
    stats = chip_smoke.check_kernel_vs_plain(cuda, size=32)
    assert len(stats) == 6
    assert trace_kernel.launches == before + 6


def test_depth_sorted_equals_raster_on_card(cuda):
    stats = chip_smoke.check_depth_sorted(cuda, size=32)
    assert stats["elementwise_mismatch"] == 0


def test_kernel_rejects_grad_and_bad_layout(cuda):
    from blackhole_tpu_torch.render import trace_kernel

    scal = torch.zeros(12, device=cuda)
    inp = torch.zeros(16, 8, device=cuda)
    with pytest.raises(NotImplementedError):
        trace_kernel.trace_planes(scal.requires_grad_(True), inp, True, 4,
                                  False)
    with pytest.raises(ValueError):
        trace_kernel.trace_planes(torch.zeros(12, device=cuda),
                                  torch.zeros(15, 8, device=cuda), True, 4,
                                  False)
    with pytest.raises(TypeError):
        trace_kernel.trace_planes(torch.zeros(12, device=cuda),
                                  inp.double(), True, 4, False)
