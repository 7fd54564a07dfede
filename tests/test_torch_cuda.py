"""PyTorch port on a CUDA device: the hand-written sweep kernel against its
plain PyTorch version, and the mode-9 step through it.  Every test needs a
card and skips without one.  This file imports no JAX, so on a machine
without it run it past tests/conftest.py:

    python3 -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import radiativetransfer_tpu_torch as rt
from radiativetransfer_tpu_torch.config import MODE_UVB_TRANSFER_ONLY
from radiativetransfer_tpu_torch.constants import KPC
from radiativetransfer_tpu_torch.core import sweep, sweep_cuda

pytestmark = pytest.mark.cuda

UVB = np.array([1.0, 0.5, 0.25])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sweep kernel has no CPU mode")
    return torch.device("cuda")


def _kappa(n, dtype, device):
    rng = np.random.default_rng(42)
    return torch.tensor(rng.lognormal(0, 1, (3, n, n, n)) * 0.7 / KPC,
                        dtype=dtype, device=device)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 2e-6),
                                        (torch.float64, 1e-12)])
@pytest.mark.parametrize("plane_memory", ["shared", "global"])
@pytest.mark.parametrize("logmean", ["exact", "clamped"])
@pytest.mark.parametrize("level,n", [(1, 8), (2, 6)])
def test_kernel_matches_plain_version(card, level, n, logmean, plane_memory,
                                      dtype, rtol):
    # rtol: the same ops per cell, Jmean summed over directions in another
    # order (atomics)
    kappa = _kappa(n, dtype, card)
    plan = sweep.build_sweep_plan(level, n)
    before = sweep_cuda.LAUNCHES
    j = sweep_cuda.diffuse_sweep_kernel(kappa, plan, UVB, KPC, logmean,
                                        plane_memory=plane_memory)
    torch.cuda.synchronize()
    assert sweep_cuda.LAUNCHES == before + 1
    ref = sweep_cuda.diffuse_sweep_merged_reference(kappa, plan, UVB, KPC,
                                                    logmean)
    np.testing.assert_allclose(j.cpu().numpy(), ref.cpu().numpy(), rtol=rtol)


def test_kernel_rejects_what_it_does_not_take(card):
    plan = sweep.build_sweep_plan(1, 8)
    with pytest.raises(TypeError):
        sweep_cuda.diffuse_sweep_kernel(_kappa(8, torch.float16, card), plan,
                                        UVB, KPC)
    with pytest.raises(ValueError, match="shape"):
        sweep_cuda.diffuse_sweep_kernel(_kappa(6, torch.float32, card), plan,
                                        UVB, KPC)
    with pytest.raises(ValueError, match="contiguous"):
        sweep_cuda.diffuse_sweep_kernel(
            _kappa(8, torch.float32, card).transpose(1, 2), plan, UVB, KPC)


def test_mode9_step_launches_kernel(card):
    cfg = rt.RunConfig(mode=MODE_UVB_TRANSFER_ONLY, current_redshift=6.55,
                       n_angular_level=1, reionization_model=10)
    model = rt.RTModel.setup(cfg, rt.GridGeometry(24, 24, 24, 200.0 * KPC),
                             torch.float32, card)
    state = rt.uniform_state(24, nh=1e-4, tgas=2e4, device=card)
    before = sweep_cuda.LAUNCHES
    nf = model.neutral_fraction(model.make_step()(state))
    assert sweep_cuda.LAUNCHES == before + 1
    assert nf == pytest.approx(0.044220, rel=1e-4)
