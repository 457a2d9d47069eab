"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips without a CUDA device:
a hand-written kernel has no CPU mode. The file imports neither JAX nor the
JAX package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

import chip_smoke
from video_mamba_suite_torch.models import MambaVim
from video_mamba_suite_torch.ops import (
    LAUNCHES,
    selective_scan_bidir,
    selective_scan_bidir_bwd,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("label,shape,dtype,has_dz", chip_smoke.K1_CASES,
                         ids=[case[0] for case in chip_smoke.K1_CASES])
def test_k1_matches_plain_version(cuda_device, label, shape, dtype, has_dz):
    """The cases and tolerances of chip_smoke.py's K1 phase."""
    chip_smoke.k1_check(label, shape, dtype, has_dz)


@pytest.mark.cuda
def test_k1_rejects_what_it_does_not_take(cuda_device):
    args = chip_smoke.k1_inputs((2, 65, 8, 4), "float32", 0)
    with pytest.raises(ValueError, match="short-sequence"):
        selective_scan_bidir(**args)
    args = chip_smoke.k1_inputs((2, 8, 8, 4), "float32", 0)
    args["zf"] = args["zf"].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        selective_scan_bidir(**args)
    args = chip_smoke.k1_inputs((2, 8, 8, 4), "float32", 0)
    args["Af"] = args["Af"].cpu()
    with pytest.raises(ValueError, match="is on"):
        selective_scan_bidir(**args)
    args = chip_smoke.k1_inputs((2, 8, 8, 4), "float16", 0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        selective_scan_bidir(**args)


@pytest.mark.cuda
@pytest.mark.parametrize("label,shape,dtype,has_dz", chip_smoke.K2_CASES,
                         ids=[case[0] for case in chip_smoke.K2_CASES])
def test_k2_matches_plain_version(cuda_device, label, shape, dtype, has_dz):
    """The cases and tolerances of chip_smoke.py's K2 phase."""
    chip_smoke.k2_check(label, shape, dtype, has_dz)


@pytest.mark.cuda
def test_k2_rejects_what_it_does_not_take(cuda_device):
    args, cot = chip_smoke.k2_inputs((2, 65, 8, 4), "float32", 0)
    with pytest.raises(ValueError, match="short-sequence"):
        selective_scan_bidir_bwd(**args, **cot)
    args, cot = chip_smoke.k2_inputs((2, 8, 8, 4), "float32", 0)
    args["Bf"] = args["Bf"][:, :, None]
    with pytest.raises(ValueError, match="grouped"):
        selective_scan_bidir_bwd(**args, **cot)
    args, cot = chip_smoke.k2_inputs((2, 8, 8, 17), "float32", 0)
    with pytest.raises(ValueError, match="dstate 17"):
        selective_scan_bidir_bwd(**args, **cot)
    args, cot = chip_smoke.k2_inputs((2, 8, 8, 4), "float32", 0)
    cot["gb"] = cot["gb"].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="gb must be contiguous"):
        selective_scan_bidir_bwd(**args, **cot)
    args, cot = chip_smoke.k2_inputs((2, 8, 8, 4), "float32", 0)
    cot["gf"] = cot["gf"].to(torch.bfloat16)
    with pytest.raises(TypeError, match="gf must be"):
        selective_scan_bidir_bwd(**args, **cot)


@pytest.mark.cuda
def test_backward_on_card_reaches_every_mamba_parameter(cuda_device):
    """A backward through MambaVim on the card goes through K1 and K2 and
    gives every parameter a gradient: in_proj, conv, x_proj, dt_proj,
    dt_bias, A_log and D upstream of the scan as well as out_proj."""
    model = MambaVim(d_model=64, d_state=16, expand=1, device="cuda",
                     generator=torch.Generator().manual_seed(0))
    x = torch.randn(6, 16, 64, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    before = dict(LAUNCHES)
    (model(x) ** 2).mean().backward()
    torch.cuda.synchronize()
    for name in ("short_bidir_fwd", "short_bidir_bwd"):
        assert LAUNCHES[name] == before.get(name, 0) + 1, name
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        assert torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0, name
