"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips without a CUDA device:
a hand-written kernel has no CPU mode. The file imports neither JAX nor the
JAX package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py
"""

import contextlib
import copy
import importlib

import pytest
import torch

import chip_smoke
from video_mamba_suite_torch.models import (
    MambaDBM,
    MambaLMHeadModel,
    MambaScanNorm,
    MambaVim,
)
from video_mamba_suite_torch.ops import (
    LAUNCHES,
    chunked_scan_bwd,
    chunked_scan_fwd,
    selective_scan,
    selective_scan_bidir,
    selective_scan_bidir_bwd,
    short_scan_bwd,
    short_scan_fwd,
)
from video_mamba_suite_torch.tasks.anticipation import (
    LSTRMamba,
    anticipation_loss,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them faster
    and keeps the test workers beside this file from being
    oversubscribed."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# the module, which the package's names of its functions shadow
chunked = importlib.import_module(
    "video_mamba_suite_torch.ops.selective_scan_chunked")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("label,shape,dtype,has_dz,shared",
                         chip_smoke.K1_CASES,
                         ids=[case[0] for case in chip_smoke.K1_CASES])
def test_k1_matches_plain_version(cuda_device, label, shape, dtype, has_dz,
                                   shared):
    """The cases and tolerances of chip_smoke.py's K1 phase."""
    chip_smoke.k1_check(label, shape, dtype, has_dz, shared)


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
@pytest.mark.parametrize("label,shape,dtype,has_dz,shared",
                         chip_smoke.K2_CASES,
                         ids=[case[0] for case in chip_smoke.K2_CASES])
def test_k2_matches_plain_version(cuda_device, label, shape, dtype, has_dz,
                                   shared):
    """The cases and tolerances of chip_smoke.py's K2 phase."""
    chip_smoke.k2_check(label, shape, dtype, has_dz, shared)


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


@pytest.mark.cuda
@pytest.mark.parametrize("label,shape,dtype,opts", chip_smoke.K3_CASES,
                         ids=[case[0] for case in chip_smoke.K3_CASES])
def test_k3_matches_plain_version(cuda_device, label, shape, dtype, opts):
    """The cases and tolerances of chip_smoke.py's K3 phase."""
    chip_smoke.k3_check(label, shape, dtype, opts)


@pytest.mark.cuda
def test_k3_rejects_what_it_does_not_take(cuda_device):
    def args(**kw):
        return chip_smoke.k3_inputs((2, 80, 8, 4), "float32", 0, **kw)

    a = args()
    a["A"] = a["A"].to(torch.complex64)
    with pytest.raises(TypeError, match="complex"):
        chunked_scan_fwd(**a)
    with pytest.raises(ValueError, match="dstate 17"):
        chunked_scan_fwd(**chip_smoke.k3_inputs((2, 80, 8, 17), "float32",
                                                0))
    a = args()
    a["z"] = a["z"].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="z must be contiguous"):
        chunked_scan_fwd(**a)
    a = args()
    a["B"] = a["B"].to(torch.bfloat16)
    with pytest.raises(TypeError, match="B must be torch.float32"):
        chunked_scan_fwd(**a)
    a = args(h0=True)
    a["initial_state"] = a["initial_state"].to(torch.bfloat16)
    with pytest.raises(TypeError, match="initial_state must be"):
        chunked_scan_fwd(**a)
    a = args()
    a["D"] = a["D"].cpu()
    with pytest.raises(ValueError, match="is on"):
        chunked_scan_fwd(**a)
    a = args(groups=3)
    with pytest.raises(ValueError, match="divisible"):
        chunked_scan_fwd(**a)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        chunked_scan_fwd(**chip_smoke.k3_inputs((2, 80, 8, 4), "float16", 0))


@pytest.mark.cuda
@pytest.mark.parametrize("label,shape,dtype,opts", chip_smoke.K4_CASES,
                         ids=[case[0] for case in chip_smoke.K4_CASES])
def test_k4_matches_plain_version(cuda_device, label, shape, dtype, opts):
    """The cases and tolerances of chip_smoke.py's K4 phase."""
    chip_smoke.k4_check(label, shape, dtype, opts)


@pytest.mark.cuda
def test_k4_rejects_what_it_does_not_take(cuda_device):
    def args(**kw):
        return chip_smoke.k4_inputs((2, 80, 8, 4), "float32", 0, **kw)

    a, states = args()
    with pytest.raises(ValueError, match="states must have shape"):
        chunked_scan_bwd(**a, states=states[:, 1:].contiguous())
    a, states = args()
    a["g"] = a["g"].to(torch.bfloat16)
    with pytest.raises(TypeError, match="g must be"):
        chunked_scan_bwd(**a, states=states)
    a, states = args()
    a["g_last"] = a["g_last"].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="g_last must be contiguous"):
        chunked_scan_bwd(**a, states=states)
    a, states = args()
    with pytest.raises(ValueError, match="checkpoint_steps"):
        chunked_scan_bwd(**a, states=states, checkpoint_steps=10)


@pytest.mark.cuda
def test_k3_writes_checkpoints_only_for_a_backward(cuda_device,
                                                   monkeypatch):
    """Under inference_mode or no_grad, or with no input that requires a
    gradient, K3 runs without checkpoints; with a backward ahead it writes
    them every CHECKPOINT_STEPS steps."""
    seen = []
    launch = chunked.chunked_scan_fwd

    def recording(*args):
        seen.append(args[-1])
        return launch(*args)

    monkeypatch.setattr(chunked, "chunked_scan_fwd", recording)
    a = chip_smoke.k3_inputs((2, 80, 8, 4), "float32", 0)
    with torch.inference_mode():
        selective_scan(**a)
    with torch.no_grad():
        selective_scan(**a)
    selective_scan(**a)
    a["u"].requires_grad_()
    with torch.no_grad():
        selective_scan(**a)
    selective_scan(**a).sum().backward()
    assert seen == [0, 0, 0, 0, chunked.CHECKPOINT_STEPS]


@pytest.mark.cuda
@pytest.mark.parametrize("cls", [MambaVim, MambaScanNorm])
def test_long_route_backward_on_card_reaches_every_parameter(cuda_device,
                                                             cls):
    """At seqlen 100 a backward through the mixer on the card runs two K3
    and two K4 launches and gives every parameter (in_proj, conv, x_proj,
    dt_proj, dt_bias, A_log, D, out_proj, scan_norm_w) the CPU's plain
    gradient."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = cls(d_model=64, d_state=16, device="cpu",
              generator=torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to("cuda")
    x = torch.randn(3, 100, 64, generator=torch.Generator().manual_seed(1))
    before = dict(LAUNCHES)
    (card(x.cuda()) ** 2).mean().backward()
    torch.cuda.synchronize()
    grown = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
             if v != before.get(k, 0)}
    assert grown == {"chunked_scan_fwd": 2, "chunked_scan_bwd": 2}
    (cpu(x) ** 2).mean().backward()
    want = dict(cpu.named_parameters())
    for name, p in card.named_parameters():
        assert p.grad is not None, name
        g, w = p.grad.cpu(), want[name].grad
        assert torch.isfinite(g).all() and g.abs().sum() > 0, name
        err = (g - w).abs().max() / w.abs().max()
        assert err < 1e-4, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("cls", [MambaVim, MambaScanNorm])
def test_long_sequence_mixer_on_card_runs_k3(cuda_device, cls):
    """At seqlen > 64 the mixer runs one K3 launch per direction and no K1,
    and matches the CPU's plain versions; at seqlen 16 it still runs K1."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = cls(d_model=64, d_state=16, device="cpu",
              generator=torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to("cuda")
    for seqlen, kernel in ((100, "chunked_scan_fwd"),
                           (16, "short_bidir_fwd")):
        x = torch.randn(3, seqlen, 64,
                        generator=torch.Generator().manual_seed(seqlen))
        before = dict(LAUNCHES)
        with torch.no_grad():
            got = card(x.cuda())
            torch.cuda.synchronize()
            want = cpu(x)
        grown = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
                 if v != before.get(k, 0)}
        assert grown == {kernel: 2 if kernel == "chunked_scan_fwd" else 1}
        err = (got.cpu() - want).abs().max() / want.abs().max()
        assert err < 1e-5, err


def _grown(before):
    return {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
            if v != before.get(k, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("label,shape,dtype,opts", chip_smoke.K5_CASES,
                         ids=[case[0] for case in chip_smoke.K5_CASES])
def test_k5_matches_plain_version(cuda_device, label, shape, dtype, opts):
    """The cases and tolerances of chip_smoke.py's K5 phase."""
    chip_smoke.k5_check(label, shape, dtype, opts)


@pytest.mark.cuda
def test_k5_rejects_what_it_does_not_take(cuda_device):
    def args(shape=(2, 16, 8, 4), dtype="float32", **kw):
        return chip_smoke.k5_inputs(shape, dtype, 0, **kw)

    a = args()
    a["A"] = a["A"].to(torch.complex64)
    with pytest.raises(TypeError, match="complex"):
        short_scan_fwd(**a)
    with pytest.raises(ValueError, match="dstate 17"):
        short_scan_fwd(**args((2, 16, 8, 17)))
    with pytest.raises(ValueError, match="seqlen 65"):
        short_scan_fwd(**args((2, 65, 8, 4)))
    a = args()
    a["z"] = a["z"].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="z must be contiguous"):
        short_scan_fwd(**a)
    a = args()
    a["C"] = a["C"].to(torch.bfloat16)
    with pytest.raises(TypeError, match="C must be torch.float32"):
        short_scan_fwd(**a)
    a = args()
    a["B"] = a["B"][:, :8].contiguous()
    with pytest.raises(ValueError, match="B and C must"):
        short_scan_fwd(**a)
    a = args()
    a["delta_bias"] = a["delta_bias"].cpu()
    with pytest.raises(ValueError, match="is on"):
        short_scan_fwd(**a)
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        short_scan_fwd(**{k: v.cpu() if isinstance(v, torch.Tensor) else v
                          for k, v in args().items()})
    with pytest.raises(ValueError, match="initial_state"):
        short_scan_fwd(**args(), initial_state=torch.zeros(
            2, 8, 4, device="cuda"))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        short_scan_fwd(**args(dtype="float16"))


@pytest.mark.cuda
def test_short_scan_route_on_card(cuda_device):
    """selective_scan launches K5 for a short scan with no backward to
    follow (under inference_mode, no_grad, or with no input that needs a
    gradient), K5 and then K6 for a short scan with a backward ahead (the
    JAX rule, with the last state's gradient stopped), and the chunked scan
    for 65 steps and for an initial state. K5's output and last state are
    K3's."""
    a = chip_smoke.k3_inputs((3, 64, 32, 16), "float32", 0, h0=True)
    h0 = a.pop("initial_state")
    for mode in (torch.inference_mode, torch.no_grad, contextlib.nullcontext):
        before = dict(LAUNCHES)
        with mode():
            out, last = selective_scan(**a, return_last_state=True)
        assert _grown(before) == {"short_scan_fwd": 1}, mode
    want, want_last = chunked_scan_fwd(**a)
    torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(last, want_last, atol=2e-5, rtol=2e-5)
    before = dict(LAUNCHES)
    with torch.no_grad():
        selective_scan(**a, initial_state=h0)
        b = chip_smoke.k3_inputs((3, 65, 32, 16), "float32", 0)
        selective_scan(**b)
    assert _grown(before) == {"chunked_scan_fwd": 2}
    a["u"].requires_grad_()
    before = dict(LAUNCHES)
    out, last = selective_scan(**a, return_last_state=True)
    out.sum().backward()
    assert _grown(before) == {"short_scan_fwd": 1, "short_scan_bwd": 1}
    assert a["u"].grad is not None and not last.requires_grad


@pytest.mark.cuda
@pytest.mark.parametrize("label,shape,dtype,opts", chip_smoke.K6_CASES,
                         ids=[case[0] for case in chip_smoke.K6_CASES])
def test_k6_matches_plain_version(cuda_device, label, shape, dtype, opts):
    """The cases and tolerances of chip_smoke.py's K6 phase."""
    chip_smoke.k6_check(label, shape, dtype, opts)


@pytest.mark.cuda
def test_k6_rejects_what_it_does_not_take(cuda_device):
    def args(shape=(2, 16, 8, 4), dtype="float32", **kw):
        return chip_smoke.k6_inputs(shape, dtype, 0, **kw)

    a = args()
    a["A"] = a["A"].to(torch.complex64)
    with pytest.raises(TypeError, match="complex"):
        short_scan_bwd(**a)
    with pytest.raises(ValueError, match="dstate 17"):
        short_scan_bwd(**args((2, 16, 8, 17)))
    with pytest.raises(ValueError, match="seqlen 65"):
        short_scan_bwd(**args((2, 65, 8, 4)))
    a = args()
    a["g"] = a["g"].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="g must be contiguous"):
        short_scan_bwd(**a)
    a = args()
    a["g"] = a["g"].to(torch.bfloat16)
    with pytest.raises(TypeError, match="g must be torch.float32"):
        short_scan_bwd(**a)
    a = args()
    a["B"] = a["B"][:, :8].contiguous()
    with pytest.raises(ValueError, match="B and C must"):
        short_scan_bwd(**a)
    a = args()
    a["D"] = a["D"].cpu()
    with pytest.raises(ValueError, match="is on"):
        short_scan_bwd(**a)
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        short_scan_bwd(**{k: v.cpu() if isinstance(v, torch.Tensor) else v
                          for k, v in args().items()})
    with pytest.raises(ValueError, match="initial_state"):
        short_scan_bwd(**args(), initial_state=torch.zeros(
            2, 8, 4, device="cuda"))
    with pytest.raises(ValueError, match="cotangent"):
        short_scan_bwd(**{k: v for k, v in args().items() if k != "g"})
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        short_scan_bwd(**args(dtype="float16"))


@pytest.mark.cuda
def test_small_lstr_mamba_grads_on_card_match_cpu(cuda_device):
    """A small LSTR-Mamba (d_model 64, 2 layers, 8 + 6 frames and 2
    queries: 16 tokens) trains through K5 and K6 on the card; its loss
    gradient at every parameter matches the CPU's plain versions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = LSTRMamba(visual_dim=12, motion_dim=6, d_model=64, num_classes=7,
                    long_memory_num_samples=8, work_memory_num_samples=6,
                    anticipation_num_samples=2, mamba_layers=2,
                    device="cpu", generator=torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to("cuda")
    g = torch.Generator().manual_seed(1)
    visual, motion = torch.randn(3, 14, 12, generator=g), \
        torch.randn(3, 14, 6, generator=g)
    targets = torch.randint(7, (3, 8), generator=g)
    before = dict(LAUNCHES)
    anticipation_loss(card(visual.cuda(), motion.cuda())["score"],
                      targets.cuda()).backward()
    torch.cuda.synchronize()
    assert _grown(before) == {"short_scan_fwd": 2, "short_scan_bwd": 2}
    anticipation_loss(cpu(visual, motion)["score"], targets).backward()
    want = dict(cpu.named_parameters())
    for name, p in card.named_parameters():
        assert p.grad is not None, name
        got, w = p.grad.cpu(), want[name].grad
        assert torch.isfinite(got).all() and got.abs().sum() > 0, name
        err = (got - w).abs().max() / w.abs().max()
        assert err < 1e-4, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("seqlen,routes", [
    (40, (("K1", "short_bidir_fwd"), ("K2", "short_bidir_bwd"))),
    (100, (("K3", "chunked_scan_fwd"), ("K4", "chunked_scan_bwd")))],
    ids=["fused-l40", "two-l100"])
def test_dbm_mixer_on_card_matches_cpu(cuda_device, seqlen, routes):
    """MambaDBM (expand 1, a ragged mask) on the card against the CPU's
    plain versions: the output and every parameter's gradient, the shared
    scan parameters taking both directions' sums. At 40 steps one K1 and
    one K2 (the shared parameters passed to both directions), at 100 two
    K3 and two K4; the profiler sees the routed kernels."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = MambaDBM(d_model=64, d_state=16, expand=1, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to("cuda")
    g = torch.Generator().manual_seed(seqlen)
    x = torch.randn(3, seqlen, 64, generator=g)
    cot = torch.randn(3, seqlen, 64, generator=g)
    mask = torch.ones(3, seqlen)
    mask[1, seqlen - 9:] = 0.0

    def step(model, dev):
        out = model(x.to(dev), mask.to(dev))
        (out * cot.to(dev)).sum().backward()
        return out

    before = dict(LAUNCHES)
    got = step(card, "cuda")
    torch.cuda.synchronize()
    calls = 1 if seqlen <= 64 else 2
    assert _grown(before) == {name: calls for _, name in routes}
    want = step(cpu, "cpu")
    err = (got.detach().cpu() - want).abs().max() / want.abs().max()
    assert err < 1e-5, err
    ref = dict(cpu.named_parameters())
    for name, p in card.named_parameters():
        assert p.grad is not None, name
        gp, w = p.grad.cpu(), ref[name].grad
        assert torch.isfinite(gp).all() and gp.abs().sum() > 0, name
        err = (gp - w).abs().max() / w.abs().max()
        assert err < 1e-4, (name, err)
    want_kernels = [k for kernel, _ in routes
                    for k in chip_smoke.ROUTES[(kernel, "float32")]]
    names = chip_smoke.kernel_names(lambda: step(card, "cuda"),
                                    want=want_kernels)
    for kernel, _ in routes:
        chip_smoke.check_route(kernel, f"MambaDBM at {seqlen}", "float32",
                               names)


@pytest.mark.cuda
def test_small_lm_on_card_matches_cpu(cuda_device):
    """A small Mamba LM (d_model 64, 2 layers) on the card against the CPU:
    the prefill through K5 (prompt 16) and K3 (prompt 80), every layer's
    state, and three decode steps."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = MambaLMHeadModel(64, 2, 50, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to("cuda")
    for prompt, kernel in ((16, "short_scan_fwd"), (80, "chunked_scan_fwd")):
        ids = torch.randint(50, (3, prompt),
                            generator=torch.Generator().manual_seed(prompt))
        before = dict(LAUNCHES)
        with torch.inference_mode():
            got, states = card.prefill(ids.cuda())
            torch.cuda.synchronize()
            assert _grown(before) == {kernel: 2}
            want, want_states = cpu.prefill(ids)
            pairs = [(got, want)] + [
                (g, w) for s, ws in zip(states, want_states)
                for g, w in zip(s, ws)]
            for t in range(3):
                got, states = card.step(ids[:, t].cuda(), states)
                want, want_states = cpu.step(ids[:, t], want_states)
                pairs.append((got, want))
        for g, w in pairs:
            err = (g.cpu() - w).abs().max() / w.abs().max()
            assert err < 1e-5, (prompt, err)


@pytest.mark.cuda
@pytest.mark.parametrize("label,shape,dtype,layout", chip_smoke.K10_CASES,
                         ids=[case[0] for case in chip_smoke.K10_CASES])
def test_k10_matches_plain_version(cuda_device, label, shape, dtype, layout):
    """The cases and tolerances of chip_smoke.py's K10 phase, and the
    kernel the profiler sees run: bf16 on the tensor cores, fp32 SIMT."""
    args, _, _ = chip_smoke.attn_check("K10", label, shape, dtype, layout)
    fwd = chip_smoke.attn_kernel("K10")[0]
    chip_smoke.check_route("K10", label, dtype, chip_smoke.kernel_names(
        lambda: fwd(*args), want=chip_smoke.ROUTES[("K10", dtype)]))


@pytest.mark.cuda
@pytest.mark.parametrize("label,shape,dtype,layout", chip_smoke.K9_CASES,
                         ids=[case[0] for case in chip_smoke.K9_CASES])
def test_k9_matches_plain_version(cuda_device, label, shape, dtype, layout):
    """The cases and tolerances of chip_smoke.py's K9 phase, and the kernel
    the profiler sees run: bf16 on the tensor cores, fp32 SIMT."""
    args, _, _ = chip_smoke.attn_check("K9", label, shape, dtype, layout)
    fwd = chip_smoke.attn_kernel("K9")[0]
    chip_smoke.check_route("K9", label, dtype, chip_smoke.kernel_names(
        lambda: fwd(*args), want=chip_smoke.ROUTES[("K9", dtype)]))


@pytest.mark.cuda
def test_k9_k10_reject_what_they_do_not_take(cuda_device):
    from video_mamba_suite_torch.ops import row_mha_fwd, vision_mha_fwd

    qkv = torch.randn(1, 2, 6, 16, 8, device="cuda")
    with pytest.raises(ValueError, match="whole-row limit"):
        row_mha_fwd(torch.zeros(1, 1, 3, 513, 8, device="cuda"))
    # any head width computes, as in the JAX package: 129 is two slices
    wide = torch.randn(1, 1, 3, 8, 129, device="cuda")
    got = row_mha_fwd(wide)
    want = chip_smoke.attn_kernel("K10")[1](wide)
    assert got.shape == want.shape == (1, 1, 1, 8, 129)
    assert (got - want).abs().max() <= chip_smoke.ATTN_TOL["float32"]
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        row_mha_fwd(qkv.half())
    with pytest.raises(ValueError, match="contiguous"):
        row_mha_fwd(qkv.transpose(-1, -2))
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        row_mha_fwd(qkv.cpu())
    q = torch.randn(2, 2, 16, 8, device="cuda")
    with pytest.raises(TypeError, match="bfloat16"):
        vision_mha_fwd(q, q, q.bfloat16())
    with pytest.raises(ValueError, match="is on"):
        vision_mha_fwd(q, q, q.cpu())
    with pytest.raises(ValueError, match="shape"):
        vision_mha_fwd(q, q, q[:, :, :8])


@pytest.mark.cuda
def test_fused_mha_flash_true_launches_k11_on_card(cuda_device):
    """FusedMHA(flash=True) on a 3-D input with dh a multiple of 64 runs
    K11: one forward launch, and one backward launch in a backward pass;
    output and gradients agree with the CPU's einsum path. A head width
    that is no multiple of 64 takes the einsum path, as in the JAX
    package."""
    from video_mamba_suite_torch.models import FusedMHA

    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = FusedMHA(128, 2, flash=True, causal=True,
                   generator=torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to("cuda")
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 9, 128, generator=gen)
    g = torch.randn(2, 9, 128, generator=gen)
    before = dict(LAUNCHES)
    with torch.no_grad():
        card(x.cuda())
    torch.cuda.synchronize()
    assert _grown(before) == {"flash_mha_fwd": 1}
    xc = x.cuda().requires_grad_()
    before = dict(LAUNCHES)
    out = card(xc)
    out.backward(g.cuda())
    torch.cuda.synchronize()
    assert _grown(before) == {"flash_mha_fwd": 1, "flash_mha_bwd": 1}
    xw = x.clone().requires_grad_()
    want = cpu(xw)
    want.backward(g)
    pairs = [(out, want), (xc.grad, xw.grad)] + [
        (a.grad, b.grad) for a, b in zip(card.parameters(),
                                         cpu.parameters())]
    for got, w in pairs:
        err = (got.detach().cpu() - w).abs().max() / w.abs().max()
        assert err < 1e-5, err
    narrow = FusedMHA(96, 2, flash=True, generator=torch.Generator()).cuda()
    before = dict(LAUNCHES)
    with torch.no_grad():
        narrow(torch.randn(2, 9, 96, device="cuda"))
    assert _grown(before) == {}


@pytest.mark.cuda
def test_fused_mha_flash_true_at_dh256_launches_k11_on_card(cuda_device):
    """FusedMHA(flash=True) with two heads of 256 (two 128-column slices)
    runs K11's forward and backward and agrees with the CPU's einsum
    path in fp32."""
    from video_mamba_suite_torch.models import FusedMHA

    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = FusedMHA(512, 2, flash=True, causal=False,
                   generator=torch.Generator().manual_seed(3))
    card = copy.deepcopy(cpu).to("cuda")
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 70, 512, generator=gen)
    g = torch.randn(2, 70, 512, generator=gen)
    xc = x.cuda().requires_grad_()
    before = dict(LAUNCHES)
    out = card(xc)
    out.backward(g.cuda())
    torch.cuda.synchronize()
    assert _grown(before) == {"flash_mha_fwd": 1, "flash_mha_bwd": 1}
    xw = x.clone().requires_grad_()
    want = cpu(xw)
    want.backward(g)
    pairs = [(out, want), (xc.grad, xw.grad)] + [
        (a.grad, b.grad) for a, b in zip(card.parameters(),
                                         cpu.parameters())]
    for got, w in pairs:
        err = (got.detach().cpu() - w).abs().max() / w.abs().max()
        assert err < 1e-5, err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fused_mha_vmem_launches_k9_on_card(cuda_device, dtype):
    """FusedMHA(flash="vmem") on a 3-D input runs one K9 a forward, on the
    kernel its dtype names; in fp32 it agrees with the CPU's plain
    version, in bf16 (the kernel held to its plain version by the K9
    cases) its output is finite."""
    from video_mamba_suite_torch.models import FusedMHA

    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    cpu = FusedMHA(128, 2, dtype=dt, flash="vmem",
                   generator=torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to("cuda")
    x = torch.randn(3, 40, 128, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        names = chip_smoke.kernel_names(
            lambda: card(x.cuda()), want=chip_smoke.ROUTES[("K9", dtype)])
        before = dict(LAUNCHES)      # the profiler may repeat its call
        got = card(x.cuda())
        torch.cuda.synchronize()
        want = cpu(x)
    assert _grown(before) == {"vision_mha_fwd": 1}
    chip_smoke.check_route("K9", "FusedMHA(flash='vmem')", dtype, names)
    assert got.shape == want.shape and torch.isfinite(got).all()
    if dtype == "float32":
        err = (got.cpu() - want).abs().max() / want.abs().max()
        assert err < 1e-5, err


@pytest.mark.cuda
@pytest.mark.parametrize("label,shape,causal,dtype,layout",
                         chip_smoke.K11_CASES,
                         ids=[case[0] for case in chip_smoke.K11_CASES])
def test_k11_matches_plain_version(cuda_device, label, shape, causal, dtype,
                                   layout):
    """The cases and tolerances of chip_smoke.py's K11 phase: forward and
    backward (dq, dk, dv), and the kernels the profiler sees each run:
    bf16 on the tensor cores, fp32 SIMT."""
    from video_mamba_suite_torch.ops import flash_mha_bwd, flash_mha_fwd

    (q, k, v, dout), (out, lse), _, _ = chip_smoke.k11_check(
        label, shape, causal, dtype, layout)
    chip_smoke.check_route("K11", label, dtype, chip_smoke.kernel_names(
        lambda: flash_mha_fwd(q, k, v, causal),
        want=chip_smoke.ROUTES[("K11", dtype)]))
    chip_smoke.check_route("K11 bwd", label, dtype, chip_smoke.kernel_names(
        lambda: flash_mha_bwd(q, k, v, out, lse, dout, causal),
        want=chip_smoke.ROUTES[("K11 bwd", dtype)]))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,dtype", sorted(chip_smoke.ROUTES),
                         ids=[f"{k}-{d}" for k, d in
                              sorted(chip_smoke.ROUTES)])
def test_each_dtype_runs_its_routed_kernels(cuda_device, kernel, dtype):
    """One call of each entry at a small shape (attention in the projection
    layout) runs exactly the kernels ``chip_smoke.ROUTES`` gives its dtype:
    bf16 attention on the tensor cores, fp32 on the SIMT kernels, K1 its
    staged tile kernel, K3 and K7 their split lane walks (here 1000 steps
    in segments, with checkpoints), K2 and K4 their lane-split walks, K5
    and K6 their lane walks (here 40 steps: three units), K8 its local,
    combine and main kernels, nothing else of the entry's source."""
    from video_mamba_suite_torch.ops import (
        complex_scan_bwd,
        complex_scan_fwd,
        flash_mha_bwd,
        flash_mha_fwd,
    )

    if kernel == "K1":
        args = chip_smoke.k1_inputs((4, 16, 256, 16), dtype, 3)

        def call():
            return selective_scan_bidir(**args)
    elif kernel == "K3":
        args = chip_smoke.k3_inputs((2, 1000, 64, 16), dtype, 3)

        def call():
            return chunked_scan_fwd(**args, checkpoint_steps=16)
    elif kernel == "K2":
        args, cot = chip_smoke.k2_inputs((4, 16, 64, 16), dtype, 3)

        def call():
            return selective_scan_bidir_bwd(**args, **cot)
    elif kernel == "K4":
        scan, states = chip_smoke.k4_inputs((2, 80, 64, 16), dtype, 3)

        def call():
            return chunked_scan_bwd(**scan, states=states)
    elif kernel == "K5":
        args = chip_smoke.k5_inputs((2, 40, 64, 16), dtype, 3)

        def call():
            return short_scan_fwd(**args)
    elif kernel == "K6":
        args = chip_smoke.k6_inputs((2, 40, 64, 16), dtype, 3)

        def call():
            return short_scan_bwd(**args)
    elif kernel == "K7":
        args = chip_smoke.k7_inputs((2, 1000, 64, 16), dtype, 3, h0=True)

        def call():
            return complex_scan_fwd(**args, checkpoint_steps=16)
    elif kernel == "K8":
        args, states, cot = chip_smoke.k8_inputs((2, 80, 64, 16), dtype, 3)
        del args["h0r"], args["h0i"]

        def call():
            return complex_scan_bwd(**args, statesr=states[0],
                                    statesi=states[1], **cot)
    elif kernel in ("K9", "K10"):
        shape = (2, 2, 3, 40, 64) if kernel == "K10" else (4, 3, 40, 64)
        fwd = chip_smoke.attn_kernel(kernel)[0]
        args = chip_smoke.attn_inputs(shape, dtype, "projection", seed=3)
        args = args if isinstance(args, tuple) else (args,)

        def call():
            return fwd(*args)
    else:
        q, k, v, dout = chip_smoke.k11_inputs((2, 100, 2, 64), dtype,
                                              "projection", seed=3)
        out, lse = flash_mha_fwd(q, k, v, True)

        def call():
            if kernel == "K11":
                return flash_mha_fwd(q, k, v, True)
            return flash_mha_bwd(q, k, v, out, lse, dout, True)
    chip_smoke.check_route(kernel, "route", dtype, chip_smoke.kernel_names(
        call, want=chip_smoke.ROUTES[(kernel, dtype)]))


@pytest.mark.cuda
def test_k11_rejects_what_it_does_not_take(cuda_device):
    from video_mamba_suite_torch.ops import flash_mha_bwd, flash_mha_fwd

    q = torch.randn(2, 16, 2, 64, device="cuda")
    # jax's flash_attention refuses a width above 128 that is no multiple
    # of 128
    with pytest.raises(ValueError, match="head width 192"):
        flash_mha_fwd(*(torch.zeros(1, 8, 2, 192, device="cuda"),) * 3)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_mha_fwd(q.half(), q.half(), q.half())
    with pytest.raises(TypeError, match="bfloat16"):
        flash_mha_fwd(q, q, q.bfloat16())
    with pytest.raises(ValueError, match="is on"):
        flash_mha_fwd(q, q, q.cpu())
    with pytest.raises(ValueError, match="contiguous last"):
        flash_mha_fwd(q, q, q.transpose(-1, -2).contiguous()
                      .transpose(-1, -2))
    with pytest.raises(ValueError, match="shape"):
        flash_mha_fwd(q, q, q[:, :8])
    out, lse = flash_mha_fwd(q, q, q)
    with pytest.raises(ValueError, match="dout must be contiguous"):
        flash_mha_bwd(q, q, q, out, lse, out.transpose(0, 1).contiguous()
                      .transpose(0, 1))
    with pytest.raises(TypeError, match="lse must be"):
        flash_mha_bwd(q, q, q, out, lse.double(), out)
    shifted = torch.empty(out.numel() + 1, device="cuda")[1:].view_as(out)
    with pytest.raises(ValueError, match="dout needs a 16-byte"):
        flash_mha_bwd(q, q, q, out, lse, shifted)


@pytest.mark.cuda
@pytest.mark.parametrize("label,shape,dtype,opts", chip_smoke.K7_CASES,
                         ids=[case[0] for case in chip_smoke.K7_CASES])
def test_k7_matches_plain_version(cuda_device, label, shape, dtype, opts):
    """The cases and tolerances of chip_smoke.py's K7 phase."""
    chip_smoke.k7_check(label, shape, dtype, opts)


@pytest.mark.cuda
@pytest.mark.parametrize("label,shape,dtype,opts", chip_smoke.K8_CASES,
                         ids=[case[0] for case in chip_smoke.K8_CASES])
def test_k8_matches_plain_version(cuda_device, label, shape, dtype, opts):
    """The cases and tolerances of chip_smoke.py's K8 phase."""
    chip_smoke.k8_check(label, shape, dtype, opts)


@pytest.mark.cuda
def test_k7_k8_reject_what_they_do_not_take(cuda_device):
    from video_mamba_suite_torch.ops import complex_scan_bwd, complex_scan_fwd

    def args(**kw):
        return chip_smoke.k7_inputs((2, 40, 8, 4), "float32", 0, **kw)

    a = args()
    a["B"] = a["B"].to(torch.complex64)
    with pytest.raises(TypeError, match="complex B or C"):
        complex_scan_fwd(**a)
    with pytest.raises(ValueError, match="dstate 17"):
        complex_scan_fwd(**chip_smoke.k7_inputs((2, 40, 8, 17), "float32",
                                                0))
    a = args(h0=True)
    a["h0i"] = None
    with pytest.raises(ValueError, match="both or neither"):
        complex_scan_fwd(**a)
    a = args()
    a["Ai"] = a["Ai"].double()
    with pytest.raises(TypeError, match="Ai must be"):
        complex_scan_fwd(**a)
    a = args()
    _, _, _, sr, si = complex_scan_fwd(**a, checkpoint_steps=16)
    del a["h0r"], a["h0i"]
    g = torch.zeros_like(a["u"])
    with pytest.raises(ValueError, match="checkpoint_steps"):
        complex_scan_bwd(**a, statesr=sr, statesi=si, g=g,
                         checkpoint_steps=32)
    with pytest.raises(ValueError, match="statesr must have shape"):
        complex_scan_bwd(**a, statesr=sr, statesi=si, g=g,
                         checkpoint_steps=8)


@pytest.mark.cuda
def test_complex_a_route_on_card(cuda_device):
    """selective_scan with complex A launches K7 (and K8 in a backward) at
    every length, with or without an initial state, and never K3 or K5;
    real A never launches K7. The card agrees with the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for seqlen in (16, 100):
        a = chip_smoke.k7_inputs((2, seqlen, 32, 8), "float32", seqlen,
                                 h0=True)
        A = torch.complex(a.pop("Ar"), a.pop("Ai"))
        h0 = torch.complex(a.pop("h0r"), a.pop("h0i"))
        for init in (None, h0):
            before = dict(LAUNCHES)
            with torch.no_grad():
                out, last = selective_scan(**a, A=A, initial_state=init,
                                           return_last_state=True)
            assert _grown(before) == {"complex_scan_fwd": 1}
            cpu = {k: v.cpu() if torch.is_tensor(v) else v
                   for k, v in a.items()}
            want, want_last = selective_scan(
                **cpu, A=A.cpu(), return_last_state=True,
                initial_state=None if init is None else init.cpu())
            torch.testing.assert_close(out.cpu(), want, atol=2e-4, rtol=2e-4)
            torch.testing.assert_close(last.cpu(), want_last, atol=2e-4,
                                       rtol=2e-4)
        Ag = A.clone().requires_grad_()
        u = a["u"].clone().requires_grad_()
        before = dict(LAUNCHES)
        out, last = selective_scan(**dict(a, u=u), A=Ag,
                                   return_last_state=True)
        (out.sum() + last.real.sum()).backward()
        torch.cuda.synchronize()
        assert _grown(before) == {"complex_scan_fwd": 1,
                                  "complex_scan_bwd": 1}
        assert torch.isfinite(Ag.grad).all() and torch.isfinite(u.grad).all()
    a = chip_smoke.k3_inputs((2, 16, 32, 8), "float32", 0)
    before = dict(LAUNCHES)
    with torch.no_grad():
        selective_scan(**a)
    assert _grown(before) == {"short_scan_fwd": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("attn_flash,launches", [
    (None, {"short_bidir_fwd": 2}),
    ("row", {"short_bidir_fwd": 2, "row_mha_fwd": 2})])
def test_timemamba_row_attention_on_card(cuda_device, attn_flash, launches):
    """A small TimeMamba forward launches one K10 per block with "row" and
    none without; both agree with the CPU."""
    from video_mamba_suite_torch.models import TimeMamba

    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = TimeMamba(img_size=32, embed_dim=64, depth=2, num_heads=4,
                    num_frames=4, ln_pre=True, attn_flash=attn_flash,
                    device="cpu", seed=0).eval()
    card = copy.deepcopy(cpu).to("cuda")
    x = torch.randn(2, 4, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    before = dict(LAUNCHES)
    with torch.inference_mode():
        got = card(x.cuda())
        torch.cuda.synchronize()
        assert _grown(before) == launches
        want = cpu(x)
    err = (got.cpu() - want).abs().max() / want.abs().max()
    assert err < 1e-5, err


@pytest.mark.cuda
def test_small_clip_on_card_matches_cpu(cuda_device):
    """A small CLIP-TimeMamba (spatial attention on K10) on the card against
    the CPU: both embeddings and the scale; 2 K1 and 2 K10 launches."""
    from video_mamba_suite_torch.models import CLIP

    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = CLIP(embed_dim=32,
               vision_cfg=dict(img_size=32, embed_dim=64, depth=2,
                               num_heads=4, num_frames=4, ln_pre=True,
                               is_tanh_gating=True, attn_flash="row"),
               text_cfg=dict(context_length=16, vocab_size=100, width=64,
                             heads=4, layers=2),
               device="cpu", seed=0).eval()
    card = copy.deepcopy(cpu).to("cuda")
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 4, 32, 32, 3, generator=g)
    ids = torch.randint(100, (3, 16), generator=g)
    before = dict(LAUNCHES)
    with torch.inference_mode():
        got = card(x.cuda(), ids.cuda())
        torch.cuda.synchronize()
        assert _grown(before) == {"short_bidir_fwd": 2, "row_mha_fwd": 2}
        want = cpu(x, ids)
    for g_, w in zip(got, want):
        err = (g_.cpu() - w).abs().max() / w.abs().max()
        assert err < 1e-5, err


def _small_clip_config():
    return dict(embed_dim=32,
                vision_cfg=dict(img_size=32, embed_dim=64, depth=2,
                                num_heads=4, num_frames=4, ln_pre=True,
                                is_tanh_gating=True, attn_flash="row"),
                text_cfg=dict(context_length=16, vocab_size=100, width=64,
                              heads=4, layers=2))


def _grads_close(card_model, cpu_model, rel):
    cpu_params = dict(cpu_model.named_parameters())
    for name, p in card_model.named_parameters():
        want = cpu_params[name].grad
        err = (p.grad.cpu() - want).abs().max() / want.abs().max().clamp_min(
            1e-30)
        assert err < rel, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("trainer", ["mir", "pretrain"])
def test_small_clip_train_step_on_card_matches_cpu(cuda_device, trainer):
    """One MirFinetuner / ClipPretrainer step of a small CLIP-TimeMamba on
    the card (K1, K10 forward; K2 backward, one each a block) against the
    CPU: the loss and every gradient (fp32, TF32 off)."""
    from video_mamba_suite_torch.models import CLIP
    from video_mamba_suite_torch.tasks.egocentric import (
        ClipPretrainer,
        MirFinetuner,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    cls = MirFinetuner if trainer == "mir" else ClipPretrainer
    cpu_model = CLIP(**_small_clip_config(), device="cpu", seed=0)
    for blk in cpu_model.visual.blocks:
        blk.alpha_timeattn.data.fill_(0.7)
    card = cls(copy.deepcopy(cpu_model).to("cuda"), warmup_steps=0)
    cpu = cls(cpu_model, warmup_steps=0)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 4, 32, 32, 3, generator=g)
    ids = torch.randint(100, (3, 16), generator=g)
    before = dict(LAUNCHES)
    got = card.train_step(x.cuda(), ids.cuda())
    torch.cuda.synchronize()
    assert _grown(before) == {"short_bidir_fwd": 2, "row_mha_fwd": 2,
                              "short_bidir_bwd": 2}
    want = cpu.train_step(x, ids)
    assert abs(got - want) <= 1e-5 * abs(want)
    _grads_close(card.model, cpu.model, 1e-4)


@pytest.mark.cuda
def test_small_classifier_step_on_card_matches_cpu(cuda_device):
    """One ClsFinetuner step of a small ViViM (4 frames of 17 tokens: 68
    steps, so K3 with checkpoints and K4, one each a direction and layer)
    against the CPU: the loss and every gradient; then the multi-crop
    evaluate's metrics agree."""
    import numpy as np

    from video_mamba_suite_torch.models import ViViM
    from video_mamba_suite_torch.tasks.egocentric import ClsFinetuner

    torch.backends.cuda.matmul.allow_tf32 = False
    tower = ViViM(img_size=64, patch_size=16, num_frames=4, depth=2,
                  embed_dim=64, drop_path_rate=0.0, device="cpu", seed=0)
    cpu = ClsFinetuner(tower, 7, dropout=0.0, warmup_steps=0)
    card = ClsFinetuner(copy.deepcopy(tower).to("cuda"), 7, dropout=0.0,
                        warmup_steps=0)
    card.model.load_state_dict(cpu.model.state_dict())
    g = torch.Generator().manual_seed(2)
    x = torch.randn(3, 4, 64, 64, 3, generator=g)
    labels = torch.tensor([0, 6, 3])
    before = dict(LAUNCHES)
    got = card.train_step(x.cuda(), labels.cuda())
    torch.cuda.synchronize()
    assert _grown(before) == {"chunked_scan_fwd": 4, "chunked_scan_bwd": 4}
    want = cpu.train_step(x, labels)
    assert abs(got - want) <= 1e-5 * abs(want)
    _grads_close(card.model, cpu.model, 1e-4)
    views = torch.randn(4, 2, 4, 64, 64, 3, generator=g)
    to_verb = [np.array([0, 1, 2]), np.array([3, 4]), np.array([5, 6])]
    kw = dict(batch_size=3, action_to_verb=to_verb)
    assert card.evaluate(views.cuda(), np.array([0, 3, 5, 6]), **kw) == \
        cpu.evaluate(views, np.array([0, 3, 5, 6]), **kw)


@pytest.mark.cuda
def test_w8_product_on_card_matches_cpu(cuda_device):
    """The bf16 product with an fp32 result: cuBLAS on the card against
    the CPU's widened product (both exact products, fp32 sums)."""
    from video_mamba_suite_torch.models.common import bf16_matmul_fp32

    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 5, 96, generator=g)
    w = torch.randn(40, 96, generator=g)
    got = bf16_matmul_fp32(x.cuda(), w.cuda())
    want = bf16_matmul_fp32(x, w)
    assert got.dtype == want.dtype == torch.float32
    err = (got.cpu() - want).abs().max() / want.abs().max()
    assert err < 1e-5, err


@pytest.mark.cuda
@pytest.mark.parametrize("prompt,kernel", [(16, "short_scan_fwd"),
                                           (80, "chunked_scan_fwd")])
def test_int8_lm_on_card_matches_cpu(cuda_device, prompt, kernel):
    """A small LM after quantize_lm_for_decode (int8 projections and
    table, bf16 rest) on the card against the CPU: the forward logits
    (one K5 or K3 a layer) and generate's tokens run unchanged."""
    from video_mamba_suite_torch.models import quantize_lm_for_decode
    from video_mamba_suite_torch.models.generation import (
        GenerationConfig,
        generate,
    )

    cpu = quantize_lm_for_decode(MambaLMHeadModel(
        64, 2, 100, device="cpu", generator=torch.Generator().manual_seed(4)))
    card = copy.deepcopy(cpu).to("cuda")
    ids = torch.randint(100, (2, prompt),
                        generator=torch.Generator().manual_seed(prompt))
    before = dict(LAUNCHES)
    with torch.inference_mode():
        got = card(ids.cuda())
        torch.cuda.synchronize()
        assert _grown(before) == {kernel: 2}
        want = cpu(ids)
    err = (got.cpu() - want).abs().max() / want.abs().max()
    assert err < 5e-2, err
    out = generate(card, ids.cuda(), GenerationConfig(max_length=prompt + 4))
    assert torch.equal(out[:, :prompt].cpu(), ids)


@pytest.mark.cuda
def test_loglikelihood_on_card_matches_cpu(cuda_device):
    """perplexity and sequence_loglikelihood of a small fp32 LM at 100
    tokens (one K3 a layer) against the CPU."""
    from video_mamba_suite_torch.models import (
        perplexity,
        sequence_loglikelihood,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = MambaLMHeadModel(64, 2, 100, device="cpu",
                           generator=torch.Generator().manual_seed(5))
    card = copy.deepcopy(cpu).to("cuda")
    ids = torch.randint(100, (2, 100),
                        generator=torch.Generator().manual_seed(6))
    mask = (torch.arange(100) >= 60).float().expand(2, 100)
    before = dict(LAUNCHES)
    got = sequence_loglikelihood(card, ids.cuda(), mask.cuda())
    torch.cuda.synchronize()
    assert _grown(before) == {"chunked_scan_fwd": 2}
    want = sequence_loglikelihood(cpu, ids, mask)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=0)
    assert perplexity(card, ids.cuda()) == pytest.approx(
        perplexity(cpu, ids), rel=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("seqlen,routes", [
    (40, (("K1", "short_bidir_fwd"), ("K2", "short_bidir_bwd"))),
    (100, (("K3", "chunked_scan_fwd"), ("K4", "chunked_scan_bwd")))],
    ids=["fused-l40", "two-l100"])
def test_tas_step_on_card_matches_cpu(cuda_device, seqlen, routes):
    """One ASFormer-Mamba train step with dropout off (2 encoder layers of
    width 16, one decoder, a padded second video) on the card against the
    CPU: the loss and every parameter's gradient. At 40 steps each encoder
    layer runs one K1 and one K2, at 100 two K3 (with checkpoints) and two
    K4; the profiler sees the routed kernels."""
    from video_mamba_suite_torch.tasks.tas import TasTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(num_classes=5, input_dim=12, num_layers=2, num_f_maps=16,
              num_decoders=1, seed=3)
    cpu, card = (TasTrainer(**kw, device=dev) for dev in ("cpu", "cuda"))
    g = torch.Generator().manual_seed(seqlen)
    feats = torch.randn(2, seqlen, 12, generator=g)
    targets = torch.randint(5, (2, seqlen), generator=g)
    mask = torch.ones(2, seqlen)
    mask[1, seqlen - 11:] = 0.0
    targets[1, seqlen - 11:] = -100
    before = dict(LAUNCHES)
    got = card.train_step(feats, targets, mask, deterministic=True)
    torch.cuda.synchronize()
    calls = 2 if seqlen <= 64 else 4
    assert _grown(before) == {name: calls for _, name in routes}
    want = cpu.train_step(feats, targets, mask, deterministic=True)
    assert got == pytest.approx(want, rel=1e-5)
    grads = {n: p.grad for n, p in cpu.model.named_parameters()}
    floor = 1e-2 * max(w.abs().max().item() for w in grads.values())
    for name, p in card.model.named_parameters():
        gp, w = p.grad.cpu(), grads[name]
        assert torch.isfinite(gp).all(), name
        err = (gp - w).abs().max() / max(w.abs().max().item(), floor)
        assert err < 1e-3, (name, err)
    model = card.model.eval()
    x, m = feats.cuda(), mask.cuda()
    want_kernels = [k for kernel, _ in routes
                    for k in chip_smoke.ROUTES[(kernel, "float32")]]
    names = chip_smoke.kernel_names(
        lambda: model(x, m).sum().backward(),
        want=want_kernels)
    for kernel, _ in routes:
        chip_smoke.check_route(kernel, f"ASFormer-Mamba at {seqlen}",
                               "float32", names)


@pytest.mark.cuda
@pytest.mark.parametrize("mamba_type,max_v_l,routes", [
    ("vim", 40, (("K1", "short_bidir_fwd"), ("K2", "short_bidir_bwd"))),
    ("dbm", 100, (("K3", "chunked_scan_fwd"), ("K4", "chunked_scan_bwd")))],
    ids=["vim-fused-l46", "dbm-two-l106"])
def test_vtg_step_on_card_matches_cpu(cuda_device, mamba_type, max_v_l,
                                      routes):
    """One UniVTG-Mamba train step with dropout off (width 32, 2 layers,
    6 query tokens, a ragged query and a ragged video) on the card
    against the CPU: every loss term and every parameter's gradient. At
    6 + 40 steps each ViM layer runs one K1 and one K2, at 6 + 100 each
    DBM layer two K3 (with checkpoints) and two K4; the profiler sees the
    routed kernels."""
    from video_mamba_suite_torch.tasks.vtg import (
        VtgTrainer,
        collate_vtg,
        make_synthetic_vtg,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(txt_dim=8, vid_dim=12, embed_dim=32, depth=2,
              mamba_type=mamba_type, max_q_l=6, max_v_l=max_v_l, seed=3)
    cpu, card = (VtgTrainer(**kw, device=dev) for dev in ("cpu", "cuda"))
    samples = make_synthetic_vtg(num_samples=3, ctx_l=max_v_l, txt_len=6,
                                 txt_dim=8, vid_dim=12, seed=max_v_l)
    samples[1]["txt_feat"] = samples[1]["txt_feat"][:3]
    samples[2]["vid_feat"] = samples[2]["vid_feat"][:max_v_l - 9]
    batch = collate_vtg(samples, 6, max_v_l)
    before = dict(LAUNCHES)
    got = card.train_step(batch, deterministic=True)
    torch.cuda.synchronize()
    calls = 2 if max_v_l + 6 <= 64 else 4
    assert _grown(before) == {name: calls for _, name in routes}
    want = cpu.train_step(batch, deterministic=True)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-6), k
    grads = {n: p.grad for n, p in cpu.model.named_parameters()}
    floor = 1e-2 * max(w.abs().max().item() for w in grads.values())
    for name, p in card.model.named_parameters():
        gp, w = p.grad.cpu(), grads[name]
        assert torch.isfinite(gp).all(), name
        err = (gp - w).abs().max() / max(w.abs().max().item(), floor)
        assert err < 1e-3, (name, err)
    model = card.model.eval()
    inputs = [torch.as_tensor(batch[k]).cuda() for k in
              ("src_txt", "src_txt_mask", "src_vid", "src_vid_mask")]
    want_kernels = [k for kernel, _ in routes
                    for k in chip_smoke.ROUTES[(kernel, "float32")]]
    names = chip_smoke.kernel_names(
        lambda: model(*inputs)["pred_logits"].sum().backward(),
        want=want_kernels)
    for kernel, _ in routes:
        chip_smoke.check_route(kernel, f"UniVTG-Mamba at {max_v_l + 6}",
                               "float32", names)


def _pdvc_batch(T, input_dim, G, L, vocab, seed):
    """One or two videos of T features (the second's last 11 padded), G
    event slots (the last invalid), captions of BOS 1, words, EOS 2."""
    g = torch.Generator().manual_seed(seed)
    B = 2
    feats = torch.randn(B, T, input_dim, generator=g)
    mask = torch.ones(B, T)
    mask[1, T - 11:] = 0.0
    feats[1, T - 11:] = 0.0
    boxes = torch.stack([0.2 + 0.6 * torch.rand(B, G, generator=g),
                         0.05 + 0.3 * torch.rand(B, G, generator=g)], -1)
    valid = torch.ones(B, G, dtype=torch.bool)
    valid[:, -1] = False
    captions = torch.full((B, G, L), -100, dtype=torch.long)
    captions[..., 0], captions[..., L - 2] = 1, 2
    captions[..., 1:L - 2] = torch.randint(4, vocab, (B, G, L - 3),
                                           generator=g)
    return (feats.numpy(), mask.numpy(), boxes.numpy(),
            torch.zeros(B, G, dtype=torch.long).numpy(), valid.numpy(),
            captions.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("kind,mixer,T,routes", [
    ("standard", "vim", 64,
     (("K3", "chunked_scan_fwd"), ("K4", "chunked_scan_bwd"))),
    ("light", "dbm", 32,
     (("K1", "short_bidir_fwd"), ("K2", "short_bidir_bwd")))],
    ids=["dsa-vim-l96", "light-dbm-l48"])
def test_pdvc_step_on_card_matches_cpu(cuda_device, kind, mixer, T, routes):
    """One PDVC-Mamba step with dropout off (width 32, 2 levels, 1 encoder
    and 2 decoder layers, a padded second video, an invalid event) on the
    card against the CPU: every loss term and every parameter's
    gradient. At 64 + 32 tokens the ViM layer runs two K3 (with
    checkpoints) and two K4, at 32 + 16 the DBM layer one K1 and one
    K2."""
    from video_mamba_suite_torch.tasks.captioning import (
        PDVC,
        CaptioningTrainer,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(input_dim=12, vocab_size=20, num_queries=6, d_model=32,
              n_levels=2, num_encoder_layers=1, num_decoder_layers=2,
              max_caption_len=6, mixer=mixer, caption_decoder_type=kind,
              seed=3)
    cpu, card = (CaptioningTrainer(PDVC(**kw, device=dev))
                 for dev in ("cpu", "cuda"))
    batch = _pdvc_batch(T, 12, 4, 7, 20, seed=T)
    before = dict(LAUNCHES)
    got = card.train_step(*batch, deterministic=True)
    torch.cuda.synchronize()
    calls = 1 if T + T // 2 <= 64 else 2
    assert _grown(before) == {name: calls for _, name in routes}
    want = cpu.train_step(*batch, deterministic=True)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-6), k
    grads = {n: p.grad for n, p in cpu.model.named_parameters()}
    floor = 1e-2 * max(w.abs().max().item() for w in grads.values())
    for name, p in card.model.named_parameters():
        gp, w = p.grad.cpu(), grads[name]
        assert torch.isfinite(gp).all(), name
        err = (gp - w).abs().max() / max(w.abs().max().item(), floor)
        assert err < 1e-3, (name, err)


@pytest.mark.cuda
def test_pdvc_anet_step_launches_k3_and_k4(cuda_device):
    """A train step of PDVC-Mamba at the ActivityNet preset's widths
    (``build_captioning_trainer(configs.DVC_ANET_C3D)``: 256 + 128 + 64 +
    32 = 480 tokens through 2 ViM layers of d_inner 1024, the DSA head,
    30-token captions) launches exactly 4 K3, all writing checkpoints,
    and 4 K4 and no plain version; a ``predict`` exactly 4 K3 without
    checkpoints."""
    from video_mamba_suite_torch.configs import DVC_ANET_C3D
    from video_mamba_suite_torch.tasks.captioning import (
        build_captioning_trainer,
    )

    trainer = build_captioning_trainer(DVC_ANET_C3D, 50, seed=1)
    feats, mask, boxes, labels, valid, captions = _pdvc_batch(
        256, 500, 10, 30, 50, seed=5)
    batch = (feats[:1], mask[:1], boxes[:1], labels[:1], valid[:1],
             captions[:1])
    with chip_smoke.count_plain_calls() as plain, \
            chip_smoke.count_checkpoint_writes() as ck:
        before = dict(LAUNCHES)
        losses = trainer.train_step(*batch)
        step = _grown(before)
        before = dict(LAUNCHES)
        trainer.predict(feats[:1], mask[:1], 120.0)
        fwd = _grown(before)
    assert step == {"chunked_scan_fwd": 4, "chunked_scan_bwd": 4}
    assert fwd == {"chunked_scan_fwd": 4}
    assert ck["chunked_scan_fwd with checkpoints"] == 4
    assert not sum(plain.values())
    assert all(v == v for v in losses.values())


@pytest.mark.cuda
def test_cli_synthetic_run_on_card_launches_kernels(cuda_device):
    """``cli.main`` of the synthetic VTG task (one epoch, width 32, 6 + 32
    steps through 2 ViM layers) on the card, as chip_smoke.py's
    cli-synthetic phase runs it: K1 and K2 launched, no plain version."""
    out, counts, plain, _ = chip_smoke.cli_run(
        ["vtg", "--synthetic", "--epochs", "1"])
    assert counts.get("short_bidir_fwd") and counts.get("short_bidir_bwd")
    assert not sum(plain.values())
    assert "epoch 0:" in out and "'R1@0.5'" in out


# the small THUMOS-layout run of the checkpoint test: 16 features, 128
# steps, a 3-level pyramid of width 32 (K3/K4 at 128 steps, K1/K2 below)
SMALL_TAL = ["dataset.input_dim=16", "dataset.num_classes=3",
             "dataset.max_seq_len=128", "model.embd_dim=32",
             "model.backbone_arch=[1,1,2]",
             "model.regression_range=[[0,8],[8,32],[32,10000]]"]


@pytest.mark.cuda
def test_card_checkpoint_restores_on_cpu_exactly(cuda_device, tmp_path):
    """A TAL checkpoint the CLI saves on the card (chip_smoke.py's
    cli-tal-thumos and card-vs-cpu-ckpt helpers, at small widths) restores
    into trainers on the card and on the CPU with every tensor equal to
    the file's bit for bit, and both run a validation video within
    ``CARD_CPU_CKPT_REL_TOL`` of scale."""
    sets = chip_smoke.write_tal_dataset(str(tmp_path), 2, 1, 160, 16, 3,
                                        seed=3) + SMALL_TAL
    ckpt = str(tmp_path / "ckpt")
    out, counts, plain, _ = chip_smoke.cli_run(
        ["tal", "--preset", "tal_thumos", "--epochs", "2", "--ckpt", ckpt,
         "--set", *sets])
    assert "epoch 1:" in out and "mAP per tIoU" in out
    assert counts.get("chunked_scan_bwd") and counts.get("short_bidir_bwd")
    assert not sum(plain.values())
    step, bad, errs, _, _ = chip_smoke.restore_card_and_cpu(ckpt, sets)
    assert step == 1
    assert bad == {"card": [], "cpu": []}
    assert max(errs["logits"], errs["offsets"]) <= \
        chip_smoke.CARD_CPU_CKPT_REL_TOL, errs
