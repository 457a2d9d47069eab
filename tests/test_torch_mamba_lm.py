"""The port's Mamba LM serving path against the JAX package's: the decode
ops, ``MambaCausal``, ``Block``, ``MambaLMHeadModel``, ``generate``, the
sampling filter and the upstream-checkpoint loader.

JAX runs on the CPU with its plain paths; the port runs its plain versions
on the CPU. Weights come from the JAX model's init and reach the port
through ``mamba_lm_from_jax`` / ``causal_mixer_from_jax``; other inputs
are made by numpy from a seed. Small widths (d_model 32, 2 layers,
vocabulary 50 padded to 56) keep the file quick.
"""

import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_mamba_suite_tpu.models import MambaLMHeadModel as JaxLM
from video_mamba_suite_tpu.models import generation as jax_generation
from video_mamba_suite_tpu.models.hf import (
    from_pretrained as jax_from_pretrained,
)
from video_mamba_suite_tpu.models.mamba import MambaCausal as JaxCausal
from video_mamba_suite_tpu.models.mamba import make_block as jax_make_block
from video_mamba_suite_tpu.ops import causal_conv1d_update as jax_conv_update
from video_mamba_suite_tpu.ops import (
    selective_state_update as jax_state_update,
)
from video_mamba_suite_torch import build_mamba_lm
from video_mamba_suite_torch.configs import MAMBA_130M
from video_mamba_suite_torch.models import (
    GenerationConfig,
    MambaCausal,
    MambaDBM,
    MambaLMHeadModel,
    MixerModel,
    causal_mixer_from_jax,
    from_pretrained,
    generate,
    make_block,
    mamba_lm_from_jax,
    sample_logits,
)
from video_mamba_suite_torch.models.generation import filter_logits
from video_mamba_suite_torch.ops import (
    LAUNCHES,
    causal_conv1d_update,
    selective_state_update,
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


@pytest.fixture(autouse=True, scope="module")
def _jax_without_most_optimizations():
    """The JAX references here compile once each for small inputs: XLA's
    optimization passes would cost more CPU than they save, on cores the
    test workers share."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


# fp32 throughout: the two frameworks sum in other orders
TOL = dict(rtol=2e-5, atol=2e-5)
D_MODEL, N_LAYER, VOCAB = 32, 2, 50


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _jit(module, method=None):
    """``module.apply`` (with ``method``) compiled: eager flax dispatches
    op by op, many times slower on the CPU."""
    if method is None:
        return jax.jit(module.apply)
    return jax.jit(functools.partial(module.apply, method=method))


def _load(module, state_dict):
    module.load_state_dict(state_dict)
    return module


@pytest.fixture(scope="module")
def lm():
    """The JAX LM (d_model 32, 2 layers, vocabulary 50), its parameters,
    and the port's LM with the same weights."""
    model = JaxLM(d_model=D_MODEL, n_layer=N_LAYER, vocab_size=VOCAB)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 4), jnp.int32))
    port = _load(MambaLMHeadModel(D_MODEL, N_LAYER, VOCAB, device="cpu"),
                 mamba_lm_from_jax(params, N_LAYER))
    return model, params, port


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_causal_conv1d_update_matches_jax(x_dtype):
    """The rolling window in fp32 (the LM's conv state) with an fp32 or a
    bf16 token: the output in the token's dtype, the window promoted."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 12)).astype(np.float32)
    state = rng.standard_normal((3, 4, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    want, want_state = jax_conv_update(
        jnp.asarray(x).astype(x_dtype), jnp.asarray(state), jnp.asarray(w),
        jnp.asarray(b), activation="silu")
    got, got_state = causal_conv1d_update(
        _t(x).to(getattr(torch, x_dtype)), _t(state), _t(w), _t(b),
        activation="silu")
    assert str(got.dtype) == f"torch.{x_dtype}"
    assert got_state.dtype == torch.float32
    tol = TOL if x_dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    _close(got, want, **tol)
    _close(got_state, want_state)


@pytest.mark.parametrize("has_dz,bias", [(True, True), (False, False)])
def test_selective_state_update_matches_jax(has_dz, bias):
    rng = np.random.default_rng(1)
    b, d, n = 3, 12, 8
    args = dict(
        state=rng.standard_normal((b, d, n)), x=rng.standard_normal((b, d)),
        dt=0.5 * rng.random((b, d)) - 0.25, A=-rng.random((d, n)) - 0.1,
        B=rng.standard_normal((b, n)), C=rng.standard_normal((b, n)),
        D=rng.standard_normal(d), z=rng.standard_normal((b, d)),
        dt_bias=0.5 * rng.random(d))
    args = {k: v.astype(np.float32) for k, v in args.items()}
    if not has_dz:
        args.pop("D"), args.pop("z")
    if not bias:
        args.pop("dt_bias")
    want_y, want_h = jax_state_update(
        **{k: jnp.asarray(v) for k, v in args.items()}, dt_softplus=bias)
    got_y, got_h = selective_state_update(
        **{k: _t(v) for k, v in args.items()}, dt_softplus=bias)
    _close(got_y, want_y)
    _close(got_h, want_h)


def test_mamba_causal_matches_jax():
    """forward, prefill (at a prompt longer and one shorter than the conv
    window) and three decode steps."""
    jm = JaxCausal(d_model=24, d_state=8, d_conv=4, expand=2, impl="ref")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 10, 24)).astype(np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    port = _load(MambaCausal(24, d_state=8, d_conv=4, device="cpu"),
                 causal_mixer_from_jax(params))
    prefill, step = _jit(jm, "prefill"), _jit(jm, "step")
    with torch.no_grad():
        _close(port(_t(x)), _jit(jm)(params, jnp.asarray(x)))
        for L in (10, 3):
            want, (want_conv, want_ssm) = prefill(params,
                                                  jnp.asarray(x[:, :L]))
            got, (conv, ssm) = port.prefill(_t(x[:, :L]))
            _close(got, want)
            _close(conv, want_conv)
            _close(ssm, want_ssm)
        state, jstate = (conv, ssm), (want_conv, want_ssm)
        for t in range(3):
            tok = rng.standard_normal((2, 24)).astype(np.float32)
            want, jstate = step(params, jnp.asarray(tok), jstate)
            got, state = port.step(_t(tok), state)
            _close(got, want)
            _close(state[0], jstate[0])
            _close(state[1], jstate[1])


def test_mamba_causal_prefill_state_is_the_step_loop_state():
    """One prefill lands on the state that L steps reach from zero (the
    conv window and the SSM state), and its outputs are the forward's."""
    torch.manual_seed(0)
    port = MambaCausal(24, d_state=8, device="cpu")
    x = torch.randn(2, 10, 24, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for L in (10, 3):
            out, (conv, ssm) = port.prefill(x[:, :L])
            _close(out, port(x[:, :L]))
            state = port.init_state(2)
            for t in range(L):
                _, state = port.step(x[:, t], state)
            _close(conv, state[0])
            _close(ssm, state[1], rtol=1e-5, atol=1e-5)


def test_block_matches_jax():
    jb = jax_make_block(24, mixer="causal", rms_norm_block=True,
                        d_state=8, impl="ref")
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, 6, 24)).astype(np.float32)
    r = rng.standard_normal((2, 6, 24)).astype(np.float32)
    params = jax.jit(jb.init)(jax.random.PRNGKey(2), jnp.asarray(h),
                              jnp.asarray(r))
    tree = params["params"]
    sd = causal_mixer_from_jax(tree["mixer"], "mixer.")
    sd["norm_w"] = _t(np.asarray(tree["norm_w"]))
    port = _load(make_block(24, mixer="causal", rms_norm_block=True,
                            d_state=8, device="cpu"), sd)
    with torch.no_grad():
        want_h, want_r = _jit(jb)(params, jnp.asarray(h), jnp.asarray(r))
        got_h, got_r = port(_t(h), _t(r))
        _close(got_h, want_h)
        _close(got_r, want_r)
        want_h, want_r, want_s = _jit(jb, "prefill")(params,
                                                     jnp.asarray(h))
        got_h, got_r, got_s = port.prefill(_t(h))
        for g, w in ((got_h, want_h), (got_r, want_r), *zip(got_s, want_s)):
            _close(g, w)
        want = _jit(jb, "step")(params, jnp.asarray(h[:, 0]),
                                jnp.asarray(r[:, 0]), want_s)
        got = port.step(_t(h[:, 0]), _t(r[:, 0]), got_s)
        for g, w in ((got[0], want[0]), (got[1], want[1]),
                     *zip(got[2], want[2])):
            _close(g, w)


def test_make_block_refuses_the_unported_dbm_mixer():
    """make_block("dbm") builds a Block around a MambaDBM (expand 1 here,
    as the task suites build it); an unknown mixer and the LM's MoE
    interleave are refused."""
    block = make_block(16, mixer="dbm", device="cpu", expand=1)
    assert isinstance(block.mixer, MambaDBM)
    assert block.mixer.in_proj.weight.shape == (64, 16)
    assert block.mixer.out_proj.weight.shape == (16, 32)
    hidden, residual = block(torch.randn(2, 9, 16))
    assert hidden.shape == residual.shape == (2, 9, 16)
    with pytest.raises(ValueError, match="unknown mixer"):
        make_block(16, mixer="dbm2", device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        MixerModel(16, 1, 8, moe_every=1, generator=torch.Generator())


@pytest.mark.parametrize("prompt", [4, 72])
def test_lm_logits_prefill_and_states_match_jax(lm, prompt):
    """Prompt 4 takes the short scan, 72 the chunked one on the card; here
    both run the plain version against the JAX LM."""
    model, params, port = lm
    ids = np.random.default_rng(prompt).integers(0, VOCAB, (2, prompt))
    ids = ids.astype(np.int32)
    with torch.no_grad():
        _close(port(_t(ids).long()), _jit(model)(params, jnp.asarray(ids)))
        want, want_states = _jit(model, "prefill")(params, jnp.asarray(ids))
        got, states = port.prefill(_t(ids).long())
    assert got.shape == (2, 56) == want.shape
    _close(got, want)
    assert len(states) == len(want_states) == N_LAYER
    for (conv, ssm), (want_conv, want_ssm) in zip(states, want_states):
        _close(conv, want_conv)
        _close(ssm, want_ssm)


def test_lm_init_states_are_jax_zero_states_and_reach_the_prefill(lm):
    """Each layer's zero state has the JAX shapes and dtypes, and the step
    loop from it over a prompt ends at the prefill's logits and states."""
    model, params, port = lm
    want = model.init_states(2)
    states = port.init_states(2)
    assert len(states) == len(want) == N_LAYER
    for got, ref in zip(states, want):
        for g, w in zip(got, ref):
            assert g.shape == w.shape and g.dtype == torch.float32
            assert not g.any()
    ids = torch.tensor([[3, 7, 1, 4, 0], [9, 2, 2, 8, 5]])
    with torch.no_grad():
        want_logits, want_states = port.prefill(ids)
        for t in range(ids.shape[1]):
            logits, states = port.step(ids[:, t], states)
    _close(logits, want_logits)
    for got, ref in zip(states, want_states):
        _close(got[0], ref[0])
        _close(got[1], ref[1])


@pytest.mark.parametrize("prefill,max_length", [(True, 12), (False, 12),
                                                (True, 5)])
def test_greedy_generate_matches_jax(lm, prefill, max_length):
    """Token for token, with the batched prefill, with the pure step loop,
    and with a single new token (genlen 1)."""
    model, params, port = lm
    ids = np.array([[3, 7, 1, 4], [9, 2, 2, 8]], np.int32)
    config = jax_generation.GenerationConfig(max_length=max_length)
    want = jax.jit(lambda p, i: jax_generation.generate(
        model, p, i, config, prefill=prefill))(params, jnp.asarray(ids))
    before = dict(LAUNCHES)
    got = generate(port, _t(ids).long(),
                   GenerationConfig(max_length=max_length), prefill=prefill)
    assert dict(LAUNCHES) == before
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bf16_lm_matches_jax_with_the_same_cast(lm):
    """Every floating parameter cast to bf16 on both sides (the serving
    cast of bench.py's decode point). The two frameworks round the bf16
    intermediates at other places: the logits (scale 0.37) read 3.2e-3
    apart, held at 2e-2."""
    model, params, port = lm
    bf16 = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x,
        params)
    port = _load(MambaLMHeadModel(D_MODEL, N_LAYER, VOCAB, device="cpu"),
                 port.state_dict()).to(torch.bfloat16)
    ids = np.random.default_rng(5).integers(0, VOCAB, (2, 8)).astype(
        np.int32)
    want, want_states = _jit(model, "prefill")(bf16, jnp.asarray(ids))
    step_want, _ = _jit(model, "step")(bf16, jnp.asarray(ids[:, 0]),
                                       want_states)
    with torch.no_grad():
        got, states = port.prefill(_t(ids).long())
        step_got, _ = port.step(_t(ids[:, 0]).long(), states)
    assert got.dtype == torch.bfloat16 and states[0][1].dtype == torch.float32
    bf16_tol = dict(rtol=2e-2, atol=2e-2)
    _close(got, want, **bf16_tol)
    _close(step_got, step_want, **bf16_tol)


@pytest.mark.parametrize("top_k,top_p,temperature", [
    (5, 0.0, 1.0), (0, 0.6, 1.0), (10, 0.8, 0.7)])
def test_sampling_filter_keeps_the_jax_tokens(monkeypatch, top_k, top_p,
                                              temperature):
    """The port's filter keeps exactly the tokens that JAX's
    ``sample_logits`` hands to its categorical draw."""
    seen = []

    def categorical(key, logits, axis=-1):
        seen.append(np.asarray(logits))
        return jnp.argmax(logits, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", categorical)
    logits = np.random.default_rng(6).standard_normal((4, 56)).astype(
        np.float32) * 2
    jax_generation.sample_logits(jax.random.PRNGKey(0), jnp.asarray(logits),
                                 top_k, top_p, temperature)
    got = filter_logits(_t(logits), top_k, top_p, temperature)
    np.testing.assert_array_equal(np.isfinite(got.numpy()),
                                  np.isfinite(seen[0]))
    assert 0 < np.isfinite(seen[0]).sum() < logits.size
    kept = np.isfinite(seen[0])
    np.testing.assert_allclose(got.numpy()[kept], seen[0][kept], **TOL)
    # the port's draws (64 per row) fall on kept tokens only
    rows = _t(logits).repeat_interleave(64, dim=0)
    draws = sample_logits(rows, top_k, top_p, temperature,
                          generator=torch.Generator().manual_seed(0))
    assert kept[np.arange(4).repeat(64), draws.numpy()].all()


def _upstream_state_dict(d_model, n_layer, vocab, seed):
    """A random upstream ``state-spaces/mamba-*`` state_dict."""
    g = torch.Generator().manual_seed(seed)
    d_inner, n, dt_rank = 2 * d_model, 16, math.ceil(d_model / 16)

    def r(*shape):
        return 0.1 * torch.randn(*shape, generator=g)

    sd = {"backbone.embedding.weight": r(vocab, d_model),
          "backbone.norm_f.weight": 1 + r(d_model),
          "lm_head.weight": torch.zeros(1)}
    for i in range(n_layer):
        p = f"backbone.layers.{i}."
        sd.update({
            p + "norm.weight": 1 + r(d_model),
            p + "mixer.in_proj.weight": r(2 * d_inner, d_model),
            p + "mixer.conv1d.weight": r(d_inner, 1, 4),
            p + "mixer.conv1d.bias": r(d_inner),
            p + "mixer.x_proj.weight": r(dt_rank + 2 * n, d_inner),
            p + "mixer.dt_proj.weight": r(d_inner, dt_rank),
            p + "mixer.dt_proj.bias": r(d_inner),
            p + "mixer.A_log": torch.log(torch.arange(1, n + 1.0)).repeat(
                d_inner, 1),
            p + "mixer.D": 1 + r(d_inner),
            p + "mixer.out_proj.weight": r(d_model, d_inner),
        })
    return sd


def test_from_pretrained_matches_jax_from_pretrained(tmp_path):
    """A local directory in the upstream layout (config.json and
    pytorch_model.bin) through both loaders gives the same logits; a bare
    checkpoint file with its config dict loads too, and a name that is no
    local path raises FileNotFoundError."""
    sd = _upstream_state_dict(D_MODEL, N_LAYER, 56, seed=7)
    torch.save(sd, tmp_path / "pytorch_model.bin")
    config = dict(d_model=D_MODEL, n_layer=N_LAYER, vocab_size=VOCAB,
                  ssm_cfg={}, rms_norm=True, pad_vocab_size_multiple=8)
    (tmp_path / "config.json").write_text(json.dumps(config))
    jm, jparams = jax_from_pretrained(str(tmp_path))
    ids = np.random.default_rng(8).integers(0, VOCAB, (2, 6)).astype(
        np.int32)
    want = _jit(jm)(jax.tree_util.tree_map(jnp.asarray, jparams),
                    jnp.asarray(ids))
    port = from_pretrained(str(tmp_path), device="cpu")
    with torch.no_grad():
        _close(port(_t(ids).long()), want)
    bare = from_pretrained(str(tmp_path / "pytorch_model.bin"),
                           config=config, device="cpu")
    with torch.no_grad():
        _close(bare(_t(ids).long()), want)
    with pytest.raises(FileNotFoundError):
        from_pretrained("state-spaces/mamba-130m", device="cpu")


def test_mamba_130m_has_its_published_widths():
    model = build_mamba_lm(MAMBA_130M, device="cpu")
    assert (model.d_model, model.n_layer, model.padded_vocab) == \
        (768, 24, 50280)
    mixer = model.backbone.layers[0].mixer
    assert mixer.fwd.A_log.shape == (1536, 16)
    assert mixer.fwd.conv_w.shape == (4, 1536)
    assert model.backbone.layers[0].norm_b is None       # RMSNorm
    # 129.1 M with the head tied to the embedding, as upstream counts
    assert sum(p.numel() for p in model.parameters()) == 129_135_360
    emb = model.backbone.embedding.weight
    assert abs(emb.std().item() - 0.02) < 1e-3
