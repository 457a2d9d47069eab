"""The rest of the port's Mamba LM against the JAX package's, on the CPU at
small widths: the int8 serving weights (``quantize_lm_for_decode``,
``W8Dense``, ``W8Embed``, the scaled tied head, ``quantized_lm_from_jax``)
and the scoring of ``models/lm_eval.py`` (``sequence_loglikelihood``,
``perplexity``, ``MambaHarnessLM``) on the character tokenizer of
tests/test_lm_eval.py. One JAX LM (2 layers, width 32, a vocabulary of
31 padded to 32) is shared by every test; its weights are carried over by
``mamba_lm_from_jax``."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_lm_eval import CharTokenizer, Instance
from video_mamba_suite_torch.models import (
    Dense,
    Embedding,
    MambaHarnessLM,
    MambaLMHeadModel,
    W8Dense,
    W8Embed,
    mamba_lm_from_jax,
    perplexity,
    quantize_lm_for_decode,
    quantized_lm_from_jax,
    register,
    sequence_loglikelihood,
)
from video_mamba_suite_torch.models.generation import (
    GenerationConfig,
    generate,
)
from video_mamba_suite_tpu.models import MambaLMHeadModel as JaxLM
from video_mamba_suite_tpu.models import lm_eval as jax_lm_eval
from video_mamba_suite_tpu.models.quant_decode import \
    quantize_lm_for_decode as jax_quantize


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


D_MODEL, N_LAYER = 32, 2
VOCAB = len(CharTokenizer.alphabet) + 1
# scores in fp32 on both sides, sums in another order
LL_RTOL = 1e-4
# the int8 model's logits against the JAX int8 model's, over the logits'
# largest magnitude: both read the same int8 bytes and bf16 leaves, but the
# activations are rounded to bf16 at each projection's input in another
# order. The JAX model itself moves 0.4-0.8% of that scale between bf16
# and fp32 leaves on these inputs; the port lands 0.5-1.1% from it.
W8_REL_TOL = 2e-2


@pytest.fixture(scope="module")
def lm():
    """The JAX LM, its fp32 parameters and the port's copy (fp32, CPU)."""
    model = JaxLM(d_model=D_MODEL, n_layer=N_LAYER, vocab_size=VOCAB)
    params = jax.jit(model.init)(jax.random.PRNGKey(3),
                                 jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params)
    port = MambaLMHeadModel(D_MODEL, N_LAYER, VOCAB, device="cpu")
    port.load_state_dict(mamba_lm_from_jax(params, N_LAYER), strict=True)
    return model, params, port.eval()


def _ids(seed, batch=3, length=12):
    rng = np.random.default_rng(seed)
    return rng.integers(0, VOCAB, (batch, length)).astype(np.int32)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def test_w8_modules_are_the_plain_ones_until_quantized():
    """Without int8 state, W8Dense is Dense and W8Embed is Embedding: the
    same parameters from the same generator, the same outputs, no buffer
    in the state."""
    x = torch.randn(3, 5, 16, generator=torch.Generator().manual_seed(0))
    ids = torch.tensor([[1, 4, 9], [0, 2, 2]])
    for cls, plain, arg in ((W8Dense, Dense, x), (W8Embed, Embedding, ids)):
        a = cls(16 if cls is W8Dense else 10, 8,
                generator=torch.Generator().manual_seed(1))
        b = plain(16 if cls is W8Dense else 10, 8,
                  generator=torch.Generator().manual_seed(1))
        assert list(a.state_dict()) == list(b.state_dict())
        torch.testing.assert_close(a.weight, b.weight, rtol=0, atol=0)
        torch.testing.assert_close(a(arg), b(arg), rtol=0, atol=0)


def test_quantize_matches_jax(lm):
    """The int8 tensors equal the JAX package's bit for bit, the scales
    within 1e-7, and every other leaf has the JAX dtype (bf16)."""
    model, params, port = lm
    want = jax_quantize(params)
    quant = quantize_lm_for_decode(copy.deepcopy(port))
    assert quant.backbone.embedding.qscale is not None
    got = quant.state_dict()
    p, s = want["params"]["backbone"], want["qscale"]["backbone"]
    checks = [("backbone.embedding", p["embedding"]["embedding"],
               s["embedding"]["embedding"], False)]
    for i in range(N_LAYER):
        for proj in ("in_proj", "out_proj"):
            checks.append((f"backbone.layers.{i}.mixer.{proj}",
                           p[f"layers_{i}"]["mixer"][proj]["kernel"],
                           s[f"layers_{i}"]["mixer"][proj]["kernel"], True))
    for prefix, q, scale, transposed in checks:
        q = np.asarray(q)
        assert q.dtype == np.int8
        w = got[prefix + ".weight"]
        assert w.dtype == torch.int8
        np.testing.assert_array_equal(w.numpy(), q.T if transposed else q)
        np.testing.assert_allclose(got[prefix + ".qscale"].numpy(),
                                   np.asarray(scale), rtol=1e-7, atol=0)
    # every other leaf: the JAX dtype and the same values
    state = quantized_lm_from_jax(want, N_LAYER)
    assert set(state) == set(got)
    for key, value in got.items():
        assert state[key].dtype == value.dtype, key
        if key.endswith("qscale"):
            continue
        torch.testing.assert_close(value, state[key], rtol=0, atol=0,
                                   msg=key)
    bf16 = [path for path, leaf in _leaves(want["params"])
            if np.asarray(leaf).dtype != np.int8]
    assert all(np.asarray(leaf).dtype.name == "bfloat16"
               for path, leaf in _leaves(want["params"])
               if np.asarray(leaf).dtype != np.int8) and bf16
    assert all(v.dtype in (torch.int8, torch.bfloat16)
               for k, v in got.items() if not k.endswith("qscale"))


def _jax_int8_model(lm):
    """The JAX int8 variables and a port model holding the same bytes."""
    model, params, port = lm
    want = jax_quantize(params)
    quant = quantize_lm_for_decode(copy.deepcopy(port))
    quant.load_state_dict(quantized_lm_from_jax(want, N_LAYER), strict=True)
    return model, want, quant


def test_w8_logits_match_jax(lm):
    """The int8 model's forward logits (fp32, the tied head scaled per
    vocabulary column) against JAX ``apply`` with the qscale collection;
    its prefill ends on the forward's last logits."""
    model, want_vars, quant = _jax_int8_model(lm)
    ids = _ids(0)
    want = np.asarray(jax.jit(model.apply)(want_vars, jnp.asarray(ids)))
    with torch.inference_mode():
        got = quant(torch.from_numpy(ids).long())
        last, _ = quant.prefill(torch.from_numpy(ids).long())
    assert got.dtype == last.dtype == torch.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=W8_REL_TOL * scale)
    torch.testing.assert_close(last, got[:, -1], rtol=0, atol=1e-5 * scale)


def test_generate_runs_unchanged_on_the_int8_model(lm):
    """``generate`` on the int8 model: the prompt kept, ids in the
    vocabulary, the greedy tokens the same with and without the prefill."""
    _, _, quant = _jax_int8_model(lm)
    prompt = torch.from_numpy(_ids(1, batch=2, length=5)).long()
    config = GenerationConfig(max_length=12)
    out = generate(quant, prompt, config)
    assert tuple(out.shape) == (2, 12)
    assert torch.equal(out[:, :5], prompt)
    assert bool(((out >= 0) & (out < quant.padded_vocab)).all())
    torch.testing.assert_close(generate(quant, prompt, config,
                                        prefill=False), out)


class _CompiledApply:
    """The JAX LM with its ``apply`` compiled: the JAX scoring functions
    call ``model.apply`` (and ``generate`` its prefill and step), which
    run eagerly op by op unless compiled, and then take most of a test's
    time."""

    def __init__(self, model):
        self.apply = jax.jit(model.apply, static_argnames="method")
        self.init_states = model.init_states


@pytest.fixture(scope="module")
def harnesses(lm):
    """The JAX adapter and the port's on the same weights: batches of 4
    cut to 16 tokens."""
    model, params, port = lm
    return (jax_lm_eval.MambaHarnessLM(_CompiledApply(model), params,
                                       CharTokenizer(),
                                       max_length=16, batch_size=4),
            MambaHarnessLM(port, CharTokenizer(), max_length=16,
                           batch_size=4))


def test_loglikelihood_and_perplexity_match_jax(lm, harnesses):
    """``sequence_loglikelihood`` with every token and with a continuation
    scored (the JAX adapter's compiled scorer, one (4, 16) shape), and
    ``perplexity``."""
    model, params, port = lm
    ids = _ids(2, batch=4, length=16)
    mask = np.ones(ids.shape, np.float32)
    mask[:, :7] = 0.0
    for m in (np.ones(ids.shape, np.float32), mask):
        want = harnesses[0]._ll_fn(params, jnp.asarray(ids), jnp.asarray(m))
        got = sequence_loglikelihood(port, torch.from_numpy(ids).long(),
                                     torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=LL_RTOL)
    want = jax_lm_eval.perplexity(_CompiledApply(model), params,
                                  jnp.asarray(ids))
    got = perplexity(port, torch.from_numpy(ids).long())
    assert got == pytest.approx(want, rel=LL_RTOL)


def test_harness_entry_points_match_jax(harnesses):
    """loglikelihood (an empty context, sequences cut to their last 16
    tokens, the greedy flags), loglikelihood_rolling and generate_until
    (stop strings) against the JAX adapter. Every batch is 4 requests
    padded to 16 tokens, so the JAX scorer compiles once."""
    jax_lm, port_lm = harnesses
    docs = [("the cat sat on the", " mat"), ("a dog ran far away", " now"),
            ("", "hello there friend"), ("a long context to cut", " down")]
    reqs = [Instance("loglikelihood", {}, doc, i)
            for i, doc in enumerate(docs)]
    want, got = jax_lm.loglikelihood(reqs), port_lm.loglikelihood(reqs)
    assert len(got) == len(docs)
    for (g_ll, g_greedy), (w_ll, w_greedy) in zip(got, want):
        assert isinstance(g_ll, float) and isinstance(g_greedy, bool)
        assert g_ll == pytest.approx(w_ll, rel=LL_RTOL)
        assert g_greedy == w_greedy
    rolling = [Instance("loglikelihood_rolling", {}, (text,), i)
               for i, text in enumerate((
                   "the cat sat on the mat", "a dog ran far away now",
                   "hello there my friend", "is it yes or is it no"))]
    np.testing.assert_allclose(port_lm.loglikelihood_rolling(rolling),
                               jax_lm.loglikelihood_rolling(rolling),
                               rtol=LL_RTOL)
    gens = [Instance("generate_until", {},
                     ("the", {"until": ["a", "e"], "max_gen_toks": 8}), 0)]
    assert port_lm.generate_until(gens) == jax_lm.generate_until(gens)


def test_harness_greedy_flag_on_its_own_continuation(harnesses):
    """The model's own greedy continuation is flagged greedy and others
    are not, as the JAX adapter flags them; only the scored positions are
    checked."""
    jax_lm, port_lm = harnesses
    ctx = "the cat sat on"
    text = port_lm.generate_until(
        [Instance("generate_until", {}, (ctx, {"max_gen_toks": 3}), 0)])[0]
    conts = (text or "a", "zzzzqqqq", " the mat", " a dog")
    reqs = [Instance("loglikelihood", {}, (ctx, c), i)
            for i, c in enumerate(conts)]
    got, want = port_lm.loglikelihood(reqs), jax_lm.loglikelihood(reqs)
    assert [g for _, g in got] == [g for _, g in want]
    if text:
        assert got[0][1]


def test_register_without_lm_eval():
    """``lm_eval`` is not installed: registering reports False, as the
    JAX ``register`` does."""
    assert register() is False
    assert jax_lm_eval.register() is False
