"""The port's dense video captioning slice against the JAX package's, on the
CPU: the 1-D deformable sampling and attention, PDVC-Mamba's modules (the
ViM and DBM encoder layers, the decoder layer, the box MLP, the LSTM
cell and both caption heads, teacher-forced and greedy), the ``PDVC``
forward, the matcher, the criterion, one ``CaptioningTrainer`` step's
matching, losses and gradients, the clipped AdamW update, ``predict``,
the data, the presets and the converter.

JAX runs its models with ``impl="assoc"``; the port runs its plain
versions on the CPU. Two small models are shared by the tests through
module fixtures, each compiled once: the LSTM-DSA model (ViM, 2 levels of
64 + 32 tokens: one chunked scan per direction, a ragged mask) and the
light-head model (DBM, 32 + 16 tokens: the fused scan). Dropout cannot
be matched across the two frameworks' generators, so the step is held
with dropout off (the JAX ``deterministic=True``), its loss built from
the functions the JAX trainer's ``make_loss_fn`` calls, the Hungarian
match through the same host callback. Weights are drawn by numpy from a
seed into the JAX tree's shapes and reach the port through
``pdvc_from_jax``.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from video_mamba_suite_tpu.configs.presets import PRESETS
from video_mamba_suite_tpu.data import tokenizer as jax_tokenizer
from video_mamba_suite_tpu.ops import deform_attn as jax_deform
from video_mamba_suite_tpu.tasks.captioning import criterion as jax_criterion
from video_mamba_suite_tpu.tasks.captioning import data as jax_data
from video_mamba_suite_tpu.tasks.captioning import matcher as jax_matcher
from video_mamba_suite_tpu.tasks.captioning import model as jax_model
from video_mamba_suite_tpu.tasks.captioning import train as jax_train
from video_mamba_suite_torch import configs
from video_mamba_suite_torch.data import WordTokenizer
from video_mamba_suite_torch.models import (
    dbm_mixer_from_jax,
    pdvc_from_jax,
    vim_mixer_from_jax,
)
from video_mamba_suite_torch.ops import deform_attn
from video_mamba_suite_torch.tasks import captioning as cap
from video_mamba_suite_torch.tasks.captioning import model as port_model

# fp32: each output within 1e-5 of its largest magnitude (and 1e-5
# relative); the two frameworks sum in other orders
REL_TOL = 1e-5
# a loss term within 1e-5 relative
LOSS_TOL = 1e-5
# gradients through the encoder, the decoder and the caption head: within
# 1e-4 of each parameter's largest gradient, plus 1e-6 of the model's
# largest (the attention key bias and the DSA head's alpha_net bias shift
# every logit of a softmax alike, so their exact gradient is 0 and both
# frameworks give rounding noise)
GRAD_TOL = 1e-4
GRAD_FLOOR = 1e-6
# AdamW fed the same gradients: each parameter within two fp32 ulps of
# its value and 5e-8 absolute (optax's bias correction in fp32, torch's in
# float64)
ADAM_RTOL = 2.5e-7
ADAM_ATOL = 5e-8
B, C, D, Q, G, VOCAB = 2, 12, 32, 6, 3, 12
# greedy captions of 2 tokens; teacher-forced captions of 3 (BOS, 0 or 1
# word, EOS, padding): each step of the unrolled heads costs the JAX
# compile seconds
CAP_LEN, CAP_TOKENS = 2, 3


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


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rel=REL_TOL, msg=""):
    w = _np(want)
    np.testing.assert_allclose(_np(got), w, atol=rel * np.abs(w).max(),
                               rtol=rel, err_msg=msg)


def _draw(shapes, seed):
    """Parameters for a JAX tree of ``shapes`` as fp32 numpy arrays in the
    ranges the inits give (A_log = log of 1..16, small dt, norms near
    1)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "A_log":
            x = np.log(rng.uniform(1.0, 16.0, shape))
        elif name == "dt_bias":
            x = np.log(np.expm1(rng.uniform(0.01, 0.1, shape)))
        elif name == "scale":
            x = rng.uniform(0.5, 1.5, shape)
        elif len(shape) <= 1:
            x = 0.5 * rng.standard_normal(shape)
        elif len(shape) == 3:              # conv (k, in, out), MHA kernels
            x = rng.standard_normal(shape) / np.sqrt(shape[0] * shape[1])
        else:
            x = rng.standard_normal(shape) / np.sqrt(shape[0])
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _init(module, seed, *args, method=None, **kwargs):
    """A parameter tree for ``module`` from ``jax.eval_shape``, drawn by
    ``_draw``."""
    shapes = jax.eval_shape(
        functools.partial(module.init, method=method, **kwargs),
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        *args)
    return _draw(shapes, seed)


def _jax_pdvc(caption_decoder_type, mixer, n_levels=2):
    return jax_model.PDVC(
        input_dim=C, num_classes=1, vocab_size=VOCAB, num_queries=Q,
        d_model=D, n_levels=n_levels, num_encoder_layers=1,
        num_decoder_layers=2, max_caption_len=CAP_LEN, mixer=mixer,
        caption_decoder_type=caption_decoder_type, impl="assoc")


def _port_pdvc(params, caption_decoder_type, mixer, n_levels=2):
    model = cap.PDVC(C, vocab_size=VOCAB, num_queries=Q, d_model=D,
                     n_levels=n_levels, num_encoder_layers=1,
                     num_decoder_layers=2, max_caption_len=CAP_LEN,
                     mixer=mixer, caption_decoder_type=caption_decoder_type,
                     device="cpu")
    model.load_state_dict(pdvc_from_jax(params), strict=True)
    return model.eval()


def _batch(T, seed):
    """A batch of 2 videos of T steps (the second's last T/4 padded),
    3 event slots (the second video's third invalid), captions framed as
    the data loader frames them: BOS 1, the words (here 0 or 1), EOS 2,
    then -100."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, T, C)).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[1, T - T // 4:] = 0.0
    feats[1, T - T // 4:] = 0.0
    centers = rng.uniform(0.2, 0.8, (B, G))
    lengths = rng.uniform(0.1, 0.4, (B, G))
    gt_boxes = np.stack([centers, lengths], -1).astype(np.float32)
    gt_labels = np.zeros((B, G), np.int32)
    gt_valid = np.ones((B, G), bool)
    gt_valid[1, 2] = False
    captions = np.full((B, G, CAP_TOKENS), -100, np.int64)
    for b in range(B):
        for g in range(G):
            n = int(rng.integers(0, CAP_TOKENS - 1))
            words = rng.integers(4, VOCAB, n)
            captions[b, g, :n + 2] = [1, *words, 2]
    return feats, mask, gt_boxes, gt_labels, gt_valid, captions


def _jax_step(jm, grad):
    """The JAX trainer's loss with dropout off (``make_loss_fn``'s
    functions: the forward, ``match_cost``, ``hungarian_match`` through
    its host callback, the caption logits of the matched queries,
    ``pdvc_losses``), with ``grad`` its gradients, compiled as one
    function."""

    def loss_fn(p, feats, mask, gt_boxes, gt_labels, gt_valid, captions):
        out = jm.apply(p, feats, mask, deterministic=True)
        cost = jax.vmap(jax_matcher.match_cost)(
            out["pred_logits"], out["pred_boxes"], gt_labels, gt_boxes,
            gt_valid)
        match_idx = jax_matcher.hungarian_match(
            jax.lax.stop_gradient(cost), jnp.sum(gt_valid, axis=1))
        safe_idx = jnp.clip(match_idx, 0, Q - 1)
        qf = jax.vmap(lambda h, i: h[i])(out["query_feats"], safe_idx)
        Bn, Gn, L = captions.shape
        cap_in = jnp.where(captions == -100, 0, captions)
        cap_kw = {}
        if jm.caption_decoder_type == "standard":
            boxes = jax.vmap(lambda b, i: b[i])(out["pred_boxes"], safe_idx)
            cap_kw = dict(refs=boxes.reshape(Bn * Gn, 2),
                          memory=jnp.repeat(out["memory"], Gn, axis=0),
                          shapes=jm.level_shapes(feats.shape[1]))
        cap_logits = jm.apply(
            p, qf.reshape(Bn * Gn, -1), cap_in.reshape(Bn * Gn, L),
            method="caption_logits", **cap_kw).reshape(Bn, Gn, L, -1)
        losses = jax_criterion.pdvc_losses(
            out, gt_boxes, gt_labels, gt_valid, match_idx,
            caption_logits=cap_logits[:, :, :-1],
            caption_targets=captions[:, :, 1:])
        aux = dict(out=out, cost=cost, match_idx=match_idx,
                   cap_logits=cap_logits)
        return losses["loss_total"], (losses, aux)

    def step(p, feats, mask, *targets):
        if grad:
            (_, (losses, aux)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(p, feats, mask, *targets)
            return losses, aux, grads
        return loss_fn(p, feats, mask, *targets)[1] + (None,)

    return jax.jit(step)


def _jax_greedy(jm):
    """The JAX trainer's ``fwd`` after the forward: every query's greedy
    caption, compiled apart from the step."""

    def greedy(p, out, T):
        Bn = out["query_feats"].shape[0]
        cap_kw = {}
        if jm.caption_decoder_type == "standard":
            cap_kw = dict(refs=out["pred_boxes"].reshape(Bn * Q, 2),
                          memory=jnp.repeat(out["memory"], Q, axis=0),
                          shapes=jm.level_shapes(T))
        caps, lps = jm.apply(p, out["query_feats"].reshape(Bn * Q, -1),
                             method="caption_greedy", **cap_kw)
        return caps.reshape(Bn, Q, -1), lps.reshape(Bn, Q, -1)

    return jax.jit(greedy, static_argnums=2)


def _fixture(caption_decoder_type, mixer, T, seed, grad):
    jm = _jax_pdvc(caption_decoder_type, mixer)
    batch = _batch(T, seed)
    # the parameters' shapes do not depend on the length: traced at 8 steps
    params = _init(jm, seed, jnp.zeros((1, 8, C)), jnp.ones((1, 8)),
                   method="init_all")
    args = (params, *(jnp.asarray(x) for x in batch))
    # the gradients at XLA's backend optimization level 1: at level 0 (the
    # module's setting) the CPU backend gives NaN gradients through the
    # count head's max over the queries, a JAX-side artifact (the eager
    # JAX gradient is finite)
    options = dict(xla_backend_optimization_level=1) if grad else {}
    losses, aux, grads = _jax_step(jm, grad).lower(*args).compile(
        compiler_options=options)(*args)
    return dict(jm=jm, batch=batch, params=params, losses=losses, aux=aux,
                grads=grads, kind=caption_decoder_type, mixer=mixer)


def _with_greedy(fx):
    """The fixture with its greedy captions, compiled without XLA's
    optimizations."""
    fx["caps"], fx["lps"] = _jax_greedy(fx["jm"])(
        fx["params"], fx["aux"]["out"], fx["batch"][0].shape[1])
    return fx


@pytest.fixture(scope="module")
def dsa():
    """The LSTM-DSA model, ViM encoder, 2 levels of 64 + 32 tokens (one
    chunked scan per direction), on the ragged batch, with the step's
    gradients."""
    return _with_greedy(_fixture("standard", "vim", 64, 21, grad=True))


@pytest.fixture(scope="module")
def light(dsa):
    """The light-head model: the LSTM-DSA fixture's weights but for its
    caption head, an LSTM head drawn anew, so its forward and matching
    are the fixture's. The head compiled alone (teacher-forced on the
    matched events, greedy on every query), the losses from them."""
    head = jax_model.LSTMCaptioner(vocab_size=VOCAB, d_model=D,
                                   max_caption_len=CAP_LEN)
    feats, mask, boxes, labels, valid, captions = dsa["batch"]
    out, idx = dsa["aux"]["out"], dsa["aux"]["match_idx"]
    qf = jax.vmap(lambda h, i: h[i])(out["query_feats"],
                                     jnp.clip(idx, 0, Q - 1))
    cap_in = jnp.where(captions == -100, 0, captions).reshape(B * G, -1)
    hp = _init(head, 23, qf.reshape(B * G, D), cap_in)

    def run(hp, qf, cap_in, qf_all):
        logits = head.apply(hp, qf, cap_in).reshape(B, G, CAP_TOKENS, -1)
        caps, lps = head.apply(hp, qf_all, method="decode_greedy")
        return logits, caps.reshape(B, Q, -1), lps.reshape(B, Q, -1)

    logits, caps, lps = jax.jit(run)(hp, qf.reshape(B * G, D), cap_in,
                                     out["query_feats"].reshape(B * Q, D))
    losses = jax.jit(jax_criterion.pdvc_losses)(
        out, boxes, labels, valid, idx, caption_logits=logits[:, :, :-1],
        caption_targets=captions[:, :, 1:])
    params = {"params": dict(dsa["params"]["params"],
                             caption_head=hp["params"])}
    return dict(dsa, jm=_jax_pdvc("light", "vim"), params=params,
                losses=losses, aux=dict(dsa["aux"], cap_logits=logits),
                grads=None, caps=caps, lps=lps, kind="light")


def _port(fx):
    return _port_pdvc(fx["params"], fx["kind"], fx["mixer"])


def _trainer(fx):
    return cap.CaptioningTrainer(_port(fx))


# --------------------------------------------------------------------------
# deformable sampling and attention


@pytest.mark.parametrize("T", [1, 7, 16])
def test_linear_sample_1d_matches_jax(T):
    """Locations inside, at the edges of and outside [0, 1]: the clamped
    neighbours, and the gradients to the values and the locations."""
    rng = np.random.default_rng(T)
    value = rng.standard_normal((3, T, 5)).astype(np.float32)
    loc = rng.uniform(-0.3, 1.3, (3, 4, 6)).astype(np.float32)
    loc[0, 0, :3] = [0.0, 1.0, 0.5 / T]
    cot = rng.standard_normal((3, 4, 6, 5)).astype(np.float32)

    def f(v, l):
        return jnp.sum(jax_deform._linear_sample_1d(v, l) * cot)

    want, (wv, wl) = jax.jit(lambda v, l: (
        jax_deform._linear_sample_1d(v, l),
        jax.grad(f, argnums=(0, 1))(v, l)))(value, loc)
    v, l = _t(value).requires_grad_(), _t(loc).requires_grad_()
    got = deform_attn.linear_sample_1d(v, l)
    (got * _t(cot)).sum().backward()
    _close(got, want)
    _close(v.grad, wv)
    _close(l.grad, wl)


@pytest.mark.parametrize("ref_width", [1, 2])
def test_msdeform_attn_matches_jax(ref_width):
    """``ms_deform_attn_core`` on the module's own sampling and the whole
    ``MSDeformAttn1D`` with a padding mask, for 1-wide reference points
    (offsets in each level's steps) and (center, length) boxes."""
    rng = np.random.default_rng(ref_width)
    shapes = [10, 5, 3]
    mod = jax_deform.MSDeformAttn1D(d_model=16, n_levels=3, n_heads=4,
                                    n_points=2)
    q = rng.standard_normal((2, 5, 16)).astype(np.float32)
    src = rng.standard_normal((2, sum(shapes), 16)).astype(np.float32)
    ref = rng.uniform(0.05, 0.95, (2, 5, 3, ref_width)).astype(np.float32)
    pad = np.zeros((2, sum(shapes)), bool)
    pad[1, 7:10] = True
    params = _init(mod, 3, q, ref, src, temporal_shapes=shapes,
                   input_padding_mask=pad)
    want = jax.jit(functools.partial(mod.apply, temporal_shapes=shapes))(
        params, q, ref, src, input_padding_mask=pad)
    port = deform_attn.MSDeformAttn1D(16, 3, 4, 2,
                                      generator=torch.Generator())
    port.load_state_dict({
        f"{k}.{'weight' if n == 'kernel' else n}":
            _t(np.asarray(v[n]).T if n == "kernel" else v[n])
        for k, v in params["params"].items() for n in v}, strict=True)
    _close(port(_t(q), _t(ref), _t(src), shapes, _t(pad)), want)

    loc = rng.uniform(-0.1, 1.1, (2, 5, 4, 3, 2)).astype(np.float32)
    w = rng.uniform(0, 1, (2, 5, 4, 3, 2)).astype(np.float32)
    value = rng.standard_normal((2, sum(shapes), 4, 4)).astype(np.float32)
    _close(deform_attn.ms_deform_attn_core(_t(value), shapes, _t(loc),
                                           _t(w)),
           jax_deform.ms_deform_attn_core(value, shapes, loc, w))


def test_offset_bias_matches_the_jax_init():
    """The directional sampling-offset bias of the JAX init."""
    mod = jax_deform.MSDeformAttn1D(d_model=16, n_levels=3, n_heads=4,
                                    n_points=2)
    params = jax.jit(functools.partial(mod.init, temporal_shapes=[5, 3, 1]))(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 16)),
        jnp.full((1, 2, 3, 1), 0.5), jnp.zeros((1, 9, 16)))
    want = params["params"]["sampling_offsets"]["bias"]
    _close(deform_attn.directional_offset_bias(4, 3, 2), want)
    port = deform_attn.MSDeformAttn1D(16, 3, 4, 2,
                                      generator=torch.Generator())
    _close(port.sampling_offsets.bias, want)
    assert not port.sampling_offsets.weight.any()
    assert not port.attention_weights.weight.any()
    assert not port.attention_weights.bias.any()


# --------------------------------------------------------------------------
# the model, the step and predict on the two fixtures


@pytest.mark.parametrize("fx", ["dsa", "light"])
def test_pdvc_forward_matches_jax(fx, request):
    """The eval forward: every layer's logits, boxes and counts, the last
    layer's query features and the encoder's memory."""
    fx = request.getfixturevalue(fx)
    feats, mask = fx["batch"][:2]
    with torch.no_grad():
        got = _port(fx)(_t(feats), _t(mask))
    want = fx["aux"]["out"]
    layers = list(zip(got["aux_outputs"] + [got],
                      want["aux_outputs"] + [want]))
    assert len(layers) == 2
    for i, (g, w) in enumerate(layers):
        for k in ("pred_logits", "pred_boxes", "pred_count"):
            _close(g[k], w[k], msg=f"layer {i} {k}")
    _close(got["query_feats"], want["query_feats"])
    _close(got["memory"], want["memory"])


@pytest.mark.parametrize("fx", ["dsa", "light"])
def test_matching_and_caption_logits_match_jax(fx, request):
    """The matching cost of the forward's outputs, the assignment (the
    second video's invalid event unmatched) and the matched queries'
    teacher-forced caption logits."""
    fx = request.getfixturevalue(fx)
    feats, mask, boxes, labels, valid, captions = fx["batch"]
    aux = fx["aux"]
    trainer = _trainer(fx)
    with torch.no_grad():
        out = trainer.model(_t(feats), _t(mask))
        cost = cap.match_cost(out["pred_logits"], out["pred_boxes"],
                              _t(labels), _t(boxes), _t(valid))
        idx = cap.hungarian_match(cost, valid.sum(1))
        logits = trainer.losses(out, _t(feats), _t(boxes), _t(labels),
                                _t(valid), _t(captions), idx)
    valid_cost = np.broadcast_to(valid[:, None, :], cost.shape)
    _close(cost[_t(valid_cost)], _np(aux["cost"])[valid_cost])
    np.testing.assert_array_equal(idx.numpy(), np.asarray(aux["match_idx"]))
    assert idx[1, 2] == -1
    for k, w in fx["losses"].items():
        assert logits[k].item() == pytest.approx(float(w), rel=LOSS_TOL), k
    with torch.no_grad():
        got = trainer.matched_caption_logits(out, _t(captions), idx,
                                             feats.shape[1])
    _close(got, aux["cap_logits"])


def test_step_gradients_match_jax(dsa):
    """``CaptioningTrainer.train_step(deterministic=True)``: the losses
    before the update and every parameter's gradient against the JAX
    value_and_grad of the trainer's loss."""
    fx = dsa
    trainer = _trainer(fx)
    trainer.optimizer.step = lambda: None            # keep the weights
    losses = trainer.train_step(*fx["batch"], deterministic=True)
    assert set(losses) == set(fx["losses"])
    for k, w in fx["losses"].items():
        assert losses[k] == pytest.approx(float(w), rel=LOSS_TOL), k
    want = pdvc_from_jax(fx["grads"])
    floor = GRAD_FLOOR * max(float(w.abs().max()) for w in want.values())
    for name, p in trainer.model.named_parameters():
        w = _np(want[name])
        np.testing.assert_allclose(
            _np(p.grad), w, rtol=GRAD_TOL,
            atol=GRAD_TOL * np.abs(w).max() + floor, err_msg=name)


def test_adamw_update_matches_optax(dsa):
    """The trainer's optimizer against the JAX trainer's chain (the global
    norm clipped at 0.1, then AdamW at 5e-5 with decay 1e-4 on every
    parameter), fed the fixture's gradients, two updates. The chain acts
    elementwise but for the global norm, so optax runs on all parameters
    as one vector (one small compile)."""
    trainer = _trainer(dsa)
    grads = pdvc_from_jax(dsa["grads"])
    names = [n for n, _ in trainer.model.named_parameters()]
    flat = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    tx = jax_train.CaptioningTrainer(dsa["jm"]).tx

    def vector(tree):
        return jnp.concatenate([jnp.asarray(_np(tree[n])).reshape(-1)
                                for n in names])

    def two_updates(p, g):
        state = tx.init(p)
        for _ in range(2):
            updates, state = tx.update(g, state, p)
            p = optax.apply_updates(p, updates)
        return p

    want = np.asarray(jax.jit(two_updates)(vector(flat), vector(grads)))
    for _ in range(2):
        trainer.optimizer.zero_grad()
        for name, p in trainer.model.named_parameters():
            p.grad = grads[name].clone()
        trainer.optimizer.step()
    start = 0
    for name, p in trainer.model.named_parameters():
        w = want[start:start + p.numel()].reshape(p.shape)
        start += p.numel()
        np.testing.assert_allclose(_np(p), w, atol=ADAM_ATOL,
                                   rtol=ADAM_RTOL, err_msg=name)


@pytest.mark.parametrize("fx", ["dsa", "light"])
def test_greedy_captions_match_jax(fx, request):
    """``caption_greedy`` of every query: the same tokens and their
    log-probabilities; the first token is the argmax after token 0 (the
    JAX decode's start, not the loader's BOS 1)."""
    fx = request.getfixturevalue(fx)
    trainer = _trainer(fx)
    out, caps, lps = trainer.forward_captions(*fx["batch"][:2])
    np.testing.assert_array_equal(caps.numpy(), np.asarray(fx["caps"]))
    _close(lps, fx["lps"])
    with torch.no_grad():
        qf = out["query_feats"].reshape(B * Q, D)
        idx = torch.arange(Q).expand(B, Q)
        first = trainer.model.caption_logits(
            qf, torch.zeros(B * Q, 1, dtype=torch.long),
            **trainer._caption_kwargs(out, idx, fx["batch"][0].shape[1]))
    np.testing.assert_array_equal(first.argmax(-1).reshape(B, Q).numpy(),
                                  caps[..., 0].numpy())


def _jax_trainer(fx):
    """The JAX trainer on the fixture's weights, its eval forward the
    fixture's (the same batch)."""
    jtr = jax_train.CaptioningTrainer(fx["jm"])
    jtr.params = fx["params"]
    jtr._fwd = lambda p, f, m: (fx["aux"]["out"], fx["caps"], fx["lps"])
    return jtr


def _same_events(got, want):
    assert len(got) == len(want)
    for g_video, w_video in zip(got, want):
        assert [e["sentence"] for e in g_video] == \
            [e["sentence"] for e in w_video]
        for g, w in zip(g_video, w_video):
            assert g["pred_event_count"] == w["pred_event_count"]
            for k in ("score", "proposal_score", "sentence_score"):
                assert g[k] == pytest.approx(w[k], rel=1e-4, abs=1e-5), k
            np.testing.assert_allclose(g["timestamp"], w["timestamp"],
                                       rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("fx", ["dsa", "light"])
def test_predict_matches_jax(fx, request):
    """``predict`` against the JAX trainer's on the same weights: the same
    events in the same order, sentences word for word (numbers, then a
    vocabulary), scores and times."""
    fx = request.getfixturevalue(fx)
    feats, mask = fx["batch"][:2]
    vocab = [f"w{i}" for i in range(VOCAB)]
    for kw in (dict(topk=4), dict(topk=Q, vocab=vocab)):
        got = _trainer(fx).predict(feats, mask, 90.0, **kw)
        _same_events(got, _jax_trainer(fx).predict(feats, mask, 90.0, **kw))


@pytest.mark.parametrize("favoured", [0, 2])
def test_predict_cuts_at_token_0_only(light, favoured):
    """A caption head that always emits ``favoured``: decoding starts at 0
    and a sentence ends at the first 0 only, so token 0 gives empty
    sentences and the loader's EOS 2 runs to the full length, as in the
    JAX ``predict``."""
    params = jax.tree_util.tree_map(np.array, light["params"])
    head = params["params"]["caption_head"]["logit"]
    head["kernel"][:] = 0.0
    head["bias"][:] = 0.0
    head["bias"][favoured] = 5.0
    fx = dict(light, params=params)
    fx.update(zip(("caps", "lps"), jax.jit(
        lambda p, f: fx["jm"].apply(p, f, method="caption_greedy"))(
            params, jnp.asarray(_np(light["aux"]["out"]["query_feats"])
                                .reshape(B * Q, D)))))
    fx["caps"] = fx["caps"].reshape(B, Q, -1)
    fx["lps"] = fx["lps"].reshape(B, Q, -1)
    feats, mask = light["batch"][:2]
    got = _trainer(fx).predict(feats, mask, 90.0)
    want = _jax_trainer(fx).predict(feats, mask, 90.0)
    _same_events(got, want)
    sentence = "" if favoured == 0 else " ".join(["2"] * CAP_LEN)
    assert all(e["sentence"] == sentence for v in got for e in v)


# --------------------------------------------------------------------------
# modules, matcher and criterion alone


def _dense_sd(tree, prefix):
    out = {prefix + "weight": _t(np.asarray(tree["kernel"]).T)}
    if "bias" in tree:
        out[prefix + "bias"] = _t(tree["bias"])
    return out


def _norm_sd(tree, prefix):
    return {prefix + "weight": _t(tree["scale"]), prefix + "bias":
            _t(tree["bias"])}


@pytest.mark.parametrize("mixer,T", [("vim", 40), ("dbm", 40), ("dbm", 80)])
def test_encoder_layer_matches_jax(mixer, T):
    """``MambaEncoderLayer`` with the ViM or the DBM (expand 1) mixer on
    both scan routes (40 steps: the fused scan; 80: one chunked scan per
    direction), a ragged mask."""
    rng = np.random.default_rng(T)
    src = rng.standard_normal((2, T, D)).astype(np.float32)
    pos = rng.standard_normal((2, T, D)).astype(np.float32)
    mask = np.ones((2, T), np.float32)
    mask[1, T - 9:] = 0.0
    mod = jax_model.MambaEncoderLayer(D, mixer=mixer, impl="assoc")
    params = _init(mod, T, src, pos, mask)
    want = jax.jit(mod.apply)(params, src, pos, mask)
    p = params["params"]
    convert = vim_mixer_from_jax if mixer == "vim" else dbm_mixer_from_jax
    sd = dict(convert(p["mamba"], "mamba."), **_norm_sd(p["norm1"], "norm1."),
              **_dense_sd(p["ffn"]["linear1"], "ffn.linear1."),
              **_dense_sd(p["ffn"]["linear2"], "ffn.linear2."),
              **_norm_sd(p["ffn"]["norm"], "ffn.norm."))
    port = port_model.MambaEncoderLayer(D, mixer=mixer,
                                        generator=torch.Generator())
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        _close(port.eval()(_t(src), _t(pos), _t(mask)), want)


def _outputs(seed, n_count=11):
    """Random PDVC outputs: logits (B, Q, 2), boxes, counts."""
    rng = np.random.default_rng(seed)
    boxes = np.stack([rng.uniform(0.1, 0.9, (B, Q)),
                      rng.uniform(0.05, 0.5, (B, Q))], -1)
    return dict(pred_logits=rng.standard_normal((B, Q, 2)) * 2,
                pred_boxes=boxes,
                pred_count=rng.standard_normal((B, n_count)))


def _targets(seed):
    rng = np.random.default_rng(seed)
    boxes = np.stack([rng.uniform(0.2, 0.8, (B, G)),
                      rng.uniform(0.1, 0.4, (B, G))], -1).astype(np.float32)
    labels = rng.integers(0, 2, (B, G)).astype(np.int32)
    valid = np.array([[True, True, False], [False, False, False]])
    return boxes, labels, valid


def test_match_cost_and_hungarian_match_jax():
    """The cost against ``vmap(match_cost)`` (1e6 at invalid events) and
    the assignment against ``hungarian_match``: −1 past each video's
    valid events, none for a video without any."""
    out = {k: v.astype(np.float32) for k, v in _outputs(5).items()}
    boxes, labels, valid = _targets(5)
    want = jax.jit(jax.vmap(jax_matcher.match_cost))(
        out["pred_logits"], out["pred_boxes"], labels, boxes, valid)
    got = cap.match_cost(_t(out["pred_logits"]), _t(out["pred_boxes"]),
                         _t(labels), _t(boxes), _t(valid))
    _close(got, want)
    assert (got[:, :, ~valid[0]][0] == 1e6).all()
    idx = cap.hungarian_match(got, valid.sum(1))
    want_idx = jax_matcher.hungarian_match(want, jnp.sum(valid, 1))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    assert (idx[1] == -1).all() and (idx[0, 2] == -1)


@pytest.mark.parametrize("captions", [True, False])
def test_pdvc_losses_match_jax(captions):
    """``pdvc_losses`` under a match with an unmatched valid event, an
    invalid one and a video without events, with caption logits and
    without (the "none" head: no loss_caption)."""
    rng = np.random.default_rng(6)
    out = {k: v.astype(np.float32) for k, v in _outputs(6).items()}
    boxes, labels, valid = _targets(6)
    valid[1, :2] = True
    match = np.array([[4, -1, -1], [0, 2, -1]], np.int32)
    kw = {}
    if captions:
        targets = rng.integers(0, VOCAB, (B, G, 3))
        targets[0, 0, 2] = -100
        kw = dict(caption_logits=rng.standard_normal(
            (B, G, 3, VOCAB)).astype(np.float32), caption_targets=targets)
    want = jax.jit(jax_criterion.pdvc_losses)(out, boxes, labels, valid,
                                              match, **kw)
    got = cap.pdvc_losses({k: _t(v) for k, v in out.items()}, _t(boxes),
                          _t(labels), _t(valid), _t(match).long(),
                          **{k: _t(v) for k, v in kw.items()})
    assert set(got) == set(want)
    assert ("loss_caption" in got) == captions
    for k, w in want.items():
        assert got[k].item() == pytest.approx(float(w), rel=LOSS_TOL), k


def test_caption_decoder_type_none_trains_without_a_caption_head():
    """A proposals-only ``PDVC`` ("none"): no caption head parameters, a
    step without loss_caption, and ``predict`` with empty sentences."""
    model = cap.PDVC(C, vocab_size=VOCAB, num_queries=Q, d_model=D,
                     n_levels=2, num_encoder_layers=1, num_decoder_layers=1,
                     caption_decoder_type="none", device="cpu")
    assert not any(n.startswith("caption_head")
                   for n, _ in model.named_parameters())
    trainer = cap.CaptioningTrainer(model)
    batch = _batch(32, 7)
    losses = trainer.train_step(*batch)
    assert "loss_caption" not in losses and np.isfinite(
        losses["loss_total"])
    events = trainer.predict(*batch[:2], duration=10.0, topk=2)
    assert [e["sentence"] for e in events[0]] == ["", ""]


# --------------------------------------------------------------------------
# data, tokenizer, presets, converter


def _annotations(tmp_path):
    """An ActivityNet-Captions json of 3 videos (one without a feature
    file, one with more events than slots) and their .npy features (one
    longer than 16 steps)."""
    rng = np.random.default_rng(8)
    db = {
        "v_a": dict(duration=30.0, timestamps=[[0, 10.5], [12, 30]],
                    sentences=["A man  cooks dinner .", "he eats it"]),
        "v_b": dict(duration=12.0,
                    timestamps=[[0, 3], [3, 6], [6, 9], [9, 12]],
                    sentences=["a dog runs", "a cat wakes up and runs "
                               "across the room fast", "A DOG sleeps",
                               "the dog jumps high"]),
        "v_c": dict(duration=5.0, timestamps=[[1, 2]],
                    sentences=["nobody has features"]),
    }
    (tmp_path / "anno.json").write_text(json.dumps(db))
    np.save(tmp_path / "v_a.npy", rng.standard_normal((40, 7)))
    np.save(tmp_path / "v_b.npy", rng.standard_normal((9, 7)))
    return str(tmp_path / "anno.json"), str(tmp_path)


def test_activitynet_loader_and_collate_match_jax(tmp_path):
    """``load_activitynet_captions`` (the corpus vocabulary, 40 steps
    subsampled to 16, 4 events cut to 3, captions cut to 8 tokens, the
    video without features skipped), ``collate_captioning`` and
    ``vocab_list`` against the JAX package's."""
    anno, feats = _annotations(tmp_path)
    kw = dict(max_events=3, max_caption_len=8, max_seq_len=16)
    got, tok = cap.load_activitynet_captions(anno, feats, **kw)
    want, jtok = jax_data.load_activitynet_captions(anno, feats, **kw)
    assert tok.word_to_id == jtok.word_to_id
    assert [it["video_id"] for it in got] == ["v_a", "v_b"]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if isinstance(g[k], np.ndarray):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
                assert g[k].dtype == w[k].dtype, k
            else:
                assert g[k] == w[k], k
    assert got[1]["captions"][1].tolist() == [1] + [
        tok.word_to_id[w] for w in "a cat wakes up and runs".split()] + [2]
    for g, w in zip(cap.collate_captioning(got, 20),
                    jax_data.collate_captioning(want, 20)):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    assert cap.vocab_list(tok) == jax_data.vocab_list(jtok)


def test_word_tokenizer_matches_jax():
    corpus = ["A  man\tcooks", "a man eats", "Dogs run", "a dog"]
    got = WordTokenizer(corpus, context_length=6, max_vocab=7)
    want = jax_tokenizer.WordTokenizer(corpus, context_length=6,
                                       max_vocab=7)
    assert got.word_to_id == want.word_to_id and got.vocab_size == 7
    texts = ["a man runs away fast now", "DOGS   eat"]
    np.testing.assert_array_equal(got(texts), want(texts))
    assert got.encode("unknown man") == want.encode("unknown man")


def test_presets_match_jax_and_read_as_the_cli():
    """The two presets equal the JAX ``PRESETS`` entries (YouCook2's is
    the dict's later entry: 100 queries, 20 events, the light head), and
    ``captioning_trainer_kwargs`` reads them dataset first, then model,
    then the JAX CLI's defaults."""
    assert configs.DVC_ANET_C3D == PRESETS["dvc_anet_c3d"]
    assert configs.DVC_YC2_TSN == PRESETS["dvc_yc2_tsn"]
    anet = cap.captioning_trainer_kwargs(configs.DVC_ANET_C3D)
    assert anet == dict(
        input_dim=500, num_classes=1, num_queries=10, d_model=512,
        n_levels=4, num_encoder_layers=2, num_decoder_layers=2,
        max_eseq_length=10, max_caption_len=30, mixer="vim",
        caption_decoder_type="standard", max_seq_len=256, max_events=10,
        lr=5e-5)
    assert sum(cap.pdvc_level_shapes(anet["max_seq_len"], 4)) == 480
    yc2 = cap.captioning_trainer_kwargs(configs.DVC_YC2_TSN)
    assert (yc2["input_dim"], yc2["num_queries"], yc2["max_eseq_length"],
            yc2["caption_decoder_type"]) == (3072, 100, 20, "light")
    cfg = dict(configs.DVC_YC2_TSN, dataset=dict(max_caption_len=12))
    assert cap.captioning_trainer_kwargs(cfg)["max_caption_len"] == 12
    assert cap.captioning_trainer_kwargs(dict(
        model=dict(input_dim=4), opt=dict(learning_rate=1.0)))[
            "num_decoder_layers"] == 6


def test_pdvc_from_jax_carries_every_value(dsa):
    """The converted tree loads with ``strict=True`` (the fixtures), and a
    leaf the port has no place for is refused."""
    params = jax.tree_util.tree_map(np.asarray, dsa["params"])
    params["params"]["transformer"]["stray"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="carried over"):
        pdvc_from_jax(params)
