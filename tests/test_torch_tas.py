"""The port's temporal action segmentation slice against the JAX package's,
on the CPU: ``instance_norm_1d``, ``sliding_window_attention``, each
ASFormer-Mamba module, ``MaTransformer``'s eval forward on both scan
routes, ``tas_loss`` and its gradients, one Adam-with-L2 update (before and
after the plateau halves the rate), the metrics, the data pipeline, the
converter and the presets.

JAX runs its modules with ``impl="ref"``; the port runs its plain versions
on the CPU: at 40 steps each ViM mixer takes the fused bidirectional
route, at 80 one scan per direction. Dropout cannot be matched across the
two frameworks' generators, so the forward, the loss's gradients and the
update are held in eval mode (the JAX ``deterministic=True``). Weights and
inputs are drawn by numpy from a seed; they fill the JAX tree and reach
the port through ``tas_from_jax``. Small widths keep the file quick.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from video_mamba_suite_tpu.configs.presets import PRESETS
from video_mamba_suite_tpu.models import common as jax_common
from video_mamba_suite_tpu.tasks.tas import data as jax_data
from video_mamba_suite_tpu.tasks.tas import metrics as jax_metrics
from video_mamba_suite_tpu.tasks.tas import model as jax_model
from video_mamba_suite_tpu.tasks.tas import train as jax_train
from video_mamba_suite_tpu.utils.schedules import (
    ReduceLROnPlateau as JaxPlateau,
)
from video_mamba_suite_torch import configs
from video_mamba_suite_torch.models import (
    instance_norm_1d,
    sliding_window_attention,
    tas_from_jax,
)
from video_mamba_suite_torch.models import mamba as port_mamba
from video_mamba_suite_torch.tasks import tas

# fp32: each output within 2e-5 of its largest magnitude (and 2e-5
# relative); the two frameworks sum in other orders
REL_TOL = 2e-5
# gradients through 2 + 2 × 2 layers and the loss: within 5e-5 of each
# parameter's largest gradient (sums over 80 frames in another order), and
# 1e-7 of the model's largest: a key conv's bias adds one score to all of
# a query's keys, which the softmax ignores, so its gradient is rounding
# noise (about 1e-8 here) on both sides
GRAD_TOL = 5e-5
GRAD_FLOOR = 1e-7
# Adam fed the same gradients: each parameter within two fp32 ulps of its
# value (an update can round it to the next float), and 5e-8 absolute (a
# tenth of a thousandth of the rate): optax computes the bias correction
# 1 - b2^t in fp32, where it loses about 3e-5 of its value at the second
# step, torch in float64; the first step's correction cancels in both
ADAM_RTOL = 2.5e-7
ADAM_ATOL = 5e-8
# the padded row against a run with other padded features: within 1e-5 of
# the logits' scale (the JAX package's own padding test, tests/test_tas.py,
# allows 1e-4)
PAD_TOL = 1e-5
MODEL = dict(num_decoders=2, num_layers=2, num_f_maps=16, input_dim=12,
             num_classes=5)


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
    ranges the inits give (A_log = log of 1..16, small dt, norms near 1,
    a drop-path scale of order 1 so the mixers count)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "A_log":
            x = np.log(rng.uniform(1.0, 16.0, shape))
        elif name == "dt_bias":
            x = np.log(np.expm1(rng.uniform(0.01, 0.1, shape)))
        elif name in ("norm_w", "scale"):
            x = rng.uniform(0.5, 1.5, shape)
        elif len(shape) <= 1:
            x = 0.5 * rng.standard_normal(shape)
        elif len(shape) == 3:              # conv kernels (k, in, out)
            x = rng.standard_normal(shape) / np.sqrt(shape[0] * shape[1])
        else:                              # (in, out) and scan projections
            x = rng.standard_normal(shape) / np.sqrt(shape[0])
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _init(module, seed, *args, **kwargs):
    """A parameter tree for ``module`` from ``jax.eval_shape``, drawn by
    ``_draw``."""
    shapes = jax.eval_shape(
        functools.partial(module.init, **kwargs),
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        *args)
    return _draw(shapes, seed)


def _mask(batch, length, valid):
    m = np.zeros((batch, length), np.float32)
    for i, v in enumerate(valid):
        m[i, :v] = 1.0
    return m


def _port_model(params, **kw):
    model = tas.MaTransformer(**dict(MODEL, **kw), device="cpu")
    model.load_state_dict(tas_from_jax(params))
    return model.eval()


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_instance_norm_1d_matches_jax(masked):
    rng = np.random.default_rng(1)
    x = (3.0 + 2.0 * rng.standard_normal((2, 23, 6))).astype(np.float32)
    mask = _mask(2, 23, (23, 9)) if masked else None
    want = jax_common.instance_norm_1d(
        jnp.asarray(x), None if mask is None else jnp.asarray(mask))
    got = instance_norm_1d(_t(x), None if mask is None else _t(mask))
    _close(got, want)
    if masked:                 # the padding does not reach the statistics
        short = instance_norm_1d(_t(x[1:, :9]))
        _close(got[1:, :9], short)


@pytest.mark.parametrize("bl", [1, 2, 4, 8])
def test_sliding_window_attention_matches_jax(bl):
    """A ragged length (37, no multiple of any window) and a row padded
    after 20 steps, whose last windows hold no valid key (at bl 8 the
    queries 32-39 see keys 28-43): finite, and zero on the padding."""
    rng = np.random.default_rng(bl)
    q, k = (rng.standard_normal((2, 37, 6)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((2, 37, 5)).astype(np.float32)
    mask = _mask(2, 37, (37, 20))
    want = jax.jit(jax_common.sliding_window_attention,
                   static_argnames="bl")(*map(jnp.asarray, (q, k, v, mask)),
                                         bl=bl)
    got = sliding_window_attention(*map(_t, (q, k, v, mask)), bl)
    assert got.shape == (2, 37, 5) and torch.isfinite(got).all()
    _close(got, want)
    assert not got[1, 20:].any()


def _module_case(name, rng):
    """(JAX module, its call arguments, the port module built from the
    drawn tree, the port's call arguments) for one TAS module."""
    L, dim = 45, 16
    x = rng.standard_normal((2, L, dim)).astype(np.float32)
    enc = rng.standard_normal((2, L, dim)).astype(np.float32)
    mask = _mask(2, L, (L, 30))
    g = torch.Generator().manual_seed(0)
    if name == "feed_forward":
        jm = jax_model.ConvFeedForward(dim, dilation=4)
        args = (x,)
        port = tas.ConvFeedForward(dim, 4, generator=g)
    elif name == "mamba_att":
        jm = jax_model.MambaAttModule(dim, dilation=2, impl="ref")
        args = (x, mask)
        port = tas.MambaAttModule(dim, 2, generator=g)
    elif name in ("attn_att", "attn_att_self"):
        jm = jax_model.AttnAttModule(dim, dilation=8, alpha=0.3)
        args = (x, None if name == "attn_att_self" else enc, mask)
        port = tas.AttnAttModule(dim, 8, 0.3, generator=g)
    elif name == "encoder":
        jm = jax_model.TasEncoder(2, dim, 5, impl="ref")
        args = (rng.standard_normal((2, L, 12)).astype(np.float32), mask)
        port = tas.TasEncoder(2, dim, 12, 5, generator=g)
    else:
        jm = jax_model.TasDecoder(3, dim, 5, alpha=0.05)
        args = (rng.standard_normal((2, L, 5)).astype(np.float32), enc,
                mask)
        port = tas.TasDecoder(3, dim, 5, 0.05, generator=g)
    return jm, args, port


def _module_sd(name, tree):
    """A module's JAX tree through ``tas_from_jax`` (which takes whole
    models) to the port module's state_dict."""
    tree = tree["params"]
    if name == "encoder":
        return {k[len("encoder."):]: v for k, v in
                tas_from_jax({"encoder": tree}).items()}
    if name == "decoder":
        return {k[len("decoders.0."):]: v for k, v in tas_from_jax(
            {"encoder": {}, "decoder0": tree}).items()}
    wrapped = {"encoder": {"layer0": tree}} if name != "feed_forward" else \
        {"encoder": {"layer0": {"ConvFeedForward_0": tree}}}
    sd = tas_from_jax(wrapped)
    prefix = "encoder.layers.0."
    if name == "feed_forward":
        prefix += "feed_forward."
    return {k[len(prefix):]: v for k, v in sd.items()}


@pytest.mark.parametrize("name", ["feed_forward", "mamba_att", "attn_att",
                                  "attn_att_self", "encoder", "decoder"])
def test_tas_module_matches_jax(name):
    """Each module's eval forward with a ragged mask: the dilated
    feed-forward, the encoder layer (MaskMambaBlock at 45 steps: the fused
    route), the decoder layer with encoder values and without, and the
    encoder and a decoder of their layers."""
    rng = np.random.default_rng(len(name))
    jm, args, port = _module_case(name, rng)
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    tree = _init(jm, 5, *jargs)
    want = jax.jit(jm.apply)(tree, *jargs)
    port.load_state_dict(_module_sd(name, tree))
    with torch.no_grad():
        got = port.eval()(*[None if a is None else _t(a) for a in args])
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        _close(g, w)


@pytest.fixture(scope="module")
def jax_forward():
    """A JAX ``MaTransformer`` of ``MODEL``'s widths, its drawn tree, its
    eval forward at 40 and 80 steps (the second row padded), and at 80 the
    ``tas_loss`` of it and its gradients, computed once."""
    jm = jax_model.MaTransformer(**MODEL, impl="ref")
    rng = np.random.default_rng(7)
    cases = {}
    for L in (40, 80):
        x = rng.standard_normal((2, L, 12)).astype(np.float32)
        mask = _mask(2, L, (L, L - 13))
        targets = rng.integers(0, 5, (2, L))
        targets[mask == 0] = jax_data.IGNORE_INDEX
        cases[L] = (x, targets, mask)
    x40 = jnp.asarray(cases[40][0])
    params = _init(jm, 11, x40, jnp.asarray(cases[40][2]), deterministic=True)

    def loss(p, x, t, m):
        logits = jm.apply(p, x, m, deterministic=True)
        return jax_train.tas_loss(logits, t, m), logits

    x, t, m = cases[40]
    out = {40: dict(inputs=cases[40], logits=jax.jit(jm.apply)(
        params, jnp.asarray(x), jnp.asarray(m)))}
    x, t, m = cases[80]
    (value, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(m))
    out[80] = dict(inputs=cases[80], loss=float(value), logits=logits,
                   grads=grads)
    return jm, params, out


@pytest.mark.parametrize("L", [40, 80], ids=["fused-l40", "chunked-l80"])
def test_ma_transformer_eval_matches_jax(jax_forward, monkeypatch, L):
    """Every stage's logits, the mixers on the fused route at 40 steps and
    one scan per direction at 80; then the padding: the padded row's valid
    steps do not change when its padded features do, and its padded steps
    are zero. (They are not those of an unpadded run: the 1x1 convs' bias
    reaches the padded steps that the dilated convs read, as in the JAX
    model.)"""
    _, params, out = jax_forward
    x, _, mask = out[L]["inputs"]
    fused = []
    inner = port_mamba.mamba_inner_bidir
    monkeypatch.setattr(port_mamba, "mamba_inner_bidir",
                        lambda *a, **k: fused.append(1) or inner(*a, **k))
    model = _port_model(params)
    with torch.no_grad():
        got = model(_t(x), _t(mask))
        assert got.shape == (3, 2, L, 5)
        _close(got, out[L]["logits"])
        assert bool(fused) == (L <= 64)
        n = int(mask[1].sum())
        noisy = x.copy()
        noisy[1, n:] = 99.0
        changed = model(_t(noisy), _t(mask))
    _close(got[:, 1, :n], changed[:, 1, :n], rel=PAD_TOL)
    assert not got[:, 1, n:].any()


def test_tas_loss_and_gradients_match_jax(jax_forward):
    """``tas_loss`` of the deterministic forward at 80 steps with a padded
    row and its gradient at every parameter, through a port trainer's
    ``train_step(deterministic=True)``; then the loss alone on random
    logits, which ignores the padded frames' logits."""
    _, params, out = jax_forward
    x, t, mask = out[80]["inputs"]
    trainer = tas.TasTrainer(**MODEL, device="cpu")
    trainer.model.load_state_dict(tas_from_jax(params))
    trainer.optimizer.step = lambda: None            # keep the weights
    loss = trainer.train_step(x, t, mask, deterministic=True)
    assert loss == pytest.approx(out[80]["loss"], rel=REL_TOL)
    want = tas_from_jax(out[80]["grads"])
    floor = GRAD_FLOOR * max(float(w.abs().max()) for w in want.values())
    for name, p in trainer.model.named_parameters():
        w = _np(want[name])
        np.testing.assert_allclose(
            _np(p.grad), w, rtol=GRAD_TOL,
            atol=GRAD_TOL * np.abs(w).max() + floor, err_msg=name)
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 2, 30, 4)).astype(np.float32) * 3
    targets = rng.integers(0, 4, (2, 30))
    m = _mask(2, 30, (30, 17))
    targets[1, 17:] = jax_data.IGNORE_INDEX
    want = jax_train.tas_loss(*map(jnp.asarray, (logits, targets, m)))
    got = tas.tas_loss(*map(_t, (logits, targets, m)))
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    logits[:, 1, 17:] = 123.0
    assert float(tas.tas_loss(*map(_t, (logits, targets, m)))) == \
        pytest.approx(float(got), rel=1e-6)


def test_adam_update_and_plateau_match_optax(jax_forward):
    """The port trainer's optimizer against the JAX trainer's chain
    (add_decayed_weights(1e-5), then Adam under an injected rate), fed the
    same gradients: one update, then four epochs' losses that do not
    improve, which halve the rate on both sides, and a second update."""
    jm, params, out = jax_forward
    jtr = jax_train.TasTrainer(**MODEL, impl="ref")
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jtr.params, jtr.opt_state = jparams, jtr.tx.init(jparams)
    port = tas.TasTrainer(**MODEL, device="cpu")
    port.model.load_state_dict(tas_from_jax(params))
    grads = out[80]["grads"]
    torch_grads = tas_from_jax(grads)
    losses = [5.0, 5.5, 6.0, 5.2, 5.1]
    update = jax.jit(jtr.tx.update)
    for plateau_loss in (None, losses):
        if plateau_loss:
            scales = []
            for value in plateau_loss:
                scales.append(port.plateau.step(value))
                port.set_lr_scale(scales[-1])
                jtr.set_lr_scale(jtr.plateau.step(value))
            assert scales == [1.0, 1.0, 1.0, 1.0, 0.5]
            assert port.optimizer.param_groups[0]["lr"] == 2.5e-4
            assert float(jtr.opt_state.hyperparams["learning_rate"]) == \
                pytest.approx(2.5e-4)
        updates, jtr.opt_state = update(grads, jtr.opt_state, jtr.params)
        jtr.params = optax.apply_updates(jtr.params, updates)
        port.optimizer.zero_grad()
        for name, p in port.model.named_parameters():
            p.grad = torch_grads[name].clone()
        port.optimizer.step()
        want = tas_from_jax(jax.device_get(jtr.params))
        for name, p in port.model.named_parameters():
            np.testing.assert_allclose(_np(p), _np(want[name]),
                                       atol=ADAM_ATOL, rtol=ADAM_RTOL,
                                       err_msg=name)
    plateau = JaxPlateau(factor=0.5, patience=3)
    assert [plateau.step(v) for v in losses] == scales


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_jax(seed):
    """Segments, edit distance, F1 at each overlap and the aggregate on
    random runs of labels (one video's prediction a copy of its truth),
    with and without a background class."""
    rng = np.random.default_rng(seed)

    def runs(n):
        out = []
        while len(out) < n:
            out += [int(rng.integers(0, 4))] * int(rng.integers(1, 9))
        return out[:n]

    preds = [runs(int(rng.integers(20, 60))) for _ in range(3)]
    gts = [runs(len(p)) for p in preds]
    gts[0] = list(preds[0])
    for p, g in zip(preds, gts):
        for bg in (("background",), (0,)):
            assert tas.get_labels_start_end_time(p, bg) == \
                jax_metrics.get_labels_start_end_time(p, bg)
            assert tas.edit_score(p, g, bg_class=bg) == \
                jax_metrics.edit_score(p, g, bg_class=bg)
            for ov in (0.1, 0.25, 0.5):
                assert tas.f_score(p, g, ov, bg) == \
                    jax_metrics.f_score(p, g, ov, bg)
        assert tas.levenstein(p, g) == jax_metrics.levenstein(p, g)
        assert tas.accuracy(p, g) == jax_metrics.accuracy(p, g)
    assert tas.evaluate_segmentation(preds, gts) == \
        jax_metrics.evaluate_segmentation(preds, gts)


def test_data_matches_jax(tmp_path):
    """``collate`` (with ``pad_to``), ``time_warp`` on the same numpy
    generator, the synthetic videos, and a ``TasBatchGenerator`` over
    files: the shuffled order, every batch with and without warps, and
    the reset."""
    items = tas.make_synthetic_dataset(5, 4, 6, seed=3)
    want_items = jax_data.make_synthetic_dataset(5, 4, 6, seed=3)
    for (f, l), (wf, wl) in zip(items, want_items):
        np.testing.assert_array_equal(f, wf)
        np.testing.assert_array_equal(l, wl)
    for pad_to in (None, 16):
        for a, b in zip(tas.collate(items[:3], pad_to),
                        jax_data.collate(items[:3], pad_to)):
            np.testing.assert_array_equal(a, b)
    got = tas.time_warp(*items[0], np.random.default_rng(4))
    want = jax_data.time_warp(*items[0], np.random.default_rng(4))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    (tmp_path / "feat").mkdir()
    (tmp_path / "gt").mkdir()
    names = ["abcd"[c] for c in range(4)]
    actions = {n: i for i, n in enumerate(names)}
    vids = []
    for i, (f, l) in enumerate(items):
        vid = f"video{i}.txt"
        vids.append(vid)
        np.save(tmp_path / "feat" / f"video{i}.npy", f)
        (tmp_path / "gt" / vid).write_text(
            "\n".join(names[c] for c in l[:len(l) - i]) + "\n")
    (tmp_path / "split.bundle").write_text("\n".join(vids) + "\n")
    gens = [cls(4, actions, str(tmp_path / "gt"), str(tmp_path / "feat"),
                sample_rate=2, pad_to=8, seed=9)
            for cls in (tas.TasBatchGenerator, jax_data.TasBatchGenerator)]
    for gen in gens:
        gen.read_data(str(tmp_path / "split.bundle"))
    assert gens[0].list_of_examples == gens[1].list_of_examples
    for warp in (False, True):
        while gens[1].has_next():
            got, want = (gen.next_batch(2, warp) for gen in gens)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert not gens[0].has_next()
        for gen in gens:
            gen.reset()
        assert gens[0].list_of_examples == gens[1].list_of_examples


def test_tas_from_jax_covers_the_model(jax_forward):
    """Every parameter and buffer of a ``MaTransformer`` comes from the JAX
    tree, and nothing else: a strict load."""
    _, params, _ = jax_forward
    sd = tas_from_jax(params)
    model = tas.MaTransformer(**MODEL, device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    for name, p in model.named_parameters():
        assert p.shape == sd[name].shape, name


@pytest.mark.parametrize("name", ["TAS_GTEA", "TAS_50SALADS",
                                  "TAS_BREAKFAST"])
def test_presets_match_jax(name):
    """The port's TAS configurations are the JAX presets."""
    assert getattr(configs, name) == PRESETS[name.lower()]
