"""The port's ViViM and recognition serving against the JAX package's, on
the CPU, from the same numpy inputs and weights.

A small ViViM (48² images, patch 8, 2 frames: 2 x 37 = 74 tokens, so every
mixer takes the long route of one chunked scan per direction; width 32,
depth 2, 5 classes) is built in JAX, its weights are carried over by
``vivim_from_jax``, and the two forwards must agree within 1e-5 of the
output scale (fp32). Their gradients (``vim`` and ``scan_norm`` mixers,
training mode with drop-path at 0) are held against ``jax.grad`` the same
way, within GRAD_REL_TOL of each parameter's gradient scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from video_mamba_suite_tpu.models.vivim import ViViM as JaxViViM
from video_mamba_suite_tpu.tasks.recognition import engine as jax_engine
from video_mamba_suite_torch.models import ViViM, vivim_from_jax
from video_mamba_suite_torch.models.common import drop_path
from video_mamba_suite_torch.ops import LAUNCHES
from video_mamba_suite_torch.tasks.recognition import (
    evaluate,
    merge_multi_view,
    predict,
    topk_accuracy,
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


SMALL = dict(img_size=48, patch_size=8, num_frames=2, depth=2, embed_dim=32,
             num_classes=5)
REL_TOL = 1e-5      # of the output scale, fp32
# of each parameter's largest gradient, fp32: the adjoint of a 74-step
# scan summed in other orders by the two frameworks (read: 1.4e-6 vim,
# 1.7e-6 scan_norm, both at a dt_proj)
GRAD_REL_TOL = 2e-5


def _videos(seed, n=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 2, 48, 48, 3)).astype(np.float32)


def _jax_params(model, x, seed):
    params = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                 jnp.asarray(x[:1]))
    return jax.tree_util.tree_map(np.asarray, params)


def _port(params, **kw):
    model = ViViM(**kw, device="cpu")
    model.load_state_dict(vivim_from_jax(params, kw["depth"]), strict=True)
    return model.eval()


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= REL_TOL, err


# the first case carries the stacked tree of scan_blocks=True models
# (blocks/{norm_w, norm_b, mixer}, a leading depth axis), the others the
# per-layer tree (norm{i}_w, norm{i}_b, mixer{i})
@pytest.mark.parametrize("mixer,bidir,extra,stacked", [
    ("vim", False, {}, True),
    ("vim", True, {"output_dim": 24}, False),
    ("scan_norm", False, {"rms_norm": True}, False),
    ("scan_norm", True, {}, False),
])
def test_vivim_matches_jax(mixer, bidir, extra, stacked):
    kw = dict(SMALL, mixer=mixer, if_bidirectional=bidir, **extra)
    x = _videos(1)
    jm = JaxViViM(**kw, scan_blocks=stacked)
    params = _jax_params(jm, x, 0)
    assert ("blocks" in params["params"]) == stacked
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    model = _port(params, **kw)
    before = dict(LAUNCHES)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert dict(LAUNCHES) == before           # the plain versions on CPU
    _close(got.numpy(), want)


@pytest.mark.parametrize("mixer", ["vim", "scan_norm"])
def test_vivim_gradients_match_jax(mixer):
    """The gradient of sum(logits · w) at every parameter against
    ``jax.grad`` of the same loss, carried to the port's names by
    ``vivim_from_jax`` (transposes and reshapes are linear)."""
    kw = dict(SMALL, mixer=mixer, drop_path_rate=0.0)
    x = _videos(2)
    w = np.random.default_rng(3).standard_normal((2, 5)).astype(np.float32)
    jm = JaxViViM(**kw)
    params = _jax_params(jm, x, 1)

    def loss(p):
        return jnp.sum(jm.apply(p, jnp.asarray(x), deterministic=False) * w)

    want = vivim_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(loss))(params)), kw["depth"])
    model = _port(params, **kw).train()
    (model(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    names = {n for n, _ in model.named_parameters()}
    assert names == set(want)
    for name, p in model.named_parameters():
        g, ref = p.grad.numpy(), want[name].numpy()
        assert g.shape == ref.shape, name
        err = np.abs(g - ref).max() / max(np.abs(ref).max(), 1e-30)
        assert err <= GRAD_REL_TOL, (name, err)


def test_predict_and_evaluate_match_jax():
    """``predict`` is the JAX trainer's ``_predict`` (softmax of the eval
    logits), and ``evaluate`` its multi-view ``evaluate``
    (``merge_multi_view`` then ``topk_accuracy``): 3 videos x 2 views, in
    batches of 3."""
    videos = _videos(4, n=6)
    labels = np.array([3, 3, 0, 0, 4, 4])
    video_ids = np.array([7, 7, 2, 2, 9, 9])
    jm = JaxViViM(**SMALL)
    params = _jax_params(jm, videos, 5)

    @jax.jit
    def jax_predict(v):             # RecognitionTrainer's _predict
        return jax.nn.softmax(jm.apply(params, v, deterministic=True),
                              axis=-1)

    want = np.concatenate([np.asarray(jax_predict(jnp.asarray(v)))
                           for v in (videos[:3], videos[3:])])
    model = _port(params, **SMALL)
    model.train()
    got = predict(model, videos, batch_size=3)
    assert model.training                      # the flag is restored
    _close(got.numpy(), want)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-6)
    uniq, merged = jax_engine.merge_multi_view(want, video_ids)
    lab = np.array([labels[video_ids == u][0] for u in uniq])
    assert evaluate(model, videos, labels, video_ids, batch_size=3) == \
        jax_engine.topk_accuracy(merged, lab)
    assert evaluate(model, videos, labels, batch_size=3) == \
        jax_engine.topk_accuracy(want, labels)


def test_merge_and_topk_match_jax():
    rng = np.random.default_rng(5)
    scores = rng.random((12, 7)).astype(np.float32)
    video_ids = rng.integers(0, 4, 12)
    labels = rng.integers(0, 7, 12)
    for got, want in zip(merge_multi_view(scores, video_ids),
                         jax_engine.merge_multi_view(scores, video_ids)):
        np.testing.assert_array_equal(got, want)
    for ks in ((1, 5), (1, 2, 3)):
        assert topk_accuracy(scores, labels, ks) == \
            jax_engine.topk_accuracy(scores, labels, ks)


def test_drop_path_keeps_or_drops_whole_samples():
    x = torch.randn(64, 5, 3) + 3.0
    g = torch.Generator().manual_seed(0)
    y = drop_path(x, 0.25, True, g)
    kept = (y != 0).flatten(1).all(1)
    dropped = (y == 0).flatten(1).all(1)
    assert bool((kept | dropped).all()) and 0 < int(dropped.sum()) < 64
    torch.testing.assert_close(y[kept], x[kept] / 0.75)
    assert drop_path(x, 0.25, False, g) is x
    with pytest.raises(ValueError, match="Generator"):
        drop_path(x, 0.25, True, None)


def test_flops_per_clip_counts_every_matmul():
    """flops_per_clip less its scan term is what torch's FLOP counter sees
    in one clip's forward, once the plain scan's per-step C contraction
    (2 per state update and direction, a bmm there) is added back."""
    model = ViViM(**SMALL, output_dim=24, device="cpu").eval()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(torch.from_numpy(_videos(6, n=1)))
    L = 2 * 37
    d_inner, d_state = 64, 16
    scan = 2 * L * d_inner * d_state * len(model.layers)     # per direction
    assert counter.get_total_flops() == \
        model.flops_per_clip() - 6 * scan + 2 * scan
