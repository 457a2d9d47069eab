"""The port's video temporal grounding slice against the JAX package's, on
the CPU: ``rope_rotate``, UniVTG-Mamba's modules and its forward, the MR,
HL and QFVS losses, one ``VtgTrainer`` step (gradients and the clipped
AdamW update), ``predict`` / ``evaluate``, the data, metrics, VLP samples
and zero-shot scores, one ``QfvsTrainer`` step and its summary, the
converter and the presets.

JAX runs its models with ``impl="assoc"``; the port runs its plain
versions on the CPU. Two small models are shared by the tests through
module fixtures, each compiled once: the moment-retrieval model (DBM,
RoPE, 6 + 64 steps: one scan per direction, with ragged text and video
masks) and the QFVS model (ViM, 2 + 24 steps: the fused bidirectional
route, with a ragged video mask and class-name tokens). Dropout cannot be
matched across the two frameworks' generators, so the forwards, the
gradients and the QFVS step are held in eval mode (the JAX
``deterministic=True``). Weights are drawn by numpy from a seed into the
JAX tree's shapes (``jax.eval_shape``, no compiled init) and reach the
port through ``vtg_from_jax``.
"""

import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from video_mamba_suite_tpu.configs.presets import PRESETS
from video_mamba_suite_tpu.models import rope as jax_rope
from video_mamba_suite_tpu.tasks.vtg import data as jax_data
from video_mamba_suite_tpu.tasks.vtg import dataset as jax_dataset
from video_mamba_suite_tpu.tasks.vtg import hl as jax_hl
from video_mamba_suite_tpu.tasks.vtg import losses as jax_losses
from video_mamba_suite_tpu.tasks.vtg import metrics as jax_metrics
from video_mamba_suite_tpu.tasks.vtg import model as jax_model
from video_mamba_suite_tpu.tasks.vtg import qfvs as jax_qfvs
from video_mamba_suite_tpu.tasks.vtg import train as jax_train
from video_mamba_suite_tpu.tasks.vtg import vlp as jax_vlp
from video_mamba_suite_torch import configs
from video_mamba_suite_torch.models import rope_rotate, vtg_from_jax
from video_mamba_suite_torch.tasks import vtg

# fp32: each output within 1e-5 of its largest magnitude (and 1e-5
# relative); the two frameworks sum in other orders
REL_TOL = 1e-5
# a loss term within 1e-5 relative
LOSS_TOL = 1e-5
# gradients through 2 layers and the five loss terms: within 1e-4 of each
# parameter's largest gradient
GRAD_TOL = 1e-4
# AdamW fed the same gradients: each parameter within two fp32 ulps of
# its value and 5e-8 absolute (optax's bias correction in fp32, torch's in
# float64; the first step's correction cancels in both)
ADAM_RTOL = 2.5e-7
ADAM_ATOL = 5e-8
TXT_DIM, VID_DIM, EMBED, DEPTH = 6, 10, 32, 2
MAX_Q_L, MAX_V_L = 6, 64           # 70 steps: one scan per direction


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
        elif name == "scale" or (name.endswith("_w") and len(shape) == 1):
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


def _port_model(params, **kw):
    model = vtg.UniVTGMamba(TXT_DIM, VID_DIM, EMBED, DEPTH, **kw,
                            device="cpu")
    model.load_state_dict(vtg_from_jax(params))
    return model.eval()


def _mr_samples(data):
    """4 moment-retrieval samples of ``data``'s ``make_synthetic_vtg`` (64
    clips, 6 query tokens), two cut short: a ragged query and a ragged
    video."""
    samples = data.make_synthetic_vtg(num_samples=4, ctx_l=MAX_V_L,
                                      txt_len=MAX_Q_L, txt_dim=TXT_DIM,
                                      vid_dim=VID_DIM, seed=3)
    samples[1]["txt_feat"] = samples[1]["txt_feat"][:4]
    samples[2]["vid_feat"] = samples[2]["vid_feat"][:50]
    return samples


@pytest.fixture(scope="module")
def mr():
    """The moment-retrieval model (DBM, RoPE) on a batch of 4 at 6 + 64
    steps: its drawn tree, the eval outputs, ``vtg_losses`` of them with
    the gradients, and the JAX trainer's optimizer (clip, AdamW) fed those
    gradients twice, from one compiled JAX function."""
    jm = jax_model.UniVTGMamba(txt_dim=TXT_DIM, vid_dim=VID_DIM,
                               embed_dim=EMBED, depth=DEPTH,
                               mamba_type="dbm", if_rope=True, impl="assoc")
    tx = jax_train.VtgTrainer(TXT_DIM, VID_DIM, embed_dim=EMBED, depth=DEPTH,
                              mamba_type="dbm", impl="assoc").tx
    samples = _mr_samples(jax_data)
    batch = jax_data.collate_vtg(samples, MAX_Q_L, MAX_V_L)
    inputs = [jnp.asarray(batch[k]) for k in
              ("src_txt", "src_txt_mask", "src_vid", "src_vid_mask")]
    params = _init(jm, 11, *inputs, deterministic=True)

    def loss(p, b):
        out = jm.apply(p, b["src_txt"], b["src_txt_mask"], b["src_vid"],
                       b["src_vid_mask"], deterministic=True)
        terms = jax_losses.vtg_losses(
            out, {k: b[k] for k in jax_train.TARGET_KEYS})
        return terms["loss_total"], (terms, out)

    def step(p, b):
        (_, (terms, out)), grads = jax.value_and_grad(loss, has_aux=True)(
            p, b)
        state, updated = tx.init(p), p
        for _ in range(2):
            updates, state = tx.update(grads, state, updated)
            updated = optax.apply_updates(updated, updates)
        return terms, out, grads, updated

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    terms, out, grads, updated = jax.jit(step)(params, jbatch)
    return dict(samples=samples, batch=batch, params=params, out=out,
                terms=terms, grads=grads, updated=updated)


@pytest.fixture(scope="module")
def short():
    """The QFVS model (ViM, no input dropout) on 4 synthetic QFVS items (3
    segments of up to 8 frames: 24 steps plus 1 or 2 query tokens), its
    drawn tree and its eval outputs with 3 class names for each query:
    concept 1, concept 2 and both (the oracle), the three forwards
    compiled as one function (``apply``)."""
    jm = jax_model.UniVTGMamba(txt_dim=TXT_DIM, vid_dim=VID_DIM,
                               embed_dim=EMBED, depth=DEPTH,
                               input_dropout=0.0, impl="assoc")
    items, tags = jax_qfvs.make_synthetic_qfvs(
        num_items=4, n_segments=3, n_frames=8, vid_dim=VID_DIM,
        txt_dim=TXT_DIM, n_concepts=6, seed=5)
    vid, vmask, gt, c1, c2 = jax_qfvs.collate_qfvs(items)
    rng = np.random.default_rng(6)
    cls = rng.standard_normal((3, 4, TXT_DIM)).astype(np.float32)
    cls_mask = np.ones((3, 4), np.float32)
    cls_mask[2, 2:] = 0.0
    oracle = np.concatenate([c1, c2], axis=1)
    ones = functools.partial(np.ones, dtype=np.float32)
    params = _init(jm, 12, jnp.asarray(oracle), jnp.ones((4, 2)),
                   jnp.asarray(vid), jnp.asarray(vmask), deterministic=True)

    def three(p, queries, v, vm, src_cls, src_cls_mask):
        return [jm.apply(p, q, qm, v, vm, src_cls=src_cls,
                         src_cls_mask=src_cls_mask, deterministic=True)
                for q, qm in queries]

    queries = [(c1, ones(c1.shape[:2])), (c2, ones(c2.shape[:2])),
               (oracle, ones(oracle.shape[:2]))]
    compiled = jax.jit(three)
    outs = dict(zip(("c1", "c2", "oracle"), compiled(
        params, queries, vid, vmask, cls, cls_mask)))

    def apply(p, txt, tmask, v, vm, src_cls, src_cls_mask):
        """The compiled forwards at the oracle's shapes, the last one on
        (txt, tmask)."""
        return compiled(p, queries[:2] + [(txt, tmask)], v, vm, src_cls,
                        src_cls_mask)[-1]

    return dict(items=items, tags=tags, collated=(vid, vmask, gt, c1, c2),
                cls=cls, cls_mask=cls_mask, oracle=oracle, apply=apply,
                params=params, outs=outs)


@pytest.mark.parametrize("shape", [(2, 7, 8), (1, 33, 64)])
def test_rope_rotate_matches_jax(shape):
    x = np.random.default_rng(shape[1]).standard_normal(shape).astype(
        np.float32) * 3
    want = jax.jit(jax_rope.rope_rotate)(x)
    _close(rope_rotate(_t(x)), want)


@pytest.mark.parametrize("name", ["linear", "linear-no-ln-no-relu",
                                  "conv_head", "weighted_pool"])
def test_module_matches_jax(name):
    """``LinearLayer`` (eval mode: no dropout) with and without its
    LayerNorm and ReLU, ``ConvHead`` over every step (SAME padding) and
    ``WeightedPool`` with a masked row tail."""
    rng = np.random.default_rng(len(name))
    x = rng.standard_normal((2, 13, 12)).astype(np.float32)
    mask = np.ones((2, 13), np.float32)
    mask[1, 5:] = 0.0
    g = torch.Generator().manual_seed(0)
    if name.startswith("linear"):
        plain = name != "linear"
        jm = jax_model.LinearLayer(9, use_ln=not plain, dropout=0.5,
                                   relu=not plain)
        args = (x,)
        port = vtg.LinearLayer(12, 9, use_ln=not plain, dropout=0.5,
                               relu=not plain, generator=g)
        prefix = "txt_proj.0."
        wrap = {"txt_proj0": None}
    elif name == "conv_head":
        jm = jax_model.ConvHead(16, 5)
        args = (x,)
        port = vtg.ConvHead(12, 16, 5, generator=g)
        prefix = "class_embed."
        wrap = {"class_embed": None}
    else:
        jm = jax_model.WeightedPool(12)
        args = (x, mask)
        port = vtg.WeightedPool(12, generator=g)
        prefix = "weightedpool."
        wrap = {"weightedpool": None}
    jargs = [jnp.asarray(a) for a in args]
    tree = _init(jm, 5, *jargs)
    want = jax.jit(jm.apply)(tree, *jargs)
    # through the whole model's converter, which takes these subtrees
    key = next(iter(wrap))
    full = {"token_type": {"embedding": np.zeros((2, 1))},
            "norm_f_w": np.zeros(1), "norm_f_b": np.zeros(1),
            "class_embed": {}, "span_embed": {},
            "weightedpool": {"weight": np.zeros((1, 1))}}
    full[key] = tree["params"]
    sd = {k[len(prefix):]: v for k, v in vtg_from_jax(full).items()
          if k.startswith(prefix)}
    port.load_state_dict(sd)
    with torch.no_grad():
        got = port.eval()(*[_t(a) for a in args])
    _close(got, want)


def test_univtg_dbm_rope_forward_matches_jax(mr):
    """The DBM model with RoPE at 6 + 64 steps (one scan per direction),
    a ragged query and a ragged video: every output; the saliency on the
    valid clips, and -1e4 + the cosine on the padded ones."""
    model = _port_model(mr["params"], mamba_type="dbm", if_rope=True)
    b = mr["batch"]
    with torch.no_grad():
        got = model(*(_t(b[k]) for k in ("src_txt", "src_txt_mask",
                                          "src_vid", "src_vid_mask")))
    want = mr["out"]
    assert set(got) == set(want)
    for k in ("pred_logits", "pred_spans", "vid_mem_proj", "txt_mem_proj"):
        _close(got[k], want[k], msg=k)
    valid = b["src_vid_mask"] > 0
    assert not valid.all()
    sal, wsal = _np(got["saliency_scores"]), _np(want["saliency_scores"])
    _close(sal[valid], wsal[valid])
    np.testing.assert_allclose(sal[~valid], wsal[~valid], rtol=1e-7)


def test_univtg_vim_cls_forward_matches_jax(short):
    """The ViM model (no RoPE) at 2 + 24 steps (the fused route) with
    class-name tokens, one of them ragged: every output, cls_mem_proj
    included."""
    model = _port_model(short["params"])
    vid, vmask, *_ = short["collated"]
    q = short["oracle"]
    with torch.no_grad():
        got = model(_t(q), torch.ones(q.shape[:2]), _t(vid), _t(vmask),
                    src_cls=_t(short["cls"]),
                    src_cls_mask=_t(short["cls_mask"]))
    want = short["outs"]["oracle"]
    assert set(got) == set(want) and "cls_mem_proj" in got
    valid = vmask > 0
    for k in got:
        if k == "saliency_scores":
            _close(got[k].numpy()[valid], _np(want[k])[valid])
        else:
            _close(got[k], want[k], msg=k)


def _loss_inputs(seed):
    """Random model outputs and the targets of 3 synthetic samples (one
    video shorter than the padding)."""
    rng = np.random.default_rng(seed)
    samples = jax_data.make_synthetic_vtg(num_samples=3, ctx_l=20,
                                          txt_len=4, txt_dim=5, vid_dim=5,
                                          seed=seed)
    samples[2]["vid_feat"] = samples[2]["vid_feat"][:13]
    batch = jax_data.collate_vtg(samples, 4, 20)
    outputs = dict(
        pred_logits=1 / (1 + np.exp(-rng.standard_normal((3, 20, 1)))),
        pred_spans=0.3 * rng.standard_normal((3, 20, 2)),
        vid_mem_proj=rng.standard_normal((3, 20, 7)),
        txt_mem_proj=rng.standard_normal((3, 1, 7)))
    outputs = {k: v.astype(np.float32) for k, v in outputs.items()}
    return outputs, batch


def test_vtg_losses_match_jax(mr):
    """Each term and the total: on random outputs with a padded video, and
    on the moment-retrieval model's outputs (the fixture's JAX terms)."""
    outputs, batch = _loss_inputs(0)
    targets = {k: batch[k] for k in jax_train.TARGET_KEYS}
    want = jax.jit(jax_losses.vtg_losses)(outputs, targets)
    got = vtg.vtg_losses({k: _t(v) for k, v in outputs.items()},
                         {k: _t(v) for k, v in targets.items()})
    assert set(got) == set(want) == {"loss_b", "loss_g", "loss_f",
                                     "loss_s_inter", "loss_s_intra",
                                     "loss_total"}
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=LOSS_TOL)
    b = mr["batch"]
    got = vtg.vtg_losses({k: _t(np.asarray(v)) for k, v in mr["out"].items()},
                         {k: _t(b[k]) for k in jax_train.TARGET_KEYS})
    for k, w in mr["terms"].items():
        assert float(got[k]) == pytest.approx(float(w), rel=LOSS_TOL), k


def test_hl_losses_match_jax():
    """Each term on random outputs of a ``collate_hl`` batch: one full row
    (its median taken) and one padded row (``jnp.median`` of a row with
    NaN is NaN, which becomes 0), with a query and without."""
    rng = np.random.default_rng(4)
    samples = [dict(vid_feat=rng.standard_normal((T, 5)).astype(np.float32),
                    saliency=rng.integers(0, 4, T).astype(np.float32),
                    txt_feat=q)
               for T, q in ((24, rng.standard_normal((3, 6))), (17, None))]
    batch = jax_hl.collate_hl(samples, 24, 6)
    outputs = dict(
        pred_logits=1 / (1 + np.exp(-rng.standard_normal((2, 24, 1)))),
        vid_mem_proj=rng.standard_normal((2, 24, 7)),
        txt_mem_proj=rng.standard_normal((2, 1, 7)))
    outputs = {k: v.astype(np.float32) for k, v in outputs.items()}
    targets = {k: batch[k] for k in vtg.hl.HL_TARGET_KEYS}
    want = jax.jit(jax_hl.hl_losses)(outputs, targets)
    got = vtg.hl_losses({k: _t(v) for k, v in outputs.items()},
                        {k: _t(v) for k, v in targets.items()})
    assert set(got) == set(want)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=LOSS_TOL)


def _mr_trainer(params):
    trainer = vtg.VtgTrainer(TXT_DIM, VID_DIM, embed_dim=EMBED, depth=DEPTH,
                             mamba_type="dbm", max_q_l=MAX_Q_L,
                             max_v_l=MAX_V_L, device="cpu")
    trainer.model.if_rope = True           # the fixture's model
    trainer.model.load_state_dict(vtg_from_jax(params))
    return trainer


def test_vtg_step_gradients_match_jax(mr):
    """``VtgTrainer.train_step(deterministic=True)`` on the fixture's batch:
    the losses before the update and every parameter's gradient against
    the JAX value_and_grad of ``vtg_losses``."""
    trainer = _mr_trainer(mr["params"])
    trainer.optimizer.step = lambda: None            # keep the weights
    losses = trainer.train_step(mr["batch"], deterministic=True)
    for k, w in mr["terms"].items():
        assert losses[k] == pytest.approx(float(w), rel=LOSS_TOL), k
    want = vtg_from_jax(mr["grads"])
    for name, p in trainer.model.named_parameters():
        w = _np(want[name])
        np.testing.assert_allclose(_np(p.grad), w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=name)


def test_vtg_adamw_update_matches_optax(mr):
    """The port trainer's optimizer against the JAX trainer's chain (the
    global-norm clip at 0.1, then AdamW with decay 1e-4 on every
    parameter), fed the fixture's gradients, two updates."""
    trainer = _mr_trainer(mr["params"])
    grads = vtg_from_jax(mr["grads"])
    for _ in range(2):
        trainer.optimizer.zero_grad()
        for name, p in trainer.model.named_parameters():
            p.grad = grads[name].clone()
        trainer.optimizer.step()
    want = vtg_from_jax(jax.device_get(mr["updated"]))
    for name, p in trainer.model.named_parameters():
        np.testing.assert_allclose(_np(p), _np(want[name]), atol=ADAM_ATOL,
                                   rtol=ADAM_RTOL, err_msg=name)


def test_predict_and_evaluate_match_jax(mr):
    """``predict`` and ``evaluate`` of the port trainer against the JAX
    trainer's on the same weights, the JAX forward the fixture's (the same
    batch of 4): the same windows in the same order, the saliency, and
    every metric."""
    jtr = jax_train.VtgTrainer(TXT_DIM, VID_DIM, embed_dim=EMBED,
                               depth=DEPTH, mamba_type="dbm",
                               max_q_l=MAX_Q_L, max_v_l=MAX_V_L,
                               impl="assoc")
    jtr.params = mr["params"]

    def fwd(params, batch):
        for k, v in mr["batch"].items():
            np.testing.assert_array_equal(batch[k], v)
        return mr["out"]

    jtr._fwd = fwd
    samples = mr["samples"]
    trainer = _mr_trainer(mr["params"])
    got, want = trainer.predict(samples), jtr.predict(samples)
    for g, w in zip(got, want):
        assert g["qid"] == w["qid"]
        gw, ww = np.asarray(g["pred_relevant_windows"]), np.asarray(
            w["pred_relevant_windows"])
        np.testing.assert_allclose(gw, ww, rtol=REL_TOL, atol=1e-5)
        _close(g["pred_saliency_scores"], w["pred_saliency_scores"])
    got, want = trainer.evaluate(samples), jtr.evaluate(samples)
    assert set(got) == set(want) == {"mAP_avg", "mIoU@1", "R1@0.5",
                                     "R1@0.7", "HL_hit1", "HL_mAP"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-6), k


@pytest.mark.parametrize("case", ["inside", "outside", "two-windows"])
def test_build_targets_matches_jax(case):
    """Targets of a window inside the video, one past its end (the forced
    positive) and two windows with given saliency, each from the same
    seeded generator."""
    windows = {"inside": [[6.0, 20.0]], "outside": [[90.0, 96.0]],
               "two-windows": [[2.0, 8.0], [30.0, 44.0]]}[case]
    sal = (np.linspace(0, 1, 30).astype(np.float32)
           if case == "two-windows" else None)
    got = vtg.build_targets(30, windows, 2.0, saliency_scores=sal,
                            rng=np.random.default_rng(1))
    want = jax_data.build_targets(30, windows, 2.0, saliency_scores=sal,
                                  rng=np.random.default_rng(1))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype


def _assert_same(got, want):
    assert type(got) is type(want) or isinstance(got, np.ndarray)
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    else:
        assert got == want


def test_synthetic_data_and_collate_vtg_match_jax():
    """``make_synthetic_vtg``, ``make_synthetic_vlp`` and
    ``make_synthetic_qfvs`` from the same seeds, then ``collate_vtg`` of
    the ragged moment-retrieval samples and ``collate_qfvs``: equal
    arrays."""
    _assert_same(_mr_samples(vtg.data), _mr_samples(jax_data))
    _assert_same(vtg.make_synthetic_vlp(seed=2),
                 jax_vlp.make_synthetic_vlp(seed=2))
    got = vtg.make_synthetic_qfvs(seed=3)
    want = jax_qfvs.make_synthetic_qfvs(seed=3)
    _assert_same(got, want)
    _assert_same(vtg.collate_qfvs(got[0]), jax_qfvs.collate_qfvs(want[0]))
    samples = _mr_samples(vtg.data)
    _assert_same(vtg.collate_vtg(samples, 5, 60),
                 jax_data.collate_vtg(samples, 5, 60))


def test_collate_hl_matches_jax():
    rng = np.random.default_rng(8)
    samples = [dict(vid_feat=rng.standard_normal((T, 4)).astype(np.float32),
                    saliency=rng.integers(0, 3, T).astype(np.float32),
                    txt_feat=rng.standard_normal((2, 3)) if T > 10 else None)
               for T in (12, 9, 20)]
    _assert_same(vtg.collate_hl(samples, 16, 3),
                 jax_hl.collate_hl(samples, 16, 3))


def test_tvsum_map_at_k_matches_jax():
    rng = np.random.default_rng(9)
    scores = [rng.standard_normal(T) for T in (30, 25, 41)]
    annos = [rng.integers(1, 6, (T, 20)).astype(np.float32)
             for T in (30, 25, 41)]
    for k in (5, 9):
        assert vtg.tvsum_map_at_k(scores, annos, k) == \
            jax_hl.tvsum_map_at_k(scores, annos, k)


def test_mr_and_hl_metrics_match_jax():
    """mAP, R1 and mIoU of random ranked windows against one or two
    ground-truth windows, and HIT@1 and HL mAP against binary labels of 3
    annotators."""
    rng = np.random.default_rng(10)
    sub, gt, qid2gt = [], [], {}
    for q in range(6):
        s = np.sort(rng.uniform(0, 100, (8, 2)), axis=1)
        sub.append(dict(qid=q, pred_relevant_windows=[
            [float(a), float(b), float(c)] for (a, b), c in
            zip(s, rng.uniform(0, 1, 8))],
            pred_saliency_scores=rng.standard_normal(20).tolist()))
        gt.append(dict(qid=q, relevant_windows=np.sort(
            rng.uniform(0, 100, (1 + q % 2, 2)), axis=1).tolist()))
        qid2gt[q] = rng.integers(0, 2, (20, 3)).astype(np.float32)
    assert vtg.compute_mr_ap(sub, gt) == jax_metrics.compute_mr_ap(sub, gt)
    assert vtg.compute_mr_r1(sub, gt) == jax_metrics.compute_mr_r1(sub, gt)
    qid2preds = {s["qid"]: s for s in sub}
    assert vtg.compute_hl_hit1(qid2preds, qid2gt) == \
        jax_metrics.compute_hl_hit1(qid2preds, qid2gt)
    assert vtg.compute_hl_ap(qid2preds, qid2gt) == \
        jax_metrics.compute_hl_ap(qid2preds, qid2gt)


def test_semantic_matching_matches_jax():
    rng = np.random.default_rng(11)
    tags = (rng.random((40, 7)) > 0.6).astype(np.float64)
    for _ in range(3):
        machine = rng.choice(40, 6, replace=False).tolist()
        truth = rng.choice(40, 9, replace=False).tolist()
        assert vtg.calculate_semantic_matching(machine, truth, tags) == \
            jax_qfvs.calculate_semantic_matching(machine, truth, tags)
    assert vtg.semantic_iou(tags[0], tags[1]) == \
        jax_qfvs.semantic_iou(tags[0], tags[1])


@pytest.mark.parametrize("kind", ["point", "interval", "curve"])
def test_build_vlp_sample_matches_jax(kind):
    got = vtg.build_vlp_sample(24, 5, 4, 3, kind, np.random.default_rng(7))
    want = jax_vlp.build_vlp_sample(24, 5, 4, 3, kind,
                                    np.random.default_rng(7))
    _assert_same(got, want)


def test_zero_shot_class_scores_match_jax(short):
    """``VlpPretrainer.zero_shot_class_scores`` of 4 VLP samples (2 query
    tokens, 24 clips) against the JAX pretrainer's, whose model call is
    the fixture's compiled forward with class-name tokens."""
    samples = [jax_vlp.build_vlp_sample(24, VID_DIM, TXT_DIM, 2, kind,
                                        np.random.default_rng(i))
               for i, kind in enumerate(("point", "interval", "curve",
                                         "point"))]
    apply = short["apply"]
    jv = jax_vlp.VlpPretrainer(TXT_DIM, VID_DIM, embed_dim=EMBED,
                               depth=DEPTH, max_q_l=2, max_v_l=24,
                               impl="assoc")
    jv.params = short["params"]
    jv.model = types.SimpleNamespace(
        apply=lambda p, *a, src_cls, src_cls_mask, deterministic:
        apply(p, *a, src_cls, src_cls_mask))
    want = jv.zero_shot_class_scores(samples, short["cls"], short["cls_mask"])
    port = vtg.VlpPretrainer(TXT_DIM, VID_DIM, embed_dim=EMBED, depth=DEPTH,
                             max_q_l=2, max_v_l=24, device="cpu")
    port.model.load_state_dict(vtg_from_jax(short["params"]))
    got = port.zero_shot_class_scores(samples, short["cls"],
                                      short["cls_mask"])
    assert got.shape == (4, 24, 3)
    _close(got, want)


def test_qfvs_losses_match_jax():
    rng = np.random.default_rng(13)
    out = dict(pred_logits=rng.uniform(0, 1, (3, 16, 1)),
               saliency_scores=rng.standard_normal((3, 16)))
    out = {k: v.astype(np.float32) for k, v in out.items()}
    gt = (rng.random((3, 16)) > 0.7).astype(np.float32)
    mask = np.ones((3, 16), np.float32)
    mask[1, 10:] = 0.0
    gt[2] = 0.0                                  # no positive frame
    want = jax.jit(jax_qfvs.qfvs_losses)(out, gt, mask)
    got = vtg.qfvs_losses({k: _t(v) for k, v in out.items()}, _t(gt),
                          _t(mask))
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=LOSS_TOL)


def _qfvs_trainer(short):
    trainer = vtg.QfvsTrainer(TXT_DIM, VID_DIM, embed_dim=EMBED,
                              depth=DEPTH, lr=1e-3, device="cpu")
    trainer.model.load_state_dict(vtg_from_jax(short["params"]))
    return trainer


def test_qfvs_step_matches_jax(short):
    """One ``QfvsTrainer.train_step(deterministic=True)``: the losses of its
    three forwards (concept 1, concept 2, the oracle) gathered, against
    the JAX ``qfvs_losses`` of the fixture's forwards; then every
    parameter has a finite gradient and the AdamW update moves it."""
    vid, vmask, gt, c1, c2 = short["collated"]
    trainer = _qfvs_trainer(short)
    before = {n: p.detach().clone()
              for n, p in trainer.model.named_parameters()}
    got = trainer.train_step(vid, vmask, gt, c1, c2, deterministic=True)
    outs = short["outs"]
    losses = jax.jit(jax_qfvs.qfvs_losses)
    terms = {name: losses(outs[name], gt, vmask)
             for name in ("c1", "c2", "oracle")}
    total = sum(float(t["loss_total"]) for t in terms.values())
    assert got["loss_total"] == pytest.approx(total, rel=LOSS_TOL)
    for k in ("loss_f", "loss_s_intra"):
        assert got[k] == pytest.approx(float(terms["oracle"][k]),
                                       rel=LOSS_TOL)
    for name, p in trainer.model.named_parameters():
        assert torch.isfinite(p.grad).all(), name
        assert not torch.equal(p.detach(), before[name]), name


def test_qfvs_summary_and_evaluate_match_jax(short):
    """``predict_summary`` (top 15% of each video's valid frames by the
    three forwards' summed scores) and ``evaluate``'s P / R / F against the
    JAX trainer's, whose scores come from the fixture's forwards."""
    vid, vmask, gt, c1, c2 = short["collated"]
    jq = jax_qfvs.QfvsTrainer(TXT_DIM, VID_DIM, embed_dim=EMBED,
                              depth=DEPTH, impl="assoc")
    jq.params = short["params"]
    outs = short["outs"]

    def scores(params, v, vm, txt):
        name = ("oracle" if txt.shape[1] == 2 else
                "c1" if np.array_equal(txt, c1) else "c2")
        return outs[name]["pred_logits"][..., 0], outs[name][
            "saliency_scores"]

    jq._scores = scores
    trainer = _qfvs_trainer(short)
    got = trainer.predict_summary(vid, vmask, c1, c2)
    want = jq.predict_summary(vid, vmask, c1, c2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    got = trainer.evaluate(short["items"], short["tags"])
    want = jq.evaluate(short["items"], short["tags"])
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("fixture", ["mr", "short"], ids=["dbm", "vim"])
def test_vtg_from_jax_loads_strictly(request, fixture):
    """The converter's keys are exactly the port model's, at each mixer,
    with the shapes of the port's own parameters."""
    tree = request.getfixturevalue(fixture)["params"]
    model = vtg.UniVTGMamba(TXT_DIM, VID_DIM, EMBED, DEPTH,
                            mamba_type="dbm" if fixture == "mr" else "vim",
                            device="cpu")
    sd = vtg_from_jax(tree)
    own = model.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in own.items()}
    model.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("name", ["VTG_QVHIGHLIGHTS", "VTG_CHARADES",
                                  "VTG_TACOS", "VTG_EGO4D", "VTG_TVSUM"])
def test_presets_match_jax(name):
    assert getattr(configs, name) == PRESETS[name.lower()]


def test_vtg_dataset_and_file_loader_match_jax(tmp_path):
    """``VtgDataset`` (two feature directories, ``.npy`` and ``.npz``, tef,
    normalization, per-annotator saliency) and ``load_file_dataset`` on the
    same files: equal samples."""
    rng = np.random.default_rng(14)
    vdirs = [tmp_path / "slowfast", tmp_path / "clip"]
    qdir = tmp_path / "query"
    for d in vdirs + [qdir]:
        d.mkdir()
    metas = []
    for i, T in enumerate((12, 20)):
        vid = f"v{i}"
        np.save(vdirs[0] / f"{vid}.npy", rng.standard_normal((T, 4)))
        np.savez(vdirs[1] / f"{vid}.npz",
                 features=rng.standard_normal((T + 1, 3)))
        np.save(vdirs[1] / f"{vid}.npy", rng.standard_normal((T + 1, 3)))
        np.save(qdir / f"{i}.npy", rng.standard_normal((5, 6)))
        np.savez(qdir / f"qid{i}.npz", features=rng.standard_normal((5, 6)))
        metas.append(dict(qid=i, vid=vid, duration=2.0 * T,
                          relevant_windows=[[2.0, 10.0]],
                          relevant_clip_ids=[1, 2, 3, 40],
                          saliency_scores=[[1, 2, 3], [0, 1, 4], [2, 2, 2],
                                           [4, 4, 4]]))
    path = tmp_path / "train.jsonl"
    path.write_text("\n".join(json.dumps(m) for m in metas) + "\n")
    args = (str(path), [str(d) for d in vdirs], str(qdir))
    got = vtg.VtgDataset(*args, max_q_l=4, max_v_l=16)
    want = jax_dataset.VtgDataset(*args, max_q_l=4, max_v_l=16)
    assert len(got) == len(want) == 2
    for i in range(2):
        _assert_same(got[i], want[i])
    _assert_same(vtg.load_file_dataset(*args, max_v_l=16),
                 jax_data.load_file_dataset(*args, max_v_l=16))


def test_trainers_run_on_the_cpu():
    """Port-side: ``train_epoch`` takes the epoch's seeded order in
    batches of 2 and skips a last batch of one (5 samples: 2 steps);
    ``HlTrainer``'s step is ``hl_losses`` of its forward, its scores are
    saliency + probability a video; no kernel launches on the CPU."""
    from video_mamba_suite_torch.ops import LAUNCHES

    before = dict(LAUNCHES)
    samples = vtg.make_synthetic_vtg(num_samples=5, ctx_l=20, txt_len=3,
                                     txt_dim=4, vid_dim=4)
    tr = vtg.VtgTrainer(4, 4, embed_dim=16, depth=1, max_q_l=3, max_v_l=20,
                        device="cpu")
    steps = []
    tr.train_step = lambda batch: steps.append(batch) or {"loss_total": 1.0}
    assert tr.train_epoch(samples, batch_size=2) == {"loss_total": 1.0}
    assert len(steps) == 2
    order = vtg.train.sharded_epoch_order(5, 0)
    np.testing.assert_array_equal(
        steps[1]["src_vid"][0], samples[order[2]]["vid_feat"])
    rng = np.random.default_rng(15)
    hl_samples = [dict(vid_feat=rng.standard_normal((T, 4)).astype(
        np.float32), saliency=rng.integers(0, 3, T).astype(np.float32))
        for T in (20, 14)]
    hl = vtg.HlTrainer(3, 4, embed_dim=16, depth=1, max_v_l=20,
                       device="cpu")
    batch = vtg.collate_hl(hl_samples, 20, 3)
    with torch.no_grad():
        want = vtg.hl_losses(hl.forward(batch), hl._on(
            batch, vtg.hl.HL_TARGET_KEYS))
    got = hl.train_step(batch, deterministic=True)
    for k in want:
        assert got[k] == pytest.approx(float(want[k]), rel=1e-6)
    scores = hl.predict_scores(hl_samples)
    with torch.no_grad():
        out = hl.forward(vtg.collate_hl(hl_samples[1:], 20, 3))
    np.testing.assert_allclose(
        scores[1], (out["saliency_scores"][0, :14]
                    + out["pred_logits"][0, :14, 0]).numpy(), rtol=1e-6)
    assert dict(LAUNCHES) == before
