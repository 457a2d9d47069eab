"""Upstream PyTorch checkpoints into the port's towers, against the JAX
package's converters, on the CPU.

The state dicts are drawn by numpy from a seed in the upstream key layouts
(those of tests/test_convert_vision.py: avion TimeMamba, ViViM /
VisionMamba, open_clip text and image towers, avion CLIP; the bimamba-v2
and scan-norm ViM mixers and the causal mixer). Each
``*_from_state_dict(sd)`` must give exactly the tensors of the JAX
``convert_*(sd)`` followed by the port's ``*_from_jax``, and load with
``strict=True``; depth-2 TimeMamba and ViViM forwards built from one
``sd`` must agree with the JAX modules built from it. Then the embedding
inflation against the JAX one, and ``load_state_dict`` against the JAX
``load_torch_checkpoint`` on a file that keeps its training
``argparse.Namespace`` beside the weights.
"""

import argparse
import math
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_mamba_suite_tpu.models import convert as jax_convert
from video_mamba_suite_tpu.models.timemamba import TimeMamba as JaxTimeMamba
from video_mamba_suite_tpu.models.vivim import ViViM as JaxViViM
from video_mamba_suite_torch.models import (
    CLIP,
    ClipImageTower,
    MambaCausal,
    MambaScanNorm,
    MambaVim,
    TextTransformer,
    TimeMamba,
    ViViM,
    causal_mixer_from_jax,
    causal_mixer_from_state_dict,
    clip_from_jax,
    clip_from_state_dict,
    clip_image_tower_from_jax,
    clip_image_tower_from_state_dict,
    inflate_pos_embed,
    inflate_temporal_embed,
    load_state_dict,
    text_transformer_from_jax,
    text_transformer_from_state_dict,
    timemamba_from_jax,
    timemamba_from_state_dict,
    vim_mixer_from_jax,
    vim_mixer_from_state_dict,
    vivim_from_jax,
    vivim_from_state_dict,
)

# depth-2 forwards from one state dict, fp32: within 1e-4 of the output
# scale (the JAX TimeMamba runs its "assoc" scan, the port the plain
# sequential one; tests/test_torch_timemamba.py holds the two at 1e-4)
FWD_TOL = 1e-4
TM = dict(img_size=32, patch_size=16, embed_dim=32, depth=2, num_heads=2,
          num_frames=8, ln_pre=True, is_tanh_gating=True, output_dim=16)
VV = dict(img_size=48, patch_size=8, num_frames=2, depth=2, embed_dim=32,
          num_classes=5)
TEXT = dict(context_length=6, vocab_size=60, width=32, heads=4, layers=1,
            output_dim=16)


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


class _TrainingState:
    """A class no weights-only load allows."""


def _draw(rng, shapes, prefix=""):
    """Tensors for ``shapes`` drawn from N(0, 0.05²), A_log as log(1..n)
    with noise, under ``prefix``."""
    out = {}
    for name, shape in shapes.items():
        x = 0.05 * rng.standard_normal(shape)
        if "A" in name and name.endswith("_log"):
            x = np.log(np.arange(1, shape[-1] + 1)) + 0.1 * x
        out[prefix + name] = torch.from_numpy(np.asarray(x, np.float32))
    return out


def _vim_shapes(d, expand=1, d_state=16, d_conv=4, scan_norm=False,
                causal=False):
    d_in, rank = d * expand, math.ceil(d / 16)
    shapes = {"in_proj.weight": (2 * d_in, d), "out_proj.weight": (d, d_in)}
    for suf, a, dd in (("", "A_log", "D"), ("_b", "A_b_log", "D_b")):
        shapes.update({
            f"conv1d{suf}.weight": (d_in, 1, d_conv),
            f"conv1d{suf}.bias": (d_in,),
            f"x_proj{suf}.weight": (rank + 2 * d_state, d_in),
            f"dt_proj{suf}.weight": (d_in, rank),
            f"dt_proj{suf}.bias": (d_in,), a: (d_in, d_state), dd: (d_in,)})
        if causal:
            break
    if scan_norm:
        shapes["norm.weight"] = (d_in,)
    return shapes


def _ln(name, d):
    return {name + ".weight": (d,), name + ".bias": (d,)}


def _attn_mlp(d, fc1="fc1", fc2="fc2"):
    return {"attn.in_proj_weight": (3 * d, d), "attn.in_proj_bias": (3 * d,),
            "attn.out_proj.weight": (d, d), "attn.out_proj.bias": (d,),
            f"mlp.{fc1}.weight": (4 * d, d), f"mlp.{fc1}.bias": (4 * d,),
            f"mlp.{fc2}.weight": (d, 4 * d), f"mlp.{fc2}.bias": (d,)}


def _timemamba_sd(rng, prefix=""):
    d, p = TM["embed_dim"], TM["patch_size"]
    n = (TM["img_size"] // p) ** 2
    shapes = {"patch_embed.proj.weight": (d, 3, p, p), "cls_token": (1, 1, d),
              "pos_embed": (1, n + 1, d), "image_projection": (d, 16),
              **_ln("ln_pre", d), **_ln("norm", d)}
    for i in range(TM["depth"]):
        b = f"blocks.{i}."
        for norm in ("norm1", "norm2", "norm3"):
            shapes.update(_ln(b + norm, d))
        shapes.update({b + k: v for k, v in _attn_mlp(d).items()})
        shapes.update({b + "time_mamba." + k: v
                       for k, v in _vim_shapes(d).items()})
        shapes[b + "alpha_timeattn"] = ()
    sd = _draw(rng, shapes, prefix)
    for name, t in sd.items():             # norms near 1, gates off 0
        if name.endswith("alpha_timeattn"):
            t.fill_(0.7)
        elif "norm" in name and name.endswith(".weight") and t.dim() == 1:
            t.add_(1.0)
    return sd


def _vivim_sd(rng, prefix="", temporal="temporal_embedding", bias=True,
              head=True, projection=False):
    d, p = VV["embed_dim"], VV["patch_size"]
    n = (VV["img_size"] // p) ** 2
    shapes = {"patch_embed.proj.weight": (d, 3, p, p),
              "patch_embed.proj.bias": (d,), "cls_token": (1, 1, d),
              "pos_embed": (1, n + 1, d), temporal: (VV["num_frames"], 1, d),
              "norm_f.weight": (d,)}
    if bias:
        shapes["norm_f.bias"] = (d,)
    if head:
        shapes.update({"head.weight": (VV["num_classes"], d),
                       "head.bias": (VV["num_classes"],)})
    if projection:
        shapes["image_projection"] = (d, 16)
    for i in range(VV["depth"]):
        lp = f"layers.{i}."
        shapes[lp + "norm.weight"] = (d,)
        if bias:
            shapes[lp + "norm.bias"] = (d,)
        shapes.update({lp + "mixer." + k: v
                       for k, v in _vim_shapes(d, expand=2).items()})
    return _draw(rng, shapes, prefix)


def _resblocks(prefix, width, layers):
    shapes = {}
    for i in range(layers):
        b = f"{prefix}transformer.resblocks.{i}."
        shapes.update(_ln(b + "ln_1", width))
        shapes.update(_ln(b + "ln_2", width))
        shapes.update({b + k: v for k, v in
                       _attn_mlp(width, "c_fc", "c_proj").items()})
    return shapes


def _text_sd(rng):
    w = TEXT["width"]
    shapes = {"textual.token_embedding.weight": (TEXT["vocab_size"], w),
              "textual.positional_embedding": (TEXT["context_length"], w),
              "textual.text_projection": (w, TEXT["output_dim"]),
              **_ln("textual.ln_final", w),
              **_resblocks("textual.", w, TEXT["layers"])}
    return _draw(rng, shapes)


def _image_sd(rng, width=32, patch=16, img=32, layers=2):
    n = (img // patch) ** 2
    shapes = {"visual.conv1.weight": (width, 3, patch, patch),
              "visual.class_embedding": (width,),
              "visual.positional_embedding": (n + 1, width),
              "visual.proj": (width, 16), **_ln("visual.ln_pre", width),
              **_ln("visual.ln_post", width),
              **_resblocks("visual.", width, layers)}
    return _draw(rng, shapes)


def _same(got, want):
    assert set(got) == set(want)
    for key in got:
        assert got[key].dtype == want[key].dtype == torch.float32, key
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("kind", ["vim", "scan_norm", "causal"])
def test_mixer_from_state_dict_equals_jax_route(kind):
    """A mixer's upstream state_dict (under a prefix) directly and through
    the JAX converter give the same tensors, and load strictly."""
    rng = np.random.default_rng(1)
    sd = _draw(rng, _vim_shapes(16, expand=2, scan_norm=kind == "scan_norm",
                                causal=kind == "causal"), "blk.mixer.")
    if kind == "causal":
        got = causal_mixer_from_state_dict(sd, "blk.mixer.")
        want = causal_mixer_from_jax(
            jax_convert.convert_mamba_mixer(sd, "blk.mixer."))
        module = MambaCausal(16, device="cpu")
    else:
        convert = (jax_convert.convert_scan_norm_mixer if kind == "scan_norm"
                   else jax_convert.convert_vim_mixer)
        got = vim_mixer_from_state_dict(sd, "blk.mixer.")
        want = vim_mixer_from_jax(convert(sd, "blk.mixer."))
        module = (MambaScanNorm if kind == "scan_norm" else MambaVim)(
            16, device="cpu")
    _same(got, want)
    module.load_state_dict(got, strict=True)


def test_timemamba_from_state_dict_equals_jax_route_and_forward():
    """TimeMamba (ln_pre, tanh gates, image projection) directly and through
    ``convert_timemamba``; then the depth-2 forwards of the port and of the
    JAX module from the same state dict."""
    rng = np.random.default_rng(2)
    sd = _timemamba_sd(rng)
    got = timemamba_from_state_dict(sd, TM["depth"])
    tree = jax_convert.convert_timemamba(sd, TM["depth"], TM["num_heads"])
    _same(got, timemamba_from_jax(tree, TM["depth"]))
    port = TimeMamba(**TM, device="cpu")
    port.load_state_dict(got, strict=True)
    x = rng.standard_normal((2, 8, 32, 32, 3)).astype(np.float32)
    want = jax.jit(JaxTimeMamba(**TM, impl="assoc").apply)(
        {"params": tree}, jnp.asarray(x))
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(x))
    want = np.asarray(want)
    err = np.abs(out.numpy() - want).max() / np.abs(want).max()
    assert out.shape == (2, 16) and err <= FWD_TOL, err


@pytest.mark.parametrize("temporal,bias,head", [
    ("temporal_embedding", True, True), ("temporal_embed", False, False)])
def test_vivim_from_state_dict_equals_jax_route(temporal, bias, head):
    """ViViM with either temporal-embedding name, with and without the
    norms' biases (an RMSNorm model) and the head."""
    rng = np.random.default_rng(3)
    sd = _vivim_sd(rng, temporal=temporal, bias=bias, head=head,
                   projection=not head)
    got = vivim_from_state_dict(sd, VV["depth"])
    _same(got, vivim_from_jax(jax_convert.convert_vivim(sd, VV["depth"]),
                              VV["depth"]))
    assert got["temporal_embed"].shape == (VV["num_frames"], 1, 32)
    kw = dict(VV, rms_norm=not bias)
    if not head:
        kw.update(num_classes=0, output_dim=16)
    ViViM(**kw, device="cpu").load_state_dict(got, strict=True)


def test_vivim_forward_from_state_dict_matches_jax():
    """Depth-2 ViViM (74 tokens: one scan per direction) of the port and
    of the JAX module from the same upstream state dict."""
    rng = np.random.default_rng(4)
    sd = _vivim_sd(rng)
    port = ViViM(**VV, device="cpu")
    port.load_state_dict(vivim_from_state_dict(sd, VV["depth"]), strict=True)
    x = rng.standard_normal((2, 2, 48, 48, 3)).astype(np.float32)
    want = np.asarray(jax.jit(JaxViViM(**VV).apply)(
        {"params": jax_convert.convert_vivim(sd, VV["depth"])},
        jnp.asarray(x)))
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(x)).numpy()
    err = np.abs(out - want).max() / np.abs(want).max()
    assert out.shape == (2, 5) and err <= FWD_TOL, err


def test_text_and_image_towers_from_state_dict_equal_jax_route():
    """The open_clip text tower (``c_fc`` / ``c_proj``) and a CLIP ViT image
    tower (conv1 (D, 3, p, p) to (D, p·p·3))."""
    rng = np.random.default_rng(5)
    sd = _text_sd(rng)
    got = text_transformer_from_state_dict(sd, TEXT["layers"])
    _same(got, text_transformer_from_jax(jax_convert.convert_text_transformer(
        sd, TEXT["layers"], TEXT["heads"])))
    TextTransformer(**TEXT, generator=torch.Generator()).load_state_dict(
        got, strict=True)
    sd = _image_sd(rng)
    got = clip_image_tower_from_state_dict(sd, 2)
    _same(got, clip_image_tower_from_jax(
        jax_convert.convert_clip_image_tower(sd, 2, 2)))
    tower = ClipImageTower(img_size=32, patch_size=16, width=32, layers=2,
                           heads=2, output_dim=16,
                           generator=torch.Generator())
    tower.load_state_dict(got, strict=True)
    w = sd["visual.conv1.weight"]               # tap (row 3, col 5, chan 1)
    assert got["conv1.weight"][7, (3 * 16 + 5) * 3 + 1] == w[7, 1, 3, 5]


@pytest.mark.parametrize("vision", ["timemamba", "vivim"])
def test_clip_from_state_dict_equals_jax_route(vision):
    """A whole avion CLIP with either video tower; ``logit_scale`` a 0-d
    tensor."""
    rng = np.random.default_rng(6)
    if vision == "timemamba":
        sd = _timemamba_sd(rng, "visual.")
        vision_cfg = {k: v for k, v in TM.items() if k != "output_dim"}
    else:
        sd = _vivim_sd(rng, "visual.", head=False, projection=True)
        vision_cfg = dict(VV, num_classes=0)
    sd.update(_text_sd(rng))
    sd["logit_scale"] = torch.tensor([math.log(1 / 0.07)])
    got = clip_from_state_dict(sd, vision, 2, TEXT["layers"])
    _same(got, clip_from_jax(jax_convert.convert_clip(
        sd, vision, 2, TEXT["layers"], TEXT["heads"])))
    assert got["logit_scale"].shape == ()
    text_cfg = {k: v for k, v in TEXT.items() if k != "output_dim"}
    CLIP(embed_dim=16, vision_tower=vision, vision_cfg=vision_cfg,
         text_cfg=text_cfg, device="cpu").load_state_dict(got, strict=True)


@pytest.mark.parametrize("old,new,mode", [
    (8, 4, "zeros"), (4, 4, "bilinear"), (4, 16, "zeros"), (3, 8, "interp"),
    (4, 16, "bilinear")], ids=["cut", "kept", "zeros", "interp", "bilinear"])
@pytest.mark.parametrize("squeeze", [True, False], ids=["T1D", "TD"])
def test_inflate_temporal_embed_matches_jax(old, new, mode, squeeze):
    """Cut, kept, or grown by zeros or interpolation, (T, 1, D) and (T, D):
    the same float32 values as the JAX function (both interpolate in
    float64 and cast back)."""
    rng = np.random.default_rng(old * 10 + new)
    e = rng.standard_normal((old, 1, 6) if squeeze else (old, 6)).astype(
        np.float32)
    want = jax_convert.inflate_temporal_embed(e, new, mode)
    got = inflate_temporal_embed(torch.from_numpy(e), new, mode)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_inflate_refuses_what_jax_refuses():
    e = torch.zeros(2, 1, 4)
    with pytest.raises(NotImplementedError):
        inflate_temporal_embed(e, 4, "cubic")
    with pytest.raises(NotImplementedError):
        jax_convert.inflate_temporal_embed(e.numpy(), 4, "cubic")
    for fn, pos in ((inflate_pos_embed, torch.zeros(1, 1 + 12, 4)),
                    (jax_convert.inflate_pos_embed, np.zeros((1, 13, 4)))):
        with pytest.raises(ValueError, match="square"):
            fn(pos, 16)


@pytest.mark.parametrize("old,new", [(16, 36), (36, 16), (16, 16)])
def test_inflate_pos_embed_matches_jax(old, new):
    """A square grid resized along rows then columns. The JAX function
    returns its float64 result; the port casts it to the input's float32,
    so each value is the JAX value rounded once (within half a float32 ulp
    of it)."""
    rng = np.random.default_rng(old + new)
    pos = rng.standard_normal((1, 1 + old, 8)).astype(np.float32)
    want = jax_convert.inflate_pos_embed(pos, new)
    got = inflate_pos_embed(torch.from_numpy(pos), new)
    assert got.shape == (1, 1 + new, 8) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=2.0 ** -24, atol=0)


@pytest.mark.parametrize("wrapper", ["state_dict", "model", "module"])
def test_load_state_dict_takes_a_training_namespace(tmp_path, wrapper):
    """A checkpoint that keeps its ``argparse.Namespace`` (and an epoch)
    beside the weights: the port's weights-only load returns the tensors
    the JAX ``load_torch_checkpoint`` returns."""
    sd = _draw(np.random.default_rng(7), _vim_shapes(16, expand=2))
    path = tmp_path / "checkpoint.pth"
    torch.save({wrapper: sd, "epoch": 3,
                "args": argparse.Namespace(lr=1e-4, model="TimeMamba")},
               path)
    want = jax_convert.load_torch_checkpoint(str(path))
    got = load_state_dict(str(path))
    _same(got, want)


def test_load_state_dict_names_a_refused_class(tmp_path):
    path = tmp_path / "checkpoint.pth"
    torch.save({"state_dict": {"w": torch.ones(2)},
                "args": argparse.Namespace(lr=1e-4),
                "trainer": _TrainingState()}, path)
    with pytest.raises(pickle.UnpicklingError, match="_TrainingState"):
        load_state_dict(str(path))
