"""JAX parameter trees and upstream PyTorch state_dicts → the port's
``state_dict``.

``*_from_jax`` take the JAX package's flax parameter tree as numpy arrays
(the mapping its ``models/convert.py`` builds from upstream checkpoints,
read in reverse); Dense kernels go from flax's (in, out) to torch's (out,
in). ``*_from_state_dict`` take an upstream checkpoint's state_dict (as
``models.hf.load_state_dict`` reads it) and give the same tensors the JAX
``convert_*`` followed by ``*_from_jax`` give; ``inflate_pos_embed`` and
``inflate_temporal_embed`` resize embeddings for another resolution or
frame count. Every result loads into its port module with
``strict=True``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _dense(tree: Dict[str, Any], prefix: str, out: Dict[str, torch.Tensor]):
    out[prefix + "weight"] = _tensor(np.asarray(tree["kernel"]).T)
    if "bias" in tree:
        out[prefix + "bias"] = _tensor(tree["bias"])


def _layernorm(tree, prefix, out):
    out[prefix + "weight"] = _tensor(tree["scale"])
    out[prefix + "bias"] = _tensor(tree["bias"])


def _scan_params(tree, prefix, out):
    out[prefix + "conv_w"] = _tensor(tree["conv_w"])
    if "conv_bias" in tree:
        out[prefix + "conv_bias"] = _tensor(tree["conv_bias"])
    out[prefix + "x_proj"] = _tensor(np.asarray(tree["x_proj"]).T)
    out[prefix + "dt_proj"] = _tensor(np.asarray(tree["dt_proj"]).T)
    for name in ("dt_bias", "A_log", "D"):
        out[prefix + name] = _tensor(tree[name])


def vim_mixer_from_jax(params: Dict[str, Any], prefix: str = ""
                       ) -> Dict[str, torch.Tensor]:
    """A JAX ``MambaVim`` tree {in_proj, fwd, bwd, out_proj} (and the
    ``scan_norm_w`` of a ``MambaScanNorm``) → the port's ``MambaVim`` or
    ``MambaScanNorm`` state_dict (keys under ``prefix``)."""
    params = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    _dense(params["in_proj"], prefix + "in_proj.", out)
    _scan_params(params["fwd"], prefix + "fwd.", out)
    _scan_params(params["bwd"], prefix + "bwd.", out)
    _dense(params["out_proj"], prefix + "out_proj.", out)
    if "scan_norm_w" in params:                       # MambaScanNorm
        out[prefix + "scan_norm_w"] = _tensor(params["scan_norm_w"])
    return out


def causal_mixer_from_jax(params: Dict[str, Any], prefix: str = ""
                          ) -> Dict[str, torch.Tensor]:
    """A JAX ``MambaCausal`` tree {in_proj, fwd, out_proj} → the port's
    ``MambaCausal`` state_dict (keys under ``prefix``)."""
    params = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    _dense(params["in_proj"], prefix + "in_proj.", out)
    _scan_params(params["fwd"], prefix + "fwd.", out)
    _dense(params["out_proj"], prefix + "out_proj.", out)
    return out


def dbm_mixer_from_jax(params: Dict[str, Any], prefix: str = ""
                       ) -> Dict[str, torch.Tensor]:
    """A JAX ``MambaDBM`` tree {in_proj, shared, out_proj} → the port's
    ``MambaDBM`` state_dict (keys under ``prefix``)."""
    params = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    _dense(params["in_proj"], prefix + "in_proj.", out)
    _scan_params(params["shared"], prefix + "shared.", out)
    _dense(params["out_proj"], prefix + "out_proj.", out)
    return out


def _causal_block(tree, prefix, out):
    """A JAX ``Block`` around a ``MambaCausal`` {norm_w, norm_b?, mixer}."""
    out[prefix + "norm_w"] = _tensor(tree["norm_w"])
    if "norm_b" in tree:
        out[prefix + "norm_b"] = _tensor(tree["norm_b"])
    out.update(causal_mixer_from_jax(tree["mixer"], prefix + "mixer."))


def mamba_lm_from_jax(params: Dict[str, Any], n_layer: int
                      ) -> Dict[str, torch.Tensor]:
    """A JAX ``MambaLMHeadModel`` tree {backbone: {embedding: {embedding},
    layers_i: {norm_w, mixer: {in_proj, fwd, out_proj}}, norm_f_w}} → the
    port's ``MambaLMHeadModel`` state_dict (the head is tied to the
    embedding)."""
    params = params.get("params", params)
    tree = params["backbone"]
    out: Dict[str, torch.Tensor] = {
        "backbone.embedding.weight": _tensor(
            tree["embedding"]["embedding"])}
    for i in range(n_layer):
        _causal_block(tree[f"layers_{i}"], f"backbone.layers.{i}.", out)
    for name in ("norm_f_w", "norm_f_b"):
        if name in tree:
            out["backbone." + name] = _tensor(tree[name])
    return out


def _serving_tensor(x) -> torch.Tensor:
    """A leaf of a quantized JAX tree in its own dtype: int8 stays int8,
    bf16 (numpy's ml_dtypes) becomes torch's bf16 through fp32, exactly."""
    x = np.asarray(x)
    if x.dtype == np.int8:
        return torch.from_numpy(x.copy())
    if x.dtype.name == "bfloat16":
        return _tensor(x.astype(np.float32)).to(torch.bfloat16)
    return _tensor(x)


def quantized_lm_from_jax(variables: Dict[str, Any], n_layer: int
                          ) -> Dict[str, torch.Tensor]:
    """The JAX ``quantize_lm_for_decode`` output {"params": ..., "qscale":
    ...} → a quantized port ``MambaLMHeadModel``'s state_dict: the int8
    embedding and the int8 in_proj / out_proj weights (transposed to (out,
    in)) with their fp32 scales under ``qscale``, every other leaf in its
    JAX dtype. It loads into a model of the same widths after
    ``quantize_lm_for_decode`` with the same ``cast``."""
    params = variables["params"]["backbone"]
    scales = variables["qscale"]["backbone"]
    out = {"backbone.embedding.weight": _serving_tensor(
               params["embedding"]["embedding"]),
           "backbone.embedding.qscale": _tensor(
               scales["embedding"]["embedding"])}
    for i in range(n_layer):
        tree = params[f"layers_{i}"]
        prefix = f"backbone.layers.{i}."
        for name in ("norm_w", "norm_b"):
            if name in tree:
                out[prefix + name] = _serving_tensor(tree[name])
        mixer = tree["mixer"]
        for proj in ("in_proj", "out_proj"):
            out[f"{prefix}mixer.{proj}.weight"] = _serving_tensor(
                np.asarray(mixer[proj]["kernel"]).T)
            out[f"{prefix}mixer.{proj}.qscale"] = _tensor(
                scales[f"layers_{i}"]["mixer"][proj]["kernel"])
        fwd = mixer["fwd"]
        for name in ("conv_w", "conv_bias", "dt_bias", "A_log", "D"):
            if name in fwd:
                out[f"{prefix}mixer.fwd.{name}"] = _serving_tensor(fwd[name])
        for name in ("x_proj", "dt_proj"):
            out[f"{prefix}mixer.fwd.{name}"] = _serving_tensor(
                np.asarray(fwd[name]).T)
    for name in ("norm_f_w", "norm_f_b"):
        if name in params:
            out["backbone." + name] = _serving_tensor(params[name])
    return out


def _block(tree, prefix, out):
    for norm in ("norm1", "norm2", "norm3"):
        _layernorm(tree[norm], f"{prefix}{norm}.", out)
    out.update(vim_mixer_from_jax(tree["time_mamba"], prefix + "time_mamba."))
    _dense(tree["attn"]["qkv"], prefix + "attn.qkv.", out)
    _dense(tree["attn"]["out"], prefix + "attn.out.", out)
    _dense(tree["mlp"]["fc1"], prefix + "mlp.fc1.", out)
    _dense(tree["mlp"]["fc2"], prefix + "mlp.fc2.", out)
    if "alpha_timeattn" in tree:
        out[prefix + "alpha_timeattn"] = _tensor(tree["alpha_timeattn"])


def _unstack(tree, i: int):
    """Block i of a stacked tree (every leaf has a leading depth axis)."""
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def timemamba_from_jax(params: Dict[str, Any], depth: int
                       ) -> Dict[str, torch.Tensor]:
    """A JAX ``TimeMamba`` tree → the port's ``TimeMamba`` state_dict.

    Accepts the unrolled tree (``block{i}``) and the stacked tree of
    ``scan_blocks=True`` models (``blocks/block``, every leaf with a
    leading depth axis). ``scan_group > 1`` trees are not taken.
    """
    params = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    kernel = np.asarray(params["patch_embed"]["kernel"])       # (p, p, C, D)
    out["patch_embed.weight"] = _tensor(kernel.reshape(-1, kernel.shape[-1]).T)
    if "bias" in params["patch_embed"]:
        out["patch_embed.bias"] = _tensor(params["patch_embed"]["bias"])
    out["cls_token"] = _tensor(params["cls_token"])
    out["pos_embed"] = _tensor(params["pos_embed"])
    if "ln_pre" in params:
        _layernorm(params["ln_pre"], "ln_pre.", out)
    if "blocks" in params:
        stacked = params["blocks"]["block"]
        blocks = [_unstack(stacked, i) for i in range(depth)]
    else:
        blocks = [params[f"block{i}"] for i in range(depth)]
    for i, blk in enumerate(blocks):
        _block(blk, f"blocks.{i}.", out)
    _layernorm(params["norm"], "norm.", out)
    if "image_projection" in params:
        out["image_projection"] = _tensor(params["image_projection"])
    return out


def vivim_from_jax(params: Dict[str, Any], depth: int
                   ) -> Dict[str, torch.Tensor]:
    """A JAX ``ViViM`` tree → the port's ``ViViM`` state_dict.

    Accepts the per-layer tree (``norm{i}_w``, ``norm{i}_b``,
    ``mixer{i}``) and the stacked tree of ``scan_blocks=True`` models
    (``blocks/{norm_w, norm_b, mixer}``, every leaf with a leading depth
    axis). ``depth`` is the number of layers in the tree.
    """
    params = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    kernel = np.asarray(params["patch_embed"]["proj"]["kernel"])  # (p,p,C,D)
    out["patch_embed.proj.weight"] = _tensor(
        kernel.reshape(-1, kernel.shape[-1]).T)
    out["patch_embed.proj.bias"] = _tensor(
        params["patch_embed"]["proj"]["bias"])
    for name in ("cls_token", "pos_embed", "temporal_embed",
                 "image_projection", "norm_f_w", "norm_f_b"):
        if name in params:
            out[name] = _tensor(params[name])
    if "blocks" in params:
        stacked = params["blocks"]
        layers = [_unstack(stacked, i) for i in range(depth)]
    else:
        layers = [{"norm_w": params[f"norm{i}_w"],
                   "norm_b": params.get(f"norm{i}_b"),
                   "mixer": params[f"mixer{i}"]} for i in range(depth)]
    for i, layer in enumerate(layers):
        out[f"layers.{i}.norm_w"] = _tensor(layer["norm_w"])
        if layer.get("norm_b") is not None:
            out[f"layers.{i}.norm_b"] = _tensor(layer["norm_b"])
        out.update(vim_mixer_from_jax(layer["mixer"], f"layers.{i}.mixer."))
    if "head" in params:
        _dense(params["head"], "head.", out)
    return out


def lstr_mamba_from_jax(params: Dict[str, Any], mamba_layers: int
                        ) -> Dict[str, torch.Tensor]:
    """A JAX ``LSTRMamba`` tree {head_long/head_work: {fusion},
    blocks_i: {norm_w, mixer}, norm_f_w, dec_query?, classifier,
    classifier_verb?, classifier_noun?} → the port's ``LSTRMamba``
    state_dict. A ``NormalizedLinear`` classifier's (in, out) kernel
    becomes its (out, in) ``weight``, as a Dense kernel does."""
    params = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    for head in ("head_long", "head_work"):
        _dense(params[head]["fusion"], f"{head}.fusion.", out)
    for i in range(mamba_layers):
        _causal_block(params[f"blocks_{i}"], f"blocks.{i}.", out)
    out["norm_f_w"] = _tensor(params["norm_f_w"])
    if "dec_query" in params:
        out["dec_query"] = _tensor(params["dec_query"])
    for head in ("classifier", "classifier_verb", "classifier_noun"):
        if head in params:
            _dense(params[head], f"{head}.", out)
    return out


def _attention_block(tree, prefix, out):
    """A JAX ``ResidualAttentionBlock`` {ln_1, attn: {qkv, out}, ln_2,
    mlp: {fc1, fc2}}."""
    for norm in ("ln_1", "ln_2"):
        _layernorm(tree[norm], f"{prefix}{norm}.", out)
    for dense in ("qkv", "out"):
        _dense(tree["attn"][dense], f"{prefix}attn.{dense}.", out)
    for dense in ("fc1", "fc2"):
        _dense(tree["mlp"][dense], f"{prefix}mlp.{dense}.", out)


def _numbered(tree, stem: str) -> int:
    """How many keys ``<stem><i>`` the tree holds."""
    return sum(1 for key in tree if key.startswith(stem)
               and key[len(stem):].isdigit())


def text_transformer_from_jax(params: Dict[str, Any], prefix: str = ""
                              ) -> Dict[str, torch.Tensor]:
    """A JAX ``TextTransformer`` tree {token_embedding: {embedding},
    positional_embedding, resblock{i}, ln_final, text_projection?} → the
    port's ``TextTransformer`` state_dict (keys under ``prefix``)."""
    params = params.get("params", params)
    out: Dict[str, torch.Tensor] = {
        prefix + "token_embedding.weight": _tensor(
            params["token_embedding"]["embedding"]),
        prefix + "positional_embedding": _tensor(
            params["positional_embedding"])}
    for i in range(_numbered(params, "resblock")):
        _attention_block(params[f"resblock{i}"],
                         f"{prefix}resblocks.{i}.", out)
    _layernorm(params["ln_final"], prefix + "ln_final.", out)
    if "text_projection" in params:
        out[prefix + "text_projection"] = _tensor(params["text_projection"])
    return out


def clip_image_tower_from_jax(params: Dict[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """A JAX ``ClipImageTower`` tree {conv1: {kernel}, class_embedding,
    positional_embedding, ln_pre, resblock{i}, ln_post, proj?} → the port's
    ``ClipImageTower`` state_dict."""
    params = params.get("params", params)
    kernel = np.asarray(params["conv1"]["kernel"])              # (p, p, C, D)
    out: Dict[str, torch.Tensor] = {
        "conv1.weight": _tensor(kernel.reshape(-1, kernel.shape[-1]).T)}
    for name in ("class_embedding", "positional_embedding", "proj"):
        if name in params:
            out[name] = _tensor(params[name])
    for norm in ("ln_pre", "ln_post"):
        _layernorm(params[norm], f"{norm}.", out)
    for i in range(_numbered(params, "resblock")):
        _attention_block(params[f"resblock{i}"], f"resblocks.{i}.", out)
    return out


def _tower_depth(tree, stem: str) -> int:
    """Layers of a tower tree: the leading axis of a stacked tree's leaves
    (``blocks``), else the count of ``<stem><i>`` keys."""
    if "blocks" in tree:
        leaf = tree["blocks"]
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        return int(np.asarray(leaf).shape[0])
    return _numbered(tree, stem)


def clip_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``CLIP`` tree {visual, textual, logit_scale} → the port's
    ``CLIP`` state_dict. The video tower is a TimeMamba or a ViViM, per
    layer or stacked (``scan_blocks=True``, as the JAX CLI builds the
    egocentric models), with or without ``image_projection``; its depth
    is read from the tree."""
    params = params.get("params", params)
    out = {"visual." + key: value for key, value in
           _tower_from_jax(params["visual"]).items()}
    out.update(text_transformer_from_jax(params["textual"], "textual."))
    out["logit_scale"] = _tensor(params["logit_scale"])
    return out


def _tower_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A video tower's tree, TimeMamba or ViViM (per layer or stacked),
    with or without its projection; the depth is read from the tree."""
    if "proj" in tree["patch_embed"]:                             # ViViM
        return vivim_from_jax(tree, _tower_depth(tree, "mixer"))
    return timemamba_from_jax(tree, _tower_depth(tree, "block"))


def video_classifier_from_jax(params: Dict[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """A JAX ``VideoClassifier`` tree {vision_tower, fc_cls} → the port's
    ``VideoClassifier`` state_dict."""
    params = params.get("params", params)
    out = {"vision_tower." + key: value for key, value in
           _tower_from_jax(params["vision_tower"]).items()}
    _dense(params["fc_cls"], "fc_cls.", out)
    return out


def _conv1d(tree, prefix, out):
    """A flax ``nn.Conv`` {kernel (k, in, out), bias?} → a masked conv's
    (out, in, k) ``weight`` and ``bias``."""
    out[prefix + "weight"] = _tensor(
        np.asarray(tree["kernel"]).transpose(2, 1, 0))
    if "bias" in tree:
        out[prefix + "bias"] = _tensor(tree["bias"])


def _norm1d(tree, prefix, out):
    out[prefix + "norm_w"] = _tensor(tree["norm_w"])
    out[prefix + "norm_b"] = _tensor(tree["norm_b"])


def mask_mamba_block_from_jax(params: Dict[str, Any], prefix: str = ""
                              ) -> Dict[str, torch.Tensor]:
    """A JAX ``MaskMambaBlock`` tree {LayerNorm1D_0, mamba,
    AffineDropPath_0?} around a DBM or a ViM mixer → the port's
    ``MaskMambaBlock`` state_dict (keys under ``prefix``)."""
    tree = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    _norm1d(tree["LayerNorm1D_0"], prefix + "norm.", out)
    mixer = tree["mamba"]
    convert = dbm_mixer_from_jax if "shared" in mixer else vim_mixer_from_jax
    out.update(convert(mixer, prefix + "mamba."))
    if "AffineDropPath_0" in tree:
        out[prefix + "drop_path.scale"] = _tensor(
            tree["AffineDropPath_0"]["scale"])
    return out


def _conv_head(tree, prefix, out):
    for i in range(_numbered(tree, "head")):
        _conv1d(tree[f"head{i}"]["Conv_0"], f"{prefix}head.{i}.", out)
    for i in range(_numbered(tree, "norm")):
        _norm1d(tree[f"norm{i}"], f"{prefix}norm.{i}.", out)
    _conv1d(tree["final"], prefix + "final.", out)


def tal_detector_from_jax(params: Dict[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """A JAX ``ActionMambaDetector`` tree {backbone: {embd{i}, embd_ln{i},
    stem{i}, branch{i}}, neck: {norm{i}} or {lateral{i}, fpn_conv{i},
    fpn_norm{i}}, cls_head, reg_head: {head{i}, norm{i}, final},
    scale{l}} → the port's ``ActionMambaDetector`` state_dict (of the
    parts the tree holds)."""
    params = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    bb = params.get("backbone", {})
    for i in range(_numbered(bb, "embd")):
        _conv1d(bb[f"embd{i}"]["Conv_0"], f"backbone.embd.{i}.", out)
    for i in range(_numbered(bb, "embd_ln")):
        _norm1d(bb[f"embd_ln{i}"], f"backbone.embd_norm.{i}.", out)
    for stem in ("stem", "branch"):
        for i in range(_numbered(bb, stem)):
            out.update(mask_mamba_block_from_jax(
                bb[f"{stem}{i}"], f"backbone.{stem}.{i}."))
    neck = params.get("neck", {})
    for stem in ("norm", "fpn_norm"):
        for i in range(_numbered(neck, stem)):
            _norm1d(neck[f"{stem}{i}"], f"neck.{stem}.{i}.", out)
    for stem in ("lateral", "fpn_conv"):
        for i in range(_numbered(neck, stem)):
            _conv1d(neck[f"{stem}{i}"]["Conv_0"], f"neck.{stem}.{i}.", out)
    for head in ("cls_head", "reg_head"):
        if head in params:
            _conv_head(params[head], head + ".", out)
    for i in range(_numbered(params, "scale")):
        out[f"scale.{i}.scale"] = _tensor(params[f"scale{i}"]["scale"])
    return out



def tas_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``MaTransformer`` tree {encoder: {conv_1x1, layer{i}:
    {ConvFeedForward_0, mamba_block}, conv_out}, decoder{s}: {conv_1x1,
    layer{i}: {ConvFeedForward_0, query_conv, key_conv, value_conv,
    conv_out, conv_1x1}, conv_out}} → the port's ``MaTransformer``
    state_dict (of the parts the tree holds); flax Conv kernels (k, in,
    out) become (out, in, k)."""
    params = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    stages = [("encoder", "encoder.")] + [
        (f"decoder{s}", f"decoders.{s}.")
        for s in range(_numbered(params, "decoder"))]
    for name, prefix in stages:
        tree = params[name]
        for conv in ("conv_1x1", "conv_out"):
            if conv in tree:
                _conv1d(tree[conv], f"{prefix}{conv}.", out)
        for i in range(_numbered(tree, "layer")):
            layer, key = tree[f"layer{i}"], f"{prefix}layers.{i}."
            _conv1d(layer["ConvFeedForward_0"]["Conv_0"],
                    key + "feed_forward.", out)
            if "mamba_block" in layer:
                out.update(mask_mamba_block_from_jax(
                    layer["mamba_block"], key + "mamba_block."))
            for conv in ("query_conv", "key_conv", "value_conv",
                         "conv_out", "conv_1x1"):
                if conv in layer:
                    _conv1d(layer[conv], f"{key}{conv}.", out)
    return out

def vtg_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``UniVTGMamba`` tree {vid_proj{i}, txt_proj{i}: {LayerNorm_0?,
    Dense_0}, token_type, norm{i}_w, norm{i}_b, mixer{i} (a ``MambaVim``
    or a ``MambaDBM``), norm_f_w, norm_f_b, class_embed, span_embed:
    {Conv_{j}}, weightedpool} → the port's ``UniVTGMamba`` state_dict;
    flax Conv kernels (k, in, out) become (out, in, k)."""
    params = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    for proj in ("vid_proj", "txt_proj"):
        for i in range(_numbered(params, proj)):
            tree, key = params[f"{proj}{i}"], f"{proj}.{i}."
            if "LayerNorm_0" in tree:
                _layernorm(tree["LayerNorm_0"], key + "norm.", out)
            _dense(tree["Dense_0"], key + "dense.", out)
    out["token_type.weight"] = _tensor(params["token_type"]["embedding"])
    for i in range(_numbered(params, "mixer")):
        key = f"layers.{i}."
        out[key + "norm_w"] = _tensor(params[f"norm{i}_w"])
        out[key + "norm_b"] = _tensor(params[f"norm{i}_b"])
        mixer = params[f"mixer{i}"]
        convert = (dbm_mixer_from_jax if "shared" in mixer
                   else vim_mixer_from_jax)
        out.update(convert(mixer, key + "mixer."))
    out["norm_f_w"] = _tensor(params["norm_f_w"])
    out["norm_f_b"] = _tensor(params["norm_f_b"])
    for head in ("class_embed", "span_embed"):
        for j in range(_numbered(params[head], "Conv_")):
            _conv1d(params[head][f"Conv_{j}"], f"{head}.convs.{j}.", out)
    out["weightedpool.weight"] = _tensor(params["weightedpool"]["weight"])
    return out


def _box_mlp(tree, prefix, out):
    for name in ("l0", "l1", "l2"):
        _dense(tree[name], f"{prefix}{name}.", out)


def _ffn(tree, prefix, out):
    _dense(tree["linear1"], prefix + "linear1.", out)
    _dense(tree["linear2"], prefix + "linear2.", out)
    _layernorm(tree["norm"], prefix + "norm.", out)


def _query_attention(tree, prefix, out):
    """flax ``MultiHeadDotProductAttention`` {query, key, value: kernel (d,
    H, dh), bias (H, dh); out: kernel (H, dh, d), bias (d,)} → Dense
    weights (H·dh, d) and (d, H·dh), heads major."""
    for name in ("query", "key", "value"):
        kernel = np.asarray(tree[name]["kernel"])
        out[f"{prefix}{name}.weight"] = _tensor(
            kernel.reshape(kernel.shape[0], -1).T)
        out[f"{prefix}{name}.bias"] = _tensor(
            np.asarray(tree[name]["bias"]).reshape(-1))
    kernel = np.asarray(tree["out"]["kernel"])
    out[prefix + "out.weight"] = _tensor(
        kernel.reshape(-1, kernel.shape[-1]).T)
    out[prefix + "out.bias"] = _tensor(tree["out"]["bias"])


def _lstm_cell(tree, prefix, out):
    """flax ``OptimizedLSTMCell`` {ii, if, ig, io: kernel (in, H); hi, hf,
    hg, ho: kernel (H, H), bias} → ``weight_ih`` (4H, in), ``weight_hh``
    (4H, H), ``bias_hh`` (4H,), the gates in the order i, f, g, o."""
    gates = "ifgo"
    out[prefix + "weight_ih"] = _tensor(np.concatenate(
        [np.asarray(tree[f"i{g}"]["kernel"]) for g in gates], axis=1).T)
    out[prefix + "weight_hh"] = _tensor(np.concatenate(
        [np.asarray(tree[f"h{g}"]["kernel"]) for g in gates], axis=1).T)
    out[prefix + "bias_hh"] = _tensor(np.concatenate(
        [np.asarray(tree[f"h{g}"]["bias"]) for g in gates]))


def _leaf_sizes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_leaf_sizes(v) for v in tree.values())
    return int(np.asarray(tree).size)


def pdvc_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``PDVC`` tree {input_proj0, level_conv{l}, transformer:
    {level_embed, enc{i}: {mamba, norm1, ffn}, reference_points, dec{i}:
    {self_attn, norm2, cross_attn, norm1, ffn}, refine{i}}, query_embed,
    class_head, count_head, bbox_head, caption_head?} → the port's
    ``PDVC`` state_dict; the encoder's mixers through
    ``vim_mixer_from_jax`` or ``dbm_mixer_from_jax``. Raises
    ``ValueError`` unless every value of the tree is carried over."""
    params = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    _dense(params["input_proj0"], "input_proj.", out)
    for l in range(_numbered(params, "level_conv")):
        _conv1d(params[f"level_conv{l}"], f"level_convs.{l}.", out)
    tr = params["transformer"]
    out["transformer.level_embed"] = _tensor(tr["level_embed"])
    for i in range(_numbered(tr, "enc")):
        tree, key = tr[f"enc{i}"], f"transformer.enc.{i}."
        mixer = tree["mamba"]
        convert = (dbm_mixer_from_jax if "shared" in mixer
                   else vim_mixer_from_jax)
        out.update(convert(mixer, key + "mamba."))
        _layernorm(tree["norm1"], key + "norm1.", out)
        _ffn(tree["ffn"], key + "ffn.", out)
    _dense(tr["reference_points"], "transformer.reference_points.", out)
    for i in range(_numbered(tr, "dec")):
        tree, key = tr[f"dec{i}"], f"transformer.dec.{i}."
        _query_attention(tree["self_attn"], key + "self_attn.", out)
        for norm in ("norm1", "norm2"):
            _layernorm(tree[norm], f"{key}{norm}.", out)
        for dense in ("value_proj", "sampling_offsets",
                      "attention_weights", "output_proj"):
            _dense(tree["cross_attn"][dense], f"{key}cross_attn.{dense}.",
                   out)
        _ffn(tree["ffn"], key + "ffn.", out)
        _box_mlp(tr[f"refine{i}"], f"transformer.refine.{i}.", out)
    out["query_embed"] = _tensor(params["query_embed"])
    _dense(params["class_head"], "class_head.", out)
    _dense(params["count_head"], "count_head.", out)
    _box_mlp(params["bbox_head"], "bbox_head.", out)
    head = params.get("caption_head")
    if head is not None:
        out["caption_head.word_embed.weight"] = _tensor(
            head["word_embed"]["embedding"])
        _lstm_cell(head["cell"], "caption_head.cell.", out)
        for name, tree in head.items():
            if name not in ("word_embed", "cell"):
                _dense(tree, f"caption_head.{name}.", out)
    carried = sum(t.numel() for t in out.values())
    if carried != _leaf_sizes(params):
        raise ValueError(f"the PDVC tree holds {_leaf_sizes(params)} values, "
                         f"{carried} were carried over")
    return out


# ---------------------------------------------------------------------------
# upstream PyTorch state_dicts → the port's state_dict (the JAX package's
# ``convert_*`` functions, without the detour through a flax tree)


def _get(sd, name: str) -> torch.Tensor:
    return sd[name].detach().float()


def _get_if(sd, name: str, out: Dict[str, torch.Tensor], key: str) -> None:
    if name in sd:
        out[key] = _get(sd, name)


def _prefixed(tree: Dict[str, torch.Tensor], prefix: str
              ) -> Dict[str, torch.Tensor]:
    return {prefix + key: value for key, value in tree.items()}


def patch_weight(w: torch.Tensor) -> torch.Tensor:
    """An upstream patch-embedding conv weight (D, C, p, p) → the port's
    ``PatchifyConv`` weight (D, p·p·C), its taps in (row, col, channel)
    order."""
    return w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)


def _sd_scan(sd, prefix: str, suffix: str, a_log: str, d: str,
             out: Dict[str, torch.Tensor], key: str) -> None:
    """One scan direction of an upstream mixer (``conv1d``, ``x_proj`` and
    ``dt_proj`` with ``suffix``, ``a_log`` and ``d``) → a ``ScanParams``
    bundle under ``key``. The conv taps (d_inner, 1, W) become (W,
    d_inner); the projections keep torch's (out, in)."""
    out[key + "conv_w"] = _get(
        sd, f"{prefix}conv1d{suffix}.weight")[:, 0, :].t().contiguous()
    _get_if(sd, f"{prefix}conv1d{suffix}.bias", out, key + "conv_bias")
    out[key + "x_proj"] = _get(sd, f"{prefix}x_proj{suffix}.weight")
    out[key + "dt_proj"] = _get(sd, f"{prefix}dt_proj{suffix}.weight")
    out[key + "dt_bias"] = _get(sd, f"{prefix}dt_proj{suffix}.bias")
    out[key + "A_log"] = _get(sd, prefix + a_log)
    out[key + "D"] = _get(sd, prefix + d)


def _sd_dense(sd, src: str, out: Dict[str, torch.Tensor], key: str) -> None:
    """A torch ``Linear`` (weight (out, in), optional bias) → a ``Dense``."""
    out[key + "weight"] = _get(sd, src + "weight")
    _get_if(sd, src + "bias", out, key + "bias")


def causal_mixer_from_state_dict(sd: Dict[str, Any], prefix: str = ""
                                 ) -> Dict[str, torch.Tensor]:
    """An upstream causal Mamba mixer's state_dict (``mamba_simple.Mamba``:
    ``in_proj``, ``conv1d`` (d_inner, 1, W), ``x_proj``, ``dt_proj``,
    ``A_log``, ``D``, ``out_proj``; keys under ``prefix``) → the port's
    ``MambaCausal`` state_dict (the JAX ``convert_mamba_mixer``)."""
    out: Dict[str, torch.Tensor] = {}
    _sd_dense(sd, prefix + "in_proj.", out, "in_proj.")
    _sd_scan(sd, prefix, "", "A_log", "D", out, "fwd.")
    _sd_dense(sd, prefix + "out_proj.", out, "out_proj.")
    return out


def vim_mixer_from_state_dict(sd: Dict[str, Any], prefix: str = ""
                              ) -> Dict[str, torch.Tensor]:
    """An upstream ViM mixer's state_dict (bimamba v2: the causal mixer's
    keys and their ``conv1d_b``, ``x_proj_b``, ``dt_proj_b``, ``A_b_log``,
    ``D_b`` mirror; keys under ``prefix``) → the port's ``MambaVim``
    state_dict (the JAX ``convert_vim_mixer``). With a ``norm.weight`` (the
    scan-norm ViM's RMSNorm over d_inner) → the port's ``MambaScanNorm``
    (``convert_scan_norm_mixer``)."""
    out = causal_mixer_from_state_dict(sd, prefix)
    _sd_scan(sd, prefix, "_b", "A_b_log", "D_b", out, "bwd.")
    _get_if(sd, prefix + "norm.weight", out, "scan_norm_w")
    return out


def _sd_layernorm(sd, src: str, out: Dict[str, torch.Tensor], key: str
                  ) -> None:
    out[key + "weight"] = _get(sd, src + "weight")
    _get_if(sd, src + "bias", out, key + "bias")


def _sd_attention(sd, src: str, out: Dict[str, torch.Tensor], key: str
                  ) -> None:
    """A torch ``nn.MultiheadAttention``: ``in_proj_weight`` (3D, D), its
    rows in q; k; v order, is ``FusedMHA``'s fused ``qkv`` weight as it
    stands (the JAX ``convert_attention``)."""
    out[key + "qkv.weight"] = _get(sd, src + "in_proj_weight")
    _get_if(sd, src + "in_proj_bias", out, key + "qkv.bias")
    _sd_dense(sd, src + "out_proj.", out, key + "out.")


def _sd_mlp(sd, src: str, out: Dict[str, torch.Tensor], key: str,
            fc1: str = "fc1", fc2: str = "fc2") -> None:
    _sd_dense(sd, f"{src}{fc1}.", out, key + "fc1.")
    _sd_dense(sd, f"{src}{fc2}.", out, key + "fc2.")


def timemamba_from_state_dict(sd: Dict[str, Any], depth: int,
                              prefix: str = "") -> Dict[str, torch.Tensor]:
    """An upstream TimeMamba tower's state_dict (avion ``timemamba.py``:
    ``patch_embed.proj`` (D, 3, p, p), ``cls_token``, ``pos_embed``,
    optional ``ln_pre``, ``blocks.{i}.{norm1, norm2, norm3, attn
    (nn.MultiheadAttention), mlp, time_mamba (ViM), alpha_timeattn?}``,
    ``norm``, optional ``image_projection``; keys under ``prefix``) → the
    port's ``TimeMamba`` state_dict (the JAX ``convert_timemamba``)."""
    out = {"patch_embed.weight": patch_weight(
               _get(sd, prefix + "patch_embed.proj.weight")),
           "cls_token": _get(sd, prefix + "cls_token"),
           "pos_embed": _get(sd, prefix + "pos_embed")}
    _get_if(sd, prefix + "patch_embed.proj.bias", out, "patch_embed.bias")
    if prefix + "ln_pre.weight" in sd:
        _sd_layernorm(sd, prefix + "ln_pre.", out, "ln_pre.")
    for i in range(depth):
        src, key = f"{prefix}blocks.{i}.", f"blocks.{i}."
        for norm in ("norm1", "norm2", "norm3"):
            _sd_layernorm(sd, f"{src}{norm}.", out, f"{key}{norm}.")
        _sd_attention(sd, src + "attn.", out, key + "attn.")
        _sd_mlp(sd, src + "mlp.", out, key + "mlp.")
        out.update(_prefixed(vim_mixer_from_state_dict(
            sd, src + "time_mamba."), key + "time_mamba."))
        _get_if(sd, src + "alpha_timeattn", out, key + "alpha_timeattn")
    _sd_layernorm(sd, prefix + "norm.", out, "norm.")
    _get_if(sd, prefix + "image_projection", out, "image_projection")
    return out


def vivim_from_state_dict(sd: Dict[str, Any], depth: int, prefix: str = ""
                          ) -> Dict[str, torch.Tensor]:
    """An upstream ViViM / VisionMamba state_dict (``patch_embed.proj``,
    ``cls_token``, ``pos_embed``, ``temporal_embedding`` or
    ``temporal_embed``, ``layers.{i}.{norm, mixer (ViM)}``, ``norm_f``,
    optional ``head`` and ``image_projection``; keys under ``prefix``) →
    the port's ``ViViM`` state_dict (the JAX ``convert_vivim``). The
    temporal embedding becomes (T, 1, D); the norms' biases are taken
    where present (an RMSNorm model has none)."""
    out = {"patch_embed.proj.weight": patch_weight(
               _get(sd, prefix + "patch_embed.proj.weight")),
           "cls_token": _get(sd, prefix + "cls_token"),
           "pos_embed": _get(sd, prefix + "pos_embed")}
    _get_if(sd, prefix + "patch_embed.proj.bias", out,
            "patch_embed.proj.bias")
    for name in ("temporal_embedding", "temporal_embed"):
        if prefix + name in sd:
            te = _get(sd, prefix + name)
            out["temporal_embed"] = te.reshape(te.shape[0], 1, te.shape[-1])
            break
    for i in range(depth):
        src, key = f"{prefix}layers.{i}.", f"layers.{i}."
        out[key + "norm_w"] = _get(sd, src + "norm.weight")
        _get_if(sd, src + "norm.bias", out, key + "norm_b")
        out.update(_prefixed(vim_mixer_from_state_dict(sd, src + "mixer."),
                             key + "mixer."))
    out["norm_f_w"] = _get(sd, prefix + "norm_f.weight")
    _get_if(sd, prefix + "norm_f.bias", out, "norm_f_b")
    if prefix + "head.weight" in sd:
        out["head.weight"] = _get(sd, prefix + "head.weight")
        out["head.bias"] = _get(sd, prefix + "head.bias")
    _get_if(sd, prefix + "image_projection", out, "image_projection")
    return out


def _sd_resblocks(sd, prefix: str, layers: int,
                  out: Dict[str, torch.Tensor]) -> None:
    """open_clip's ``transformer.resblocks.{i}`` (``ln_1``, ``attn``,
    ``ln_2``, ``mlp.c_fc``, ``mlp.c_proj``) → ``resblocks.{i}``."""
    for i in range(layers):
        src, key = f"{prefix}transformer.resblocks.{i}.", f"resblocks.{i}."
        for norm in ("ln_1", "ln_2"):
            _sd_layernorm(sd, f"{src}{norm}.", out, f"{key}{norm}.")
        _sd_attention(sd, src + "attn.", out, key + "attn.")
        _sd_mlp(sd, src + "mlp.", out, key + "mlp.", "c_fc", "c_proj")


def text_transformer_from_state_dict(sd: Dict[str, Any], layers: int,
                                     prefix: str = "textual."
                                     ) -> Dict[str, torch.Tensor]:
    """An upstream CLIP text tower's state_dict (open_clip layout under
    ``prefix``: ``token_embedding``, ``positional_embedding``,
    ``transformer.resblocks.{i}``, ``ln_final``, optional
    ``text_projection``) → the port's ``TextTransformer`` state_dict (the
    JAX ``convert_text_transformer``)."""
    out = {"token_embedding.weight": _get(
               sd, prefix + "token_embedding.weight"),
           "positional_embedding": _get(sd, prefix + "positional_embedding")}
    _sd_resblocks(sd, prefix, layers, out)
    _sd_layernorm(sd, prefix + "ln_final.", out, "ln_final.")
    _get_if(sd, prefix + "text_projection", out, "text_projection")
    return out


def clip_image_tower_from_state_dict(sd: Dict[str, Any], layers: int,
                                     prefix: str = "visual."
                                     ) -> Dict[str, torch.Tensor]:
    """A published CLIP ViT image encoder's state_dict (open_clip / clip
    layout under ``prefix``: ``conv1`` (D, 3, p, p), ``class_embedding``,
    ``positional_embedding``, ``ln_pre``, ``transformer.resblocks.{i}``,
    ``ln_post``, optional ``proj``) → the port's ``ClipImageTower``
    state_dict (the JAX ``convert_clip_image_tower``)."""
    out = {"conv1.weight": patch_weight(_get(sd, prefix + "conv1.weight")),
           "class_embedding": _get(sd, prefix + "class_embedding"),
           "positional_embedding": _get(sd, prefix + "positional_embedding")}
    for norm in ("ln_pre", "ln_post"):
        _sd_layernorm(sd, f"{prefix}{norm}.", out, f"{norm}.")
    _sd_resblocks(sd, prefix, layers, out)
    _get_if(sd, prefix + "proj", out, "proj")
    return out


def clip_from_state_dict(sd: Dict[str, Any], vision: str, vision_depth: int,
                         text_layers: int) -> Dict[str, torch.Tensor]:
    """An upstream avion CLIP state_dict (``visual.`` a TimeMamba or a
    ViViM tower, ``vision`` "timemamba" or "vivim", with its
    ``image_projection``; ``textual.`` the text tower; ``logit_scale``) →
    the port's ``CLIP`` state_dict (the JAX ``convert_clip``), the scale a
    0-d tensor."""
    if vision == "timemamba":
        visual = timemamba_from_state_dict(sd, vision_depth, "visual.")
    elif vision == "vivim":
        visual = vivim_from_state_dict(sd, vision_depth, "visual.")
    else:
        raise ValueError(f"unknown vision tower {vision!r}")
    out = _prefixed(visual, "visual.")
    out.update(_prefixed(text_transformer_from_state_dict(sd, text_layers),
                         "textual."))
    out["logit_scale"] = _get(sd, "logit_scale").reshape(())
    return out


def _interp_rows(x: torch.Tensor, new_len: int) -> torch.Tensor:
    """Linear interpolation along dim 0 in float64 (torch's bilinear
    ``F.interpolate`` of a (1, 1, T, D) image with align_corners=False
    reduces to this); x itself where the length does not change."""
    old_len = x.shape[0]
    if old_len == new_len:
        return x
    pos = (torch.arange(new_len, dtype=torch.float64) + 0.5) * old_len \
        / new_len - 0.5
    pos = pos.clamp(0, old_len - 1)
    lo = pos.floor().long()
    hi = (lo + 1).clamp(max=old_len - 1)
    w = (pos - lo)[:, None]
    x = x.double()
    return (1 - w) * x[lo] + w * x[hi]


def inflate_temporal_embed(embed: torch.Tensor, num_frames: int,
                           mode: str = "bilinear") -> torch.Tensor:
    """A temporal embedding (T, 1, D) or (T, D) for ``num_frames`` frames
    (the JAX ``inflate_temporal_embed``): cut when it has more rows; with
    fewer, padded with zeros (``mode`` "zeros") or interpolated ("interp",
    "bilinear") in float64 and cast back to its dtype."""
    squeeze = embed.dim() == 3
    e = embed[:, 0] if squeeze else embed
    t_old, d = e.shape
    if t_old >= num_frames:
        out = e[:num_frames]
    elif mode == "zeros":
        out = torch.cat([e, e.new_zeros(num_frames - t_old, d)])
    elif mode in ("interp", "bilinear"):
        out = _interp_rows(e, num_frames).to(e.dtype)
    else:
        raise NotImplementedError(mode)
    return out[:, None] if squeeze else out


def inflate_pos_embed(pos: torch.Tensor, new_num_patches: int
                      ) -> torch.Tensor:
    """A positional embedding (1, 1 + n, D) over a square grid of n patches
    resized to ``new_num_patches`` (a square too, else ValueError): the
    class slot kept, the grid resized bilinearly along rows, then columns,
    in float64 and cast back to the input's dtype (the JAX
    ``inflate_pos_embed`` returns the float64 result)."""
    cls_tok, grid = pos[:, :1], pos[0, 1:]
    n_old, d = grid.shape
    side_old = int(round(n_old ** 0.5))
    side_new = int(round(new_num_patches ** 0.5))
    if side_old * side_old != n_old or side_new * side_new != new_num_patches:
        raise ValueError("pos-embed inflation needs square grids")
    if side_old == side_new:
        return pos
    g = _interp_rows(grid.reshape(side_old, side_old * d), side_new)
    g = g.reshape(side_new, side_old, d).permute(1, 0, 2)
    g = _interp_rows(g.reshape(side_old, side_new * d), side_new)
    g = g.reshape(side_new, side_new, d).permute(1, 0, 2)
    return torch.cat([cls_tok.double(), g.reshape(1, -1, d)],
                     dim=1).to(pos.dtype)
