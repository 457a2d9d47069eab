"""JAX parameter trees → the port's ``state_dict``.

Takes the JAX package's flax parameter tree as numpy arrays (the mapping
its ``models/convert.py`` builds from upstream checkpoints, read in
reverse) and returns tensors keyed by the port's parameter names. Dense
kernels go from flax's (in, out) to torch's (out, in).
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
