"""Loading an upstream ``state-spaces/mamba-*`` checkpoint into the port's
``MambaLMHeadModel`` (counterpart of the JAX package's ``models/hf.py``
``from_pretrained`` with ``models/convert.py`` ``convert_mamba_lm``), and
an upstream DBM mixer's state_dict into a ``MambaDBM``
(``convert_dbm_mixer``). ``load_state_dict`` reads any upstream checkpoint
file (the JAX ``load_torch_checkpoint``); ``models/convert.py``'s
``*_from_state_dict`` carry the towers' state dicts over.

Only local files are read: a directory holding ``config.json`` and
``pytorch_model.bin`` (or ``model.pt`` / ``checkpoint.pt``), or a bare
checkpoint file with its config passed as a dict. The hub route is not
ported (no network); a name that is not a local path raises
``FileNotFoundError``, as the JAX loader does offline.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
from typing import Any, Dict, Optional

import torch

from .common import resolve_device
from .convert import causal_mixer_from_state_dict
from .mixer_seq import MambaLMHeadModel, build_mamba_lm

_CONFIG_NAME = "config.json"
_WEIGHTS_NAMES = ("pytorch_model.bin", "model.pt", "checkpoint.pt")
# classes a weights-only load accepts beside tensors and containers: the
# ``argparse.Namespace`` that training scripts save next to the weights
SAFE_GLOBALS = (argparse.Namespace,)


def load_config(path: str) -> Dict[str, Any]:
    """``config.json`` of a local checkpoint directory."""
    name = os.path.join(path, _CONFIG_NAME)
    if not os.path.isfile(name):
        raise FileNotFoundError(f"no {_CONFIG_NAME} for {path!r} (only "
                                "local directories are read)")
    with open(name) as f:
        return json.load(f)


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The state_dict of a checkpoint file, or of the first weights file
    in a local directory, loaded on the CPU (unwrapped from a
    ``state_dict``, ``model`` or ``module`` entry), as the JAX
    ``load_torch_checkpoint`` loads it.

    The load is ``weights_only=True`` with ``SAFE_GLOBALS`` allowed, so a
    file that keeps its training ``argparse.Namespace`` beside the weights
    loads; a file holding any other class raises ``UnpicklingError``
    naming it (the JAX loader unpickles anything)."""
    if os.path.isdir(path):
        found = [os.path.join(path, n) for n in _WEIGHTS_NAMES
                 if os.path.isfile(os.path.join(path, n))]
        if not found:
            raise FileNotFoundError(f"no weights file for {path!r}")
        path = found[0]
    elif not os.path.isfile(path):
        raise FileNotFoundError(f"{path!r} is not a local file or "
                                "directory (the hub is not read)")
    try:
        with torch.serialization.safe_globals(list(SAFE_GLOBALS)):
            ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as err:
        allowed = {f"{c.__module__}.{c.__qualname__}" for c in SAFE_GLOBALS}
        refused = [name for name in
                   torch.serialization.get_unsafe_globals_in_checkpoint(path)
                   if name not in allowed]
        raise pickle.UnpicklingError(
            f"{path!r} holds classes a weights-only load refuses: "
            f"{', '.join(refused) or err}") from err
    for key in ("state_dict", "model", "module"):
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
    return ckpt


def mamba_lm_from_state_dict(sd: Dict[str, torch.Tensor], n_layer: int
                             ) -> Dict[str, torch.Tensor]:
    """An upstream ``MambaLMHeadModel`` state_dict
    (``backbone.layers.{i}.mixer.conv1d.weight`` (d_inner, 1, W), ...) →
    the port's state_dict. Linear weights keep torch's (out, in) layout;
    the conv taps become (W, d_inner); ``lm_head.weight`` is tied to the
    embedding and dropped."""
    def get(name):
        return sd[name].detach().float()

    out = {"backbone.embedding.weight": get("backbone.embedding.weight"),
           "backbone.norm_f_w": get("backbone.norm_f.weight")}
    if "backbone.norm_f.bias" in sd:
        out["backbone.norm_f_b"] = get("backbone.norm_f.bias")
    for i in range(n_layer):
        layer = f"backbone.layers.{i}."
        out[layer + "norm_w"] = get(layer + "norm.weight")
        if layer + "norm.bias" in sd:
            out[layer + "norm_b"] = get(layer + "norm.bias")
        for key, value in causal_mixer_from_state_dict(
                sd, layer + "mixer.").items():
            out[layer + "mixer." + key] = value
    return out


def dbm_mixer_from_state_dict(sd: Dict[str, torch.Tensor],
                              prefix: str = "") -> Dict[str, torch.Tensor]:
    """An upstream DBM mixer's state_dict (the suite's ``mamba_new.Mamba``:
    ``in_proj.weight`` (4·d_inner, d_model), one ``conv1d`` (d_inner, 1,
    W), ``x_proj``, ``dt_proj``, ``A_log`` and ``D`` shared by both
    directions, ``out_proj.weight`` (d_model, 2·d_inner); keys under
    ``prefix``) → the port's ``MambaDBM`` state_dict (the JAX
    ``convert_dbm_mixer``): the causal mixer's keys, its one scan bundle
    named ``shared``."""
    return {("shared." + key[4:] if key.startswith("fwd.") else key): value
            for key, value in causal_mixer_from_state_dict(sd,
                                                           prefix).items()}


def from_pretrained(path: str, config: Optional[Dict[str, Any]] = None,
                    device="cuda") -> MambaLMHeadModel:
    """The port's ``MambaLMHeadModel`` with an upstream checkpoint's
    weights, in fp32 on ``device`` (CUDA unless the caller asks for the
    CPU); ``.to(torch.bfloat16)`` casts it for bf16 serving.

    ``path`` is a local directory (``config.json`` and a weights file) or
    a checkpoint file; ``config`` replaces config.json (needed for a bare
    file). Its keys are the JAX loader's: ``d_model`` or ``hidden_size``,
    ``n_layer`` or ``num_hidden_layers``, ``vocab_size``, ``ssm_cfg``,
    ``rms_norm``, ``pad_vocab_size_multiple``.
    """
    device = resolve_device(device)
    cfg = dict(config) if config is not None else load_config(path)
    model = build_mamba_lm(cfg, device="cpu")
    sd = mamba_lm_from_state_dict(load_state_dict(path), model.n_layer)
    model.load_state_dict(sd)
    return model.to(device)
