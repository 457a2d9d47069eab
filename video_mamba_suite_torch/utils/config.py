"""One config type for every task (the port's copy of the JAX package's
``utils/config.py``): a dict with attribute access, deep merge, dotted-key
overrides and JSON or YAML loading.

The reference uses yaml over deep defaults (TAL libs/core/config.py),
yacs (anticipation config/defaults.py), argparse (VTG main/config.py) and
yml + argparse (dense captioning opts.py); this one type stands for all
four.
"""

from __future__ import annotations

import copy
import json
from typing import Any, Dict, Mapping, Optional


class Config(dict):
    """Dict with attribute access and recursive wrapping."""

    def __init__(self, data: Optional[Mapping[str, Any]] = None, **kw):
        super().__init__()
        data = dict(data or {})
        data.update(kw)
        for k, v in data.items():
            self[k] = self._wrap(v)

    @staticmethod
    def _wrap(v):
        if isinstance(v, Mapping) and not isinstance(v, Config):
            return Config(v)
        if isinstance(v, list):
            return [Config._wrap(x) for x in v]
        return v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = self._wrap(v)

    def merged(self, other: Mapping[str, Any]) -> "Config":
        """Deep merge: ``other`` wins (the TAL ``_merge`` semantics,
        libs/core/config.py:135-148)."""
        out = copy.deepcopy(self)

        def rec(dst, src):
            for k, v in src.items():
                if (k in dst and isinstance(dst[k], Mapping)
                        and isinstance(v, Mapping)):
                    rec(dst[k], v)
                else:
                    dst[k] = Config._wrap(v)

        rec(out, other)
        return out

    def override(self, dotted: Dict[str, Any]) -> "Config":
        """Apply {'a.b.c': v} style overrides."""
        out = copy.deepcopy(self)
        for key, v in dotted.items():
            node = out
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    node[p] = Config()
                node = node[p]
            node[parts[-1]] = Config._wrap(v)
        return out

    def to_dict(self) -> dict:
        def rec(v):
            if isinstance(v, Config):
                return {k: rec(x) for k, x in v.items()}
            if isinstance(v, list):
                return [rec(x) for x in v]
            return v

        return rec(self)

    def dumps(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str)


def load_config(path: str,
                defaults: Optional[Mapping[str, Any]] = None) -> Config:
    """Load ``path`` over ``defaults`` with a deep merge. A ``.yaml`` or
    ``.yml`` file needs PyYAML (an ``ImportError`` without it); any other
    file is read as JSON."""
    with open(path) as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        try:
            import yaml
        except ImportError as e:
            raise ImportError(f"reading {path} needs PyYAML; give the "
                              f"config as JSON instead") from e
        data = yaml.safe_load(text)
    else:
        data = json.loads(text)
    return Config(defaults or {}).merged(data or {})
