"""Carry LanguageModel weights between the JAX package and the port.

The JAX side hands over its parameter pytree as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``); the port never sees JAX.  The port
keeps the JAX tree exactly, scanned segments' leading ``layers`` axis
(``transformer.py:243-248``) included, so the conversion is leaf for leaf:
every key of the JAX tree must be one the port expects, with the shape it
expects, and every key the port expects must be present.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import LanguageModel


def params_from_numpy(tree: dict, cfg: ModelConfig,
                      device: torch.device | str = "cuda") -> dict:
    """The port's parameters for ``cfg`` from a JAX parameter tree of numpy
    arrays; raises on a missing, extra or mis-shaped leaf."""
    expected = LanguageModel(cfg, device="meta").param_shapes()

    def walk(node: Any, exp: Any, path: str) -> Any:
        if isinstance(exp, dict):
            if not isinstance(node, dict) or set(node) != set(exp):
                got = sorted(node) if isinstance(node, dict) else type(node)
                raise KeyError(f"{path or '/'}: keys {got} != {sorted(exp)}")
            return {k: walk(node[k], exp[k], f"{path}/{k}") for k in exp}
        if tuple(np.shape(node)) != exp:
            raise ValueError(f"{path}: shape {np.shape(node)} != {exp}")
        return torch.from_numpy(np.array(node, copy=True)).to(device)

    return walk(tree, expected, "")


def params_to_numpy(params: dict) -> dict:
    """Inverse of ``params_from_numpy``: nested dicts of numpy arrays."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return params.detach().cpu().numpy()
