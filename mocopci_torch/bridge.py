"""Carry the JAX package's flax variables over to the port's ``state_dict``.

``params_from_jax`` takes the flax ``{"params", "batch_stats"}`` tree as
nested dicts of numpy arrays (no flax needed) and returns a ``state_dict``
for ``MoCoPCI`` or any of its submodules, whose names follow the flax tree:

  - Dense ``kernel (in, out)`` -> ``weight (out, in)``;
  - LayerNorm / BatchNorm ``scale`` -> ``weight``, ``bias`` -> ``bias``;
  - ``batch_stats`` ``mean`` / ``var`` -> ``running_mean`` / ``running_var``;
  - PReLU ``alpha``, MlpT ``dw_scale`` / ``dw_bias`` and Injector ``gamma``
    one to one.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_PARAM_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias",
                "alpha": "alpha", "gamma": "gamma",
                "dw_scale": "dw_scale", "dw_bias": "dw_bias"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _walk(tree: Mapping, prefix=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _walk(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def params_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax variables (nested numpy dicts) -> torch ``state_dict``."""
    state = {}
    for collection, names in (("params", _PARAM_NAMES), ("batch_stats", _STAT_NAMES)):
        for path, leaf in _walk(variables.get(collection, {})):
            if path[-1] not in names:
                raise KeyError(f"no mapping for {collection}/{'/'.join(path)}")
            arr = np.asarray(leaf, np.float32)
            if path[-1] == "kernel":
                arr = arr.T
            key = ".".join(path[:-1] + (names[path[-1]],))
            state[key] = torch.from_numpy(np.array(arr, order="C"))  # keeps 0-d leaves 0-d
    return state
