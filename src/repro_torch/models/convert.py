"""The reference's parameter tree → the port's parameters.

``from_jax_params(tree)`` takes the tree ``repro.models.transformer
.init_params`` builds, as NumPy arrays (e.g. ``jax.device_get(params)``):
top-level leaves (``embed``, ``final_norm``, ``lm_head``, ``frontend``)
and ``groups[g][slot]``, each leaf stacked on a leading ``n_repeat`` axis.
It returns a ``state_dict`` for ``transformer.Transformer`` of the same
config: the groups unrolled into ``layers.<i>.<slot>.<leaf>`` in layer
order, every tensor f32 on the CPU with the reference's layout.  Neither
``jax`` nor ``repro`` is imported.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix: str, out: dict, index=None) -> None:
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            _flatten(leaf, f"{prefix}{name}.", out, index)
        else:
            a = np.asarray(leaf)
            if index is not None:
                a = a[index]
            out[prefix + name] = torch.from_numpy(np.array(a, dtype=np.float32))


def _n_repeat(group: dict) -> int:
    leaf = group
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return np.asarray(leaf).shape[0]


def from_jax_params(tree: dict) -> dict[str, torch.Tensor]:
    out: dict[str, torch.Tensor] = {}
    _flatten({k: v for k, v in tree.items() if k != "groups"}, "", out)
    layer = 0
    for group in tree["groups"]:
        for r in range(_n_repeat(group)):
            _flatten(group, f"layers.{layer}.", out, index=r)
            layer += 1
    return out
