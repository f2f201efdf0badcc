"""The reference's parameter tree → the port's parameters.

``from_jax_params(tree)`` takes the tree the reference's ``init_params``
builds, as NumPy arrays (e.g. ``jax.device_get(params)``): top-level
leaves (``embed``, ``final_norm``, ``lm_head``, ``enc_norm``,
``frontend``) and groups of stacked layers, each leaf on a leading
``n_repeat`` axis — ``groups[g][slot]`` for a decoder-only model
(``repro.models.transformer``), ``enc_groups`` and ``dec_groups`` for an
encoder-decoder one (``repro.models.encdec``).  It returns a
``state_dict`` for the port's ``transformer.Transformer`` or
``encdec.EncDec`` of the same config: the groups unrolled in layer order
into ``layers.<i>.<slot>.<leaf>`` (``dec_groups`` too) and
``enc_layers.<i>.<slot>.<leaf>``, every tensor f32 on the CPU with the
reference's layout.  Neither ``jax`` nor ``repro`` is imported.
"""

from __future__ import annotations

import numpy as np
import torch

# the reference's stacked groups -> the port's unrolled layer lists
GROUPS = {"groups": "layers", "dec_groups": "layers", "enc_groups": "enc_layers"}


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
    _flatten({k: v for k, v in tree.items() if k not in GROUPS}, "", out)
    for key, name in GROUPS.items():
        layer = 0
        for group in tree.get(key, ()):
            for r in range(_n_repeat(group)):
                _flatten(group, f"{name}.{layer}.", out, index=r)
                layer += 1
    return out
