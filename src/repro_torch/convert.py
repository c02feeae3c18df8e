"""Parameters and AdamW state of the JAX package -> the port's.

The JAX package's param tree comes in as numpy arrays (for example
``jax.tree.map(np.asarray, params)``), so the two packages compute the
same function on the same weights.  bf16 arrays cross through f32, which
is exact; fp8 arrays cross as a ``uint8`` view.  The unstacked
``pre{i}`` blocks (the dense first layers of an MoE model), then the
stacked ``params["layers"]`` (a leading layer axis, one ``"b0"`` block
per layer for the ``("attn",)`` pattern), become one list of per-layer
dicts.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    a = np.asarray(a)
    name = a.dtype.name
    if name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16) \
            .to(device)
    if name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()) \
            .view(torch.float8_e4m3fn).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def tree_from_numpy(tree, device="cpu"):
    """Nested dicts of numpy arrays -> the same nesting of tensors."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def params_from_jax(np_tree, cfg: ModelConfig, device="cpu"):
    """The JAX decoder's param tree (numpy leaves) -> the port's."""
    if tuple(cfg.block_pattern) != ("attn",):
        raise NotImplementedError("only the ('attn',) block pattern is ported")
    out = {"embed": tree_from_numpy(np_tree["embed"], device),
           "final_norm": tree_from_numpy(np_tree["final_norm"], device)}
    n_pre = cfg.moe.first_dense_layers if cfg.moe is not None else 0
    stacked = np_tree["layers"]["b0"]
    n = np.asarray(stacked["ln1"]["scale"]).shape[0]
    if n_pre + n != cfg.num_layers:
        raise ValueError(f"the tree holds {n_pre} + {n} layers, the config "
                         f"{cfg.num_layers}")
    out["layers"] = [tree_from_numpy(np_tree[f"pre{i}"], device)
                     for i in range(n_pre)]
    out["layers"] += [tree_from_numpy(_index(stacked, i), device)
                      for i in range(n)]
    return out


def opt_state_from_jax(np_state, cfg: ModelConfig, device="cpu"):
    """The JAX package's AdamW state (numpy leaves: param-shaped ``m``,
    ``v`` and optional ``master`` / ``ef`` trees, a scalar ``step``) ->
    the port's, so both packages train on from identical state."""
    out = {k: params_from_jax(v, cfg, device) for k, v in np_state.items()
           if k != "step"}
    out["step"] = torch.tensor(int(np.asarray(np_state["step"])),
                               dtype=torch.int32, device=device)
    return out
