"""Parameters and AdamW state of the JAX package -> the port's.

The JAX package's param tree comes in as numpy arrays (for example
``jax.tree.map(np.asarray, params)``), so the two packages compute the
same function on the same weights.  bf16 arrays cross through f32, which
is exact; fp8 arrays cross as a ``uint8`` view; f32 leaves stay f32.
The layer layouts, each becoming the port's one flat list of per-layer
dicts in the JAX package's order (``transformer.layer_kinds``):
  - a decoder: the unstacked ``pre{i}`` blocks (an MoE model's dense
    first layers), then the stacked cycles ``params["layers"]`` (a
    leading cycle axis, one ``"b{i}"`` block per entry of the block
    pattern; cycle ``c``'s ``b{i}`` is layer ``n_pre + c * p + i``), then
    the unstacked ``tail{i}`` blocks; a VLM's ``vision_proj`` alongside;
  - whisper: the stacked ``enc_layers`` and ``layers`` (a leading layer
    axis, no ``"b"`` keys) and ``enc_final_norm``.
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


def _unstack(tree) -> list:
    """A stacked tree (a leading axis on every leaf) -> a list of trees."""
    leaf = tree
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return [_index(tree, i) for i in range(np.asarray(leaf).shape[0])]


def params_from_jax(np_tree, cfg: ModelConfig, device="cpu"):
    """The JAX package's param tree (numpy leaves) of ``cfg``'s model ->
    the port's."""
    from repro_torch.models.transformer import layer_kinds

    def conv(t):
        return tree_from_numpy(t, device)
    out = {k: conv(np_tree[k]) for k in ("embed", "final_norm",
                                         "enc_final_norm", "vision_proj")
           if k in np_tree}
    if cfg.family == "audio":
        out["enc_layers"] = [conv(t) for t in
                             _unstack(np_tree["enc_layers"])]
        out["layers"] = [conv(t) for t in _unstack(np_tree["layers"])]
        return out
    pattern = tuple(cfg.block_pattern) or ("attn",)
    n_pre = cfg.moe.first_dense_layers if cfg.moe is not None else 0
    cycles = [] if "layers" not in np_tree else [
        list(c) for c in zip(*(_unstack(np_tree["layers"][f"b{i}"])
                               for i in range(len(pattern))))]
    n_tail = (cfg.num_layers - n_pre) % len(pattern)
    layers = [np_tree[f"pre{i}"] for i in range(n_pre)]
    layers += [blk for c in cycles for blk in c]
    layers += [np_tree[f"tail{i}"] for i in range(n_tail)]
    if len(layers) != len(layer_kinds(cfg)):
        raise ValueError(f"the tree holds {len(layers)} layers, the config "
                         f"{cfg.num_layers}")
    out["layers"] = [conv(t) for t in layers]
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
