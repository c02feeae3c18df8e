"""Shapes of a configuration file, and its weights drawn from the seed.

:func:`shape` reads the published keys of a configuration file (the
names of its ``config.json``) into the sizes the benchmark computes with;
:func:`port_config` turns them into the port's ``ModelConfig`` (its
registered preset with the file's sizes and recipe), and refuses a
preset whose widths differ from the file's.  :func:`make_params` draws
the weights on the device from the seed, in the port's param-tree
layout and the dtypes it serves them in; the plain reference draws the
same tensors again from the same seed.
"""
from __future__ import annotations

import dataclasses

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class Shape:
    vocab: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    layers: int
    dense_layers: int
    d_ff_dense: int
    experts: int
    top_k: int
    d_ff_expert: int
    d_ff_shared: int
    norm_topk: bool
    qkv_bias: bool
    rope_theta: float
    eps: float
    dtype: torch.dtype
    aux_weight: float = 0.01

    @property
    def moe_layers(self) -> int:
        return self.layers - self.dense_layers


def shape(c: dict) -> Shape:
    d, h = c["hidden_size"], c["num_attention_heads"]
    f = c["moe_intermediate_size"]
    if "n_shared_experts" in c:
        fs = c["n_shared_experts"] * f
    else:
        fs = c.get("shared_expert_intermediate_size", 0)
    return Shape(
        vocab=c["vocab_size"], d=d, heads=h,
        kv_heads=c["num_key_value_heads"],
        head_dim=c.get("head_dim", d // h),
        layers=c["num_hidden_layers"],
        dense_layers=c.get("first_k_dense_replace", 0),
        d_ff_dense=c["intermediate_size"],
        experts=c.get("n_routed_experts", c.get("num_experts")),
        top_k=c["num_experts_per_tok"], d_ff_expert=f, d_ff_shared=fs,
        norm_topk=c["norm_topk_prob"],
        qkv_bias=c.get("attention_bias", c.get("qkv_bias",
                                               "qkv_bias" in c["assumed"])),
        rope_theta=c["rope_theta"], eps=c["rms_norm_eps"],
        dtype=DTYPES[c["recipe"]["dtype"]])


def port_config(c: dict):
    """The port's ``ModelConfig`` for configuration file ``c``: its
    ``port_preset`` (``smoke:<arch>``: the port's reduced CPU preset)."""
    from repro_torch.configs import get_config, smoke_config
    s = shape(c)
    preset = c["port_preset"]
    base = smoke_config(preset[6:]) if preset.startswith("smoke:") \
        else get_config(preset)
    m = base.moe
    if m.d_ff_expert and s.d_ff_shared % m.d_ff_expert:
        raise ValueError("the shared width is no multiple of the experts'")
    want = dict(d_model=s.d, num_heads=s.heads, num_kv_heads=s.kv_heads,
                head_dim=s.head_dim, vocab_size=s.vocab,
                rope_theta=s.rope_theta, norm_eps=s.eps,
                qkv_bias=s.qkv_bias, tie_embeddings=c["tie_word_embeddings"])
    moe = dict(num_experts=s.experts, top_k=s.top_k,
               d_ff_expert=s.d_ff_expert,
               num_shared_experts=s.d_ff_shared // s.d_ff_expert,
               norm_topk_prob=s.norm_topk, first_dense_layers=s.dense_layers)
    bad = [k for k, v in want.items() if getattr(base, k) != v]
    bad += [k for k, v in moe.items() if getattr(m, k) != v]
    if s.dense_layers and base.d_ff != s.d_ff_dense:
        bad.append("d_ff")
    if bad:
        raise ValueError(f"the port's preset {c['port_preset']} differs from "
                         f"{c['source']} in {bad}")
    r = c["recipe"]
    return dataclasses.replace(
        base, num_layers=s.layers, precision=r["precision"],
        dtype=DTYPES[r["dtype"]], attn_backend=r["attn_backend"],
        remat=r["remat"], moe_dispatch=r["moe_dispatch"])


def leaf_specs(s: Shape) -> list:
    """``(path, shape, dtype, kind)`` of every weight, in a fixed order;
    kind ``"matrix"`` (scale 1/sqrt(fan in), the second-to-last dim),
    ``"bias"`` or ``"norm"``."""
    f32, dt = torch.float32, s.dtype
    hq, hkv = s.heads * s.head_dim, s.kv_heads * s.head_dim
    out = [("embed/embedding", (s.vocab, s.d), dt, "embedding"),
           ("embed/lm_head", (s.d, s.vocab), dt, "matrix"),
           ("final_norm/scale", (s.d,), f32, "norm")]
    for i in range(s.layers):
        p = f"layers/{i}/"
        out += [(p + "ln1/scale", (s.d,), f32, "norm"),
                (p + "ln2/scale", (s.d,), f32, "norm"),
                (p + "attn/wq", (s.d, hq), dt, "matrix"),
                (p + "attn/wk", (s.d, hkv), dt, "matrix"),
                (p + "attn/wv", (s.d, hkv), dt, "matrix"),
                (p + "attn/wo", (hq, s.d), dt, "matrix")]
        if s.qkv_bias:
            out += [(p + "attn/bq", (hq,), dt, "bias"),
                    (p + "attn/bk", (hkv,), dt, "bias"),
                    (p + "attn/bv", (hkv,), dt, "bias")]
        if i < s.dense_layers:
            f = s.d_ff_dense
            out += [(p + "mlp/w_gate", (s.d, f), dt, "matrix"),
                    (p + "mlp/w_up", (s.d, f), dt, "matrix"),
                    (p + "mlp/w_down", (f, s.d), dt, "matrix")]
            continue
        e, f, fs = s.experts, s.d_ff_expert, s.d_ff_shared
        out += [(p + "moe/router", (s.d, e), f32, "matrix"),
                (p + "moe/w_gate", (e, s.d, f), dt, "matrix"),
                (p + "moe/w_up", (e, s.d, f), dt, "matrix"),
                (p + "moe/w_down", (e, f, s.d), dt, "matrix")]
        if fs:
            out += [(p + "moe/shared_gate", (s.d, fs), dt, "matrix"),
                    (p + "moe/shared_up", (s.d, fs), dt, "matrix"),
                    (p + "moe/shared_down", (fs, s.d), dt, "matrix")]
    return out


def leaf_seed(seed: int, index: int) -> int:
    """The generator seed of weight ``index`` of run ``seed``."""
    return (int(seed) * 1_000_003 + 7919 * (index + 1)) % (2 ** 63 - 1)


def make_leaf(spec, index: int, seed: int, device) -> torch.Tensor:
    path, shp, dtype, kind = spec
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, index))
    x = torch.randn(shp, generator=gen, device=device, dtype=dtype)
    if kind == "matrix":
        return x.mul_(shp[-2] ** -0.5)
    if kind == "embedding":
        return x.mul_(shp[-1] ** -0.5)
    if kind == "bias":
        return x.mul_(0.02)
    return x.mul_(0.05).add_(1.0)


def make_params(s: Shape, seed: int, device, *, f32: bool = False,
                keep=None) -> dict:
    """The param tree (nested dicts, ``layers`` a list) drawn from
    ``seed`` on ``device``: one generator and one draw a weight
    (``f32``: each upcast to float32 as it is drawn, for the reference;
    ``keep``: a test of the path, the weights drawn)."""
    tree: dict = {"layers": [{} for _ in range(s.layers)]}
    for i, spec in enumerate(leaf_specs(s)):
        if keep is not None and not keep(spec[0]):
            continue
        parts = spec[0].split("/")
        node = tree
        if parts[0] == "layers":
            node, parts = tree["layers"][int(parts[1])], parts[2:]
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        leaf = make_leaf(spec, i, seed, device)
        node[parts[-1]] = leaf.float() if f32 else leaf
    return tree


def change_norms(tree, s: Shape, seed: int, device) -> list:
    """Each leaf's L2 distance from the weight :func:`make_params` drew
    for it from ``seed`` (drawn again, one leaf at a time), in
    :func:`leaf_paths` order."""
    specs = leaf_specs(s)
    index = {spec[0]: i for i, spec in enumerate(specs)}
    out = []
    for path, x in leaf_paths(tree):
        i = index[path]
        w0 = make_leaf(specs[i], i, seed, device).float()
        out.append(float(torch.linalg.vector_norm(x.float() - w0)))
    return out


def leaf_paths(tree, prefix: str = "") -> list:
    """``(path, tensor)`` of every leaf, dict keys sorted (the port's
    order of its optimizer state)."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in leaf_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [pl for i, v in enumerate(tree)
                for pl in leaf_paths(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]
