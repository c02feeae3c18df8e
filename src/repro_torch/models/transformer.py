"""Generic decoder LM over the JAX package's families (dense, MoE, ssm,
hybrid, vlm): the config's ``block_pattern`` cycled over the layers.

The layer order is the JAX package's ``_layout``: the ``pre{i}`` blocks
(an MoE model's dense first layers), then ``cycles`` x ``block_pattern``,
then the ``tail{i}`` remainder of the pattern.  The JAX package scans
over stacked cycles; here ``params["layers"]`` is one flat list of
per-layer dicts in that order (:func:`layer_kinds` names each layer's
kind) and the scan is a Python loop.  Kinds: ``"attn"`` (attention, then
MoE or a dense SwiGLU MLP), ``"rglru"`` (the RG-LRU block, then a SwiGLU
MLP), ``"mlstm"`` and ``"slstm"`` (the xLSTM blocks); any other raises
``ValueError``, as in the JAX package.  A VLM (``family="vlm"``)
projects ``patch_embeds`` by ``vision_proj`` and prepends them to the
token embeddings.  Modes: "train" (differentiable: :func:`lm_loss`
trains through it), "prefill" (returns per-layer caches), "decode" (one
token against the caches; attention caches are updated in place,
recurrent states returned anew).  Every GEMM call site takes
``cfg.resolved_kernel_config``, the kernel config with ``gemm_backend``
folded in.

Remat (``cfg.remat``, the reference's default True): a training forward
with gradients runs each cycle of ``block_pattern`` under
``torch.utils.checkpoint`` (non-reentrant), so the backward recomputes
the cycle from its input; the ``pre`` and ``tail`` layers keep their
activations, as the reference leaves them outside its scan.

With a ``mesh`` whose ``model`` axis is larger than 1, the params are
this rank's slices, as :func:`storage_specs` gives them
(:func:`init_decoder` keeps only that slice of each leaf as it is
drawn).  An MoE layer runs the reference's ``_apply_moe`` branch
(``moe_apply`` sums the partials over the model axis's process group);
attention, the dense MLP, the embedding and the head, the RG-LRU and
both xLSTM blocks are tensor-parallel wherever :func:`tp_split` splits
them (:mod:`repro_torch.models.attention`, :mod:`~repro_torch.models.
layers`, :mod:`~repro_torch.models.rglru`, :mod:`~repro_torch.models.
xlstm`), and the logits are this rank's vocab columns.  ``fsdp``
(:func:`storage_specs`) also shards the big leaves over ``data``, the
reference's FSDP rule: each block gathers its layer's shards at use,
inside the remat scope, so the backward's recomputation gathers them
again rather than keeping them.  ``cfg.seq_shard`` (the reference's
Megatron-SP) keeps the residual stream split over ``model`` along the
sequence where the axis divides it: each block gathers the sequence
before attention, the MLP, the MoE and each recurrent block (a
recurrence needs its whole sequence) and reduce-scatters their
row-parallel outputs; the head gathers it back.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.moe import (MoEConfig, ep_size_for, init_moe_params,
                                  moe_apply, shard_moe_params)
from repro_torch.distributed import context as dctx
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import (rule_dim, rule_spec,
                                             rule_storage, shard_tree,
                                             slice_leaf, use_leaf, use_tree)
from repro_torch.models import attention as attn
from repro_torch.models import rglru as rg
from repro_torch.models import xlstm as xl
from repro_torch.models.layers import (cross_entropy, embed, init_embedding,
                                       init_mlp, init_rms_norm, mlp, ninit,
                                       norm, remat_scope, rms_norm, sublayer,
                                       tp_out, unembed)
from repro_torch.tree import tree_paths

#: the block kinds of ``block_pattern``
KINDS = ("attn", "rglru", "mlstm", "slstm")


def moe_config(cfg: ModelConfig) -> MoEConfig:
    m = cfg.moe
    return MoEConfig(
        num_experts=m.num_experts, top_k=m.top_k, d_model=cfg.d_model,
        d_ff_expert=m.d_ff_expert, num_shared_experts=m.num_shared_experts,
        norm_topk_prob=m.norm_topk_prob, capacity_factor=m.capacity_factor,
        precision=cfg.precision, kernel_config=cfg.resolved_kernel_config,
        dispatch=cfg.moe_dispatch)


def layer_kinds(cfg: ModelConfig) -> list:
    """The kind of every layer, in the flat order of ``params["layers"]``:
    the JAX package's ``pre{i}`` blocks (``"attn"``), then its stacked
    cycles of ``block_pattern``, then its ``tail{i}`` blocks.  An unknown
    kind raises ``ValueError``."""
    pattern = tuple(cfg.block_pattern) or ("attn",)
    for kind in pattern:
        if kind not in KINDS:
            raise ValueError(f"{cfg.name}: unknown block kind {kind!r}; "
                             f"expected one of {KINDS}")
    n_pre = cfg.moe.first_dense_layers if cfg.moe else 0
    rest = cfg.num_layers - n_pre
    cycles = rest // len(pattern)
    return (["attn"] * n_pre + list(pattern) * cycles
            + list(pattern[:rest % len(pattern)]))


def is_moe_layer(cfg: ModelConfig, i: int) -> bool:
    """Whether block ``i`` carries ``"moe"`` (else a dense ``"mlp"``)."""
    return cfg.moe is not None and i >= cfg.moe.first_dense_layers


def init_block(kind: str, cfg: ModelConfig, *, generator, device,
               moe_layer: bool):
    d = cfg.d_model
    kw = dict(generator=generator, device=device)
    if kind == "attn":
        p = {"ln1": init_rms_norm(d, device=device),
             "ln2": init_rms_norm(d, device=device),
             "attn": attn.init_attention(cfg, cfg.dtype, **kw)}
        if moe_layer:
            p["moe"] = init_moe_params(moe_config(cfg), dtype=cfg.dtype,
                                       **kw)
        else:
            p["mlp"] = init_mlp(d, cfg.dense_ff_width(), "swiglu",
                                cfg.dtype, **kw)
        return p
    if kind == "rglru":
        return {"ln1": init_rms_norm(d, device=device),
                "ln2": init_rms_norm(d, device=device),
                "rglru": rg.init_rglru(cfg, cfg.dtype, **kw),
                "mlp": init_mlp(d, cfg.d_ff, "swiglu", cfg.dtype, **kw)}
    if kind == "mlstm":
        return {"ln1": init_rms_norm(d, device=device),
                "mlstm": xl.init_mlstm(cfg, cfg.dtype, **kw)}
    if kind == "slstm":
        return {"ln1": init_rms_norm(d, device=device),
                "slstm": xl.init_slstm(cfg, cfg.dtype, **kw)}
    raise ValueError(kind)


def _apply_moe(p, x, cfg: ModelConfig, mesh, mode: str, seq: bool = False):
    """The MoE FFN of [B, S, d] ``x``: on one rank, or over the mesh's
    model axis (EP where the experts divide it, else TP); in training on
    a mesh, the load-balance loss is the whole batch's (its statistics
    averaged over the batch axes).  ``seq``: ``x`` is the sequence
    gathered over the model axis, and the output is reduce-scattered
    back to this rank's chunk."""
    mcfg = moe_config(cfg)
    b, s, d = x.shape
    kw = {}
    if mode == "train" and mesh is not None and mesh.batch_ranks > 1:
        kw["batch_group"] = mesh.batch_group()
    group = None
    if dctx.model_axis_size(mesh) > 1:
        ep = ep_size_for(mcfg, dctx.model_axis_size(mesh))
        group = mesh.group("model")
        kw.update(ep_rank=mesh.coord("model") if ep > 1 else 0, ep_size=ep,
                  group=group, seq=seq)
    y, aux = moe_apply(p, x.reshape(b * s, d), mcfg, **kw)
    y = y.reshape(b, s, d)
    if seq:
        y = tp_out(y, group, True, x.dtype)
    return y, aux["load_balance_loss"]


def block_apply(kind: str, p, x, cfg: ModelConfig, positions, *, cache=None,
                mode: str = "train", cache_capacity=None, pos_offset: int = 0,
                mesh=None, sp: bool = False):
    """Returns (x, new_cache, aux_loss); new_cache is None in train
    mode.  ``sp``: ``x`` is this rank's chunk of a sequence-parallel
    residual (module docstring)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    split = tp_split(cfg, dctx.model_axis_size(mesh))
    group = mesh.group("model") if split else None
    ngroup = group if sp else None

    def mlp_fn(pm):
        return lambda h, g, seq: (mlp(pm, h, "swiglu", precision=cfg.precision,
                                      config=cfg.resolved_kernel_config,
                                      group=g, seq=seq), None)
    if kind == "attn":
        h, new_cache = sublayer(
            lambda h, g, seq: attn.attention_block(
                p["attn"], h, cfg, positions, cache=cache,
                layer_window=cfg.window, mode=mode,
                cache_capacity=cache_capacity, pos_offset=pos_offset,
                group=g, kv_split=split.get("kv", False), seq=seq),
            norm(p["ln1"], x, cfg.norm_eps, ngroup), group,
            split.get("heads", False), sp)
        x = x + h
        h2 = norm(p["ln2"], x, cfg.norm_eps, ngroup)
        if "moe" not in p:
            ff, _ = sublayer(mlp_fn(p["mlp"]), h2, group,
                             split.get("mlp", False), sp)
            return x + ff, new_cache, aux
        if sp:
            h2 = dctx.gather_seq(h2, group)
        ff, lb = _apply_moe(p["moe"], h2, cfg, mesh, mode, sp)
        return x + ff, new_cache, lb
    if kind == "rglru":
        h, state = sublayer(
            lambda h, g, seq: rg.rglru_apply(p["rglru"], h, state=cache,
                                             group=g, seq=seq),
            norm(p["ln1"], x, cfg.norm_eps, ngroup), group,
            split.get("recurrent", False), sp)
        x = x + h
        ff, _ = sublayer(mlp_fn(p["mlp"]),
                         norm(p["ln2"], x, cfg.norm_eps, ngroup), group,
                         split.get("mlp", False), sp)
        x = x + ff
    elif kind in ("mlstm", "slstm"):
        fn = xl.mlstm_apply if kind == "mlstm" else xl.slstm_apply
        h, state = sublayer(
            lambda h, g, seq: fn(p[kind], h, state=cache, group=g, seq=seq),
            norm(p["ln1"], x, cfg.norm_eps, ngroup), group,
            split.get(kind, False), sp)
        x = x + h
    else:
        raise ValueError(kind)
    return x, (None if mode == "train" else state), aux


def init_block_cache(kind: str, cfg: ModelConfig, batch: int, seq_len: int,
                     *, device, group=None, split=None):
    """An empty cache of one layer; ``group`` (the model axis) with
    ``split`` (:func:`tp_split`) keeps this rank's part of each state
    the layer splits."""
    split = split or {}
    ways = dctx.group_size(group)
    if kind == "attn":
        return attn.init_kv_cache(cfg, batch, seq_len, cfg.window,
                                  device=device,
                                  group=group if split.get("heads") else None)
    if kind == "rglru":
        return rg.init_rglru_state(
            cfg, batch, device=device,
            ways=ways if split.get("recurrent") else 1)
    if kind == "mlstm":
        return xl.init_mlstm_state(cfg, batch, device=device,
                                   ways=ways if split.get("mlstm") else 1)
    if kind == "slstm":
        return xl.init_slstm_state(cfg, batch, device=device,
                                   ways=ways if split.get("slstm") else 1)
    raise ValueError(kind)


def tp_split(cfg: ModelConfig, n: int) -> dict:
    """What a model axis of ``n`` ranks splits ({} for ``n == 1``), each
    where ``n`` divides it: the q heads (``"heads"``), the kv heads
    (``"kv"``: the reference's ``spec_for`` guard, on heads, not
    columns), the dense MLP's ``d_ff`` (``"mlp"``), the vocab
    (``"vocab"``), the RG-LRU's width (``"recurrent"``), the mLSTM's
    heads (``"mlstm"``) and the sLSTM's channels (``"slstm"``).  A module
    whose dim ``n`` does not divide runs whole on every rank."""
    if n == 1:
        return {}
    heads = cfg.num_heads % n == 0
    return {"heads": heads, "kv": heads and cfg.num_kv_heads % n == 0,
            "mlp": cfg.dense_ff_width() % n == 0,
            "vocab": cfg.vocab_size % n == 0,
            "recurrent": (cfg.lru_width or cfg.d_model) % n == 0,
            "mlstm": heads, "slstm": cfg.d_model % n == 0}


def _leaf_dim(path: str, ndim: int) -> Optional[str]:
    """The :func:`tp_split` key that decides whether the leaf at ``path``
    is split: the rule's logical dim, read as the xLSTM blocks' heads or
    channels under ``mlstm/`` and ``slstm/``."""
    dim = rule_dim(path, ndim)
    parts = path.split("/")
    if "mlstm" in parts and dim in ("heads", "kv"):
        return "mlstm"
    if "slstm" in parts and dim == "heads":
        return "slstm"
    return dim


@functools.lru_cache(maxsize=64)
def param_shapes(cfg: ModelConfig) -> dict:
    """Path -> logical shape of every leaf of ``cfg``'s param tree (drawn
    on the meta device: nothing is allocated)."""
    gen = torch.Generator()
    if cfg.family == "audio":
        from repro_torch.models.whisper import init_whisper
        tree = init_whisper(cfg, generator=gen, device="meta")
    else:
        tree = init_decoder(cfg, generator=gen, device="meta")
    return {p: tuple(x.shape) for p, x in tree_paths(tree)}


def param_specs(cfg: ModelConfig, mesh, *, fsdp: bool = False) -> dict:
    """Path -> storage spec of every leaf of ``cfg``'s param tree on
    ``mesh`` (:func:`storage_specs`)."""
    return _param_specs(cfg, mesh, fsdp, sharding.FSDP_MIN_SIZE)


@functools.lru_cache(maxsize=64)
def _param_specs(cfg, mesh, fsdp, fsdp_min_size) -> dict:
    n = dctx.model_axis_size(mesh)
    split = tp_split(cfg, n)
    per_name = {}
    if split and cfg.moe is not None:
        mcfg = moe_config(cfg)
        per_name = shard_moe_params(None, mcfg, ep_size_for(mcfg, n))
    stack = reference_stack(cfg) if fsdp else None
    specs = {}
    for path, shape in param_shapes(cfg).items():
        parts = path.split("/")
        if fsdp and n == 1:
            # a model axis of 1 splits nothing: the rules' own specs place
            # the data shards where the reference's do
            spec = rule_spec(path, len(shape), "ep")
        elif "moe" in parts[:-1]:
            spec = per_name.get(parts[-1], ())
        elif split.get(_leaf_dim(path, len(shape))):
            spec = rule_spec(path, len(shape), "ep")
        else:
            spec = ()
        specs[path] = rule_storage(path, shape, spec, mesh, fsdp=fsdp,
                                   fsdp_min_size=fsdp_min_size, stack=stack)
    return specs


def storage_specs(params, cfg: ModelConfig, mesh, *,
                  fsdp: bool = False) -> dict:
    """Path -> spec of every leaf of ``params`` (the model's tree; full
    leaves or a rank's slices) as the port stores it on ``mesh``: an MoE
    layer's leaves (under ``moe/``) as ``shard_moe_params`` lays them out
    (EP where the experts divide the model axis, else TP on ``d_ff``),
    every other leaf by the partition rules (``build_param_specs``) where
    :func:`tp_split` splits it, else whole.  With ``fsdp``, each is then
    extended over ``data`` by the reference's FSDP rule, decided on the
    logical shapes (``distributed.sharding.rule_storage``; a leaf whose
    stacked layer axis the reference would shard is kept whole by the
    data rank that owns its layer, an ``Owner``)."""
    specs = param_specs(cfg, mesh, fsdp=fsdp)
    return {path: specs[path] for path, _ in tree_paths(params)}


def init_decoder(cfg: ModelConfig, *, generator: torch.Generator, device,
                 mesh=None, fsdp: bool = False):
    """Random params drawn from ``generator`` in the reference's order.
    With a mesh, each leaf keeps only this rank's slice
    (:func:`storage_specs`; ``fsdp`` as there), taken as its layer is
    drawn: every rank draws the same values, and none holds more than one
    whole layer (or the embedding) at a time."""
    kinds = layer_kinds(cfg)
    specs = None if mesh is None else param_specs(cfg, mesh, fsdp=fsdp)

    def keep(tree, prefix):
        return tree if specs is None else shard_tree(tree, specs, mesh,
                                                     prefix)
    params = {
        "embed": keep(init_embedding(cfg.vocab_size, cfg.d_model, cfg.dtype,
                                     cfg.tie_embeddings, generator=generator,
                                     device=device), "embed/"),
        "final_norm": init_rms_norm(cfg.d_model, device=device),
    }
    if cfg.family == "vlm" and cfg.num_patches:
        params["vision_proj"] = ninit(
            (cfg.patch_embed_dim, cfg.d_model), cfg.patch_embed_dim ** -0.5,
            cfg.dtype, generator=generator, device=device)
        if specs is not None:
            params["vision_proj"] = slice_leaf(
                params["vision_proj"], specs["vision_proj"], mesh)
    params["layers"] = [keep(init_block(kind, cfg, generator=generator,
                                        device=device,
                                        moe_layer=is_moe_layer(cfg, i)),
                             f"layers/{i}/")
                        for i, kind in enumerate(kinds)]
    return params


def reference_stack(cfg: ModelConfig) -> dict:
    """Top-level list key -> for each entry, ``(copies, position)``: the
    layer copies the JAX package stacks it with and its place among
    them (``None``: stored unstacked there), the ``stack`` of
    ``distributed.sharding.build_param_specs``: a decoder's cycles of
    ``block_pattern`` stack ``(num_layers - n_pre) // len(pattern)``
    copies, its ``pre``/``tail`` layers are unstacked; whisper stacks
    every encoder layer and every decoder layer."""
    if cfg.family == "audio":
        return {"enc_layers": [(cfg.encoder_layers, i)
                               for i in range(cfg.encoder_layers)],
                "layers": [(cfg.num_layers, i)
                           for i in range(cfg.num_layers)]}
    pattern = tuple(cfg.block_pattern) or ("attn",)
    n_pre = cfg.moe.first_dense_layers if cfg.moe is not None else 0
    cycles = (cfg.num_layers - n_pre) // len(pattern)
    n = len(layer_kinds(cfg))
    return {"layers": [(cycles, (i - n_pre) // len(pattern))
                       if n_pre <= i < n_pre + cycles * len(pattern)
                       else None for i in range(n)]}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *, device,
               mesh=None):
    """Empty decode caches; on a mesh, each layer keeps this rank's part
    of what the model axis splits (:func:`init_block_cache`)."""
    split = tp_split(cfg, dctx.model_axis_size(mesh))
    group = mesh.group("model") if split else None
    return {"layers": [init_block_cache(kind, cfg, batch, seq_len,
                                        device=device, group=group,
                                        split=split)
                       for kind in layer_kinds(cfg)]}


def _segments(cfg: ModelConfig) -> list:
    """The layers as runs to apply in order, with whether each is a cycle
    of ``block_pattern`` (remat's unit) or a lone ``pre`` / ``tail``
    layer."""
    stack = reference_stack(cfg)["layers"]
    period = len(tuple(cfg.block_pattern) or ("attn",))
    out, i = [], 0
    while i < len(stack):
        if stack[i] is None:
            out.append((range(i, i + 1), False))
            i += 1
        else:
            out.append((range(i, i + period), True))
            i += period
    return out


def seq_parallel(cfg: ModelConfig, mesh, s: int) -> bool:
    """Whether a forward of ``s`` positions keeps its residual split over
    the model axis: ``cfg.seq_shard`` and an axis larger than 1 that
    divides ``s`` (the reference's ``spec_for`` guard; decode's S = 1
    stays whole)."""
    n = dctx.model_axis_size(mesh)
    return cfg.seq_shard and n > 1 and s % n == 0


def decoder_forward(params, tokens, cfg: ModelConfig, *, mode="train",
                    cache=None, patch_embeds=None, pos_offset: int = 0,
                    cache_capacity: Optional[int] = None, mesh=None,
                    specs: Optional[dict] = None):
    """tokens: [B, S] int.  Returns (logits, new_cache, aux_loss).

    decode mode: S == 1 and ``cache`` holds the per-layer state.
    vlm: ``patch_embeds`` [B, P, patch_embed_dim] are projected and
    prepended (their loss positions carry label -1 in :func:`lm_loss`).
    ``specs``: the params' storage specs where they are FSDP shards
    (gathered at use), else None.
    """
    kinds = layer_kinds(cfg)
    split = tp_split(cfg, dctx.model_axis_size(mesh))
    group = mesh.group("model") if split else None
    vgroup = group if split.get("vocab") else None

    def used(tree, prefix):
        return tree if specs is None else use_tree(tree, specs, mesh, prefix)
    x = embed(used(params["embed"], "embed/"), tokens, vgroup)
    if patch_embeds is not None:
        vp = params["vision_proj"] if specs is None else \
            use_leaf(params["vision_proj"], specs["vision_proj"], mesh)
        pe = patch_embeds.to(x.dtype) @ vp.to(x.dtype)
        x = torch.cat([pe, x], dim=1)
    b, s = x.shape[:2]
    positions = None
    if mode != "decode":
        positions = pos_offset + torch.arange(s, dtype=torch.int32,
                                              device=tokens.device)
    sp = seq_parallel(cfg, mesh, s)
    if sp:
        x = dctx.split_seq(x, group)
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    caches = []

    def run_layers(layers, x, aux_total):
        for li in layers:
            c = cache["layers"][li] if cache is not None else None
            x, nc, aux = block_apply(kinds[li],
                                     used(params["layers"][li],
                                          f"layers/{li}/"),
                                     x, cfg, positions, cache=c, mode=mode,
                                     cache_capacity=cache_capacity,
                                     pos_offset=pos_offset, mesh=mesh, sp=sp)
            aux_total = aux_total + aux
            caches.append(nc)
        return x, aux_total

    remat = mode == "train" and cfg.remat and torch.is_grad_enabled()
    cycle = remat_scope(run_layers) if remat else run_layers
    for layers, is_cycle in _segments(cfg):
        x, aux_total = (cycle if is_cycle else run_layers)(layers, x,
                                                          aux_total)
    if sp:
        x = dctx.gather_seq(x, group, grad="own")
    new_cache = {"layers": caches} if mode in ("prefill", "decode") else None
    if mode == "prefill":
        x = x[:, -1:]        # serving prefill needs only the last position
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return (unembed(used(params["embed"], "embed/"), x, vgroup), new_cache,
            aux_total)


def lm_loss(params, batch, cfg: ModelConfig, *, aux_weight=0.01, mesh=None,
            specs: Optional[dict] = None):
    """batch: {tokens [B, S], labels [B, S] (-1 = ignore), optional
    patch_embeds}.  Next-token cross-entropy plus ``aux_weight`` times the
    MoE load-balance loss; returns ``(loss, {"ce", "aux"})``."""
    pe = batch.get("patch_embeds")
    logits, _, aux = decoder_forward(params, batch["tokens"], cfg,
                                     mode="train", patch_embeds=pe,
                                     mesh=mesh, specs=specs)
    labels = batch["labels"]
    if pe is not None:      # the patch positions carry no label
        labels = torch.cat([labels.new_full((labels.shape[0], pe.shape[1]),
                                            -1), labels], dim=1)
    vgroup = mesh.group("model") if tp_split(
        cfg, dctx.model_axis_size(mesh)).get("vocab") else None
    loss = cross_entropy(logits[:, :-1], labels[:, 1:], vgroup)
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}
