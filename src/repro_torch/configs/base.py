"""Model configuration dataclasses of the port, with torch dtypes.

The fields carry the names and defaults of the JAX package's
``ModelConfig``, the recurrent (``lru_width``, ``conv_width``), encoder
(``encoder_layers``, ``encoder_seq``, ``cross_attention``) and vision
(``num_patches``, ``patch_embed_dim``) fields included, and ``remat``
(default True, as in the JAX package: a training forward with gradients
recomputes each cycle of ``block_pattern``, and whisper's layers, in the
backward instead of keeping their activations), and ``seq_shard``
(default False, as in the JAX package: under a model axis larger than 1
the residual stream is split over it along the sequence, Megatron-SP;
the mesh itself is an argument of ``make_model``, not a field).
``scan_layers`` is left out, as the port keeps its layers in a list, and
so is ``moe_reduce_bf16`` (ROADMAP C).
``block_pattern`` is cycled over the layers: ``"attn"`` (attention and
an MLP or MoE), ``"rglru"`` (the RG-LRU recurrence and an MLP),
``"mlstm"`` or ``"slstm"`` (the xLSTM blocks).  ``moe_dispatch`` is
``"ragged"`` (the
paper's padding-free grouped GEMM) or ``"dense"`` (GShard's capacity
buckets).  ``gemm_backend`` selects the
grouped GEMMs' backend for the whole model: None, or
``"padded_baseline"``, the paper's baseline.  ``attn_backend`` picks the
prefill and training attention: ``"chunked"`` (plain PyTorch) or
``"flash"`` (the flash-attention kernel, taken where the layer has no
window and S % 128 == 0, as in the JAX package).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.kernels.plan import KernelConfig, check_backend, \
    resolve_config


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    norm_topk_prob: bool = False
    capacity_factor: float = 2.0
    first_dense_layers: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense|moe|ssm|hybrid|audio|vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    block_pattern: Tuple[str, ...] = ("attn",)
    window: Optional[int] = None
    moe: Optional[MoESpec] = None
    # recurrent dims
    lru_width: Optional[int] = None
    conv_width: int = 4
    # encoder-decoder (whisper): encoder frames are a precomputed stub
    encoder_layers: int = 0
    encoder_seq: int = 1500
    cross_attention: bool = False
    # vlm stub: precomputed patch embeddings projected and prepended
    num_patches: int = 0
    patch_embed_dim: int = 1024
    dtype: torch.dtype = torch.bfloat16
    precision: str = "bf16"            # "bf16" | "fp8" for grouped/linear GEMMs
    # None | "padded_baseline" (kernels.plan.check_backend)
    gemm_backend: Optional[str] = None
    # tile shapes of every grouped GEMM; None = KernelConfig()
    kernel_config: Optional[KernelConfig] = None
    remat: bool = True
    seq_shard: bool = False            # Megatron-SP: residual split on model
    attn_chunk: int = 512
    moe_dispatch: str = "ragged"       # "ragged" (paper) | "dense" (GShard)
    attn_backend: str = "chunked"      # "chunked" | "flash"

    def __post_init__(self):
        if self.gemm_backend != "auto":
            check_backend(self.gemm_backend)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def resolved_kernel_config(self) -> Optional[KernelConfig]:
        """``kernel_config`` with ``gemm_backend`` folded in: the config
        every GEMM call site of the model takes.  It stays None when
        neither is set, so a :func:`~repro_torch.kernels.plan.default_config`
        scope still applies; the fold goes through ``resolve_config``, so
        it lands on that scope's config where the model has none."""
        if self.gemm_backend is None:
            return self.kernel_config
        return resolve_config(self.kernel_config, backend=self.gemm_backend)

    def param_count(self) -> int:
        """The number of elements in the param tree, for every family: the
        embedding (and head), the final norm(s), each layer's block (of
        the kind :func:`repro_torch.models.transformer.layer_kinds` gives
        it) and, for a VLM, the patch projection; for the audio family,
        the encoder's and the decoder's layers."""
        d = self.d_model
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family == "audio":      # whisper never ties its head
            emb = 2 * self.vocab_size * d
            enc = self._attn_params() + 2 * d + 2 * d * self.d_ff
            dec = 2 * self._attn_params() + 3 * d + 2 * d * self.d_ff
            return (emb + 2 * d + self.encoder_layers * enc
                    + self.num_layers * dec)
        from repro_torch.models.transformer import layer_kinds
        n = emb + d
        if self.family == "vlm" and self.num_patches:
            n += self.patch_embed_dim * d
        return n + sum(self._block_params(kind, i)
                       for i, kind in enumerate(layer_kinds(self)))

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        n = d * hd * (self.num_heads + 2 * self.num_kv_heads) \
            + hd * self.num_heads * d
        if self.qkv_bias:
            n += hd * (self.num_heads + 2 * self.num_kv_heads)
        if self.qk_norm:
            n += 2 * hd
        return n

    def dense_ff_width(self) -> int:
        """The width of an attention block's dense MLP: ``d_ff``, else (the
        JAX package's rule) the active experts' width, else 4 d."""
        m = self.moe
        return self.d_ff or (m.d_ff_expert * (m.top_k + m.num_shared_experts)
                             if m else 4 * self.d_model)

    def _block_params(self, kind: str, i: int) -> int:
        d, m = self.d_model, self.moe
        if kind == "attn":
            if m is not None and i >= m.first_dense_layers:
                ff = 3 * d * m.d_ff_expert * (m.num_experts
                                              + m.num_shared_experts) \
                    + d * m.num_experts
            else:
                ff = 3 * d * self.dense_ff_width()
            return self._attn_params() + 2 * d + ff
        if kind == "rglru":
            w, cw = self.lru_width or d, self.conv_width
            return (2 * d + 2 * d * w + cw * w + 2 * w * w + w + w * d
                    + 3 * d * self.d_ff)
        hhd = self.num_heads * self.resolved_head_dim
        if kind == "mlstm":
            return d + 5 * d * hhd + 2 * d * self.num_heads
        if kind == "slstm":
            return d + 5 * d * d
        raise ValueError(kind)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"
    grad_accum: int = 1        # microbatch count for train shapes


#: the dry run's input shapes, the JAX package's
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

#: architectures whose attention is strictly O(S^2) full attention: the
#: long_500k cell is skipped for these
FULL_ATTENTION_ARCHS = frozenset({
    "yi-9b", "minitron-8b", "qwen3-1.7b", "qwen1.5-110b", "whisper-tiny",
    "qwen2-moe-a2.7b", "deepseek-moe-16b", "pixtral-12b",
})


def cell_is_runnable(arch: str, shape: str) -> bool:
    if shape == "long_500k" and arch in FULL_ATTENTION_ARCHS:
        return False
    return True
