"""Model configuration dataclasses of the port, with torch dtypes.

The fields carry the names of the JAX package's ``ModelConfig``; those
the port does not read yet (recurrent, encoder and vision fields, the
remat and scan switches, distribution switches) are left out until a
slice ports what reads them.  ``moe_dispatch`` is ``"ragged"`` (the
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
    dtype: torch.dtype = torch.bfloat16
    precision: str = "bf16"            # "bf16" | "fp8" for grouped/linear GEMMs
    # None | "padded_baseline" (kernels.plan.check_backend)
    gemm_backend: Optional[str] = None
    # tile shapes of every grouped GEMM; None = KernelConfig()
    kernel_config: Optional[KernelConfig] = None
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
        """Parameter count of a decoder of attention blocks, each with MoE
        (``moe``) or a dense SwiGLU MLP (``d_ff``; with MoE, the first
        ``moe.first_dense_layers`` blocks): the number of elements in the
        param tree."""
        d, hd = self.d_model, self.resolved_head_dim
        attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) \
            + hd * self.num_heads * d
        if self.qkv_bias:
            attn += hd * (self.num_heads + 2 * self.num_kv_heads)
        if self.qk_norm:
            attn += 2 * hd
        m = self.moe
        dense_ff = 3 * d * self.d_ff
        n_dense = self.num_layers if m is None else m.first_dense_layers
        ff = n_dense * dense_ff
        if m is not None:
            ff += (self.num_layers - n_dense) * (
                3 * d * m.d_ff_expert * (m.num_experts
                                         + m.num_shared_experts)
                + d * m.num_experts)
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.num_layers * (attn + 2 * d) + ff + emb + d
