"""qwen2-moe-a2.7b: 60 routed (top-4) + 4 shared experts
[hf:Qwen/Qwen1.5-MoE-A2.7B].

The port serves it in fp8: every dimension is a multiple of 128, so every
GEMM of its MoE layers, the shared experts' included, runs on the fp8
grouped GEMM.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=0, vocab_size=151936, head_dim=128, rope_theta=1e6,
    qkv_bias=True, precision="fp8",
    moe=MoESpec(num_experts=60, top_k=4, d_ff_expert=1408,
                num_shared_experts=4, norm_topk_prob=False),
)
RUN_HINTS = {"train_microbatch": 32, "prefill_microbatch": 16}


def smoke_config():
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
        head_dim=64, vocab_size=512, attn_chunk=64,
        moe=MoESpec(num_experts=8, top_k=2, d_ff_expert=128,
                    num_shared_experts=2, norm_topk_prob=False))
