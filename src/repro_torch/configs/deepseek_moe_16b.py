"""deepseek-moe-16b: fine-grained 64 routed (top-6) + 2 shared experts,
first layer dense [arXiv:2401.06066].

The paper's sweet spot: many small ragged groups per grouped GEMM.  The
port serves it in fp8: the experts' widths (2048, 1408, 2 x 1408) are
multiples of 128, so every MoE GEMM runs on the fp8 grouped GEMM; the
dense first layer's d_ff (10944 = 85.5 x 128) is not, so its MLP is a
plain bf16 matmul, as the JAX package leaves it to XLA.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=10944,  # layer-0 dense FFN width (deepseek-moe-16b)
    vocab_size=102400, head_dim=128, rope_theta=1e4, precision="fp8",
    moe=MoESpec(num_experts=64, top_k=6, d_ff_expert=1408,
                num_shared_experts=2, norm_topk_prob=False,
                first_dense_layers=1),
)
RUN_HINTS = {"train_microbatch": 32, "prefill_microbatch": 16}


def smoke_config():
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=256, num_heads=4, num_kv_heads=4,
        head_dim=64, d_ff=512, vocab_size=512, attn_chunk=64,
        moe=MoESpec(num_experts=8, top_k=2, d_ff_expert=128,
                    num_shared_experts=1, norm_topk_prob=False,
                    first_dense_layers=1))
