"""qwen1.5-110b: large dense LM with QKV bias [hf:Qwen/Qwen1.5-110B].

The preset keeps the JAX package's bf16 default.  Its 80 layers (~111 B
params, ~222 GB in bf16) do not fit one card; under ``precision="fp8"``
its MLP runs the G = 1 fp8 GEMM at K / N = 8192 / 49152.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=49152, vocab_size=152064, head_dim=128, rope_theta=1e6,
    qkv_bias=True,
    attn_chunk=1024,   # halves the online-softmax rescale steps
)
# biggest model: 1 sample per data shard per microbatch
RUN_HINTS = {"train_microbatch": 16, "prefill_microbatch": 16}


def smoke_config():
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=512, vocab_size=512, attn_chunk=64)
