"""qwen3-1.7b: dense LM with qk-norm and GQA [hf:Qwen/Qwen3-1.7B].

bf16 weights and GEMMs (``precision="bf16"``): its 2-D products are plain
``torch.matmul`` calls, as the JAX package leaves them to XLA.  With
``attn_backend="flash"`` its prefill and training attention run the
flash-attention kernel, the one path on which GQA (16 q heads over 8 kv
heads) reaches it.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=8,
    d_ff=6144, vocab_size=151936, head_dim=128, rope_theta=1e6,
    qk_norm=True, tie_embeddings=True,
)
RUN_HINTS = {"train_microbatch": 32, "prefill_microbatch": 16}


def smoke_config():
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=512, vocab_size=512, attn_chunk=64)
