"""pixtral-12b: pixtral-ViT frontend (stub) and mistral-nemo decoder
[hf:mistralai/Pixtral-12B-2409].

The vision frontend is a stub, as in the JAX package: a batch carries
precomputed patch embeddings ``patch_embeds`` [B, num_patches,
patch_embed_dim], projected by ``vision_proj`` and prepended to the
token embeddings; positions run over patches and text, and the loss
ignores the patch positions.  The preset keeps the JAX package's bf16
default.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=131072, head_dim=128, rope_theta=1e9,
    num_patches=256, patch_embed_dim=1024,
)
RUN_HINTS = {"train_microbatch": 16, "prefill_microbatch": 8}


def smoke_config():
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=512, vocab_size=512, attn_chunk=64,
        num_patches=16, patch_embed_dim=64)
