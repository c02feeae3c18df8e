"""whisper-tiny: encoder-decoder audio backbone [arXiv:2212.04356].

The conv / mel frontend is a stub, as in the JAX package: a batch carries
precomputed frame embeddings ``frames`` [B, encoder_seq, d_model].  4
encoder layers (bidirectional attention, GELU MLP) and 4 decoder layers
(causal self-attention, cross-attention over the encoder output, GELU
MLP); RoPE positions.  The preset keeps the JAX package's bf16 default;
under ``precision="fp8"`` the MLPs (d 384, d_ff 1536) run on the fp8
kernels with the fused activation quantizer's gelu mode.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    num_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
    d_ff=1536, vocab_size=51865, head_dim=64,
    encoder_layers=4, encoder_seq=1500, cross_attention=True,
    rope_theta=1e4,
)
RUN_HINTS = {"train_microbatch": 64, "prefill_microbatch": 32}


def smoke_config():
    return dataclasses.replace(
        CONFIG, num_layers=2, encoder_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
        encoder_seq=64, attn_chunk=64)
