"""StarCoder2-7B — dense GQA with RoPE [arXiv:2402.19173].

32 layers, d_model=4608, 36 heads (GQA kv=4), d_ff=18432, vocab=49152.
long_500k runs under the sliding-window variant [swa-variant].
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    rope_theta=1_000_000.0,
    gated_mlp=False,  # starcoder2 uses a classic GELU MLP (c_fc/c_proj)
    long_context_window=8192,
    source="arXiv:2402.19173",
)
