"""Falcon-Mamba-7B — pure Mamba-1 architecture [arXiv:2410.05355].

64 layers, d_model=4096, attention-free, vocab=65024, ssm_state=16.
d_inner = 2*d_model = 8192, dt_rank = d_model/16 = 256, conv width 4.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=65024,
    ssm=SSMConfig(kind="mamba1", d_state=16, d_conv=4, expand=2, dt_rank=256),
    source="arXiv:2410.05355",
)
