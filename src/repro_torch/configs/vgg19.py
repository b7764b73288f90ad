"""VGG-19 — the paper's sequential DNN (Fig. 2) [Simonyan & Zisserman 2015].

Exact Keras ``applications.VGG19`` layer sequence (25 partitionable layers:
16 conv + 5 pool + flatten + 3 dense).  Per-layer activation volumes vary by
orders of magnitude, which is what makes the optimal split move with
bandwidth in the paper's Fig. 2.
"""
from repro_torch.configs.base import CNNConfig, CNNLayer as L

CONFIG = CNNConfig(
    name="vgg19",
    family="cnn",
    input_hw=224,
    input_ch=3,
    layers=(
        # block1
        L("conv", out_ch=64), L("conv", out_ch=64), L("pool", stride=2),
        # block2
        L("conv", out_ch=128), L("conv", out_ch=128), L("pool", stride=2),
        # block3
        L("conv", out_ch=256), L("conv", out_ch=256),
        L("conv", out_ch=256), L("conv", out_ch=256), L("pool", stride=2),
        # block4
        L("conv", out_ch=512), L("conv", out_ch=512),
        L("conv", out_ch=512), L("conv", out_ch=512), L("pool", stride=2),
        # block5
        L("conv", out_ch=512), L("conv", out_ch=512),
        L("conv", out_ch=512), L("conv", out_ch=512), L("pool", stride=2),
        L("flatten"),
        L("dense", units=4096), L("dense", units=4096), L("dense", units=1000),
    ),
    num_classes=1000,
    source="arXiv:1409.1556 (paper's Fig. 2 model)",
)
