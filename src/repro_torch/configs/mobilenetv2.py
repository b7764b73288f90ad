"""MobileNetV2 — the paper's non-sequential DNN (Fig. 3) [Sandler et al. 2018].

Per the paper (section II-A), layers on parallel paths are NOT partitioned:
each inverted-residual region is treated as one BLOCK.  We model the standard
MobileNetV2(1.0, 224) stage list; each ``block`` entry is one partition unit
(``repeats`` inverted residuals fused, as in the paper's "layers 19-28 are a
block").
"""
from repro_torch.configs.base import CNNConfig, CNNLayer as L

CONFIG = CNNConfig(
    name="mobilenetv2",
    family="cnn",
    input_hw=224,
    input_ch=3,
    layers=(
        L("conv", out_ch=32, stride=2),                       # stem
        L("block", out_ch=16, expand=1, stride=1, repeats=1),
        L("block", out_ch=24, expand=6, stride=2, repeats=2),
        L("block", out_ch=32, expand=6, stride=2, repeats=3),
        L("block", out_ch=64, expand=6, stride=2, repeats=4),
        L("block", out_ch=96, expand=6, stride=1, repeats=3),
        L("block", out_ch=160, expand=6, stride=2, repeats=3),
        L("block", out_ch=320, expand=6, stride=1, repeats=1),
        L("conv", out_ch=1280, kernel=1),                     # head conv
        L("pool", stride=7),                  # global pool: a MAX (models/cnn.py)
        L("flatten"),
        L("dense", units=1000),
    ),
    num_classes=1000,
    source="arXiv:1801.04381 (paper's Fig. 3 model)",
)
