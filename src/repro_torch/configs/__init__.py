from repro_torch.configs.base import (
    ArchConfig, CNNConfig, CNNLayer, EncoderConfig, InputShape, INPUT_SHAPES,
    MoEConfig, SSMConfig,
)
from repro_torch.configs.registry import (ALL_ARCHS, ASSIGNED_ARCHS,
                                         PAPER_ARCHS, get_config, get_shape,
                                         pair_is_runnable)
