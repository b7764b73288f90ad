"""repro_torch: the PyTorch/CUDA port of the NEUKONFIG reproduction.

The counterpart of ``repro`` (the JAX reference, which this package never
imports).  Module names mirror ``repro``'s.  Ported so far, for the dense,
ssm (falcon-mamba-7b) and hybrid (zamba2-7b) families: the stateless
edge-cloud pipeline of the quickstart
(``repro_torch.core.stages.StageRunner``,
``repro_torch.core.pipeline.EdgeCloudPipeline``) and the stateful
edge-cloud decode path (``repro_torch.core.stateful``), both with live
repartitioning, on four hand-written kernels: prefill attention
(``repro_torch.kernels.flash_attention``), decode attention
(``repro_torch.kernels.flash_decode``), the Mamba-1 selective scan
(``repro_torch.kernels.mamba_scan``) and the Mamba-2 SSD scan
(``repro_torch.kernels.ssd_scan``).  Entry points run on the card unless
the caller passes ``device="cpu"``.
"""
