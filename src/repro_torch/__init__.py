"""repro_torch: the PyTorch/CUDA port of the NEUKONFIG reproduction.

The counterpart of ``repro`` (the JAX reference, which this package never
imports).  Module names mirror ``repro``'s.  Ported so far, for the dense
family: the stateless edge-cloud pipeline of the quickstart
(``repro_torch.core.stages.StageRunner``,
``repro_torch.core.pipeline.EdgeCloudPipeline``) and the stateful
edge-cloud decode path (``repro_torch.core.stateful``), both with live
repartitioning, on two hand-written kernels: prefill attention
(``repro_torch.kernels.flash_attention``) and decode attention
(``repro_torch.kernels.flash_decode``).  Entry points run on the card
unless the caller passes ``device="cpu"``.
"""
