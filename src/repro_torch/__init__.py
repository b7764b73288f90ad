"""repro_torch: the PyTorch/CUDA port of the NEUKONFIG reproduction.

The counterpart of ``repro`` (the JAX reference, which this package never
imports).  Module names mirror ``repro``'s.  Ported so far: the dense
stateful edge-cloud decode path with live repartitioning
(``repro_torch.core.stateful``) and its decode-attention kernel
(``repro_torch.kernels.flash_decode``).  Entry points run on the card
unless the caller passes ``device="cpu"``.
"""
