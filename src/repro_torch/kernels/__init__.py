"""Hand-written Hopper kernels of the port, each beside its plain version.

Importing this package builds nothing: a kernel is compiled at its first
launch on a CUDA tensor (``repro_torch.kernels.build``)."""
