"""Training of the port (see ``repro.training``)."""
from repro_torch.training.steps import (make_prefill_step, make_serve_step,
                                        make_train_step)
from repro_torch.training.loop import train
