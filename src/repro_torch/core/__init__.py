"""Control plane and stateful serving of the port (see ``repro.core``)."""
