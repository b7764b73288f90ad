"""Model math of the port (see ``repro.models``)."""
