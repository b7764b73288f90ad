"""Command-line launchers of the port (see ``repro/launch``)."""
