"""Model layers (port of ``repro/models/layers``)."""
