"""The CSP detector ladder and its layers (port of ``repro.models``)."""
