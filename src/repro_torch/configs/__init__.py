"""Architecture configs (port of ``repro.configs``) for the ported archs."""
