"""The training package (port of ``repro.training``): the LM serving steps."""
