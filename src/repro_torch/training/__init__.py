"""The training package (port of ``repro.training``): the train and serve
steps, the optimizers and gradient compression."""
