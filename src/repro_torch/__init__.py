"""PyTorch/CUDA port of the OmniSense reproduction (``repro``).

Mirrors ``repro`` path for path: ``repro_torch.core.sphere`` ports
``repro.core.sphere`` and so on.  Importing the package builds and loads
no kernel; the CUDA kernels under ``repro_torch.kernels`` are compiled
on first use (``repro_torch.kernels._build``).
"""
