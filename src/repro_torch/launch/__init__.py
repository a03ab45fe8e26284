"""Launchers of the port: ``repro_torch.launch.serve`` (the pod serving
driver), ``replay`` and ``train`` (the training driver)."""
