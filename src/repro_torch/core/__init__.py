"""Spherical geometry, SRoI prediction, accuracy estimation,
allocation and the per-frame loop (port of ``repro.core``)."""
