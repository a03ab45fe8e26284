"""Synthetic 360-degree scenes (port of ``repro.data``)."""
