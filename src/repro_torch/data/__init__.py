"""Synthetic 360-degree scenes and the training data pipeline (port of
``repro.data``)."""
