"""Latency model, inference backends and batching (port of
``repro.serving``)."""
