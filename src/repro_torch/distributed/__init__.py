"""Distributed control-plane logic (port of ``repro.distributed``)."""
