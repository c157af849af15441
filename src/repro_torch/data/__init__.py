"""Synthetic, stateless data pipelines (port of ``repro.data``)."""
