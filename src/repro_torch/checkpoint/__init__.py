"""Checkpoints of the SRAM state (port of ``repro.checkpoint``): training
steps and branch-only scenario checkpoints, in the JAX package's file
layout, so either package reads the other's files."""
