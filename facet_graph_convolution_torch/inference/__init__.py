"""Patch inference and mesh reassembly."""
