"""Decode attention across cache slabs (single-slab branch)."""
