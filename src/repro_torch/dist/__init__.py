"""Decode attention across cache slabs and page pools (local branches)."""
