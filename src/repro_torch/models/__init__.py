"""Model layers and assembly (dense family)."""
