"""Model layers and assembly (the KV-cache families)."""
