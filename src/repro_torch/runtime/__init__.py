"""Fault-tolerance runtime (straggler monitor, heartbeat, retries)."""
