"""Fault-tolerance decisions of the port (``elastic``); the sharding
modules wait for multi-GPU (ROADMAP A10)."""
