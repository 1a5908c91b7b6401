"""Data side of the port: the jitter spec and the eval crop."""
