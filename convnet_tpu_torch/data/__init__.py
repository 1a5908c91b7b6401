"""Data side of the port: the jitter spec, crops and flips, and the
host-side DataHandler."""
