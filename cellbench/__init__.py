"""The port's benchmark: cells of a configuration under a traffic mix,
each run by `python3 -m cellbench.run` (see run.py and harness.py)."""
