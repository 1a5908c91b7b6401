"""Tools of the port, `python -m convnet_tpu_torch.tools.<name>`: the data
tools (counterparts of the repo's `tools/*.py` that read or write HDF5, on
the port's own HDF5 module, with the arguments of the script of the same
name under `tools/`), and the measurement scripts on the card
(`bench_pipeline`, `profile_alexnet`, `sweep`; with `--device cpu` on the
CPU)."""
