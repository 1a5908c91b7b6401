"""Data-preparation tools of the port (counterparts of the repo's
`tools/*.py` that read or write HDF5), on the port's own HDF5 module:
`python -m convnet_tpu_torch.tools.<name>` with the arguments of the
script of the same name under `tools/`."""
