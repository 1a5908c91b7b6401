"""Ops of the port: NHWC tensors in and out, as in `convnet_tpu.ops`."""
