"""Utilities: wall-clock timers and torch.profiler capture (counterpart
of `convnet_tpu/utils/`)."""

from convnet_tpu_torch.utils.timers import Timer, profile_trace  # noqa: F401
