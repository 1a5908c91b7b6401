"""Utilities: wall-clock timers, named spans and torch.profiler capture
(counterpart of `convnet_tpu/utils/`), and the card a measurement runs on
(`card`)."""

from convnet_tpu_torch.utils.timers import Timer  # noqa: F401
