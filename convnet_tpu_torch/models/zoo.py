"""Typed constructors over the examples/ pbtxt zoo (counterpart of
`convnet_tpu/models/zoo.py`): each reads its example pbtxt, which stays
the source of truth, into the port's `Graph`."""

from __future__ import annotations

import os
from typing import Dict, Optional

from convnet_tpu_torch import config
from convnet_tpu_torch.graph import Graph, build_graph

_EXAMPLES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "examples",
)


def from_pbtxt(path: str, input_image_sizes: Optional[Dict[str, int]] = None) -> Graph:
    """Compile any model pbtxt into a Graph."""
    return build_graph(config.read_model(path), input_image_sizes)


def _example(rel: str, image_size: Optional[int] = None) -> Graph:
    sizes = {"input": image_size} if image_size else None
    return from_pbtxt(os.path.join(_EXAMPLES, rel), sizes)


def mnist_lenet(image_size: Optional[int] = None) -> Graph:
    """MNIST LeNet-class convnet."""
    return _example("mnist/mnist_lenet.pbtxt", image_size)


def cifar10(image_size: Optional[int] = None) -> Graph:
    """CIFAR-10 conv / max pool / LRN / dropout net."""
    return _example("cifar10/cifar10_conv.pbtxt", image_size)


def cifar10_local(image_size: Optional[int] = None) -> Graph:
    """CIFAR-10 with locally connected (untied) late layers."""
    return _example("cifar10/cifar10_local.pbtxt", image_size)


def alexnet(image_size: Optional[int] = None) -> Graph:
    """ImageNet AlexNet."""
    return _example("imagenet/alexnet.pbtxt", image_size)


def alexnet_local(image_size: Optional[int] = None) -> Graph:
    """AlexNet with an untied-weight LOCAL conv4."""
    return _example("imagenet/alexnet_local.pbtxt", image_size)


def alexnet_2tower(image_size: Optional[int] = None) -> Graph:
    """The two-tower AlexNet: conv2, conv4 and conv5 as grouped convs
    (num_groups: 2). Its `parallel { data: 4 model: 2 }` puts one tower on
    each rank of the model axis; on one device both towers run there."""
    return _example("imagenet/alexnet_2tower.pbtxt", image_size)


def googlenet(image_size: Optional[int] = None) -> Graph:
    """GoogLeNet (Inception v1, arXiv:1409.4842) at Table 1's widths, with
    its two auxiliary heads: CONCAT joins, AVGPOOL edges and loss weights,
    the port's schema only."""
    return _example("imagenet/port/googlenet.pbtxt", image_size)
