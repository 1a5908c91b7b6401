"""The model zoo: typed constructors over the examples/ pbtxts, each
returning the port's `Graph` (counterpart of `convnet_tpu.models`)."""

from convnet_tpu_torch.models.zoo import (  # noqa: F401
    alexnet,
    alexnet_2tower,
    alexnet_local,
    cifar10,
    cifar10_local,
    from_pbtxt,
    googlenet,
    mnist_lenet,
)
