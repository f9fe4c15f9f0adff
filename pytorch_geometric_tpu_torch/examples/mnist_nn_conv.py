"""NNConv (edge-conditioned convolution) on MNIST superpixels: the port's
counterpart of examples/mnist_nn_conv.py. ``NNConv(1 -> 32, aggr
"mean")`` over an edge network (Dense 25, ReLU, Dense 32) of the
Cartesian pseudo-coordinates, with an ELU; the voxel levels' max pool;
:func:`mnist_graclus.device_cartesian`; ``NNConv(32 -> 64)`` (edge network
to 32 x 64); a second pool; ``global_mean_pool``, Dense 128 (ELU, dropout
0.5) and Dense 10. Adam 0.01, batches of 64, 1000 synthetic training
samples by default.

    python -m pytorch_geometric_tpu_torch.examples.mnist_nn_conv \\
        [--epochs 3]

The step runs over mnist_graclus's operator set with each level's
``SortedSegmentSum`` over its receivers and its real edges, and level
1's over its senders (``mnist_operators(..., segment_ops=True)``): the
NNConv messages of both levels sum through the segment-sum kernel
(their backward is a gather), and so do the pools' means of ``pos`` and
the readout; conv2 gathers its input through the sender operator, whose
backward sums the input's gradient in the same kernel in a fixed order
(torch's gather backward adds with atomics): 5 segment-sum launches a
step forward and 1 in its backward, 5 an evaluation batch. The edge
network and the pseudo-coordinates of level 1 run on the card. On a
card the training step and the evaluation are each a CUDA graph over
static buffers of the loaders' budgets (``capture=None`` or ``True``;
``mnist_graclus.fit``); ``capture=False`` runs them eagerly.
"""

import argparse
import functools

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.device import resolve_device
from pytorch_geometric_tpu_torch.examples import mnist_graclus as mg
from pytorch_geometric_tpu_torch.examples import mnist_voxel_grid as mv
from pytorch_geometric_tpu_torch.models.capture import resolve_capture
from pytorch_geometric_tpu_torch.nn.conv import NNConv
from pytorch_geometric_tpu_torch.nn.layers import Dense
from pytorch_geometric_tpu_torch.nn.pool import (
    global_mean_pool, pool_graph_masked)

#: The flax names of the JAX script's edge networks (adopted by its
#: ``Net``) and the port's, for ``convert.params_from_jax(...,
#: names=FLAX_NAMES)``.
FLAX_NAMES = {"EdgeNN_0": "conv1.edge_nn", "EdgeNN_1": "conv2.edge_nn"}


class EdgeNN(nn.Module):
    """examples/mnist_nn_conv.py's ``EdgeNN``: Dense 25, ReLU, Dense
    ``out``. Flax names its layers in the order it builds them, the outer
    call first: ``Dense_0`` is the output layer, ``Dense_1`` the input
    layer."""

    def __init__(self, in_channels: int, out: int, generator=None):
        super().__init__()
        self.Dense_1 = Dense(in_channels, 25, generator=generator)
        self.Dense_0 = Dense(25, out, generator=generator)

    def forward(self, ea):
        return self.Dense_0(torch.relu(self.Dense_1(ea)))


class Net(nn.Module):
    """examples/mnist_nn_conv.py's ``Net``: ``conv1``, ``conv2`` (their
    edge networks the JAX ``EdgeNN_0`` / ``EdgeNN_1``, :data:`FLAX_NAMES`),
    ``Dense_0``, ``Dense_1``."""

    def __init__(self, num_classes: int = 10, generator=None):
        super().__init__()
        self.conv1 = NNConv(1, 32, EdgeNN(2, 1 * 32, generator), aggr="mean",
                            generator=generator)
        self.conv2 = NNConv(32, 64, EdgeNN(2, 32 * 64, generator),
                            aggr="mean", generator=generator)
        self.Dense_0 = Dense(64, 128, generator=generator)
        self.Dense_1 = Dense(128, num_classes, generator=generator)

    def forward(self, graph: Graph, *, train: bool = False, ops=None,
                generator=None):
        """``ops``: ``mnist_operators(graph, segment_ops=True)`` (required
        on a card)."""
        ops = ops or {}
        x = F.elu(self.conv1(graph, graph.x,
                             segment_op=ops.get("segment1")))
        g = pool_graph_masked(graph.extras["cluster1"], graph.replace(x=x),
                              reduce="max", segment_op=ops.get("pool1"))
        g = mg.device_cartesian(g)
        x = F.elu(self.conv2(g, g.x, segment_op=ops.get("segment2"),
                             sender_op=ops.get("senders2")))
        g = pool_graph_masked(graph.extras["cluster2"], g.replace(x=x),
                              reduce="max", segment_op=ops.get("pool2"))
        return mg.head(self, global_mean_pool(
            g.x, g, segment_op=ops.get("readout")), train, generator)


#: The operator set of a batch (``mnist_operators`` with the NNConv sums).
nn_conv_operators = functools.partial(mg.mnist_operators, segment_ops=True)


def run(epochs: int = 3, batch_size: int = 64, seed: int = 0,
        train_samples: int = 1000, device="cuda", loaders=None,
        capture=None):
    """Train and print the JAX script's line per epoch over the voxel
    levels; ``loaders`` (train, test) replaces
    ``mnist_voxel_grid.load``'s; ``capture`` as mnist_graclus's ``run``.
    Returns mnist_graclus's ``fit`` record."""
    dev = resolve_device(device)
    capture = resolve_capture(capture, dev)
    loaders = loaders or mv.load(seed, batch_size, train_samples,
                                 device=dev)
    next(iter(loaders[0]))
    model = Net(generator=torch.Generator().manual_seed(seed)).to(dev)
    return mg.fit(model, loaders, epochs, seed, dev, segment_ops=True,
                  capture=capture)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=3)
    args = p.parse_args()
    run(args.epochs)
