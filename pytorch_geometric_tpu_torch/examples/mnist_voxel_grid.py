"""SplineConv and voxel-grid pooling on MNIST superpixels: the port's
counterpart of examples/mnist_voxel_grid.py. The model, the step and the
operators are examples/mnist_graclus.py's; the coarsening levels are
voxel grids of cell sizes 5 and 10, precomputed per sample at load time
(:class:`PrecomputeVoxelLevels`).

    python -m pytorch_geometric_tpu_torch.examples.mnist_voxel_grid \\
        [--epochs 3]
"""

import argparse

import numpy as np
import torch

from pytorch_geometric_tpu_torch.cluster import voxel_grid
from pytorch_geometric_tpu_torch.datasets.graphs import PLANETOID_ROOT
from pytorch_geometric_tpu_torch.device import resolve_device
from pytorch_geometric_tpu_torch.examples import mnist_graclus as mg
from pytorch_geometric_tpu_torch.transforms import Cartesian, Compose

#: The JAX script's dataset root, beside the graclus script's.
VOXEL_ROOT = PLANETOID_ROOT.parent / "datasets_cache_voxel"


class PrecomputeVoxelLevels:
    """cluster{k} fields from voxel grids of growing cell size. Cluster
    ids are representative node ids (the first member), keeping the
    batching-offset convention."""

    def __init__(self, sizes=(5.0, 10.0)):
        self.sizes = sizes

    def __call__(self, data):
        rep = np.arange(data.num_nodes, dtype=np.int64)
        for k, size in enumerate(self.sizes, start=1):
            cell = voxel_grid(data.pos, size=size)
            cell = cell[rep]  # cell of each node's current representative
            # representative = first node (lowest id) in each cell
            order = np.lexsort((np.arange(len(cell)), cell))
            first_of = {}
            for i in order:
                first_of.setdefault(int(cell[i]), int(i))
            rep = np.asarray([first_of[int(c)] for c in cell],
                             dtype=np.int64)
            setattr(data, f"cluster{k}", rep.copy())
        return data


def load(seed: int = 0, batch_size: int = 64, train_samples: int = 1500,
         root=VOXEL_ROOT, device="cuda"):
    """``(train loader, test loader)`` of the JAX script: mnist_graclus's,
    through ``Compose([Cartesian(), PrecomputeVoxelLevels()])``."""
    return mg.load(seed, batch_size, train_samples, root,
                   Compose([Cartesian(), PrecomputeVoxelLevels()]), device)


def run(epochs: int = 3, batch_size: int = 64, seed: int = 0,
        train_samples: int = 1500, device="cuda", loaders=None):
    """Train mnist_graclus's ``Net`` over the voxel levels and print the
    JAX script's line per epoch; ``loaders`` (train, test) replaces
    :func:`load`'s. Returns mnist_graclus's ``fit`` record."""
    dev = resolve_device(device)
    loaders = loaders or load(seed, batch_size, train_samples, device=dev)
    next(iter(loaders[0]))
    model = mg.Net(generator=torch.Generator().manual_seed(seed)).to(dev)
    return mg.fit(model, loaders, epochs, seed, dev, mg.mnist_operators)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=3)
    args = p.parse_args()
    run(args.epochs)
