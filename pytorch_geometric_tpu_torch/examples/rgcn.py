"""RGCN on Entities / MUTAG-RDF: the port's counterpart of
examples/rgcn.py (two RGCN layers, 30 bases, 16 hidden, node-id
features, Adam lr 0.01, 50 epochs; train and test over the labelled
entities). Entities("MUTAG") -> from_data -> ``train_rgcn``, every
aggregation through the fused operator, the epochs on the card as one
captured CUDA graph.

    python -m pytorch_geometric_tpu_torch.examples.rgcn [--epochs 50]

Prints the final loss and the test accuracy, as the JAX script does.
"""

import argparse

from pytorch_geometric_tpu_torch.data import from_data
from pytorch_geometric_tpu_torch.datasets import Entities
from pytorch_geometric_tpu_torch.datasets.graphs import PLANETOID_ROOT
from pytorch_geometric_tpu_torch.models.entities import train_rgcn


def load(root=PLANETOID_ROOT, device="cuda"):
    """``(dataset, graph on device)``: ``Entities(root, "MUTAG")`` at its
    default scale, as the JAX script builds it, collated by
    ``from_data``."""
    ds = Entities(str(root), "MUTAG")
    return ds, from_data(ds[0], device=device)


def run(epochs: int = 50, seed: int = 0, device="cuda"):
    ds, graph = load(device=device)
    _, metrics = train_rgcn(graph, ds.num_relations, ds.num_classes,
                            epochs=epochs, seed=seed, device=device)
    acc = metrics["test_acc"]
    print(f"Loss: {float(metrics['curve']['loss'][-1]):.4f}, "
          f"Test Acc: {acc:.4f}")
    return acc


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=50)
    args = p.parse_args()
    run(args.epochs)
