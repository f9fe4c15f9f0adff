"""GCN on Cora: the port's counterpart of examples/gcn.py (2-layer GCN,
hidden 16, dropout 0.5, Adam lr 0.01 with weight decay 5e-4 on the first
layer, 200 epochs). Planetoid -> NormalizeFeatures -> from_data ->
``train_gcn``, whose epochs run on the card as one captured CUDA graph.

    python -m pytorch_geometric_tpu_torch.examples.gcn [--dataset Cora] \\
        [--epochs 200]

Prints the loss every tenth of the run and the final accuracies, as the
JAX script does.
"""

import argparse

from pytorch_geometric_tpu_torch.data import from_data
from pytorch_geometric_tpu_torch.datasets import Planetoid
from pytorch_geometric_tpu_torch.datasets.graphs import PLANETOID_ROOT
from pytorch_geometric_tpu_torch.models.citation import train_gcn
from pytorch_geometric_tpu_torch.transforms import NormalizeFeatures


def load(dataset_name: str = "Cora", root=PLANETOID_ROOT, device="cuda"):
    """``(dataset, graph on device)``: Planetoid ``dataset_name`` under
    ``root``, features normalised, collated by ``from_data``."""
    ds = Planetoid(str(root), dataset_name, transform=NormalizeFeatures())
    return ds, from_data(ds[0], device=device)


def run(dataset_name: str = "Cora", epochs: int = 200, seed: int = 0,
        device="cuda"):
    ds, graph = load(dataset_name, device=device)
    _, metrics = train_gcn(graph, num_classes=ds.num_classes, epochs=epochs,
                           seed=seed, device=device)
    curve = metrics["curve"]["loss"]
    for e in range(0, epochs, max(epochs // 10, 1)):
        print(f"Epoch {e:03d}  loss {curve[e]:.4f}")
    print(f"Train: {metrics['train_acc']:.4f}, "
          f"Val: {metrics['val_acc']:.4f}, "
          f"Test: {metrics['test_acc']:.4f}")
    return metrics


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="Cora")
    p.add_argument("--epochs", type=int, default=200)
    args = p.parse_args()
    run(args.dataset, args.epochs)
