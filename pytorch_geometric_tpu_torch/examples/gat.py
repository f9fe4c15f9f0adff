"""GAT on Cora: the port's counterpart of examples/gat.py (8 heads x 8
channels, then one head of the classes; dropout 0.6 on the inputs and on
the attention; AdamW lr 5e-3, weight decay 5e-4; 200 epochs). Planetoid
-> NormalizeFeatures -> ``reorder_graph`` (RCM, for every fused backend)
-> from_data -> ``train_gat``, whose epochs run on the card as one
captured CUDA graph.

    python -m pytorch_geometric_tpu_torch.examples.gat [--dataset Cora] \\
        [--epochs 200] [--backend auto|packed|bsr|dense|none]

``--backend`` picks the fused attention operator
(``models/citation.py:gat_flash_op``): ``auto`` is ``packed``, as in the
JAX script's ``make_flash_op``; ``none``, the JAX script's plain
segment-softmax path, is refused, because no trainer of the port sums
feature rows with plain segment ops on a card. Prints the final loss and
accuracies, as the JAX script does.
"""

import argparse

from pytorch_geometric_tpu_torch.data import from_data
from pytorch_geometric_tpu_torch.datasets import Planetoid
from pytorch_geometric_tpu_torch.datasets.graphs import PLANETOID_ROOT
from pytorch_geometric_tpu_torch.models.citation import train_gat
from pytorch_geometric_tpu_torch.transforms import NormalizeFeatures
from pytorch_geometric_tpu_torch.utils.reorder import reorder_graph


def load(dataset_name: str = "Cora", backend: str = "auto",
         root=PLANETOID_ROOT, device="cuda"):
    """``(dataset, graph on device)``: Planetoid ``dataset_name`` under
    ``root``, features normalised, nodes relabelled by RCM unless
    ``backend`` is ``"none"``, collated by ``from_data``."""
    ds = Planetoid(str(root), dataset_name, transform=NormalizeFeatures())
    data = ds[0]
    if backend != "none":
        data = reorder_graph(data)
    return ds, from_data(data, device=device)


def run(dataset_name: str = "Cora", epochs: int = 200, seed: int = 0,
        backend: str = "auto", device="cuda"):
    ds, graph = load(dataset_name, backend, device=device)
    _, metrics = train_gat(graph, num_classes=ds.num_classes, epochs=epochs,
                           seed=seed, device=device, backend=backend)
    accs = {s: metrics[f"{s}_acc"] for s in ("train", "val", "test")}
    print(f"Loss: {float(metrics['curve']['loss'][-1]):.4f}  "
          f"Train: {accs['train']:.4f}, Val: {accs['val']:.4f}, "
          f"Test: {accs['test']:.4f}")
    return accs


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="Cora")
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--backend", default="auto",
                   choices=["auto", "packed", "bsr", "dense", "none"])
    args = p.parse_args()
    run(args.dataset, args.epochs, backend=args.backend)
