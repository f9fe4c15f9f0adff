"""Five small citation models on Planetoid: the port's counterpart of
examples/citation_suite.py, itself a compact mirror of the reference's
sgc.py (SGConv, K = 2, cached), agnn.py (two AGNN propagation layers),
arma.py (ARMAConv stacks), cora.py (SplineConv with TargetIndegree) and
dna.py (DNAConv over the layer history).

    python -m pytorch_geometric_tpu_torch.examples.citation_suite \\
        {agnn,arma,dna,sgc,spline} [--dataset Cora] [--epochs 200]

Each trains full-batch with the reference's hyperparameters (``MODELS``:
AdamW's learning rate and weight decay, ``torch.optim.AdamW`` being
``optax.adamw``'s update) and prints the JAX script's line. On a CUDA
device the epochs run as one captured CUDA graph
(``models/capture.py:run_epochs``; ``capture=False`` keeps the eager
loop), the counterpart of the JAX script's one ``lax.scan`` program.

Every feature-row sum runs through an operator that each model builds
once per graph on the host (``operators``), so on the card it is a kernel
of the port:

- sgc: Â² x at set-up (the reference's ``cached=True``), two ``spmm_csr``
  launches over ``gcn_edge_set``; each epoch is one matrix product;
- agnn: ``SpmmOperator(alpha, x)`` over ``agnn_edge_set`` per layer,
  the softmax's sums and the gathers' gradients by the segment-sum
  kernel (``agnn_operators``);
- arma: L̂ as a bound SpMM, one launch a layer for the three stacks;
- spline: the accumulator split by kernel index into two bound SpMMs a
  layer (``spline_operators``);
- dna: the normalised messages summed by the ``sorted_segment_sum``
  kernel, which also takes the gradients of the gathers by receiver and
  by sender (``dna_operators``).

Module and parameter names are flax's auto-names (``Dense_0``,
``AGNNConv_1``, ``ARMAConv_0``, ``SplineConv_1``, ``dna0`` ... with
``lin_q`` / ``lin_k`` / ``lin_v``), and a flax ``Dense`` keeps its kernel
(in, out) (``nn/layers.py:Dense``), so ``convert.params_from_jax`` carries
a JAX ``model.init`` tree across unchanged.
"""

import argparse
import time
from typing import Any, Dict, Optional

import torch
from torch import nn

from pytorch_geometric_tpu_torch.data import from_data
from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.datasets import Planetoid
from pytorch_geometric_tpu_torch.datasets.graphs import PLANETOID_ROOT
from pytorch_geometric_tpu_torch.device import resolve_device
from pytorch_geometric_tpu_torch.models.capture import (
    launch_counts, resolve_capture, run_epochs)
from pytorch_geometric_tpu_torch.models.citation import (
    gcn_spmm_operator, masked_accuracy, masked_softmax_xent)
from pytorch_geometric_tpu_torch.nn.conv import (
    AGNNConv, ARMAConv, DNAConv, SGConv, SplineConv, agnn_operators,
    arma_operator, dna_operators, sgc_precompute, spline_operators)
from pytorch_geometric_tpu_torch.nn.layers import Dense, dropout
from pytorch_geometric_tpu_torch.transforms import (
    NormalizeFeatures, TargetIndegree)

Gen = Optional[torch.Generator]


class SGCNet(nn.Module):

    def __init__(self, in_channels: int, num_classes: int,
                 generator: Gen = None):
        super().__init__()
        self.SGConv_0 = SGConv(in_channels, num_classes, K=2,
                               generator=generator)

    @staticmethod
    def operators(graph: Graph):
        op, w = gcn_spmm_operator(graph)
        return {"cached_x": sgc_precompute(graph, graph.x, 2, op.bind(w))}

    def forward(self, graph: Graph, x, *, train: bool = False,
                generator: Gen = None, cached_x=None):
        return self.SGConv_0(graph, x, cached_x=cached_x)


class AGNNNet(nn.Module):

    def __init__(self, in_channels: int, num_classes: int,
                 generator: Gen = None, dropout_rate: float = 0.5):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.Dense_0 = Dense(in_channels, 16, generator=generator)
        self.AGNNConv_0 = AGNNConv(requires_grad=False)
        self.AGNNConv_1 = AGNNConv(requires_grad=True)
        self.Dense_1 = Dense(16, num_classes, generator=generator)

    @staticmethod
    def operators(graph: Graph):
        return agnn_operators(graph)

    def forward(self, graph: Graph, x, *, train: bool = False,
                generator: Gen = None, **ops):
        x = dropout(x, self.dropout_rate, train, generator)
        x = torch.relu(self.Dense_0(x))
        x = self.AGNNConv_0(graph, x, **ops)
        x = self.AGNNConv_1(graph, x, **ops)
        x = dropout(x, self.dropout_rate, train, generator)
        return self.Dense_1(x)


class ARMANet(nn.Module):

    def __init__(self, in_channels: int, num_classes: int,
                 generator: Gen = None, dropout_rate: float = 0.5,
                 conv_dropout: float = 0.25):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.ARMAConv_0 = ARMAConv(in_channels, 16, num_stacks=3,
                                   num_layers=2, shared_weights=True,
                                   dropout=conv_dropout, generator=generator)
        self.ARMAConv_1 = ARMAConv(16, num_classes, num_stacks=3,
                                   num_layers=2, shared_weights=True,
                                   dropout=conv_dropout,
                                   act=lambda v: v, generator=generator)

    @staticmethod
    def operators(graph: Graph):
        return {"lap_fn": arma_operator(graph)}

    def forward(self, graph: Graph, x, *, train: bool = False,
                generator: Gen = None, lap_fn=None):
        x = self.ARMAConv_0(graph, x, train=train, generator=generator,
                            lap_fn=lap_fn)
        x = dropout(torch.relu(x), self.dropout_rate, train, generator)
        return self.ARMAConv_1(graph, x, train=train, generator=generator,
                               lap_fn=lap_fn)


class SplineNet(nn.Module):

    def __init__(self, in_channels: int, num_classes: int,
                 generator: Gen = None, dropout_rate: float = 0.5):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.SplineConv_0 = SplineConv(in_channels, 16, dim=1,
                                       kernel_size=2, generator=generator)
        self.SplineConv_1 = SplineConv(16, num_classes, dim=1,
                                       kernel_size=2, generator=generator)

    @staticmethod
    def operators(graph: Graph):
        return {"spline_fns": spline_operators(graph, dim=1, kernel_size=2)}

    def forward(self, graph: Graph, x, *, train: bool = False,
                generator: Gen = None, spline_fns=None):
        x = self.SplineConv_0(graph, x, spline_fns=spline_fns)
        x = dropout(torch.nn.functional.elu(x), self.dropout_rate, train,
                    generator)
        return self.SplineConv_1(graph, x, spline_fns=spline_fns)


class DNANet(nn.Module):

    def __init__(self, in_channels: int, num_classes: int,
                 generator: Gen = None, dropout_rate: float = 0.5,
                 hidden: int = 128, num_layers: int = 4, heads: int = 8,
                 groups: int = 16):
        super().__init__()
        self.dropout_rate, self.num_layers = dropout_rate, num_layers
        self.Dense_0 = Dense(in_channels, hidden, generator=generator)
        for i in range(num_layers):
            setattr(self, f"dna{i}", DNAConv(hidden, heads=heads,
                                             groups=groups, dropout=0.0,
                                             generator=generator))
        self.Dense_1 = Dense(hidden, num_classes, generator=generator)

    @staticmethod
    def operators(graph: Graph):
        return dna_operators(graph)

    def forward(self, graph: Graph, x, *, train: bool = False,
                generator: Gen = None, **ops):
        x = torch.relu(self.Dense_0(x))
        x = dropout(x, self.dropout_rate, train, generator)
        x_all = x[:, None, :]
        for i in range(self.num_layers):
            h = getattr(self, f"dna{i}")(graph, x_all, train=train,
                                         generator=generator, **ops)
            x_all = torch.cat([x_all, torch.relu(h)[:, None, :]], dim=1)
        x = dropout(x_all[:, -1], self.dropout_rate, train, generator)
        return self.Dense_1(x)


MODELS = {
    "sgc": (SGCNet, dict(lr=0.1, wd=5e-6)),
    "agnn": (AGNNNet, dict(lr=0.01, wd=5e-4)),
    "arma": (ARMANet, dict(lr=0.01, wd=5e-4)),
    "spline": (SplineNet, dict(lr=0.01, wd=5e-4)),
    "dna": (DNANet, dict(lr=5e-3, wd=5e-4)),
}


def load(model_name: str, dataset_name: str = "Cora", root=PLANETOID_ROOT,
         device="cuda"):
    """``(dataset, graph on device)``: Planetoid ``dataset_name`` under
    ``root``, features normalised, ``TargetIndegree`` pseudo-coordinates
    for ``"spline"``, collated by ``from_data``."""
    ds = Planetoid(str(root), dataset_name, transform=NormalizeFeatures())
    data = ds[0]
    if model_name == "spline":
        data = TargetIndegree()(data)
    return ds, from_data(data, device=device)


def create_train_step(model: nn.Module, graph: Graph, lr: float,
                      weight_decay: float, ops: Dict[str, Any]):
    """``(epoch_step, eval_fn)`` over a static graph and the model's
    operators ``ops``, as ``models/citation.py:create_gat_train_step``:
    one AdamW step on the masked cross-entropy of the full logits, built
    with ``capturable=True`` on a CUDA graph, gradients zeroed in place;
    the dropout masks drawn from the step's generator. ``eval_fn`` gives
    the train / val / test accuracies."""
    opt = torch.optim.AdamW(model.parameters(), lr=lr,
                            weight_decay=weight_decay,
                            capturable=graph.device.type == "cuda")

    def epoch_step(generator: Gen = None):
        model.train()
        opt.zero_grad(set_to_none=False)
        logits = model(graph, graph.x, train=True, generator=generator,
                       **ops)
        loss = masked_softmax_xent(logits, graph.y, graph.train_mask)
        loss.backward()
        opt.step()
        return {"loss": loss.detach(),
                "train_acc": masked_accuracy(logits.detach(), graph.y,
                                             graph.train_mask)}

    @torch.no_grad()
    def eval_fn():
        model.eval()
        logits = model(graph, graph.x, **ops)
        return {f"{s}_acc": masked_accuracy(logits, graph.y,
                                            getattr(graph, f"{s}_mask"))
                for s in ("train", "val", "test")}

    return epoch_step, eval_fn


def train_suite(model_name: str, graph: Graph, num_classes: int,
                epochs: int = 200, seed: int = 0, device="cuda",
                capture: Optional[bool] = None):
    """The model's full training run on ``device``: its operators built
    once (``setup_seconds``; the kernels they launch, SGC's propagation,
    in ``setup_launches``), then ``epochs`` AdamW steps and one
    evaluation through ``run_epochs`` (captured by default on a CUDA
    device; the metrics of ``models/citation.py:train_gcn``). Returns
    ``(model, metrics)``. Kernel launches on a CUDA graph, per epoch and
    for the evaluation: sgc none (2 ``spmm_csr`` at set-up); agnn 4 and 2
    ``spmm_csr``, 8 and 2 ``sorted_segment_sum``; arma 8 and 4
    ``spmm_csr``; spline 6 and 4; dna 12 and 4 ``sorted_segment_sum``."""
    dev = resolve_device(device)
    capture = resolve_capture(capture, dev)
    graph = graph.to(dev)
    cls, hp = MODELS[model_name]
    model = cls(graph.num_node_features, num_classes,
                generator=torch.Generator().manual_seed(seed)).to(dev)
    before = launch_counts()
    t0 = time.perf_counter()
    ops = cls.operators(graph)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_seconds = time.perf_counter() - t0
    setup = {k: v - before[k] for k, v in launch_counts().items()
             if v != before[k]}
    epoch_step, eval_fn = create_train_step(model, graph, hp["lr"],
                                            hp["wd"], ops)
    drop_gen = torch.Generator(device=dev).manual_seed(seed)
    metrics = run_epochs(epoch_step, eval_fn, epochs, drop_gen, dev,
                         capture)
    metrics.update(setup_seconds=setup_seconds, setup_launches=setup)
    return model, metrics


def run(model_name: str, dataset_name: str = "Cora", epochs: int = 200,
        seed: int = 0, device="cuda"):
    ds, graph = load(model_name, dataset_name, device=device)
    _, metrics = train_suite(model_name, graph, ds.num_classes,
                             epochs=epochs, seed=seed, device=device)
    losses = metrics["curve"]["loss"]
    accs = {s: metrics[f"{s}_acc"] for s in ("train", "val", "test")}
    print(f"[{model_name}/{dataset_name}] loss {float(losses[-1]):.4f} "
          f"train {accs['train']:.4f} val {accs['val']:.4f} "
          f"test {accs['test']:.4f}")
    return accs


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("model", choices=sorted(MODELS))
    p.add_argument("--dataset", default="Cora")
    p.add_argument("--epochs", type=int, default=200)
    args = p.parse_args()
    run(args.model, args.dataset, args.epochs)
