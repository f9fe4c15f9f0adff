"""PointNet++ classification on ModelNet10: the port's counterpart of
examples/pointnet2.py (NormalizeScale and SamplePoints(128), two
fps / radius set-abstraction levels with ``PointConv``, a global max pool,
Dense 256 (ReLU) and Dense 10). Adam 1e-3, batches of 16 shuffled from
``seed``, 12 synthetic samples a class, test accuracy after each epoch.

    python -m pytorch_geometric_tpu_torch.examples.pointnet2 [--epochs 3]

The neighbourhoods depend only on the points, so they are computed per
sample at load time into index fields of fixed budgets
(:class:`PrecomputeSetAbstraction`, the JAX script's). A batch's fields
arrive stacked (graphs, budget) and offset by each graph's first node;
the padding entries point at a graph's node 0 and are masked. Every
reduction of this path is a maximum (``PointConv``'s and the readout's,
torch's ``scatter_reduce``, as neither package has a segment-max kernel).
The second level gathers its input by sender through a
``SortedSegmentSum`` over the batch's real level-2 neighbourhood entries
(:func:`pointnet2_operators`, built on the host): its gradient then sums
in the segment-sum kernel in a fixed order (one launch a training step;
torch's gather backward adds with atomics in an order that varies from
run to run, so two runs of one step would differ), and the path launches
no other kernel of the port.

The JAX script jits its training step and its evaluation once over the
loaders' static budget. Here, on a card, each is a CUDA graph captured
once (``models/capture.py:CapturedStep``, ``capture=None`` or ``True``)
over static buffers of its loader's budget (:func:`static_batch`: the
graph, its index fields included, and the static form of the level-2
gather's operator). Each batch,
the last one too, is collated on the host at the loader's budget (its
missing graphs are padding, masked by ``graph_mask``), copied in, and the
graph replays; Adam keeps its step count on the card; each step's loss
and each test batch's correct and total counts stay in device buffers
until the epoch ends (``models/capture.py:StepLoop``). ``capture=False``
runs the same steps eagerly over each batch's own tensors (the CPU's only
mode).
"""

import argparse
import functools
import time

import numpy as np
import torch
from torch import nn

from pytorch_geometric_tpu_torch.cluster import fps, radius
from pytorch_geometric_tpu_torch.data import DataLoader
from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.datasets import ModelNet
from pytorch_geometric_tpu_torch.datasets.graphs import PLANETOID_ROOT
from pytorch_geometric_tpu_torch.device import resolve_device
from pytorch_geometric_tpu_torch.models.capture import (
    StaticBatch, StepLoop, resolve_capture)
from pytorch_geometric_tpu_torch.models.graph_pred import graph_xent_loss
from pytorch_geometric_tpu_torch.nn.conv import PointConv
from pytorch_geometric_tpu_torch.nn.layers import Dense
from pytorch_geometric_tpu_torch.nn.pool import global_max_pool
from pytorch_geometric_tpu_torch.ops.sorted_spmm import (
    SortedSegmentSum, StaticSegmentSum)
from pytorch_geometric_tpu_torch.transforms import (
    Compose, NormalizeScale, SamplePoints)

N_POINTS = 128
SA1_K, SA1_R, SA1_RATIO = 32, 0.4, 0.5
SA2_K, SA2_R, SA2_RATIO = 32, 0.6, 0.25
#: The JAX script's dataset root.
PN2_ROOT = PLANETOID_ROOT.parent / "datasets_cache_pn2"
#: The Dense layers of examples/pointnet2.py's ``Net`` in its flax order:
#: the two set-abstraction MLPs (``_mlp``, whose layers flax creates in
#: the ``Net``'s scope: ``Dense_0`` .. ``Dense_5``), then the head
#: (``Dense_6``, ``Dense_7``); (in, out) each.
SA1_MLP = ((3, 64), (64, 64), (64, 128))
SA2_MLP = ((128 + 3, 128), (128, 128), (128, 256))


class PrecomputeSetAbstraction:
    """fps + radius neighbourhoods as padded index fields.

    Stores, per level: sampled node ids (``cluster_sa{k}_idx``, in the
    original node id space, so batching offsets them) with their mask,
    and neighbourhood edges (``cluster_sa{k}_src`` / ``_dst``, also node
    ids) padded to fixed budgets with a mask.
    """

    def __call__(self, data):
        pos = data.pos
        idx_space = np.arange(data.num_nodes)
        cur_idx = idx_space
        for lvl, (k, r, ratio) in enumerate(
                [(SA1_K, SA1_R, SA1_RATIO), (SA2_K, SA2_R, SA2_RATIO)],
                start=1):
            p = pos[cur_idx]
            sel = fps(p, ratio=ratio, random_start=False)
            row, col = radius(p, p[sel], r=r, max_num_neighbors=k)
            budget_sel = int(np.ceil(ratio * N_POINTS))
            budget_e = budget_sel * k
            # pad: selected ids (global node ids)
            sel_g = cur_idx[sel]
            sel_pad = np.zeros(budget_sel, dtype=np.int64)
            sel_pad[: len(sel_g)] = sel_g
            sel_mask = np.zeros(budget_sel, dtype=bool)
            sel_mask[: len(sel_g)] = True
            src = np.zeros(budget_e, dtype=np.int64)
            dst = np.zeros(budget_e, dtype=np.int64)
            em = np.zeros(budget_e, dtype=bool)
            m = min(len(row), budget_e)
            src[:m] = cur_idx[col[:m]]        # neighbor: global node id
            dst[:m] = sel_g[row[:m]]          # center:   global node id
            em[:m] = True
            setattr(data, f"cluster_sa{lvl}_idx", sel_pad)
            setattr(data, f"sa{lvl}_sel_mask", sel_mask)
            setattr(data, f"cluster_sa{lvl}_src", src)
            setattr(data, f"cluster_sa{lvl}_dst", dst)
            setattr(data, f"sa{lvl}_edge_mask", em)
            cur_idx = sel_g
        return data


class Net(nn.Module):
    """examples/pointnet2.py's ``Net``, with its flax parameter names
    (``Dense_0`` .. ``Dense_7``, :data:`SA1_MLP`, :data:`SA2_MLP`), so that
    ``convert.params_from_jax`` carries the parameters across: each
    ``PointConv``'s ``local_nn`` is three of them, each with a ReLU."""

    def __init__(self, num_classes: int = 10, generator=None):
        super().__init__()
        widths = SA1_MLP + SA2_MLP + ((256, 256), (256, num_classes))
        for i, (c_in, c_out) in enumerate(widths):
            setattr(self, f"Dense_{i}", Dense(c_in, c_out,
                                              generator=generator))
        self.sa1 = PointConv(local_nn=functools.partial(self._mlp, 0))
        self.sa2 = PointConv(local_nn=functools.partial(self._mlp, 3))

    def _mlp(self, first: int, x):
        for i in range(first, first + 3):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
        return x

    def forward(self, graph: Graph, sender_op=None):
        """``sender_op``: :func:`pointnet2_operators`' level-2 gather
        (None: torch's gather)."""
        N = graph.num_nodes
        pos = graph.pos
        # per-graph index fields arrive stacked (G, budget); flatten:
        # entries already carry the batch node offset, pads are masked
        ex = {k: v.reshape(-1) for k, v in graph.extras.items()
              if k.startswith(("cluster_sa", "sa"))}
        h = self.sa1(None, pos, ex["cluster_sa1_src"],
                     ex["cluster_sa1_dst"], N,
                     edge_mask=ex["sa1_edge_mask"])
        # h is indexed by global node id (centers only are valid)
        h = self.sa2(h, pos, ex["cluster_sa2_src"], ex["cluster_sa2_dst"],
                     N, edge_mask=ex["sa2_edge_mask"], sender_op=sender_op)
        # the level-2 centers: a scatter-max of their mask (.at[].max)
        center = torch.zeros(N, dtype=torch.int32, device=pos.device)
        center = center.scatter_reduce(
            0, ex["cluster_sa2_idx"].long(),
            ex["sa2_sel_mask"].to(torch.int32), "amax") > 0
        g = graph.replace(x=h, node_mask=center & graph.node_mask)
        out = torch.relu(self.Dense_6(global_max_pool(h, g)))
        return self.Dense_7(out)


def loss_of(logits, graph: Graph):
    """The JAX script's loss: cross-entropy over the real graphs."""
    return graph_xent_loss(logits, graph.y, graph.graph_mask)


def pointnet2_operators(graph: Graph):
    """``{"sender_op"}`` of a batch on its device, built on the host: the
    ``SortedSegmentSum`` over the level-2 neighbourhoods' senders, its
    real entries only (``sa2_edge_mask``: a masked entry's message is
    replaced before the max, so its gradient is 0)."""
    ex = graph.extras
    return {"sender_op": SortedSegmentSum(
        ex["cluster_sa2_src"].reshape(-1), graph.num_nodes,
        entry_mask=ex["sa2_edge_mask"].reshape(-1), device=graph.device)}


def train_step(model: Net, opt, graph: Graph, ops=None):
    """One Adam step on one batch over its :func:`pointnet2_operators`
    (None: torch's gather), the gradients zeroed in place (a captured
    step keeps them); the loss stays on the device."""
    opt.zero_grad(set_to_none=False)
    loss = loss_of(model(graph, **(ops or {})), graph)
    loss.backward()
    opt.step()
    return loss.detach()


def counts_of(model: Net, graph: Graph, ops):
    """``(correct, total)`` of the argmax over the batch's real graphs
    over ``ops`` (``{}``: torch's gather), as device scalars (the JAX
    script's ``eval_step``)."""
    with torch.no_grad():
        pred = model(graph, **ops).argmax(dim=1)
    m = graph.graph_mask
    return ((pred == graph.y.long()) & m).sum(), m.sum()


def static_batch(loader: DataLoader, device, sender_op: bool = True
                 ) -> StaticBatch:
    """The static buffers of ``loader``'s budget on ``device``: its graph,
    the set-abstraction index fields included, and, with ``sender_op``,
    the static form of :func:`pointnet2_operators` (a slot for each
    level-2 neighbourhood entry of the budget's graphs)."""
    ops = {}
    if sender_op:
        entries = loader.num_graphs * len(loader.dataset[0].cluster_sa2_src)
        ops["sender_op"] = StaticSegmentSum(loader.num_nodes, entries,
                                            device=device)
    return StaticBatch(loader, ops, device)


def step_loop(model: Net, opt, loaders, epochs: int, dev,
              capture: bool = False) -> StepLoop:
    """The run's :class:`StepLoop`: the training step over each batch's
    :func:`pointnet2_operators` (built anew each batch: a shuffled batch
    seldom repeats) and the evaluation over torch's gather (it takes no
    gradient, and its forward is the same gather), captured over
    :func:`static_batch` es of both loaders if ``capture``."""
    statics = (static_batch(loaders[0], dev),
               static_batch(loaders[1], dev, sender_op=False)) \
        if capture else None
    return StepLoop(loaders, (lambda idx, graph: pointnet2_operators(graph),
                              lambda idx, graph: {}),
                    lambda graph, ops: train_step(model, opt, graph, ops),
                    lambda graph, ops: counts_of(model, graph, ops),
                    epochs, dev, capture, statics)


def load(seed: int = 0, batch_size: int = 16, samples_per_class: int = 12,
         root=PN2_ROOT, device="cuda"):
    """``(train loader, test loader)`` of the JAX script: ModelNet10
    under ``root`` through ``Compose([NormalizeScale(),
    SamplePoints(N_POINTS), PrecomputeSetAbstraction()])``, the train
    loader shuffled from ``seed``."""
    pre = Compose([NormalizeScale(), SamplePoints(N_POINTS),
                   PrecomputeSetAbstraction()])
    train_ds = ModelNet(str(root), "10", train=True, pre_transform=pre,
                        samples_per_class=samples_per_class)
    test_ds = ModelNet(str(root), "10", train=False, pre_transform=pre,
                       samples_per_class=samples_per_class)
    return (DataLoader(train_ds, batch_size=batch_size, shuffle=True,
                       seed=seed, device=device),
            DataLoader(test_ds, batch_size=batch_size, device=device))


def run(epochs: int = 3, batch_size: int = 16, seed: int = 0,
        samples_per_class: int = 12, device="cuda", loaders=None,
        capture=None):
    """Train and print the JAX script's line per epoch; ``loaders``
    (train, test) replaces :func:`load`'s. ``capture`` (see the module
    docstring) None means captured on a card and eager on the CPU; True
    elsewhere than a card raises. Returns the last test accuracy, the
    mean loss of each epoch, every step's loss, the run's seconds and the
    model; a captured run adds what
    ``models/capture.py:captured_metrics`` gives."""
    dev = resolve_device(device)
    capture = resolve_capture(capture, dev)
    loaders = loaders or load(seed, batch_size, samples_per_class,
                              device=dev)
    next(iter(loaders[0]))
    model = Net(generator=torch.Generator().manual_seed(seed)).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3,
                           capturable=dev.type == "cuda")
    loop = step_loop(model, opt, loaders, epochs, dev, capture)
    epoch_losses, step_losses = [], []
    t0 = time.perf_counter()
    for epoch in range(1, epochs + 1):
        losses, (correct, total) = loop.epoch()
        acc = correct / max(total, 1.0)
        step_losses.append(losses)
        epoch_losses.append(float(np.mean(losses)))
        print(f"Epoch {epoch:02d}, Loss: {np.mean(losses):.4f}, "
              f"Test Acc: {acc:.4f}")
    return {"acc": acc, "epoch_losses": epoch_losses,
            "step_losses": np.stack(step_losses),
            "seconds": time.perf_counter() - t0, "model": model,
            **loop.metrics()}


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=3)
    args = p.parse_args()
    run(args.epochs)
