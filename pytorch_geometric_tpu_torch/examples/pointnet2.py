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
torch's ``scatter_reduce``, as neither package has a segment-max kernel),
so it launches no kernel of the port.
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
from pytorch_geometric_tpu_torch.models.graph_pred import graph_xent_loss
from pytorch_geometric_tpu_torch.nn.conv import PointConv
from pytorch_geometric_tpu_torch.nn.layers import Dense
from pytorch_geometric_tpu_torch.nn.pool import global_max_pool
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

    def forward(self, graph: Graph):
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
                     N, edge_mask=ex["sa2_edge_mask"])
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


def train_step(model: Net, opt, graph: Graph):
    """One Adam step on one batch; the loss stays on the device."""
    opt.zero_grad(set_to_none=True)
    loss = loss_of(model(graph), graph)
    loss.backward()
    opt.step()
    return loss.detach()


def evaluate(model: Net, loader: DataLoader):
    """Accuracy of the argmax over the loader's real graphs."""
    correct = total = 0
    with torch.no_grad():
        for graph in loader:
            pred = model(graph).argmax(dim=1)
            m = graph.graph_mask
            correct += int(((pred == graph.y.long()) & m).sum())
            total += int(m.sum())
    return correct / max(total, 1)


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
        samples_per_class: int = 12, device="cuda", loaders=None):
    """Train and print the JAX script's line per epoch; ``loaders``
    (train, test) replaces :func:`load`'s. Returns the last test
    accuracy, the mean loss of each epoch, every step's loss and the
    run's seconds."""
    dev = resolve_device(device)
    train_loader, test_loader = loaders or load(seed, batch_size,
                                                samples_per_class,
                                                device=dev)
    next(iter(train_loader))
    model = Net(generator=torch.Generator().manual_seed(seed)).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    epoch_losses, step_losses = [], []
    t0 = time.perf_counter()
    for epoch in range(1, epochs + 1):
        losses = [train_step(model, opt, graph) for graph in train_loader]
        acc = evaluate(model, test_loader)
        losses = torch.stack(losses).cpu().numpy()
        step_losses.append(losses)
        epoch_losses.append(float(np.mean(losses)))
        print(f"Epoch {epoch:02d}, Loss: {np.mean(losses):.4f}, "
              f"Test Acc: {acc:.4f}")
    return {"acc": acc, "epoch_losses": epoch_losses,
            "step_losses": np.stack(step_losses),
            "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=3)
    args = p.parse_args()
    run(args.epochs)
