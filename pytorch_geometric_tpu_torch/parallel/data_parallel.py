"""Data parallelism over graph shards.

Counterpart of ``pytorch_geometric_tpu/parallel/data_parallel.py``
(reference: ``torch_geometric.nn.DataParallel``, examples/
data_parallel.py:8,37). A list of graphs is split round-robin into one
padded, collated shard per rank (:func:`shard_data_list`); every rank
runs the same step on its own shard with the parameters replicated, and
the gradients and the loss are averaged over the ranks, as the JAX
trainer's ``pmean`` does. The average adds the ranks' values in rank
order (``mesh.ordered_sum``), so every rank applies the same bits and
two runs repeat bitwise; with one rank it is the identity.
"""

from typing import Callable, List, Sequence

import torch
import torch.distributed as dist

from pytorch_geometric_tpu_torch.data.batch import collate
from pytorch_geometric_tpu_torch.data.data import Data
from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.parallel.mesh import ordered_sum


def _stack(values):
    first = values[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(values)
    return first


def stack_graphs(graphs: Sequence[Graph]) -> Graph:
    """Identically shaped padded Graphs stacked along a new leading shard
    axis (tensors, extras included); the other fields are the first's."""
    g0 = graphs[0]
    fields = {f: _stack([getattr(g, f) for g in graphs])
              for f in g0.__dataclass_fields__ if f != "extras"}
    extras = {k: _stack([g.extras[k] for g in graphs]) for k in g0.extras}
    return Graph(**fields, extras=extras)


def unstack_graph(stacked: Graph, index: int) -> Graph:
    """Shard ``index`` of a :func:`stack_graphs` result."""
    def pick(v):
        return v[index] if isinstance(v, torch.Tensor) else v

    fields = {f: pick(getattr(stacked, f))
              for f in stacked.__dataclass_fields__ if f != "extras"}
    return Graph(**fields, extras={k: pick(v)
                                   for k, v in stacked.extras.items()})


def shard_data_list(data_list: List[Data], num_shards: int,
                    num_nodes: int, num_edges: int,
                    graphs_per_shard: int, device="cuda") -> Graph:
    """Split a list of host graphs round-robin (``data_list[i::n]``) into
    ``num_shards`` shards collated at the given budgets with
    ``graphs_per_shard + 1`` graphs (the padding graph's row), stacked on
    ``device``."""
    shards = [data_list[i::num_shards] for i in range(num_shards)]
    return stack_graphs([
        collate(s, num_nodes=num_nodes, num_edges=num_edges,
                num_graphs=graphs_per_shard + 1, device=device)
        for s in shards])


def _parameters(params) -> List[torch.nn.Parameter]:
    if isinstance(params, torch.nn.Module):
        return list(params.parameters())
    return list(params)


class DataParallelTrainer:
    """A synchronous data-parallel step over the ``axis`` dimension of
    ``mesh`` (a ``DeviceMesh`` from ``make_mesh``).

    ``loss_fn(params, graph, rng) -> scalar`` is user code on ONE shard:
    ``params`` is the model (an ``nn.Module``, the same on every rank),
    ``graph`` this rank's shard of the stack, ``rng`` the caller's
    ``torch.Generator`` (or None). ``optimizer`` is a torch optimizer
    over the model's parameters, or a factory that makes one from them
    (``lambda ps: torch.optim.Adam(ps, 1e-2)``); :meth:`init` returns it,
    and it plays the role of optax's state."""

    def __init__(self, mesh, loss_fn: Callable, optimizer, axis: str = "dp"):
        self.mesh = mesh
        self.axis = axis
        self.loss_fn = loss_fn
        self.tx = optimizer
        self.group = mesh.get_group(axis)
        self.rank = dist.get_rank(self.group)
        self.size = dist.get_world_size(self.group)

    def init(self, params):
        if isinstance(self.tx, torch.optim.Optimizer):
            return self.tx
        return self.tx(_parameters(params))

    def _local(self, params, stacked_graph: Graph, rng):
        if stacked_graph.senders.shape[0] != self.size:
            raise ValueError(f"the stack holds {stacked_graph.senders.shape[0]}"
                             f" shards for {self.size} ranks")
        graph = unstack_graph(stacked_graph, self.rank)
        ps = _parameters(params)
        for p in ps:
            p.grad = None
        loss = self.loss_fn(params, graph, rng)
        loss.backward()
        return ps, loss.detach()

    def _average(self, ps, loss):
        """(mean gradients, mean loss) over the ranks, in rank order:
        one gather of the flat gradient and the loss."""
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1).float()
                          for p in ps] + [loss.reshape(1).float()])
        mean = ordered_sum(flat, self.group) / self.size
        grads, at = [], 0
        for p in ps:
            grads.append(mean[at:at + p.numel()].reshape(p.shape).to(
                p.dtype))
            at += p.numel()
        return grads, mean[at]

    def grads(self, params, stacked_graph: Graph, rng):
        """The averaged gradients, one per parameter (no update): the DP
        gradient as the step sees it."""
        ps, loss = self._local(params, stacked_graph, rng)
        grads, _ = self._average(ps, loss)
        for p in ps:
            p.grad = None
        return grads

    def step(self, params, opt_state, stacked_graph: Graph, rng):
        """One synchronous step; ``stacked_graph``'s leading dim is the
        mesh axis's size. Returns ``(params, opt_state, mean loss)``."""
        ps, loss = self._local(params, stacked_graph, rng)
        grads, mean_loss = self._average(ps, loss)
        for p, g in zip(ps, grads):
            p.grad = g
        opt_state.step()
        return params, opt_state, mean_loss
