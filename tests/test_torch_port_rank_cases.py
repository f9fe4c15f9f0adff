"""What the ranks of the port's distributed tests run.

``tests/test_torch_port_data_parallel.py``, ``test_torch_port_partition.py``
and ``test_torch_port_dist_models.py`` start a ``RankPool`` of gloo ranks
on the CPU and hand each case below, by pickle, the numpy inputs and the
weights they fed the JAX package. A rank process imports this module,
which imports torch, numpy and the port only: no JAX and nothing of the
JAX package (checked by the one test here). Every case takes ``rank``
first and ``P``, the group's size: the ranks ``>= P`` of the pool sit the
case out (they still join the group's creation) and return None.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from pytorch_geometric_tpu_torch.parallel import mesh
from pytorch_geometric_tpu_torch.parallel.api import GraphPartition
from pytorch_geometric_tpu_torch.parallel.data_parallel import (
    DataParallelTrainer, shard_data_list, stack_graphs)
from pytorch_geometric_tpu_torch.parallel.fast import PartitionedSpmm
from pytorch_geometric_tpu_torch.parallel import models as dist_models
from pytorch_geometric_tpu_torch.parallel import partition as pt

_MESHES = {}


def group_of(rank, P, axis="graph"):
    """The group of ranks ``0 .. P-1`` (None outside it); every rank of
    the pool makes each mesh once."""
    key = (P, axis)
    if key not in _MESHES:
        _MESHES[key] = mesh.make_mesh((P,), (axis,))
    m = _MESHES[key]
    return m.get_group(axis) if rank < P else None


def _t(a, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.requires_grad_() if grad else t


def _np(t):
    return t.detach().numpy().copy()


# --- partition ---------------------------------------------------------------

def halo_paths(rank, P, shards, w_lr, x, probe):
    """Forward and ``d sum(out * probe) / dx`` of the generic halo
    functions on this rank's shard."""
    g = group_of(rank, P)
    if g is None:
        return None
    t = shards.rank_tables(rank, "cpu")
    xs = shards.shard_nodes(x)[rank]
    pr = _t(shards.shard_nodes(probe)[rank])
    w = (_t(w_lr[0][rank]), _t(w_lr[1][rank]))
    H, B = shards.halo_size, shards.boundary_size
    calls = {
        "halo": lambda v: pt.halo_spmm(v, w, t, g, H, P),
        "boundary": lambda v: pt.boundary_spmm(v, w, t, g, B),
        "allgather": lambda v: pt.allgather_spmm(v, w, t, g),
        "max": lambda v: pt.halo_spmm_max(v, t, g, H, P),
        "mean": lambda v: pt.halo_spmm_mean(v, w, t, g, H, P),
    }
    out = {}
    for name, fn in calls.items():
        v = _t(xs, grad=True)
        o = fn(v)
        (o * pr).sum().backward()
        out[name] = (_np(o), _np(v.grad))
    return out


def halo_gat_case(rank, P, shards, h, a_src, a_dst, heads, probe):
    """``halo_gat``'s output and its gradients in (h, a_src, a_dst)."""
    g = group_of(rank, P)
    if g is None:
        return None
    t = shards.rank_tables(rank, "cpu")
    ins = [_t(shards.shard_nodes(a)[rank], grad=True)
           for a in (h, a_src, a_dst)]
    o = pt.halo_gat(*ins, t, g, shards.halo_size, P, heads)
    (o * _t(shards.shard_nodes(probe)[rank])).sum().backward()
    return _np(o), [_np(a.grad) for a in ins]


def halo_rgcn_case(rank, P, shards, rel_w, x, basis, comb, root, probe):
    """``halo_rgcn``'s output and its gradients in (x, basis, comb,
    root)."""
    g = group_of(rank, P)
    if g is None:
        return None
    t = shards.rank_tables(rank, "cpu")
    xs = _t(shards.shard_nodes(x)[rank], grad=True)
    params = [_t(a, grad=True) for a in (basis, comb, root)]
    rw = [(_t(wl[rank]), _t(wr[rank])) for wl, wr in rel_w]
    o = pt.halo_rgcn(xs, params[0], params[1], rw, t, g, shards.halo_size,
                     P, root=params[2])
    (o * _t(shards.shard_nodes(probe)[rank])).sum().backward()
    return _np(o), [_np(a.grad) for a in [xs] + params]


def partitioned_spmm_case(rank, P, shards, wl, wr, kw, x, probe):
    """``PartitionedSpmm``'s output, ``dx`` of ``sum(out * probe)``, the
    dense block count and the dtype of the rows sent."""
    g = group_of(rank, P)
    if g is None:
        return None
    op = PartitionedSpmm(shards, wl, wr, ranks=[rank], device="cpu", **kw)
    fn, consts = op.bind()
    xs = _t(shards.shard_nodes(x)[rank], grad=True)
    o = fn(consts[rank], xs, g)
    (o * _t(shards.shard_nodes(probe)[rank])).sum().backward()
    sent = op.send_rows(consts[rank], xs)
    return {"out": _np(o), "dx": _np(xs.grad),
            "dense_blocks": op.num_dense_blocks, "sent": str(sent.dtype)}


def exchange_case(rank, P, shards, wl, wr, x):
    """This rank's send buffer and what the gloo all-to-all delivers."""
    g = group_of(rank, P)
    if g is None:
        return None
    op = PartitionedSpmm(shards, wl, wr, ranks=[rank], device="cpu")
    consts = op.device_consts()[rank]
    send = op.send_rows(consts, _t(shards.shard_nodes(x)[rank]))
    recv = op.exchange(send, g)
    return _np(send.float()), _np(recv.float())


# --- Dist models ---------------------------------------------------------------

def _partition(rank, P, src, dst, N, kw):
    group_of(rank, P)              # the pool's groups, made in one order
    part = GraphPartition(src, dst, N, P, device="cpu", **kw)
    return part


def _model(name, state_dict, **kwargs):
    model = getattr(dist_models, name)(**kwargs)
    model.load_state_dict({k: torch.as_tensor(v)
                           for k, v in state_dict.items()})
    return model


def dist_forward(rank, P, src, dst, N, kw, name, model_kw, state_dict, x):
    """The unsharded logits of a Dist model (every rank gathers them)."""
    part = _partition(rank, P, src, dst, N, kw)
    if part.rank is None:
        return None
    model = part.init_model(_model(name, state_dict, **model_kw), None)
    x_sh = part.shard_nodes(x)
    return part.unshard_nodes(part.apply_model(model, model, x_sh))


def dist_train_step(rank, P, src, dst, N, kw, name, model_kw, state_dict,
                    x, y, mask, lr, steps):
    """``steps`` SGD steps of ``make_train_step`` with the masked
    cross-entropy: the losses and the final state dict."""
    from pytorch_geometric_tpu_torch.examples.distributed_gcn import (
        nll_terms)

    part = _partition(rank, P, src, dst, N, kw)
    if part.rank is None:
        return None
    model = part.init_model(_model(name, state_dict, **model_kw), None)
    opt = torch.optim.SGD(model.parameters(), lr=lr)
    step = part.make_train_step(model, opt, nll_terms)
    x_sh, y_sh, m_sh = (part.shard_nodes(a) for a in (x, y, mask))
    losses = []
    for _ in range(steps):
        model, opt, loss = step(model, opt, x_sh, y_sh, m_sh, None)
        losses.append(float(loss))
    return losses, {k: _np(v) for k, v in model.state_dict().items()}


# --- data parallelism ------------------------------------------------------------

def _loss_fn(model, graph, rng):
    from pytorch_geometric_tpu_torch.examples.data_parallel import batch_loss

    return batch_loss(model, graph, rng)


def dp_case(rank, P, datas, budgets, state_dict, model_kw, lr, steps):
    """``DataParallelTrainer`` on a ``GraphClassifier``: the averaged
    gradients, then ``steps`` SGD steps; the losses, the final state
    dict and every step's bits."""
    from pytorch_geometric_tpu_torch.models.graph_pred import GraphClassifier

    g = group_of(rank, P, "dp")
    if g is None:
        return None
    m = _MESHES[(P, "dp")]
    model = GraphClassifier(**model_kw)
    model.load_state_dict({k: torch.as_tensor(v)
                           for k, v in state_dict.items()})
    trainer = DataParallelTrainer(
        m, _loss_fn, lambda ps: torch.optim.SGD(ps, lr=lr))
    opt = trainer.init(model)
    stacked = shard_data_list(datas, P, *budgets, device="cpu")
    grads = [_np(gr) for gr in trainer.grads(model, stacked, None)]
    losses = []
    for _ in range(steps):
        model, opt, loss = trainer.step(model, opt, stacked, None)
        losses.append(_np(loss))
    return {"grads": grads, "losses": losses,
            "state_dict": {k: _np(v) for k, v in model.state_dict().items()}}


def dp_stack_case(rank, P, datas, budgets):
    """Rank ``rank``'s shard of the stack, and a restack of the shards."""
    from pytorch_geometric_tpu_torch.parallel.data_parallel import (
        unstack_graph)

    if rank >= P:
        return None
    stacked = shard_data_list(datas, P, *budgets, device="cpu")
    shards = [unstack_graph(stacked, i) for i in range(P)]
    again = stack_graphs(shards)
    same = all(torch.equal(getattr(again, f), getattr(stacked, f))
               for f in ("x", "senders", "receivers", "y", "batch"))
    mine = shards[rank]
    return same, _np(mine.x), _np(mine.senders), _np(mine.y)


def ordered(rank, values):
    """``ordered_sum`` over the pool's 4 ranks of ``values[rank]``."""
    group_of(rank, 4, "dp")
    return _np(mesh.ordered_sum(torch.tensor(values[rank]), None))


def boom(rank):
    if rank == 1:
        raise ValueError("rank one fails")
    return rank


def run_example(rank, module, fn, *args):
    """``module.fn(rank, *args)`` of an example, in the pool."""
    import importlib

    return getattr(importlib.import_module(module), fn)(rank, *args)


# --- the one test -----------------------------------------------------------------

def test_a_rank_process_imports_no_jax():
    """This module, imported alone as a rank imports it, loads no JAX and
    nothing of the JAX package."""
    code = ("import sys; sys.path.insert(0, 'tests'); "
            "import test_torch_port_rank_cases; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'pytorch_geometric_tpu')))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=Path(__file__).resolve().parents[1], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
