"""Convex-pruning research pipeline driver.

Counterpart of ``pytorch_geometric_tpu/research/driver.py`` (reference:
ConvexPruning.py ``TrainingNet``, :443): dataset dispatch ->
``contraction_layer_coefficients`` widths -> model -> phase 1 pre-train
(``TrainPart``, :47-95) -> ``retain_network_size`` SVD width pruning
(:551) -> a smaller net rebuilt (:552-566) -> phase 2 fine-tune with a
``weight_correction`` every 20 epochs past ``start_topo_coeff *
epochs`` (:58-64) -> best-metric checkpoints (:78-88) -> one ``.npy``
convergence curve per Monte-Carlo run under ``Results/<dataset>
Convergence`` (:569-576) -> the CLI (:580-626).

The epochs run eagerly on ``device`` (default ``"cuda"``) through each
model's operators, built once per graph (``models/prunable.py``); one
evaluation and one ``save_best`` follow each span between corrections,
as in the JAX driver (its chunking of a span into compiled scans has no
counterpart here). The correction runs on the host between spans, its
power iterations on the device, and edits the model's parameters in
place, so AdamW keeps its moments across it as optax keeps
``opt_state``.

``--gpus N`` runs the graph-classification pipeline data-parallel over
N ranks (``parallel/mesh.py:spawn``: one process per card, NCCL, or
gloo ranks with ``device="cpu"``): every rank runs the whole pipeline on
its shard of each batch list, the gradients averaged in rank order
(``train_part_graphcls_dp``), so every rank holds the same weights and
rank 0 writes the files. ``--partition N`` trains a Dist model over an
N-way edge partition (``training_net_partitioned``).
"""

import argparse
import os
import os.path as osp
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from pytorch_geometric_tpu_torch.data import (
    DataListLoader, DataLoader, from_data)
from pytorch_geometric_tpu_torch.data.batch import bucket_size
from pytorch_geometric_tpu_torch.datasets import (
    PPI, Amazon, CoraFull, MNISTSuperpixels, Planetoid, Reddit, TUDataset)
from pytorch_geometric_tpu_torch.datasets.graphs import PLANETOID_ROOT
from pytorch_geometric_tpu_torch.device import resolve_device
from pytorch_geometric_tpu_torch.examples.ppi import OperatorCache, bce_loss
from pytorch_geometric_tpu_torch.models.citation import (
    masked_accuracy, masked_softmax_xent)
from pytorch_geometric_tpu_torch.models.graph_pred import graph_xent_loss
from pytorch_geometric_tpu_torch.models.prunable import choose_model
from pytorch_geometric_tpu_torch.nn.message_passing import require_cpu
from pytorch_geometric_tpu_torch.parallel import (
    DataParallelTrainer, make_mesh, shard_data_list)
from pytorch_geometric_tpu_torch.parallel.mesh import rank_device, spawn
from pytorch_geometric_tpu_torch.research import spectral
from pytorch_geometric_tpu_torch.research.checkpoint import CheckpointManager
from pytorch_geometric_tpu_torch.research.pruning import (
    contraction_layer_coefficients, retain_network_size)
from pytorch_geometric_tpu_torch.transforms import (
    Cartesian, NormalizeFeatures)


GRAPH_CLS_DATASETS = ("enzymes", "mutag", "proteins", "dd", "collab",
                      "mnist")

def load_citation_dataset(name: str, root=PLANETOID_ROOT, device="cuda"):
    """``(dataset, graph on device)`` (reference :458-517, the
    citation-style datasets); a dataset without canonical splits gets a
    random 60/20/20 one from ``default_rng(0)``. No download."""
    root = str(root)
    name_l = name.lower()
    if name_l in ("cora", "citeseer", "pubmed"):
        ds = Planetoid(root, name, transform=NormalizeFeatures())
    elif name_l == "corafull":
        ds = CoraFull(root)
    elif name_l in ("computers", "photo"):
        ds = Amazon(root, name_l)
    elif name_l == "reddit":
        ds = Reddit(root)
    else:
        raise ValueError(f"unsupported dataset {name}")
    data = ds[0]
    if getattr(data, "train_mask", None) is None:
        rng = np.random.default_rng(0)
        split = rng.random(data.num_nodes)
        data.train_mask = split < 0.6
        data.val_mask = (split >= 0.6) & (split < 0.8)
        data.test_mask = split >= 0.8
    return ds, from_data(data, device=resolve_device(device))


class TrainPartResult:
    """One phase's outcome: the model's ``params`` (its state dict), the
    optimizer's ``opt_state`` (its state dict), the convergence lists,
    the best validation metric, and ``corrections``: one dict a weight
    correction (``epoch``, ``applied``, ``seconds``, and ``fiedler``, how
    many Fiedler pairs each backend computed)."""

    def __init__(self, params, opt_state, train_conv, test_conv, best,
                 corrections=None):
        self.params = params
        self.opt_state = opt_state
        self.train_convergence = train_conv
        self.test_convergence = test_conv
        self.best_acc = best
        self.corrections = corrections or []


def clip_by_global_norm(parameters, max_norm: float = 5.0):
    """``optax.clip_by_global_norm`` on the gradients, in place: each
    ``g`` becomes ``g / ||g|| * max_norm`` when the global norm ``||g||``
    is at least ``max_norm`` (not ``clip_grad_norm_``'s
    ``g * max_norm / (||g|| + 1e-6)``). Nothing leaves the device."""
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


def _spans(epochs: int, correction_epochs):
    """``[(length, correct_after)]``: the epochs cut at each correction
    epoch in (0, epochs], the last span without one."""
    spans, prev = [], 0
    for c in sorted(set(correction_epochs or [])):
        if prev < c <= epochs:
            spans.append((c - prev, True))
            prev = c
    if prev < epochs:
        spans.append((epochs - prev, False))
    return spans


def train_part(model, graph, params, epochs: int, lr: float = 0.01,
               weight_decay: float = 5e-4, seed: int = 0,
               correction_epochs: Optional[Sequence[int]] = None,
               correction_kwargs: Optional[dict] = None,
               ckpt: Optional[CheckpointManager] = None,
               run_key: str = "run", monte: int = 0,
               apply_kwargs: Optional[dict] = None) -> TrainPartResult:
    """One training phase (reference TrainPart :47-95): ``epochs`` steps
    of the masked cross-entropy with global-norm clipping at 5 and AdamW
    (optax's ``chain(clip_by_global_norm(5.0), adamw(lr, weight_decay))``),
    cut into spans at ``correction_epochs``; after each span one
    evaluation, a ``save_best`` on the validation accuracy, and, where
    the span ends at a correction epoch, ``weight_correction(model,
    **correction_kwargs)``.

    ``params``: a state dict loaded into ``model`` first (None: its own).
    ``apply_kwargs`` go to every forward: the model's operators
    (``model.operators(graph)``); without them the plain path, on a CPU
    graph only. Dropout draws from a generator on the graph's device
    seeded with ``seed + monte``."""
    if params is not None:
        model.load_state_dict(params)
    ak = apply_kwargs or {}
    opt = torch.optim.AdamW(model.parameters(), lr=lr,
                            weight_decay=weight_decay)
    gen = torch.Generator(device=graph.device).manual_seed(seed + monte)

    def evaluate():
        model.eval()
        with torch.no_grad():
            logits = model(graph, graph.x, **ak)
        return [float(masked_accuracy(logits, graph.y, m))
                for m in (graph.train_mask, graph.val_mask,
                          graph.test_mask)]

    train_conv: List[float] = []
    test_conv: List[float] = []
    corrections = []
    best = 0.0
    for length, correct_after in _spans(epochs, correction_epochs):
        model.train()
        losses = []
        for _ in range(length):
            opt.zero_grad(set_to_none=False)
            logits = model(graph, graph.x, train=True, generator=gen, **ak)
            loss = masked_softmax_xent(logits, graph.y, graph.train_mask)
            loss.backward()
            clip_by_global_norm(model.parameters(), 5.0)
            opt.step()
            losses.append(loss.detach())
        train_conv.extend(torch.stack(losses).cpu().tolist())
        tr, va, te = evaluate()
        test_conv.append(te)
        if ckpt is not None:
            ckpt.save_best(run_key, va, model.state_dict(), opt.state_dict(),
                           train_conv, test_conv,
                           epoch=len(train_conv))
        best = max(best, va)
        if correct_after:
            before = dict(spectral.FIEDLER_CALLS)
            t0 = time.perf_counter()
            _, applied = spectral.weight_correction(
                model, **(correction_kwargs or {"num_classes": 4}))
            corrections.append({
                "epoch": len(train_conv), "applied": applied,
                "seconds": time.perf_counter() - t0,
                "fiedler": {k: spectral.FIEDLER_CALLS[k] - before[k]
                            for k in before}})
    return TrainPartResult(model.state_dict(), opt.state_dict(), train_conv,
                           test_conv, best, corrections)


def _accuracy(model, test_loader, test_ops: OperatorCache) -> float:
    """Accuracy of the argmax over the loader's real graphs (eval mode)."""
    model.eval()
    cor = tot = 0
    with torch.no_grad():
        for idx, graph in test_loader.indexed():
            pred = model(graph, **test_ops(idx, graph)).argmax(dim=1)
            m = graph.graph_mask
            cor += int(((pred == graph.y.long()) & m).sum())
            tot += int(m.sum())
    return cor / max(tot, 1)


def train_part_graphcls(model, train_loader, test_loader, params,
                        epochs: int, lr: float = 5e-4, seed: int = 0,
                        ckpt: Optional[CheckpointManager] = None,
                        run_key: str = "run",
                        operators: Optional[OperatorCache] = None
                        ) -> TrainPartResult:
    """Graph-classification phase (the reference's TopKNet / batch-size
    pipeline, ConvexPruningBatchSize.py): one Adam step a batch over the
    loader, accuracy over the test loader's real graphs each epoch.
    ``operators`` caches each training batch's operators by its dataset
    indices (default: a new cache of ``model.operators``); the test
    batches get a cache of their own."""
    if params is not None:
        model.load_state_dict(params)
    ops = operators or OperatorCache(model.operators)
    test_ops = OperatorCache(model.operators)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    gen = torch.Generator(device=train_loader.device).manual_seed(seed)
    train_conv, test_conv = [], []
    best = 0.0
    for epoch in range(epochs):
        model.train()
        losses = []
        for idx, graph in train_loader.indexed():
            opt.zero_grad(set_to_none=True)
            logits = model(graph, train=True, generator=gen,
                           **ops(idx, graph))
            loss = graph_xent_loss(logits, graph.y, graph.graph_mask)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        train_conv.append(float(torch.stack(losses).mean()))
        acc = _accuracy(model, test_loader, test_ops)
        test_conv.append(acc)
        best = max(best, acc)
        if ckpt is not None:
            ckpt.save_best(run_key, acc, model.state_dict(), opt.state_dict(),
                           train_conv, test_conv,
                           epoch=epoch)
    return TrainPartResult(model.state_dict(), opt.state_dict(), train_conv,
                           test_conv, best)


def train_part_graphcls_dp(model, train_list_loader, test_loader, params,
                           epochs: int, num_devices: int,
                           num_nodes: int, num_edges: int,
                           graphs_per_shard: int, lr: float = 5e-4,
                           seed: int = 0,
                           ckpt: Optional[CheckpointManager] = None,
                           run_key: str = "run",
                           device="cuda") -> TrainPartResult:
    """The data-parallel graph-classification phase (the reference runs
    the pipeline under ``DataParallel(net)``, ConvexPruning.py:530-531,
    559-560), in one rank of a group of ``num_devices``: each list of the
    list loader is split round-robin into padded shards
    (``shard_data_list``, a tail shorter than the rank count skipped),
    this rank's shard runs through its operators (``model.operators``),
    and ``DataParallelTrainer`` averages the Adam step's gradients and
    loss over the ranks in rank order. Dropout draws from a generator
    seeded with ``seed`` on every rank (the JAX step hands every device
    one key). Accuracy over the test loader after each epoch."""
    if params is not None:
        model.load_state_dict(params)
    dev = rank_device(device)
    mesh = make_mesh((num_devices,), ("dp",))

    def loss_fn(m, graph, rng):
        logits = m(graph, train=True, generator=rng, **m.operators(graph))
        return graph_xent_loss(logits, graph.y, graph.graph_mask)

    trainer = DataParallelTrainer(
        mesh, loss_fn, lambda ps: torch.optim.Adam(ps, lr=lr))
    opt = trainer.init(model)
    test_ops = OperatorCache(model.operators)
    gen = torch.Generator(device=dev).manual_seed(seed)
    train_conv, test_conv = [], []
    best = 0.0
    for epoch in range(epochs):
        model.train()
        losses = []
        for data_list in train_list_loader:
            if len(data_list) < num_devices:   # tail smaller than the group
                continue
            stacked = shard_data_list(data_list, num_devices, num_nodes,
                                      num_edges, graphs_per_shard,
                                      device=dev)
            model, opt, loss = trainer.step(model, opt, stacked, gen)
            losses.append(loss)
        train_conv.append(float(torch.stack(losses).mean()) if losses
                          else 0.0)
        acc = _accuracy(model, test_loader, test_ops)
        test_conv.append(acc)
        best = max(best, acc)
        if ckpt is not None:
            ckpt.save_best(run_key, acc, model.state_dict(), opt.state_dict(),
                           train_conv, test_conv, epoch=epoch)
    return TrainPartResult(model.state_dict(), opt.state_dict(), train_conv,
                           test_conv, best)


def _save_curves(out_dir, stem, tag, monte, phase):
    for which, curve in (("Train", phase.train_convergence),
                         ("Test", phase.test_convergence)):
        np.save(osp.join(out_dir, f"{which}Convergence-{stem}-{tag}-"
                                  f"monte_{monte}.npy"), np.asarray(curve))


def _pruned_widths(params, con_coeff, num_layers, widths, least):
    new = [max(int(w), least) for w in
           retain_network_size(params, con_coeff)[:num_layers]]
    return new or list(widths)


def training_net_graphcls(dataset: str, model_name: str = "TopK",
                          num_layers: int = 3, con_coeff: float = 0.6,
                          alpha: float = 0.5, epochs: int = 20,
                          fine_tune_epochs: int = 20,
                          batch_size: int = 64, lr: float = 5e-4,
                          monte_size: int = 1, seed: int = 0,
                          results_dir: str = "Results",
                          ckpt_dir: str = "checkpoint",
                          num_devices: int = 1, device="cuda",
                          root=PLANETOID_ROOT,
                          data_parallel: Optional[bool] = None):
    """Graph-classification pipeline (reference TUDataset dispatch at
    ConvexPruning.py:487 and its MNISTSuperpixels one at :515).

    ``num_devices > 1`` (or ``data_parallel=True``, also on one rank) runs
    both phases data-parallel on ``num_devices`` ranks
    (``train_part_graphcls_dp``): ``batch_size`` rounded down to a
    multiple of the rank count, each shard's budget that of its largest
    graphs. Every rank runs the pipeline; rank 0 saves the files, and its
    results are returned."""
    dp = num_devices > 1 if data_parallel is None else data_parallel
    kwargs = dict(dataset=dataset, model_name=model_name,
                  num_layers=num_layers, con_coeff=con_coeff, alpha=alpha,
                  epochs=epochs, fine_tune_epochs=fine_tune_epochs,
                  batch_size=batch_size, lr=lr, monte_size=monte_size,
                  seed=seed, results_dir=results_dir, ckpt_dir=ckpt_dir,
                  num_devices=num_devices, device=device, root=root)
    if dp:
        return spawn(_graphcls_rank, num_devices, kwargs, device=device)[0]
    return _graphcls(None, **kwargs)


def _graphcls_rank(rank, kwargs):
    return _graphcls(rank, **kwargs)


def _graphcls(rank, dataset, model_name, num_layers, con_coeff, alpha,
              epochs, fine_tune_epochs, batch_size, lr, monte_size, seed,
              results_dir, ckpt_dir, num_devices, device, root):
    """The pipeline on one device (``rank`` None) or in one rank."""
    dev = rank_device(device)
    if dataset.lower() == "mnist":
        ds = MNISTSuperpixels(str(root), train=True, transform=Cartesian())
    else:
        ds = TUDataset(str(root), dataset.upper())
    num_classes = ds.num_classes
    writer = rank in (None, 0)
    ckpt = CheckpointManager(ckpt_dir) if writer else None
    out_dir = osp.join(results_dir, f"{dataset.upper()}Convergence")
    if writer:
        os.makedirs(out_dir, exist_ok=True)
    if rank is not None:
        batch_size = max(batch_size // num_devices, 1) * num_devices
        gps = batch_size // num_devices           # graphs per shard
        sizes_n = sorted((d.num_nodes for d in ds), reverse=True)
        sizes_e = sorted((d.num_edges for d in ds), reverse=True)
        shard_nodes = bucket_size(sum(sizes_n[:gps]) + 1)
        shard_edges = bucket_size(max(sum(sizes_e[:gps]), 1))
    results = []
    for monte in range(monte_size):
        sh = ds.shuffle(seed=seed + monte)
        n = len(sh)
        test_ds, train_ds = sh[: n // 10], sh[n // 10:]
        train_loader = DataLoader(train_ds, batch_size=batch_size,
                                  shuffle=True, seed=seed + monte,
                                  device=dev)
        test_loader = DataLoader(test_ds, batch_size=batch_size,
                                 device=dev)
        widths = contraction_layer_coefficients(
            128, num_layers, alpha, seed=seed + monte)
        g0 = next(iter(train_loader))
        model = choose_model(
            model_name, widths, num_classes,
            in_channels=g0.num_node_features,
            generator=torch.Generator().manual_seed(seed + monte)).to(dev)
        ops = OperatorCache(model.operators)
        run_key = (f"{dataset}-{model_name}{num_layers}-"
                   f"{'_'.join(map(str, widths))}-b{batch_size}-{monte}")
        if rank is not None:
            list_loader = DataListLoader(train_ds, batch_size=batch_size,
                                         shuffle=True, seed=seed + monte)

            def fit(mdl, n_epochs, sd, rk):
                return train_part_graphcls_dp(
                    mdl, list_loader, test_loader, None, n_epochs,
                    num_devices, shard_nodes, shard_edges, gps, lr=lr,
                    seed=sd, ckpt=ckpt, run_key=rk, device=dev)
        else:
            def fit(mdl, n_epochs, sd, rk):
                return train_part_graphcls(
                    mdl, train_loader, test_loader, None, n_epochs, lr=lr,
                    seed=sd, ckpt=ckpt, run_key=rk, operators=ops)

        phase1 = fit(model, epochs, seed, run_key + "-p1")
        new_widths = _pruned_widths(phase1.params, con_coeff, num_layers,
                                    widths, 2)
        pruned = choose_model(
            model_name, new_widths, num_classes,
            in_channels=g0.num_node_features,
            generator=torch.Generator().manual_seed(seed + monte + 1)
        ).to(dev)
        phase2 = fit(pruned, fine_tune_epochs, seed + 1, run_key + "-p2")
        tag = f"param_{'_'.join(map(str, widths))}_{con_coeff}_b{batch_size}"
        if writer:
            _save_curves(out_dir,
                         f"{dataset.upper()}-{model_name}{num_layers}", tag,
                         monte, phase2)
        results.append({"monte": monte, "widths": widths,
                        "new_widths": new_widths,
                        "pretrain_best": phase1.best_acc,
                        "finetune_best": phase2.best_acc})
    return results


def training_net_ppi(model_name: str = "GCN", num_layers: int = 2,
                     con_coeff: float = 0.6, alpha: float = 0.5,
                     epochs: int = 20, fine_tune_epochs: int = 20,
                     batch_size: int = 2, lr: float = 5e-3,
                     monte_size: int = 1, seed: int = 0,
                     results_dir: str = "Results",
                     ckpt_dir: str = "checkpoint", device="cuda",
                     root=PLANETOID_ROOT):
    """PPI pipeline (reference dispatch ConvexPruning.py:492-501):
    inductive multi-label node classification over the 20/2/2 split,
    sigmoid cross-entropy over the real nodes, micro-F1 on the test
    graphs, through the two-phase prune / fine-tune loop. Each distinct
    batch's operators are built once, on its first sight, and serve both
    phases (``examples/ppi.py:OperatorCache``)."""
    dev = resolve_device(device)
    train_ds = PPI(str(root), split="train")
    test_ds = PPI(str(root), split="test")
    num_classes = train_ds.num_classes
    ckpt = CheckpointManager(ckpt_dir)
    out_dir = osp.join(results_dir, "PPIConvergence")
    os.makedirs(out_dir, exist_ok=True)

    def fit(model, n_epochs, sd, rk, train_ops, test_ops):
        opt = torch.optim.Adam(model.parameters(), lr=lr)
        gen = torch.Generator(device=dev).manual_seed(sd)
        train_loader = DataLoader(train_ds, batch_size=batch_size,
                                  shuffle=True, seed=sd, device=dev)
        test_loader = DataLoader(test_ds, batch_size=batch_size, device=dev)
        train_conv, test_conv, best = [], [], 0.0
        for _ in range(n_epochs):
            model.train()
            losses = []
            for idx, graph in train_loader.indexed():
                opt.zero_grad(set_to_none=True)
                loss = bce_loss(model(graph, graph.x, train=True,
                                      generator=gen,
                                      **train_ops(idx, graph)), graph)
                loss.backward()
                opt.step()
                losses.append(loss.detach())
            train_conv.append(float(torch.stack(losses).mean()))
            model.eval()
            tp = fp = fn = 0
            with torch.no_grad():
                for idx, graph in test_loader.indexed():
                    logits = model(graph, graph.x, **test_ops(idx, graph))
                    pred = logits > 0
                    y = graph.y > 0.5
                    m = graph.real_node_mask()[:, None]
                    tp += int((pred & y & m).sum())
                    fp += int((pred & ~y & m).sum())
                    fn += int((~pred & y & m).sum())
            f1 = 2 * tp / max(2 * tp + fp + fn, 1)       # micro-F1
            test_conv.append(f1)
            best = max(best, f1)
            ckpt.save_best(rk, f1, model.state_dict(), opt.state_dict(),
                           train_conv, test_conv,
                           epoch=len(train_conv))
        return TrainPartResult(model.state_dict(), opt.state_dict(),
                               train_conv, test_conv, best)

    results = []
    for monte in range(monte_size):
        widths = contraction_layer_coefficients(
            train_ds[0].x.shape[1], num_layers, alpha, seed=seed + monte)
        in_channels = train_ds[0].x.shape[1]
        model = choose_model(
            model_name, widths, num_classes, in_channels=in_channels,
            generator=torch.Generator().manual_seed(seed + monte)).to(dev)
        train_ops = OperatorCache(model.operators)
        test_ops = OperatorCache(model.operators)
        run_key = (f"PPI-{model_name}{num_layers}-"
                   f"{'_'.join(map(str, widths))}-{monte}")
        phase1 = fit(model, epochs, seed + monte, run_key + "-p1",
                     train_ops, test_ops)
        new_widths = _pruned_widths(phase1.params, con_coeff, num_layers,
                                    widths, 2)
        pruned = choose_model(
            model_name, new_widths, num_classes, in_channels=in_channels,
            generator=torch.Generator().manual_seed(seed + monte + 1)
        ).to(dev)
        phase2 = fit(pruned, fine_tune_epochs, seed + monte + 1,
                     run_key + "-p2", train_ops, test_ops)
        tag = f"param_{'_'.join(map(str, widths))}_{con_coeff}"
        _save_curves(out_dir, f"PPI-{model_name}{num_layers}", tag, monte,
                     phase2)
        results.append({"monte": monte, "widths": widths,
                        "new_widths": new_widths,
                        "pretrain_best": phase1.best_acc,
                        "finetune_best": phase2.best_acc,
                        "operators": len(train_ops.ops) + len(test_ops.ops)})
    return results


def correction_epochs_of(fine_tune_epochs: int, start_topo_coeff: float):
    """The phase-2 correction epochs: every 20 epochs from
    ``int(start_topo_coeff * fine_tune_epochs) + 20``, before the end."""
    start = int(start_topo_coeff * fine_tune_epochs)
    return list(range(start + 20, fine_tune_epochs, 20))


def training_net(dataset: str = "Cora", model_name: str = "GCN",
                 num_layers: int = 2, con_coeff: float = 0.6,
                 alpha: float = 0.5, epochs: int = 100,
                 fine_tune_epochs: int = 100, lr: float = 0.01,
                 start_topo_coeff: float = 0.5, vector_pairs: int = 2,
                 correction_coeff: float = 0.001,
                 link_prediction_method: str = "resource_allocation_index",
                 monte_size: int = 1, seed: int = 0,
                 results_dir: str = "Results", resume: bool = False,
                 ckpt_dir: str = "checkpoint",
                 fused_gat: Optional[bool] = None, device="cuda"):
    """The full pipeline (reference TrainingNet :443-576 and its Monte
    loop :452) on ``device``. Saves the phase-2 Train/Test convergence
    ``.npy`` files keyed by hyperparameters (:569-576). Each result holds
    the JAX driver's keys and, beyond them, ``seconds`` (phase 1, the SVD
    pruning, phase 2) and phase 2's ``corrections``.

    Every model aggregates through its operators, built once for the
    graph and shared by both phases. ``fused_gat``: the GAT's fused
    ``PackedFlashGat``; None or True use it wherever the graph is, False
    runs the plain segment path, on a CPU graph only (it raises on a
    card). ``resume`` looks up the bare run key, as the JAX driver does,
    while the phases save under ``-phase1`` / ``-phase2``: it finds no
    checkpoint that this driver wrote."""
    ds, graph = load_citation_dataset(dataset, device=device)
    num_classes = ds.num_classes
    in_channels = graph.num_node_features
    plain_gat = model_name == "GAT" and fused_gat is False
    if plain_gat:
        require_cpu(graph.x, "training_net(fused_gat=False)",
                    "the fused GAT operator (fused_gat=None or True)")
    ckpt = CheckpointManager(ckpt_dir)
    out_dir = osp.join(results_dir, f"{dataset}Convergence")
    os.makedirs(out_dir, exist_ok=True)
    results = []
    apply_kwargs = None
    for monte in range(monte_size):
        widths = contraction_layer_coefficients(
            in_channels, num_layers, alpha, seed=seed + monte)
        model = choose_model(
            model_name, widths, num_classes, in_channels=in_channels,
            generator=torch.Generator().manual_seed(seed + monte)
        ).to(graph.device)
        if apply_kwargs is None:
            apply_kwargs = {} if plain_gat else model.operators(graph)
        run_key = (f"{dataset}-{model_name}{num_layers}-"
                   f"{'_'.join(map(str, widths))}-{con_coeff}-{monte}")
        if resume:
            restored = ckpt.resume(run_key)
            if restored is not None:
                model.load_state_dict(restored[0])

        t0 = time.perf_counter()
        phase1 = train_part(model, graph, None, epochs, lr=lr, seed=seed,
                            ckpt=ckpt, run_key=run_key + "-phase1",
                            monte=monte, apply_kwargs=apply_kwargs)
        t1 = time.perf_counter()
        new_widths = _pruned_widths(phase1.params, con_coeff, num_layers,
                                    widths, 1)
        pruned_model = choose_model(
            model_name, new_widths, num_classes, in_channels=in_channels,
            generator=torch.Generator().manual_seed(seed + monte + 1)
        ).to(graph.device)
        t2 = time.perf_counter()
        phase2 = train_part(
            pruned_model, graph, None, fine_tune_epochs, lr=lr,
            seed=seed + 1, ckpt=ckpt, run_key=run_key + "-phase2",
            monte=monte,
            correction_epochs=correction_epochs_of(fine_tune_epochs,
                                                   start_topo_coeff),
            correction_kwargs=dict(
                num_classes=num_classes, method=link_prediction_method,
                vector_pairs=vector_pairs,
                correction_coeff=correction_coeff),
            apply_kwargs=apply_kwargs)
        t3 = time.perf_counter()
        params_tag = f"param_{'_'.join(map(str, widths))}_{con_coeff}"
        _save_curves(out_dir, f"{dataset}-{model_name}{num_layers}",
                     params_tag, monte, phase2)
        results.append({
            "monte": monte, "widths": widths, "new_widths": new_widths,
            "pretrain_best": phase1.best_acc,
            "finetune_best": phase2.best_acc,
            "seconds": {"phase1": t1 - t0, "pruning": t2 - t1,
                        "phase2": t3 - t2},
            "corrections": phase2.corrections,
        })
    return results


#: The models of --partition (:func:`_dist_model`).
PARTITION_MODELS = ("GCN", "SAGE", "GAT")


def _dist_model(model_name, in_channels, num_classes, generator):
    from pytorch_geometric_tpu_torch.parallel.models import (
        DistGAT, DistGCN, DistSAGE)

    if model_name == "GCN":
        return DistGCN(in_channels, 16, num_classes, generator=generator)
    if model_name == "SAGE":
        return DistSAGE(in_channels, 16, num_classes, generator=generator)
    return DistGAT(in_channels, num_classes, generator=generator)


def training_net_partitioned(dataset: str = "Cora",
                             model_name: str = "GCN",
                             num_devices: int = 1, epochs: int = 100,
                             lr: float = 0.01, seed: int = 0,
                             results_dir: str = "Results", device="cuda",
                             root=PLANETOID_ROOT, state_dict=None):
    """Edge-partitioned citation training through the distributed nn API
    (``parallel/api.py:GraphPartition`` and ``parallel/models.py``), the
    driver's ``--partition``: GCN (hidden 16, dropout 0.5), SAGE (hidden
    16) or GAT (8 heads of 8), Adam ``lr``, over ``num_devices`` ranks.
    The dataset is loaded here and handed to the ranks. Returns rank 0's
    result: the JAX driver's keys, and ``seconds`` and ``ms_per_step`` of
    the steps, ``logits`` (N, C) after training and the ``state_dict``.
    ``state_dict`` (e.g. ``convert.params_from_jax`` of the JAX model's)
    replaces the model's initial weights. ``results_dir`` is the JAX
    signature's; nothing is written."""
    if model_name not in PARTITION_MODELS:
        raise ValueError(
            f"--partition supports GCN/SAGE/GAT, got {model_name}")
    resolve_device(device)
    ds, graph = load_citation_dataset(dataset, root=root, device="cpu")
    return spawn(_partitioned_rank, num_devices, graph, ds.num_classes,
                 dataset, model_name, num_devices, epochs, lr, seed, device,
                 state_dict, device=device)[0]


def _partitioned_rank(rank, graph, num_classes, dataset, model_name,
                      num_devices, epochs, lr, seed, device, state_dict):
    from pytorch_geometric_tpu_torch.examples.distributed_gcn import (
        nll_terms, partition_edges)
    from pytorch_geometric_tpu_torch.parallel.api import GraphPartition

    dev = rank_device(device)
    s, r = partition_edges(graph)
    part = GraphPartition(s, r, graph.num_nodes, num_devices, device=dev)
    model = _dist_model(model_name, graph.num_node_features, num_classes,
                        torch.Generator().manual_seed(seed))
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model = part.init_model(model, None)
    has_rng = model_name == "GCN"          # dropout layers
    x_sh = part.shard_nodes(graph.x)
    y_sh = part.shard_nodes(graph.y)
    m_sh = part.shard_nodes(graph.train_mask.float())
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    step = part.make_train_step(model, opt, nll_terms, has_rng=has_rng)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    losses = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(epochs):
        model, opt, loss = step(model, opt, x_sh, y_sh, m_sh, gen)
        losses.append(loss)
    losses = torch.stack(losses).cpu().tolist()
    seconds = time.perf_counter() - t0
    logits = part.unshard_nodes(part.apply_model(model, model, x_sh))
    pred = np.argmax(logits, axis=1)
    y = graph.y.numpy()

    def acc(mask):
        m = mask.numpy().astype(bool)
        return float((pred[m] == y[m]).mean()) if m.any() else 0.0

    return {"dataset": dataset, "model": model_name,
            "num_devices": num_devices, "epochs": epochs,
            "loss_first": losses[0], "loss_last": losses[-1],
            "val_acc": acc(graph.val_mask), "test_acc": acc(graph.test_mask),
            "seconds": seconds, "ms_per_step": 1e3 * seconds / epochs,
            "logits": logits,
            "state_dict": {k: v.cpu() for k, v in model.state_dict().items()}}


def main(argv=None):
    """CLI mirroring the reference's flags (ConvexPruning.py:580-611)."""
    p = argparse.ArgumentParser(description="Convex pruning pipeline")
    p.add_argument("--dataset", default="Cora")
    p.add_argument("--modelName", default="GCN")
    p.add_argument("--num_layers", type=int, default=2)
    p.add_argument("--ConCoeff", type=float, default=0.6)
    p.add_argument("--CutoffCoeff", type=float, default=0.5, dest="alpha")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--fine_tune_epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--StartTopoCoeffi", type=float, default=0.5)
    p.add_argument("--VectorPairs", type=int, default=2)
    p.add_argument("--WeightCorrectionCoeffi", type=float, default=0.001)
    p.add_argument("--LinkPredictionMethod",
                   default="resource_allocation_index")
    p.add_argument("--MonteSize", type=int, default=1)
    p.add_argument("--Batch_size", type=int, default=64)
    p.add_argument("--gpus", type=int, default=1, dest="num_devices",
                   help="ranks for data-parallel graph classification (the "
                        "reference's --gpus): one per card")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", "-r", action="store_true")
    p.add_argument("--savepath", default="Results")
    p.add_argument("--partition", type=int, default=0,
                   help="edge-partitioned training over this many ranks "
                        "(GraphPartition + DistGCN/DistSAGE/DistGAT); "
                        "0 = off")
    args = p.parse_args(argv)
    if args.partition:
        res = [training_net_partitioned(
            dataset=args.dataset, model_name=args.modelName,
            num_devices=args.partition, epochs=args.epochs, lr=args.lr,
            seed=args.seed, results_dir=args.savepath)]
    elif args.dataset.lower() == "ppi":
        res = training_net_ppi(
            model_name=args.modelName, num_layers=args.num_layers,
            con_coeff=args.ConCoeff, alpha=args.alpha,
            epochs=args.epochs, fine_tune_epochs=args.fine_tune_epochs,
            batch_size=max(args.Batch_size, 1), monte_size=args.MonteSize,
            seed=args.seed, results_dir=args.savepath)
    elif args.dataset.lower() in GRAPH_CLS_DATASETS:
        res = training_net_graphcls(
            dataset=args.dataset,
            model_name=args.modelName if args.modelName != "GCN"
            else "TopK",
            num_layers=args.num_layers, con_coeff=args.ConCoeff,
            alpha=args.alpha, epochs=args.epochs,
            fine_tune_epochs=args.fine_tune_epochs,
            batch_size=args.Batch_size, monte_size=args.MonteSize,
            seed=args.seed, results_dir=args.savepath,
            num_devices=args.num_devices)
    else:
        res = training_net(
            dataset=args.dataset, model_name=args.modelName,
            num_layers=args.num_layers, con_coeff=args.ConCoeff,
            alpha=args.alpha, epochs=args.epochs,
            fine_tune_epochs=args.fine_tune_epochs, lr=args.lr,
            start_topo_coeff=args.StartTopoCoeffi,
            vector_pairs=args.VectorPairs,
            correction_coeff=args.WeightCorrectionCoeffi,
            link_prediction_method=args.LinkPredictionMethod,
            monte_size=args.MonteSize, seed=args.seed,
            results_dir=args.savepath, resume=args.resume)
    for r in res:
        print({k: v for k, v in r.items() if k not in ("logits",
                                                        "state_dict")})
    return res


if __name__ == "__main__":
    main()
