"""Convergence-curve store + plotting CLI.

Counterpart of ``pytorch_geometric_tpu/research/plotting.py``, host code
copied: matplotlib (and networkx, for the partition drawing) are
imported inside the functions that draw. The partition comes from the
``.npz`` graph and ``.json`` clusters that ``research/spectral.py``
writes (the JAX module writes and reads pickles), and a net's weights
from an ``.npz`` or a ``research/checkpoint.py`` ``.pt`` checkpoint,
read with ``weights_only``.

Reference counterparts: PlotMonteCalorsConvergence.py (glob over
hyperparameter-encoded filenames :25,33-40), DebugMonteConvergence.py
(:1-13 — fixed-coefficient comparison with a start epoch),
PlotNetworkContraction.py (mean +- std curves swept over ONE
coefficient with the others held), PlotDynamicalEvolution.py (singular-
value trajectories of the activation SVD snapshots), and
PlotGraphPartition.py (:1-22 — community-layout drawing of the pickled
weight-graph partition).  The fork's de-facto experiment registry is
the filename (SURVEY §5 config system).

CLI subcommands: ``convergence`` (default), ``contraction``,
``dynamics``, ``partition``.
"""

import argparse
import glob
import os.path as osp
import re
from collections import defaultdict

import numpy as np


def load_convergence(results_dir: str, dataset: str, which: str = "Test"):
    """Load all `<which>Convergence-...-monte_k.npy` curves grouped by
    hyperparameter tag (everything between dataset and monte index)."""
    pattern = osp.join(results_dir, f"{dataset}Convergence",
                       f"{which}Convergence-{dataset}-*.npy")
    groups = defaultdict(list)
    for path in sorted(glob.glob(pattern)):
        name = osp.basename(path)
        m = re.match(
            rf"{which}Convergence-{re.escape(dataset)}-(.+)-monte_(\d+)"
            r"\.npy", name)
        if not m:
            continue
        tag, monte = m.group(1), int(m.group(2))
        groups[tag].append((monte, np.load(path)))
    return {tag: [c for _, c in sorted(v)] for tag, v in groups.items()}


def monte_carlo_stats(curves):
    """(mean, std) over Monte-Carlo repeats, truncated to common length."""
    n = min(len(c) for c in curves)
    arr = np.stack([np.asarray(c[:n]) for c in curves])
    return arr.mean(axis=0), arr.std(axis=0)


def plot_convergence(results_dir: str, dataset: str, which: str = "Test",
                     out: str = None):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    groups = load_convergence(results_dir, dataset, which)
    if not groups:
        print(f"no curves under {results_dir}/{dataset}Convergence")
        return None
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for tag, curves in sorted(groups.items()):
        mean, std = monte_carlo_stats(curves)
        xs = np.arange(len(mean))
        ax.plot(xs, mean, label=f"{tag} (n={len(curves)})")
        ax.fill_between(xs, mean - std, mean + std, alpha=0.2)
    ax.set_xlabel("epoch")
    ax.set_ylabel(f"{which} metric")
    ax.set_title(f"{dataset} {which} convergence (Monte-Carlo mean ± std)")
    ax.legend(fontsize=7)
    out = out or osp.join(results_dir,
                          f"{dataset}_{which}_convergence.png")
    fig.tight_layout()
    fig.savefig(out, dpi=150)
    plt.close(fig)
    print(f"wrote {out}")
    return out


def plot_contraction(results_dir: str, dataset: str,
                     which: str = "Train", sweep_key: str = "param",
                     start_plot: int = 0, out: str = None):
    """Mean +- std curves swept over one filename coefficient with the
    others held — the reference's PlotNetworkContraction loops (its
    coefficientsFirst/Second sweeps over glob patterns).  ``sweep_key``
    selects which dash-separated tag field varies; curves are grouped
    by the value of that field."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    groups = load_convergence(results_dir, dataset, which)
    if not groups:
        print(f"no curves under {results_dir}/{dataset}Convergence")
        return None
    # group tags by the sweep field (e.g. 'param_128_64_0.6' -> 0.6)
    by_value = defaultdict(list)
    for tag, curves in groups.items():
        fields = tag.split("-")
        key = next((f for f in fields if f.startswith(sweep_key)),
                   fields[-1])
        by_value[key].extend(curves)
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for val, curves in sorted(by_value.items()):
        mean, std = monte_carlo_stats(curves)
        xs = np.arange(len(mean))[start_plot:]
        mean, std = mean[start_plot:], std[start_plot:]
        ax.plot(xs, mean, lw=2, label=f"{val} (n={len(curves)})")
        ax.fill_between(xs, mean - std, mean + std, alpha=0.3)
    ax.set_xlabel("epoch")
    ax.set_ylabel(f"{which} metric")
    ax.set_title(f"{dataset} network contraction sweep ({sweep_key})")
    ax.legend(fontsize=7)
    out = out or osp.join(results_dir,
                          f"{dataset}_{which}_contraction.png")
    fig.tight_layout()
    fig.savefig(out, dpi=150)
    plt.close(fig)
    print(f"wrote {out}")
    return out


def plot_dynamics(path: str, out: str = None):
    """Singular-value trajectories from a SaveDynamicsEvolution .npy
    history (profiling.save_dynamics_evolution; reference
    PlotDynamicalEvolution.py plots EvolutionDynamics.T rows)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    history = np.load(path, allow_pickle=True)
    arr = np.asarray([np.asarray(h, dtype=np.float64) for h in history])
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for i in range(arr.shape[1]):
        ax.plot(np.arange(1, arr.shape[0] + 1), arr[:, i],
                label=f"sigma_{i + 1}")
    ax.set_xlabel("snapshot")
    ax.set_ylabel("singular value")
    ax.set_title(osp.basename(path))
    ax.legend(fontsize=7, ncol=2)
    out = out or path.replace(".npy", ".png")
    fig.tight_layout()
    fig.savefig(out, dpi=150)
    plt.close(fig)
    print(f"wrote {out}")
    return out


def plot_partition(results_dir: str, dataset: str, model_name: str,
                   epoch: int, out: str = None):
    """Draw a weight-graph partition with the community layout
    (reference PlotGraphPartition.py:1-22): reads
    ``Results/PartitionResults/<ds>-<model>-GraphEpoch_<epoch>.npz`` (the
    composed graph's nodes, edges and weights) and
    ``...-oneClassNodeEpoch_<epoch>.json`` (the clusters) as
    ``research/spectral.py:weight_correction(dump=...)`` writes them,
    flattens the partition, community_layout, nx.draw."""
    import json

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import networkx as nx

    from pytorch_geometric_tpu_torch.research.visualization import (
        community_layout)

    base = osp.join(results_dir, "PartitionResults")
    stem = osp.join(base, f"{dataset}-{model_name}-")
    with np.load(f"{stem}GraphEpoch_{epoch}.npz") as z:
        G = nx.Graph()
        G.add_nodes_from(int(u) for u in z["nodes"])
        for (u, v), w in zip(z["edges"], z["weights"]):
            if np.isnan(w):
                G.add_edge(int(u), int(v))
            else:
                G.add_edge(int(u), int(v), weight=float(w))
    with open(f"{stem}oneClassNodeEpoch_{epoch}.json") as f:
        partition = {int(k): v for k, v in json.load(f).items()}
    node_to_class = {}
    for key, members in partition.items():
        for v in members:
            node_to_class[v] = key
    pos = community_layout(G, node_to_class)
    fig, ax = plt.subplots(figsize=(7, 7))
    nx.draw(G, pos, ax=ax, node_size=30,
            node_color=[node_to_class.get(u, 0) for u in G.nodes()])
    out = out or (f"GraphPartitionVisualization-{dataset}_"
                  f"{model_name}-{epoch}.png")
    fig.savefig(out, dpi=150)
    plt.close(fig)
    print(f"wrote {out}")
    return out


def significance_report(weights_path: str, num_clusters: int = 4,
                        num_samples: int = 20,
                        shuffle_method: str = "layer",
                        num_workers: int = None, seed: int = 0,
                        out: str = None):
    """N-cut significance of a net's weight graph under the shuffle
    null (reference pipeline: spectral_cluster_model.py run_clustering
    :952 + shuffle_and_cluster :870-950 + compute_pvalue).  Input: an
    ``.npz`` of 2-D weight matrices (insertion order = layer order) or
    a research CheckpointManager ``.pkl`` (2-D 'weight' leaves are
    extracted in pytree order).  Prints a JSON report; ``--out`` also
    writes a null-histogram plot with the actual n-cut marked."""
    import json

    from pytorch_geometric_tpu_torch.research.spectral_cluster import (
        run_clustering)

    if weights_path.endswith(".npz"):
        with np.load(weights_path) as z:
            weights = [z[k] for k in z.files]
    else:
        import torch

        from pytorch_geometric_tpu_torch.research.spectral import (
            layer_weight_items)

        state = torch.load(weights_path, map_location="cpu",
                           weights_only=True)
        params = state.get("params", state) if isinstance(state, dict) \
            else state
        weights = [w for _, w in layer_weight_items(params)]
    if not weights:
        raise SystemExit(f"no 2-D weight matrices found in "
                         f"{weights_path}")
    res = run_clustering([np.asarray(w) for w in weights],
                         num_clusters=num_clusters,
                         num_shuffle_samples=num_samples,
                         shuffle_method=shuffle_method, seed=seed,
                         num_workers=num_workers)
    report = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
              for k, v in res.items() if k != "labels"}
    report["num_clusters"] = num_clusters
    report["layers"] = [list(np.asarray(w).shape) for w in weights]
    print(json.dumps(report, indent=2))
    if out:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 4))
        ax.hist(res["shuffle_ncuts"], bins=min(20, num_samples),
                alpha=0.7, label="shuffle null")
        ax.axvline(res["ncut"], color="red",
                   label=f"actual (p={res['pvalue']:.3f})")
        ax.set_xlabel("n-cut")
        ax.legend()
        fig.savefig(out, dpi=150)
        plt.close(fig)
        print(f"wrote {out}")
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description="Result-analysis plots")
    sub = p.add_subparsers(dest="cmd")

    pc = sub.add_parser("convergence", help="Monte-Carlo mean+-std")
    pc.add_argument("--results_dir", default="Results")
    pc.add_argument("--dataset", default="Cora")
    pc.add_argument("--which", default="Test", choices=["Train", "Test"])
    pc.add_argument("--out", default=None)

    pn = sub.add_parser("contraction",
                        help="sweep one coefficient, hold the rest")
    pn.add_argument("--results_dir", default="Results")
    pn.add_argument("--dataset", default="Cora")
    pn.add_argument("--which", default="Train",
                    choices=["Train", "Test"])
    pn.add_argument("--sweep_key", default="param")
    pn.add_argument("--start_plot", type=int, default=0)
    pn.add_argument("--out", default=None)

    pd = sub.add_parser("dynamics", help="SVD snapshot trajectories")
    pd.add_argument("path")
    pd.add_argument("--out", default=None)

    pp = sub.add_parser("partition", help="weight-graph partition viz")
    pp.add_argument("--results_dir", default="Results")
    pp.add_argument("--dataset", default="Cora")
    pp.add_argument("--modelName", default="GCN")
    pp.add_argument("--epoch", type=int, default=40)
    pp.add_argument("--out", default=None)

    ps = sub.add_parser("significance",
                        help="n-cut shuffle-null p-value of a net")
    ps.add_argument("weights_path",
                    help=".npz of weight matrices or checkpoint .pt")
    ps.add_argument("--num_clusters", type=int, default=4)
    ps.add_argument("--num_samples", type=int, default=20)
    ps.add_argument("--shuffle_method", default="layer",
                    choices=["layer", "layer_nonzero"])
    ps.add_argument("--num_workers", type=int, default=None)
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--out", default=None)

    # bare invocation keeps the round-1 flags (convergence plot)
    p.set_defaults(cmd=None, results_dir="Results", dataset="Cora",
                   which="Test", out=None)
    args, extra = p.parse_known_args(argv)
    if args.cmd == "contraction":
        plot_contraction(args.results_dir, args.dataset, args.which,
                         args.sweep_key, args.start_plot, args.out)
    elif args.cmd == "dynamics":
        plot_dynamics(args.path, args.out)
    elif args.cmd == "partition":
        plot_partition(args.results_dir, args.dataset, args.modelName,
                       args.epoch, args.out)
    elif args.cmd == "significance":
        significance_report(args.weights_path, args.num_clusters,
                            args.num_samples, args.shuffle_method,
                            args.num_workers, args.seed, args.out)
    else:
        plot_convergence(args.results_dir, args.dataset, args.which,
                         args.out)


if __name__ == "__main__":
    main()
