"""Smoke run of the PyTorch port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Phases, one JSON line each:

1. card   — the card's name and power limit (nvidia-smi);
2. build  — every CUDA kernel of the port, built with nvcc from csrc/;
3. kernel — each kernel against its plain PyTorch version on the card,
            at the shapes the main path gives it (Cora: 3072 padded
            nodes, its real edges and 3072 self loops, F = 16 and 7) and
            at a
            synthetic graph of PubMed's shapes (F = 16 and 128), in both
            CSR directions, with fp32 x (tolerance 1e-5) and bf16 x
            (1e-2), relative to the largest reference magnitude; with
            the kernel's, the plain version's and one library call's
            times (CUDA graphs of 50 calls timed with CUDA events) and
            the bound;
4. slice  — the main path as a user runs it: Planetoid Cora ->
            from_data -> train_gcn(epochs=200, device="cuda"), with the
            kernel's launch count read over exactly that run, accuracy
            gates, and the trained model's logits on the card against
            the plain path on the CPU.
5. trace  — torch.profiler over 20 more epochs of the same step: device
            time per kernel name, device busy and idle share.

Then a "kernels" JSON line, and as the last line
{"ok": true, "device": {...}}. Any failure exits non-zero without that
line; so does a machine without CUDA, or a directory without the port.
"""

import json
import os
import subprocess
import sys
import time
import traceback

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
SEED = 0
EPOCHS = 200
# H100 SXM data-sheet peaks (used for the bound): HBM bytes/s and fp32
# (non-tensor-core) flop/s.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TOL = {"fp32": 1e-5, "bf16": 1e-2}


def emit(obj):
    print(json.dumps(obj), flush=True)


def device_ms(fn, calls=50):
    """Device time of one ``fn()``: ``calls`` calls captured in a CUDA
    graph, replayed and timed with CUDA events, so host overhead between
    launches is not counted. The inputs stay in the 50 MB L2 between
    calls, as they do between the layers of a training step."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def spmm_bound(csr, f, x_bytes):
    """Least time for one SpMM call on this card: each input read once,
    the output written once, against the bytes rate; 2 flops per edge
    and feature against the fp32 rate. The larger wins."""
    nbytes = (csr.num_edges * 8 + (csr.num_rows + 1) * 4
              + csr.num_cols * f * x_bytes + csr.num_rows * f * 4)
    flops = 2 * csr.num_edges * f
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "card", "nvidia_smi": smi, "torch_name": name,
          "capability": list(torch.cuda.get_device_capability(0)),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return smi


def phase_build():
    from pytorch_geometric_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    report = _build.build()
    for name in report:
        _build.load_library(name)
    ptxas = {name: [ln.strip() for ln in r["log"].splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, r in report.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": {k: v["seconds"] for k, v in report.items()},
          "ptxas": ptxas})


def _cora_graph(device):
    from pytorch_geometric_tpu_torch.data import from_data
    from pytorch_geometric_tpu_torch.datasets import Planetoid
    from pytorch_geometric_tpu_torch.transforms import NormalizeFeatures

    ds = Planetoid(os.path.join(REPO, "datasets_cache"), "Cora",
                   transform=NormalizeFeatures())
    return ds, from_data(ds[0], device=device)


def _csr_pairs(graph):
    """The (CSR, weights in CSR order) pairs that the GCN's bound SpMM
    hands the kernel: forward (receiver-major) and backward (transposed),
    over the self-looped ``gcn_norm`` edge set without padding edges."""
    from pytorch_geometric_tpu_torch.models.citation import gcn_spmm_operator

    op, w = gcn_spmm_operator(graph)
    return {"fwd": (op.fwd, w[op.fwd.perm].contiguous()),
            "bwd": (op.bwd, w[op.bwd.perm].contiguous())}


def check_case(graph_name, csr, val, direction, f, dtype_name, gen):
    from pytorch_geometric_tpu_torch.ops.spmm import spmm_csr, spmm_csr_plain

    dt = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    x = torch.randn(csr.num_cols, f, generator=gen,
                    device=val.device).to(dt)
    got = spmm_csr(csr, val, x)
    want = spmm_csr_plain(csr, val, x)
    torch.cuda.synchronize()
    abs_err = float((got - want).abs().max())
    rel_err = abs_err / max(float(want.abs().max()), 1e-30)
    kernel_ms = device_ms(lambda: spmm_csr(csr, val, x))
    plain_ms = device_ms(lambda: spmm_csr_plain(csr, val, x))
    # the yardstick: one library call on the same values (the port never
    # calls it); cuSPARSE wants one dtype, so bf16 x goes up to fp32 first
    a = torch.sparse_csr_tensor(csr.row_ptr, csr.col, val,
                                (csr.num_rows, csr.num_cols))
    x32 = x.float()
    lib_out = torch.sparse.mm(a, x32)
    lib_err = float((lib_out - want).abs().max())
    library_ms = device_ms(lambda: torch.sparse.mm(a, x32))
    bound_ms, bound_by = spmm_bound(csr, f, x.element_size())
    case = {"phase": "kernel", "kernel": "spmm_csr", "graph": graph_name,
            "direction": direction, "F": f, "x": dtype_name,
            "rows": csr.num_rows, "edges": csr.num_edges,
            "longest_row": int((csr.row_ptr[1:] - csr.row_ptr[:-1]).max()),
            "max_abs_err": abs_err, "rel_err": rel_err,
            "tol": TOL[dtype_name], "ok": rel_err <= TOL[dtype_name],
            "library_max_abs_err": lib_err,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}
    emit(case)
    return case


def phase_kernel():
    from pytorch_geometric_tpu_torch.data import from_data
    from pytorch_geometric_tpu_torch.datasets import synthetic_citation_graph
    from pytorch_geometric_tpu_torch.transforms import NormalizeFeatures

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    _, cora = _cora_graph(DEVICE)
    pubmed = from_data(NormalizeFeatures()(synthetic_citation_graph(
        "pubmed", seed=SEED)), device=DEVICE)
    cases = []
    for graph_name, graph, widths in (("cora", cora, (16, 7)),
                                      ("pubmed", pubmed, (16, 128))):
        for direction, (csr, val) in _csr_pairs(graph).items():
            for f in widths:
                for dtype_name in ("fp32", "bf16"):
                    cases.append(check_case(graph_name, csr, val, direction,
                                            f, dtype_name, gen))
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} kernel case(s) disagree with the "
                             f"plain version: {bad}")
    return cases


def phase_slice():
    import numpy as np

    from pytorch_geometric_tpu_torch.models.citation import (
        gcn_spmm_operator, train_gcn)
    from pytorch_geometric_tpu_torch.ops.spmm import spmm_csr

    ds, graph = _cora_graph(DEVICE)
    spmm_csr.launches = 0
    model, metrics = train_gcn(graph, num_classes=ds.num_classes,
                               epochs=EPOCHS, seed=SEED, device=DEVICE)
    launches = spmm_csr.launches
    loss = metrics["curve"]["loss"]
    expected = 4 * EPOCHS + 2     # 2 fwd + 2 bwd per epoch, 2 for eval
    # The trained model on the card (kernel) against the plain path on the
    # CPU, same weights, dropout off.
    with torch.no_grad():
        logits = {}
        for dev in (DEVICE, "cpu"):
            m = model.to(dev)
            g = graph.to(dev)
            op, w = gcn_spmm_operator(g)
            logits[dev] = m(g, g.x, aggregate_fn=op.bind(w))
    ref = logits["cpu"]
    parity = float((logits[DEVICE].cpu() - ref).abs().max()
                   / ref.abs().max())
    result = {"phase": "slice", "dataset": "cora",
              "synthetic": ds.is_synthetic, "nodes": graph.num_nodes,
              "edges": graph.num_edges, "epochs": EPOCHS,
              "seconds": metrics["seconds"],
              "ms_per_epoch": metrics["seconds"] / EPOCHS * 1e3,
              "final_loss": float(loss[-1]),
              "train_acc": metrics["train_acc"],
              "val_acc": metrics["val_acc"], "test_acc": metrics["test_acc"],
              "spmm_csr_launches": launches,
              "expected_launches": expected,
              "logits_shape": list(ref.shape),
              "logits_cuda_vs_cpu_rel_err": parity}
    emit(result)
    if not np.isfinite(loss).all():
        raise AssertionError("non-finite training loss")
    if not (metrics["val_acc"] > 0.6 and metrics["test_acc"] > 0.6):
        raise AssertionError(f"accuracy gate: val {metrics['val_acc']}, "
                             f"test {metrics['test_acc']} (need > 0.6)")
    if launches != expected:
        raise AssertionError(f"spmm_csr launched {launches} times on the "
                             f"main path, expected {expected}")
    if not (torch.isfinite(logits[DEVICE]).all() and parity <= 1e-4):
        raise AssertionError(f"trained logits: card vs CPU rel err {parity}")
    return result


def phase_trace(epochs=20):
    """Where an epoch's time goes: ``torch.profiler`` over ``epochs``
    epochs of the same training step (after warm-up), device busy time
    per kernel name against the host's wall clock. Launches here come
    after the slice's count was read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pytorch_geometric_tpu_torch.models.citation import (
        GCN, create_gcn_train_step)

    ds, graph = _cora_graph(DEVICE)
    model = GCN(graph.num_node_features, 16, ds.num_classes,
                generator=torch.Generator().manual_seed(SEED)).to(DEVICE)
    step, _ = create_gcn_train_step(model, graph)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    for _ in range(5):
        step(gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(epochs):
            step(gen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, memsets, copies), not the host ops
    # or annotations that the profiler also credits with device time
    per_name = {}
    for e in prof.events():
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            us, n = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    kernels = [(us, name, n) for name, (us, n) in per_name.items()]
    kernels.sort(reverse=True)
    busy_us = sum(k[0] for k in kernels)
    result = {"phase": "trace", "epochs": epochs,
              "wall_ms_per_epoch": wall_us / epochs / 1e3,
              "device_busy_ms_per_epoch": busy_us / epochs / 1e3,
              "device_idle_share": (1 - busy_us / wall_us) if kernels
              else None,
              "device_ops_per_epoch": sum(k[2] for k in kernels) / epochs,
              "top": [{"name": n[:80], "us_per_epoch": us / epochs,
                       "calls_per_epoch": c / epochs}
                      for us, n, c in kernels[:10]]}
    emit(result)
    return result


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    try:
        import pytorch_geometric_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here ({exc}); run "
              "from the root of the repository", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    failed = []
    results = {}
    for name, fn in (("card", phase_card), ("build", phase_build),
                     ("kernel", phase_kernel), ("slice", phase_slice),
                     ("trace", phase_trace)):
        if failed and name != "card":
            emit({"phase": name, "skipped": f"after {failed[0]} failed"})
            continue
        try:
            results[name] = fn()
            torch.cuda.synchronize()
        except Exception as exc:   # report every phase, then fail
            traceback.print_exc()
            emit({"phase": name, "error": f"{type(exc).__name__}: {exc}"})
            failed.append(name)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1

    main_case = next(c for c in results["kernel"]
                     if c["graph"] == "cora" and c["direction"] == "fwd"
                     and c["F"] == 16 and c["x"] == "fp32")
    main_err = max(c["max_abs_err"] for c in results["kernel"]
                   if c["graph"] == "cora")
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(results["card"], flush=True)
    emit({"kernels": [{
        "name": "spmm_csr", "route": "cuda",
        "source": "pytorch_geometric_tpu_torch/csrc/spmm_csr.cu",
        "replaces": "pytorch_geometric_tpu/ops/spmm.py:56",
        "launches": results["slice"]["spmm_csr_launches"],
        "max_abs_err": main_err,
        "ms": main_case["kernel_ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
