"""The zoo's card-against-CPU comparison of the max aggregations
(``probes/zoo_max_routes.py``: ``MaxRoutes``, ``compare``; run by
``chip_smoke.py:zoo_row``), on the CPU.

A max's gradient goes to the entry that holds the max, so two messages a
rounding apart may send it to different edges on two devices. The zoo
phase therefore holds the card's gradients to the CPU's backward routed
through the card's maxima. Here a run on slightly perturbed features
stands in for the card:

- recording the maxima changes no bit of EdgeConv's output or
  gradients;
- on a graph whose receiver holds two messages about 1e-6 apart, the
  perturbed run's maxima differ from the plain run's, the plain
  gradients then differ by a whole message's cotangent, and the CPU run
  routed through the perturbed run's maxima has the perturbed run's
  gradients again, with its output bitwise the plain run's;
- ``compare`` with such a stand-in fails the plain gradients and passes
  the routed gate;
- ``zoo_row`` of each max conv on the synthetic Cora, and the probe's
  scan over one draw.
"""

import copy

import pytest
import torch

import chip_smoke
from probes import zoo_max_routes as zr
from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.nn import conv as tc
from pytorch_geometric_tpu_torch.nn.layers import Dense


def _graph():
    """Receiver 0 gets edges from 1 and 2, whose features differ by 1e-6
    in one entry; receiver 3 gets edges from 1 and 2 too."""
    x = torch.tensor([[0.3, 0.1, 0.2], [0.5, 0.5, 0.5],
                      [0.5, 0.5, 0.5 + 1e-6], [0.2, 0.4, 0.1]])
    senders = torch.tensor([1, 2, 1, 2], dtype=torch.int32)
    receivers = torch.tensor([0, 0, 3, 3], dtype=torch.int32)
    return Graph(x=x, senders=senders, receivers=receivers), x


def _flipped(x):
    """The stand-in for the card: the two close senders trade places."""
    x = x.clone()
    x[2, 2] = 0.5 - 1e-6
    return x


def _cotangent(out):
    return torch.arange(out.numel(), dtype=out.dtype).reshape(out.shape)


def _run(conv, g, x, route=None):
    x = x.clone().requires_grad_(True)
    with zr.MaxRoutes(route) as routes:
        out = conv(g, x)
        (out * _cotangent(out)).sum().backward()
    return out.detach(), x.grad, [p.grad.clone() for p in conv.parameters()], \
        routes.records


def _edge_conv():
    gen = torch.Generator().manual_seed(0)
    return tc.EdgeConv(Dense(6, 4, generator=gen))


def test_recording_the_maxima_changes_no_bit():
    g, x = _graph()
    conv = _edge_conv()
    plain = copy.deepcopy(conv)
    xp = x.clone().requires_grad_(True)
    out = plain(g, xp)
    (out * _cotangent(out)).sum().backward()
    got, dx, grads, records = _run(conv, g, x)
    assert len(records) == 1
    assert torch.equal(got, out.detach()) and torch.equal(dx, xp.grad)
    for a, b in zip(grads, plain.parameters()):
        assert torch.equal(a, b.grad)


def test_routed_backward_follows_the_other_runs_maxima():
    g, x = _graph()
    conv = _edge_conv()
    _, dx_other, grads_other, route = _run(copy.deepcopy(conv), g,
                                           _flipped(x))
    out, dx, grads, records = _run(copy.deepcopy(conv), g, x)
    differ = int((route[0][1] != records[0][1]).sum())
    assert differ > 0
    assert float((dx - dx_other).abs().max()) > 1e-3 * float(
        dx_other.abs().max())
    routed_out, routed_dx, routed_grads, _ = _run(copy.deepcopy(conv), g, x,
                                                  route=route)
    assert torch.equal(routed_out, out)
    assert zr.rel(routed_dx, dx_other) < 1e-5
    for a, b in zip(routed_grads, grads_other):
        assert zr.rel(a, b) < 1e-5
    err, n = zr.route_errors(route, records)
    assert n == differ and err < 1e-5


def test_compare_holds_a_flipped_max_to_the_routed_backward():
    g, x = _graph()
    calls = []

    def call(m, xi, dev, ops):
        calls.append(dev)
        # the first run stands in for the card
        return m(g, xi + (_flipped(x) - x) if len(calls) == 1 else xi)

    res = zr.compare(_edge_conv(), call, lambda dev: {}, x,
                     torch.Generator().manual_seed(0), "cpu", max_aggr=True)
    assert calls == ["cpu"] * 3 and res["max_calls"] == 1
    assert res["max_routes_differ"] > 0 and res["dx_rel_err"] > 1e-3
    assert max(res["gate"]) < 1e-5
    plain = zr.compare(_edge_conv(), call, lambda dev: {}, x,
                       torch.Generator().manual_seed(0), "cpu")
    assert "max_calls" not in plain and len(plain["gate"]) == 3


@pytest.mark.parametrize("name", chip_smoke.ZOO_MAX_CONVS)
def test_zoo_row_of_the_max_convs_on_the_cpu(name, monkeypatch):
    from pytorch_geometric_tpu_torch.datasets.graphs import cora_graph

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    g = cora_graph("cpu")[1]
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    case = [c for c in chip_smoke._zoo_cases(g.num_node_features, 16, gen)
            if c[0] == name][0]
    row = chip_smoke.zoo_row(case, g, gen)
    assert row["ok"] and row["launches"] == {} and row["max_calls"] == 1
    assert row["max_routes_differ"] == 0 and row["messages_rel_err"] == 0.0
    assert row["out_shape"] == [g.num_nodes, 16]


def test_probe_scans_a_draw(capsys):
    summary = zr.main(["--device", "cpu", "--graphs", "1", "--first", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split('"conv": ')[1][:11] for line in lines[:2]] == [
        '"EdgeConv",', '"PointConv"']
    assert summary == {"graphs": 1, "first": 3, "routes_differ": 0,
                       "plain_gate_fails": 0, "routed_gate_fails": 0}
