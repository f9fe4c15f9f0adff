"""Port parity, ``data/neighbor_loader.py``: the port's sampled batches
bitwise equal to the JAX ``NeighborSampler``'s on the same seed (senders,
receivers, masks, ``local_to_global``, and the materialized rows), over
two shuffled epochs; index-shipping batches against materialized ones;
``prefetch`` reproducing the serial stream and stopping its thread when
the consumer abandons an epoch, also while the producer waits to queue
the epoch's end or its exception; ``iter_packed`` / ``unpack`` round
trips. The port samples through its own native
``cluster.sample_neighbors`` (the JAX library's draws)."""

import threading
import time

import numpy as np
import pytest
import torch

from pytorch_geometric_tpu.data.neighbor_loader import (
    NeighborSampler as JNeighborSampler)
from pytorch_geometric_tpu_torch.data.neighbor_loader import (
    PACKED_LEAVES, NeighborSampler)

LEAVES = ("senders", "receivers", "node_mask", "edge_mask")
EXTRAS = ("seed_mask", "local_to_global")


def _graph(seed=0, n=300, e=2400, f=6):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, e), rng.integers(0, n, e), n,
            rng.normal(size=(n, f)).astype(np.float32),
            rng.integers(0, 5, n))


def _same_batch(port, ref, features=True):
    for name in LEAVES:
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in EXTRAS:
        np.testing.assert_array_equal(port.extras[name].numpy(),
                                      np.asarray(ref.extras[name]),
                                      err_msg=name)
    if features:
        np.testing.assert_array_equal(port.x.numpy(), np.asarray(ref.x))
        np.testing.assert_array_equal(port.y.numpy(), np.asarray(ref.y))


@pytest.mark.parametrize("materialize", [True, False])
def test_batches_match_jax_bitwise(materialize):
    s, r, n, x, y = _graph(1)
    kw = dict(sizes=[4, 3], node_features=x, labels=y, batch_size=32,
              seed_nodes=np.arange(0, n, 2), seed=5,
              materialize_features=materialize)
    port = NeighborSampler(s, r, n, device="cpu", **kw)
    ref = JNeighborSampler(s, r, n, **kw)
    assert (port.node_budget, port.edge_budget) == (ref.node_budget,
                                                    ref.edge_budget)
    assert len(port) == len(ref) == 5
    for _ in range(2):      # the second epoch reshuffles from the stream
        pairs = list(zip(port, ref, strict=True))
        for a, b in pairs:
            _same_batch(a, b, materialize)
            if not materialize:
                assert a.x is None and a.y is None
    g = pairs[0][0]
    assert g.num_nodes == port.node_budget and g.num_edges == \
        port.edge_budget
    assert (np.diff(g.receivers.numpy()) >= 0).all()
    assert g.senders.dtype == torch.int32 and g.edge_mask.dtype == torch.bool


def test_index_shipping_batches_match_materialized():
    s, r, n, x, y = _graph(3)
    kw = dict(sizes=[4, 4], batch_size=32, shuffle=False,
              seed_nodes=np.arange(64), seed=7)
    mat = NeighborSampler(s, r, n, node_features=x, labels=y,
                          device="cpu", **kw)
    idx = NeighborSampler(s, r, n, materialize_features=False,
                          device="cpu", **kw)
    x_dev, y_dev = idx.device_tables(x, y.astype(np.int32))
    assert x_dev.shape == (n + 1, x.shape[1])
    assert not x_dev[n].any() and y_dev[n] == 0
    for gm, gi in zip(mat, idx, strict=True):
        ids = gi.extras["local_to_global"].long()
        nm = gi.node_mask
        # padding rows point at the sentinel row: zeros, as materialized
        assert (ids[~nm] == n).all()
        np.testing.assert_array_equal(x_dev[ids].numpy(), gm.x.numpy())
        np.testing.assert_array_equal(y_dev[ids][nm].numpy(),
                                      gm.y[nm].numpy())
        np.testing.assert_array_equal(gi.senders.numpy(),
                                      gm.senders.numpy())


def test_prefetch_reproduces_serial_batches():
    s, r, n, _, _ = _graph(2, n=500, e=4000)

    def make(prefetch):
        return NeighborSampler(s, r, n, sizes=[4, 4], batch_size=64,
                               seed=9, materialize_features=False,
                               prefetch=prefetch, device="cpu")
    for serial, pre in zip(make(0), make(3), strict=True):
        _same_batch(pre, serial, features=False)


def test_prefetch_early_abandon_stops_the_producer():
    s, r, n, _, _ = _graph(4, n=400, e=3000)
    loader = NeighborSampler(s, r, n, sizes=[4], batch_size=16,
                             materialize_features=False, prefetch=2,
                             device="cpu")
    before = threading.active_count()
    for i, _ in enumerate(loader):
        if i >= 1:
            break
    # the abandoned generator closes at once (CPython) and joins its
    # producer thread
    assert threading.active_count() == before
    assert not [t for t in threading.enumerate()
                if t.name == "neighbor-sampler-prefetch"]
    # the next epoch runs whole
    assert len(list(loader)) == len(loader)


def test_prefetch_surfaces_the_producers_exception():
    s, r, n, _, _ = _graph(5)
    loader = NeighborSampler(s, r, n, sizes=[3], batch_size=64,
                             materialize_features=False, prefetch=2,
                             device="cpu")

    def fail(seeds):
        raise KeyError("from the producer")
    loader._sample = fail
    with pytest.raises(KeyError, match="from the producer"):
        list(loader)


@pytest.mark.parametrize("last", ["end", "exception"])
def test_prefetch_abandon_with_a_full_queue_stops_the_producer(last):
    """The consumer stops when the queue is full and the producer waits
    to queue its last item, the epoch's end (``prefetch`` batches left)
    or the last batch's exception (``prefetch + 1`` left): the producer
    gives up that item and the consumer's join returns."""
    s, r, n, _, _ = _graph(9, n=400, e=3000)
    prefetch = 2
    loader = NeighborSampler(s, r, n, sizes=[4], batch_size=50,
                             materialize_features=False, prefetch=prefetch,
                             device="cpu")
    num = len(loader)
    left = prefetch if last == "end" else prefetch + 1
    if last == "exception":
        sample, calls = loader._sample, []

        def fail_last(seeds):
            calls.append(1)
            if len(calls) == num:
                raise KeyError("the last batch")
            return sample(seeds)
        loader._sample = fail_last

    def consume():
        for i, _ in enumerate(loader):
            if i == num - left - 1:
                time.sleep(0.5)     # the producer fills the queue
                break
    worker = threading.Thread(target=consume, daemon=True)
    worker.start()
    worker.join(timeout=20)
    assert not worker.is_alive(), "the consumer hangs in the join"
    assert not [t for t in threading.enumerate()
                if t.name == "neighbor-sampler-prefetch"]


@pytest.mark.parametrize("prefetch", [0, 2])
def test_packed_batches_roundtrip(prefetch):
    s, r, n, _, _ = _graph(6, n=600, e=5000)

    def make(p):
        return NeighborSampler(s, r, n, sizes=[4, 4], batch_size=64, seed=3,
                               materialize_features=False, prefetch=p,
                               device="cpu")
    plain = list(make(0))
    loader = make(prefetch)
    packed = list(loader.iter_packed())
    assert len(packed) == len(plain)
    size = sum(loader.edge_budget if b == "E" else loader.node_budget
               for _, b in PACKED_LEAVES)
    for buf, g in zip(packed, plain):
        assert buf.dtype == torch.int32 and buf.shape == (size,)
        u = loader.unpack(buf)
        _same_batch(u, g, features=False)
        assert u.senders.data_ptr() == buf.data_ptr()       # a view
    with pytest.raises(ValueError, match="int32 values"):
        loader.unpack(packed[0][:-1])
    with pytest.raises(ValueError, match="index-shipping"):
        next(NeighborSampler(s, r, n, sizes=[2], device="cpu").iter_packed())


def test_loader_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    s, r, n, _, _ = _graph(8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NeighborSampler(s, r, n, sizes=[2])
