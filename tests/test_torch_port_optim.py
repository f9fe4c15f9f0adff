"""Port parity, ``utils/optim.py`` and ``data/sampler.py``:
``adam_compact`` against the JAX ``adam_compact`` over several steps fed
the same gradients (the parameters within 1e-5 of their largest
magnitude; the bf16 moments equal but for a rare rounding of an fp32
value that lies on a bf16 tie between the two: at most one bf16 step
apart), its state (the group's ``count``, each parameter's ``mu`` and
``nu``) against the JAX ``CompactAdamState``, and ``data_sampler``
bitwise.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_geometric_tpu.data.sampler import data_sampler as j_sampler
from pytorch_geometric_tpu.utils.optim import adam_compact as j_adam_compact
from pytorch_geometric_tpu_torch.data.sampler import data_sampler
from pytorch_geometric_tpu_torch.utils.optim import CompactAdam, adam_compact


def _bf16_steps_apart(a, b):
    """Largest distance in bf16 steps between two bf16 arrays of equal
    sign (the int16 patterns of finite values of one sign are ordered)."""
    ia = a.view(torch.int16).to(torch.int32)
    ib = torch.from_numpy(np.asarray(b).view(np.int16).astype(np.int32))
    return int((ia - ib).abs().max())


@pytest.mark.parametrize("lr,steps", [(0.05, 6), (1e-3, 4)])
def test_adam_compact_matches_jax_on_the_same_gradients(lr, steps):
    rng = np.random.default_rng(0)
    shapes = [(17, 5), (5,), (3, 4, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) * 10 ** -k
              for k, s in enumerate(shapes)] for _ in range(steps)]
    tx = j_adam_compact(lr)
    jp = [jnp.asarray(p) for p in params]
    st = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = adam_compact(tp, lr)
    for g in grads:
        upd, st = tx.update([jnp.asarray(a) for a in g], st, jp)
        jp = optax.apply_updates(jp, upd)
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a)
        opt.step()
    assert int(opt.param_groups[0]["count"]) == int(st.count) == steps
    for p, want, jmu, jnu in zip(tp, jp, st.mu, st.nu):
        mu, nu = opt.state[p]["mu"], opt.state[p]["nu"]
        want = np.asarray(want)
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
        assert mu.dtype == nu.dtype == torch.bfloat16
        assert _bf16_steps_apart(mu, jmu) <= 1
        assert _bf16_steps_apart(nu, jnu) <= 1


def test_adam_compact_is_adam_with_rounded_moments():
    """With fp32 moments it is torch's Adam (1e-5: torch takes the bias
    corrections in float64 on the host, this optimizer in fp32 on the
    device); the moments default to bf16, and the step count lives on
    the parameters' device."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=(8, 3)).astype(np.float32)
    a = torch.nn.Parameter(torch.from_numpy(w.copy()))
    b = torch.nn.Parameter(torch.from_numpy(w.copy()))
    ours = adam_compact([a], 0.01, moment_dtype=torch.float32)
    ref = torch.optim.Adam([b], lr=0.01)
    for _ in range(5):
        g = torch.from_numpy(rng.normal(size=w.shape).astype(np.float32))
        a.grad, b.grad = g.clone(), g.clone()
        ours.step()
        ref.step()
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    opt = adam_compact([torch.nn.Parameter(torch.ones(4, 4))], 0.01)
    assert isinstance(opt, CompactAdam) and isinstance(
        opt, torch.optim.Optimizer)
    p0, count = opt.param_groups[0]["params"][0], opt.param_groups[0]["count"]
    assert opt.state[p0]["mu"].dtype == opt.state[p0]["nu"].dtype == \
        torch.bfloat16
    assert count.dtype == torch.int32 and count.device.type == "cpu"
    opt.step()          # no gradient: nothing moves but the count
    assert int(count) == 1 and torch.equal(
        opt.param_groups[0]["params"][0], torch.ones(4, 4))


def test_adam_compact_converges_on_a_quadratic():
    rng = np.random.default_rng(2)
    d = 32
    A = rng.normal(size=(d, d)).astype(np.float32)
    A = A @ A.T / d + np.eye(d, dtype=np.float32)
    b = rng.normal(size=d).astype(np.float32)
    sol = np.linalg.solve(A, b)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    p = torch.nn.Parameter(torch.from_numpy(
        rng.normal(size=d).astype(np.float32)))
    opt = adam_compact([p], 0.1)
    for _ in range(800):
        opt.zero_grad()
        (0.5 * p @ At @ p - bt @ p).backward()
        opt.step()
    assert np.abs(p.detach().numpy() - sol).max() < 0.05


@pytest.mark.parametrize("n,train,val,seed", [(100, 0.8, 0.1, 0),
                                              (37, 0.5, 0.25, 3),
                                              (1, 0.8, 0.1, 1)])
def test_data_sampler_matches_jax_bitwise(n, train, val, seed):
    got = data_sampler(n, train, val, seed)
    want = j_sampler(n, train, val, seed)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)
    assert sum(len(a) for a in got) == n
