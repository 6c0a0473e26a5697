"""The port's conv, pool, relu and channel-dropout layers against the JAX
package's, from the same numpy inputs.

Tolerances: forward values within 1e-5 (rtol and atol); gradients within
1e-5 relative, with an absolute floor of 1e-5 times the gradient's largest
entry. Both sides run f32 convolutions and pools whose sums only run in
another order (TF32 is off in the port). A conv's weight gradient sums
every output pixel of the batch (1152 products at the LeNet shape), so an
entry whose products nearly cancel carries the rounding of the large ones:
the floor scales with the gradient, as that rounding does.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_distributed_machine_learning_tpu.ops import layers as jl
from simple_distributed_machine_learning_tpu_torch.ops import layers as tl

TOL = dict(rtol=1e-5, atol=1e-5)


def _conv_inputs(seed, n, h, w, cin, cout, k):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, cin)).astype(np.float32)
    p = {"w": rng.normal(size=(k, k, cin, cout)).astype(np.float32) * 0.3,
         "b": rng.normal(size=(cout,)).astype(np.float32)}
    return x, p


def _assert_grad_close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * max(1.0, float(np.abs(ref).max())))


def _torch(p):
    return {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}


# (H, W, k, stride, padding): VALID at the LeNet shapes, SAME at stride 1
# and at stride 2 over even and odd sizes, where XLA puts the odd padding
# pixel on the high side
CONV_CASES = [(28, 28, 5, 1, "VALID"), (12, 12, 5, 1, "VALID"),
              (9, 7, 3, 2, "VALID"), (8, 8, 3, 1, "SAME"),
              (7, 9, 5, 1, "SAME"), (8, 8, 3, 2, "SAME"),
              (7, 7, 3, 2, "SAME"), (9, 6, 4, 3, "SAME")]


@pytest.mark.parametrize("h,w,k,stride,padding", CONV_CASES)
def test_conv2d_forward_and_grads_match_jax(h, w, k, stride, padding):
    x, p = _conv_inputs(h * 31 + w + k, 2, h, w, 3, 4, k)
    wy = np.random.default_rng(1).normal(
        size=np.asarray(jl.conv2d({k_: jnp.asarray(v) for k_, v in p.items()},
                                  jnp.asarray(x), stride, padding)).shape
    ).astype(np.float32)

    def jloss(p_, x_):
        return jnp.sum(jl.conv2d(p_, x_, stride, padding) * wy)

    jy = jl.conv2d(jax.tree.map(jnp.asarray, p), jnp.asarray(x), stride,
                   padding)
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, p),
                                               jnp.asarray(x))
    tp, tx = _torch(p), torch.tensor(x, requires_grad=True)
    ty = tl.conv2d(tp, tx, stride, padding)
    assert ty.shape == jy.shape
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL)
    (ty * torch.from_numpy(wy)).sum().backward()
    _assert_grad_close(tx.grad, jgx)
    for name in ("w", "b"):
        _assert_grad_close(tp[name].grad, jgp[name])


def test_conv2d_rejects_unknown_padding():
    x, p = _conv_inputs(0, 1, 8, 8, 1, 2, 3)
    with pytest.raises(ValueError, match="VALID or SAME"):
        tl.conv2d(_torch(p), torch.from_numpy(x), padding="FULL")


@pytest.mark.parametrize("window,stride,h", [(2, None, 24), (2, None, 7),
                                             (3, 2, 9), (3, 1, 6)])
def test_max_pool2d_forward_and_grad_match_jax(window, stride, h):
    x = np.random.default_rng(h).normal(size=(2, h, h + 1, 3)).astype(
        np.float32)
    jy = jl.max_pool2d(jnp.asarray(x), window, stride)
    wy = np.random.default_rng(2).normal(size=jy.shape).astype(np.float32)
    jg = jax.grad(lambda x_: jnp.sum(jl.max_pool2d(x_, window, stride)
                                     * wy))(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    ty = tl.max_pool2d(tx, window, stride)
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    (ty * torch.from_numpy(wy)).sum().backward()
    _assert_grad_close(tx.grad, jg)


def test_relu_matches_jax():
    x = np.random.default_rng(3).normal(size=(4, 5, 6)).astype(np.float32)
    np.testing.assert_array_equal(tl.relu(torch.from_numpy(x)).numpy(),
                                  np.asarray(jl.relu(jnp.asarray(x))))


@pytest.mark.parametrize("rate", [0.5, 0.25])
def test_dropout2d_zeroes_whole_channels_and_scales(rate):
    x = torch.rand((8, 5, 6, 16)) + 0.5          # no zero before the drop
    y = tl.dropout2d(torch.Generator().manual_seed(0), x, rate=rate)
    kept = y != 0
    # one draw per (sample, channel): every pixel of a channel agrees
    assert torch.equal(kept, kept[:, :1, :1, :].expand_as(kept))
    torch.testing.assert_close(y[kept], (x / (1.0 - rate))[kept])
    frac = kept[:, 0, 0, :].float().mean().item()
    assert 0.4 * (1 - rate) < frac < min(1.0, 1.6 * (1 - rate))
    # the same generator seed draws the same channels
    y2 = tl.dropout2d(torch.Generator().manual_seed(0), x, rate=rate)
    assert torch.equal(y, y2)


def test_dropout2d_is_the_identity_when_deterministic():
    x = torch.rand((2, 3, 3, 4))
    assert tl.dropout2d(torch.Generator().manual_seed(0), x,
                        deterministic=True) is x
    assert tl.dropout2d(None, x, rate=0.0) is x
    # the JAX layer's contract is the same
    jx = jnp.asarray(x.numpy())
    assert jl.dropout2d(jax.random.key(0), jx, deterministic=True) is jx


def test_dropout2d_gradient_flows_through_kept_channels():
    x = torch.rand((4, 3, 3, 8), requires_grad=True)
    y = tl.dropout2d(torch.Generator().manual_seed(5), x, rate=0.5)
    y.sum().backward()
    kept = (y != 0).float()
    torch.testing.assert_close(x.grad, kept * 2.0)


@pytest.mark.parametrize("cin,cout,k", [(1, 10, 5), (10, 20, 5), (3, 4, 3)])
def test_conv2d_init_draws_torch_bounds_in_hwio(cin, cout, k):
    p = tl.conv2d_init(torch.Generator().manual_seed(0), cin, cout, k)
    jp = jl.conv2d_init(jax.random.key(0), cin, cout, k)
    assert p["w"].shape == jp["w"].shape == (k, k, cin, cout)
    assert p["b"].shape == jp["b"].shape == (cout,)
    bound = 1.0 / math.sqrt(cin * k * k)
    for t in (p["w"], p["b"]):
        assert float(t.abs().max()) <= bound
        # U(-b, b): the draws reach well past half the bound
        assert float(t.abs().max()) > 0.5 * bound
