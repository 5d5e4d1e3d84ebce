"""Kernel K5's plain version (liso_tpu_torch/ops/corr_fused.py
`corr_window_bwd_plain`) vs liso_tpu's fused backward
(`corr_fused_pallas._fused_bwd_impl`, Pallas in interpret mode off the TPU)
at several coarse sizes, and the port's autograd of `fused_corr_window` vs
`jax.vjp` of the JAX one. Both quantise the corr cotangent to bf16 per
element (d = bf16(g * scale)) and sum exact bf16 x bf16 products in fp32,
in other orders: the results agree within the recursive-sum bound of
`bwd_sum_order_slack`. The CUDA kernel is held to the plain version on the
card (tests/test_torch_cuda_kernels.py, chip_smoke.py)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from liso_tpu.ops import corr_fused_pallas as jcf
from liso_tpu_torch.ops import corr_fused as tcf

torch.set_num_threads(1)
RADIUS = 3


def _inputs(h, c, b=2, seed=0):
    rng = np.random.RandomState(seed)
    f0 = rng.randn(b, h * h, c).astype(np.float32)
    f1 = rng.randn(b, h, h, c).astype(np.float32)
    coords = rng.uniform(-6, h + 6, (b, 2, h * h)).astype(np.float32)
    coords[:, 0, 0] = -1e4  # far out of range: no tap contributes
    coords[:, 1, 1] = 5e3
    f1cat_j, lv = jcf.pool_f1_levels(jnp.asarray(f1), 4)
    nt = len(lv.shapes) * (2 * RADIUS + 2) ** 2
    g = rng.randn(b, nt, h * h).astype(np.float32)
    return f0, f1, f1cat_j, lv, coords, g


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("h,c", [(4, 32), (8, 32), (16, 32), (8, 128)])
def test_plain_bwd_matches_pallas_kernel(h, c):
    f0, _, f1cat_j, lv_j, coords, g = _inputs(h, c, seed=h + c)
    want0, want1 = jcf._fused_bwd_impl(
        jnp.asarray(f0), f1cat_j, jnp.asarray(coords), jnp.asarray(g), lv_j,
        RADIUS, interpret=True,
    )
    f1cat = _t(f1cat_j.astype(jnp.float32)).to(torch.bfloat16)
    lv = tcf.level_geometry(h, h, 4)
    args = (_t(f0), f1cat, _t(coords), _t(g), lv, RADIUS)
    got0, got1 = tcf.corr_window_bwd(*args)
    s0, s1 = tcf.bwd_sum_order_slack(*args)
    for got, want, slack in ((got0, want0, s0), (got1, want1, s1)):
        want = _t(want)
        assert got.shape == want.shape and got.dtype == torch.float32
        err = (got - want).abs()
        assert bool((err <= slack + 1e-30).all()), float((err - slack).max())
    # the far-away pixels get no df0
    assert bool((got0[:, :2] == 0).all())


@pytest.mark.parametrize("h", [8, 16])
def test_autograd_matches_jax_vjp(h):
    """d(sum(taps * w)) / d(f0, fmap1) through pool_f1_levels: the port's
    autograd Function vs jax.vjp of fused_corr_window (custom VJP, Pallas
    interpret). df1 is rounded to bf16 on both sides before the pooling
    VJP, so an fp32 sum-order difference can move it by one bf16 ulp."""
    c = 32
    f0, f1, _, lv_j, coords, w = _inputs(h, c, seed=7 * h)

    def jloss(f0, f1):
        f1cat, lv = jcf.pool_f1_levels(f1, 4)
        return jnp.sum(jcf.fused_corr_window(f0, f1cat, coords, lv, RADIUS) * w)

    jd0, jd1 = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(f0), jnp.asarray(f1))
    tf0 = _t(f0).requires_grad_()
    tf1 = _t(f1).requires_grad_()
    f1cat, lv = tcf.pool_f1_levels(tf1, 4)
    (tcf.fused_corr_window(tf0, f1cat, _t(coords), lv, RADIUS) * _t(w)).sum().backward()
    d0 = np.asarray(jd0)
    np.testing.assert_allclose(tf0.grad.numpy(), d0, rtol=1e-5,
                               atol=1e-5 * np.abs(d0).max())
    d1 = np.asarray(jd1)
    np.testing.assert_allclose(tf1.grad.numpy(), d1, rtol=2**-7,
                               atol=2**-8 * np.abs(d1).max())
