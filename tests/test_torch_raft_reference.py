"""The reference layout of RAFT in the port (liso_tpu_torch/models/raft.py:
the twin towers, `torch_compat`, the norms, `predict_logits=False`) and
the reference-checkpoint loader (liso_tpu_torch/models/torch_compat.py)
against the JAX package, fp32, on the CPU.

No reference checkpoint is in the repository, so both packages get the same
random state_dict in the reference's layout
(`torch_compat.random_reference_state_dict`): JAX through its
`convert_raft_state_dict` and flax's `RAFT(joint_encoders=False,
torch_compat=True, predict_weight_for_static_aggregation=True)`, the port
through `load_reference_raft`. JAX runs its fused corr path
(LISO_CORR_PATH=fused), whose bf16-rounded corr values the port's plain
lookup takes too.

Tolerances: flow 2e-3 m (the serving parity limit, tests/test_torch_serve.py)
and logits and the weight logit 5e-4. The corr taps are rounded to bf16,
and a tap whose fp32 value differs in its last bits between oneDNN's and
XLA's convolutions can round to the neighbouring bf16 value, 2^-8 of it;
measured here 2.9e-4 m in flow, 2.1e-4 in a logit and 3.5e-4 in the weight
logit after 2 iterations, 1.3e-4 in a logit after the first. With the taps
in fp32 on both sides (JAX's gather path, the port's plain pyramid and
gather) all three meet FP32_TAPS_ATOL, 1e-4 (measured 3.8e-6 m, 3.3e-6 and
2.2e-6), which shows that cause; the encoders' features and
the flow head 1e-4; the gradient of a weighted output
sum 3e-2 of each tensor's norm (the train-step parity limit; the fused corr
backward rounds its cotangent to bf16 on both sides), except the conv
biases that feed a norm, whose gradient is 0 in exact arithmetic and is
held to 1e-6 of their weight's gradient; the converted parameters bitwise.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from liso_tpu.models import raft as jraft
from liso_tpu.models.torch_compat import convert_raft_state_dict as j_convert
from liso_tpu_torch.models import raft
from liso_tpu_torch.models import torch_compat
from liso_tpu_torch.weights import flax_state_dict, load_flax_variables
from test_torch_modules import random_variables

torch.set_num_threads(1)
GRID, ITERS, RES_M, SEED = 64, 2, 0.2, 7
FLOW_ATOL = 2e-3
LOGIT_ATOL = 5e-4
FP32_TAPS_ATOL = 1e-4
FEAT_ATOL = 1e-4
GRAD_REL = 3e-2
ZERO_GRAD_REL = 1e-6
NORMS = ("instance_affine", "instance", "group", "none")


def _t(x):
    return torch.from_numpy(np.array(x))


def _images(seed, grid=GRID, c=64):
    rng = np.random.RandomState(seed)
    img0 = rng.randn(1, grid, grid, c).astype(np.float32)
    img1 = (0.5 * img0 + 0.1
            + 0.3 * rng.randn(*img0.shape)).astype(np.float32)
    return img0, img1


@pytest.fixture(scope="module")
def reference():
    """JAX's converted twin-tower RAFT on a random reference state_dict:
    its outputs and the parameter gradient of a weighted output sum, in
    one compile; the port's loaded network and its own."""
    mp = pytest.MonkeyPatch()
    mp.setenv("LISO_CORR_PATH", "fused")
    try:
        sd = torch_compat.random_reference_state_dict(
            SEED, raft.corr_channels((GRID, GRID)))
        jparams = j_convert(sd)
        img0, img1 = _images(3)
        jm = jraft.RAFT(num_iters=ITERS, joint_encoders=False,
                        torch_compat=True, resolution_m=RES_M,
                        predict_weight_for_static_aggregation=True)
        shape = jax.eval_shape(lambda p: jm.apply({"params": p},
                                                  jnp.asarray(img0),
                                                  jnp.asarray(img1)), jparams)
        w = np.random.RandomState(4).randn(*shape.shape).astype(np.float32)

        @jax.jit
        def out_and_grad(p):
            out, vjp = jax.vjp(lambda q: jm.apply(
                {"params": q}, jnp.asarray(img0), jnp.asarray(img1)), p)
            return out, vjp(jnp.asarray(w))[0]

        jout, jgrad = out_and_grad(jparams)
        jout, jgrad = np.asarray(jout), jax.tree_util.tree_map(np.asarray, jgrad)
    finally:
        mp.undo()
    tm = torch_compat.load_reference_raft(
        {k: torch.from_numpy(v) for k, v in sd.items()}, (GRID, GRID),
        num_iters=ITERS, resolution_m=RES_M, device="cpu")
    out = tm(_t(img0), _t(img1))
    (out * _t(w)).sum().backward()
    return dict(sd=sd, jparams=jparams, jout=jout, jgrad=jgrad, tm=tm,
                out=out.detach())


def test_converted_params_are_jaxs_bitwise(reference):
    """The port's copy of the converter gives JAX's tree, leaf for leaf,
    and load_reference_raft fills the network with exactly that tree
    carried by the weight bridge."""
    mine = torch_compat.convert_raft_state_dict(reference["sd"])
    jl = jax.tree_util.tree_leaves_with_path(reference["jparams"])
    ml = jax.tree_util.tree_leaves_with_path(mine)
    assert [p for p, _ in jl] == [p for p, _ in ml]
    for (path, a), (_, b) in zip(jl, ml):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    want = flax_state_dict(reference["tm"], {"params": reference["jparams"]})
    got = reference["tm"].state_dict()
    assert set(want) == set(got)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_every_reference_key_is_read(reference):
    """The random state_dict holds exactly the keys the converter reads."""
    class Recording(dict):
        def __init__(self, d):
            super().__init__(d)
            self.read = set()

        def __getitem__(self, k):
            self.read.add(k)
            return super().__getitem__(k)

        def get(self, k, default=None):
            if k in self:
                self.read.add(k)
            return super().get(k, default)

    sd = Recording(reference["sd"])
    torch_compat.convert_raft_state_dict(sd)
    assert sd.read == set(sd)


def test_load_reference_raft_matches_jax(reference):
    """Per-iteration flow (m), logits, the static-aggregation weight logit;
    static and dynamic flow are the same tensor."""
    got, want = reference["out"].numpy(), reference["jout"]
    assert got.shape == want.shape == (ITERS, 1, GRID, GRID, 9)
    np.testing.assert_allclose(got[..., 4:8], want[..., 4:8], atol=FLOW_ATOL,
                               rtol=0, err_msg="flow")
    np.testing.assert_allclose(got[..., :4], want[..., :4], atol=LOGIT_ATOL,
                               rtol=LOGIT_ATOL, err_msg="logits")
    np.testing.assert_allclose(got[..., 8:], want[..., 8:], atol=LOGIT_ATOL,
                               rtol=LOGIT_ATOL, err_msg="weight logit")
    assert np.array_equal(got[..., 4:6], got[..., 6:8])
    assert np.abs(want[-1, ..., 4:6]).max() > 0.05  # the flow moves


def test_logits_meet_1e4_with_fp32_corr_taps(reference, monkeypatch):
    """LOGIT_ATOL's cause: with the corr taps in fp32 on both sides (JAX's
    gather path; the port's plain fp32 pyramid and gather in place of the
    bf16 window lookup) the flow, the logits and the weight logit meet
    FP32_TAPS_ATOL."""
    img0, img1 = _images(3)
    monkeypatch.setenv("LISO_CORR_PATH", "gather")
    jm = jraft.RAFT(num_iters=ITERS, joint_encoders=False, torch_compat=True,
                    resolution_m=RES_M,
                    predict_weight_for_static_aggregation=True)
    want = np.asarray(jax.jit(lambda p: jm.apply(
        {"params": p}, jnp.asarray(img0), jnp.asarray(img1)))(
            reference["jparams"]))

    def fp32_window(f0_flat, fmap1, coords, num_levels, radius):
        b, h, w, c = fmap1.shape
        pyramid = raft.build_corr_pyramid(f0_flat.reshape(b, h, w, c), fmap1,
                                          num_levels)
        return raft.lookup_corr(pyramid, coords.permute(0, 2, 3, 1),
                                radius).permute(0, 3, 1, 2)

    monkeypatch.setattr(raft, "pool_f1_levels", lambda f1, n: (f1, n))
    monkeypatch.setattr(raft, "corr_window_features", fp32_window)
    with torch.no_grad():
        got = reference["tm"](_t(img0), _t(img1)).numpy()
    for sl, what in ((np.s_[..., 4:8], "flow"), (np.s_[..., :4], "logits"),
                     (np.s_[..., 8:], "weight logit")):
        np.testing.assert_allclose(got[sl], want[sl], atol=FP32_TAPS_ATOL,
                                   rtol=FP32_TAPS_ATOL, err_msg=what)


def _feeds_a_norm(name: str) -> bool:
    """fnet's convs before an instance norm: the stem, every block conv
    and `down`; cnet has no norm and its head (conv2) none either."""
    return (name.startswith("fnet.") and name.endswith(".bias")
            and not name.startswith("fnet.conv2"))


def test_gradient_through_the_plain_corr_backward(reference):
    tm = reference["tm"]
    want = flax_state_dict(tm, {"params": reference["jgrad"]})
    bad = {}
    for k, p in tm.named_parameters():
        if _feeds_a_norm(k) and "norm" not in k:
            wn = float(want[k[:-4] + "weight"].norm())
            for g in (p.grad, want[k]):
                if not float(g.norm()) <= ZERO_GRAD_REL * wn:
                    bad[k] = float(g.norm()) / wn
            continue
        rel = float((p.grad - want[k]).norm() / want[k].norm())
        if not rel <= GRAD_REL:
            bad[k] = rel
    assert not bad, bad


@pytest.mark.parametrize("torch_compat_layout", [False, True])
@pytest.mark.parametrize("norm", NORMS)
def test_small_encoder(norm, torch_compat_layout):
    """Every norm kind of the reference's tower, in both padding layouts
    (torch_compat also keeps the second blocks' `down`), against flax's
    SmallEncoder on an odd-sized image."""
    rng = np.random.RandomState(11)
    x = rng.randn(1, 37, 42, 16).astype(np.float32)
    jm = jraft.SmallEncoder(output_dim=64, norm_fn=norm,
                            torch_compat=torch_compat_layout)
    v = random_variables(jm.init, jnp.asarray(x), seed=12)
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    tm = load_flax_variables(
        raft.SmallEncoder(16, 64, norm, torch_compat=torch_compat_layout), v)
    with torch.no_grad():
        got = tm(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 5, 6, 64)
    np.testing.assert_allclose(got, want, atol=FEAT_ATOL, rtol=FEAT_ATOL)
    has_down = [n for n, _ in tm.named_modules() if n.endswith(".down")]
    assert len(has_down) == (4 if torch_compat_layout else 2)


def test_unknown_norm_raises():
    with pytest.raises(ValueError, match="unknown norm"):
        raft.SmallEncoder(16, 64, "batch")


def test_flow_cls_head():
    rng = np.random.RandomState(13)
    x = rng.randn(1, 9, 11, 96).astype(np.float32)
    jm = jraft.FlowClsHead(128, 3)
    v = random_variables(jm.init, jnp.asarray(x), seed=14)
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    tm = load_flax_variables(raft.FlowClsHead(96, 128, 3), v)
    with torch.no_grad():
        got = tm(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=FEAT_ATOL, rtol=FEAT_ATOL)


@pytest.mark.parametrize("joint", [True, False])
def test_raft_without_logits(monkeypatch, joint):
    """predict_logits=False (the flow branch of the motion encoder and the
    static flow head alone) with either tower layout: flow and weight
    logit against JAX; the logits stay 0."""
    monkeypatch.setenv("LISO_CORR_PATH", "fused")
    img0, img1 = _images(5, grid=32, c=8)
    jm = jraft.RAFT(num_iters=ITERS, resolution_m=1.0, predict_logits=False,
                    joint_encoders=joint,
                    predict_weight_for_static_aggregation=True)
    v = random_variables(jm.init, jnp.asarray(img0), jnp.asarray(img1),
                         seed=6, small=("conv2",))
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(img0),
                                        jnp.asarray(img1)))
    tm = load_flax_variables(raft.RAFT(
        (32, 32), in_channels=8, num_iters=ITERS, resolution_m=1.0,
        predict_logits=False, joint_encoders=joint,
        predict_weight_for_static_aggregation=True), v)
    assert not hasattr(tm.update_block, "heads_conv1")
    with torch.no_grad():
        got = tm(_t(img0), _t(img1)).numpy()
    assert got.shape == want.shape == (ITERS, 1, 32, 32, 9)
    assert not got[..., :4].any() and not want[..., :4].any()
    np.testing.assert_allclose(got[..., 4:8], want[..., 4:8], atol=FLOW_ATOL,
                               rtol=0)
    np.testing.assert_allclose(got[..., 8:], want[..., 8:], atol=LOGIT_ATOL,
                               rtol=LOGIT_ATOL)


def test_torch_compat_needs_the_twin_towers():
    with pytest.raises(ValueError, match="twin-tower"):
        raft.RAFT((32, 32), joint_encoders=True, torch_compat=True,
                  device="cpu")
    img = jnp.zeros((1, 32, 32, 4))
    with pytest.raises(AssertionError, match="twin-tower"):
        jraft.RAFT(joint_encoders=True, torch_compat=True).init(
            jax.random.PRNGKey(0), img, img)


def test_load_reference_raft_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sd = torch_compat.random_reference_state_dict(
        0, raft.corr_channels((GRID, GRID)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_compat.load_reference_raft(sd, (GRID, GRID))


def test_corr_lookup_dispatch(monkeypatch):
    """make_corr_lookup / lookup_corr_dispatch over a materialised pyramid
    against JAX's gather path (fp32)."""
    monkeypatch.setenv("LISO_CORR_PATH", "gather")
    rng = np.random.RandomState(15)
    f0 = rng.randn(1, 12, 10, 16).astype(np.float32)
    f1 = rng.randn(1, 12, 10, 16).astype(np.float32)
    coords = rng.uniform(-4, 15, (1, 12, 10, 2)).astype(np.float32)
    jpyr = jraft.build_corr_pyramid(jnp.asarray(f0), jnp.asarray(f1), 3)
    want = np.asarray(jraft.lookup_corr_dispatch(jpyr, jnp.asarray(coords)))
    tpyr = raft.build_corr_pyramid(_t(f0), _t(f1), 3)
    got = raft.lookup_corr_dispatch(tpyr, _t(coords))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert np.array_equal(raft.make_corr_lookup(tpyr)(_t(coords)).numpy(),
                          got.numpy())
