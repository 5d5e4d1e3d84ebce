"""liso_tpu_torch modules vs their liso_tpu (flax) counterparts, fp32, with
the flax weights carried over by the weight bridge (liso_tpu_torch.weights).
Every variable, norm scales, shifts and BatchNorm statistics included, is
drawn at random (`random_variables`) so that the bridging of every leaf is
tested. The JAX side runs under `jax.jit`: its eager dispatch would take
longer than its compile."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from liso_tpu.models import box_decode as jdecode
from liso_tpu.models import raft as jraft
from liso_tpu.models.box_learner import BoxLearner as JBoxLearner
from liso_tpu.models.centerpoint import CenterPointNet as JCenterPoint
from liso_tpu.ops.bev import BevSetup as JBev
from liso_tpu_torch.models import box_decode, raft
from liso_tpu_torch.models.box_learner import BoxLearner
from liso_tpu_torch.models.centerpoint import CenterPointNet
from liso_tpu_torch.ops.bev import BevSetup
from liso_tpu_torch.weights import load_flax_variables

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)


def random_variables(init, *args, seed, small=("heads_conv2",)):
    """A flax variables tree for `init(KEY, *args)`, drawn with numpy from
    `seed` on the shapes of `jax.eval_shape` (the init is traced, never
    compiled): kernels ~ N(0, 1/fan_in) (N(0, 1e-2) under a module named in
    `small`, as flax inits the flow heads), norm scales ~ 1 + 0.2 N, biases
    and BatchNorm means ~ 0.2 N, variances ~ U(0.5, 1.5). Every norm leaf is
    non-trivial, so the bridging of every norm is tested."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        keys = [p.key for p in path]
        name, shape = keys[-1], x.shape
        if name == "kernel":
            std = 1e-2 if set(keys) & set(small) else np.prod(shape[:-1]) ** -0.5
            return (std * rng.randn(*shape)).astype(np.float32)
        if name == "scale":
            return (1 + 0.2 * rng.randn(*shape)).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.2 * rng.randn(*shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        raise KeyError(f"no random init for leaf {'/'.join(keys)}")

    return jax.tree_util.tree_map_with_path(
        leaf, dict(jax.eval_shape(init, KEY, *args))
    )


def t(x):
    return torch.from_numpy(np.array(x))


def nchw(x):
    return t(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("hw", [(32, 32), (40, 24)])
def test_joint_encoder(hw):
    """Even and non-multiple-of-8 inputs: XLA 'SAME' padding on the
    stride-2 convs (7x7 pads (2, 3), 3x3 pads (0, 1))."""
    x = np.random.RandomState(0).randn(2, *hw, 16).astype(np.float32)
    jm = jraft.JointEncoder(fmap_dim=128, ctx_dim=160)
    v = random_variables(jm.init, jnp.asarray(x), seed=1)
    want_f, want_c = jax.jit(jm.apply)(v, jnp.asarray(x))
    tm = load_flax_variables(raft.JointEncoder(16, 128, 160), v)
    with torch.no_grad():
        got_f, got_c = tm(nchw(x))
    np.testing.assert_allclose(
        got_f.permute(0, 2, 3, 1).numpy(), np.asarray(want_f), atol=1e-4, rtol=1e-4
    )
    np.testing.assert_allclose(
        got_c.permute(0, 2, 3, 1).numpy(), np.asarray(want_c), atol=1e-4, rtol=1e-4
    )


def test_small_update_block():
    rng = np.random.RandomState(2)
    b, h, w, corr_c = 2, 8, 8, 3 * 49
    net = np.tanh(rng.randn(b, h, w, 96)).astype(np.float32)
    inp = np.maximum(rng.randn(b, h, w, 64), 0).astype(np.float32)
    corr = rng.randn(b, h, w, corr_c).astype(np.float32)
    flow = rng.randn(b, h, w, 2).astype(np.float32)
    logits = rng.randn(b, h, w, 4).astype(np.float32)
    args = [jnp.asarray(a) for a in (net, inp, corr, flow, logits)] + [None]
    jm = jraft.SmallUpdateBlock(96)
    v = random_variables(jm.init, *args, seed=3)
    want = jax.jit(jm.apply)(v, *args)
    tm = load_flax_variables(raft.SmallUpdateBlock(corr_c, 96, 64), v)
    with torch.no_grad():
        got = tm(nchw(net), nchw(inp), nchw(corr), nchw(flow), nchw(logits))
    for g, wv in zip(got, want[:3]):
        np.testing.assert_allclose(
            g.permute(0, 2, 3, 1).numpy(), np.asarray(wv), atol=1e-4, rtol=1e-4
        )


def test_raft_flow_from_features(monkeypatch):
    """Both sides round corr to bf16 (fused lookup)."""
    monkeypatch.setenv("LISO_CORR_PATH", "fused")
    rng = np.random.RandomState(4)
    img0 = rng.randn(1, 64, 64, 8).astype(np.float32)
    img1 = img0 + 0.3 * rng.randn(1, 64, 64, 8).astype(np.float32)
    jm = jraft.RAFT(num_iters=2, corr_levels=4, resolution_m=100 / 64)
    v = random_variables(jm.init, jnp.asarray(img0), jnp.asarray(img1), seed=5)
    encode = jax.jit(lambda v, x: jm.apply(v, x, method=jraft.RAFT.encode))
    fmap0, cn0 = encode(v, jnp.asarray(img0))
    fmap1, _ = encode(v, jnp.asarray(img1))
    want = jax.jit(
        lambda v, f0, c0, f1: jm.apply(v, f0, c0, f1, upsample_all=True,
                                       method=jraft.RAFT.flow_from_features)
    )(v, fmap0, cn0, fmap1)
    tm = load_flax_variables(
        raft.RAFT((64, 64), in_channels=8, num_iters=2, resolution_m=100 / 64), v
    )
    with torch.no_grad():
        f0, c0 = tm.encode(t(img0))
        np.testing.assert_allclose(f0.numpy(), np.asarray(fmap0), atol=1e-4, rtol=1e-4)
        got = tm.flow_from_features(t(fmap0), t(cn0), t(fmap1), upsample_all=True)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=1e-3)


def test_upsample_bilinear():
    x = np.random.RandomState(6).randn(2, 5, 7, 3).astype(np.float32)
    want = jraft.upsample_bilinear(jnp.asarray(x), 8)
    got = raft.upsample_bilinear(nchw(x), 8).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _cloud(seed, n=1024, b=2):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-45, 45, (b, n, 4)).astype(np.float32)
    pts[..., 2] = rng.uniform(-3, 3, (b, n))
    valid = rng.rand(b, n) > 0.05
    return pts, valid


def test_centerpoint_net():
    pts, valid = _cloud(7)
    jb = JBev((100.0, 100.0), (64, 64))
    jm = JCenterPoint(jb)
    v = random_variables(jm.init, jnp.asarray(pts), jnp.asarray(valid), seed=8)
    want, want_occ = jax.jit(jm.apply)(v, jnp.asarray(pts), jnp.asarray(valid))
    tm = load_flax_variables(CenterPointNet(BevSetup((100.0, 100.0), (64, 64))), v)
    tm.eval()  # the JAX side applies with train=False: BN running stats
    with torch.no_grad():
        got, got_occ = tm(t(pts), t(valid))
    np.testing.assert_array_equal(got_occ.numpy(), np.asarray(want_occ))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(
            got[k].numpy(), np.asarray(want[k]), atol=1e-4, rtol=1e-4, err_msg=k
        )


@pytest.mark.parametrize("baseline", [True, False],
                         ids=["baseline", "non_baseline"])
def test_centerpoint_net_configurations(baseline):
    """CenterPointNet with use_baseline_parameters True (the three-stage RPN,
    predictions at /4) and False (the two-stage RPN and a stride-2 shared
    conv, whose XLA SAME padding is asymmetric: predictions at /8), eval
    mode, maps within 1e-4."""
    pts, valid = _cloud(11)
    jm = JCenterPoint(JBev((100.0, 100.0), (64, 64)),
                      use_baseline_parameters=baseline)
    v = random_variables(jm.init, jnp.asarray(pts), jnp.asarray(valid), seed=12)
    want, _ = jax.jit(jm.apply)(v, jnp.asarray(pts), jnp.asarray(valid))
    tm = load_flax_variables(CenterPointNet(
        BevSetup((100.0, 100.0), (64, 64)), use_baseline_parameters=baseline), v)
    tm.eval()
    with torch.no_grad():
        got, _ = tm(t(pts), t(valid))
    assert tm.out_downsample_factor == jm.out_downsample_factor == (4 if baseline else 8)
    side = 64 // tm.out_downsample_factor
    for k in want:
        assert tuple(got[k].shape[1:3]) == (side, side)
        np.testing.assert_allclose(
            got[k].numpy(), np.asarray(want[k]), atol=1e-4, rtol=1e-4, err_msg=k
        )


def test_box_learner():
    pts, valid = _cloud(9)
    jm = JBoxLearner(JBev((100.0, 100.0), (64, 64)), network="centerpoint")
    v = random_variables(jm.init, jnp.asarray(pts), jnp.asarray(valid), seed=10)
    want = jax.jit(lambda v, p, m: jm.apply(v, p, m)[0])(
        v, jnp.asarray(pts), jnp.asarray(valid)
    )
    tm = load_flax_variables(BoxLearner(BevSetup((100.0, 100.0), (64, 64))), v)
    tm.eval()  # the JAX side applies with train=False: BN running stats
    with torch.no_grad():
        got = tm(t(pts), t(valid))[0]
    for f in ("pos", "dims", "rot", "probs", "velo"):
        np.testing.assert_allclose(
            getattr(got, f).numpy(), np.asarray(getattr(want, f)),
            atol=1e-4, rtol=1e-4, err_msg=f,
        )
    for f in ("valid", "class_id", "difficulty"):
        np.testing.assert_array_equal(
            getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f
        )
    # PointPillars and PointRCNN have their own pipelines, as in JAX
    with pytest.raises(NotImplementedError):
        BoxLearner(BevSetup((100.0, 100.0), (64, 64)), network="pointpillars")


DECODE_CFGS = {
    "centerpoint": {},
    "global_relative_2d_aspect_direct": dict(
        position_method="global_relative", num_box_pos_dims=2,
        dimensions_method="predict_aspect_ratio", rotation_method="direct",
        activations={"pos": "tanh", "dims": "sigmoid", "probs": "sigmoid"},
    ),
    "global_absolute_log_bins": dict(
        position_method="global_absolute", dimensions_method="predict_log_size",
        rotation_method="class_bins",
        activations={"dims": "exp", "probs": "sigmoid"},
    ),
    "local_offset_2d_norm_vector": dict(
        num_box_pos_dims=2, norm_vector_len=True,
    ),
}


@pytest.mark.parametrize("name", DECODE_CFGS)
def test_decode_box_maps(name):
    """apply_activations + decode_box_maps + flatten_to_boxes for each
    position, dimension and rotation method."""
    kw = DECODE_CFGS[name]
    jcfg, tcfg = jdecode.BoxPredictionCfg(**kw), box_decode.BoxPredictionCfg(**kw)
    assert tcfg.head_channels() == jcfg.head_channels()
    rng = np.random.RandomState(12)
    raw = {k: rng.randn(2, 6, 5, c).astype(np.float32)
           for k, c in jcfg.head_channels()}
    want = jdecode.flatten_to_boxes(jdecode.decode_box_maps(
        jdecode.apply_activations({k: jnp.asarray(v) for k, v in raw.items()}, jcfg),
        jcfg, JBev((100.0, 80.0), (48, 40)),
    ))
    got = box_decode.flatten_to_boxes(box_decode.decode_box_maps(
        box_decode.apply_activations({k: t(v) for k, v in raw.items()}, tcfg),
        tcfg, BevSetup((100.0, 80.0), (48, 40)),
    ))
    for f in ("pos", "dims", "rot", "probs", "velo"):
        np.testing.assert_allclose(
            getattr(got, f).numpy(), np.asarray(getattr(want, f)),
            atol=1e-5, rtol=1e-5, err_msg=f,
        )
    for f in ("valid", "class_id", "difficulty"):
        np.testing.assert_array_equal(
            getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f
        )


def test_bridge_requires_every_leaf_on_both_sides():
    x = jnp.zeros((1, 16, 16, 4))
    jm = jraft.JointEncoder(fmap_dim=8, ctx_dim=8)
    v = random_variables(jm.init, x, seed=11)
    load_flax_variables(raft.JointEncoder(4, 8, 8), v)  # all matched

    extra = {"params": dict(v["params"], stray={"kernel": np.zeros((1, 1, 4, 4))})}
    with pytest.raises(KeyError, match="stray"):
        load_flax_variables(raft.JointEncoder(4, 8, 8), extra)

    missing = {"params": {k: p for k, p in v["params"].items() if k != "ctx_head"}}
    with pytest.raises(KeyError, match="ctx_head"):
        load_flax_variables(raft.JointEncoder(4, 8, 8), missing)

    with pytest.raises(ValueError, match="shape"):
        load_flax_variables(raft.JointEncoder(4, 16, 8), v)
