"""The port's layers and modules against the JAX package's, on the CPU in
float32, with the JAX weights converted and every BatchNorm leaf seeded
(tests/torch_parity.py).

Tolerances: layers and modules within 1e-4 (rtol and atol): convolutions
sum in another order in XLA-CPU and in oneDNN, and a module stacks a dozen
of them.  The whole GANet within 1e-3 px of disparity: the float32 noise of
the forward (the port in float32 against itself in float64 differs by
about 4e-4 px at this shape), which the softmax over 24 bins amplifies.
The GANet_deep forward is in tests/test_torch_model_deep.py.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ganet_tpu.config import MODEL_PRESETS as J_PRESETS
from ganet_tpu.config import ganet_deep as j_ganet_deep
from ganet_tpu.config import ganet_small as j_ganet_small
from ganet_tpu.models.aggregation import SGABlock as JSGABlock
from ganet_tpu.models.feature import FeatureNet as JFeatureNet
from ganet_tpu.models.guidance import GuidanceNet as JGuidanceNet
from ganet_tpu.models.layers import BasicConv as JBasicConv
from ganet_tpu.models.layers import Conv2x as JConv2x
from ganet_tpu_torch.config import MODEL_PRESETS, ganet_deep, ganet_small
from ganet_tpu_torch.models import BasicConv, Conv2x, FeatureNet, GuidanceNet, SGABlock
from tests.torch_parity import (  # noqa: F401
    ganet_parity, load_converted, nchw, nhwc, seeded_variables, two_torch_threads,
)

TOL = dict(rtol=1e-4, atol=1e-4)
KEY = jax.random.PRNGKey(0)


def _randn(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _jax_eval(jmod, *args):
    """Seeded, converted-ready variables of a flax module and its eval output."""
    variables = seeded_variables(jax.jit(lambda k: jmod.init(k, *args, False))(KEY))
    out = jax.jit(lambda v: jmod.apply(v, *args, False))(variables)
    return variables, jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("name", sorted(J_PRESETS))
def test_presets_match(name):
    """Every field equals the JAX preset's, `channel_tp` included; the
    port's only renamed field is `impl` (JAX `sga_impl`)."""
    assert sorted(MODEL_PRESETS) == sorted(J_PRESETS)
    ours = dataclasses.asdict(MODEL_PRESETS[name]())
    theirs = dataclasses.asdict(J_PRESETS[name]())
    assert ours.pop("impl") == theirs.pop("sga_impl") == "auto"
    assert ours == theirs and ours["channel_tp"] is False


# (in, features, kernel, stride, is_3d, deconv, relu, input shape NHWC/NDHWC)
BASIC_CONV_CASES = {
    "2d_k3_s1": (4, 6, 3, 1, False, False, True, (2, 12, 12, 4)),
    "2d_k3_s2": (4, 6, 3, 2, False, False, True, (2, 12, 12, 4)),
    "2d_k5_s3": (4, 6, 5, 3, False, False, False, (2, 12, 12, 4)),
    "2d_deconv": (4, 6, 3, 2, False, True, True, (2, 6, 6, 4)),
    "3d_k3_s1": (4, 6, 3, 1, True, False, False, (1, 6, 8, 8, 4)),
    "3d_k3_s2": (4, 6, 3, 2, True, False, True, (1, 6, 8, 8, 4)),
    "3d_deconv": (4, 6, 3, 2, True, True, True, (1, 3, 4, 4, 4)),
}


@pytest.mark.parametrize("case", sorted(BASIC_CONV_CASES))
def test_basic_conv(rng, case):
    cin, feats, k, stride, is_3d, deconv, relu, shape = BASIC_CONV_CASES[case]
    x = _randn(rng, shape)
    jmod = JBasicConv(feats, k, stride=stride, is_3d=is_3d, deconv=deconv, relu=relu)
    variables, want = _jax_eval(jmod, x)
    tmod = load_converted(
        BasicConv(cin, feats, k, stride=stride, is_3d=is_3d, deconv=deconv, relu=relu), variables
    )
    with torch.no_grad():
        got = nhwc(tmod(nchw(x)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("is_3d", [False, True])
@pytest.mark.parametrize("deconv", [False, True])
def test_conv2x(rng, is_3d, deconv):
    sp_hi = (6, 8, 8) if is_3d else (12, 12)
    sp_lo = tuple(s // 2 for s in sp_hi)
    if deconv:  # up: (lo, 8 ch) + skip (hi, 4 ch) -> (hi, 4 ch)
        x, rem, cin, feats = _randn(rng, (1, *sp_lo, 8)), _randn(rng, (1, *sp_hi, 4)), 8, 4
    else:  # down: (hi, 4 ch) + skip (lo, 8 ch) -> (lo, 8 ch)
        x, rem, cin, feats = _randn(rng, (1, *sp_hi, 4)), _randn(rng, (1, *sp_lo, 8)), 4, 8
    jmod = JConv2x(feats, deconv=deconv, is_3d=is_3d)
    variables, want = _jax_eval(jmod, x, rem)
    tmod = load_converted(Conv2x(cin, feats, feats, deconv=deconv, is_3d=is_3d), variables)
    with torch.no_grad():
        got = nhwc(tmod(nchw(x), nchw(rem)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("preset", ["small", "deep"])
def test_feature_net(rng, preset):
    jcfg, tcfg = (j_ganet_small(24), ganet_small(24)) if preset == "small" else (j_ganet_deep(24), ganet_deep(24))
    x = _randn(rng, (2, 48, 96, 3))
    jmod = JFeatureNet(jcfg)
    variables, want = _jax_eval(jmod, x)
    tmod = load_converted(FeatureNet(tcfg), variables)
    with torch.no_grad():
        got = nhwc(tmod(nchw(x)))
    np.testing.assert_allclose(got, want, **TOL)


def test_guidance_net_every_output(rng):
    jcfg, tcfg = j_ganet_deep(24), ganet_deep(24)
    image = _randn(rng, (1, 48, 96, 3))
    feat = _randn(rng, (1, 16, 32, jcfg.feature_channels))
    jmod = JGuidanceNet(jcfg)
    variables, want = _jax_eval(jmod, image, feat)
    tmod = load_converted(GuidanceNet(tcfg), variables)
    with torch.no_grad():
        got = tmod(nchw(image), nchw(feat))
    assert len(got["sg_full"]) == 3 and len(got["sg_half"]) == 4
    for key in ("lg1", "lg2"):
        np.testing.assert_allclose(nhwc(got[key]), want[key], **TOL)
    for key in ("sg_full", "sg_half"):
        for g, w in zip(got[key], want[key]):
            np.testing.assert_allclose(nhwc(g), w, **TOL)


def test_sga_block(rng):
    C = 4
    jcfg, tcfg = j_ganet_small(24, sga_impl="scan"), ganet_small(24)
    x = _randn(rng, (1, 4, 6, 8, C))  # (B, D, H, W, C)
    g = _randn(rng, (1, 6, 8, 20 * C))
    jmod = JSGABlock(C, jcfg)
    variables, want = _jax_eval(jmod, x, g)
    tmod = load_converted(SGABlock(C, tcfg), variables)
    with torch.no_grad():
        got = nhwc(tmod(nchw(x), nchw(g)))
    np.testing.assert_allclose(got, want, **TOL)


def test_ganet_small_forward():
    assert ganet_parity(j_ganet_small(24, sga_impl="scan"), ganet_small(24)) <= 1e-3

