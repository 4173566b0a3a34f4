"""The port's bfloat16 path held against the JAX package, on the CPU.

Every other parity test runs in float32, while the card runs the models
with compute_dtype "bfloat16".  The two frameworks round to bf16 at other
places (a convolution's output, a BatchNorm's scale, the sweeps' carries),
so the port's bf16 output cannot equal JAX's.  The gate bounds the port's
bf16 error by JAX's own instead: on the same inputs and the same converted
seeded weights,

    mean |port bf16 - JAX f32|  <=  FACTOR * mean |JAX bf16 - JAX f32|,

FACTOR = 1.5, per module (`BasicConv`, `SGABlock`, `DispAggHead`) and for
the whole GANet_small and GANet_deep at 48x96, max_disp 24 (disparity in
px).  A bf16 fault of the port (a tensor left in f32, a reduction in bf16,
a rounding step too many) moves the left side by whole multiples of the
right.

Measured by this file on the CPU (`-s` prints them): BasicConv 0.843,
SGABlock 0.889, DispAggHead 0.616 (the port's head is closer to JAX f32
than JAX's own bf16 head), GANet_small 0.917, GANet_deep 1.164.  Before
the eval BatchNorm took JAX's rounding (flax's `BatchNorm` in float32,
rounded once; the BatchNorm of a 3D conv folded into its weights, as
`FoldableBN` does), where the port had rounded s, t, the product and the
sum in bf16, they were 1.004, 1.143, 0.616, 1.147 and 1.289.  GANet_deep's
remaining excess is XLA's, not the port's: XLA may keep a value in
float32 where the program rounds it to bf16
(`--xla_allow_excess_precision`, on by default), and skips the rounding of
a conv's output before its BatchNorm; with that flag off JAX's feature net
and the port's agree (factor 1.00 at its first conv) and the deep model's
factor is 0.91.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganet_tpu.config import ganet_deep as j_ganet_deep
from ganet_tpu.config import ganet_small as j_ganet_small
from ganet_tpu.models.aggregation import DispAggHead as JDispAggHead
from ganet_tpu.models.aggregation import SGABlock as JSGABlock
from ganet_tpu.models.ganet import GANet as JGANet
from ganet_tpu.models.layers import BasicConv as JBasicConv
from ganet_tpu_torch.entry import build_model, predict
from ganet_tpu_torch.config import ganet_deep, ganet_small
from ganet_tpu_torch.convert import convert_flax_variables
from ganet_tpu_torch.models import BasicConv, SGABlock
from ganet_tpu_torch.models.aggregation import DispAggHead
from tests.torch_parity import load_converted, nchw, nhwc, seeded_variables, two_torch_threads  # noqa: F401

FACTOR = 1.5
KEY = jax.random.PRNGKey(0)


def _mean_abs(a, b) -> float:
    return float(np.mean(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


def _check(name, port16, jax32, jax16):
    ours, theirs = _mean_abs(port16, jax32), _mean_abs(jax16, jax32)
    print(f"{name}: port bf16 {ours:.4g}, JAX bf16 {theirs:.4g} from JAX f32: factor {ours / theirs:.3f}")
    assert np.isfinite(port16).all()
    assert theirs > 0 and ours <= FACTOR * theirs, (name, ours, theirs)


def _bf16(a: np.ndarray) -> np.ndarray:
    """a rounded to bf16, as float32: the input both bf16 runs get."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _jax_pair(make, args16, args32):
    """(variables, f32 output, bf16 output) of a flax module built by
    make(dtype) on f32 and bf16-rounded inputs, one set of seeded variables."""
    j32, j16 = make(jnp.float32), make(jnp.bfloat16)
    variables = seeded_variables(jax.jit(lambda k: j32.init(k, *args32, False))(KEY))
    out32 = jax.jit(lambda v: j32.apply(v, *args32, False))(variables)
    cast = [jnp.asarray(a).astype(jnp.bfloat16) for a in args16]
    out16 = jax.jit(lambda v: j16.apply(v, *cast, False))(variables)
    return variables, np.asarray(out32), np.asarray(out16.astype(jnp.float32))


def test_basic_conv_bf16(rng):
    x = rng.standard_normal((1, 8, 12, 16, 8)).astype(np.float32)  # NDHWC
    make = lambda dt: JBasicConv(8, 3, is_3d=True, relu=True, dtype=dt)  # noqa: E731
    variables, want32, want16 = _jax_pair(make, [_bf16(x)], [x])
    mod = load_converted(BasicConv(8, 8, 3, is_3d=True, relu=True), variables)
    with torch.no_grad():
        got = nhwc(mod(nchw(_bf16(x)).bfloat16()).float())
    _check("BasicConv", got, want32, want16)


def test_sga_block_bf16(rng):
    C = 4
    x = rng.standard_normal((1, 8, 12, 16, C)).astype(np.float32)  # (B, D, H, W, C)
    g = rng.standard_normal((1, 12, 16, 20 * C)).astype(np.float32)

    def make(dt):
        name = "bfloat16" if dt == jnp.bfloat16 else "float32"
        return JSGABlock(C, j_ganet_small(24, sga_impl="scan", compute_dtype=name))

    variables, want32, want16 = _jax_pair(make, [_bf16(x), _bf16(g)], [x, g])
    mod = load_converted(SGABlock(C, ganet_small(24, compute_dtype="bfloat16")), variables)
    with torch.no_grad():
        got = nhwc(mod(nchw(_bf16(x)).bfloat16(), nchw(_bf16(g)).bfloat16()).float())
    _check("SGABlock", got, want32, want16)


def test_disp_agg_head_bf16(rng):
    C, H, W = 8, 48, 96
    x = rng.standard_normal((1, 8, H // 3, W // 3, C)).astype(np.float32)
    lg1 = rng.standard_normal((1, H, W, 75)).astype(np.float32)
    lg2 = rng.standard_normal((1, H, W, 75)).astype(np.float32)

    def make(dt):
        name = "bfloat16" if dt == jnp.bfloat16 else "float32"
        return JDispAggHead(j_ganet_small(24, sga_impl="scan", compute_dtype=name))

    args = [x, lg1, lg2]
    variables, want32, want16 = _jax_pair(make, [_bf16(a) for a in args], args)
    mod = load_converted(DispAggHead(ganet_small(24, compute_dtype="bfloat16"), C), variables)
    with torch.no_grad():
        got = mod(*(nchw(_bf16(a)).bfloat16() for a in args)).float().numpy()
    _check("DispAggHead", got, want32, want16)


@pytest.mark.parametrize("preset", ["small", "deep"])
def test_ganet_bf16(preset):
    """The whole eval forward at 48x96, max_disp 24: disparity in px."""
    jpreset, tpreset = (j_ganet_small, ganet_small) if preset == "small" else (j_ganet_deep, ganet_deep)
    H, W = 48, 96
    rng = np.random.default_rng(0)
    left = rng.random((1, H, W, 3), dtype=np.float32)
    right = rng.random((1, H, W, 3), dtype=np.float32)
    j32 = JGANet(jpreset(24, sga_impl="scan"))
    j16 = JGANet(jpreset(24, sga_impl="scan", compute_dtype="bfloat16"))
    dummy = jnp.zeros((1, H, W, 3), jnp.float32)
    variables = seeded_variables(jax.jit(lambda k: j32.init(k, dummy, dummy, train=True))(KEY))
    want32 = np.asarray(jax.jit(lambda v: j32.apply(v, left, right, train=False))(variables))
    want16 = np.asarray(jax.jit(lambda v: j16.apply(v, left, right, train=False))(variables))
    model = build_model(tpreset(24, compute_dtype="bfloat16"), device="cpu",
                        state_dict=convert_flax_variables(variables))
    got = predict(model, left, right).numpy()
    assert got.shape == want32.shape == (1, H, W)
    _check(f"GANet_{preset}", got, want32, np.asarray(want16, np.float32))
