"""The weight bridge: flax variables of the JAX package -> the port's
state_dict."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ganet_tpu.config import model_config as j_model_config
from ganet_tpu.models import GANet as JGANet
from ganet_tpu_torch.config import model_config
from ganet_tpu_torch.convert import convert_flax_variables
from ganet_tpu_torch.models import GANet
from tests.torch_parity import seeded_variables, two_torch_threads  # noqa: F401


def _variable_tree(name: str, rng) -> dict:
    """A GANet variable tree of the JAX package (train-mode init, so the
    deep-supervision heads are present) with seeded values, from shapes
    alone."""
    cfg = j_model_config(name, max_disp=24)
    dummy = jnp.zeros((1, 48, 96, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda k: JGANet(cfg).init(k, dummy, dummy, train=True), jax.random.PRNGKey(0)
    )
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes
    )


def _leaves(tree) -> int:
    return len(jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("name", ["GANet_deep", "GANet11", "GANet_small"])
def test_every_leaf_consumed_once_and_loads_strict(rng, name):
    variables = jax.device_get(_variable_tree(name, rng))
    sd = convert_flax_variables(variables)
    n_bn = sum(1 for k in sd if k.endswith("num_batches_tracked"))
    # Each flax leaf lands on its own key; the only extra keys are the
    # BatchNorm step counters.
    assert len(sd) - n_bn == _leaves(variables["params"]) + _leaves(variables["batch_stats"])
    assert n_bn == _leaves(variables["batch_stats"]) // 2
    model = GANet(model_config(name, max_disp=24))
    model.load_state_dict(sd, strict=True)  # raises on a missing, extra or misshapen key
    # The values are the flax leaves, moved: the sums of all values agree.
    total_flax = sum(float(np.sum(a, dtype=np.float64)) for a in jax.tree_util.tree_leaves(variables))
    total_torch = sum(
        float(t.double().sum()) for k, t in sd.items() if not k.endswith("num_batches_tracked")
    )
    assert total_torch == pytest.approx(total_flax, rel=1e-9, abs=1e-6)


def test_unknown_leaf_raises():
    with pytest.raises(KeyError):
        convert_flax_variables({"params": {"Conv_0": {"weird": np.zeros(3)}}})
    with pytest.raises(KeyError):
        convert_flax_variables({"cache": {}})


@pytest.mark.parametrize("dims", [2, 3])
def test_conv_transpose_needs_the_flip(rng, dims):
    """flax ConvTranspose(k=4, s=2, "SAME") equals PyTorch's transposed conv
    with padding 1 only once the kernel is spatially flipped."""
    layer = fnn.ConvTranspose(3, (4,) * dims, strides=(2,) * dims, padding="SAME", use_bias=False)
    x = rng.standard_normal((1,) + (6,) * dims + (5,)).astype(np.float32)
    variables = seeded_variables(layer.init(jax.random.PRNGKey(1), x))
    want = np.asarray(layer.apply(variables, x))

    sd = convert_flax_variables({"params": {"ConvTranspose_0": variables["params"]}})
    weight = sd["conv.weight"]
    xt = torch.from_numpy(x).movedim(-1, 1)
    fn = F.conv_transpose3d if dims == 3 else F.conv_transpose2d
    got = fn(xt, weight, stride=2, padding=1).movedim(1, -1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    unflipped = torch.flip(weight, dims=list(range(2, 2 + dims)))
    bad = fn(xt, unflipped, stride=2, padding=1).movedim(1, -1).numpy()
    assert np.abs(bad - want).max() > 1e-2
