"""The GANet_deep eval forward of the port against the JAX package's, on the
CPU in float32, converted weights and seeded BatchNorm
(tests/torch_parity.py).  In a file of its own so that it gets a worker of
its own.

At 48x96 with max_disp 24: tolerance 1e-3 px of disparity, the float32
noise of the forward (the port in float32 against itself in float64
differs by about 4e-4 px here), which the softmax over 24 bins amplifies;
convolutions sum in another order in XLA-CPU and in oneDNN.

At the CPU shape of `__graft_entry__.entry()`, 96x144 with max_disp 48:
tolerance 2e-3 px.  Probe behind it (on the CPU): port against JAX max
1.08e-3 px (mean 1.4e-5, disparities within +-35), while the port in
float32 against itself in float64 differs by 1.77e-3 px at this shape, so
1e-3 px would fail on float32 noise alone; a wrong layer moves pixels by
whole px.
"""

import jax
import jax.numpy as jnp
import numpy as np

from ganet_tpu.config import ganet_deep as j_ganet_deep
from ganet_tpu.models.ganet import GANet as JGANet
from ganet_tpu_torch.entry import build_model, predict
from ganet_tpu_torch.config import ganet_deep
from ganet_tpu_torch.convert import convert_flax_variables
from tests.torch_parity import ganet_parity, seeded_variables


def test_ganet_deep_forward():
    assert ganet_parity(j_ganet_deep(24, sga_impl="scan"), ganet_deep(24)) <= 1e-3


def test_ganet_deep_forward_at_the_entry_shape():
    H, W, max_disp = 96, 144, 48  # __graft_entry__.entry() without a chip
    rng = np.random.default_rng(0)
    jmodel = JGANet(j_ganet_deep(max_disp, sga_impl="scan"))
    dummy = jnp.zeros((1, H, W, 3), jnp.float32)
    variables = seeded_variables(
        jax.jit(lambda k: jmodel.init(k, dummy, dummy, train=True))(jax.random.PRNGKey(0))
    )
    left = rng.random((1, H, W, 3), dtype=np.float32)
    right = rng.random((1, H, W, 3), dtype=np.float32)
    want = np.asarray(jax.jit(lambda v, a, b: jmodel.apply(v, a, b, train=False))(variables, left, right))
    model = build_model(ganet_deep(max_disp), device="cpu", state_dict=convert_flax_variables(variables))
    got = predict(model, left, right).numpy()
    assert got.shape == want.shape == (1, H, W)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    print(f"GANet_deep {H}x{W} D={max_disp}: max |port - JAX| {err:.3e} px")
    assert err <= 2e-3
