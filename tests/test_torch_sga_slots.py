"""Where the SGA kernels find one direction's weights, and their describe
entries, on the CPU.

`weight_slot` gives the wrappers of K1, K3, K5 and K6 and the describe
functions the offset and per-n stride, in elements, of one direction's 5
weight planes: pinned here for an (N, 5, H, W) set and for each direction
of an (N, 4, 5, H, W) set, and held against the view the plain versions
read.  `sga_describe`, `sga_bwd_describe`, `sga_fwd_seeded_describe` and
`sga_bwd_seeded_describe` describe a CUDA launch and raise on a CPU
tensor.  The redesigned sweep kernels (K1, K3, K5, K6) have no block
barrier.
"""

from pathlib import Path

import pytest
import torch

from ganet_tpu_torch.ops import sga as S

N, D, H, W = 2, 3, 4, 5


@pytest.mark.parametrize("direction", [None, 0, 1, 2, 3])
def test_weight_slot(direction):
    x = torch.zeros((N, D, H, W))
    shape = (N, 5, H, W) if direction is None else (N, 4, 5, H, W)
    w = torch.arange(torch.Size(shape).numel(), dtype=torch.float32).view(shape)
    offset, stride = S.weight_slot(w, x, direction)
    assert (offset, stride) == ((0, 5 * H * W) if direction is None else (direction * 5 * H * W, 20 * H * W))
    view = w if direction is None else w[:, direction]
    flat = w.flatten()
    for n in range(N):
        got = flat[offset + n * stride : offset + n * stride + 5 * H * W].view(5, H, W)
        assert torch.equal(got, view[n])


@pytest.mark.parametrize("shape,direction", [((N, 5, H, W), 0), ((N, 4, 5, H, W), None),
                                             ((N, 4, 5, H, W), 4), ((N, 4, 5, H, W + 1), 1)])
def test_weight_slot_rejects_what_does_not_match(shape, direction):
    with pytest.raises(ValueError):
        S.weight_slot(torch.zeros(shape), torch.zeros((N, D, H, W)), direction)


@pytest.mark.parametrize("describe", [S.sga_describe, S.sga_bwd_describe])
def test_describe_raises_on_a_cpu_tensor(describe):
    with pytest.raises(ValueError, match="CUDA"):
        describe(torch.zeros((N, D, H, W)), torch.zeros((N, 4, 5, H, W)), "w", 0)


@pytest.mark.parametrize("describe", [S.sga_fwd_seeded_describe, S.sga_bwd_seeded_describe])
def test_seeded_describe_raises_on_a_cpu_tensor(describe):
    x = torch.zeros((N, D, H, W))
    with pytest.raises(ValueError, match="CUDA"):
        describe(x, torch.zeros((N, 4, 5, H, W)), torch.zeros((N, D, 3)), direction=2, col0=1, cols=3)


@pytest.mark.parametrize("source", ["sga_fwd", "sga_bwd", "sga_fwd_seeded", "sga_bwd_seeded"])
def test_sweep_kernels_have_no_block_barrier(source):
    text = (Path(S.__file__).resolve().parent.parent / "csrc" / f"{source}.cu").read_text()
    assert "__syncthreads(" not in text and "__syncwarp(" in text
