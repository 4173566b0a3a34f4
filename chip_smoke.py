#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ganet_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an H100 (sm_90a) and the
CUDA toolkit.  Phases, each printing its lines:

  1. the card (nvidia-smi name and power limit), and the build of every
     CUDA kernel from `ganet_tpu_torch/csrc/`, one nvcc per source at once;
  2. the SGA sweep kernel (K1) against its plain PyTorch version at the
     eval path's shapes, per direction and fused, in float32 and bfloat16;
     per launch, storing and accumulating, its time beside its own traffic
     floor, the staging path it took (vectorised at every shape of the
     model's paths, the training path's included), its registers, shared
     memory and local memory (no spills), and its H-sweep step loop in
     SASS; and at the top rungs of its D (129, 192 and 256 = SGA_MAX_D) on
     a small volume, per direction, storing and accumulating, with no
     spills;
  3. the LGA kernel (K2) against its plain version at the eval path's head
     (repeats 1 and 2) and at the training path's, float32 and bfloat16:
     two launches bit-identical, its time beside its bound, its
     registers, shared memory, local memory (none) and blocks an SM, and
     the instructions of its chunk loop in SASS (cuobjdump);
  4. the whole model at 240x528, D=192, and at 96x192, D=768 (SGA volumes
     of 256 bins), float32 with TF32 off, once through the kernels and once
     through the plain versions, from one seeded init, with a tolerance
     per D;
  5. the eval path: GANet_deep at 576x960, D=192, batch 1, bfloat16, seeded
     random weights, through `build_model` and `predict`; launch counts of
     each kernel in that run, its latency and peak memory;
  6. the SGA gradient-sweep kernel (K3) against its plain version at the
     training path's shapes, per direction, storing and accumulating,
     float32 and bfloat16; per launch its time beside its own traffic
     floor and its staging path, registers, shared and local memory (as
     phase 2 for K1), and a block's 4 directions as the training step
     runs them; and at the top rungs of its D as phase 2;
  7. the LGA backward kernel (K4) likewise at the training path's head and
     at the `lga3d` backward's fold, float32 and bfloat16: two launches
     bit-identical, its time beside its bound, and its registers, shared
     memory, local memory (none) and blocks an SM;
  8. gradients of the whole model in train mode at 240x528, D=192, batch 1,
     float32 with TF32 off, through the kernels and through the plain
     versions, from one seeded init and one synthetic batch;
  9. the training path: GANet_deep at 240x528, D=192, batch 2, bfloat16,
     synthetic batches, through `create_train_state` and `make_train_step`;
     launch counts of each kernel in one step, the loss over steps on one
     batch, the step time, peak memory and a profile of the forward and the
     backward;
 10. the seeded H-sweep kernel of the sharded wavefront (K5) against its
     plain version on a 128-column window of the per-shard eval and
     training chunks, seeded and not, forward and reverse, float32 and
     bfloat16; unseeded over the whole width, bit for bit against K1's H
     sweep; its time at both chunks beside its bound and its launches, its
     pace over H, its describe fields (vectorised staging, no local memory)
     and its step loop in SASS; and at the top rungs of its D (129, 192,
     256) on small windows, whole copies and element-wise;
 11. its gradient kernel (K6) likewise at the per-shard training block,
     with dx and dw added into and the seed's cotangent (0 without a seed),
     nothing written outside the window or the direction's slot; its time
     beside its bound, its describe fields (vectorised staging, no local
     memory) and its step loop in SASS; and at the top rungs of its D
     (129, 192, 256) on a small window;
 12. the sharded path: 4 ranks share the card, joined by gloo (boundary
     rows staged through the host; NCCL refuses two ranks on one device),
     through `parallel/launch.py`; H-sharded SGA (wavefront) and LGA (halo)
     forward and gradients at GANet_deep's full widths against the
     unsharded kernels in this process; launch counts of K1, K3, K5, K6 on
     every rank, and wall times per rank (4 ranks on one card: not a
     multi-GPU time); where the f32 SGA gradients part (K1 against K5 on
     the H sweeps: difference, argmax flips, and the unsharded gradient on
     K5's sweeps against the sharded one);
 13. the channel-wise LGA (`lga3d`) path: its forward kernel (K7) at one
     channel per guidance against its plain version and, bit for bit,
     against K2 at the eval head; `lga3d` forward at GANet_deep's full-res
     aggregation volume and forward and backward (K7, K4) at the training
     crop's, against the plain versions, with the launches of each run
     counted; K7's time at both volumes beside its bound, its registers,
     shared and local memory (none), blocks an SM and channel groups, and
     the instructions of its chunk loop in SASS;
 14. the from-files path: a seeded KITTI-2015-shaped frame (375x1242 RGB
     PNGs and a ground-truth disparity PNG, written by the port's PNG
     writer, their read and write times printed) and a checkpoint saved
     from a seeded init; `python -m ganet_tpu_torch.predict` in process
     (GANet_deep, crop 384x1248, max_disp 192, --bf16 1, --resume): the
     PNG 375x1242 and within 1/256 px of `entry.predict` on the same padded
     input, K1 and K2 launched 28 and 4 times a frame, the time a frame;
     `ganet_tpu_torch.evaluate` offline over the PNG and online over the
     list; the bench entry (`ganet_tpu_torch.bench`) at batch 4 and at
     batch 1, its JSON line and peak memory; every K1 and K2 launch of
     these runs recorded by volume shape, and K1 (each direction, storing
     and accumulating) and K2 held against their plain versions at each
     such shape, float32 and bfloat16;
 15. training from files: a seeded SceneFlow-shaped tree (8 training
     frames of 540x960, 2 validation frames of 240x528; PNG views, PFM
     disparity of both views); `python -m ganet_tpu_torch.train` in process
     (GANet_deep, crop 240x528, max_disp 192, batch 2, --bf16 1, the
     default --remat sga): 1 epoch of 4 steps with evaluation (finite losses
     a row a step, checkpoint 0/ with the optimizer and schedule, best/ and
     best_epe.json), its --resume for epoch 1 (start_epoch 1, steps 5-8, the
     restored schedule's decayed lr) and a --left_right 1 run; the predict
     CLI from the trained checkpoint within 1/256 px of `entry.predict`; the
     step time and peak memory under remat none, sga and full at batch 2
     and 4; the launches of every run and step against their expected
     counts (K1 and K2 twice a step under remat); and K1-K4 held against
     their plain versions at every volume shape those runs launched them
     at, float32 and bfloat16;
 16. data-parallel training on 2 ranks that share the card over gloo,
     started by `parallel/launch.py` (GANet_deep at 240x528, max_disp 192,
     batch 1 a rank): (a) one float32 step (TF32 off, remat none) of the
     ranks against one step of the same model on the global batch in this
     process (loss, running statistics, global gradients, parameters; the
     ranks' parameters the same bits); (b) `python -m ganet_tpu_torch.train
     --mesh_data 2` in process (this process rank 0; bf16, remat sga, batch
     2) on phase 15's SceneFlow-shaped files, 1 epoch of 4 steps with
     evaluation (rows and checkpoints written once, by rank 0), and its
     checkpoint resumed on one device; (c) each rank's launches a step
     against their expected counts, its step time, gradient all-reduce time
     and peak memory (two ranks on one card: not a multi-GPU time); then
     K1-K4 against their plain versions at every volume shape the ranks
     launched them at;
 17. H-sharded inference on 4 ranks that share the card over gloo
     (GANet_deep 576x960 over `space` 4) against one device, float32 and
     bfloat16, each rank's launches, time and peak memory; the predict CLI
     with --space 2 and --space 2 --data 2; K1, K5 and K2 at every shape
     launched;
 18. H-sharded training on 2 ranks over `space` that share the card over
     gloo (GANet_deep at 240x528, max_disp 192, global batch 2, remat
     sga): (a) one float32 step (TF32 off) of the ranks against one step
     of the same model on the same batch in this process, which runs it
     twice to show its own noise (loss, running statistics, gradients, the
     Adam update's direction; the ranks' parameters the same bits); (b)
     each rank's bfloat16 step time, peak memory and launches of K1, K3,
     K5, K6, K2 and K4 (two ranks on one card: not a multi-GPU time); (c)
     `python -m ganet_tpu_torch.train --mesh_space 2` in process for 2
     steps on phase 15's SceneFlow-shaped files, and the predict CLI on one
     device from its checkpoint; (d) `python -m ganet_tpu_torch.dryrun 4`
     (mesh (2, 2, 1)); then K1-K6 against their plain versions at every
     shape the ranks launched them at;
 19. disparity-sharded inference and training on 2 ranks over `disp`
     that share the card over gloo: (a) GANet_deep's eval forward at
     576x960, max_disp 192, batch 1, the gathered f32 disparity (TF32 off)
     within 2e-2 px of one device and bf16 within 1.5x one device's bf16
     error, each rank's launches (one device's: every rank sweeps and
     refines the whole D), its 3D convolutions' depths (at most its 32
     bins and a halo of 2), bf16 forward time and peak memory; (b) its
     training at 240x528, global batch 2, remat sga: one f32 step against
     one device under phase 18's gates, the ranks' parameters the same
     bits, each rank's launches a step, bf16 step time, all-reduce time
     and peak memory; (c) `python -m ganet_tpu_torch.train --mesh_disp 2`
     for 2 steps from phase 15's files, its checkpoint read by the
     predict CLI on one device; (d) `python -m ganet_tpu_torch.dryrun 8`
     (mesh (2, 2, 2), GANet_small: D halos, H halos and their corners,
     the wavefront, BatchNorm over the whole mesh); (e) K1-K6 against
     their plain versions at every shape the ranks launched them at;
 20. channel tensor parallelism on 2 ranks over `disp` that share the
     card over gloo (`channel_tp`: each rank holds a block of the
     channels of every aggregation volume, with every bin): (a) GANet_deep's
     eval forward at 576x960, max_disp 192, batch 1, the f32 disparity
     within 2e-2 px of one device and bf16 within 1.5x one device's bf16
     error, each rank's launches (one device's: K1 28, K2 4, each K1 on
     the rank's channels, N = B C / 2), every 3D convolution the one
     device's with a block of its output channels (a head's C -> 1 conv:
     of its input channels) at every bin, bf16 forward time and peak
     memory; (b) its training at 240x528, global batch 2, remat sga: one
     f32 step against one device under phase 18's gates, the ranks'
     parameters and the aggregation's buffers the same bits, each rank's
     launches a step (K1 56, K2 8, K3 28, K4 4), bf16 step time,
     all-reduce time and peak memory; (c) `python -m
     ganet_tpu_torch.train --mesh_disp 2 --channel_tp 1` for 2 steps from
     phase 15's files, its checkpoint read by the predict CLI on one
     device; (d) K1-K4 against their plain versions at every shape the
     ranks launched them at;
 21. the native decoder and feeding the step: (a) the host's g++ and
     libpng, the build of `ganet_tpu_torch/csrc/ganet_io.cpp` (a failed
     build fails the phase where both are present); (b) 4 seeded
     SceneFlow-shaped pairs of 540x960 (PNG rows Sub, Up, Average and
     Paeth in turn) decoded natively and in Python, bit for bit, as
     240x528 training crops and padded to 576x960, and one KITTI-shaped
     frame (375x1242 RGB and 16-bit disparity) padded to 384x1248, with
     the time a sample of each path; (c) `python -m
     ganet_tpu_torch.bench_input --samples 16 --batch 2` in process, its
     JSON line; (d) GANet_deep at 240x528, max_disp 192, batch 2, bf16,
     remat sga, 6 steps fed by `Trainer`'s `BatchIterator` (prefetch 2)
     from those files natively, then 6 in Python: per step the time
     blocked on the batch and the step's between synchronises, pairs/s
     from files over the last 3, phase 15's launches a step (K1 56, K2 8,
     K3 28, K4 4), and 12 native reads in the native run, none in the
     Python one;
 22. the training benchmarks (GANet_deep at 240x528, max_disp 192, bf16):
     (a) `python -m ganet_tpu_torch.bench_train --remat none --batches
     4,8,16 --steps 4` in a subprocess, its rows (ms a step, pairs/s, peak
     memory; finite losses) and launches a step (K1 28, K2 4, K3 28, K4
     4), the out-of-memory row, if any, last and "HBM-infeasible"; (b)
     bench_train under remat sga at batches 8 and 16 in process, its
     launches counted (56 / 8 / 28 / 4 a step); (c) `profile_train
     --batch 4` under remat none, sga and full (forward, forward and
     backward, whole step; the recompute tax), launches counted; (d) one
     `torch.profiler` window (`utils.profiling.trace`) of a batch-4 step
     under sga and one under none, device time by phase 9's groups and
     their difference; (e) `bench_scaling --meshes 1,1,1 2,1,1` (GANet_small
     48x96): finite losses, (2,1,1) plumbing only on one card.

`--phases 10,11` runs only the listed phases (after phase 1) and prints no
result line.  Any failed check raises and the script exits non-zero.  On
success the line before the last is a JSON object with each kernel's
launches on its path, error, times and bound, and the last line is
{"ok": true, "device": {...}}.  Without a CUDA device, or run outside a
checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 (non-tensor-core) FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# bf16 has 8 significant bits: one ulp is at most 2^-7 of the value.
BF16_ULP = 2.0**-7
F32_ABS_TOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of `fn` in ms over `reps` calls, after warm-up.  The
    calls are enqueued behind a spin kernel of about 0.2 ms a call, so that
    launches shorter than their wrapper's host time still run back to back
    on the card and are timed at its pace, not the host's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(reps * 4e5))  # cycles: about 0.2 ms a call at 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(torch, name: str, got, ref, summed: bool = False) -> float:
    """Hold a kernel's output against its plain version; returns the max
    abs error.  float32: |err| <= 1e-4, or for the gradient kernels, whose
    sums over D and carries run over hundreds of terms (`summed`),
    |err| <= 1e-5 (max|ref| + |ref|).  bfloat16 (the plain version run on
    the same bf16 inputs, summing in f32 and rounding where the kernel
    rounds): |err| <= one bf16 ulp of the value (2^-7 |ref|) plus a floor
    of 2^-9 max|ref| for rounding differences that an earlier rounding step
    passes on (the 2nd LGA pass)."""
    g, r = got.float(), ref.float()
    if g.shape != r.shape:
        raise AssertionError(f"{name}: shape {tuple(g.shape)} != {tuple(r.shape)}")
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (g - r).abs()
    max_abs = err.max().item()
    scale = r.abs().max().item()
    if got.dtype == torch.float32 and summed:
        ok = bool((err <= 1e-5 * (scale + r.abs())).all())
        tol = "1e-5(max+|ref|)"
    elif got.dtype == torch.float32:
        ok = max_abs <= F32_ABS_TOL
        tol = f"abs<={F32_ABS_TOL}"
    else:
        bound = BF16_ULP * r.abs() + 2.0**-9 * scale
        ok = bool((err <= bound).all())
        tol = "ulp"
    log(f"  {name}: max_abs_err={max_abs:.3e} max|ref|={scale:.3e} "
        f"rel={max_abs / max(scale, 1e-30):.3e} tol={tol} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return max_abs


def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[1] nvidia-smi: {smi}")
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda}; device 0: "
        f"{torch.cuda.get_device_name(0)}; device count {torch.cuda.device_count()}")
    from ganet_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[1] built {', '.join(logs)} in {time.perf_counter() - t0:.1f} s (nvcc, sm_90a, parallel)")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    return smi


def describe_line(info: dict) -> str:
    """One line of an SGA kernel's `describe` fields (ops/sga.py)."""
    return (f"{'vectorised' if info['vectorised'] else 'element-wise'} staging, "
            f"{info['registers']} registers, {info['shared_bytes']} B shared a block, "
            f"{info['local_bytes']} B local; {info['lanes']} lanes x {info['bins']} bins a "
            f"column, {info['steps']} steps x {info['stages']} stages, {info['warps']} "
            f"warps a block, {info['blocks']} blocks")


def sga_launch_floor_ms(x, accumulate: bool) -> float:
    """The traffic floor of one K1 launch: x, 5 weight planes and the output
    (read first when accumulating) moved once, over the HBM rate."""
    N, D, H, W = x.shape
    nbytes = ((2 + accumulate) * x.numel() + 5 * N * H * W) * x.element_size()
    return nbytes / HBM_BYTES_PER_S * 1e3


def phase_sga(torch, gen):
    """K1 at the main path's shapes; returns the JSON entry (full-res bf16)."""
    from ganet_tpu_torch.ops import sga as S
    from ganet_tpu_torch.ops.normalize import l1_normalize

    entry = None
    # (B, D, H, W, C) of the full-res and half-res blocks of GANet_deep at 576x960.
    for label, (B, D, H, W, C) in (("full", (1, 64, 192, 320, 32)), ("half", (1, 32, 96, 160, 48))):
        x32 = torch.randn((B * C, D, H, W), device="cuda", generator=gen)
        w32 = l1_normalize(torch.randn((B * C, 4, 5, H, W), device="cuda", generator=gen), dim=2)
        for dtype in (torch.float32, torch.bfloat16):
            x, w = x32.to(dtype), w32.to(dtype)
            tag = f"sga {label} {tuple(x.shape)} {str(dtype)[6:]}"
            for direction, (axis, reverse) in enumerate(S.DIRECTIONS):
                got = S.sga_sweep_kernel(x, w, axis, reverse, direction=direction)
                ref = S.sga_sweep_plain(x, w[:, direction], axis, reverse).to(dtype)
                compare(torch, f"{tag} sweep {axis}{'-rev' if reverse else ''}", got, ref)
                del got, ref
                sweep_ms = cuda_ms(
                    torch, lambda: S.sga_sweep_kernel(x, w, axis, reverse, direction=direction), reps=3
                )
                acc = torch.zeros_like(x)
                acc_ms = cuda_ms(
                    torch, lambda: S.sga_sweep_kernel(x, w, axis, reverse, direction=direction, out=acc),
                    reps=3,
                )
                del acc
                for accumulate, ms in ((False, sweep_ms), (True, acc_ms)):
                    info = S.sga_describe(x, w, axis, direction, accumulate)
                    log(f"    one launch {'accumulating' if accumulate else 'storing'}: {ms:.3f} ms, "
                        f"launch floor {sga_launch_floor_ms(x, accumulate):.4f} ms; {describe_line(info)}")
                    if not info["vectorised"] or info["local_bytes"]:
                        raise AssertionError(f"{tag}: K1 staged element-wise or spilled: {info}")
            x5 = x.view(B, C, D, H, W)
            w5 = w.view(B, C, 4, 5, H, W)
            got = S.sga_ncdhw(x5, w5)
            ref = S.sga_reference_ncdhw(x5, w5)
            err = compare(torch, f"{tag} fused 4 directions", got, ref)
            del got, ref
            ms = cuda_ms(torch, lambda: S.sga_ncdhw(x5, w5), reps=5)
            plain_ms = cuda_ms(torch, lambda: S.sga_reference_ncdhw(x5, w5), reps=1)
            numel = x.numel()
            nbytes = (2 * numel + w.numel()) * x.element_size()
            flops = 4 * 10 * numel + 3 * numel  # 5 mul + 4 add + max per sweep, 3 max to fuse
            bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S) * 1e3
            by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOP_PER_S else "operations"
            # The 4 launches' own floor: one storing, three accumulating.
            floor_ms = sga_launch_floor_ms(x, False) + 3 * sga_launch_floor_ms(x, True)
            log(f"  {tag}: kernel {ms:.3f} ms (4 launches), plain {plain_ms:.3f} ms, "
                f"bound {bound_ms:.3f} ms ({by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
                f"floor of the 4 launches {floor_ms:.3f} ms")
            if label == "full" and dtype == torch.bfloat16:
                entry = {
                    "name": "sga_fwd", "route": "cuda",
                    "source": "ganet_tpu_torch/csrc/sga_fwd.cu",
                    "replaces": "ganet_tpu/ops/sga_pallas.py:78",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
                }
            del x, w, x5, w5
        del x32, w32
    # The training path's blocks (240x528, batch 2): the staging K1 takes there.
    for N, D, H, W in ((64, 64, 80, 176), (96, 32, 40, 88)):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.empty((N, D, H, W), device="cuda", dtype=dtype)
            w = torch.empty((N, 4, 5, H, W), device="cuda", dtype=dtype)
            for direction, (axis, _) in enumerate(S.DIRECTIONS):
                info = S.sga_describe(x, w, axis, direction, direction > 0)
                if not info["vectorised"] or info["local_bytes"]:
                    raise AssertionError(f"K1 at {(N, D, H, W)} {dtype}: element-wise or spilled: {info}")
            log(f"  sga training block {(N, D, H, W)} {str(dtype)[6:]}: vectorised staging in all 4 directions")
            del x, w
    # K1's H-sweep step loop in SASS at the paths' D = 64 (2 lanes x 32 bins).
    from ganet_tpu_torch.ops import _build

    for name, ops in sass_chunk_loops(_build._lib_path("sga_fwd")).items():
        for dt, mangled in (("float32", "If"), ("bfloat16", "I13__nv_bfloat16")):
            if "sga_sweep_h_kernel" in name and f"{mangled}Li2ELi32E" in name:
                log(f"  sga_fwd H step loop {dt} (G=2, B=32): {sass_line(ops)}")
    return entry


# D of the SGA kernels' top rungs: past 128 bins (8 lanes x 32 bins a column
# along H, 32 x 8 along W), up to SGA_MAX_D.
SGA_RUNG_DS = (129, 192, 256)
SGA_RUNG_SHAPE = (4, 24, 40)  # (N, H, W): rows of whole copies in both dtypes


def rung_describe(S, describe, tag, x, w) -> None:
    """Describe K1 or K3 at the W and H sweeps, storing and accumulating;
    raises on element-wise staging or local memory.  The dynamic shared
    memory shown was granted: the launches above ran."""
    for direction in (0, 2):
        axis = S.DIRECTIONS[direction][0]
        for accumulate in (False, True):
            info = describe(x, w, axis, direction, accumulate)
            log(f"    {tag} {axis} {'accumulating' if accumulate else 'storing'}: {describe_line(info)}")
            if not info["vectorised"] or info["local_bytes"]:
                raise AssertionError(f"{tag}: staged element-wise or spilled: {info}")


def phase_sga_rungs(torch, gen) -> None:
    """K1 at D = 129, 192 and 256 on a small volume, against its plain
    version per direction, storing and accumulating, float32 and bfloat16."""
    from ganet_tpu_torch.ops import sga as S
    from ganet_tpu_torch.ops.normalize import l1_normalize

    N, H, W = SGA_RUNG_SHAPE
    if max(SGA_RUNG_DS) != S.SGA_MAX_D:
        raise AssertionError(f"the top rung {max(SGA_RUNG_DS)} is not SGA_MAX_D {S.SGA_MAX_D}")
    for D in SGA_RUNG_DS:
        x32 = torch.randn((N, D, H, W), device="cuda", generator=gen)
        w32 = l1_normalize(torch.randn((N, 4, 5, H, W), device="cuda", generator=gen), dim=2)
        p32 = torch.randn((N, D, H, W), device="cuda", generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            x, w, prev = x32.to(dtype), w32.to(dtype), p32.to(dtype)
            tag = f"sga rung D={D} {tuple(x.shape)} {str(dtype)[6:]}"
            hold_k1(torch, S, x, w, prev, tag)
            rung_describe(S, S.sga_describe, "K1 " + tag, x, w)


def hold_k1(torch, S, x, w, prev, tag) -> None:
    """K1 against its plain version in each direction, storing, and
    accumulating into a copy of `prev`."""
    for direction, (axis, reverse) in enumerate(S.DIRECTIONS):
        name = f"{tag} sweep {axis}{'-rev' if reverse else ''}"
        ref = S.sga_sweep_plain(x, w[:, direction], axis, reverse).to(x.dtype)
        compare(torch, name, S.sga_sweep_kernel(x, w, axis, reverse, direction=direction), ref)
        got = S.sga_sweep_kernel(x, w, axis, reverse, direction=direction, out=prev.clone())
        compare(torch, f"{name} accumulating", got, torch.maximum(prev, ref))
        del ref, got


def hold_k3(torch, S, x, w, gbar, prev, tag) -> None:
    """K3 against its plain version in each direction (dx and dw, storing,
    and dx accumulating into a copy of `prev`), on the forward sweeps of
    K1."""
    dw = torch.zeros_like(w)
    for direction, (axis, reverse) in enumerate(S.DIRECTIONS):
        name = f"{tag} sweep {axis}{'-rev' if reverse else ''}"
        a = S.sga_sweep_kernel(x, w, axis, reverse, direction=direction)
        ref_dx, ref_dw = S.sga_sweep_bwd_plain(
            x.float(), w[:, direction].float(), a.float(), gbar.float(), axis, reverse)
        got_dx, _ = S.sga_sweep_bwd_kernel(x, w, a, gbar, axis, reverse, direction=direction, dw=dw)
        compare(torch, f"{name} dx", got_dx, ref_dx.to(x.dtype), summed=True)
        compare(torch, f"{name} dw", dw[:, direction], ref_dw.to(x.dtype), summed=True)
        got_dx, _ = S.sga_sweep_bwd_kernel(x, w, a, gbar, axis, reverse, direction=direction,
                                           dx=prev.clone(), dw=dw)
        compare(torch, f"{name} dx accumulating", got_dx, (prev.float() + ref_dx).to(x.dtype),
                summed=True)
        del a, ref_dx, ref_dw, got_dx


def lga_bound(numel: int, n_guidance: int, elem: int):
    """(bound ms, "bytes" or "operations", bytes, FLOP) of one LGA pass over
    `numel` outputs: x read and out written once, the guidance read once,
    75 FMAs an output."""
    nbytes = (2 * numel + n_guidance) * elem
    flops = 2 * 75 * numel
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def lga_describe_line(info: dict) -> str:
    """One line of K2's `lga_describe`, K4's `lga_bwd_describe` or K7's
    `lga3d_describe` fields (ops/lga.py)."""
    line = (f"{info['registers']} registers, {info['static_shared_bytes']} B static + "
            f"{info['dynamic_shared_bytes']} B dynamic shared a block, {info['local_bytes']} B local, "
            f"{info['blocks_per_sm']} blocks an SM of {info['threads']} threads, tile "
            f"{info['tile_h']}x{info['tile_w']}, {info['chunk']} slices a chunk, {info['blocks']} blocks")
    if "group" in info:
        line += f" ({info['groups']} groups of up to {info['group']} channels a tile)"
    return line


def sass_chunk_loops(lib_path) -> dict:
    """Per kernel of a built library: the opcodes of its chunk loop, the
    backward branch's body with the most FFMAs (the shortest such body,
    where several have as many), from `cuobjdump -sass`.  Empty, with a
    line that says why, where cuobjdump is missing or fails."""
    import re
    import shutil
    from collections import Counter

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                              check=True, timeout=120).stdout
    except (OSError, subprocess.CalledProcessError, subprocess.TimeoutExpired) as err:
        log(f"  no SASS of {lib_path.name}: {tool}: {err}")
        return {}
    loops = {}
    for body in re.split(r"\n\s*Function : ", text)[1:]:
        name = body.split("\n", 1)[0].strip()
        code = [(int(a, 16), op) for a, op in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
        best = None
        for addr, op in code:
            m = re.search(r"\bBRA\s+0x([0-9a-f]+)", op)
            if not m or int(m.group(1), 16) >= addr:
                continue
            start = int(m.group(1), 16)
            ops = Counter(re.sub(r"^@!?U?P\w+\s+", "", o).split()[0].split(".")[0]
                          for a, o in code if start <= a <= addr)
            key = (ops["FFMA"], -sum(ops.values()))
            if best is None or key > best[0]:
                best = (key, ops)
        if best:
            loops[name] = best[1]
    return loops


def sass_line(ops) -> str:
    """One line of a chunk loop's opcode counts (`sass_chunk_loops`)."""
    main = ("FFMA", "LDS", "LDG", "LDGSTS", "STS", "STG", "BAR", "LDL", "STL")
    total = sum(ops.values())
    rest = total - sum(ops[k] for k in main)
    return (f"{total} instructions: " + ", ".join(f"{ops[k]} {k}" for k in main if ops[k])
            + f", {rest} other; {total / max(ops['FFMA'], 1):.2f} an FFMA")


def phase_lga(torch, gen, smi):
    """K2 at the eval head (1, 192, 576, 960), repeats 1 and 2, and at the
    training head (2, 192, 240, 528), float32 and bfloat16: against its
    plain version, two launches bit-equal, no local memory, its time
    beside its bound; returns the JSON entry (one bf16 pass at the eval
    head)."""
    from ganet_tpu_torch.ops import lga as G
    from ganet_tpu_torch.ops.normalize import l1_normalize

    r = 2
    entry = None
    for label, (B, D, H, W), repeats in (("eval", (1, 192, 576, 960), (1, 2)),
                                         ("train", (2, 192, 240, 528), (1,))):
        x32 = torch.randn((B, D, H, W), device="cuda", generator=gen)
        g32 = l1_normalize(torch.randn((B, 75, H, W), device="cuda", generator=gen), dim=1)
        for dtype in (torch.float32, torch.bfloat16):
            x, g = x32.to(dtype), g32.to(dtype)
            tag = f"lga {label} {tuple(x.shape)} r{r} {str(dtype)[6:]}"
            errs = {}
            for n in repeats:
                got = G.lga_nchw(x, g, r, n)
                ref = G.lga_reference_nchw(x, g, r, n)
                errs[n] = compare(torch, f"{tag} repeats {n}", got, ref)
                del got, ref
            if not torch.equal(G.lga_kernel(x, g, r), G.lga_kernel(x, g, r)):
                raise AssertionError(f"{tag}: two launches differ")
            info = G.lga_describe(x, r)
            ms = cuda_ms(torch, lambda: G.lga_kernel(x, g, r), reps=10)
            bound_ms, by, nbytes, flops = lga_bound(x.numel(), g.numel(), x.element_size())
            log(f"  {tag}: kernel {ms:.3f} ms per pass, bound {bound_ms:.3f} ms ({by}: "
                f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), {ms / bound_ms:.2f}x the bound; "
                f"{lga_describe_line(info)}; card {smi}")
            if info["local_bytes"]:
                raise AssertionError(f"{tag}: K2 uses local memory: {info}")
            if label == "eval" and dtype == torch.bfloat16:
                plain_ms = cuda_ms(torch, lambda: G.lga_reference_nchw(x, g, r, 1), reps=2)
                log(f"  {tag}: plain {plain_ms:.3f} ms per pass")
                entry = {
                    "name": "lga_fwd", "route": "cuda",
                    "source": "ganet_tpu_torch/csrc/lga_fwd.cu",
                    "replaces": "ganet_tpu/ops/lga_pallas.py:122",
                    "max_abs_err": errs[1], "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
                }
            del x, g
        del x32, g32
        torch.cuda.empty_cache()
    # What bounds K2: its chunk loop in SASS, per instantiation.
    from ganet_tpu_torch.ops import _build

    for name, ops in sass_chunk_loops(_build._lib_path("lga_fwd")).items():
        kind = ("bf16" if "bfloat16" in name else "f32") + (" r2" if "Li2E" in name else " r1")
        log(f"  lga_fwd chunk loop {kind}: {sass_line(ops)}")
    return entry


def phase_model_parity(torch, gen):
    """Whole model, kernels vs plain versions, f32 with TF32 off: at
    240x528 with max_disp 192, and at 96x192 with max_disp 768, whose SGA
    volumes have D = 256 (the kernels' top rung) and 128 bins."""
    from ganet_tpu_torch import ganet_deep
    from ganet_tpu_torch.entry import build_model, predict

    # cuDNN's default algorithms for the transposed convolutions sum in a
    # run-dependent order; with its deterministic ones the two routes differ
    # only where the kernels and the plain versions sum in other orders.
    torch.backends.cudnn.deterministic = True
    for H, W, D, tol in ((240, 528, 192, 2e-2), (96, 192, 768, 5e-2)):
        left = torch.rand((1, H, W, 3), device="cuda", generator=gen)
        right = torch.rand((1, H, W, 3), device="cuda", generator=gen)
        outs = {}
        for impl in ("kernel", "torch"):
            model = build_model(ganet_deep(max_disp=D, impl=impl), device="cuda", seed=0)
            outs[impl] = predict(model, left, right)
            del model
        d = (outs["kernel"] - outs["torch"]).abs().max().item()
        finite = bool(torch.isfinite(outs["kernel"]).all())
        # Tolerance per D: the float32 noise of the whole forward with room to
        # spare.  The kernels sum in another order (FMA contraction) than the
        # plain versions, and random weights make disparities span about
        # +-130 px at D = 192 and +-450 px at D = 768; on an H100 runs on
        # identical inputs read 4e-3 to 9e-3 px at D = 192 and 2.1e-2 to
        # 3.2e-2 px at D = 768.  A sweep that leaves the bins past 128
        # unaggregated reads whole px (PERF.md).
        ok = finite and d <= tol
        log(f"[4] GANet_deep {H}x{W} D={D} f32 (TF32 off): max |disparity(kernel) - "
            f"disparity(torch)| = {d:.3e} px (tol {tol:.0e}), range "
            f"[{outs['kernel'].min().item():.3f}, {outs['kernel'].max().item():.3f}] {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"model forward at D={D} through the kernels disagrees with the plain versions")
        del outs
    torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()


def phase_main_path(torch, gen, smi, entries):
    """GANet_deep 576x960 D=192 bf16: counted run, then timed runs."""
    from ganet_tpu_torch import ganet_deep
    from ganet_tpu_torch.entry import build_model, predict
    from ganet_tpu_torch.utils.profiling import read_launches, reset_launches

    cfg = ganet_deep(max_disp=192, compute_dtype="bfloat16")
    model = build_model(cfg, seed=0)
    H, W = 576, 960
    left = torch.rand((1, H, W, 3), device="cuda", generator=gen)
    right = torch.rand((1, H, W, 3), device="cuda", generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    disp = predict(model, left, right)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[5] launches in one forward: {launches}")
    if any(launches[k] for k in ("sga_bwd", "lga_bwd", "sga_fwd_seeded", "sga_bwd_seeded", "lga3d_fwd")):
        raise AssertionError("the eval forward launched a gradient, seeded or lga3d kernel")
    n_sga = 4 * (cfg.num_sga_full + cfg.num_sga_half)
    n_lga = 2 * cfg.lga_repeats
    if tuple(disp.shape) != (1, H, W):
        raise AssertionError(f"output shape {tuple(disp.shape)}")
    if not bool(torch.isfinite(disp).all()):
        raise AssertionError("non-finite disparity")
    if launches["sga_fwd"] != n_sga:
        raise AssertionError(f"expected {n_sga} SGA sweeps (7 blocks x 4), got {launches['sga_fwd']}")
    if launches["lga_fwd"] != n_lga:
        raise AssertionError(f"expected {n_lga} LGA passes, got {launches['lga_fwd']}")
    for e in entries:
        e["launches"] = launches[e["name"]]

    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict(model, left, right)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[5] GANet_deep {H}x{W} D=192 bf16 batch 1: disparity range "
        f"[{disp.min().item():.3f}, {disp.max().item():.3f}]; forward latency "
        f"{min(times):.1f} ms (min of 3; all {', '.join(f'{t:.1f}' for t in times)}); "
        f"peak memory {peak:.2f} GiB; card {smi}")
    profile_forward(torch, lambda: predict(model, left, right))


# Kernel-name fragments of each group in the device time.
KERNEL_GROUPS = (
    ("sga_fwd (K1)", ("sga_sweep",)),
    ("lga_fwd (K2)", ("lga_fwd_kernel",)),
    ("sga_bwd (K3)", ("sga_bwd",)),
    ("lga_bwd (K4)", ("lga_bwd_kernel",)),
    ("lga3d_fwd (K7)", ("lga3d_fwd_kernel",)),
    ("convolution", ("conv", "xmma", "cudnn", "implicit", "gemm", "cutlass", "fprop", "dgrad", "wgrad")),
)


def device_groups(torch, prof) -> tuple:
    """(kernels as (ms, count, name), device ms by `KERNEL_GROUPS` and
    "other", total device ms) of a finished profiler window."""
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        kernels.append((us / 1e3, evt.count, evt.key))
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    for ms, _, key in kernels:
        low = key.lower()
        name = next((g for g, frags in KERNEL_GROUPS if any(f in low for f in frags)), "other")
        groups[name] += ms
    return kernels, groups, sum(ms for ms, _, _ in kernels)


def profile_forward(torch, forward, tag: str = "[5] profile of one forward") -> None:
    """Device time of one call of `forward` by kernel, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, groups, total = device_groups(torch, prof)
    if total == 0:
        log(f"{tag}: the profiler saw no device time")
        return
    log(f"{tag} (profiler on): device time {total:.1f} ms in "
        f"{wall_ms:.1f} ms wall, device idle {100 * (1 - total / wall_ms):.1f}%; "
        + "; ".join(f"{g} {ms:.1f} ms" for g, ms in groups.items()))
    for ms, count, key in sorted(kernels, reverse=True)[:12]:
        log(f"  {ms:8.2f} ms  x{count:<4d} {key[:110]}")


def sga_bwd_launch_floor_ms(x, accumulate: bool) -> float:
    """The traffic floor of one K3 launch: x, A, gbar and 5 weight planes
    read, dx and 5 dw planes written (dx read first when accumulating),
    each once, over the HBM rate."""
    N, D, H, W = x.shape
    nbytes = ((4 + accumulate) * x.numel() + 10 * N * H * W) * x.element_size()
    return nbytes / HBM_BYTES_PER_S * 1e3


def phase_sga_bwd(torch, gen):
    """K3 at the training path's shapes; returns the JSON entry (full-res
    bf16, one storing launch of direction 0, along W)."""
    from ganet_tpu_torch.ops import sga as S
    from ganet_tpu_torch.ops.normalize import l1_normalize

    entry = None
    # (N = B*C, D, H, W) of the full-res and half-res blocks of GANet_deep
    # at 240x528, batch 2.
    for label, (N, D, H, W) in (("full", (64, 64, 80, 176)), ("half", (96, 32, 40, 88))):
        x32 = torch.randn((N, D, H, W), device="cuda", generator=gen)
        w32 = l1_normalize(torch.randn((N, 4, 5, H, W), device="cuda", generator=gen), dim=2)
        g32 = torch.randn((N, D, H, W), device="cuda", generator=gen)
        p32 = torch.randn((N, D, H, W), device="cuda", generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            x, w, gbar, prev = x32.to(dtype), w32.to(dtype), g32.to(dtype), p32.to(dtype)
            tag = f"sga_bwd {label} {tuple(x.shape)} {str(dtype)[6:]}"
            err = 0.0
            a = [S.sga_sweep_kernel(x, w, ax, rev, direction=k) for k, (ax, rev) in enumerate(S.DIRECTIONS)]
            dw = torch.empty_like(w)
            for direction, (axis, reverse) in enumerate(S.DIRECTIONS):
                name = f"{tag} sweep {axis}{'-rev' if reverse else ''}"
                wk = w[:, direction]
                # The plain version on the inputs widened to f32: its dx and dw
                # before the rounding to dtype, which the accumulating launch
                # adds to the old dx in f32 and rounds once.
                ref_dx, ref_dw = S.sga_sweep_bwd_plain(
                    x.float(), wk.float(), a[direction].float(), gbar.float(), axis, reverse)
                got_dx, _ = S.sga_sweep_bwd_kernel(x, w, a[direction], gbar, axis, reverse,
                                                   direction=direction, dw=dw)
                err = max(err, compare(torch, f"{name} dx", got_dx, ref_dx.to(dtype), summed=True))
                err = max(err, compare(torch, f"{name} dw", dw[:, direction], ref_dw.to(dtype), summed=True))
                got_dx = S.sga_sweep_bwd_kernel(x, w, a[direction], gbar, axis, reverse,
                                                direction=direction, dx=prev.clone(), dw=dw)[0]
                compare(torch, f"{name} dx accumulating", got_dx, (prev.float() + ref_dx).to(dtype),
                        summed=True)
                del got_dx, ref_dx, ref_dw
                acc = torch.zeros_like(x)
                for accumulate in (False, True):
                    ms = cuda_ms(torch, lambda: S.sga_sweep_bwd_kernel(
                        x, w, a[direction], gbar, axis, reverse, direction=direction,
                        dx=acc if accumulate else None, dw=dw), reps=5)
                    info = S.sga_bwd_describe(x, w, axis, direction, accumulate)
                    log(f"    {axis}{'-rev' if reverse else ''} one launch "
                        f"{'accumulating' if accumulate else 'storing'}: {ms:.3f} ms, launch floor "
                        f"{sga_bwd_launch_floor_ms(x, accumulate):.4f} ms; {describe_line(info)}")
                    if not info["vectorised"] or info["local_bytes"]:
                        raise AssertionError(f"{name}: K3 staged element-wise or spilled: {info}")
                    if direction == 0 and not accumulate:
                        ms_w0 = ms
                del acc

            def four():  # the training step's order: direction 0 stores, 1-3 accumulate
                dx = None
                for k, (ax, rev) in enumerate(S.DIRECTIONS):
                    dx, _ = S.sga_sweep_bwd_kernel(x, w, a[k], gbar, ax, rev, direction=k, dx=dx, dw=dw)

            four_ms = cuda_ms(torch, four, reps=5)
            four_floor = sga_bwd_launch_floor_ms(x, False) + 3 * sga_bwd_launch_floor_ms(x, True)
            w0 = w[:, 0].contiguous()
            plain_ms = cuda_ms(torch, lambda: S.sga_sweep_bwd_plain(x, w0, a[0], gbar, "w", False), reps=1)
            numel, plane = x.numel(), N * H * W
            # One launch reads x, A and gbar and 5 weight planes, writes dx and dw.
            nbytes = (4 * numel + 10 * plane) * x.element_size()
            flops = 25 * numel  # g, dx, 5 products summed over d, the 4-term carry
            bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S) * 1e3
            by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOP_PER_S else "operations"
            log(f"  {tag}: kernel {ms_w0:.3f} ms per storing W launch, {four_ms:.3f} ms for the 4 "
                f"directions of one block (their floor {four_floor:.3f} ms); plain {plain_ms:.3f} ms "
                f"per launch; bound {bound_ms:.3f} ms per launch ({by}: {nbytes / 1e6:.1f} MB, "
                f"{flops / 1e9:.2f} GFLOP)")
            if label == "full" and dtype == torch.bfloat16:
                entry = {
                    "name": "sga_bwd", "route": "cuda",
                    "source": "ganet_tpu_torch/csrc/sga_bwd.cu",
                    "replaces": "ganet_tpu/ops/sga_pallas.py:228",
                    "max_abs_err": err, "ms": ms_w0, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
                }
            del x, w, gbar, prev, a, dw
        del x32, w32, g32, p32
    return entry


def phase_sga_bwd_rungs(torch, gen) -> None:
    """K3 at D = 129, 192 and 256 on a small volume, against its plain
    version per direction (dx and dw, storing and accumulating), float32
    and bfloat16."""
    from ganet_tpu_torch.ops import sga as S
    from ganet_tpu_torch.ops.normalize import l1_normalize

    N, H, W = SGA_RUNG_SHAPE
    for D in SGA_RUNG_DS:
        x32 = torch.randn((N, D, H, W), device="cuda", generator=gen)
        w32 = l1_normalize(torch.randn((N, 4, 5, H, W), device="cuda", generator=gen), dim=2)
        g32 = torch.randn((N, D, H, W), device="cuda", generator=gen)
        p32 = torch.randn((N, D, H, W), device="cuda", generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            x, w, gbar, prev = x32.to(dtype), w32.to(dtype), g32.to(dtype), p32.to(dtype)
            tag = f"sga_bwd rung D={D} {tuple(x.shape)} {str(dtype)[6:]}"
            hold_k3(torch, S, x, w, gbar, prev, tag)
            rung_describe(S, S.sga_bwd_describe, "K3 " + tag, x, w)


def phase_lga_bwd(torch, gen):
    """K4 at the training path's head and at the `lga3d` backward's fold;
    returns the JSON entry (one bf16 pass at the head)."""
    from ganet_tpu_torch.ops import lga as G
    from ganet_tpu_torch.ops.normalize import l1_normalize

    r = 2
    entry = None
    # (B, D, H, W): the head of GANet_deep at 240x528, batch 2, and the fold
    # (B*C, D, H, W) of `lga3d` at the training crop's volume (phase 13).
    for label, (B, D, H, W) in (("head", (2, 192, 240, 528)), ("fold", (64, 64, 80, 176))):
        x32 = torch.randn((B, D, H, W), device="cuda", generator=gen)
        g32 = l1_normalize(torch.randn((B, 75, H, W), device="cuda", generator=gen), dim=1)
        b32 = torch.randn((B, D, H, W), device="cuda", generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            x, g, gbar = x32.to(dtype), g32.to(dtype), b32.to(dtype)
            tag = f"lga_bwd {label} {tuple(x.shape)} r{r} {str(dtype)[6:]}"
            got_dx, got_dg = G.lga_bwd_kernel(x, g, gbar, r)
            ref_dx, ref_dg = G.lga_bwd_plain(x, g, gbar, r)
            err = max(compare(torch, f"{tag} dx", got_dx, ref_dx, summed=True),
                      compare(torch, f"{tag} dg", got_dg, ref_dg, summed=True))
            del ref_dx, ref_dg
            again_dx, again_dg = G.lga_bwd_kernel(x, g, gbar, r)
            if not (torch.equal(again_dx, got_dx) and torch.equal(again_dg, got_dg)):
                raise AssertionError(f"{tag}: two launches differ")
            del got_dx, got_dg, again_dx, again_dg
            ms = cuda_ms(torch, lambda: G.lga_bwd_kernel(x, g, gbar, r), reps=5)
            info = G.lga_bwd_describe(x, r)
            if info["local_bytes"]:
                raise AssertionError(f"{tag}: K4 uses local memory: {info}")
            numel = x.numel()
            # Reads x, gbar and the guidance, writes dx and dg.
            nbytes = (3 * numel + 2 * g.numel()) * x.element_size()
            flops = 2 * 2 * 75 * numel  # 75 FMAs for dx and 75 for dg per element
            bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S) * 1e3
            by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOP_PER_S else "operations"
            log(f"  {tag}: kernel {ms:.3f} ms per pass, bound {bound_ms:.3f} ms ({by}: "
                f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); {lga_describe_line(info)}")
            if label == "head" and dtype == torch.bfloat16:
                plain_ms = cuda_ms(torch, lambda: G.lga_bwd_plain(x, g, gbar, r), reps=1)
                log(f"  {tag}: plain {plain_ms:.3f} ms per pass")
                entry = {
                    "name": "lga_bwd", "route": "cuda",
                    "source": "ganet_tpu_torch/csrc/lga_bwd.cu",
                    "replaces": "ganet_tpu/ops/lga_pallas.py:367",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
                }
            del x, g, gbar
        del x32, g32, b32
        torch.cuda.empty_cache()
    return entry


def window_bound(n_vol: int, n_row: int, n_planes: int, elem: int, flops: int):
    """(bound ms, "bytes" or "operations") of a seeded sweep that moves
    `n_vol` volume elements, `n_row` boundary-row elements (float32) and
    `n_planes` weight elements."""
    nbytes = (n_vol + n_planes) * elem + 4 * n_row
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes


# K5's shapes: the wavefront's per-shard chunks, (N, D, H, W, col0, cols)
# with the launches each gets.  Eval: GANet_deep's full-res block at 576x960
# over 4 shards, its middle chunk of 3 (24 launches a sharded eval forward:
# 3 chunks x 2 directions x 4 ranks).  Train: the 240x528 batch-2 crop's
# block over 4 shards, its tail chunk of 2 (16 launches a sharded training
# step).  The walk's pace is timed at the eval chunk over K5_SLOPE_HS rows.
K5_SHAPES = (("eval", (32, 64, 48, 320, 128, 128), 24), ("train", (64, 64, 20, 176, 48, 128), 16))
K5_SLOPE_HS = (12, 24, 48)
# K5's rungs on SGA_RUNG_SHAPE's volume: a window of whole copies in both
# dtypes, and one at an odd col0 with a ragged last tile (element-wise).
K5_RUNG_WINDOWS = ((8, 24), (5, 23))


def seeded_fwd_bound(x, cols: int):
    """(bound ms, "bytes" or "operations", bytes) of one K5 launch on `cols`
    columns of x: x in the window, 5 weight planes and the seed read once,
    A and the boundary row written once."""
    N, D, H, _ = x.shape
    vol = N * D * H * cols
    return window_bound(2 * vol, 0, 5 * N * H * cols + 2 * N * D * cols, x.element_size(), 10 * vol)


def hold_k5(torch, S, x, w, seed, col0, cols, tag) -> float:
    """K5 against its plain version on the window [col0, col0 + cols), both
    directions, seeded and not: A and the boundary row, and nothing written
    outside the window.  Returns the max abs error."""
    win = slice(col0, col0 + cols)
    err = 0.0
    for direction, reverse in ((2, False), (3, True)):
        for valid in (True, False):
            out, bnd = S.sga_sweep_seeded_kernel(x, w, reverse, seed, valid, direction=direction,
                                                 col0=col0, cols=cols, out=torch.zeros_like(x))
            ref = S.sga_sweep_plain(x[..., win], w[:, direction, :, :, win], "h", reverse,
                                    seed, valid).to(x.dtype)
            name = f"{tag} {'bt' if reverse else 'tb'} valid={valid}"
            err = max(err, compare(torch, f"{name} out", out[..., win], ref))
            compare(torch, f"{name} boundary", bnd, ref[:, :, 0 if reverse else -1])
            if out[..., :col0].any() or out[..., col0 + cols:].any():
                raise AssertionError(f"{name}: the kernel wrote outside its column window")
            del out, bnd, ref
    return err


def phase_seeded_fwd(torch, gen, smi):
    """K5 at the wavefront's eval and training chunks (K5_SHAPES), f32 and
    bf16: against its plain version; unseeded over the whole width, bit for
    bit against K1's H sweep; its time beside its bound and the launches it
    gets, its pace over H at the eval chunk, its describe fields
    (vectorised staging, no local memory: checked after every time is
    printed) and its step loop in SASS; then at D = 129, 192 and 256 on a
    small volume.  Returns the JSON entry (eval chunk, bf16, valid, one
    launch)."""
    from ganet_tpu_torch.ops import _build
    from ganet_tpu_torch.ops import sga as S
    from ganet_tpu_torch.ops.normalize import l1_normalize

    entry = None
    path, faults = {}, []
    for label, (N, D, H, W, col0, cols), launches in K5_SHAPES:
        x32 = torch.randn((N, D, H, W), device="cuda", generator=gen)
        w32 = l1_normalize(torch.randn((N, 4, 5, H, W), device="cuda", generator=gen), dim=2)
        s32 = torch.randn((N, D, cols), device="cuda", generator=gen)
        win = slice(col0, col0 + cols)
        for dtype in (torch.float32, torch.bfloat16):
            x, w, seed = x32.to(dtype), w32.to(dtype), s32.to(dtype)
            tag = f"sga_fwd_seeded {label} {tuple(x.shape)} [{col0}:{col0 + cols}] {str(dtype)[6:]}"
            err = hold_k5(torch, S, x, w, seed, col0, cols, tag)
            if label == "eval":  # K1's arithmetic over the whole width
                for direction, reverse in ((2, False), (3, True)):
                    k1 = S.sga_sweep_kernel(x, w, "h", reverse, direction=direction)
                    k5, bnd = S.sga_sweep_seeded_kernel(x, w, reverse, None, False, direction=direction)
                    same = torch.equal(k5, k1) and torch.equal(bnd, k1[:, :, 0 if reverse else -1])
                    log(f"  {tag} {'bt' if reverse else 'tb'}: unseeded over [0:{W}] against K1's H "
                        f"sweep: {'bit for bit' if same else 'DIFFERENT'}")
                    if not same:
                        raise AssertionError(f"{tag}: K5 over the whole width is not K1's H sweep")
                    del k1, k5, bnd
            out = torch.empty_like(x)
            ms = cuda_ms(torch, lambda: S.sga_sweep_seeded_kernel(
                x, w, False, seed, True, direction=2, col0=col0, cols=cols, out=out), reps=20)
            plain_ms = cuda_ms(torch, lambda: S.sga_sweep_plain(
                x[..., win], w[:, 2, :, :, win], "h", False, seed, True), reps=1)
            bound_ms, by, nbytes = seeded_fwd_bound(x, cols)
            info = S.sga_fwd_seeded_describe(x, w, seed, direction=2, col0=col0, cols=cols)
            log(f"  {tag}: kernel {ms:.4f} ms per launch, plain {plain_ms:.3f} ms, bound "
                f"{bound_ms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, {10 * N * D * H * cols / 1e9:.3f} "
                f"GFLOP), {bound_ms / ms:.1%} of it; {launches} launches {launches * ms:.3f} ms, gap "
                f"{launches * (ms - bound_ms):.3f} ms; card {smi}")
            log(f"    {describe_line(info)}, {info['blocks_per_sm']} blocks an SM")
            if not info["vectorised"] or info["local_bytes"]:
                faults.append(f"{tag}: K5 staged element-wise or spilled: {info}")
            path[(dtype, info["lanes"], info["bins"])] = label
            if label == "eval":  # the walk's pace: one step's time and the walk's start
                hs, ts = [], []
                for h in K5_SLOPE_HS:
                    xs, ws = x[:, :, :h].contiguous(), w[:, :, :, :h].contiguous()
                    ts.append(cuda_ms(torch, lambda: S.sga_sweep_seeded_kernel(
                        xs, ws, False, seed, True, direction=2, col0=col0, cols=cols), reps=20))
                    hs.append(h)
                    del xs, ws
                hm, tm = sum(hs) / len(hs), sum(ts) / len(ts)
                slope = sum((h - hm) * (t - tm) for h, t in zip(hs, ts)) / sum((h - hm) ** 2 for h in hs)
                step_bytes = (2 * N * D + 5 * N) * cols * x.element_size()
                log(f"    {tag} over H: " + ", ".join(f"H={h} {t:.4f}" for h, t in zip(hs, ts))
                    + f" ms; {slope * 1e3:.3f} us a step, {tm - slope * hm:.4f} ms at H=0; a step's "
                    f"bytes {step_bytes / 1e6:.3f} MB take {step_bytes / HBM_BYTES_PER_S * 1e6:.3f} us")
            if label == "eval" and dtype == torch.bfloat16:
                entry = {
                    "name": "sga_fwd_seeded", "route": "cuda",
                    "source": "ganet_tpu_torch/csrc/sga_fwd_seeded.cu",
                    "replaces": "ganet_tpu/ops/sga_pallas.py:115",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
                }
            del x, w, seed, out
        del x32, w32, s32
        torch.cuda.empty_cache()
    # K5's step loop in SASS at each layout the chunks ran (D = 64 at both).
    for name, ops in sass_chunk_loops(_build._lib_path("sga_fwd_seeded")).items():
        for (dtype, lanes, bins), label in path.items():
            if f"I{'13__nv_bfloat16' if dtype == torch.bfloat16 else 'f'}Li{lanes}ELi{bins}E" in name:
                log(f"  sga_fwd_seeded step loop {str(dtype)[6:]} (G={lanes}, B={bins}, {label} chunk): "
                    f"{sass_line(ops)}")
    if faults:
        raise AssertionError("; ".join(faults))
    # The top rungs of D, on a small volume.
    Nr, Hr, Wr = SGA_RUNG_SHAPE
    for Dr in SGA_RUNG_DS:
        x32 = torch.randn((Nr, Dr, Hr, Wr), device="cuda", generator=gen)
        w32 = l1_normalize(torch.randn((Nr, 4, 5, Hr, Wr), device="cuda", generator=gen), dim=2)
        for c0, nc in K5_RUNG_WINDOWS:
            s32 = torch.randn((Nr, Dr, nc), device="cuda", generator=gen)
            for dtype in (torch.float32, torch.bfloat16):
                x, w, seed = x32.to(dtype), w32.to(dtype), s32.to(dtype)
                tag = f"sga_fwd_seeded rung D={Dr} {tuple(x.shape)} [{c0}:{c0 + nc}] {str(dtype)[6:]}"
                hold_k5(torch, S, x, w, seed, c0, nc, tag)
                info = S.sga_fwd_seeded_describe(x, w, seed, direction=2, col0=c0, cols=nc)
                log(f"    K5 {tag}: {describe_line(info)}, {info['blocks_per_sm']} blocks an SM")
                if info["vectorised"] != ((c0, nc) == K5_RUNG_WINDOWS[0]) or info["local_bytes"]:
                    raise AssertionError(f"{tag}: K5's staging is not the window's, or it spilled: {info}")
    return entry


# K6's rungs: D = 129, 192 and 256 on SGA_RUNG_SHAPE's volume, in the window
# [8, 32) of its W = 40 (whole copies in both dtypes).
K6_RUNG_WINDOW = (8, 24)


def seeded_bwd_bound(x, cols: int):
    """(bound ms, "bytes" or "operations", bytes) of one K6 launch on `cols`
    columns of x: x, A, gbar and the old dx in the window, 5 weight planes,
    the 5 old dw planes, the seed and dboundary read once; dx, 5 dw planes
    and dseed written once (dx and dw are added into, so their old values
    are read)."""
    N, D, H, _ = x.shape
    vol = N * D * H * cols
    return window_bound(5 * vol, 2 * N * D * cols, 15 * N * H * cols + N * D * cols,
                        x.element_size(), 25 * vol)


def hold_k6(torch, S, x, w, seed, gbar, dbound, dx0, dw0, col0, cols, a_of, tag) -> float:
    """K6 against its plain version on the window [col0, col0 + cols), both
    directions, seeded and not, adding into copies of dx0 and dw0: dx, dw and
    dseed (exactly 0 without `valid`), and nothing written outside the window
    or the direction's slot.  a_of(direction, reverse, valid) gives the
    forward's output.  Returns the max abs error."""
    N, D, H, W = x.shape
    win = slice(col0, col0 + cols)
    outside = torch.ones((N, 1, H, W), dtype=torch.bool, device=x.device)
    outside[..., win] = False
    err = 0.0
    for direction, reverse in ((2, False), (3, True)):
        for valid in (True, False):
            a = a_of(direction, reverse, valid)
            dx, dw, dseed = S.sga_sweep_bwd_seeded_kernel(
                x, w, a, gbar, reverse, seed, valid, direction=direction, col0=col0,
                cols=cols, dboundary=dbound, dx=dx0.clone(), dw=dw0.clone())
            # The plain version on the inputs widened to f32: its dx and dw
            # before the rounding to dtype, which the kernel adds to the old
            # ones in f32 and rounds once.
            rdx, rdw, rds = S.sga_sweep_bwd_plain(
                x[..., win].float(), w[:, direction, :, :, win].float(), a[..., win].float(),
                gbar[..., win].float(), "h", reverse, seed.float(), valid, dbound)
            name = f"{tag} {'bt' if reverse else 'tb'} valid={valid}"
            err = max(err, compare(torch, f"{name} dx", dx[..., win],
                                   (dx0[..., win].float() + rdx).to(x.dtype), summed=True))
            err = max(err, compare(torch, f"{name} dw", dw[:, direction, :, :, win],
                                   (dw0[:, direction, :, :, win].float() + rdw).to(x.dtype),
                                   summed=True))
            err = max(err, compare(torch, f"{name} dseed", dseed, rds, summed=True))
            if not valid and bool(dseed.any()):
                raise AssertionError(f"{name}: dseed is not 0 without a seed")
            others = [k for k in range(4) if k != direction]
            if not (torch.equal(dx.masked_select(outside), dx0.masked_select(outside))
                    and torch.equal(dw[:, direction].masked_select(outside),
                                    dw0[:, direction].masked_select(outside))
                    and torch.equal(dw[:, others], dw0[:, others])):
                raise AssertionError(f"{name}: the kernel wrote outside its window or slot")
            del a, dx, dw, dseed, rdx, rdw, rds
    return err


def phase_seeded_bwd(torch, gen, smi):
    """K6 at the training shape's per-shard tail chunk (240x528 batch 2
    full-res block over 4 shards: (64, 64, 20, W=176), columns 48..176),
    f32 and bf16: against its plain version, its time beside its bound, its
    describe fields (vectorised staging, no local memory) and its step loop
    in SASS; then at D = 129, 192 and 256 on a small window.  Returns the
    JSON entry (bf16, valid, one launch)."""
    from ganet_tpu_torch.ops import _build
    from ganet_tpu_torch.ops import sga as S
    from ganet_tpu_torch.ops.normalize import l1_normalize

    N, D, H, W, col0, cols = 64, 64, 20, 176, 48, 128
    x32 = torch.randn((N, D, H, W), device="cuda", generator=gen)
    w32 = l1_normalize(torch.randn((N, 4, 5, H, W), device="cuda", generator=gen), dim=2)
    s32 = torch.randn((N, D, cols), device="cuda", generator=gen)
    b32 = torch.randn((N, D, H, W), device="cuda", generator=gen)
    dbound = torch.randn((N, D, cols), device="cuda", generator=gen)
    dx0_32 = torch.randn((N, D, H, W), device="cuda", generator=gen)
    dw0_32 = torch.randn((N, 4, 5, H, W), device="cuda", generator=gen)
    win = slice(col0, col0 + cols)
    entry = None
    path = {}
    for dtype in (torch.float32, torch.bfloat16):
        x, w, seed, gbar = x32.to(dtype), w32.to(dtype), s32.to(dtype), b32.to(dtype)
        dx0, dw0 = dx0_32.to(dtype), dw0_32.to(dtype)
        tag = f"sga_bwd_seeded {tuple(x.shape)} [{col0}:{col0 + cols}] {str(dtype)[6:]}"

        def k5(direction, reverse, valid):
            return S.sga_sweep_seeded_kernel(x, w, reverse, seed, valid, direction=direction,
                                             col0=col0, cols=cols, out=torch.zeros_like(x))[0]

        err = hold_k6(torch, S, x, w, seed, gbar, dbound, dx0, dw0, col0, cols, k5, tag)
        a = k5(2, False, True)
        dx, dw = torch.zeros_like(x), torch.zeros_like(w)

        def launch():
            S.sga_sweep_bwd_seeded_kernel(x, w, a, gbar, False, seed, True, direction=2, col0=col0,
                                          cols=cols, dboundary=dbound, dx=dx, dw=dw)

        ms = cuda_ms(torch, launch, reps=20)
        plain_ms = cuda_ms(torch, lambda: S.sga_sweep_bwd_plain(
            x[..., win], w[:, 2, :, :, win], a[..., win], gbar[..., win], "h", False, seed, True,
            dbound), reps=1)
        bound_ms, by, nbytes = seeded_bwd_bound(x, cols)
        info = S.sga_bwd_seeded_describe(x, w, seed, direction=2, col0=col0, cols=cols)
        log(f"  {tag}: kernel {ms:.4f} ms per launch, plain {plain_ms:.3f} ms, bound "
            f"{bound_ms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, {25 * N * D * H * cols / 1e9:.3f} "
            f"GFLOP), {bound_ms / ms:.1%} of it; card {smi}")
        log(f"    {describe_line(info)}, {info['blocks_per_sm']} blocks an SM")
        if not info["vectorised"] or info["local_bytes"]:
            raise AssertionError(f"{tag}: K6 staged element-wise or spilled: {info}")
        path[dtype] = info
        if dtype == torch.bfloat16:
            entry = {
                "name": "sga_bwd_seeded", "route": "cuda",
                "source": "ganet_tpu_torch/csrc/sga_bwd_seeded.cu",
                "replaces": "ganet_tpu/ops/sga_pallas.py:295",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
            }
        del x, w, seed, gbar, a, dx, dw, dx0, dw0
    del x32, w32, s32, b32, dbound, dx0_32, dw0_32
    # K6's step loop in SASS at the path's layout (every bin in [0, D)).
    for name, ops in sass_chunk_loops(_build._lib_path("sga_bwd_seeded")).items():
        for dtype, info in path.items():
            want = f"{'13__nv_bfloat16' if dtype == torch.bfloat16 else 'f'}Li{info['lanes']}ELi{info['bins']}ELb1E"
            if want in name:
                log(f"  sga_bwd_seeded step loop {str(dtype)[6:]} (G={info['lanes']}, B={info['bins']}): "
                    f"{sass_line(ops)}")
    # The top rungs of D, on a small window; A from the plain forward.
    Nr, Hr, Wr = SGA_RUNG_SHAPE
    c0, nc = K6_RUNG_WINDOW
    rwin = slice(c0, c0 + nc)
    for Dr in SGA_RUNG_DS:
        x32 = torch.randn((Nr, Dr, Hr, Wr), device="cuda", generator=gen)
        w32 = l1_normalize(torch.randn((Nr, 4, 5, Hr, Wr), device="cuda", generator=gen), dim=2)
        s32 = torch.randn((Nr, Dr, nc), device="cuda", generator=gen)
        b32 = torch.randn((Nr, Dr, Hr, Wr), device="cuda", generator=gen)
        dbound = torch.randn((Nr, Dr, nc), device="cuda", generator=gen)
        dx0_32 = torch.randn((Nr, Dr, Hr, Wr), device="cuda", generator=gen)
        dw0_32 = torch.randn((Nr, 4, 5, Hr, Wr), device="cuda", generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            x, w, seed, gbar = x32.to(dtype), w32.to(dtype), s32.to(dtype), b32.to(dtype)
            tag = f"sga_bwd_seeded rung D={Dr} {tuple(x.shape)} [{c0}:{c0 + nc}] {str(dtype)[6:]}"

            def plain_a(direction, reverse, valid):
                a = torch.zeros_like(x)
                a[..., rwin] = S.sga_sweep_plain(x[..., rwin], w[:, direction, :, :, rwin], "h",
                                                 reverse, seed, valid).to(dtype)
                return a

            hold_k6(torch, S, x, w, seed, gbar, dbound, dx0_32.to(dtype), dw0_32.to(dtype), c0, nc,
                    plain_a, tag)
            info = S.sga_bwd_seeded_describe(x, w, seed, direction=2, col0=c0, cols=nc)
            log(f"    K6 {tag}: {describe_line(info)}, {info['blocks_per_sm']} blocks an SM")
            if not info["vectorised"] or info["local_bytes"]:
                raise AssertionError(f"{tag}: K6 staged element-wise or spilled: {info}")
    return entry


# Phase 12: the sharded path on 4 ranks sharing the card, over gloo.  The
# f32 gradients against the unsharded kernels, norm-relative; the bf16
# forward differs from the unsharded one where the boundary row is rounded
# to bf16 at each shard border (the unsharded carry stays f32): a few ulps
# of max|ref|.
SHARDS = 4
SHARDED_GRAD_TOL = 1e-4
SHARDED_BF16_ULPS = 4


def sharded_cases():
    """The cases of phase 12 (see ganet_tpu_torch/parallel/cases.py)."""
    full = (1, 32, 64, 192, 320)  # GANet_deep's full-res SGA block at 576x960
    train = (2, 32, 64, 80, 176)  # ... and at the 240x528 batch-2 training crop
    return [
        dict(name="sga_bf16", op="sga", shape=full, seed=1, dtype="bfloat16", reps=5),
        dict(name="sga_f32", op="sga", shape=full, seed=1, dtype="float32"),
        dict(name="sga_grad", op="sga", shape=train, seed=2, dtype="float32", grad=True, reps=3),
        dict(name="lga_f32", op="lga", shape=(1, 192, 576, 960), seed=3, repeats=2, dtype="float32"),
        dict(name="lga_grad", op="lga", shape=(2, 192, 240, 528), seed=4, repeats=2,
             dtype="float32", grad=True),
    ]


def norm_rel(torch, got, ref) -> float:
    return ((got.double() - ref.double()).norm() / ref.double().norm().clamp_min(1e-30)).item()


def sharded_grad_gap(torch, tag, x, w, gbar, res) -> None:
    """Where the f32 sharded gradients part from the unsharded ones.  The
    sharded path runs its H sweeps by K5 (its carry crosses the shard
    borders in f32), the unsharded path by K1.  Measures K1's H sweeps
    against K5's, unseeded over the whole volume: their difference, the
    (n, h, w) steps whose argmax over d differs (the cell the w4 term's
    gradient goes to) and the elements where the max over the 4 directions
    picks another sweep; then holds the unsharded gradient, with K5's H
    sweeps as its residuals in place of K1's, against the sharded one."""
    from ganet_tpu_torch.ops import sga as S

    B, C, D, H, W = x.shape
    xn, wn = x.reshape(B * C, D, H, W), w.reshape(B * C, 4, 5, H, W)
    a1 = [S.sga_sweep_kernel(xn, wn, axis, rev, direction=k) for k, (axis, rev) in enumerate(S.DIRECTIONS)]
    a5 = a1[:2] + [S.sga_sweep_seeded_kernel(xn, wn, rev, direction=k)[0]
                   for k, (axis, rev) in enumerate(S.DIRECTIONS) if axis == "h"]
    for k in (2, 3):
        diff = (a1[k] - a5[k]).abs()
        flips = int((a1[k].argmax(1) != a5[k].argmax(1)).sum())
        log(f"  {tag}: H sweep {k}, K1 vs K5 (f32): max |diff| {diff.max().item():.3e} over "
            f"max|A| {a1[k].abs().max().item():.3e}, {int((diff > 0).sum())} of {diff.numel()} "
            f"elements differ; argmax over d differs at {flips} of {diff.numel() // D} steps")
        del diff
    routes = int((torch.stack(a1).argmax(0) != torch.stack(a5).argmax(0)).sum())
    log(f"  {tag}: the max over the 4 directions picks another sweep at {routes} of {xn.numel()} elements")
    del a1
    gs = S.max_tree_bwd(a5, gbar.reshape(xn.shape).contiguous())
    dx, dw = None, torch.empty_like(wn)
    for k, (axis, rev) in enumerate(S.DIRECTIONS):
        dx, _ = S.sga_sweep_bwd_kernel(xn, wn, a5[k], gs[k], axis, rev, direction=k, dx=dx, dw=dw)
    for name, got in (("dx", dx), ("dw", dw)):
        e = norm_rel(torch, res[name].cuda().reshape(got.shape), got)
        ok = e <= SHARDED_GRAD_TOL
        log(f"  {tag}: {name} norm-relative {e:.3e} against the unsharded gradient with K5's H "
            f"sweeps as residuals (tol {SHARDED_GRAD_TOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag}: {name} disagrees with the unsharded gradient on K5's sweeps")


def phase_sharded(torch, smi, entries):
    """Sharded SGA (K1, K5 / K3, K6) and LGA (K2 / K4) on SHARDS ranks that
    share the card, against the unsharded kernels in this process."""
    import tempfile

    from ganet_tpu_torch.ops import lga as G
    from ganet_tpu_torch.ops import sga as S
    from ganet_tpu_torch.parallel import cases as K
    from ganet_tpu_torch.parallel.launch import launch
    from ganet_tpu_torch.parallel.sharded_sga import chunk_layout

    cases = sharded_cases()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        launch(K.run_cases, SHARDS, (cases, out_dir, "cuda"), backend="gloo", device="cuda")
        log(f"[12] {SHARDS} ranks on one card (gloo, boundary rows staged through the host): "
            f"all cases in {time.perf_counter() - t0:.1f} s")
        results = {c["name"]: K.gather(c, out_dir, SHARDS) for c in cases}
    for case in cases:
        name, res = case["name"], results[case["name"]]
        dtype = getattr(torch, case["dtype"])
        inputs = {k: torch.from_numpy(v).cuda().to(dtype) for k, v in K.make_inputs(case).items()}
        grad = bool(case.get("grad"))
        x = inputs["x"].requires_grad_(grad)
        other = inputs["w" if case["op"] == "sga" else "g"].requires_grad_(grad)
        with torch.set_grad_enabled(grad):
            if case["op"] == "sga":
                ref = S.sga_ncdhw(x, other)
            else:
                ref = G.lga_nchw(x, other, 2, case["repeats"])
            if grad:
                ref.backward(inputs["gbar"])
        ref = ref.detach()
        got = res["out"].cuda()
        tag = f"[12] sharded {name} {tuple(case['shape'])} over {SHARDS} ranks vs unsharded"
        if dtype == torch.float32:
            compare(torch, f"{tag}: out", got, ref)
        else:
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            ok = err <= SHARDED_BF16_ULPS * BF16_ULP * scale
            log(f"  {tag}: out max_abs_err={err:.3e} max|ref|={scale:.3e} = "
                f"{err / (BF16_ULP * scale):.2f} bf16 ulps of max|ref| (tol {SHARDED_BF16_ULPS}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{tag}: the sharded bf16 forward is off the unsharded one")
        if grad:
            for k, r in (("dx", x.grad), ("dw" if case["op"] == "sga" else "dg", other.grad)):
                e = norm_rel(torch, res[k].cuda(), r)
                ok = e <= SHARDED_GRAD_TOL
                log(f"  {tag}: {k} norm-relative {e:.3e} (tol {SHARDED_GRAD_TOL}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{tag}: {k} disagrees with the unsharded gradient")
            if case["op"] == "sga":
                sharded_grad_gap(torch, tag, x.detach(), other.detach(), inputs["gbar"], res)
        # Launches on every rank: 2 K1 + 2 x nchunks K5 forward, 2 K3 + 2 x nchunks K6 backward.
        if case["op"] == "sga":
            n = len(chunk_layout(case["shape"][-1], case.get("chunks", 0))[1])
            want = {"sga_fwd": 2, "sga_fwd_seeded": 2 * n, "sga_bwd": 2 * grad, "sga_bwd_seeded": 2 * n * grad}
        else:
            want = {"lga_fwd": case["repeats"], "lga_bwd": case["repeats"] * grad}
        for rank, got_counts in enumerate(res["launches"]):
            want = {k: want.get(k, 0) for k in got_counts}
            if got_counts != want:
                raise AssertionError(f"{tag}: rank {rank} launched {got_counts}, expected {want}")
        log(f"  {tag}: launches on each rank {want}")
        if res["times"][0]:
            per_rank = [min(t) for t in res["times"]]
            what = "forward and backward" if grad else "forward"
            log(f"  {tag}: {what} wall time per rank, {SHARDS} ranks sharing one card (not a "
                f"multi-GPU time): {', '.join(f'{t:.2f}' for t in per_rank)} ms (min of "
                f"{len(res['times'][0])}); card {smi}")
            if case["op"] == "sga" and not grad:
                xs, ws = x.detach(), other.detach()
                ms = cuda_ms(torch, lambda: S.sga_ncdhw(xs, ws), reps=5)
                log(f"  {tag}: the unsharded K1 sga on the whole volume: {ms:.3f} ms")
        # K5's launches in a sharded eval forward (its entry's time is the
        # eval chunk's), K6's in a sharded training step.
        for e in entries:
            if (e["name"], name) in (("sga_fwd_seeded", "sga_bf16"), ("sga_bwd_seeded", "sga_grad")):
                e["launches"] = sum(c[e["name"]] for c in res["launches"])
        del inputs, x, other, ref, got, res
        results[name] = None
        torch.cuda.empty_cache()


# Tolerance of phase 8, norm-relative: the kernels' gradients against the
# plain versions', over all parameters and for the worst one.  The whole
# model's float32 gradient is chaotic at the 1e-2 level: the argmax of each
# SGA carry and every ReLU mask flip under a change in the last bit, and
# cuDNN's and the trilinear upsample's backward sum with atomics.  The
# kernel route run twice on identical inputs differed by 7.5e-3 over all
# and 1.6e-2 on the worst parameter (a BatchNorm scale), and kernels
# against plain versions by 6.7e-3 and 1.7e-2, on an H100 80GB HBM3 at
# 700 W; a wrong gradient kernel moves its parameters by O(1).  The
# tolerances give that noise 4x and 6x room.
GRAD_TOL_ALL = 3e-2
GRAD_TOL_PARAM = 1e-1


def train_loss(model, batch, weights):
    """The train-mode forward and deep-supervision loss of `make_train_step`
    (no left_right)."""
    from ganet_tpu_torch.train import deep_supervision_loss

    outputs = model(batch["left"], batch["right"])
    return deep_supervision_loss(outputs, batch["disparity"], batch["valid"], weights)


def phase_grad_parity(torch):
    """Whole-model gradients in train mode, kernels vs plain versions."""
    from ganet_tpu_torch import build_model, ganet_deep
    from ganet_tpu_torch.data import SyntheticStereoDataset, stack

    H, W, D = 240, 528, 192
    batch = {k: torch.from_numpy(v).cuda() for k, v in stack(SyntheticStereoDataset(H, W, D), [0]).items()}
    weights = (0.2, 0.6, 1.0)
    grads, losses = {}, {}
    for run in ("kernel", "kernel again", "torch"):
        model = build_model(ganet_deep(max_disp=D, impl=run.split()[0]), seed=0).train()
        loss = train_loss(model, batch, weights)
        loss.backward()
        losses[run] = loss.item()
        grads[run] = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        del model, loss
    torch.cuda.empty_cache()

    def rel(a, b):
        flat = lambda g: torch.cat([g[n].flatten().double() for n in sorted(g)])  # noqa: E731
        per = max(((a[n] - b[n]).double().norm() / b[n].double().norm().clamp_min(1e-30)).item() for n in b)
        return (flat(a) - flat(b)).norm().item() / flat(b).norm().item(), per

    noise_all, noise_param = rel(grads["kernel again"], grads["kernel"])
    diff_all, diff_param = rel(grads["kernel"], grads["torch"])
    worst = sorted(
        (((grads["kernel"][n] - grads["torch"][n]).double().norm() / grads["torch"][n].double().norm()).item(), n)
        for n in grads["torch"]
    )[-3:]
    loss_rel = abs(losses["kernel"] - losses["torch"]) / abs(losses["torch"])
    ok = (loss_rel <= 1e-5 and diff_all <= GRAD_TOL_ALL and diff_param <= GRAD_TOL_PARAM
          and all(torch.isfinite(g).all() for g in grads["kernel"].values()))
    log(f"[8] GANet_deep {H}x{W} D={D} batch 1 train mode f32 (TF32 off): loss kernel "
        f"{losses['kernel']:.6f} torch {losses['torch']:.6f} (rel {loss_rel:.2e}, tol 1e-5); gradients "
        f"kernel vs torch: all {diff_all:.2e} (tol {GRAD_TOL_ALL}), worst parameter {diff_param:.2e} "
        f"(tol {GRAD_TOL_PARAM}); kernel vs kernel again: all {noise_all:.2e}, worst parameter "
        f"{noise_param:.2e} {'ok' if ok else 'FAIL'}")
    log("  worst parameters kernel vs torch: " + ", ".join(f"{n} {v:.2e}" for v, n in worst))
    if not ok:
        raise AssertionError("model gradients through the kernels disagree with the plain versions")


def phase_train_path(torch, smi, entries):
    """GANet_deep 240x528 D=192 batch 2 bf16 train step: counted step, then
    more steps on the same batch, timed, then a profile."""
    from ganet_tpu_torch.config import DataConfig, TrainConfig, ganet_deep
    from ganet_tpu_torch.data import SyntheticStereoDataset, stack
    from ganet_tpu_torch.utils.profiling import read_launches, reset_launches
    from ganet_tpu_torch.train import create_train_state, make_train_step

    H, W, D, B = 240, 528, 192, 2
    cfg = TrainConfig(
        model=ganet_deep(max_disp=D, compute_dtype="bfloat16"),
        data=DataConfig(crop_height=H, crop_width=W, kind="synthetic"),
        batch_size=B,
    )
    state = create_train_state(cfg)
    step = make_train_step(cfg)
    ds = SyntheticStereoDataset(H, W, D)
    batch = stack(ds, range(B))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    metrics = step(state, batch)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[9] launches in one train step: {launches}")
    n_sga = 4 * (cfg.model.num_sga_full + cfg.model.num_sga_half)
    n_lga = 2 * cfg.model.lga_repeats
    want = {"sga_fwd": n_sga, "sga_bwd": n_sga, "lga_fwd": n_lga, "lga_bwd": n_lga,
            "sga_fwd_seeded": 0, "sga_bwd_seeded": 0, "lga3d_fwd": 0}
    if launches != want:
        raise AssertionError(f"expected launches {want} in one train step, got {launches}")
    for e in entries:
        if e["name"] in ("sga_bwd", "lga_bwd"):
            e["launches"] = launches[e["name"]]

    losses = [metrics["loss"].item()]
    times = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(map(lambda v: v == v and abs(v) != float("inf"), losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall on a fixed batch: {losses}")
    log(f"[9] GANet_deep {H}x{W} D={D} bf16 batch {B} train step: loss on one batch over "
        f"{len(losses)} Adam steps {', '.join(f'{v:.4f}' for v in losses)}; epe {m['epe'].item():.3f}; "
        f"step time {min(times[-3:]):.1f} ms (min of the last 3; all "
        f"{', '.join(f'{t:.1f}' for t in times)}); peak memory {peak:.2f} GiB; card {smi}")

    model = state.model
    b = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    holder = {}

    def forward():
        holder["loss"] = train_loss(model, b, cfg.loss_weights)

    profile_forward(torch, forward, "[9] profile of the train step's forward and loss")
    profile_forward(torch, lambda: holder.pop("loss").backward(), "[9] profile of the train step's backward")
    state.optimizer.zero_grad(set_to_none=True)


def expect_launches(torch, tag: str, want: dict) -> dict:
    """Read the counts after a run; every kernel not in `want` must be 0."""
    from ganet_tpu_torch.utils.profiling import read_launches

    torch.cuda.synchronize()
    got = read_launches()
    full = {k: want.get(k, 0) for k in got}
    if got != full:
        raise AssertionError(f"{tag}: launched {got}, expected {full}")
    log(f"  {tag}: launches {got}")
    return got


# Launches a K7 timing averages over (and K2's beside it in phase 13): 50 at
# about 0.6 ms is a 30 ms window, which one slow stretch of the card moves
# less than it moves a 6 ms one.
K7_REPS = 50


def k7_describe(G, tag: str, xf, r: int, gdiv: int, spills: list) -> None:
    """Print K7's describe line for a launch on the fold xf; a launch that
    uses local memory goes into `spills`, for phase 13 to fail on once every
    time has been printed."""
    info = G.lga3d_describe(xf, r, gdiv)
    log(f"  {tag}: {lga_describe_line(info)}")
    if info["local_bytes"]:
        spills.append(f"{tag}: K7 uses local memory: {info}")


def phase_lga3d(torch, gen, smi):
    """K7 at one channel per guidance (K2's function, bit for bit) at the
    eval head; the `lga3d` path at GANet_deep's full-res volume and at the
    training crop's, with K7 timed beside its bound at both; returns K7's
    JSON entry (one bf16 pass over the full-res volume)."""
    from ganet_tpu_torch.ops import dispatch
    from ganet_tpu_torch.ops import lga as G
    from ganet_tpu_torch.utils.profiling import reset_launches
    from ganet_tpu_torch.ops.normalize import l1_normalize

    r = 2
    spills = []
    # (i) gdiv 1 at the eval head (1, 192, 576, 960): K7 against its plain version and K2.
    x32 = torch.randn((1, 192, 576, 960), device="cuda", generator=gen)
    g32 = l1_normalize(torch.randn((1, 75, 576, 960), device="cuda", generator=gen), dim=1)
    for dtype in (torch.float32, torch.bfloat16):
        x, g = x32.to(dtype), g32.to(dtype)
        tag = f"lga3d_fwd gdiv 1 {tuple(x.shape)} r{r} {str(dtype)[6:]}"
        got = G.lga3d_kernel(x, g, r, 1)
        compare(torch, f"{tag} vs plain", got, G.lga3d_fwd_plain(x, g, r, 1).to(dtype))
        if not torch.equal(got, G.lga_kernel(x, g, r)):
            raise AssertionError(f"{tag}: K7 at gdiv 1 differs from K2")
        log(f"  {tag}: equal to K2 bit for bit")
        del got
        k7_ms = cuda_ms(torch, lambda: G.lga3d_kernel(x, g, r, 1), reps=K7_REPS)
        k2_ms = cuda_ms(torch, lambda: G.lga_kernel(x, g, r), reps=K7_REPS)
        bound_ms, by, _, _ = lga_bound(x.numel(), g.numel(), x.element_size())
        log(f"  {tag}: K7 {k7_ms:.3f} ms, K2 {k2_ms:.3f} ms per pass, bound {bound_ms:.3f} ms ({by}); "
            f"card {smi}")
        del x, g
    del x32, g32
    torch.cuda.empty_cache()

    # (ii) lga3d forward at GANet_deep's full-res aggregation volume, (B, C, D, H, W).
    B, C, D, H, W = 1, 32, 64, 192, 320
    x32 = torch.randn((B, C, D, H, W), device="cuda", generator=gen)
    g32 = l1_normalize(torch.randn((B, 75, H, W), device="cuda", generator=gen), dim=1)
    entry = None
    for dtype in (torch.float32, torch.bfloat16):
        x, g = x32.to(dtype), g32.to(dtype)
        tag = f"lga3d {tuple(x.shape)} r{r} {str(dtype)[6:]}"
        errs, counted = {}, {}
        for repeats in (1, 2):
            reset_launches()
            got = dispatch.lga3d_ncdhw(x, g, r, repeats)
            counted[repeats] = expect_launches(torch, f"{tag} repeats {repeats}", {"lga3d_fwd": repeats})
            ref = G.lga3d_reference_ncdhw(x, g, r, repeats)
            errs[repeats] = compare(torch, f"{tag} repeats {repeats}", got, ref)
            del got, ref
        xf = x.view(B * C, D, H, W)
        ms = cuda_ms(torch, lambda: G.lga3d_kernel(xf, g, r, C), reps=K7_REPS)
        plain_ms = cuda_ms(torch, lambda: G.lga3d_fwd_plain(xf, g, r, C), reps=1)
        bound_ms, by, nbytes, flops = lga_bound(x.numel(), g.numel(), x.element_size())
        log(f"  {tag}: K7 {ms:.3f} ms per pass, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
            f"({by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), {ms / bound_ms:.2f}x the bound; "
            f"card {smi}")
        k7_describe(G, tag, xf, r, C, spills)
        if dtype == torch.bfloat16:
            entry = {
                "name": "lga3d_fwd", "route": "cuda",
                "source": "ganet_tpu_torch/csrc/lga3d_fwd.cu",
                "replaces": "ganet_tpu/ops/lga_pallas.py:267",
                "launches": counted[2]["lga3d_fwd"],
                "max_abs_err": errs[1], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
            }
        del x, g, xf
    del x32, g32
    torch.cuda.empty_cache()
    # What bounds K7: its chunk loop in SASS, per instantiation.
    from ganet_tpu_torch.ops import _build

    for name, ops in sass_chunk_loops(_build._lib_path("lga3d_fwd")).items():
        kind = ("bf16" if "bfloat16" in name else "f32") + (" r2" if "Li2E" in name else " r1")
        log(f"  lga3d_fwd chunk loop {kind}: {sass_line(ops)}")

    # (iii) lga3d forward and backward at the training crop's volume, repeats 2,
    # through the kernels (K7, K4) and through autograd of the plain forward.
    B, C, D, H, W, repeats = 2, 32, 64, 80, 176, 2
    x32 = torch.randn((B, C, D, H, W), device="cuda", generator=gen)
    g32 = l1_normalize(torch.randn((B, 75, H, W), device="cuda", generator=gen), dim=1)
    b32 = torch.randn((B, C, D, H, W), device="cuda", generator=gen)
    for dtype in (torch.float32, torch.bfloat16):
        x, g, gbar = x32.to(dtype), g32.to(dtype), b32.to(dtype)
        xf = x.view(B * C, D, H, W)
        ms = cuda_ms(torch, lambda: G.lga3d_kernel(xf, g, r, C), reps=K7_REPS)
        bound_ms, by, _, _ = lga_bound(x.numel(), g.numel(), x.element_size())
        tag = f"lga3d {tuple(x.shape)} r{r} {str(dtype)[6:]}"
        log(f"  {tag}: K7 {ms:.3f} ms per pass, bound {bound_ms:.3f} ms ({by}), "
            f"{ms / bound_ms:.2f}x the bound; card {smi}")
        k7_describe(G, tag, xf, r, C, spills)
        del xf
        tag = f"lga3d grad {tuple(x.shape)} r{r} repeats {repeats} {str(dtype)[6:]}"
        res = {}
        for impl in ("kernel", "torch"):
            xr, gr = x.clone().requires_grad_(), g.clone().requires_grad_()
            reset_launches()
            out = dispatch.lga3d_ncdhw(xr, gr, r, repeats, impl=impl)
            out.backward(gbar)
            want = {"lga3d_fwd": repeats, "lga_bwd": repeats} if impl == "kernel" else {}
            expect_launches(torch, f"{tag} {impl}", want)
            res[impl] = (out.detach(), xr.grad, gr.grad)
            del xr, gr, out
        compare(torch, f"{tag} out", res["kernel"][0], res["torch"][0])
        compare(torch, f"{tag} dx", res["kernel"][1], res["torch"][1], summed=True)
        compare(torch, f"{tag} dg", res["kernel"][2], res["torch"][2], summed=True)
        del res

        def step():
            xr, gr = x.detach().requires_grad_(), g.detach().requires_grad_()
            dispatch.lga3d_ncdhw(xr, gr, r, repeats).backward(gbar)

        ms = cuda_ms(torch, step, reps=3)
        log(f"  {tag}: forward and backward through K7 and K4 {ms:.3f} ms; card {smi}")
        del x, g, gbar
    del x32, g32, b32
    torch.cuda.empty_cache()
    if spills:
        raise AssertionError("; ".join(spills))
    return entry


# Phase 14: KITTI 2015's frame and the crop the reference pads it to.
KITTI_FRAME = (375, 1242)
KITTI_CROP = (384, 1248)
FROM_FILES_FRAMES = 1
BENCH_ITERS = 5


def recorded_line(seen, launches) -> str:
    """The recorded shapes of a counted run; raises unless the recorders saw
    every launch that the wrappers counted."""
    from ganet_tpu_torch.utils.profiling import RECORDED

    for name in RECORDED:
        if sum(n for k, n in seen.items() if k[0] == name) != launches[name]:
            raise AssertionError(f"{name}: recorded {dict(seen)}, counted {launches[name]}")
    return "; ".join(f"{k[0]} {k[1]} {str(k[2])[6:]}{f' r{k[3]}' if len(k) > 3 else ''} x{n}"
                     for k, n in seen.items())


def hold_at_path_shapes(torch, gen, shapes, tag) -> None:
    """K1 and K3 (each direction, storing and accumulating), K2 and K4
    against their plain versions, float32 and bfloat16, at each volume
    shape in `shapes` (from `recording_shapes`); K5 and K6 (both
    directions, seeded and not) on each column window of the sharded
    wavefront's chunks (`chunk_layout`) of each block they swept."""
    from ganet_tpu_torch.ops import lga as G
    from ganet_tpu_torch.ops import sga as S
    from ganet_tpu_torch.ops.normalize import l1_normalize
    from ganet_tpu_torch.parallel.sharded_sga import chunk_layout

    for key in sorted({k[:2] + k[3:] for k in shapes}, key=str):  # dtype aside: both are held
        kind, shape = key[:2]
        x32 = torch.randn(shape, device="cuda", generator=gen)
        p32 = torch.randn(shape, device="cuda", generator=gen)  # prev for K1/K3, gbar for K4
        for dtype in (torch.float32, torch.bfloat16):
            name = f"{tag} {kind} {shape} {str(dtype)[6:]}"
            x, p = x32.to(dtype), p32.to(dtype)
            if kind in ("sga_fwd", "sga_bwd", "sga_fwd_seeded", "sga_bwd_seeded"):
                N, D, H, W = shape
                w = l1_normalize(torch.randn((N, 4, 5, H, W), device="cuda", generator=gen),
                                 dim=2).to(dtype)
                if kind == "sga_fwd":
                    hold_k1(torch, S, x, w, p, name)
                elif kind == "sga_fwd_seeded":
                    cols, starts = chunk_layout(W)
                    seed = p[:, :, 0, :cols].contiguous()  # (N, D, cols)
                    for col0 in starts:
                        hold_k5(torch, S, x, w, seed, col0, cols, f"{name} [{col0}:{col0 + cols}]")
                    del seed
                elif kind == "sga_bwd_seeded":
                    cols, starts = chunk_layout(W)
                    seed = p[:, :, 0, :cols].contiguous()
                    gbar = torch.randn(shape, device="cuda", generator=gen).to(dtype)
                    dbound = torch.randn((N, D, cols), device="cuda", generator=gen)
                    dx0 = torch.randn(shape, device="cuda", generator=gen).to(dtype)
                    dw0 = torch.randn(tuple(w.shape), device="cuda", generator=gen).to(dtype)
                    for col0 in starts:
                        def k5(direction, reverse, valid, col0=col0):
                            return S.sga_sweep_seeded_kernel(
                                x, w, reverse, seed, valid, direction=direction, col0=col0,
                                cols=cols, out=torch.zeros_like(x))[0]

                        hold_k6(torch, S, x, w, seed, gbar, dbound, dx0, dw0, col0, cols, k5,
                                f"{name} [{col0}:{col0 + cols}]")
                    del seed, gbar, dbound, dx0, dw0
                else:
                    gbar = torch.randn(shape, device="cuda", generator=gen).to(dtype)
                    hold_k3(torch, S, x, w, gbar, p, name)
                    del gbar
                del w
            else:
                r = key[2]
                B, _, H, W = shape
                g = l1_normalize(torch.randn((B, 3 * (2 * r + 1) ** 2, H, W), device="cuda",
                                             generator=gen), dim=1).to(dtype)
                if kind == "lga_fwd":
                    compare(torch, f"{name} r{r}", G.lga_kernel(x, g, r), G.lga_reference_nchw(x, g, r, 1))
                else:
                    got_dx, got_dg = G.lga_bwd_kernel(x, g, p, r)
                    ref_dx, ref_dg = G.lga_bwd_plain(x, g, p, r)
                    compare(torch, f"{name} r{r} dx", got_dx, ref_dx, summed=True)
                    compare(torch, f"{name} r{r} dg", got_dg, ref_dg, summed=True)
                    del got_dx, got_dg, ref_dx, ref_dg
                del g
            del x, p
            torch.cuda.empty_cache()
        del x32, p32
        torch.cuda.empty_cache()


def hold_pngs(written, ds, model, frame) -> None:
    """Each PNG that the predict CLI wrote against `entry.predict` on the
    same padded input (sample i of `ds`), unpadded to the (H, W) frame."""
    import os

    import numpy as np

    from ganet_tpu_torch.data import png
    from ganet_tpu_torch.entry import predict

    H0, W0 = frame
    CH = ds.crop_height
    # The forward repeats itself bit for bit (the kernels sum in a fixed
    # order, cuDNN picks by shape and layout), which the check needs: with
    # random weights the bf16 disparity is chaotic, the head's renormalised
    # expectation dividing by sums near zero, so a change in the last bit of
    # a convolution moves pixels by whole px.
    for i, path in enumerate(written):
        got = png.read_disparity_png(path)
        s = ds[i]
        ref = predict(model, s["left"][None], s["right"][None])[0].float().cpu().numpy()
        ref = np.floor(np.clip(ref[CH - H0 :, :W0] * 256.0, 0, 65535)) / 256.0
        diff = np.abs(got - ref) if got.shape == ref.shape else np.array([np.inf])
        err = float(diff.max())
        ok = err <= 1.0 / 256
        log(f"  {os.path.basename(path)}: {got.shape[0]}x{got.shape[1]}, max |png - "
            f"entry.predict| {err:.5f} px (tol 1/256; {int((diff > 1.0 / 256).sum())} pixels "
            f"past it), range [{got.min():.2f}, {got.max():.2f}] {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{path} is not entry.predict's disparity")


def write_kitti(root: str, names, frame, rng) -> tuple:
    """KITTI-2015-shaped frames `names` of `frame` (H, W) under `root`
    (image_2, image_3, disp_occ_0) and their list beside it; returns (the
    list's path, the RGB PNG writes' times in s)."""
    import os

    import numpy as np

    from ganet_tpu_torch.data import png

    H0, W0 = frame
    for sub in ("image_2", "image_3", "disp_occ_0"):
        os.makedirs(os.path.join(root, sub))
    write_s = []
    for name in names:
        # A textured left view, the right view shifted by 12 px, and
        # ground truth on 40 % of the pixels (KITTI's is sparse).
        base = rng.integers(0, 256, (H0 // 8 + 2, W0 // 8 + 2, 3)).astype(np.float32)
        left = np.kron(base, np.ones((8, 8, 1)))[:H0, :W0] + rng.normal(0, 6, (H0, W0, 3))
        left = np.clip(left, 0, 255).astype(np.uint8)
        right = np.roll(left, -12, axis=1)
        gt = np.full((H0, W0), 12.0, np.float32) * (rng.random((H0, W0)) < 0.4)
        for sub, img in (("image_2", left), ("image_3", right)):
            t0 = time.perf_counter()
            png.write_png(os.path.join(root, sub, name), img)
            write_s.append(time.perf_counter() - t0)
        png.write_disparity_png(os.path.join(root, "disp_occ_0", name), gt)
    lst = root + ".list"
    with open(lst, "w") as f:
        f.write("\n".join(names))
    return lst, write_s


def phase_from_files(torch, gen, smi) -> None:
    """The from-files path on the card: a PNG frame and a checkpoint written
    here from seeds, then the predict CLI, the evaluate CLI (offline and
    online) and the bench entry, in this process; then K1 and K2 against
    their plain versions at the shapes those runs launched them at."""
    import io
    import os
    import tempfile
    from collections import Counter

    import numpy as np

    from ganet_tpu_torch import bench, evaluate, ganet_deep
    from ganet_tpu_torch import predict as predict_cli
    from ganet_tpu_torch.data import png
    from ganet_tpu_torch.data.dataset import StereoDataset
    from ganet_tpu_torch.entry import build_model, predict
    from ganet_tpu_torch.train.checkpoint import load_inference_state, save_checkpoint
    from ganet_tpu_torch.utils.profiling import read_launches, recording_shapes, reset_launches

    (H0, W0), (CH, CW), D = KITTI_FRAME, KITTI_CROP, 192
    rng = np.random.default_rng(14)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "kitti")
        names = [f"{i:06d}_10.png" for i in range(FROM_FILES_FRAMES)]
        lst, write_s = write_kitti(root, names, (H0, W0), rng)
        read_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            png.read_image(os.path.join(root, "image_2", names[0]))
            read_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        png.read_disparity_png(os.path.join(root, "disp_occ_0", names[0]))
        read_gt_s = time.perf_counter() - t0
        log(f"[14] PNG {H0}x{W0} on the host: RGB write {min(write_s) * 1e3:.1f} ms (min of "
            f"{len(write_s)}), RGB read {min(read_s) * 1e3:.1f} ms (min of 3; all "
            f"{', '.join(f'{t * 1e3:.1f}' for t in read_s)}), 16-bit disparity read {read_gt_s * 1e3:.1f} ms")

        ckpt = os.path.join(tmp, "ckpt")
        save_checkpoint(ckpt, 0, build_model(ganet_deep(max_disp=D), device="cpu", seed=0))
        out = os.path.join(tmp, "result")
        data = ["--kitti2015", "1", "--data_path", root, "--test_list", lst]
        crop = ["--crop_height", str(CH), "--crop_width", str(CW), "--max_disp", str(D),
                "--model", "GANet_deep", "--bf16", "1", "--resume", ckpt]
        shapes = Counter()
        torch.cuda.synchronize()
        with recording_shapes(shapes):
            reset_launches()
            t0 = time.perf_counter()
            written = predict_cli.main(data + crop + ["--save_path", out])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            launches = read_launches()
        n = len(names)
        want = {k: 0 for k in launches}
        want.update(sga_fwd=28 * n, lga_fwd=4 * n)
        if launches != want:
            raise AssertionError(f"[14] predict CLI launched {launches}, expected {want}")
        log(f"[14] predict CLI over {n} frame{'s' if n > 1 else ''} (GANet_deep crop {CH}x{CW} D={D} "
            f"bf16, from the checkpoint): {cli_s:.2f} s, {cli_s / n * 1e3:.1f} ms a frame with reads, "
            f"writes and the first call's warm-up; launches {launches}; at "
            f"{recorded_line(shapes, launches)}")

        model = build_model(ganet_deep(max_disp=D, compute_dtype="bfloat16"), device="cuda",
                            state_dict=load_inference_state(ckpt))
        ds = StereoDataset(data_path=root, list_path=lst, crop_height=CH, crop_width=CW,
                           kind="kitti2015", training=False, max_disp=D)
        hold_pngs(written, ds, model, (H0, W0))
        left = torch.as_tensor(ds[0]["left"][None], device="cuda")
        right = torch.as_tensor(ds[0]["right"][None], device="cuda")
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            predict(model, left, right)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        log(f"[14] GANet_deep {CH}x{CW} D={D} bf16 batch 1 forward: {min(times):.1f} ms (min of 3; "
            f"all {', '.join(f'{t:.1f}' for t in times)}); card {smi}")
        del model, left, right

        offline = evaluate.main(["--pred_path", out, "--gt_path", root, "--test_list", lst,
                                 "--kitti2015", "1", "--max_disp", str(D)])
        log(f"[14] evaluate offline over the PNGs: {json.dumps(offline)}")
        seen = Counter()
        with recording_shapes(seen):
            reset_launches()
            online = evaluate.main(data + crop)
            launches = read_launches()
        shapes.update(seen)
        log(f"[14] evaluate online over the list: {json.dumps(online)}; launches at "
            f"{recorded_line(seen, launches)}")
        for name, metrics in (("offline", offline), ("online", online)):
            if sorted(metrics) != ["d1_all", "epe", "rate_1px", "rate_2px", "rate_3px"] or not all(
                    v == v and 0 <= v < float("inf") for v in metrics.values()):
                raise AssertionError(f"[14] evaluate {name}: {metrics}")

    for batch in (4, 1):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        seen = Counter()
        with recording_shapes(seen), contextlib.redirect_stdout(buf):
            reset_launches()
            bench.main(["--batch", str(batch), "--iters", str(BENCH_ITERS)])
            launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        shapes.update(seen)
        k1, k2 = launches["sga_fwd"], launches["lga_fwd"]
        if not k1 or k1 % 28 or k2 * 7 != k1:
            raise AssertionError(f"[14] bench at batch {batch}: K1 {k1}, K2 {k2} launches")
        log(f"[14] bench --batch {batch} --iters {BENCH_ITERS}: {buf.getvalue().strip()}")
        log(f"[14] bench --batch {batch}: peak memory {peak:.2f} GiB, {k1} K1 and {k2} K2 launches at "
            f"{recorded_line(seen, launches)}; card {smi}")

    log(f"[14] K1 and K2 against their plain versions at the {len(shapes)} volume shapes above")
    hold_at_path_shapes(torch, gen, shapes, "[14]")


# Phase 15: SceneFlow's frame (the training frames), the training crop, and
# the frames of each part of the written tree.
SCENEFLOW_FRAME = (540, 960)
TRAIN_CROP = (240, 528)
TRAIN_FRAMES, VAL_FRAMES = 8, 2
# Steps a training run takes an epoch, and steps a timing takes after its
# counted step (the time is the min of the last 3).
FILE_STEPS, TIMED_STEPS = 4, 4
# Launches of one GANet_deep training step by remat policy (7 SGA blocks of
# 4 sweeps, 2 LGA calls of 2 passes): the recompute of "sga" and "full"
# runs the SGA blocks and the final head's forward again in backward.
STEP_LAUNCHES = {
    "none": {"sga_fwd": 28, "lga_fwd": 4, "sga_bwd": 28, "lga_bwd": 4},
    "sga": {"sga_fwd": 56, "lga_fwd": 8, "sga_bwd": 28, "lga_bwd": 4},
    "full": {"sga_fwd": 56, "lga_fwd": 8, "sga_bwd": 28, "lga_bwd": 4},
}
FORWARD_LAUNCHES = {"sga_fwd": 28, "lga_fwd": 4}


def write_sceneflow(root: str, split: str, n: int, frame, rng) -> tuple:
    """A SceneFlow-shaped tree of `n` frames under `root` (textured left and
    right PNGs, the right view shifted, PFM disparity of both views signed
    by view); returns (list file, its lines)."""
    import os

    import numpy as np

    from ganet_tpu_torch.data import png
    from ganet_tpu_torch.data.pfm import write_pfm

    H, W = frame
    lines = [f"frames_finalpass/{split}/A/{i:04d}/left/0006.png" for i in range(n)]
    for i, line in enumerate(lines):
        d = 6 + 4 * i
        base = rng.integers(0, 256, (H // 8 + 2, W // 8 + 2, 3)).astype(np.float32)
        left = np.kron(base, np.ones((8, 8, 1)))[:H, :W] + rng.normal(0, 6, (H, W, 3))
        left = np.clip(left, 0, 255).astype(np.uint8)
        for view, img, sign in (("left", left, 1.0), ("right", np.roll(left, -d, axis=1), -1.0)):
            path = os.path.join(root, line.replace("/left/", f"/{view}/"))
            disp = os.path.splitext(path.replace("frames_finalpass", "disparity"))[0] + ".pfm"
            for p in (path, disp):
                os.makedirs(os.path.dirname(p), exist_ok=True)
            png.write_png(path, img)
            write_pfm(disp, np.full((H, W), sign * d, np.float32))
    lst = os.path.join(root, f"{split.lower()}.list")
    with open(lst, "w") as f:
        f.write("\n".join(lines))
    return lst, lines


def train_rows(save_path: str, prefix: str) -> list:
    import os

    with open(os.path.join(save_path, "train.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["prefix"] == prefix]


def phase_train_from_files(torch, gen, smi) -> None:
    """The port trains from files on the card: a SceneFlow-shaped tree
    written here from a seed, then `python -m ganet_tpu_torch.train` in this
    process (a run with evaluation, its resume, a left_right run), predict
    from the trained checkpoint, the step time and peak memory under each
    remat policy at batch 2 and 4, and K1-K4 against their plain versions at
    the shapes these runs launched them at."""
    import math
    import os
    import tempfile
    from collections import Counter

    import numpy as np

    from ganet_tpu_torch import ganet_deep
    from ganet_tpu_torch import predict as predict_cli
    from ganet_tpu_torch import train as train_cli
    from ganet_tpu_torch.data.dataset import StereoDataset
    from ganet_tpu_torch.entry import build_model
    from ganet_tpu_torch.train import Trainer
    from ganet_tpu_torch.train.checkpoint import load_inference_state
    from ganet_tpu_torch.utils.profiling import read_launches, recording_shapes, reset_launches

    (H0, W0), (CH, CW), D = SCENEFLOW_FRAME, TRAIN_CROP, 192
    rng = np.random.default_rng(15)
    shapes = Counter()

    def counted(tag, fn, want):
        """Run `fn` with every launch recorded; the counts must be `want`."""
        seen = Counter()
        torch.cuda.synchronize()
        with recording_shapes(seen):
            reset_launches()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = read_launches()
        full = {k: want.get(k, 0) for k in launches}
        if launches != full:
            raise AssertionError(f"{tag}: launched {launches}, expected {full}")
        shapes.update(seen)
        log(f"{tag}: {secs:.2f} s; launches {launches} at {recorded_line(seen, launches)}")
        return out

    def total(steps, remat, forwards=0):
        return {k: steps * STEP_LAUNCHES[remat][k] + forwards * FORWARD_LAUNCHES.get(k, 0)
                for k in STEP_LAUNCHES[remat]}

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "sceneflow")
        t0 = time.perf_counter()
        train_list, _ = write_sceneflow(root, "TRAIN", TRAIN_FRAMES, (H0, W0), rng)
        val_list, val_lines = write_sceneflow(root, "TEST", VAL_FRAMES, (CH, CW), rng)
        log(f"[15] wrote {TRAIN_FRAMES} training frames {H0}x{W0} and {VAL_FRAMES} validation "
            f"frames {CH}x{CW} (PNG views, PFM disparity of both) in {time.perf_counter() - t0:.1f} s")
        save = os.path.join(tmp, "ckpt")
        common = ["--model", "GANet_deep", "--max_disp", str(D), "--bf16", "1", "--batchSize", "2",
                  "--crop_height", str(CH), "--crop_width", str(CW), "--data_path", root,
                  "--training_list", train_list, "--val_list", val_list, "--log_every", "1"]
        run = common + ["--steps", str(FILE_STEPS), "--lr_decay_epoch", "1", "--save_path", save]

        # Run 1: one epoch, evaluated; the default remat is "sga".
        trainer = counted("[15] run 1 (1 epoch of 4 steps, remat sga, then evaluate)",
                          lambda: train_cli.main(run + ["--nEpochs", "1", "--eval", "1"]),
                          total(FILE_STEPS, "sga", forwards=VAL_FRAMES))
        rows = train_rows(save, "epoch0")
        val = train_rows(save, "val")
        files = sorted(os.listdir(os.path.join(save, "0")))
        ok = (trainer.cfg.model.remat == "sga" and [r["step"] for r in rows] == [1, 2, 3, 4]
              and all(math.isfinite(r["loss"]) for r in rows) and len(val) == 1
              and files == ["meta.json", "model.pt", "optimizer.pt", "scheduler.pt"]
              and os.path.exists(os.path.join(save, "best_epe.json"))
              and os.listdir(os.path.join(save, "best")) == [str(FILE_STEPS)])
        log(f"[15] run 1 rows: " + "; ".join(
            f"step {r['step']} loss {r['loss']:.4f} epe {r['epe']:.3f} lr {r['lr']:g}" for r in rows)
            + f"; val epe {val[-1]['epe']:.3f} over {val[-1]['valid_px']:.0f} px; checkpoint 0/ {files},"
            f" best/ {os.listdir(os.path.join(save, 'best'))} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("[15] run 1 did not train, save and evaluate")
        del trainer
        torch.cuda.empty_cache()

        # Run 2: resumed from epoch 0's checkpoint for a second epoch; the
        # decay at epoch 1 shows the restored schedule.
        trainer = counted("[15] run 2 (--resume, epoch 1)",
                          lambda: train_cli.main(run + ["--nEpochs", "2", "--resume", save]),
                          total(FILE_STEPS, "sga"))
        rows2 = train_rows(save, "epoch1")
        ok = (trainer.start_epoch == 1 and [r["step"] for r in rows2] == [5, 6, 7, 8]
              and all(math.isfinite(r["loss"]) for r in rows2)
              and all(math.isclose(r["lr"], 1e-3) for r in rows)
              and all(math.isclose(r["lr"], 1e-4) for r in rows2)
              and os.path.exists(os.path.join(save, "1", "scheduler.pt")))
        log(f"[15] run 2: start_epoch {trainer.start_epoch}; rows " + "; ".join(
            f"step {r['step']} loss {r['loss']:.4f} lr {r['lr']:g}" for r in rows2)
            + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("[15] the resumed run did not go on from the checkpoint")
        del trainer
        torch.cuda.empty_cache()

        # Run 3: left_right, on the right view's PFM disparity.
        save_lr = os.path.join(tmp, "ckpt_left_right")
        trainer = counted("[15] run 3 (--left_right 1, 2 steps)",
                          lambda: train_cli.main(common + ["--left_right", "1", "--nEpochs", "1",
                                                           "--steps", "2", "--save_path", save_lr]),
                          total(2, "sga"))
        rows3 = train_rows(save_lr, "epoch0")
        ok = [r["step"] for r in rows3] == [1, 2] and all(math.isfinite(r["loss"]) for r in rows3)
        log(f"[15] run 3 left_right rows: " + "; ".join(
            f"step {r['step']} loss {r['loss']:.4f} epe {r['epe']:.3f}" for r in rows3)
            + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("[15] the left_right run gave no finite loss")
        del trainer
        torch.cuda.empty_cache()

        # Predict from the trained checkpoint (epoch 1's), one validation frame.
        one = os.path.join(root, "one.list")
        with open(one, "w") as f:
            f.write(val_lines[0])
        written = counted(
            "[15] predict CLI from the trained checkpoint, 1 frame",
            lambda: predict_cli.main(["--resume", save, "--data_path", root, "--test_list", one,
                                      "--crop_height", str(CH), "--crop_width", str(CW),
                                      "--max_disp", str(D), "--model", "GANet_deep", "--bf16", "1",
                                      "--save_path", os.path.join(tmp, "result")]),
            FORWARD_LAUNCHES)
        model = build_model(ganet_deep(max_disp=D, compute_dtype="bfloat16"), device="cuda",
                            state_dict=load_inference_state(save))
        ds = StereoDataset(data_path=root, list_path=one, crop_height=CH, crop_width=CW,
                           kind="sceneflow", training=False, max_disp=D)
        hold_pngs(written, ds, model, (CH, CW))
        del model

        # Step time and peak memory under each remat policy at batch 2 and 4,
        # on batches read from the files; the first step is counted.
        for batch in (2, 4):
            for remat in ("none", "sga", "full"):
                torch.cuda.empty_cache()
                args = train_cli.parse_args(common + ["--remat", remat, "--batchSize", str(batch),
                                                      "--save_path", os.path.join(tmp, f"t_{remat}_{batch}")])
                trainer = Trainer(train_cli.build_config(args))
                it = iter(trainer.train_iter)
                batches = [next(it) for _ in range(2)]
                it.close()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                step = lambda i: trainer.train_step(trainer.state, batches[i % 2])  # noqa: E731
                counted(f"[15] one step, remat {remat}, batch {batch}", lambda: step(0),
                        STEP_LAUNCHES[remat])
                times, losses = [], []
                for i in range(1, TIMED_STEPS + 1):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    m = step(i)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                    losses.append(m["loss"].item())
                peak = torch.cuda.max_memory_allocated() / 2**30
                if not all(map(math.isfinite, losses)):
                    raise AssertionError(f"[15] remat {remat} batch {batch}: losses {losses}")
                log(f"[15] GANet_deep {CH}x{CW} D={D} bf16 from files, remat {remat}, batch {batch}: "
                    f"step time {min(times[-3:]):.1f} ms (min of the last 3; all "
                    f"{', '.join(f'{t:.1f}' for t in times)}), peak memory {peak:.2f} GiB; card {smi}")
                trainer.close()
                del trainer, batches, step
    torch.cuda.empty_cache()

    log(f"[15] K1-K4 against their plain versions at the {len(shapes)} volume shapes above")
    hold_at_path_shapes(torch, gen, shapes, "[15]")


# Phase 16: data-parallel training on DP_RANKS ranks that share the card over
# gloo.  (a) parity: one f32 step (TF32 off, remat none) of the 2 ranks at
# global batch 2 against one step of the same model, init and batch in this
# process.  Tolerances: the loss within DP_LOSS_RTOL (the forward is
# deterministic; cuDNN may pick other algorithms for a rank's batch of 1
# than for the batch of 2, which moves the loss by float32 rounding); the
# BatchNorm running statistics within DP_STATS_TOL norm-relative; the
# global gradients (the ranks' sum) against this process's within phase 8's
# GRAD_TOL_ALL / GRAD_TOL_PARAM, which hold cuDNN's nondeterministic
# backward; the update of the parameters: Adam's first update moves each
# element by lr times the sign of its gradient, so the two updates differ by
# 2 lr where an element's gradient lies within the noise of 0 and moves the
# other way; of the elements that this process's update moved by more than
# lr / 2, at most DP_FLIP_SHARE may have moved the other way (or not at all)
# on the ranks, where a wrong gradient turns about half and a skipped
# update all; and the parameters the same bits on both ranks.  (b) the train CLI with --mesh_data 2 from phase 15's files.
# (c) each rank's launches a step, step time, gradient all-reduce time and
# peak memory (ranks sharing one card: not a multi-GPU time).
DP_RANKS = 2
DP_MAX_DISP = 192
DP_LOSS_RTOL = 1e-5
DP_STATS_TOL = 1e-4
DP_FLIP_SHARE = 0.02
DP_TIMED_STEPS = 4


def phase_data_parallel(torch, gen, smi, device: str = "cuda") -> None:
    """Data-parallel training: parity of 2 ranks with one device, the train
    CLI with --mesh_data 2 from files, per-rank figures, and K1-K4 held at
    every shape the ranks launched.  `device` "cpu" rehearses the phase's
    control flow on the plain versions (no times, no kernels to hold)."""
    import math
    import os
    import tempfile
    from collections import Counter

    import numpy as np

    from ganet_tpu_torch import train as train_cli
    from ganet_tpu_torch.parallel.launch import launch
    from ganet_tpu_torch.parallel import dp_cases as K
    from ganet_tpu_torch.utils.profiling import read_launches, recording_shapes, reset_launches

    (CH, CW), D = TRAIN_CROP, DP_MAX_DISP
    cuda = device == "cuda"
    deep = dict(kind="step", model="GANet_deep", size=(CH, CW), max_disp=D, batch=DP_RANKS, steps=1)
    cases = [dict(deep, name="parity", remat="none", dtype="float32"),
             dict(deep, name="timed", remat="sga", dtype="bfloat16", reps=DP_TIMED_STEPS)]
    shapes = Counter()
    if cuda:
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        launch(K.run_cases, DP_RANKS, (cases, out_dir, device), backend="gloo", device=device)
        log(f"[16] {DP_RANKS} ranks on one card (gloo): GANet_deep {CH}x{CW} D={D} global batch "
            f"{DP_RANKS}, the parity step and the timed steps in {time.perf_counter() - t0:.1f} s")
        results = {c["name"]: K.load(c, out_dir, DP_RANKS) for c in cases}

    # (c) launches a step on every rank, against phase 15's counts.
    for case in cases:
        want = STEP_LAUNCHES[case["remat"]]
        for rank, res in enumerate(results[case["name"]]):
            for launched in res["launches"]:
                if launched != {k: want.get(k, 0) for k in launched}:
                    raise AssertionError(f"[16] {case['name']} rank {rank}: launched {launched} a step, "
                                         f"expected {want}")
            shapes.update(res["shapes"])
        log(f"  [16] {case['name']} (remat {case['remat']}, {case['dtype']}): launches a step on each "
            f"of the {DP_RANKS} ranks {want} ok")

    # (a) parity against one step in this process on the global batch.
    ranks = results["parity"]
    digests = {r["digest"] for r in ranks}
    ref = K.reference(cases[0], device)
    got = ranks[0]
    loss_rel = abs(got["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    stats = [k for k in ref["state"] if "running" in k]
    stats_rel = max(norm_rel(torch, got["state"][k], ref["state"][k]) for k in stats)
    flat = lambda g: torch.cat([g[n].flatten().double() for n in sorted(g)])  # noqa: E731
    grad_all = norm_rel(torch, flat(got["grads"]), flat(ref["grads"]))
    grad_worst = max((norm_rel(torch, got["grads"][n], ref["grads"][n]), n) for n in ref["grads"])
    lr = K.train_config(cases[0]).optim.lr
    params = sorted(ref["grads"])
    step_diff = max((got["state"][n] - ref["state"][n]).abs().max().item() for n in params)
    moved = flipped = 0
    for n in params:
        mine, theirs = ref["state"][n] - ref["init"][n], got["state"][n] - ref["init"][n]
        sel = mine.abs() > lr / 2
        moved += int(sel.sum())
        flipped += int((sel & (mine * theirs <= 0)).sum())
    total = sum(ref["state"][n].numel() for n in params)
    flip_share = flipped / max(moved, 1)
    ok = (len(digests) == 1 and loss_rel <= DP_LOSS_RTOL and stats_rel <= DP_STATS_TOL
          and grad_all <= GRAD_TOL_ALL and grad_worst[0] <= GRAD_TOL_PARAM
          and moved > 0 and flip_share <= DP_FLIP_SHARE and math.isfinite(got["losses"][0]))
    log(f"[16] (a) parity, GANet_deep {CH}x{CW} D={D} f32 (TF32 off) remat none, {DP_RANKS} ranks x "
        f"batch 1 vs one process x batch {DP_RANKS}: loss {got['losses'][0]:.6f} vs "
        f"{ref['losses'][0]:.6f} (rel {loss_rel:.2e}, tol {DP_LOSS_RTOL}); running statistics worst "
        f"{stats_rel:.2e} (tol {DP_STATS_TOL}); global gradients all {grad_all:.2e} (tol "
        f"{GRAD_TOL_ALL}), worst {grad_worst[0]:.2e} {grad_worst[1]} (tol {GRAD_TOL_PARAM}); "
        f"update (lr {lr:g}): {moved} of {total} elements moved by more than lr/2 here, of them "
        f"{flipped} ({flip_share:.3%}, tol {DP_FLIP_SHARE:.0%}) the other way or not at all on the "
        f"ranks; parameters after the update max |diff| {step_diff:.2e}; "
        f"state digests of the ranks {'equal' if len(digests) == 1 else 'DIFFER'} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[16] the data-parallel step disagrees with the one-device step")
    del ref, ranks, got

    # (c) per-rank figures of the timed case (bf16, remat sga, batch 1 a rank).
    for rank, res in enumerate(results["timed"]):
        if not all(map(math.isfinite, res["losses"])):
            raise AssertionError(f"[16] timed rank {rank}: losses {res['losses']}")
        if not cuda:
            continue
        log(f"[16] (c) rank {rank}, GANet_deep {CH}x{CW} D={D} bf16 remat sga, batch 1 of global "
            f"{DP_RANKS}: step {min(res['step_ms']):.1f} ms (min of {len(res['step_ms'])}; all "
            f"{', '.join(f'{t:.1f}' for t in res['step_ms'])}); gradient all-reduce of "
            f"{res['grad_mib']:.1f} MiB f32 through the host {min(res['allreduce_ms']):.1f} ms (all "
            f"{', '.join(f'{t:.1f}' for t in res['allreduce_ms'])}); peak memory "
            f"{res['peak_gib']:.2f} GiB; {DP_RANKS} ranks share one card: not a multi-GPU time; card {smi}")
    if len({r["digest"] for r in results["timed"]}) != 1:
        raise AssertionError("[16] the timed ranks' parameters differ")
    del results

    # (b) the train CLI, --mesh_data 2, from phase 15's SceneFlow-shaped files.
    rng = np.random.default_rng(16)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "sceneflow")
        train_list, _ = write_sceneflow(root, "TRAIN", TRAIN_FRAMES, SCENEFLOW_FRAME, rng)
        val_list, _ = write_sceneflow(root, "TEST", VAL_FRAMES, (CH, CW), rng)
        save = os.path.join(tmp, "ckpt")
        common = ["--model", "GANet_deep", "--max_disp", str(D), "--bf16", "1", "--batchSize", "2",
                  "--crop_height", str(CH), "--crop_width", str(CW), "--data_path", root,
                  "--training_list", train_list, "--val_list", val_list, "--log_every", "1",
                  "--save_path", save] + ([] if cuda else ["--device", "cpu"])
        # This process is rank 0: its launches are rank 0's, 4 steps and one
        # evaluation forward (the 2 validation frames, one a rank).
        seen = Counter()
        want = {k: FILE_STEPS * v + FORWARD_LAUNCHES.get(k, 0) for k, v in STEP_LAUNCHES["sga"].items()}
        with recording_shapes(seen):
            reset_launches()
            t0 = time.perf_counter()
            trainer = train_cli.main(common + ["--mesh_data", str(DP_RANKS), "--nEpochs", "1",
                                               "--steps", str(FILE_STEPS), "--eval", "1"])
            if cuda:
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = read_launches()
        shapes.update(seen)
        full = {k: want.get(k, 0) for k in launches}
        rows, val = train_rows(save, "epoch0"), train_rows(save, "val")
        files = sorted(os.listdir(save))
        ok = (launches == full and trainer.cfg.model.remat == "sga" and trainer.data_size == DP_RANKS
              and [r["step"] for r in rows] == list(range(1, FILE_STEPS + 1))
              and all(math.isfinite(r["loss"]) for r in rows) and len(val) == 1
              and files == ["0", "best", "best_epe.json", "train.jsonl"]
              and sorted(os.listdir(os.path.join(save, "0"))) == [
                  "meta.json", "model.pt", "optimizer.pt", "scheduler.pt"]
              and os.listdir(os.path.join(save, "best")) == [str(FILE_STEPS)])
        log(f"[16] (b) train CLI --mesh_data {DP_RANKS} (bf16, remat sga, batch 2, 1 epoch of "
            f"{FILE_STEPS} steps, then evaluate): {secs:.2f} s; rank 0 launched {launches} (expected "
            f"{full}) at {recorded_line(seen, launches)}")
        log("  [16] (b) rows: " + "; ".join(
            f"step {r['step']} loss {r['loss']:.4f} epe {r['epe']:.3f}" for r in rows)
            + f"; val epe {val[-1]['epe']:.3f} over {val[-1]['valid_px']:.0f} px (both frames); "
            f"{len(rows) + len(val)} rows in train.jsonl (one run's); save_path {files}, 0/ and best/ "
            f"once {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("[16] the data-parallel CLI run did not train, log and save once")
        del trainer

        # The 2-rank checkpoint resumes on one device.
        trainer = train_cli.main(common + ["--nEpochs", "2", "--steps", "1"])
        rows = train_rows(save, "epoch1")
        ok = (trainer.start_epoch == 1 and trainer.mesh is None and [r["step"] for r in rows] == [5]
              and math.isfinite(rows[0]["loss"]))
        log(f"[16] (b) resumed on one device: start_epoch {trainer.start_epoch}, step "
            f"{rows[0]['step']} loss {rows[0]['loss']:.4f} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("[16] the 2-rank checkpoint did not resume on one device")
        del trainer
    if cuda:
        torch.cuda.empty_cache()
        log(f"[16] K1-K4 against their plain versions at the {len(shapes)} volume shapes the "
            "ranks launched")
        hold_at_path_shapes(torch, gen, shapes, "[16]")


# Phase 17: the H-sharded eval forward of GANet_deep on SP_RANKS ranks that
# share the card, and the predict CLI on meshes.
SP_RANKS = 4
SP_FRAME = (576, 960)
SP_MAX_DISP = 192
SP_F32_TOL = 2e-2  # px at the worst pixel: the model-level gate of phase 4 (PERF.md §2)
SP_BF16_FACTOR = 1.5  # the rule of tests/test_torch_bf16.py
SP_TIMED = 1  # timed forwards after the counted one (ranks time-slicing the card)
SP_CLI_FRAME, SP_CLI_CROP, SP_CLI_FRAMES = (375, 1242), (384, 1248), 2
# The CLI's PNGs on a mesh against the one-device CLI's: (a)'s float32 gate
# plus the writer's truncation to 1/256 px.  The two forwards differ by
# float32 noise (cuDNN picks its algorithms by shape, and a rank's blocks
# have other shapes than the whole), which random weights amplify to
# about 7e-3 px at the worst pixel (a frame's PNG read 2/256 against 1/256).
SP_PNG_TOL = SP_F32_TOL + 1.0 / 256
# ... and a frame's pixels more than 1/256 px apart may be at most this
# share of it (0-2 of 465,750 read on the card), so that a fault in a few
# rows of the CLI's join still fails.
SP_PNG_PAST_SHARE = 1e-4


def sharded_forward_launches(cfg, W: int) -> dict:
    """K1, K5 and K2 launches of one rank's sharded eval forward at image
    width W: 2 K1 (the W sweeps) a SGA block, 2 waves of K5 a block over
    each chunk of its width (`chunk_layout`), and lga_repeats K2 for each
    of the head's 2 LGA calls."""
    from ganet_tpu_torch.parallel.sharded_sga import chunk_layout

    chunks = lambda w: len(chunk_layout(w)[1])  # noqa: E731
    return {"sga_fwd": 2 * (cfg.num_sga_full + cfg.num_sga_half),
            "sga_fwd_seeded": 2 * (cfg.num_sga_full * chunks(W // 3) + cfg.num_sga_half * chunks(W // 6)),
            "lga_fwd": 2 * cfg.lga_repeats}


def sharded_forward_checks(torch, smi, tag: str, mesh: tuple, seed: int, want: dict,
                           device: str, channel_tp: bool = False) -> "Counter":
    """(a)-(d) of a sharded eval forward of GANet_deep at SP_FRAME, batch 1,
    on the ranks of `mesh` (data, space, disp), which share the card over
    gloo, against one device in this process (the same seeded init 0):
    (a) the f32 disparity (TF32 off) within SP_F32_TOL px, (b) bf16 within
    SP_BF16_FACTOR times one device's bf16 error, (c) each rank's launches
    (`want`), every rank holding the same whole disparity, and every 3D
    convolution's input depth at most a rank's block of bins and a halo of
    2, or with `channel_tp` every 3D convolution the one device's with a
    1/disp block of its output channels (a head's C -> 1 conv: of its
    input channels) at every bin, (d) each rank's bf16 forward time and
    peak memory.  Returns the shapes the ranks launched K1, K5 and K2 at."""
    from collections import Counter
    import tempfile

    from ganet_tpu_torch import ganet_deep
    from ganet_tpu_torch.entry import build_model, predict
    from ganet_tpu_torch.parallel import spatial_cases as K
    from ganet_tpu_torch.parallel.launch import launch

    cuda = device == "cuda"
    (H, W), D = SP_FRAME, SP_MAX_DISP
    ranks = mesh[0] * mesh[1] * mesh[2]
    label = ", ".join(f"{a} {n}" for a, n in zip(("data", "space", "disp"), mesh) if n > 1)
    label += " (channel TP)" if channel_tp else ""
    model = dict(kind="model", model="GANet_deep", mesh=mesh, batch=1, size=(H, W), max_disp=D,
                 seed=seed, channel_tp=channel_tp)
    cases = [dict(model, name="f32", dtype="float32"),
             dict(model, name="bf16", dtype="bfloat16", reps=SP_TIMED)]
    shapes = Counter()
    if cuda:
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        launch(K.run_cases, ranks, (cases, out_dir, device), backend="gloo", device=device)
        log(f"{tag} {ranks} ranks on one card (gloo): GANet_deep {H}x{W} D={D} batch 1 over {label}, "
            f"f32 and bf16 forwards, in {time.perf_counter() - t0:.1f} s")
        results = {c["name"]: K.load(c, out_dir, ranks) for c in cases}

    # (c) launches of each rank's forward, and its convolutions' depths.
    depth_bound = ganet_deep(max_disp=D).disp_channels // mesh[2] + 2
    for case in cases:
        res_ranks = results[case["name"]]
        for rank, res in enumerate(res_ranks):
            full = {k: want.get(k, 0) for k in res["launches"]}
            if cuda and res["launches"] != full:  # the plain versions count nothing
                raise AssertionError(f"{tag} {case['name']} rank {rank}: launched {res['launches']}, "
                                     f"expected {full}")
            if not channel_tp and (not res["depths"] or max(res["depths"]) > depth_bound):
                raise AssertionError(f"{tag} {case['name']} rank {rank}: 3D convolutions at depths "
                                     f"{sorted(set(res['depths']))}, bound {depth_bound}")
            shapes.update(res["shapes"])
        if not all(torch.equal(r["out"], res_ranks[0]["out"]) for r in res_ranks):
            raise AssertionError(f"{tag} {case['name']}: the ranks returned other disparities")
        if not channel_tp:
            log(f"  {tag} (c) {case['name']}: launches of each rank's forward {want} (K3, K4, K6, K7 "
                f"none); every rank holds the same whole disparity; the {len(res_ranks[0]['depths'])} 3D "
                f"convolutions of a rank at depths {sorted(set(res_ranks[0]['depths']))} (at most "
                f"{depth_bound}) ok")

    # (a), (b) against one device in this process, the same weights (seeded
    # init 0); the f32 run records its 3D convolutions' depths and widths.
    left, right = K.model_inputs(cases[0])
    ref = {}
    depths, widths = [], []
    for dt in ("float32", "bfloat16"):
        one = build_model(ganet_deep(max_disp=D, compute_dtype=dt), device, seed=0)
        with (K._Depths(depths, widths) if dt == "float32" else contextlib.nullcontext()):
            ref[dt] = predict(one, left, right).float().cpu()
        if cuda and dt == "bfloat16":
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                predict(one, left, right)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            log(f"{tag} one device, this process, GANet_deep {H}x{W} D={D} bf16 batch 1: "
                f"{min(times):.1f} ms (min of 3; all {', '.join(f'{t:.1f}' for t in times)})")
        del one
    if channel_tp:
        # (c) each rank's convolutions: the one device's, a block of channels each.
        P = mesh[2]
        blocked = [(win // P, 1) if wout == 1 else (win, wout // P) for win, wout in widths]
        for case in cases:
            for rank, res in enumerate(results[case["name"]]):
                if res["depths"] != depths or res["widths"] != blocked:
                    raise AssertionError(
                        f"{tag} {case['name']} rank {rank}: 3D convolutions (in, out) channels "
                        f"{sorted(set(res['widths']))} at depths {sorted(set(res['depths']))}, expected "
                        f"{sorted(set(blocked))} at {sorted(set(depths))}")
            log(f"  {tag} (c) {case['name']}: launches of each rank's forward {want} (K3, K4, K6, K7 "
                f"none); every rank holds the same whole disparity; each of the {len(depths)} 3D "
                f"convolutions of a rank is one device's with 1/{P} of its output channels (heads: of "
                f"its input channels), (in, out) {sorted(set(blocked))}, at every bin "
                f"({sorted(set(depths))}) ok")
    f32, bf16 = results["f32"][0]["out"], results["bf16"][0]["out"].float()
    diff = (f32 - ref["float32"]).abs()
    ok = bool(torch.isfinite(f32).all()) and tuple(f32.shape) == (1, H, W) and diff.max().item() <= SP_F32_TOL
    log(f"{tag} (a) f32 (TF32 off): max |sharded - one device| {diff.max().item():.3e} px (tol "
        f"{SP_F32_TOL:.0e}), mean {diff.mean().item():.3e} px, {int((diff > 0).sum())} of {diff.numel()} "
        f"pixels differ; range [{f32.min().item():.2f}, {f32.max().item():.2f}] {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag} the sharded f32 forward disagrees with one device")
    err_sh = (bf16 - ref["float32"]).abs().mean().item()
    err_one = (ref["bfloat16"] - ref["float32"]).abs().mean().item()
    ok = bool(torch.isfinite(bf16).all()) and err_sh <= SP_BF16_FACTOR * err_one
    log(f"{tag} (b) bf16: mean |sharded bf16 - one-device f32| {err_sh:.4f} px, mean |one-device bf16 - "
        f"one-device f32| {err_one:.4f} px, factor {err_sh / max(err_one, 1e-30):.3f} (tol "
        f"{SP_BF16_FACTOR}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag} the sharded bf16 forward is further from f32 than one device's")
    del ref, f32, bf16, diff

    # (d) each rank's bf16 forward time and peak memory.
    if cuda:
        for rank, res in enumerate(results["bf16"]):
            log(f"{tag} (d) rank {rank}, GANet_deep {H}x{W} D={D} bf16 batch 1 over {label}: "
                f"forward {min(res['times']):.1f} ms (host clock after a barrier to a synchronize, min "
                f"of {len(res['times'])}; all {', '.join(f'{t:.1f}' for t in res['times'])}); peak "
                f"memory {res['peak_gib']:.2f} GiB; {ranks} ranks time-slicing one card over gloo: "
                f"not a multi-GPU time; card {smi}")
        log(f"{tag} (d) ranks' peak memory {[round(r['peak_gib'], 2) for r in results['f32']]} GiB in f32")
    return shapes


def phase_spatial(torch, gen, smi, entries, device: str = "cuda") -> None:
    """H-sharded inference: GANet_deep at SP_FRAME on SP_RANKS ranks over
    `space` against one device in this process, float32 and bfloat16, the
    ranks' launches, times and peak memory (`sharded_forward_checks`); the
    predict CLI with --space 2 and --space 2 --data 2 against the
    one-device CLI; then K1, K5 and K2 held at every shape the ranks
    launched them at.  `device` "cpu" rehearses the phase's control flow
    on the plain versions (no times, no kernels to hold)."""
    import os
    import tempfile
    from collections import Counter

    import numpy as np

    from ganet_tpu_torch import ganet_deep
    from ganet_tpu_torch import predict as predict_cli
    from ganet_tpu_torch.data import png
    from ganet_tpu_torch.entry import build_model
    from ganet_tpu_torch.train.checkpoint import save_checkpoint
    from ganet_tpu_torch.utils.profiling import read_launches, recording_shapes, reset_launches

    cuda = device == "cuda"
    D = SP_MAX_DISP
    want = sharded_forward_launches(ganet_deep(max_disp=D), SP_FRAME[1])
    shapes = sharded_forward_checks(torch, smi, "[17]", (1, SP_RANKS, 1), 17, want, device)
    for e in entries:
        if e["name"] in want:
            log(f"  [17] {e['name']}: {want[e['name']]} launches a rank, "
                f"{SP_RANKS * want[e['name']]} over the {SP_RANKS} ranks")
        if e["name"] == "sga_fwd_seeded":  # the model path's launches, as phase 12 sums them
            e["launches"] = SP_RANKS * want["sga_fwd_seeded"]

    # (e) the predict CLI on meshes against the one-device CLI, float32.
    (H0, W0), (CH, CW), n = SP_CLI_FRAME, SP_CLI_CROP, SP_CLI_FRAMES
    rng = np.random.default_rng(17)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "kitti")
        lst, _ = write_kitti(root, [f"{i:06d}_10.png" for i in range(n)], (H0, W0), rng)
        ckpt = os.path.join(tmp, "ckpt")
        save_checkpoint(ckpt, 0, build_model(ganet_deep(max_disp=D), device="cpu", seed=0))
        common = ["--kitti2015", "1", "--data_path", root, "--test_list", lst, "--crop_height",
                  str(CH), "--crop_width", str(CW), "--max_disp", str(D), "--model", "GANet_deep",
                  "--resume", ckpt] + ([] if cuda else ["--device", "cpu"])
        # (flags, rank 0's launches: a frame's forward times the batches)
        frame = sharded_forward_launches(ganet_deep(max_disp=D), CW)
        runs = {"one device": ([], {"sga_fwd": 28 * n, "lga_fwd": 4 * n}),
                "--space 2": (["--space", "2"], {k: v * n for k, v in frame.items()}),
                "--space 2 --data 2 --batch 2": (["--space", "2", "--data", "2", "--batch", "2"],
                                                 {k: v * -(-n // 2) for k, v in frame.items()})}
        pngs = {}
        for label, (flags, expected) in runs.items():
            out = os.path.join(tmp, f"out{len(pngs)}")
            seen = Counter()
            with recording_shapes(seen):
                reset_launches()
                t0 = time.perf_counter()
                written = predict_cli.main(common + flags + ["--save_path", out])
                secs = time.perf_counter() - t0
                launches = read_launches()
            shapes.update(seen)
            pngs[label] = {os.path.basename(p): png.read_disparity_png(p) for p in written}
            log(f"[17] (e) predict CLI {label} (f32, {n} frames of {H0}x{W0} at crop {CH}x{CW}): "
                f"{secs:.2f} s with the ranks' start; rank 0 launched {launches}")
            full = {k: expected.get(k, 0) for k in launches}
            if cuda and launches != full:
                raise AssertionError(f"[17] (e) {label}: rank 0 launched {launches}, expected {full}")
            if sorted(pngs[label]) != sorted(pngs["one device"]):
                raise AssertionError(f"[17] (e) {label} wrote {sorted(pngs[label])}")
            for name, img in pngs[label].items() if flags else ():
                ref_img = pngs["one device"][name]
                d = np.abs(img - ref_img) if img.shape == ref_img.shape == (H0, W0) else np.array([np.inf])
                past = int((d > 1.0 / 256).sum())
                ok = float(d.max()) <= SP_PNG_TOL and past <= SP_PNG_PAST_SHARE * d.size
                log(f"  [17] (e) {label} {name}: max |png - one-device png| {float(d.max()):.5f} px (tol "
                    f"{SP_PNG_TOL:.5f}: (a)'s gate plus 1/256); {int((d > 0).sum())} pixels differ, "
                    f"{past} by more than 1/256 (tol {SP_PNG_PAST_SHARE * d.size:.1f}, "
                    f"{SP_PNG_PAST_SHARE:.2%} of the frame) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"[17] (e) {label}: {name} is not the one-device CLI's")

    # (f) K1, K5 and K2 at every shape the ranks and the CLIs launched them at.
    if cuda:
        torch.cuda.empty_cache()
        log(f"[17] (f) K1, K5 and K2 against their plain versions at the {len(shapes)} shapes launched")
        hold_at_path_shapes(torch, gen, shapes, "[17]")



# Phase 18: H-sharded training of GANet_deep on ST_RANKS ranks over `space`
# that share the card, the train CLI with --mesh_space and the dryrun.
ST_RANKS = 2
ST_MAX_DISP = 192
ST_TIMED = 1  # timed steps after the 2 counted ones (ranks time-slicing the card: plumbing times)
ST_CLI_STEPS = 2


def sharded_step_launches(cfg, W: int, remat: str) -> dict:
    """Launches of one rank's sharded training step at image width W: the
    forward's (`sharded_forward_launches`), again for the SGA blocks and
    the final head under remat "sga" or "full" (their recompute), and the
    backward's: 2 K3 a SGA block (the W sweeps), one K6 for each K5 of the
    forward, and one K4 for each K2 of the forward."""
    fwd = sharded_forward_launches(cfg, W)
    times = 2 if remat in ("sga", "full") else 1
    return {"sga_fwd": times * fwd["sga_fwd"], "sga_fwd_seeded": times * fwd["sga_fwd_seeded"],
            "lga_fwd": times * fwd["lga_fwd"], "sga_bwd": fwd["sga_fwd"],
            "sga_bwd_seeded": fwd["sga_fwd_seeded"], "lga_bwd": fwd["lga_fwd"]}


def ranks_agree(torch, ranks, params) -> tuple:
    """(whether the ranks' parameters are the same bits, the worst
    norm-relative gap of their running statistics).  The gradients are
    summed over the mesh, so every rank takes the same update; but each
    rank of a `space` line runs the 2D part on its own, and on the card
    cuDNN's default algorithms do not repeat bit for bit, so that part's
    running statistics are each rank's, equal up to float noise."""
    first = ranks[0]["state"]
    same = all(torch.equal(r["state"][n], first[n]) for r in ranks[1:] for n in params)
    stats = [k for k in first if "running" in k]
    gap = max((norm_rel(torch, r["state"][k], first[k]) for r in ranks[1:] for k in stats), default=0.0)
    return same, gap


def sharded_step_checks(torch, gen, smi, tag: str, mesh: tuple, seed: int, want: dict,
                        dryrun_n, device: str, shapes=None, channel_tp: bool = False) -> None:
    """Sharded training of GANet_deep at TRAIN_CROP, max_disp ST_MAX_DISP,
    global batch 2, remat sga, on the ranks of `mesh` (data, space, disp),
    with `channel_tp` the `disp` ranks splitting channels, which share the
    card over gloo: (a) parity of one f32 step with one device on the same
    batch, (b) each rank's launches a step (`want`), step time and peak
    memory, (c) the train CLI on the mesh from files and the predict CLI on
    one device from its checkpoint, (d) the dryrun on `dryrun_n` ranks
    (none for None); then K1-K6 held at every shape the ranks launched,
    and at the `shapes` (a Counter) given."""
    import math
    import os
    import tempfile
    from collections import Counter

    import numpy as np

    from ganet_tpu_torch import ganet_deep
    from ganet_tpu_torch import predict as predict_cli
    from ganet_tpu_torch import train as train_cli
    from ganet_tpu_torch.parallel import dp_cases as K
    from ganet_tpu_torch.parallel.launch import launch
    from ganet_tpu_torch.train.checkpoint import load_inference_state
    from ganet_tpu_torch.utils.profiling import read_launches, recording_shapes, reset_launches

    (CH, CW), D = TRAIN_CROP, ST_MAX_DISP
    cuda = device == "cuda"
    n_ranks = mesh[0] * mesh[1] * mesh[2]
    axes = [(a, n) for a, n in zip(("data", "space", "disp"), mesh) if n > 1]
    label = ", ".join(f"{a} {n}" for a, n in axes) + (" (channel TP)" if channel_tp else "")
    cli_flags = [w for a, n in axes for w in (f"--mesh_{a}", str(n))]
    cli_flags += ["--channel_tp", "1"] if channel_tp else []
    deep = dict(kind="step", model="GANet_deep", size=(CH, CW), max_disp=D, batch=2, remat="sga",
                mesh=mesh, channel_tp=channel_tp)
    cases = [dict(deep, name="parity", dtype="float32", steps=1, seed=seed),
             dict(deep, name="timed", dtype="bfloat16", steps=2, reps=ST_TIMED, seed=seed)]
    shapes = Counter() if shapes is None else shapes
    if cuda:
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        launch(K.run_cases, n_ranks, (cases, out_dir, device), backend="gloo", device=device)
        log(f"{tag} {n_ranks} ranks over {label} on one card (gloo): GANet_deep {CH}x{CW} D={D} "
            f"global batch 2, remat sga, the f32 parity step and the bf16 steps in "
            f"{time.perf_counter() - t0:.1f} s")
        results = {c["name"]: K.load(c, out_dir, n_ranks) for c in cases}

    # (b) launches a step on every rank.
    for case in cases:
        for rank, res in enumerate(results[case["name"]]):
            for launched in res["launches"]:
                full = {k: want.get(k, 0) for k in launched}
                if cuda and launched != full:  # the plain versions count nothing
                    raise AssertionError(f"{tag} {case['name']} rank {rank}: launched {launched} a "
                                         f"step, expected {full}")
            shapes.update(res["shapes"])
        log(f"  {tag} (b) {case['name']} ({case['dtype']}): launches a step on each of the {n_ranks} "
            f"ranks {want} (K7 none) ok")

    # (a) parity against one step in this process on the same batch, run twice.
    ranks = results["parity"]
    refs = [K.reference(cases[0], device) for _ in range(2)]
    params = sorted(refs[0]["grads"])
    flat = lambda g: torch.cat([g[n].flatten().double() for n in sorted(g)])  # noqa: E731
    stats = [k for k in refs[0]["state"] if "running" in k]

    def gaps(got, ref):
        """(loss rel, stats worst, grads all, (grads worst, name), flipped share, moved, flipped)"""
        lr = K.train_config(cases[0]).optim.lr
        moved = flipped = 0
        for n in params:
            mine, theirs = ref["state"][n] - ref["init"][n], got["state"][n] - ref["init"][n]
            sel = mine.abs() > lr / 2
            moved += int(sel.sum())
            flipped += int((sel & (mine * theirs <= 0)).sum())
        return (abs(got["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0]),
                max(norm_rel(torch, got["state"][k], ref["state"][k]) for k in stats),
                norm_rel(torch, flat(got["grads"]), flat(ref["grads"])),
                max((norm_rel(torch, got["grads"][n], ref["grads"][n]), n) for n in params),
                flipped / max(moved, 1), moved, flipped)

    def line(g) -> str:
        return (f"loss rel {g[0]:.2e}, running statistics worst {g[1]:.2e}, gradients all "
                f"{g[2]:.2e}, worst {g[3][0]:.2e} {g[3][1]}, update: {g[6]} of {g[5]} moved "
                f"elements ({g[4]:.3%}) the other way or not at all")

    self_noise = gaps(refs[1], refs[0])
    log(f"{tag} (a) one device's f32 step twice (its own noise): {line(self_noise)}")
    got = ranks[0]
    g = gaps(got, refs[0])
    same, buffers = ranks_agree(torch, ranks, params)
    # The aggregation's parameters and buffers (its running statistics are
    # summed or gathered over the mesh) are the same bits on every rank.
    agg = [k for k in got["state"] if k.startswith("cost_agg.")]
    same = same and all(torch.equal(r["state"][k], got["state"][k]) for r in ranks[1:] for k in agg)
    ok = (same and buffers <= DP_STATS_TOL and g[0] <= DP_LOSS_RTOL and g[1] <= DP_STATS_TOL and g[2] <= GRAD_TOL_ALL
          and g[3][0] <= GRAD_TOL_PARAM and g[5] > 0 and g[4] <= DP_FLIP_SHARE
          and math.isfinite(got["losses"][0]))
    log(f"{tag} (a) parity, GANet_deep {CH}x{CW} D={D} f32 (TF32 off) remat sga, {n_ranks} ranks "
        f"over {label} vs one process, batch 2: loss {got['losses'][0]:.6f} vs "
        f"{refs[0]['losses'][0]:.6f}; {line(g)}; gates: loss {DP_LOSS_RTOL}, statistics "
        f"{DP_STATS_TOL}, gradients {GRAD_TOL_ALL} / {GRAD_TOL_PARAM}, update {DP_FLIP_SHARE:.0%}; "
        f"the ranks' parameters and aggregation buffers {'the same bits' if same else 'DIFFER'}, "
        f"their running statistics {buffers:.2e} apart (each rank's own 2D part) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag} the sharded step disagrees with the one-device step")
    del refs, ranks, got

    # (b) per-rank figures of the timed case (bf16, remat sga).
    for rank, res in enumerate(results["timed"]):
        if not all(map(math.isfinite, res["losses"])):
            raise AssertionError(f"{tag} timed rank {rank}: losses {res['losses']}")
        if not cuda:
            continue
        log(f"{tag} (b) rank {rank}, GANet_deep {CH}x{CW} D={D} bf16 remat sga, global batch 2 over "
            f"{label}: step {min(res['step_ms']):.1f} ms (host clock after a barrier to a "
            f"synchronize, min of the last {len(res['step_ms'])} of {2 + len(res['step_ms'])}; all "
            f"{', '.join(f'{t:.1f}' for t in res['step_ms'])}); gradient all-reduce "
            f"{min(res['allreduce_ms']):.1f} ms; peak memory {res['peak_gib']:.2f} GiB; "
            f"{n_ranks} ranks time-slicing one card over gloo: not a multi-GPU time; card {smi}")
    if not ranks_agree(torch, results["timed"], params)[0]:
        raise AssertionError(f"{tag} the timed ranks' parameters differ")
    del results

    # (c) the train CLI on the mesh from phase 15's SceneFlow-shaped files,
    # and the predict CLI on one device from its checkpoint.
    rng = np.random.default_rng(seed)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "sceneflow")
        train_list, _ = write_sceneflow(root, "TRAIN", TRAIN_FRAMES, SCENEFLOW_FRAME, rng)
        val_list, val_lines = write_sceneflow(root, "TEST", 1, (CH, CW), rng)
        save = os.path.join(tmp, "ckpt")
        dev = [] if cuda else ["--device", "cpu"]
        seen = Counter()
        with recording_shapes(seen):
            reset_launches()
            t0 = time.perf_counter()
            trainer = train_cli.main(
                ["--model", "GANet_deep", "--max_disp", str(D), "--bf16", "1", "--batchSize", "2",
                 "--crop_height", str(CH), "--crop_width", str(CW), "--data_path", root,
                 "--training_list", train_list, "--val_list", val_list, "--log_every", "1",
                 "--save_path", save, "--nEpochs", "1", "--steps", str(ST_CLI_STEPS)]
                + cli_flags + dev)
            if cuda:
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = read_launches()
        shapes.update(seen)
        full = {k: ST_CLI_STEPS * want.get(k, 0) for k in launches}
        rows = train_rows(save, "epoch0")
        final = {k: v.detach().cpu() for k, v in trainer.state.model.state_dict().items()}
        weights = load_inference_state(save)
        ok = ((launches == full or not cuda) and trainer.cfg.model.remat == "sga"
              and trainer.cfg.model.channel_tp == channel_tp
              and (trainer.mesh.cfg.data, trainer.mesh.cfg.space, trainer.mesh.cfg.disp) == mesh
              and [r["step"] for r in rows] == list(range(1, ST_CLI_STEPS + 1))
              and all(math.isfinite(r["loss"]) for r in rows)
              and sorted(os.listdir(save)) == ["0", "train.jsonl"]
              and sorted(weights) == sorted(final)
              and all(torch.equal(weights[k].cpu(), v) for k, v in final.items()))
        log(f"{tag} (c) train CLI {' '.join(cli_flags)} (bf16, remat sga, batch 2, {ST_CLI_STEPS} "
            f"steps from {TRAIN_FRAMES} SceneFlow-shaped frames): {secs:.2f} s with the ranks' start; "
            f"rank 0 launched {launches} (expected {full}); rows "
            + "; ".join(f"step {r['step']} loss {r['loss']:.4f}" for r in rows)
            + f"; the checkpoint is rank 0's state bit for bit {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag} the {' '.join(cli_flags)} CLI run did not train, log and save once")
        del trainer, final, weights
        one = os.path.join(root, "one.list")
        with open(one, "w") as f:
            f.write(val_lines[0])
        written = predict_cli.main(["--resume", save, "--data_path", root, "--test_list", one,
                                    "--crop_height", str(CH), "--crop_width", str(CW), "--max_disp",
                                    str(D), "--model", "GANet_deep", "--bf16", "1", "--save_path",
                                    os.path.join(tmp, "result")] + dev)
        ok = len(written) == 1 and os.path.getsize(written[0]) > 0
        log(f"{tag} (c) predict CLI on one device from the {' '.join(cli_flags)} checkpoint: wrote "
            f"{[os.path.basename(p) for p in written]} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag} the predict CLI did not read the {' '.join(cli_flags)} checkpoint")

    # (d) the dryrun, python -m ganet_tpu_torch.dryrun n.
    from ganet_tpu_torch.dryrun import dryrun_mesh

    if dryrun_n is None:
        if cuda:
            torch.cuda.empty_cache()
            log(f"{tag} K1-K6 against their plain versions at the {len(shapes)} shapes the ranks launched")
            hold_at_path_shapes(torch, gen, shapes, tag)
        return
    dm = dryrun_mesh(dryrun_n)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "ganet_tpu_torch.dryrun", str(dryrun_n)] + dev,
                         capture_output=True, text=True, timeout=600,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = out.stdout.strip().splitlines()
    ok = out.returncode == 0 and bool(lines) and lines[-1].startswith(
        f"dryrun_multichip ok: mesh={{'data': {dm.data}, 'space': {dm.space}, 'disp': {dm.disp}}} ")
    log(f"{tag} (d) python -m ganet_tpu_torch.dryrun {dryrun_n}: {lines[-1] if lines else '(no output)'} "
        f"({time.perf_counter() - t0:.1f} s with its start) {'ok' if ok else 'FAIL'}")
    if not ok:
        print(out.stderr[-4000:], file=sys.stderr)
        raise AssertionError(f"{tag} the dryrun failed")

    if cuda:
        torch.cuda.empty_cache()
        log(f"{tag} K1-K6 against their plain versions at the {len(shapes)} shapes the ranks launched")
        hold_at_path_shapes(torch, gen, shapes, tag)


def phase_spatial_train(torch, gen, smi, entries, device: str = "cuda") -> None:
    """H-sharded training on ST_RANKS ranks over `space`
    (`sharded_step_checks`): (a) parity with one device on the same batch,
    (b) each rank's launches, step time and peak memory, (c) the train CLI
    with --mesh_space from files and the predict CLI on one device from
    its checkpoint, (d) the dryrun on 4 ranks; then K1-K6 held at every
    shape the ranks launched.  `device` "cpu" rehearses the phase's control
    flow on the plain versions (no times, no kernels to hold)."""
    from ganet_tpu_torch import ganet_deep

    want = sharded_step_launches(ganet_deep(max_disp=ST_MAX_DISP), TRAIN_CROP[1], "sga")
    for e in entries:
        if e["name"] == "sga_bwd_seeded":  # K6's model path: a step's launches over the ranks
            e["launches"] = ST_RANKS * want["sga_bwd_seeded"]
    sharded_step_checks(torch, gen, smi, "[18]", (1, ST_RANKS, 1), 18, want, 4, device)


# Phase 19: disparity-sharded inference and training of GANet_deep on
# DS_RANKS ranks over `disp` that share the card, the train CLI with
# --mesh_disp and the dryrun of 8 ranks over (2, 2, 2).
DS_RANKS = 2


def phase_disp(torch, gen, smi, device: str = "cuda") -> None:
    """Disparity-sharded inference and training on DS_RANKS ranks over
    `disp`: GANet_deep's eval forward at SP_FRAME against one device
    (`sharded_forward_checks`: f32, bf16, each rank's launches, which are
    one device's, since every rank of a `disp` line sweeps and refines the
    whole D, and its 3D convolutions' depths, times and peak memory); then
    its training (`sharded_step_checks`: one f32 step against one device,
    the ranks' parameters the same bits, each rank's launches a step, step
    time, all-reduce time and peak memory, the train CLI with --mesh_disp
    from files and the predict CLI on one device from its checkpoint, the
    dryrun on 8 ranks over (2, 2, 2)); K1-K6 held at every shape the ranks
    launched them at.  `device` "cpu" rehearses the phase's control flow on
    the plain versions (no times, no kernels to hold)."""
    mesh = (1, 1, DS_RANKS)
    shapes = sharded_forward_checks(torch, smi, "[19]", mesh, 19, FORWARD_LAUNCHES, device)
    sharded_step_checks(torch, gen, smi, "[19]", mesh, 19, STEP_LAUNCHES["sga"], 8, device, shapes)


# Phase 20: channel tensor parallelism of GANet_deep on CT_RANKS ranks over
# `disp` that share the card, and the train CLI with --channel_tp 1.
CT_RANKS = 2


def phase_channel_tp(torch, gen, smi, device: str = "cuda") -> None:
    """Channel tensor parallelism on CT_RANKS ranks over `disp`: GANet_deep's
    eval forward at SP_FRAME against one device (`sharded_forward_checks`
    with `channel_tp`: f32, bf16, each rank's launches, one device's, since
    every rank sweeps its block of channels over every bin and runs the
    heads whole, and its 3D convolutions' channels, times and peak memory);
    then its training (`sharded_step_checks` with `channel_tp`: one f32
    step against one device, the ranks' parameters and aggregation buffers
    the same bits, each rank's launches a step, step time, all-reduce time
    and peak memory, the train CLI with --mesh_disp --channel_tp 1 from
    files and the predict CLI on one device from its checkpoint); K1-K4
    held at every shape the ranks launched them at.  `device` "cpu"
    rehearses the phase's control flow on the plain versions (no times,
    no kernels to hold)."""
    mesh = (1, 1, CT_RANKS)
    shapes = sharded_forward_checks(torch, smi, "[20]", mesh, 20, FORWARD_LAUNCHES, device,
                                    channel_tp=True)
    sharded_step_checks(torch, gen, smi, "[20]", mesh, 20, STEP_LAUNCHES["sga"], None, device, shapes,
                        channel_tp=True)



# Phase 21: the native decoder and feeding the step.  NATIVE_SAMPLES
# SceneFlow-shaped pairs (SCENEFLOW_FRAME, uint8 noise, PNG rows Sub, Up,
# Average and Paeth in turn: `bench_input.generate_dataset`), of which the
# first NATIVE_PARITY are held native against Python as training crops and
# padded to NATIVE_PAD, beside one KITTI-shaped frame padded to KITTI_CROP;
# the first 2 x NATIVE_STEPS feed NATIVE_STEPS training steps (one epoch at
# batch 2), once decoded natively and once in Python.
NATIVE_SAMPLES = 16
NATIVE_PARITY = 4
NATIVE_PAD = (576, 960)
NATIVE_STEPS = 6
NATIVE_BATCH = 2
NATIVE_MODEL, NATIVE_MAX_DISP = "GANet_deep", 192


def toolchain() -> tuple:
    """(g++ --version's first line or None, {header: whether g++ finds it}
    for png.h and zlib.h, libpng's shared library as `ctypes.util` finds
    it or None)."""
    import ctypes.util
    import shutil

    gxx = shutil.which("g++")
    found = {}
    version = None
    if gxx is not None:
        version = subprocess.run([gxx, "--version"], capture_output=True, text=True).stdout
        version = version.splitlines()[0] if version else gxx
        for header in ("png.h", "zlib.h"):
            found[header] = subprocess.run([gxx, "-E", "-x", "c++", "-"],
                                           input=f"#include <{header}>\n",
                                           capture_output=True, text=True).returncode == 0
    lib = ctypes.util.find_library("png16") or ctypes.util.find_library("png")
    return version, found, lib


def native_parity(tag: str, make, n: int, native: bool, reps: int = 2) -> None:
    """Samples of `make(use_native)` native against Python, bit for bit,
    `reps` times over its `n` samples (the crops drawn alike), and the
    mean time a sample of each; without the library, Python's alone."""
    import numpy as np

    paths = (True, False) if native else (False,)
    ds = {u: make(u) for u in paths}
    secs = {u: [] for u in paths}
    for i in list(range(n)) * reps:
        got = {}
        for u in paths:
            t0 = time.perf_counter()
            got[u] = ds[u][i]
            secs[u].append(time.perf_counter() - t0)
        if not native:
            continue
        a, b = got[True], got[False]
        same = sorted(a) == sorted(b) and all(
            a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in b)
        if not same:
            diff = {k: float(np.abs(a[k] - b[k]).max()) for k in b if a[k].shape == b[k].shape}
            raise AssertionError(f"{tag}: sample {i} native != Python ({diff})")
    mean = {u: sum(v) / len(v) for u, v in secs.items()}
    what = f"{n} sample{'s' if n > 1 else ''} x {reps}"
    if native:
        log(f"{tag}: {what} native == Python bit for bit; a sample native "
            f"{mean[True] * 1e3:.1f} ms, Python {mean[False] * 1e3:.1f} ms "
            f"({mean[False] / mean[True]:.1f}x)")
    else:
        log(f"{tag}: {what} in Python (no native library): {mean[False] * 1e3:.1f} ms a sample")


def write_kitti_mixed(root: str, frame, rng) -> str:
    """One KITTI-2015-shaped frame under `root` (RGB views and 16-bit ground
    truth, PNG rows Sub, Up, Average and Paeth in turn); returns its list."""
    import os

    import numpy as np

    from ganet_tpu_torch.bench_input import ROW_FILTERS
    from ganet_tpu_torch.data import png

    H, W = frame
    name = "000000_10.png"
    for sub in ("image_2", "image_3", "disp_occ_0"):
        os.makedirs(os.path.join(root, sub))
        if sub == "disp_occ_0":
            gt = rng.random((H, W)) * 90 * (rng.random((H, W)) < 0.4)
            img = (gt * 256).astype(np.uint16)
        else:
            img = rng.integers(0, 256, (H, W, 3), np.uint8)
        png.write_png(os.path.join(root, sub, name), img, row_filters=ROW_FILTERS)
    lst = root + ".list"
    with open(lst, "w") as f:
        f.write(name + "\n")
    return lst


def phase_native_io(torch, smi, device: str = "cuda") -> None:
    """The native decoder on the card's host: (a) its toolchain and the
    library's build; (b) native against Python bit for bit on SceneFlow-
    and KITTI-shaped files with mixed row filters, and the time a sample of
    each; (c) `python -m ganet_tpu_torch.bench_input` in process, its JSON
    line; (d) NATIVE_STEPS training steps fed from files by `Trainer` and
    its `BatchIterator` (prefetch 2), native then Python: per step the time
    blocked on the batch and the step between synchronises, pairs/s from
    files over the last 3, the launches of each step (phase 15's under
    remat sga) and the native reads counted.  `device` "cpu" rehearses the
    phase's control flow (no launches to count) at sizes set in the
    module's constants."""
    import contextlib
    import io
    import os
    import tempfile

    import numpy as np

    from ganet_tpu_torch import bench_input
    from ganet_tpu_torch import train as train_cli
    from ganet_tpu_torch.data import native_io
    from ganet_tpu_torch.data.dataset import StereoDataset
    from ganet_tpu_torch.train import Trainer
    from ganet_tpu_torch.utils.profiling import read_launches, reset_launches

    frame, crop, pad, model, max_disp = (SCENEFLOW_FRAME, TRAIN_CROP, NATIVE_PAD, NATIVE_MODEL,
                                         NATIVE_MAX_DISP)
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    # (a) the toolchain, and the library.
    gxx, headers, libpng = toolchain()
    pngh = headers.get("png.h", False)
    native = native_io.native_available()
    built = native_io.build_seconds()
    log(f"[21] host: {os.cpu_count()} CPUs ({len(os.sched_getaffinity(0))} usable); g++: {gxx}; "
        + ", ".join(f"{h} {'found' if ok else 'not found'}" for h, ok in headers.items())
        + f"; libpng's shared library {libpng or 'not found'}; library "
        + (f"{native_io.library_path().name}, " + (f"built in this process in {built:.2f} s"
           if built is not None else "found built") if native
           else f"unavailable: {native_io.why_unavailable()}"))
    if gxx and pngh and not native:
        raise AssertionError(f"[21] g++ and libpng are here, yet the library did not build or "
                             f"load: {native_io.why_unavailable()}")
    if not native:
        log("[21] no toolchain: the Python readers alone are timed")

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "sceneflow")
        t0 = time.perf_counter()
        full = bench_input.generate_dataset(root, NATIVE_SAMPLES, *frame)
        log(f"[21] wrote {NATIVE_SAMPLES} SceneFlow-shaped pairs {frame[0]}x{frame[1]} (noise, "
            f"rows Sub/Up/Average/Paeth) in {time.perf_counter() - t0:.1f} s")
        with open(full) as f:
            lines = f.read().split()

        def sublist(name, n):
            path = os.path.join(root, name)
            with open(path, "w") as f:
                f.write("\n".join(lines[:n]) + "\n")
            return path

        # (b) native against Python, bit for bit.
        parity = sublist("parity.list", NATIVE_PARITY)
        for training, (ch, cw), what in ((True, crop, "training crops"), (False, pad, "padded")):
            native_parity(
                f"[21] SceneFlow {frame[0]}x{frame[1]}, {what} {ch}x{cw}",
                lambda u: StereoDataset(data_path=root, list_path=parity, crop_height=ch,
                                        crop_width=cw, kind="sceneflow", training=training,
                                        max_disp=max_disp, seed=21, use_native=u),
                NATIVE_PARITY, native)
        (kf, kp), kroot = (KITTI_FRAME, KITTI_CROP), os.path.join(tmp, "kitti")
        klist = write_kitti_mixed(kroot, kf, np.random.default_rng(21))
        native_parity(
            f"[21] KITTI {kf[0]}x{kf[1]} RGB + 16-bit disparity, padded {kp[0]}x{kp[1]}",
            lambda u: StereoDataset(data_path=kroot, list_path=klist, crop_height=kp[0],
                                    crop_width=kp[1], kind="kitti2015", training=False,
                                    max_disp=max_disp, use_native=u),
            1, native)

        # (c) the bench, in process, on these files.
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            bench = bench_input.main(["--samples", str(NATIVE_SAMPLES), "--batch", str(NATIVE_BATCH),
                                      "--crop_height", str(crop[0]), "--crop_width", str(crop[1]),
                                      "--keep", root])
        log(f"[21] python -m ganet_tpu_torch.bench_input --samples {NATIVE_SAMPLES} --batch "
            f"{NATIVE_BATCH} ({time.perf_counter() - t0:.1f} s):")
        log(out.getvalue().strip().splitlines()[-1])

        # (d) feeding the step.
        train_list = sublist("steps.list", NATIVE_BATCH * NATIVE_STEPS)
        args = train_cli.parse_args([
            "--model", model, "--max_disp", str(max_disp), "--bf16", "1" if cuda else "0",
            "--batchSize", str(NATIVE_BATCH), "--crop_height", str(crop[0]),
            "--crop_width", str(crop[1]), "--data_path", root, "--training_list", train_list,
            "--val_list", train_list, "--save_path", os.path.join(tmp, "ckpt"),
            "--device", device])
        trainer = Trainer(train_cli.build_config(args), device=device)
        want = STEP_LAUNCHES[trainer.cfg.model.remat]
        if trainer.cfg.data.num_prefetch != 2 or trainer.cfg.model.remat != "sga":
            raise AssertionError(f"[21] prefetch {trainer.cfg.data.num_prefetch}, remat "
                                 f"{trainer.cfg.model.remat}: expected 2 and sga")
        calls = []
        decode = native_io.decode_sample

        def counted(*a, **k):
            calls.append(a[0])
            return decode(*a, **k)

        native_io.decode_sample = counted
        runs = {}
        try:
            for use_native in ((True, False) if native else (False,)):
                trainer.train_ds.use_native = use_native
                calls.clear()
                rows = []
                it = iter(trainer.train_iter)
                try:
                    for i in range(NATIVE_STEPS):
                        t0 = time.perf_counter()
                        batch = next(it)
                        blocked = time.perf_counter() - t0
                        batch = {k: batch[k] for k in trainer.train_keys}
                        sync()
                        reset_launches()
                        t0 = time.perf_counter()
                        m = trainer.train_step(trainer.state, batch)
                        sync()
                        step = time.perf_counter() - t0
                        launches = read_launches()
                        loss = m["loss"].item()
                        if cuda and launches != {k: want.get(k, 0) for k in launches}:
                            raise AssertionError(f"[21] step {i + 1}: launched {launches}, expected {want}")
                        if not np.isfinite(loss):
                            raise AssertionError(f"[21] step {i + 1}: loss {loss}")
                        rows.append((blocked, step))
                finally:
                    it.close()
                reads = len(calls)
                want_reads = NATIVE_BATCH * NATIVE_STEPS if use_native else 0
                last = rows[-3:]
                pairs = NATIVE_BATCH * len(last) / sum(b + t for b, t in last)
                runs[use_native] = (rows, pairs)
                log(f"[21] {'native' if use_native else 'Python'} decode, {model} "
                    f"{crop[0]}x{crop[1]} D={max_disp} batch {NATIVE_BATCH} remat sga, prefetch 2: "
                    + "; ".join(f"step {i + 1} blocked {b * 1e3:.1f} ms + step {t * 1e3:.1f} ms = "
                                f"{(b + t) * 1e3:.1f}" for i, (b, t) in enumerate(rows))
                    + f"; over the last 3: {pairs:.3f} pairs/s from files; native reads {reads} "
                    f"(expected {want_reads}); launches a step {want if cuda else 'not counted (CPU)'}; "
                    f"card {smi}")
                if reads != want_reads:
                    raise AssertionError(f"[21] {reads} native reads, expected {want_reads}")
        finally:
            native_io.decode_sample = decode
            trainer.close()
        step_rate = NATIVE_BATCH / min(t for _, t in runs[list(runs)[0]][0][-3:])
        log(f"[21] the step alone {step_rate:.3f} pairs/s (min of the last 3); bench_input's "
            f"value {bench['value']} pairs/s is {bench['value'] / step_rate:.2f}x it"
            + (f"; from files: native {runs[True][1]:.3f}, Python {runs[False][1]:.3f} pairs/s"
               if native else ""))
        del trainer
    if cuda:
        torch.cuda.empty_cache()


# Phase 22: the training benchmarks at GANet_deep's training crop.  From
# phase 15's peaks (remat none 13.09 GiB at batch 2 and 25.96 at 4; sga
# 15.78 at 4), batch 8 needs about 52 GiB under none and batch 16 about
# 103, above the card's 80 GB, so the probe under none should end in its
# out-of-memory row at 16; under sga, 8 and 16 need about 31 and 63 GiB.
TB_MODEL, TB_MAX_DISP = "GANet_deep", 192
TB_NONE_BATCHES, TB_SGA_BATCHES, TB_PROFILE_BATCH = (4, 8, 16), (8, 16), 4
TB_STEPS = 4
TB_MESHES = ("1,1,1", "2,1,1")
TB_SCALING_STEPS = 4  # bench_scaling's timed steps a mesh, after one warm-up step


def bench_rows(tag: str, rows: list, cuda: bool) -> None:
    """Log `bench_train`'s rows.  A measured row must have a finite loss and
    on the card a positive peak; a failure row must be the last and say
    that the batch does not fit the card's memory."""
    import math

    for i, r in enumerate(rows):
        if "reason" in r:
            log(f"{tag} batch {r['batch']} remat {r['remat']}: {r['reason']}; {r['error_head'][:200]}")
            if i != len(rows) - 1 or not r["reason"].startswith("HBM-infeasible"):
                raise AssertionError(f"{tag} batch {r['batch']}: a failure other than the probe's end "
                                     f"at the card's memory: {r}")
            continue
        mem = r["runtime_memory"]
        peak = mem.get("peak_bytes_in_use", 0)
        log(f"{tag} batch {r['batch']} remat {r['remat']}: {r['ms_per_step']} ms a step (median of "
            f"{TB_STEPS}), {r['pairs_per_s']} pairs/s, peak {peak / 2**30:.2f} GiB of "
            f"{mem.get('bytes_limit', 0) / 2**30:.2f}, loss {r['loss']}, init {r['init_s']} s, "
            f"first step {r['compile_s']} s")
        if not math.isfinite(r["loss"]) or (cuda and peak <= 0):
            raise AssertionError(f"{tag} batch {r['batch']}: loss {r['loss']}, peak {peak}")


def phase_train_bench(torch, smi, device: str = "cuda") -> None:
    """The training benchmarks (`python -m ganet_tpu_torch.bench_train`,
    `.profile_train`, `.bench_scaling`): (a) bench_train's probe under
    remat none in a subprocess (an out-of-memory error cannot fragment this
    process's allocator), its rows and the launches a step on its `#`
    lines; (b) bench_train under sga in process, its launches counted; (c)
    profile_train's split under none, sga and full and the recompute tax;
    (d) one profiler window (`utils.profiling.trace`) of a step under sga
    and one under none, by phase 9's kernel groups, and their difference;
    (e) bench_scaling on one card at the training crop, GANet_deep f32.
    `device` "cpu" rehearses the phase's control flow (no launches or
    memory to check) at sizes set in the module's constants."""
    import ast
    import io
    import math
    import os
    import re
    import tempfile

    from ganet_tpu_torch import bench_scaling, bench_train, profile_train
    from ganet_tpu_torch.config import DataConfig, TrainConfig, model_config
    from ganet_tpu_torch.train import create_train_state, make_train_step
    from ganet_tpu_torch.utils.profiling import reset_launches, synchronize, trace

    cuda = device == "cuda"
    (H, W), D, B = TRAIN_CROP, TB_MAX_DISP, TB_PROFILE_BATCH
    model = ["--model", TB_MODEL, "--max_disp", str(D), "--height", str(H), "--width", str(W)]
    dev = [] if cuda else ["--device", "cpu"]
    if cuda:
        torch.cuda.empty_cache()
        log(f"[22] allocated when the phase starts: {torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    def in_process(main, argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            result = main(argv)
        return result, [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]

    # (a) the probe under remat none, in a subprocess.
    argv = model + ["--remat", "none", "--batches", ",".join(map(str, TB_NONE_BATCHES)),
                    "--steps", str(TB_STEPS)] + dev
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "ganet_tpu_torch.bench_train"] + argv,
                         capture_output=True, text=True, timeout=900,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    log(f"[22] (a) python -m ganet_tpu_torch.bench_train {' '.join(argv)}: exit {out.returncode} "
        f"({time.perf_counter() - t0:.1f} s with its start)")
    for line in out.stderr.splitlines():
        if line.startswith("#"):
            log(f"[22] (a) {line}")
    if out.returncode != 0:
        print(out.stderr[-4000:], file=sys.stderr)
        raise AssertionError("[22] (a) bench_train failed")
    none_rows = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    bench_rows("[22] (a)", none_rows, cuda)
    measured = [r["batch"] for r in none_rows if "reason" not in r]
    if not measured or measured != list(TB_NONE_BATCHES[:len(measured)]):
        raise AssertionError(f"[22] (a) rows for batches {[r['batch'] for r in none_rows]}")
    launches = [ast.literal_eval(m) for m in re.findall(r"launches a step: (\{.*\})", out.stderr)]
    want = {k: STEP_LAUNCHES["none"].get(k, 0) for k in (launches or [{}])[0]}
    if len(launches) < len(measured) or (cuda and any(n != want for n in launches)):
        raise AssertionError(f"[22] (a) launches a step {launches}, expected {want} at each of "
                             f"batches {measured}")

    # (b) remat sga at the batches that none cannot hold, in process.
    reset_launches()
    t0 = time.perf_counter()
    sga_rows, _ = in_process(bench_train.main, model + [
        "--remat", "sga", "--batches", ",".join(map(str, TB_SGA_BATCHES)), "--steps", str(TB_STEPS)] + dev)
    log(f"[22] (b) bench_train --remat sga --batches {','.join(map(str, TB_SGA_BATCHES))} in process "
        f"({time.perf_counter() - t0:.1f} s)")
    bench_rows("[22] (b)", sga_rows, cuda)
    if [r["batch"] for r in sga_rows if "reason" not in r] != list(TB_SGA_BATCHES):
        raise AssertionError(f"[22] (b) remat sga did not run every batch: {sga_rows}")
    if cuda:
        expect_launches(torch, f"[22] (b) {len(sga_rows)} batches x {1 + TB_STEPS} steps under remat sga",
                        {k: n * len(sga_rows) * (1 + TB_STEPS) for k, n in STEP_LAUNCHES["sga"].items()})
    by_batch = {r["batch"]: r for r in none_rows if "reason" not in r}
    for r in sga_rows:
        if r["batch"] in by_batch:
            n = by_batch[r["batch"]]
            log(f"[22] (b) batch {r['batch']}: sga {r['ms_per_step']} ms against none {n['ms_per_step']} "
                f"(+{r['ms_per_step'] - n['ms_per_step']:.1f}), peak "
                f"{r['runtime_memory'].get('peak_bytes_in_use', 0) / 2**30:.2f} against "
                f"{n['runtime_memory'].get('peak_bytes_in_use', 0) / 2**30:.2f} GiB")

    # (c) the split of a step by remat policy.
    calls = profile_train.WARMUP + profile_train.CHAIN
    split = {}
    for remat in ("none", "sga", "full"):
        reset_launches()
        t0 = time.perf_counter()
        row, _ = in_process(profile_train.main, model + ["--batch", str(B), "--remat", remat] + dev)
        log(f"[22] (c) profile_train --batch {B} --remat {remat} ({time.perf_counter() - t0:.1f} s): "
            + json.dumps(row))
        if cuda:
            expect_launches(
                torch, f"[22] (c) remat {remat}: {calls} forwards, forward-backwards and steps each",
                {k: calls * (FORWARD_LAUNCHES.get(k, 0) + 2 * n) for k, n in STEP_LAUNCHES[remat].items()})
        figures = [row[k] for k in ("fwd_train_ms", "fwd_bwd_ms", "full_step_ms")]
        if not all(math.isfinite(v) and v > 0 for v in figures):
            raise AssertionError(f"[22] (c) remat {remat}: {row}")
        split[remat] = row
    for remat in ("sga", "full"):
        tax = split[remat]["bwd_attrib_ms"] - split["none"]["bwd_attrib_ms"]
        log(f"[22] (c) recompute tax of remat {remat} at batch {B}: bwd_attrib_ms "
            f"{split[remat]['bwd_attrib_ms']} - {split['none']['bwd_attrib_ms']} = {tax:.1f} ms; "
            f"full step {split[remat]['full_step_ms']} against {split['none']['full_step_ms']} ms")

    # (d) where the recompute's device time goes: one window a policy.
    windows = {}
    with tempfile.TemporaryDirectory() as tmp:
        for remat in ("sga", "none"):
            cfg = TrainConfig(
                model=model_config(TB_MODEL, max_disp=D, compute_dtype="bfloat16", remat=remat),
                data=DataConfig(crop_height=H, crop_width=W, kind="synthetic"), batch_size=B)
            state = create_train_state(cfg, device)
            step = make_train_step(cfg)
            batch = bench_train.random_batch(B, H, W, D, torch.device(device))
            step(state, batch)  # warm-up
            with trace(os.path.join(tmp, remat)) as prof:
                synchronize(device)
                t0 = time.perf_counter()
                step(state, batch)
                synchronize(device)
                wall_ms = (time.perf_counter() - t0) * 1e3
            del state, batch
            if cuda:
                torch.cuda.empty_cache()
            (path,) = os.listdir(os.path.join(tmp, remat))
            kernels, groups, total = device_groups(torch, prof)
            size = os.path.getsize(os.path.join(tmp, remat, path)) / 2**20
            tag = f"[22] (d) one batch-{B} step under remat {remat}"
            if total == 0:
                log(f"{tag}: the profiler saw no device time ({wall_ms:.1f} ms wall; trace {size:.1f} MiB)")
                continue
            windows[remat] = groups
            log(f"{tag} (profiler on, Chrome trace {size:.1f} MiB): device time {total:.1f} ms in "
                f"{wall_ms:.1f} ms wall, device idle {100 * (1 - total / wall_ms):.1f}%; "
                + "; ".join(f"{g} {ms:.1f} ms" for g, ms in groups.items()))
            for ms, count, key in sorted(kernels, reverse=True)[:8]:
                log(f"  {ms:8.2f} ms  x{count:<4d} {key[:110]}")
    if len(windows) == 2:
        log(f"[22] (d) sga - none, device ms by group (the recompute, and what it saves): "
            + "; ".join(f"{g} {windows['sga'][g] - windows['none'][g]:+.1f}" for g in windows["sga"]))

    # (e) the scaling sweep on this host's cards, at the training crop, with
    # PyTorch's default float32 numerics (TF32 in cuDNN), as
    # `python -m ganet_tpu_torch.bench_scaling` runs; the ranks take them.
    t0 = time.perf_counter()
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        rows, lines = in_process(bench_scaling.main, [
            "--meshes", *TB_MESHES, "--model", TB_MODEL, "--crop_height", str(H), "--crop_width",
            str(W), "--max_disp", str(D), "--steps", str(TB_SCALING_STEPS), "--warmup", "1"] + dev)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    for line in lines:
        log(f"[22] (e) {json.dumps(line)}")
    cards = torch.cuda.device_count() if cuda else 0
    log(f"[22] (e) bench_scaling --meshes {' '.join(TB_MESHES)} --model {TB_MODEL} {H}x{W} D={D} f32, "
        f"{TB_SCALING_STEPS} steps after 1 ({time.perf_counter() - t0:.1f} s, {cards} card(s))")
    if len(rows) != len(TB_MESHES):
        raise AssertionError(f"[22] (e) {len(rows)} rows for {len(TB_MESHES)} meshes")
    for r in rows:
        timed = r["devices"] <= cards
        if (not math.isfinite(r["loss"]) or r["plumbing_only"] == timed
                or (timed and not r["pairs_per_s"] > 0)):
            raise AssertionError(f"[22] (e) mesh {r['mesh']} on {cards} card(s): {r}")
    log(f"[22] card {smi}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU", file=sys.stderr)
        return 1
    try:
        import ganet_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})", file=sys.stderr)
        return 1

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", default="",
                        help="comma-separated phase numbers to run (default: all; "
                        "a partial run prints no result line)")
    args = parser.parse_args()
    only = {int(p) for p in args.phases.split(",") if p}
    want = lambda n: not only or n in only  # noqa: E731

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    smi = phase_card(torch)
    entries = []
    if want(2):
        log("[2] K1 SGA sweep kernel vs plain version")
        entries.append(phase_sga(torch, gen))
        phase_sga_rungs(torch, gen)
    if want(3):
        log("[3] K2 LGA kernel vs plain version")
        entries.append(phase_lga(torch, gen, smi))
    if want(4):
        phase_model_parity(torch, gen)
    if want(5):
        phase_main_path(torch, gen, smi, entries)
    if want(6):
        log("[6] K3 SGA gradient-sweep kernel vs plain version")
        entries.append(phase_sga_bwd(torch, gen))
        phase_sga_bwd_rungs(torch, gen)
    if want(7):
        log("[7] K4 LGA backward kernel vs plain version")
        entries.append(phase_lga_bwd(torch, gen))
    if want(8):
        phase_grad_parity(torch)
    if want(9):
        phase_train_path(torch, smi, entries)
    if want(10):
        log(f"[10] K5 seeded SGA sweep kernel vs plain version ({time.perf_counter() - t0:.1f} s)")
        entries.append(phase_seeded_fwd(torch, gen, smi))
    if want(11):
        log(f"[11] K6 seeded SGA gradient-sweep kernel vs plain version ({time.perf_counter() - t0:.1f} s)")
        entries.append(phase_seeded_bwd(torch, gen, smi))
    if want(12):
        log(f"[12] sharded SGA wavefront and halo LGA on {SHARDS} ranks sharing the card "
            f"({time.perf_counter() - t0:.1f} s)")
        phase_sharded(torch, smi, entries)
    if want(13):
        log(f"[13] K7 channel-wise LGA kernel and the lga3d path ({time.perf_counter() - t0:.1f} s)")
        entries.append(phase_lga3d(torch, gen, smi))
    if want(14):
        log(f"[14] the from-files path: predict, evaluate and bench ({time.perf_counter() - t0:.1f} s)")
        phase_from_files(torch, gen, smi)
    if want(15):
        log(f"[15] training from files: train, resume, left_right, predict, remat "
            f"({time.perf_counter() - t0:.1f} s)")
        phase_train_from_files(torch, gen, smi)
    if want(16):
        log(f"[16] data-parallel training on {DP_RANKS} ranks sharing the card "
            f"({time.perf_counter() - t0:.1f} s)")
        phase_data_parallel(torch, gen, smi)
    if want(17):
        log(f"[17] H-sharded inference on {SP_RANKS} ranks sharing the card, and the predict CLI "
            f"on meshes ({time.perf_counter() - t0:.1f} s)")
        phase_spatial(torch, gen, smi, entries)
    if want(18):
        log(f"[18] H-sharded training on {ST_RANKS} ranks sharing the card, the train CLI with "
            f"--mesh_space and the dryrun ({time.perf_counter() - t0:.1f} s)")
        phase_spatial_train(torch, gen, smi, entries)
    if want(19):
        log(f"[19] disparity-sharded inference and training on {DS_RANKS} ranks sharing the card, the "
            f"train CLI with --mesh_disp and the dryrun of 8 ({time.perf_counter() - t0:.1f} s)")
        phase_disp(torch, gen, smi)
    if want(20):
        log(f"[20] channel tensor parallelism on {CT_RANKS} ranks sharing the card and the train CLI "
            f"with --channel_tp 1 ({time.perf_counter() - t0:.1f} s)")
        phase_channel_tp(torch, gen, smi)
    if want(21):
        log(f"[21] the native decoder and feeding the step ({time.perf_counter() - t0:.1f} s)")
        phase_native_io(torch, smi)
    if want(22):
        log(f"[22] the training benchmarks: bench_train, profile_train, bench_scaling "
            f"({time.perf_counter() - t0:.1f} s)")
        t22 = time.perf_counter()
        phase_train_bench(torch, smi)
        log(f"[22] {time.perf_counter() - t22:.1f} s")
    log(f"total {time.perf_counter() - t0:.1f} s")
    if only:
        return 0
    print(json.dumps({"kernels": entries}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
