#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ganet_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an H100 (sm_90a) and the
CUDA toolkit.  Phases, each printing its lines:

  1. the card (nvidia-smi name and power limit), and the build of every
     CUDA kernel from `ganet_tpu_torch/csrc/`, one nvcc per source at once;
  2. the SGA sweep kernel (K1) against its plain PyTorch version at the
     eval path's shapes, per direction and fused, in float32 and bfloat16;
  3. the LGA kernel (K2) likewise, radius 2, repeats 1 and 2;
  4. the whole model at 240x528, D=192, float32 with TF32 off, once through
     the kernels and once through the plain versions, from one seeded init;
  5. the eval path: GANet_deep at 576x960, D=192, batch 1, bfloat16, seeded
     random weights, through `build_model` and `predict`; launch counts of
     each kernel in that run, its latency and peak memory;
  6. the SGA gradient-sweep kernel (K3) against its plain version at the
     training path's shapes, per direction, float32 and bfloat16;
  7. the LGA backward kernel (K4) likewise at the training path's head;
  8. gradients of the whole model in train mode at 240x528, D=192, batch 1,
     float32 with TF32 off, through the kernels and through the plain
     versions, from one seeded init and one synthetic batch;
  9. the training path: GANet_deep at 240x528, D=192, batch 2, bfloat16,
     synthetic batches, through `create_train_state` and `make_train_step`;
     launch counts of each kernel in one step, the loss over steps on one
     batch, the step time, peak memory and a profile of the forward and the
     backward.

Any failed check raises and the script exits non-zero.  On success the
line before the last is a JSON object with each kernel's launches on its
path, error, times and bound, and the last line is
{"ok": true, "device": {...}}.  Without a CUDA device, or run outside a
checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

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
    """Mean device time of `fn` in ms over `reps` calls, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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
                log(f"    one launch: {sweep_ms:.3f} ms")
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
            log(f"  {tag}: kernel {ms:.3f} ms (4 launches), plain {plain_ms:.3f} ms, "
                f"bound {bound_ms:.3f} ms ({by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
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
    return entry


def phase_lga(torch, gen):
    """K2 at the head's shape; returns the JSON entry (one bf16 pass)."""
    from ganet_tpu_torch.ops import lga as G
    from ganet_tpu_torch.ops.normalize import l1_normalize

    B, D, H, W, r = 1, 192, 576, 960, 2
    x32 = torch.randn((B, D, H, W), device="cuda", generator=gen)
    g32 = l1_normalize(torch.randn((B, 75, H, W), device="cuda", generator=gen), dim=1)
    entry = None
    for dtype in (torch.float32, torch.bfloat16):
        x, g = x32.to(dtype), g32.to(dtype)
        tag = f"lga {tuple(x.shape)} r{r} {str(dtype)[6:]}"
        errs = {}
        for repeats in (1, 2):
            got = G.lga_nchw(x, g, r, repeats)
            ref = G.lga_reference_nchw(x, g, r, repeats)
            errs[repeats] = compare(torch, f"{tag} repeats {repeats}", got, ref)
            del got, ref
        ms = cuda_ms(torch, lambda: G.lga_kernel(x, g, r), reps=10)
        plain_ms = cuda_ms(torch, lambda: G.lga_reference_nchw(x, g, r, 1), reps=2)
        numel = x.numel()
        nbytes = (2 * numel + g.numel()) * x.element_size()
        flops = 2 * 75 * numel
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S) * 1e3
        by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOP_PER_S else "operations"
        log(f"  {tag}: kernel {ms:.3f} ms per pass, plain {plain_ms:.3f} ms, "
            f"bound {bound_ms:.3f} ms ({by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        if dtype == torch.bfloat16:
            entry = {
                "name": "lga_fwd", "route": "cuda",
                "source": "ganet_tpu_torch/csrc/lga_fwd.cu",
                "replaces": "ganet_tpu/ops/lga_pallas.py:122",
                "max_abs_err": errs[1], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
            }
        del x, g
    return entry


def phase_model_parity(torch, gen):
    """Whole model, kernels vs plain versions, f32 with TF32 off."""
    from ganet_tpu_torch import build_model, ganet_deep, predict

    H, W = 240, 528
    left = torch.rand((1, H, W, 3), device="cuda", generator=gen)
    right = torch.rand((1, H, W, 3), device="cuda", generator=gen)
    outs = {}
    for impl in ("kernel", "torch"):
        model = build_model(ganet_deep(max_disp=192, impl=impl), device="cuda", seed=0)
        outs[impl] = predict(model, left, right)
        del model
    d = (outs["kernel"] - outs["torch"]).abs().max().item()
    finite = bool(torch.isfinite(outs["kernel"]).all())
    # Tolerance 5e-2 px: the float32 noise of the whole forward.  The kernels
    # sum in another order (FMA contraction) than the plain versions, cuDNN
    # may pick another algorithm per run, and random weights make disparities
    # span about +-130 px; runs on identical inputs differed by 4e-3 to
    # 9e-3 px on an H100.  A wrong sweep or stencil moves pixels by whole px.
    ok = finite and d <= 5e-2
    log(f"[4] GANet_deep {H}x{W} D=192 f32 (TF32 off): max |disparity(kernel) - "
        f"disparity(torch)| = {d:.3e} px (tol 5e-2), range "
        f"[{outs['kernel'].min().item():.3f}, {outs['kernel'].max().item():.3f}] {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("model forward through the kernels disagrees with the plain versions")


def phase_main_path(torch, gen, smi, entries):
    """GANet_deep 576x960 D=192 bf16: counted run, then timed runs."""
    from ganet_tpu_torch import build_model, ganet_deep, predict
    from ganet_tpu_torch.ops import lga as G
    from ganet_tpu_torch.ops import sga as S

    cfg = ganet_deep(max_disp=192, compute_dtype="bfloat16")
    model = build_model(cfg, seed=0)
    H, W = 576, 960
    left = torch.rand((1, H, W, 3), device="cuda", generator=gen)
    right = torch.rand((1, H, W, 3), device="cuda", generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counts(S, G)
    disp = predict(model, left, right)
    torch.cuda.synchronize()
    launches = read_counts(S, G)
    log(f"[5] launches in one forward: {launches}")
    if launches["sga_bwd"] or launches["lga_bwd"]:
        raise AssertionError("the eval forward launched a gradient kernel")
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


def reset_counts(S, G) -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in (S.sga_sweep_kernel, G.lga_kernel, S.sga_sweep_bwd_kernel, G.lga_bwd_kernel):
        fn.launches = 0


def read_counts(S, G) -> dict:
    return {
        "sga_fwd": S.sga_sweep_kernel.launches, "lga_fwd": G.lga_kernel.launches,
        "sga_bwd": S.sga_sweep_bwd_kernel.launches, "lga_bwd": G.lga_bwd_kernel.launches,
    }


# Kernel-name fragments of each group in the device time.
KERNEL_GROUPS = (
    ("sga_fwd (K1)", ("sga_sweep",)),
    ("lga_fwd (K2)", ("lga_fwd_kernel",)),
    ("sga_bwd (K3)", ("sga_bwd",)),
    ("lga_bwd (K4)", ("lga_bwd_kernel",)),
    ("convolution", ("conv", "xmma", "cudnn", "implicit", "gemm", "cutlass", "fprop", "dgrad", "wgrad")),
)


def profile_forward(torch, forward, tag: str = "[5] profile of one forward") -> None:
    """Device time of one call of `forward` by kernel, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        kernels.append((us / 1e3, evt.count, evt.key))
    total = sum(ms for ms, _, _ in kernels)
    if total == 0:
        log(f"{tag}: the profiler saw no device time")
        return
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    for ms, _, key in kernels:
        low = key.lower()
        name = next((g for g, frags in KERNEL_GROUPS if any(f in low for f in frags)), "other")
        groups[name] += ms
    log(f"{tag} (profiler on): device time {total:.1f} ms in "
        f"{wall_ms:.1f} ms wall, device idle {100 * (1 - total / wall_ms):.1f}%; "
        + "; ".join(f"{g} {ms:.1f} ms" for g, ms in groups.items()))
    for ms, count, key in sorted(kernels, reverse=True)[:12]:
        log(f"  {ms:8.2f} ms  x{count:<4d} {key[:110]}")


def phase_sga_bwd(torch, gen):
    """K3 at the training path's shapes; returns the JSON entry (full-res
    bf16, one launch)."""
    from ganet_tpu_torch.ops import sga as S
    from ganet_tpu_torch.ops.normalize import l1_normalize

    entry = None
    # (N = B*C, D, H, W) of the full-res and half-res blocks of GANet_deep
    # at 240x528, batch 2.
    for label, (N, D, H, W) in (("full", (64, 64, 80, 176)), ("half", (96, 32, 40, 88))):
        x32 = torch.randn((N, D, H, W), device="cuda", generator=gen)
        w32 = l1_normalize(torch.randn((N, 4, 5, H, W), device="cuda", generator=gen), dim=2)
        g32 = torch.randn((N, D, H, W), device="cuda", generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            x, w, gbar = x32.to(dtype), w32.to(dtype), g32.to(dtype)
            tag = f"sga_bwd {label} {tuple(x.shape)} {str(dtype)[6:]}"
            err = 0.0
            a = [S.sga_sweep_kernel(x, w, ax, rev, direction=k) for k, (ax, rev) in enumerate(S.DIRECTIONS)]
            for direction, (axis, reverse) in enumerate(S.DIRECTIONS):
                wk = w[:, direction].contiguous()
                got_dx, got_dw = S.sga_sweep_bwd_kernel(x, wk, a[direction], gbar, axis, reverse)
                ref_dx, ref_dw = S.sga_sweep_bwd_plain(x, wk, a[direction], gbar, axis, reverse)
                name = f"{tag} sweep {axis}{'-rev' if reverse else ''}"
                err = max(err, compare(torch, f"{name} dx", got_dx, ref_dx, summed=True))
                err = max(err, compare(torch, f"{name} dw", got_dw, ref_dw, summed=True))
                del got_dx, got_dw, ref_dx, ref_dw
                one_ms = cuda_ms(torch, lambda: S.sga_sweep_bwd_kernel(x, wk, a[direction], gbar, axis, reverse), reps=5)
                log(f"    one launch: {one_ms:.3f} ms")
            dw = torch.empty_like(w)

            def four():
                dx = None
                for k, (ax, rev) in enumerate(S.DIRECTIONS):
                    dx, _ = S.sga_sweep_bwd_kernel(x, w, a[k], gbar, ax, rev, direction=k, dx=dx, dw=dw)

            four_ms = cuda_ms(torch, four, reps=5)
            w0 = w[:, 0].contiguous()
            ms = cuda_ms(torch, lambda: S.sga_sweep_bwd_kernel(x, w0, a[0], gbar, "w", False), reps=5)
            plain_ms = cuda_ms(torch, lambda: S.sga_sweep_bwd_plain(x, w0, a[0], gbar, "w", False), reps=1)
            numel, plane = x.numel(), N * H * W
            # One launch reads x, A and gbar and 5 weight planes, writes dx and dw.
            nbytes = (4 * numel + 10 * plane) * x.element_size()
            flops = 25 * numel  # g, dx, 5 products summed over d, the 4-term carry
            bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S) * 1e3
            by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOP_PER_S else "operations"
            log(f"  {tag}: kernel {ms:.3f} ms per launch (W sweep), {four_ms:.3f} ms for the 4 "
                f"directions of one block; plain {plain_ms:.3f} ms per launch; bound {bound_ms:.3f} ms "
                f"per launch ({by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
            if label == "full" and dtype == torch.bfloat16:
                entry = {
                    "name": "sga_bwd", "route": "cuda",
                    "source": "ganet_tpu_torch/csrc/sga_bwd.cu",
                    "replaces": "ganet_tpu/ops/sga_pallas.py:228",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
                }
            del x, w, gbar, a, dw
        del x32, w32, g32
    return entry


def phase_lga_bwd(torch, gen):
    """K4 at the training path's head; returns the JSON entry (one bf16 pass)."""
    from ganet_tpu_torch.ops import lga as G
    from ganet_tpu_torch.ops.normalize import l1_normalize

    B, D, H, W, r = 2, 192, 240, 528, 2
    x32 = torch.randn((B, D, H, W), device="cuda", generator=gen)
    g32 = l1_normalize(torch.randn((B, 75, H, W), device="cuda", generator=gen), dim=1)
    b32 = torch.randn((B, D, H, W), device="cuda", generator=gen)
    entry = None
    for dtype in (torch.float32, torch.bfloat16):
        x, g, gbar = x32.to(dtype), g32.to(dtype), b32.to(dtype)
        tag = f"lga_bwd {tuple(x.shape)} r{r} {str(dtype)[6:]}"
        got_dx, got_dg = G.lga_bwd_kernel(x, g, gbar, r)
        ref_dx, ref_dg = G.lga_bwd_plain(x, g, gbar, r)
        err = max(compare(torch, f"{tag} dx", got_dx, ref_dx, summed=True),
                  compare(torch, f"{tag} dg", got_dg, ref_dg, summed=True))
        del got_dx, got_dg, ref_dx, ref_dg
        ms = cuda_ms(torch, lambda: G.lga_bwd_kernel(x, g, gbar, r), reps=5)
        plain_ms = cuda_ms(torch, lambda: G.lga_bwd_plain(x, g, gbar, r), reps=1)
        numel = x.numel()
        # Reads x, gbar and the guidance, writes dx and dg.
        nbytes = (3 * numel + 2 * g.numel()) * x.element_size()
        flops = 2 * 2 * 75 * numel  # 75 FMAs for dx and 75 for dg per element
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S) * 1e3
        by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOP_PER_S else "operations"
        log(f"  {tag}: kernel {ms:.3f} ms per pass, plain {plain_ms:.3f} ms, "
            f"bound {bound_ms:.3f} ms ({by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        if dtype == torch.bfloat16:
            entry = {
                "name": "lga_bwd", "route": "cuda",
                "source": "ganet_tpu_torch/csrc/lga_bwd.cu",
                "replaces": "ganet_tpu/ops/lga_pallas.py:367",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
            }
        del x, g, gbar
    return entry


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
    from ganet_tpu_torch.ops import lga as G
    from ganet_tpu_torch.ops import sga as S
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

    reset_counts(S, G)
    metrics = step(state, batch)
    torch.cuda.synchronize()
    launches = read_counts(S, G)
    log(f"[9] launches in one train step: {launches}")
    n_sga = 4 * (cfg.model.num_sga_full + cfg.model.num_sga_half)
    n_lga = 2 * cfg.model.lga_repeats
    want = {"sga_fwd": n_sga, "sga_bwd": n_sga, "lga_fwd": n_lga, "lga_bwd": n_lga}
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

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    smi = phase_card(torch)
    log("[2] K1 SGA sweep kernel vs plain version")
    sga_entry = phase_sga(torch, gen)
    log("[3] K2 LGA kernel vs plain version")
    lga_entry = phase_lga(torch, gen)
    phase_model_parity(torch, gen)
    entries = [sga_entry, lga_entry]
    phase_main_path(torch, gen, smi, entries)
    log("[6] K3 SGA gradient-sweep kernel vs plain version")
    entries.append(phase_sga_bwd(torch, gen))
    log("[7] K4 LGA backward kernel vs plain version")
    entries.append(phase_lga_bwd(torch, gen))
    phase_grad_parity(torch)
    phase_train_path(torch, smi, entries)
    log(f"total {time.perf_counter() - t0:.1f} s")
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
