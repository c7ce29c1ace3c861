#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's serving and training paths on one
NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, one JSON line each:
  device   the card (nvidia-smi name and power limit), torch and CUDA versions
  build    nvcc of every kernel in gaussiangrasper_torch/csrc (seconds, ptxas report)
  k1       each kernel against its plain PyTorch version on the card, at a mid
           size and at full width (200k Gaussians, 800x800, C = 39): errors,
           kernel and plain times, the roofline bound
  render_small  the whole render path on the card against the same path on
           the CPU (plain compositor) on a small field
  serve    a full-width run directory (seeded field, step 4000, seeded
           fea_up, 4 orbit views with ground truth); the render and query
           CLIs on cuda with every launch count set to 0 just before and
           read just after; outputs checked finite; ms per view
  k2       the backward kernel against its plain version on K1's own logt
           and ncomp, random g_out and a nonzero g_alpha, at mid size (C 39
           and C 3) and full width: errors of the per-Gaussian sums,
           kernel and plain times, the roofline bound
  train_small  three train steps and a refine step on a small field, on the
           card and on the CPU path from the same init and batch
  train    the full-width train step (bench field grown to capacity 400k,
           bench camera, bench batch shapes, seeded fea_up), steps 4000 to
           4099 and a refine step with every launch count set to 0 just
           before and read just after; ms per step, px/s, a profile
Then the kernels line, the nvidia-smi line and, last, the ok line. Any
failure exits non-zero without the ok line. Without a card, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

N_FULL, WIDTH, HEIGHT, STEP = 200_000, 800, 800, 4000
F32_PEAK_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
K1_ERR_MAX = 1e-4
K1_NCOMP_SHARE_MAX = 1e-4  # of pixels whose ncomp may differ, by at most 1
K2_ERR_MAX = 1e-4  # of each column group's max |per-Gaussian gradient|
CAPACITY = 400_000
TRAIN_STEPS = 100


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def orbit_c2w(angle: float, target=(0.0, 0.0, -3.0), radius: float = 3.0) -> np.ndarray:
    """OpenGL camera-to-world on a horizontal circle around `target`."""
    target = np.asarray(target)
    eye = target + radius * np.array([math.sin(angle), 0.0, math.cos(angle)])
    back = (eye - target) / np.linalg.norm(eye - target)
    right = np.cross([0.0, 1.0, 0.0], back)
    right /= np.linalg.norm(right)
    return np.stack([right, np.cross(back, right), back, eye], 1).astype(np.float32)


def bench_field(n: int, seed: int, device):
    """bench.py's scene: init_random extent 4, scale 0.02, means scaled by
    (0.5, 0.5, 0.25) and shifted to z = -3, with seeded SH rest bands so
    all 25 coefficients do work at step 4000."""
    import torch
    from gaussiangrasper_torch.models.gaussian_field import init_random, random_draws

    rng = np.random.default_rng(seed)
    field, alive = init_random(random_draws(rng, n), extent=4.0, init_scale=0.02, device=device)
    rest = torch.as_tensor(0.1 * rng.standard_normal((n, 24, 3), np.float32), device=device)
    scale = torch.tensor([0.5, 0.5, 0.25], device=device)
    shift = torch.tensor([0.0, 0.0, -3.0], device=device)
    return field._replace(means=field.means * scale + shift,
                          sh_coeffs=torch.cat([field.sh_coeffs[:, :1], rest], 1)), alive


def seeded_fea_up_arrays(seed: int) -> dict:
    """fea_up weights {w{i} (d_in, d_out), b{i}} with torch.nn.Linear's
    default U(-1/sqrt(fan_in), +) draws."""
    rng = np.random.default_rng(seed)
    arrays = {}
    for i, (a, b) in enumerate(((32, 128), (128, 512))):
        bound = 1.0 / math.sqrt(a)
        arrays[f"w{i}"] = rng.uniform(-bound, bound, (a, b)).astype(np.float32)
        arrays[f"b{i}"] = rng.uniform(-bound, bound, b).astype(np.float32)
    return arrays


def seeded_fea_up(seed: int):
    from gaussiangrasper_torch.models.efd import FeaUp

    return FeaUp.from_numpy(seeded_fea_up_arrays(seed))


def k1_inputs(field, alive, cam, cfg):
    """The kernel's inputs on the main path for one view."""
    from gaussiangrasper_torch.models.model import render_inputs
    from gaussiangrasper_torch.ops import rasterize_cuda as rc
    from gaussiangrasper_torch.ops.rasterize import bin_gaussians, tile_grid

    proj, colors, opac, bg = render_inputs(field, alive, cam, STEP, cfg)
    bins = bin_gaussians(proj, cam.width, cam.height, cfg.raster, opacities=opac)
    k = min(cfg.raster.max_gaussians_per_tile, proj.xys.shape[0])
    starts, counts = rc.stream_bounds(bins.pair_gidx, bins.pair_starts, bins.tile_count, k)
    tw, _ = tile_grid(cam.width, cam.height, cfg.raster.tile_size)
    return (bins.pair_gidx.to(proj.xys.device).int().contiguous(), starts, counts,
            rc.pack_attrs(proj.xys, proj.conics, opac, colors), bg, tw, cfg.raster.tile_size)


def cuda_ms(fn, reps: int) -> float:
    """Median device time of fn() over `reps` runs, CUDA events, after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def k1_bound(args, ncomp, live) -> dict:
    """Least time for K1's work on these inputs: operations from the
    walk's own visit counts (a pixel walks until its cut entry, inclusive)
    at the f32 peak, and compulsory bytes at the HBM rate."""
    import torch

    gidx, starts, counts, attrs, bg, tw, ts = args
    c = attrs.shape[1] - 6
    cnt = counts.double()[:, None].expand_as(ncomp)
    visits = float(torch.where(ncomp < cnt, ncomp.double() + 1.0, cnt).sum())
    # per visit: dx, dy, sigma (9), exp, o*exp, min, two tests = 16
    # per composited live visit: log1p, cum add, test, exp, w, logt add + 2C FMA flops
    ops = 16.0 * visits + (6.0 + 2.0 * c) * float(live.double().sum())
    t, p = ncomp.shape
    nbytes = 4.0 * (attrs.numel() + float(counts.sum()) + 2 * t + c + t * p * (c + 3))
    t_ops, t_bytes = ops / F32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "visits": visits, "ops": ops, "bytes": nbytes}


def check_k1(label: str, args, time_it: bool) -> dict:
    """Kernel vs plain version on the same inputs; raises past the bounds."""
    import torch
    from gaussiangrasper_torch.ops import rasterize_cuda as rc

    got = rc.composite_pairs_fwd(*args)
    want = rc.composite_pairs_fwd_plain(*args, count_live=True)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got[:3], want[:3]))
    dn = (got[3] - want[3]).abs()
    n_diff, dn_max = int((dn > 0).sum()), float(dn.max())
    share = n_diff / dn.numel()
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    row = {"phase": "k1", "case": label, "tiles": int(args[1].shape[0]),
           "channels": int(args[3].shape[1] - 6), "pairs": int(args[2].sum()),
           "max_abs_err": err, "ncomp_diff_pixels": n_diff, "ncomp_diff_max": dn_max}
    if time_it:
        # the kernel alone, then with the wrapper's input checks (one host sync)
        row["ms"] = cuda_ms(lambda: rc._launch_kernel(*args), 20)
        row["wrapper_ms"] = cuda_ms(lambda: rc.composite_pairs_fwd(*args), 20)
        row["plain_ms"] = cuda_ms(lambda: rc.composite_pairs_fwd_plain(*args), 3)
        row.update(k1_bound(args, want[3], want[4]))
    emit(row)
    if not finite or err > K1_ERR_MAX or dn_max > 1 or share > K1_NCOMP_SHARE_MAX:
        raise RuntimeError(f"k1 {label}: kernel disagrees with its plain version: {row}")
    return row


def device_profile(fn, top: int = 8) -> dict:
    """torch.profiler over one synchronized call: device-busy ms (the sum
    of every kernel's device time) and the `top` kernels by it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # device-side events only: a CPU op's self device time repeats the
    # kernels it launched
    rows = sorted(((e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    return {"device_busy_ms": sum(ms for _, ms in rows),
            "top_ms": [[k[:80], ms] for k, ms in rows[:top]]}


def k2_inputs(k1_args, seed: int):
    """K2's inputs on the main path: the stream, K1's own logt and ncomp
    from the kernel, a random g_out and a nonzero g_alpha (the term
    sky_alpha_reg drives)."""
    import torch
    from gaussiangrasper_torch.ops import rasterize_cuda as rc

    gidx, starts, counts, attrs, bg, tw, ts = k1_args
    _, alpha, logt, ncomp = rc._launch_kernel(*k1_args)
    gen = torch.Generator(device=attrs.device).manual_seed(seed)
    g_out = torch.randn(*alpha.shape, attrs.shape[1] - 6, generator=gen, device=attrs.device)
    g_alpha = torch.randn(alpha.shape, generator=gen, device=attrs.device)
    return gidx, starts, counts, attrs, bg, g_out, g_alpha, logt, ncomp, tw, ts


def per_gaussian(args, gpairs):
    """The (N, 6 + C) per-Gaussian sum of K2's rows, as the backward takes it."""
    import torch

    return torch.zeros_like(args[3]).index_add_(0, args[0].long(), gpairs)


def k2_bound(args, live) -> dict:
    """Least time for K2's work on these inputs: every pixel tests the rows
    below min(ncomp, count) (~16 operations each) and each composited row
    with a live alpha adds ~40 + 4C (log1p, exp, <c, g>, dalpha, the conic
    chain, dcolour and the pixel sums), at the f32 peak; compulsory bytes
    (table, walked pair_gidx, g_out, g_alpha, logt, ncomp, gpairs) at the
    HBM rate."""
    import torch

    gidx, starts, counts, attrs, bg, g_out, g_alpha, logt, ncomp, tw, ts = args
    c = attrs.shape[1] - 6
    visits = float(torch.minimum(ncomp.double(), counts.double()[:, None]).sum())
    n_live = float(live.double().sum())
    ops = 16.0 * visits + (40.0 + 4.0 * c) * n_live
    t, p = ncomp.shape
    nbytes = 4.0 * (attrs.numel() + float(counts.sum()) + 2 * t + c + t * p * (c + 3)
                    + gidx.shape[0] * attrs.shape[1])
    t_ops, t_bytes = ops / F32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "visits": visits, "live_visits": n_live, "ops": ops, "bytes": nbytes}


def check_k2(label: str, k1_args, time_it: bool) -> dict:
    """Kernel vs plain version on the same inputs, held on the per-Gaussian
    sums (column groups dxy, dconic, dopacity, dcolour, each relative to
    its max |value|); raises past K2_ERR_MAX."""
    import torch
    from gaussiangrasper_torch.ops import rasterize_cuda as rc

    args = k2_inputs(k1_args, seed=5)
    got = per_gaussian(args, rc.composite_pairs_bwd(*args))
    want = per_gaussian(args, rc.composite_pairs_bwd_plain(*args))
    torch.cuda.synchronize()
    c = args[3].shape[1] - 6
    errs, scales = {}, {}
    for name, lo, hi in (("dxy", 0, 2), ("dconic", 2, 5), ("dopacity", 5, 6), ("dcolor", 6, 6 + c)):
        scales[name] = float(want[:, lo:hi].abs().max())
        errs[name] = float((got[:, lo:hi] - want[:, lo:hi]).abs().max()) / max(scales[name], 1e-30)
    row = {"phase": "k2", "case": label, "tiles": int(args[1].shape[0]), "channels": c,
           "pairs": int(args[2].sum()), "rel_err": errs, "scale": scales,
           "max_abs_err": float((got - want).abs().max()),
           "max_rel_err": max(errs.values())}
    if time_it:
        row["ms"] = cuda_ms(lambda: rc._launch_bwd_kernel(*args), 20)
        row["wrapper_ms"] = cuda_ms(lambda: rc.composite_pairs_bwd(*args), 20)
        row["plain_ms"] = cuda_ms(lambda: rc.composite_pairs_bwd_plain(*args), 1)
        live = rc.composite_pairs_fwd_plain(*k1_args, count_live=True)[4]
        row.update(k2_bound(args, live))
    emit(row)
    if not bool(torch.isfinite(got).all()) or max(errs.values()) > K2_ERR_MAX \
            or min(scales.values()) <= 0.0:
        raise RuntimeError(f"k2 {label}: kernel disagrees with its plain version: {row}")
    return row


def train_batch(width: int, height: int, groups: int, pairs: int, points: int, seed: int, device):
    """A supervision batch with the data layer's shapes (bench.py's
    make_batch): image, depth, normal, valid mask, SAM pairs, CLIP points."""
    import torch

    rng = np.random.default_rng(seed)

    def pix(*shape):
        return np.stack([rng.integers(0, height, shape), rng.integers(0, width, shape)],
                        -1).astype(np.int32)

    valid = np.ones((height, width), bool)
    valid[: height // 20] = False  # a masked-out band: sky_alpha_reg's pixels
    batch = {
        "image": rng.uniform(size=(height, width, 3)).astype(np.float32),
        "depth": np.full((height, width), 3.0, np.float32),
        "normal": np.tile(np.array([0.0, 0.0, 1.0], np.float32), (height, width, 1)),
        "valid_mask": valid,
        "pair_a": pix(groups, pairs), "pair_b": pix(groups, pairs),
        "pair_valid": np.ones((groups, pairs), bool),
        "group_valid": np.ones(groups, bool),
        "points": pix(points), "point_valid": np.ones(points, bool),
        "gt_clip": rng.standard_normal((points, 512)).astype(np.float32),
    }
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def train_state_at(n: int, capacity: int, seed: int, device):
    """bench.py's train state: bench field, seeded fea_up, step 4000, grown
    to `capacity` so densification has free slots."""
    import dataclasses

    from gaussiangrasper_torch.engine.train_state import grow_capacity, init_train_state
    from gaussiangrasper_torch.models.efd import params_from_numpy

    field, alive = bench_field(n, seed=seed, device=device)
    state = init_train_state(field, alive, params_from_numpy(seeded_fea_up_arrays(seed + 1), device))
    return grow_capacity(dataclasses.replace(state, step=STEP), capacity)


def train_small_phase(cfg) -> None:
    """Three train steps and a refine step on a 4000-Gaussian field at
    128x96, on the card and on the CPU path from the same init, batch and
    split noise. Losses within 1e-3 relative (float32 sums in another
    order, K2's atomics); parameters within 3 lr N of their group (Adam with
    eps 1e-15 moves a near-zero-gradient entry by about +-lr on a sign
    rounding can flip, and after the first step |m_hat| / sqrt(v_hat) can
    pass 1); alive counts after the refine within 0.5% (a densify or cull
    threshold can flip with the statistics' rounding)."""
    import dataclasses

    import torch
    from gaussiangrasper_torch.core.cameras import Camera
    from gaussiangrasper_torch.engine import optimizers as optim
    from gaussiangrasper_torch.engine.train_state import refine_step, train_step

    cam_args = (160.0, 160.0, 64.0, 48.0, orbit_c2w(0.2), 128, 96)
    runs = {}
    for dev in ("cuda", "cpu"):
        state = train_state_at(4000, 4400, seed=3, device=dev)
        rng = np.random.default_rng(4)
        # spread opacities off init_opacity, so no cull test sits on its threshold
        state = dataclasses.replace(state, step=STEP + 97, field=state.field._replace(
            opacity_logits=torch.as_tensor(rng.normal(-1.0, 1.0, 4400).astype(np.float32), device=dev)))
        batch = train_batch(128, 96, 4, 64, 100, seed=6, device=dev)
        cam = Camera.create(*cam_args, device=dev)
        losses = []
        for _ in range(3):
            state, m = train_step(state, cam, batch, cfg)
            losses.append({k: float(v) for k, v in m.items() if not k.startswith("grad_norm")})
        noise = torch.as_tensor(np.random.default_rng(7).standard_normal((4400, 3)).astype(np.float32),
                                device=dev)
        before = state
        after = refine_step(state, cfg, 128, 96, num_train_data=4, noise=noise)
        runs[dev] = (losses, before, after)
    (gl, gb, ga), (cl, cb, ca) = runs["cuda"], runs["cpu"]
    loss_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6) for a, b in zip(gl, cl) for k in b)
    param_err = {}
    for leaf, group in optim.FIELD_GROUP_OF.items():
        lim = 3.0 * optim.DEFAULT_GROUPS[group].lr_init * 3
        param_err[leaf] = float((getattr(gb.field, leaf).cpu() - getattr(cb.field, leaf)).abs().max()) / lim
    alive = [int(gb.alive.sum()), int(ga.alive.sum()), int(ca.alive.sum())]
    row = {"phase": "train_small", "gaussians": 4000, "capacity": 4400, "losses_cuda": gl,
           "max_loss_rel_err": loss_err, "param_err_over_limit": param_err,
           "alive_before_after_cuda_cpu": alive}
    emit(row)
    finite = all(bool(torch.isfinite(x).all()) for x in ga.field)
    if (loss_err > 1e-3 or max(param_err.values()) > 1.0 or not finite
            or abs(alive[1] - alive[2]) > 0.005 * alive[2] or alive[1] == alive[0]):
        raise RuntimeError(f"train_small: the card disagrees with the CPU path: {row}")


def train_phase(device, cfg) -> dict:
    """Full-width train steps 4000..4099 and a refine step, bench.py's point."""
    import torch
    from gaussiangrasper_torch.engine.train_state import refine_step, train_step
    from gaussiangrasper_torch.ops import rasterize_cuda as rc

    state = train_state_at(N_FULL, CAPACITY, seed=0, device=device)
    batch = train_batch(WIDTH, HEIGHT, 32, 800, 1000, seed=8, device=device)
    cam = bench_camera(WIDTH, HEIGHT, device)
    torch.cuda.synchronize()
    rc.composite_pairs_fwd.launches = 0
    rc.composite_pairs_bwd.launches = 0
    batch_s, losses = [], []
    for _ in range(TRAIN_STEPS // 10):
        t0 = time.perf_counter()
        metrics = []
        for _ in range(10):
            state, m = train_step(state, cam, batch, cfg)
            metrics.append(torch.stack([v.float() for v in m.values()]))
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
        stacked = torch.stack(metrics)
        if not bool(torch.isfinite(stacked).all()):
            raise RuntimeError(f"non-finite train metrics: {dict(zip(m, stacked[-1].tolist()))}")
        losses.append(float(stacked[-1, 0]))
    alive_before = int(state.alive.sum())
    refined = refine_step(state, cfg, WIDTH, HEIGHT, num_train_data=4)
    alive_after = int(refined.alive.sum())
    torch.cuda.synchronize()
    launches = {"k1": rc.composite_pairs_fwd.launches, "k2": rc.composite_pairs_bwd.launches}
    if launches != {"k1": TRAIN_STEPS, "k2": TRAIN_STEPS}:
        raise RuntimeError(f"launches {launches} for {TRAIN_STEPS} train steps")
    if alive_after == alive_before or not all(bool(torch.isfinite(x).all()) for x in refined.field):
        raise RuntimeError(f"refine: alive {alive_before} -> {alive_after}")
    ms = 1e3 * float(np.median(batch_s[1:])) / 10
    final = dict(zip(m, (float(x) for x in stacked[-1])))
    # one more step of the last batch's state (before the refine), traced
    profile = device_profile(lambda: train_step(state, cam, batch, cfg), top=10)
    t0 = time.perf_counter()
    train_step(state, cam, batch, cfg)
    torch.cuda.synchronize()
    profile["step_ms"] = 1e3 * (time.perf_counter() - t0)
    row = {"phase": "train", "gaussians": N_FULL, "capacity": CAPACITY, "width": WIDTH,
           "height": HEIGHT, "channels": cfg.num_channels, "steps": [STEP, STEP + TRAIN_STEPS - 1],
           "launches": launches, "ms_per_step": ms, "px_per_s": WIDTH * HEIGHT / (ms / 1e3),
           "batch_ms_per_step": [1e3 * b / 10 for b in batch_s], "loss_every_10": losses,
           "final_metrics": final, "alive_before_refine": alive_before,
           "alive_after_refine": alive_after, "train_profile": profile,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    row["device_idle_share"] = 1.0 - profile["device_busy_ms"] / profile["step_ms"]
    emit(row)
    return row


def serve_phase(device, cfg) -> dict:
    """Full-width run directory through the render and query CLIs."""
    import torch
    from gaussiangrasper_torch.engine import checkpoint as ckpt
    from gaussiangrasper_torch.engine.weights import ServeState
    from gaussiangrasper_torch.ops import rasterize_cuda as rc
    from gaussiangrasper_torch.scripts import query, render

    field, alive = bench_field(N_FULL, seed=0, device="cpu")
    state = ServeState(field, alive, seeded_fea_up(1), STEP)
    views = 4
    rng = np.random.default_rng(2)
    with tempfile.TemporaryDirectory() as tmp:
        run = Path(tmp) / "run"
        ckpt.save_run(run, state, cfg, experiment_name="chip_smoke_full_width")
        c2w = np.stack([orbit_c2w(a) for a in np.linspace(-0.3, 0.3, views)])
        valid = np.ones((views, HEIGHT, WIDTH), bool)
        valid[:, :40] = False
        ckpt.save_cameras(
            run, [1000.0] * views, [1000.0] * views, [WIDTH / 2] * views, [HEIGHT / 2] * views,
            c2w, WIDTH, HEIGHT,
            image=rng.uniform(size=(views, HEIGHT, WIDTH, 3)).astype(np.float32),
            depth=rng.uniform(2.0, 4.0, (views, HEIGHT, WIDTH)).astype(np.float32),
            normal=rng.standard_normal((views, HEIGHT, WIDTH, 3)).astype(np.float32),
            valid_mask=valid)
        np.save(run / "q.npy", rng.standard_normal((1, 512)).astype(np.float32))
        np.save(run / "canon.npy", rng.standard_normal((4, 512)).astype(np.float32))

        rc.composite_pairs_fwd.launches = 0
        t0 = time.perf_counter()
        render.main(["--run-dir", str(run), "--num-views", str(views), "--device", "cuda"])
        query.main(["--run-dir", str(run), "--text-embedding", str(run / "q.npy"),
                    "--canonical-embedding", str(run / "canon.npy"),
                    "--views", *map(str, range(views)), "--device", "cuda"])
        torch.cuda.synchronize()
        launches = rc.composite_pairs_fwd.launches
        cli_s = time.perf_counter() - t0
        if launches != 2 * views:
            raise RuntimeError(f"K1 launched {launches} times for {2 * views} renders")

        metrics = json.loads((run / "renders" / "metrics.json").read_text())
        arrays = [np.load(p) for sub in ("clip", "depth", "normal")
                  for p in sorted((run / "renders" / sub).glob("*.npy"))]
        arrays += [np.load(p) for p in sorted((run / "query").glob("*.npy"))]
        if len(arrays) != 4 * views:
            raise RuntimeError(f"expected {4 * views} arrays, found {len(arrays)}")
        if not all(np.isfinite(a.astype(np.float32)).all() for a in arrays):
            raise RuntimeError("non-finite values in the served outputs")
        if arrays[0].shape != (HEIGHT, WIDTH, 512):
            raise RuntimeError(f"clip map shape {arrays[0].shape}")
        stats = metrics["binning"]
        if len(stats) != views or not all(set(s) == {"overflow", "dropped_tiles", "pair_overflow"}
                                           for s in stats):
            raise RuntimeError(f"binning stats missing: {stats}")
        scores = [metrics["results"][k] for k in ("psnr", "ssim", "psnr_masked")]
        if not all(math.isfinite(v) for v in scores):
            raise RuntimeError(f"non-finite metrics {scores}")

        # ms per view of each serving stage, host clock around synchronized work
        cfg_, st, _ = ckpt.load_run(run, device)
        cams, _ = ckpt.load_cameras(run, device)
        q = torch.as_tensor(np.load(run / "q.npy")[0], device=device)
        canon = torch.as_tensor(np.load(run / "canon.npy"), device=device)
        times = {"render": [], "lift": [], "relevancy": []}
        for cam in cams * 2:
            t0 = time.perf_counter()
            outs = render.render_view(st, cam, cfg_)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            clip = render.lift(st.fea_up, outs["feature"])
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            query.relevancy_map(clip, q, canon)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            for k, dt in zip(times, (t1 - t0, t2 - t1, t3 - t2)):
                times[k].append(1e3 * dt)
        profile = device_profile(lambda: render.render_view(st, cams[0], cfg_))
    row = {"phase": "serve", "gaussians": N_FULL, "width": WIDTH, "height": HEIGHT,
           "channels": cfg.num_channels, "views": views, "k1_launches": launches,
           "cli_seconds": cli_s, "binning": stats,
           "metrics": dict(zip(("psnr", "ssim", "psnr_masked"), scores)),
           **{f"{k}_ms_per_view": float(np.median(v[views:])) for k, v in times.items()},
           "render_profile": profile}
    row["render_device_idle_share"] = 1.0 - profile["device_busy_ms"] / row["render_ms_per_view"]
    emit(row)
    return row


def render_small_phase(cfg) -> None:
    """The whole render path on the card against the CPU path (plain
    compositor) on one small field: same images within 1e-4."""
    import torch
    from gaussiangrasper_torch.core.cameras import Camera
    from gaussiangrasper_torch.models.model import render

    field, alive = bench_field(4000, seed=3, device="cpu")
    cam = Camera.create(160.0, 160.0, 64.0, 48.0, orbit_c2w(0.2), 128, 96)
    cam_gpu = Camera.create(160.0, 160.0, 64.0, 48.0, orbit_c2w(0.2), 128, 96, device="cuda")
    with torch.no_grad():
        cpu = render(field, alive, cam, STEP, cfg)
        gpu = render(field.to("cuda"), alive.cuda(), cam_gpu, STEP, cfg)
    err = {k: float((gpu[k].cpu() - cpu[k]).abs().max())
           for k in ("rgb", "feature", "depth", "normal", "alpha")}
    emit({"phase": "render_small", "gaussians": 4000, "max_abs_err": err})
    if max(err.values()) > K1_ERR_MAX or float(cpu["alpha"].max()) <= 0.0:
        raise RuntimeError(f"render on the card disagrees with the CPU path: {err}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from gaussiangrasper_torch import _build
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})", file=sys.stderr)
        return 3
    from gaussiangrasper_torch.models.model import GaussianSplatConfig

    card = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": card, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    reports = _build.build_all()
    ptxas = {name: [ln.strip() for ln in text.splitlines()
                    if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
             for name, text in reports.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas})

    device = torch.device("cuda")
    cfg = GaussianSplatConfig()
    field, alive = bench_field(N_FULL, seed=0, device=device)
    with torch.no_grad():
        cam_mid = bench_camera(400, 300, device)
        mid39 = k1_inputs(field, alive, cam_mid, cfg)
        check_k1("mid_c39", mid39, time_it=False)
        mid3 = list(mid39)
        mid3[3] = torch.cat([mid3[3][:, :6], mid3[3][:, 6:9]], 1).contiguous()
        mid3[4] = mid3[4][:3].contiguous()
        mid3 = tuple(mid3)
        check_k1("mid_c3", mid3, time_it=False)
        full_args = k1_inputs(field, alive, bench_camera(WIDTH, HEIGHT, device), cfg)
        full = check_k1("full_width_c39", full_args, time_it=True)
        check_k2("mid_c39", mid39, time_it=False)
        check_k2("mid_c3", mid3, time_it=False)
        full2 = check_k2("full_width_c39", full_args, time_it=True)
    del field, alive, mid39, mid3, full_args
    render_small_phase(cfg)
    serve = serve_phase(device, cfg)
    train_small_phase(cfg)
    train = train_phase(device, cfg)

    def kernel_row(name, replaces, row, launches):
        return {"name": name, "route": "cuda", "source": f"gaussiangrasper_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": sum(launches.values()),
                "launches_by_path": launches, "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "wrapper_ms": row["wrapper_ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None}

    emit({"kernels": [
        kernel_row("composite_pairs_fwd", "rasterize_pallas.py:490 (_fwd_pairs_kernel)", full,
                   {"serve": serve["k1_launches"], "train": train["launches"]["k1"]}),
        kernel_row("composite_pairs_bwd", "rasterize_pallas.py:600 (_bwd_pairs_kernel)", full2,
                   {"train": train["launches"]["k2"]}),
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def bench_camera(width: int, height: int, device):
    """bench.py's camera scaled to width x height: f = 1000 * width / 800,
    at the origin looking down -z."""
    from gaussiangrasper_torch.core.cameras import Camera

    f = 1000.0 * width / WIDTH
    return Camera.create(f, f, width / 2, height / 2, np.eye(4, dtype=np.float32)[:3],
                         width, height, device=device)


if __name__ == "__main__":
    sys.exit(main())
