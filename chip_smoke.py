#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's serving and training paths on one
NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, one JSON line each:
  device   the card (nvidia-smi name and power limit), torch and CUDA versions
  build    nvcc of every kernel in gaussiangrasper_torch/csrc and g++ of the native
           sampler, all into gaussiangrasper_torch/build (seconds, ptxas report, the
           sampler's branch, how many clusters of K5 (two CTAs) and K6 (four)
           the card holds)
  k1       each kernel against its plain PyTorch version on the card, at a mid
           size and at full width (200k Gaussians, 800x800, C = 39): errors,
           kernel and plain times, the roofline bound
  k2       the backward kernel against its plain version on K1's own logt
           and ncomp, random g_out and a nonzero g_alpha, at mid size (C 39
           and C 3) and full width: errors of the per-Gaussian sums,
           kernel and plain times, the roofline bound, and the work in warp
           x row pairs (warp_rows walked, live_warp_rows with a live lane)
           with the SM clocks the kernel spends a live warp-row
  k5       the two-tile forward against K1 (all four outputs bit-equal) at
           an odd mid tile count (C 39 and C 3, also against the plain
           version) and at full width (625 tiles); its time beside K1's and
           the bound
  k6       the two-tile backward against K2 and the plain version with K2's
           criterion, at the same sizes; its time beside K2's and the bound
  k3       the table compositor against its plain version at mid size (C 39
           and C 3, tables from bin_gaussians(build_table=True)) with K1's
           criterion, and at full width bit-equal to K1 on the stream of the
           same sort (no K or pair-budget clip); its time beside K1's and
           the bound
  k4       the table backward against its plain version at mid size and
           against K2 at full width, on the per-Gaussian sums with K2's
           criterion; its time beside K2's and the bound
  render_small  the whole render path on the card against the same path on
           the CPU (plain compositor) on a small field
  serve    a full-width run directory (seeded field, step 4000, seeded
           fea_up, 4 orbit views with ground truth); the render and query
           CLIs on cuda with every launch count set to 0 just before and
           read just after; outputs checked finite; ms per view
  train_small  three train steps and a refine step on a small field, on the
           card and on the CPU path from the same init and batch
  table    the table path at full width: render with a table compositor
           (bin_gaussians(build_table=True) -> rasterize_projected(bins=...))
           beside the pair path, ms per view, images bit-equal; then 20
           iterations of train_loss + backward through each path at the
           train phase's point, launch counts set to 0 just before (20 K3 +
           20 K4), ms per iteration and the device time of one traced
           iteration of each, step-0 losses bit-equal and the field
           gradients within K2's criterion of the pair path's
  probes   both probe entry points in-process (kernel_probe: P1, K3 at the
           probe's shapes; copy_probe: P2, P3), launch counts set to 0 just
           before, every stage OK; P1-P3 and the library calls for P1 / P2
           against their plain versions, exact; their device times from the
           profiler over 50 calls (CUDA events around one call time the host)
  train    the full-width train step (bench field grown to capacity 400k,
           bench camera, bench batch shapes, seeded fea_up), steps 4000 to
           4099 and a refine step with every launch count set to 0 just
           before and read just after; ms per step, px/s, a profile
  trainer  the training CLI (`ggt-torch-train`) on an 800x800, 8-view
           ray-traced tabletop with 200k seed points: 300 steps (250 at
           400x400, 50 at 800x800), refines at steps 100, 200, 300, capacity
           400k, C = 39, then the render CLI on the run; every launch count
           set to 0 just before; ms per step at each resolution, px/s, the
           wait on the data path, losses, alive counts, peak memory, a profile
  trainer_tp2  the same run with rasterize_cuda.TP = 2 (K5 / K6): its
           step-0 loss equal to trainer's, and how far the runs drift apart
Then the kernels line (nine kernels), the nvidia-smi line and, last, the
ok line. Any
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
# H100 SXM dense TF32 on the tensor cores is 495e12; an f32-grade product in
# 3xTF32 (K2's scheme) takes three TF32 products
TF32X3_PEAK_FLOPS = 495e12 / 3
HBM_BYTES_PER_S = 3.35e12
K1_ERR_MAX = 1e-4
K1_NCOMP_SHARE_MAX = 1e-4  # of pixels whose ncomp may differ, by at most 1
K2_ERR_MAX = 1e-4  # of each column group's max |per-Gaussian gradient|
CAPACITY = 400_000
TRAIN_STEPS = 100
TRAINER_STEPS = 300
TRAINER_SCENE = dict(width=800, height=800, n_views=8, seed_points=200_000, seed=0)


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
    bins = bin_gaussians(proj, cam.width, cam.height, cfg.raster, opacities=opac,
                         build_table=False, keep_pairs=True)
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


def roofline(ops: float, nbytes: float, tc_ops: float = 0.0, **counts) -> dict:
    """The least time: the larger of the operations' time and bytes at the
    HBM rate. Operations: `ops` at the f32 peak outside the tensor cores
    plus `tc_ops` (f32-grade products on the tensor cores) at the 3xTF32
    rate, the two times added."""
    t_ops = ops / F32_PEAK_FLOPS + tc_ops / TF32X3_PEAK_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S
    row = {"bound_ms": 1e3 * max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           **counts, "ops": ops, "bytes": nbytes}
    return {**row, "tensor_core_ops": tc_ops} if tc_ops else row


def walk_ops(counts, ncomp, live, c: int):
    """(visits, operations) of the forward walk on these inputs: a pixel
    walks until its cut entry, inclusive."""
    import torch

    cnt = counts.double()[:, None].expand_as(ncomp)
    visits = float(torch.where(ncomp < cnt, ncomp.double() + 1.0, cnt).sum())
    # per visit: dx, dy, sigma (9), exp, o*exp, min, two tests = 16
    # per composited live visit: log1p, cum add, test, exp, w, logt add + 2C FMA flops
    return visits, 16.0 * visits + (6.0 + 2.0 * c) * float(live.double().sum())


def k1_bound(args, ncomp, live) -> dict:
    """Least time for K1's work on these inputs: operations from the
    walk's own visit counts at the f32 peak, and compulsory bytes (the
    (N, 6 + C) table, the walked pair_gidx, outputs) at the HBM rate."""
    gidx, starts, counts, attrs, bg, tw, ts = args
    c = attrs.shape[1] - 6
    visits, ops = walk_ops(counts, ncomp, live, c)
    t, p = ncomp.shape
    nbytes = 4.0 * (attrs.numel() + float(counts.sum()) + 2 * t + c + t * p * (c + 3))
    return roofline(ops, nbytes, visits=visits)


def k3_bound(targs, ncomp, live) -> dict:
    """K1's operations on the table's rows; bytes: the walked table rows,
    counts, bg and the outputs."""
    counts, tables, bg, tw, ts = targs
    c = tables.shape[2] - 6
    visits, ops = walk_ops(counts, ncomp, live, c)
    t, p = ncomp.shape
    nbytes = 4.0 * (float(counts.sum()) * tables.shape[2] + t + c + t * p * (c + 3))
    return roofline(ops, nbytes, visits=visits)


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


def device_ms(fn, reps: int) -> float:
    """Device time of one fn() call: the profiler's device-busy ms over
    `reps` calls, divided by reps. For kernels of a few microseconds, where
    CUDA events around one call time the host's launch path instead. A
    profile that recorded no device time (seen once, for a kernel that a
    profile of its own always records) is taken again, up to three in all."""
    for _ in range(3):
        busy = device_profile(lambda: [fn() for _ in range(reps)])["device_busy_ms"]
        if busy > 0:
            break
    return busy / reps


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
    with a live alpha adds ~40 (log1p, exp, dalpha, the conic chain and the
    pixel sums) at the f32 peak and 4C (<c, g> and dcolour, the kernel's
    tensor-core products) at the 3xTF32 rate; compulsory bytes
    (table, walked pair_gidx, g_out, g_alpha, logt, ncomp, gpairs) at the
    HBM rate."""
    gidx, starts, counts, attrs, bg, g_out, g_alpha, logt, ncomp, tw, ts = args
    c = attrs.shape[1] - 6
    visits, n_live, ops, tc_ops = grad_ops(counts, ncomp, live, c)
    t, p = ncomp.shape
    nbytes = 4.0 * (attrs.numel() + float(counts.sum()) + 2 * t + c + t * p * (c + 3)
                    + gidx.shape[0] * attrs.shape[1])
    return roofline(ops, nbytes, tc_ops, visits=visits, live_visits=n_live)


def grad_ops(counts, ncomp, live, c: int):
    """(visits, live visits, operations outside the tensor cores, products
    on them) of the reverse walk (K2 / K4 / K6)."""
    import torch

    visits = float(torch.minimum(ncomp.double(), counts.double()[:, None]).sum())
    n_live = float(live.double().sum())
    return visits, n_live, 16.0 * visits + 40.0 * n_live, 4.0 * c * n_live


def k4_bound(bargs, live) -> dict:
    """K2's operations on the table's rows; bytes: the walked table rows,
    counts, bg, g_out, g_alpha, logt, ncomp and the whole (T, K, 6 + C)
    gradient table written."""
    counts, tables, bg, g_out, g_alpha, logt, ncomp, tw, ts = bargs
    c = tables.shape[2] - 6
    visits, n_live, ops, tc_ops = grad_ops(counts, ncomp, live, c)
    t, p = ncomp.shape
    nbytes = 4.0 * (float(counts.sum()) * tables.shape[2] + t + c + t * p * (c + 3)
                    + tables.numel())
    return roofline(ops, nbytes, tc_ops, visits=visits, live_visits=n_live)


def warp_row_work(args, ms: float) -> dict:
    """K2's work in warp x row pairs on these inputs (a warp an 8 x 4 pixel
    block, rc.warp_pixels): walked by some lane, and live (a lane's row
    passes the validity tests), from the plain version; with the kernel's
    ms, the SM clocks it spends a live warp-row at the card's maximum SM
    clock."""
    import torch
    from gaussiangrasper_torch.ops import rasterize_cuda as rc

    _, warp_rows, live = rc.composite_pairs_bwd_plain(*args, count_warp_rows=True)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"warp_rows": warp_rows, "live_warp_rows": live, "max_sm_mhz": mhz, "sms": sms,
            "ns_per_live_warp_row": 1e6 * ms / max(live, 1),
            "sm_clocks_per_live_warp_row": 1e-3 * ms * sms * mhz * 1e6 / max(live, 1)}


def grad_errors(got, want, c: int):
    """Per column group (dxy, dconic, dopacity, dcolour) of per-Gaussian
    sums: max |got - want| over the group's max |want|, and that max."""
    errs, scales = {}, {}
    for name, lo, hi in (("dxy", 0, 2), ("dconic", 2, 5), ("dopacity", 5, 6), ("dcolor", 6, 6 + c)):
        scales[name] = float(want[:, lo:hi].abs().max())
        errs[name] = float((got[:, lo:hi] - want[:, lo:hi]).abs().max()) / max(scales[name], 1e-30)
    return errs, scales


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
    errs, scales = grad_errors(got, want, c)
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
        row.update(warp_row_work(args, row["ms"]))
    emit(row)
    if not bool(torch.isfinite(got).all()) or max(errs.values()) > K2_ERR_MAX \
            or min(scales.values()) <= 0.0:
        raise RuntimeError(f"k2 {label}: kernel disagrees with its plain version: {row}")
    return row


def check_k5(label: str, args, time_it: bool, plain: bool) -> dict:
    """K5 against K1 on the same inputs: all four outputs bit-equal
    (torch.equal); with `plain`, also against the plain version under K1's
    criterion. Timed beside K1 with the same CUDA events."""
    import torch
    from gaussiangrasper_torch.ops import rasterize_cuda as rc

    got = rc.composite_pairs_fwd2(*args)
    k1 = rc._launch_kernel(*args)
    torch.cuda.synchronize()
    equal = [bool(torch.equal(a, b)) for a, b in zip(got, k1)]
    row = {"phase": "k5", "case": label, "tiles": int(args[1].shape[0]),
           "channels": int(args[3].shape[1] - 6), "pairs": int(args[2].sum()),
           "bit_equal_to_k1": dict(zip(("out", "alpha", "logt", "ncomp"), equal))}
    ok = all(equal) and all(bool(torch.isfinite(x).all()) for x in got)
    want = None
    if plain or time_it:
        want = rc.composite_pairs_fwd_plain(*args, count_live=True)
    if plain:
        err = max(float((a - b).abs().max()) for a, b in zip(got[:3], want[:3]))
        dn = (got[3] - want[3]).abs()
        row.update(max_abs_err=err, ncomp_diff_pixels=int((dn > 0).sum()),
                   ncomp_diff_max=float(dn.max()))
        ok = ok and err <= K1_ERR_MAX and float(dn.max()) <= 1 \
            and int((dn > 0).sum()) <= K1_NCOMP_SHARE_MAX * dn.numel()
    if time_it:
        row["ms"] = cuda_ms(lambda: rc._launch_kernel2(*args), 20)
        row["k1_ms"] = cuda_ms(lambda: rc._launch_kernel(*args), 20)
        row["plain_ms"] = cuda_ms(lambda: rc.composite_pairs_fwd_plain(*args), 3)
        row.update(k1_bound(args, want[3], want[4]))
        row.setdefault("max_abs_err", max(float((a - b).abs().max()) for a, b in zip(got[:3], want[:3])))
    emit(row)
    if not ok:
        raise RuntimeError(f"k5 {label}: K5 disagrees with K1 or the plain version: {row}")
    return row


def check_k6(label: str, k1_args, time_it: bool) -> dict:
    """K6 against K2 and against the plain version on the same inputs, with
    K2's criterion on the per-Gaussian sums; timed beside K2."""
    import torch
    from gaussiangrasper_torch.ops import rasterize_cuda as rc

    args = k2_inputs(k1_args, seed=5)
    got = per_gaussian(args, rc.composite_pairs_bwd2(*args))
    k2 = per_gaussian(args, rc._launch_bwd_kernel(*args))
    want = per_gaussian(args, rc.composite_pairs_bwd_plain(*args))
    torch.cuda.synchronize()
    c = args[3].shape[1] - 6
    errs_k2, _ = grad_errors(got, k2, c)
    errs, scales = grad_errors(got, want, c)
    row = {"phase": "k6", "case": label, "tiles": int(args[1].shape[0]), "channels": c,
           "pairs": int(args[2].sum()), "rel_err_vs_plain": errs, "rel_err_vs_k2": errs_k2,
           "scale": scales, "max_abs_err": float((got - want).abs().max()),
           "max_rel_err": max(max(errs.values()), max(errs_k2.values()))}
    if time_it:
        row["ms"] = cuda_ms(lambda: rc._launch_bwd_kernel2(*args), 20)
        row["k2_ms"] = cuda_ms(lambda: rc._launch_bwd_kernel(*args), 20)
        row["plain_ms"] = cuda_ms(lambda: rc.composite_pairs_bwd_plain(*args), 1)
        live = rc.composite_pairs_fwd_plain(*k1_args, count_live=True)[4]
        row.update(k2_bound(args, live))
    emit(row)
    if not bool(torch.isfinite(got).all()) or row["max_rel_err"] > K2_ERR_MAX \
            or min(scales.values()) <= 0.0:
        raise RuntimeError(f"k6 {label}: K6 disagrees with K2 or the plain version: {row}")
    return row


def table_inputs(field, alive, cam, cfg) -> dict:
    """K3's inputs on the table path for one view (counts, tables, bg, tw,
    ts), from bin_gaussians(build_table=True), with K1's on the pair stream
    of the same sort, tile_gidx, N and the bins."""
    import torch
    from gaussiangrasper_torch.models.model import render_inputs
    from gaussiangrasper_torch.ops import rasterize_cuda as rc
    from gaussiangrasper_torch.ops.rasterize import bin_gaussians, tile_grid

    proj, colors, opac, bg = render_inputs(field, alive, cam, STEP, cfg)
    bins = bin_gaussians(proj, cam.width, cam.height, cfg.raster, opacities=opac,
                         build_table=True, keep_pairs=True)
    k = bins.tile_gidx.shape[1]
    tw, _ = tile_grid(cam.width, cam.height, cfg.raster.tile_size)
    ts = cfg.raster.tile_size
    counts = torch.clamp(bins.tile_count, max=k).to(torch.int32).contiguous()
    tables = rc.gather_tables(bins.tile_gidx, proj.xys, proj.conics, opac, colors)
    starts, kcounts = rc.stream_bounds(bins.pair_gidx, bins.pair_starts, bins.tile_count, k)
    k1 = (bins.pair_gidx.int().contiguous(), starts, kcounts,
          rc.pack_attrs(proj.xys, proj.conics, opac, colors), bg, tw, ts)
    return {"t": (counts, tables, bg, tw, ts), "k1": k1, "gidx": bins.tile_gidx,
            "n": proj.xys.shape[0], "bins": bins}


def table_c3(inp: dict) -> dict:
    """The same table with only the rgb channels (C = 3)."""
    counts, tables, bg, tw, ts = inp["t"]
    return {**inp, "t": (counts, tables[..., :9].contiguous(), bg[:3].contiguous(), tw, ts),
            "k1": c3_inputs(inp["k1"])}


def no_clip(bins) -> None:
    """K3 = K1 and K4 ~ K2 need the table and the stream to hold the same
    rows: no K clip and no pair-budget clip."""
    if int(bins.overflow) or int(bins.pair_overflow):
        raise RuntimeError(f"overflow {int(bins.overflow)}, pair_overflow "
                           f"{int(bins.pair_overflow)}: the table and the stream differ")


def check_k3(label: str, inp: dict, time_it: bool, against_k1: bool) -> dict:
    """K3 against its plain version with K1's criterion; with `against_k1`,
    all four outputs bit-equal to K1's on the stream of the same sort, and
    timed beside K1."""
    import torch
    from gaussiangrasper_torch.ops import rasterize_cuda as rc

    targs = inp["t"]
    got = rc.composite_tables_fwd(*targs)
    want = rc.composite_tables_fwd_plain(*targs, count_live=True)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got[:3], want[:3]))
    dn = (got[3] - want[3]).abs()
    n_diff, dn_max = int((dn > 0).sum()), float(dn.max())
    row = {"phase": "k3", "case": label, "tiles": int(targs[0].shape[0]),
           "channels": int(targs[1].shape[2] - 6), "table_k": int(targs[1].shape[1]),
           "rows_walked": int(targs[0].sum()), "max_abs_err": err, "ncomp_diff_pixels": n_diff,
           "ncomp_diff_max": dn_max}
    ok = all(bool(torch.isfinite(x).all()) for x in got) and err <= K1_ERR_MAX and dn_max <= 1 \
        and n_diff <= K1_NCOMP_SHARE_MAX * dn.numel()
    if against_k1:
        no_clip(inp["bins"])
        k1 = rc._launch_kernel(*inp["k1"])
        torch.cuda.synchronize()
        equal = [bool(torch.equal(a, b)) for a, b in zip(got, k1)]
        row["bit_equal_to_k1"] = dict(zip(("out", "alpha", "logt", "ncomp"), equal))
        ok = ok and all(equal)
    if time_it:
        row["ms"] = cuda_ms(lambda: rc._launch_table_fwd(*targs), 20)
        if against_k1:
            row["k1_ms"] = cuda_ms(lambda: rc._launch_kernel(*inp["k1"]), 20)
        row["wrapper_ms"] = cuda_ms(lambda: rc.composite_tables_fwd(*targs), 20)
        row["plain_ms"] = cuda_ms(lambda: rc.composite_tables_fwd_plain(*targs), 3)
        row.update(k3_bound(targs, want[3], want[4]))
    emit(row)
    if not ok:
        raise RuntimeError(f"k3 {label}: K3 disagrees with its plain version or K1: {row}")
    return row


def check_k4(label: str, inp: dict, time_it: bool, against_k2: bool) -> dict:
    """K4 against its plain version on K3's own logt and ncomp, random g_out
    and g_alpha, with K2's criterion on the per-Gaussian sums; with
    `against_k2`, also against K2 on the stream of the same sort, fed the
    same upstream gradients (K1's logt / ncomp equal K3's there), and
    timed beside K2."""
    import torch
    from gaussiangrasper_torch.ops import rasterize_cuda as rc

    counts, tables, bg, tw, ts = inp["t"]
    _, alpha, logt, ncomp = rc._launch_table_fwd(*inp["t"])
    gen = torch.Generator(device=tables.device).manual_seed(5)
    g_out = torch.randn(*alpha.shape, tables.shape[2] - 6, generator=gen, device=tables.device)
    g_alpha = torch.randn(alpha.shape, generator=gen, device=tables.device)
    bargs = (counts, tables, bg, g_out, g_alpha, logt, ncomp, tw, ts)
    gidx, n, c = inp["gidx"], inp["n"], tables.shape[2] - 6
    got = rc.scatter_table(gidx, n, rc.composite_tables_bwd(*bargs))
    want = rc.scatter_table(gidx, n, rc.composite_tables_bwd_plain(*bargs))
    torch.cuda.synchronize()
    errs, scales = grad_errors(got, want, c)
    row = {"phase": "k4", "case": label, "tiles": int(counts.shape[0]), "channels": c,
           "rows_walked": int(counts.sum()), "rel_err_vs_plain": errs, "scale": scales,
           "max_abs_err": float((got - want).abs().max())}
    worst = max(errs.values())
    if against_k2:
        no_clip(inp["bins"])
        k2args = inp["k1"][:5] + (g_out, g_alpha, logt, ncomp) + inp["k1"][5:]
        k2 = per_gaussian(k2args, rc._launch_bwd_kernel(*k2args))
        torch.cuda.synchronize()
        errs_k2, _ = grad_errors(got, k2, c)
        row["rel_err_vs_k2"] = errs_k2
        worst = max(worst, max(errs_k2.values()))
    row["max_rel_err"] = worst
    if time_it:
        row["ms"] = cuda_ms(lambda: rc._launch_table_bwd(*bargs), 20)
        if against_k2:
            row["k2_ms"] = cuda_ms(lambda: rc._launch_bwd_kernel(*k2args), 20)
        row["wrapper_ms"] = cuda_ms(lambda: rc.composite_tables_bwd(*bargs), 20)
        row["plain_ms"] = cuda_ms(lambda: rc.composite_tables_bwd_plain(*bargs), 1)
        live = rc.composite_tables_fwd_plain(*inp["t"], count_live=True)[4]
        row.update(k4_bound(bargs, live))
    emit(row)
    if not bool(torch.isfinite(got).all()) or worst > K2_ERR_MAX or min(scales.values()) <= 0.0:
        raise RuntimeError(f"k4 {label}: K4 disagrees with its plain version or K2: {row}")
    return row


def table_compositor(proj, colors, opacities, background, width, height, config):
    """The table path as a `compositor` for render / train_loss: bin with
    the (T, K) table, then rasterize_projected(bins=...), which routes the
    table to composite_binned (K3 / K4)."""
    from gaussiangrasper_torch.ops.rasterize import bin_gaussians, rasterize_projected

    bins = bin_gaussians(proj, width, height, config, opacities=opacities.detach(),
                         build_table=True)
    return rasterize_projected(proj, colors, opacities, background, width, height, config,
                               bins=bins)


TABLE_RENDERS, TABLE_ITERS = 5, 20


def table_phase(device, cfg) -> dict:
    """The table path at full width, beside the pair path in the same phase:
    renders of the bench field at 800x800, then TABLE_ITERS iterations of
    train_loss + backward at the train phase's point, the two paths in
    turn."""
    import torch
    from gaussiangrasper_torch.models.gaussian_field import GaussianParams
    from gaussiangrasper_torch.models.model import render, train_loss
    from gaussiangrasper_torch.ops import rasterize_cuda as rc

    kernels = {"k3": rc.composite_tables_fwd, "k4": rc.composite_tables_bwd,
               "k1": rc.composite_pairs_fwd, "k2": rc.composite_pairs_bwd}
    paths = {"table": table_compositor, "pairs": None}

    def reset():
        for k in kernels.values():
            k.launches = 0

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    field, alive = bench_field(N_FULL, seed=0, device=device)
    cam = bench_camera(WIDTH, HEIGHT, device)
    render_ms = {p: [] for p in paths}
    reset()
    with torch.no_grad():
        for _ in range(TABLE_RENDERS):
            outs = {}
            for p, comp in paths.items():
                outs[p], ms = timed(lambda: render(field, alive, cam, STEP, cfg, compositor=comp))
                render_ms[p].append(ms)
    render_launches = {n: k.launches for n, k in kernels.items()}
    tb, pb = outs["table"]["bins"], outs["pairs"]["bins"]
    if int(tb.overflow) or int(pb.pair_overflow) or tb.pair_gidx is not None:
        raise RuntimeError(f"table render: overflow {int(tb.overflow)}, pair_overflow "
                           f"{int(pb.pair_overflow)}")
    images_equal = all(bool(torch.equal(outs["table"][k], outs["pairs"][k]))
                       for k in ("rgb", "feature", "depth", "normal", "alpha"))
    del field, alive, outs

    state = train_state_at(N_FULL, CAPACITY, seed=0, device=device)
    batch = train_batch(WIDTH, HEIGHT, 32, 800, 1000, seed=8, device=device)

    def iteration(comp):
        fld = GaussianParams(*(x.detach().requires_grad_(True) for x in state.field))
        fea_up = {k: v.detach().requires_grad_(True) for k, v in state.fea_up.items()}
        probe = torch.zeros(state.field.capacity, 2, device=device, requires_grad=True)
        total, aux = train_loss({"field": fld, "fea_up": fea_up}, state.alive, cam, batch,
                                state.step, cfg, probe=probe, compositor=comp)
        grads = torch.autograd.grad(total, list(fld) + [probe])
        return total.detach(), aux, grads

    iter_ms = {p: [] for p in paths}
    first = {}
    reset()
    for i in range(TABLE_ITERS):
        for p, comp in paths.items():
            res, ms = timed(lambda: iteration(comp))
            iter_ms[p].append(ms)
            if i == 0:
                first[p] = res
    launches = {n: k.launches for n, k in kernels.items()}
    (lt, auxt, gt), (lp, auxp, gp) = first["table"], first["pairs"]
    if int(auxp["overflow"]) or int(auxp["pair_overflow"]) or int(auxt["overflow"]):
        raise RuntimeError("table train: overflow or pair_overflow at the train point")
    # one traced iteration of each path: device time, which the host's spread does not move
    profiles = {p: device_profile(lambda: iteration(comp), top=6) for p, comp in paths.items()}
    names = list(GaussianParams._fields) + ["probe"]
    grad_err = {n: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for n, a, b in zip(names, gt, gp)}
    row = {"phase": "table", "gaussians": N_FULL, "capacity": CAPACITY, "width": WIDTH,
           "height": HEIGHT, "channels": cfg.num_channels,
           "table_k": int(tb.tile_gidx.shape[1]), "render_launches": render_launches,
           "render_ms_per_view": {p: float(np.median(v[1:])) for p, v in render_ms.items()},
           "render_images_bit_equal": images_equal, "iterations": TABLE_ITERS,
           "train_launches": launches,
           "train_loss_fwd_bwd_ms": {p: float(np.median(v[1:])) for p, v in iter_ms.items()},
           "train_loss_ms_all": iter_ms, "train_loss_profile": profiles,
           "step0_loss": [float(lt), float(lp)],
           "step0_loss_bit_equal": bool(torch.equal(lt, lp)), "grad_rel_err_vs_pairs": grad_err,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    row["table_extra_ms_per_iteration"] = \
        row["train_loss_fwd_bwd_ms"]["table"] - row["train_loss_fwd_bwd_ms"]["pairs"]
    row["table_extra_device_ms_per_iteration"] = \
        profiles["table"]["device_busy_ms"] - profiles["pairs"]["device_busy_ms"]
    emit(row)
    want_render = {"k3": TABLE_RENDERS, "k4": 0, "k1": TABLE_RENDERS, "k2": 0}
    want_train = {"k3": TABLE_ITERS, "k4": TABLE_ITERS, "k1": TABLE_ITERS, "k2": TABLE_ITERS}
    if render_launches != want_render or launches != want_train:
        raise RuntimeError(f"table: launches {render_launches} / {launches}, want "
                           f"{want_render} / {want_train}")
    if not images_equal or not row["step0_loss_bit_equal"] or max(grad_err.values()) > K2_ERR_MAX \
            or not all(bool(torch.isfinite(g).all()) for g in gt):
        raise RuntimeError(f"table: the table path disagrees with the pair path: {row}")
    return row


def probes_phase(device) -> dict:
    """Both probe entry points in-process, then each probe kernel against
    its plain version on the card (exact) and timed."""
    import torch
    from gaussiangrasper_torch.ops import rasterize_cuda as rc
    from gaussiangrasper_torch.probes import copy_probe, kernel_probe
    from gaussiangrasper_torch.probes import kernels as pk

    kernels = {"p1": pk.affine, "p2": pk.read_at, "p3": pk.write_at,
               "k3": rc.composite_tables_fwd}
    for k in kernels.values():
        k.launches = 0
    rcs = {"kernel_probe": kernel_probe.main([]), "copy_probe": copy_probe.main([])}
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in kernels.items()}
    if any(rcs.values()) or launches != {"p1": 1, "p2": 2, "p3": 1, "k3": 3}:
        raise RuntimeError(f"probes: exit codes {rcs}, launches {launches}")

    x = torch.arange(8 * 128, dtype=torch.float32, device=device).reshape(8, 128) - 300.5
    src = torch.arange(4096 * 128, dtype=torch.float32, device=device).reshape(4096, 128)
    rstarts = torch.tensor([3, 77, 1001], dtype=torch.int32, device=device)
    vals = torch.randn(3, 128, 128, generator=torch.Generator(device=device).manual_seed(9),
                       device=device)
    wstarts = torch.tensor([0, 100, 200], dtype=torch.int32, device=device)
    covered = pk.covered_rows(wstarts, 512).to(device)
    one = torch.ones((), device=device)
    windows = src.unfold(0, 128, 1).mT  # windows[s] = rows [s, s + 128) of src
    rstarts_long = rstarts.long()
    # compulsory words: inputs read once, outputs written once; P3 reads and
    # writes only the covered rows, each from the block that wins it
    cases = {
        "p1": (lambda: pk._launch_affine(x), lambda: pk.affine_plain(x),
               lambda: torch.add(one, x, alpha=2.0), 2 * x.numel()),
        "p2": (lambda: pk._launch_read_at(src, rstarts), lambda: pk.read_at_plain(src, rstarts),
               lambda: windows[rstarts_long], 2 * 3 * 128 * 128 + 3),
        "p3": (lambda: pk._launch_write_at(vals, wstarts, 512),
               lambda: pk.write_at_plain(vals, wstarts, 512), None,
               2 * int(covered.sum()) * 128 + 3),
    }
    rows = {}
    for name, (kernel, plain, library, words) in cases.items():
        got, want = kernel(), plain()
        lib_equal = library is None or bool(torch.equal(library(), want))
        torch.cuda.synchronize()
        if name == "p3":
            got, want = got[covered], want[covered]
        r = {"max_abs_err": float((got - want).abs().max()), "equal": bool(torch.equal(got, want)),
             "library_equal": lib_equal, "ms": device_ms(kernel, 50),
             "plain_ms": device_ms(plain, 20),
             "library_ms": device_ms(library, 50) if library else None,
             "host_ms": cuda_ms(kernel, 50)}
        r["us"] = 1e3 * r["ms"]
        r.update(roofline(0.0, 4.0 * words))
        rows[name] = r
    row = {"phase": "probes", "exit_codes": rcs, "launches": launches, **rows}
    emit(row)
    if not all(r["equal"] and r["library_equal"] and r["ms"] > 0 for r in rows.values()):
        raise RuntimeError(f"probes: a probe kernel or library call disagrees with the plain "
                           f"version, or the profiler saw no device time: {row}")
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


def trainer_phase(scene: Path, label: str, tp: int) -> dict:
    """The training CLI in-process on the tabletop, then the render CLI on
    the run. A shim around train_state.train_step / refine_step times each
    step between two synchronizations and records losses and alive counts;
    it is this script's instrument, not the trainer's."""
    import torch
    from gaussiangrasper_torch.engine import train_state
    from gaussiangrasper_torch.ops import rasterize_cuda as rc
    from gaussiangrasper_torch.scripts import render, train

    steps, refines = [], []
    train_step, refine_step = train_state.train_step, train_state.refine_step

    def timed_step(state, cam, batch, cfg, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_step(state, cam, batch, cfg, *a, **k)
        torch.cuda.synchronize()
        steps.append((cam.width, 1e3 * (time.perf_counter() - t0),
                      float(out[1]["loss"]), float(out[1]["psnr"])))
        return out

    def counted_refine(state, *a, **k):
        new = refine_step(state, *a, **k)
        refines.append([state.step, int(state.alive.sum()), int(new.alive.sum())])
        return new

    kernels = (rc.composite_pairs_fwd, rc.composite_pairs_bwd, rc.composite_pairs_fwd2,
               rc.composite_pairs_bwd2)
    names = ("k1", "k2", "k5", "k6")
    with tempfile.TemporaryDirectory() as tmp:
        rc.TP = tp
        train_state.train_step, train_state.refine_step = timed_step, counted_refine
        torch.cuda.reset_peak_memory_stats()
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        try:
            trainer = train.main(["--data", str(scene), "--max-iterations", str(TRAINER_STEPS),
                                  "--capacity", str(CAPACITY), "--steps-per-save",
                                  str(TRAINER_STEPS), "--output-dir", tmp])
            torch.cuda.synchronize()
        finally:
            train_state.train_step, train_state.refine_step = train_step, refine_step
            rc.TP = 1
        wall_s = time.perf_counter() - t0
        launches = dict(zip(names, (k.launches for k in kernels)))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        run = Path(tmp) / "gaussian-splatting"
        render.main(["--run-dir", str(run), "--num-views", "2"])
        torch.cuda.synchronize()
        render_launches = {n: k.launches - launches[n] for n, k in zip(names, kernels)}
        metrics = json.loads((run / "renders" / "metrics.json").read_text())["results"]
        # one more full-resolution step of the trained state through the
        # same kernels, traced
        rc.TP = tp
        try:
            cam, batch = trainer.dm.get_batch(0)
            cfg = trainer.config.model
            profile = device_profile(lambda: train_step(trainer.state, cam, batch, cfg), top=10)
            t0 = time.perf_counter()
            train_step(trainer.state, cam, batch, cfg)
            torch.cuda.synchronize()
            profile["step_ms"] = 1e3 * (time.perf_counter() - t0)
        finally:
            rc.TP = 1
    by_width = {w: [ms for w2, ms, _, _ in steps if w2 == w] for w in (WIDTH // 2, WIDTH)}
    ms = {f"{w}x{w}": float(np.median(v)) for w, v in by_width.items()}
    losses = [loss for _, _, loss, _ in steps]
    row = {"phase": label, "tp": tp, "steps": len(steps), "seed_points": TRAINER_SCENE["seed_points"],
           "capacity": CAPACITY, "channels": trainer.config.model.num_channels,
           "launches_train": launches, "launches_render": render_launches,
           "ms_per_step_median": ms, "steps_at": {k: len(v) for k, v in zip(ms, by_width.values())},
           "px_per_s_800x800": WIDTH * HEIGHT / (ms[f"{WIDTH}x{HEIGHT}"] / 1e3),
           "data_wait_ms_mean": 1e3 * float(np.mean(trainer.data_wait_s)),
           "wall_s": wall_s, "loss_first_last": [losses[0], losses[-1]],
           "psnr_first_last": [steps[0][3], steps[-1][3]],
           "loss_every_50": losses[::50], "refine_step_alive_before_after": refines,
           "peak_mem_gb": peak_gb, "sampler_branch": trainer.dm.sampler_branch,
           "render_metrics": {k: metrics[k] for k in ("psnr", "ssim", "psnr_masked") if k in metrics},
           "train_profile": profile, "losses": losses}
    row["device_idle_share"] = 1.0 - profile["device_busy_ms"] / profile["step_ms"]
    emit({k: v for k, v in row.items() if k != "losses"})
    want = {"k1": 0, "k2": 0, "k5": TRAINER_STEPS, "k6": TRAINER_STEPS} if tp == 2 else \
        {"k1": TRAINER_STEPS, "k2": TRAINER_STEPS, "k5": 0, "k6": 0}
    if launches != want:
        raise RuntimeError(f"{label}: launches {launches}, want {want}")
    if render_launches != {"k1": 2, "k2": 0, "k5": 0, "k6": 0}:
        raise RuntimeError(f"{label}: render launches {render_launches}")
    if len(steps) != TRAINER_STEPS or not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0] or len(refines) != TRAINER_STEPS // 100:
        raise RuntimeError(f"{label}: {len(steps)} steps, losses {losses[::50]}, refines {refines}")
    if not all(math.isfinite(v) for v in row["render_metrics"].values()):
        raise RuntimeError(f"{label}: render metrics {row['render_metrics']}")
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
    from gaussiangrasper_torch import native
    from gaussiangrasper_torch.models.model import GaussianSplatConfig
    from gaussiangrasper_torch.ops import rasterize_cuda as rc

    card = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": card, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    reports = _build.build_all()
    ptxas = {name: [ln.strip() for ln in text.splitlines()
                    if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
             for name, text in reports.items()}
    sampler = native.branch()
    clusters = {f"{k}_c{c}": rc.max_active_clusters(k, c, 32) for k in ("fwd2", "bwd2")
                for c in rc.KERNEL_CHANNELS}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas,
          "sampler_branch": sampler, "sampler_library": str(native.LIB_PATH.relative_to(ROOT)),
          "max_active_clusters": clusters})
    if min(clusters.values()) == 0:
        raise RuntimeError(f"no cluster of K5 / K6 fits on this card: {clusters}")

    device = torch.device("cuda")
    cfg = GaussianSplatConfig()
    field, alive = bench_field(N_FULL, seed=0, device=device)
    with torch.no_grad():
        cam_mid = bench_camera(400, 300, device)
        mid39 = k1_inputs(field, alive, cam_mid, cfg)
        check_k1("mid_c39", mid39, time_it=False)
        mid3 = c3_inputs(mid39)
        check_k1("mid_c3", mid3, time_it=False)
        full_args = k1_inputs(field, alive, bench_camera(WIDTH, HEIGHT, device), cfg)
        full = check_k1("full_width_c39", full_args, time_it=True)
        check_k2("mid_c39", mid39, time_it=False)
        check_k2("mid_c3", mid3, time_it=False)
        full2 = check_k2("full_width_c39", full_args, time_it=True)
        odd39 = k1_inputs(field, alive, bench_camera(400, 288, device), cfg)  # 13 x 9 tiles
        odd3 = c3_inputs(odd39)
        check_k5("mid_odd_c39", odd39, time_it=False, plain=True)
        check_k5("mid_odd_c3", odd3, time_it=False, plain=True)
        full5 = check_k5("full_width_c39", full_args, time_it=True, plain=False)
        check_k6("mid_odd_c39", odd39, time_it=False)
        check_k6("mid_odd_c3", odd3, time_it=False)
        full6 = check_k6("full_width_c39", full_args, time_it=True)
        del mid39, mid3, full_args, odd39, odd3
        tmid39 = table_inputs(field, alive, cam_mid, cfg)
        tmid3 = table_c3(tmid39)
        tfull = table_inputs(field, alive, bench_camera(WIDTH, HEIGHT, device), cfg)
        check_k3("mid_c39", tmid39, time_it=False, against_k1=False)
        check_k3("mid_c3", tmid3, time_it=False, against_k1=False)
        full3 = check_k3("full_width_c39", tfull, time_it=True, against_k1=True)
        check_k4("mid_c39", tmid39, time_it=False, against_k2=False)
        check_k4("mid_c3", tmid3, time_it=False, against_k2=False)
        full4 = check_k4("full_width_c39", tfull, time_it=True, against_k2=True)
    del field, alive, tmid39, tmid3, tfull
    render_small_phase(cfg)
    serve = serve_phase(device, cfg)
    train_small_phase(cfg)
    train = train_phase(device, cfg)
    table = table_phase(device, cfg)
    probes = probes_phase(device)
    with tempfile.TemporaryDirectory() as tmp:
        from gaussiangrasper_torch.data.synthetic import generate_tabletop

        t0 = time.perf_counter()
        scene = generate_tabletop(Path(tmp) / "tabletop", **TRAINER_SCENE)
        emit({"phase": "trainer_data", "seconds": time.perf_counter() - t0, **TRAINER_SCENE})
        trainer = trainer_phase(scene, "trainer", tp=1)
        trainer2 = trainer_phase(scene, "trainer_tp2", tp=2)
    l1, l2 = trainer["losses"], trainer2["losses"]
    drift = [abs(a - b) / abs(b) for a, b in zip(l2, l1)]
    emit({"phase": "trainer_tp2_vs_trainer", "step0_loss": [l1[0], l2[0]],
          "last_loss": [l1[-1], l2[-1]], "rel_drift_at_step": {str(i): drift[i] for i in
                                                               (0, 1, 10, 100, 250, len(drift) - 1)},
          "max_rel_drift": max(drift)})
    if drift[0] > 1e-6:
        raise RuntimeError(f"trainer_tp2: step-0 loss {l2[0]} != {l1[0]}")

    def kernel_row(name, source, replaces, row, launches):
        return {"name": name, "route": "cuda", "source": f"gaussiangrasper_torch/csrc/{source}.cu",
                "replaces": replaces, "launches": sum(launches.values()),
                "launches_by_path": launches, "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "wrapper_ms": row.get("wrapper_ms"), "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row.get("library_ms")}

    emit({"kernels": [
        kernel_row("composite_pairs_fwd", "composite_pairs_fwd",
                   "rasterize_pallas.py:490 (_fwd_pairs_kernel)", full,
                   {"serve": serve["k1_launches"], "train": train["launches"]["k1"],
                    "trainer": trainer["launches_train"]["k1"],
                    "trainer_render": trainer["launches_render"]["k1"],
                    "trainer_tp2_render": trainer2["launches_render"]["k1"],
                    "table_phase_pair_render": table["render_launches"]["k1"],
                    "table_phase_pair_train": table["train_launches"]["k1"]}),
        kernel_row("composite_pairs_bwd", "composite_pairs_bwd",
                   "rasterize_pallas.py:600 (_bwd_pairs_kernel)", full2,
                   {"train": train["launches"]["k2"], "trainer": trainer["launches_train"]["k2"],
                    "table_phase_pair_train": table["train_launches"]["k2"]}),
        kernel_row("composite_pairs_fwd2", "composite_pairs_fwd",
                   "rasterize_pallas.py:1059 (_fwd_pairs2_kernel)", full5,
                   {"trainer_tp2": trainer2["launches_train"]["k5"]}),
        kernel_row("composite_pairs_bwd2", "composite_pairs_bwd",
                   "rasterize_pallas.py:1189 (_bwd_pairs2_kernel)", full6,
                   {"trainer_tp2": trainer2["launches_train"]["k6"]}),
        kernel_row("composite_tables_fwd", "composite_pairs_fwd",
                   "rasterize_pallas.py:160 (_fwd_kernel)", full3,
                   {"table_render": table["render_launches"]["k3"],
                    "table_train": table["train_launches"]["k3"],
                    "kernel_probe": probes["launches"]["k3"]}),
        kernel_row("composite_tables_bwd", "composite_pairs_bwd",
                   "rasterize_pallas.py:206 (_bwd_kernel)", full4,
                   {"table_train": table["train_launches"]["k4"]}),
        kernel_row("probe_affine", "probes", "pallas_probe.py:38 (kernel)",
                   probes["p1"], {"kernel_probe": probes["launches"]["p1"]}),
        kernel_row("probe_read_at", "probes", "dma_probe.py:37 (_read_kernel)",
                   probes["p2"], {"copy_probe": probes["launches"]["p2"]}),
        kernel_row("probe_write_at", "probes", "dma_probe.py:65 (_write_kernel)",
                   probes["p3"], {"copy_probe": probes["launches"]["p3"]}),
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def c3_inputs(args):
    """The same stream with only the rgb channels (C = 3)."""
    import torch

    c3 = list(args)
    c3[3] = torch.cat([c3[3][:, :6], c3[3][:, 6:9]], 1).contiguous()
    c3[4] = c3[4][:3].contiguous()
    return tuple(c3)


def bench_camera(width: int, height: int, device):
    """bench.py's camera scaled to width x height: f = 1000 * width / 800,
    at the origin looking down -z."""
    from gaussiangrasper_torch.core.cameras import Camera

    f = 1000.0 * width / WIDTH
    return Camera.create(f, f, width / 2, height / 2, np.eye(4, dtype=np.float32)[:3],
                         width, height, device=device)


if __name__ == "__main__":
    sys.exit(main())
