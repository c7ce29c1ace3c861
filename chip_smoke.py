#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's serving and training paths on one
NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, one JSON line each:
  device   the card (nvidia-smi name and power limit), torch and CUDA versions
  build    nvcc of every kernel in gaussiangrasper_torch/csrc and g++ of the native
           sampler, all into gaussiangrasper_torch/build (seconds, ptxas report, the
           sampler's branch, how many clusters of K5 and K6 the card holds, the
           forward body's dynamic shared memory a CTA)
  k1       the forward kernel against its plain PyTorch version on the card, at
           a mid size (C 39, C 3, and C 23 through the wrapper's zero padding)
           and at full width (200k Gaussians, 800x800, C = 39, and C = 71, F 64:
           two channel pieces, two launches a call): errors, kernel
           and plain times, the roofline bound on the visits the kernel's cull
           keeps (beside bound_all_visits_ms, every visit charged), and the work
           in warp x row pairs (warp_rows walked, live_warp_rows with a lane that
           composites, kept_warp_rows that the cull keeps, the colour products)
           with the SM clocks the kernel spends a live warp-row
  k2       the backward kernel against its plain version on K1's own logt
           and ncomp, random g_out and a nonzero g_alpha, at mid size (C 39,
           C 3 and C 23) and full width (C 39 and 71): errors of the per-Gaussian sums,
           kernel and plain times, the roofline bound, and the work in warp
           x row pairs (warp_rows walked, live_warp_rows with a live lane)
           with the SM clocks the kernel spends a live warp-row
  dense_tile  K1 on two dense tiles (2048 live rows a pixel, |out| ~4, where
           truncated colour sums err most) against its plain version with K1's
           criterion, the bias of its error, K5 and K3 on the same rows
           bit-equal to K1, K1's time there
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
           profiler over 50 calls (CUDA events around one call time the host);
           then P1 on 2^26 floats and P3 on 2048 overlapping blocks into 2^17
           rows, where bytes decide (p1_large, p3_large: exact, timed over 20
           calls, with the bound and its share); the allocator's cache is
           emptied after it, before the trainers
  train    the full-width train step (bench field grown to capacity 400k,
           bench camera, bench batch shapes, seeded fea_up), steps 4000 to
           4099 and a refine step with every launch count set to 0 just
           before and read just after; ms per step, px/s, a profile
  segment  the classic segmentation backend (`python -m
           gaussiangrasper_torch.scripts.segment`) on a copy of trainer's
           800x800, 8-view tabletop without its masks: ms and instances a
           view on the card, views 0-1 bit-equal to the CPU path from the
           same generator state, then `ggt-torch-train` 20 steps on the
           segmented copy (finite step-0 loss, positive contrastive term,
           K1 / K2 launches from 0, `segment_train` in the kernels line)
  sam_clip  SAM and CLIP's text tower as the port's own modules, seeded
           random weights at the published widths written as hub snapshots
           (HF_HUB_CACHE): `segment --backend sam` on a two-view 800x800
           tabletop, view 0's image embedding, mask logits and IoU scores on
           the card against this machine's CPU, its masks pixel for pixel
           but near-zero logits; `ggt-torch-train` 20 steps on the SAM masks;
           `ggt-torch-query --text` with two prompts on two views; the text
           features card against CPU; the encoder's, a view's and a prompt
           batch's times beside the card's name and power limit
  trainer  the training CLI (`ggt-torch-train`) on an 800x800, 8-view
           ray-traced tabletop with 200k seed points: 300 steps (250 at
           400x400, 50 at 800x800), refines at steps 100, 200, 300, capacity
           400k, C = 39, then the render CLI on the run; every launch count
           set to 0 just before; ms per step at each resolution, px/s, the
           wait on the data path, losses, alive counts, peak memory, a profile
  trainer_tp2  the same run with rasterize_cuda.TP = 2 (K5 / K6): its
           step-0 loss equal to trainer's, and how far the runs drift apart
  edit     the paper's last steps on trainer's run, each CLI in-process with
           every launch count set to 0 just before and read just after:
           grasp (sphere 1's synthetic CLIP vector against the other three),
           project_hull, update (sphere 1 moved, the after capture at
           trainer's settings, 580 fine-tune steps through K1 / K2, each
           timed), export_ply, export_pointcloud --mesh over the 8 views and
           export_texture (the CLI's defaults) on the edited run; seconds a
           CLI, Gaussians moved, ms per step at each resolution, the grasp's
           distance from sphere 1 in radii, PSNR on after-view 0 of the
           pre-edit and the edited state, the exports' counts; the grasp
           must launch V1 (csrc/voxel_cluster.cu) once
  e2e_small  tests/test_e2e_tabletop.py's setting (64x64, 6 views, 300 steps,
           feature 16, then 80 update iterations) on the card with that
           test's bars, each failing it; the grasp's bar (within 3 radii of
           sphere 1) over the first five of the ten trainer seeds, each a
           train and a grasp: no more of them may miss it than miss it in
           the JAX package at those seeds (ROADMAP.md queue 3, F4); each
           grasp must launch V1 once
  capture  trainer's tabletop rewritten through an OPENCV lens (k1 -0.08,
           k2 0.02, p1 5e-4, p2 -5e-4; `distort_frame` on the host), the
           poses of views 1-7 moved by 0.5 degrees and 5 mm, trained by
           `Trainer` with pose_opt_mode "SO3xR3" at trainer's settings:
           undistortion ms a view, the new K, view 0 undistorted on the
           card against the CPU path (bit-equal), ms a step beside
           trainer's, losses, the pose deltas after steps 99 / 199 / 299,
           K1 / K2 launches from 0
  pose     tests/test_pose_opt.py's recovery at full width (the bench
           field and camera) in SO3xR3 and SE3 with that test's bar, the
           residual rotation and translation; the first step's delta
           gradient on a mid-size field, card against the CPU path, within
           POSE_GRAD_RTOL / POSE_GRAD_COS_MIN
  sharded_split  the tile-sharded compositor split four ways in one process
           at full width (the bench field and camera, C 39): shard halves,
           torch.cat for the all-gathers, band halves through K1 / K2;
           image and alpha bit-equal to rasterize_projected's, per-Gaussian
           gradients within K2's criterion, the gather stats, each band's
           stream rows, K1 / K2 launches (four each), the split's render
           and backward ms beside the unsharded path's
  sharded_train  `ggt-torch-train --mesh 1,1 --tile-shard on` (a real NCCL
           world of one rank) on trainer's tabletop for 200 steps (refines
           at 100 and 200, the gather budget derived again after each),
           then the render CLI on the run: step-0 loss beside trainer's
           (within STEP0_LOSS_RTOL), ms per step beside trainer's, the
           gather stats after each refine, 200 K1 + 200 K2 launches
  multi_scene  `ggt-torch-train --data <tabletop> <edit's post-move
           capture>` for 200 steps with the shared fea_up: each scene's
           step-0 loss beside a single-scene Trainer's (within
           STEP0_LOSS_RTOL), fea_up equal across the scenes, ms per step,
           400 K1 + 400 K2 launches, both scene checkpoints rendered
  tools    the capture and viewing tools on trainer's run and tabletop, each
           with every launch count set to 0 just before: `ggt-torch-render
           --traj interpolate` (6 x 7 + 1 frames) and `--traj spiral` (16),
           each frame equal to a direct render of its path camera;
           `ggt-torch-train --profiler trace` for 20 steps (the Chrome
           trace's step ranges 12..16, K1 / K2 kernels in it, its top 5
           kernels); the viewer over the run's state on an ephemeral port
           (/scene, /render in four modes at 320x240 and 800x600, the rgb
           frame within JPEG q85's error of a direct render, a crop box
           hiding half the scene, /render_path of 8 frames, /export.ply),
           then `ggt-torch-train --viewer-port` for 30 steps with a client
           asking a frame every 100 ms (step-0 loss equal to trainer's, the
           renders' share of wall time); `ggt-torch-generate-data` on the
           tabletop's views as an RGB-D capture (the cloud's size, the
           normals against the ray tracer's, the result parsed and trained
           20 steps); a seeded 1024x512 panorama's 8 crops on the card
           against the CPU path, bit-equal, ms a crop
  hash_grid  csrc/hash_grid.cu at nerfacto-train-800's three lookups a step
           (4096 rays of 256, 96 and 48 samples; 5, 5 and 16 levels): each
           kernel's ms, a lookup's forward and backward by the kernels (launch
           counts set to 0 just before: one of each) and by the plain path,
           errors against the plain path, bytes bounds; at the field's lookup
           the double backward (neus-facto's) against the plain path's
  voxel_cluster  csrc/voxel_cluster.cu at efd-grasp-query's shape (the 10,000
           Gaussians of a 200k-point field nearest a seeded centre, 0.02 voxels):
           the kernels' roots equal to the host union-find's, the kernels' ms
           (CUDA events), `largest_component` and `grasp.largest_cluster` on the
           card (host clock, the copies in), the host union-find's ms
  pixel_gather  (after train) csrc/pixel_gather.cu at efd-train-800's shape (the 32-channel
           slice of an 800x800x39 image, 52,200 rows of which 44,800 pad at
           (0, 0)): the forward bit-equal to the plain index, both paths'
           gradients against a float64 sum, one launch of each kernel; each
           kernel's ms, the pair's forward plus backward beside the plain
           path's and index_select / index_add_'s, the bytes bound
Then the kernels line (fourteen rows: the nine TPU kernels' ports, the
three hash-grid kernels, H1-H3, whose launches by path come from the
nerf_zoo CLIs and the hash_grid phase, the voxel labelling, V1, whose
launches come from edit's and e2e_small's grasp CLIs and its own phase, and
the pixel gather pair, G1, launched by the train phase and its own), the
nvidia-smi line and, last, the ok line. Any
failure exits non-zero without the ok line. Without a card, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

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


KERNELS = {"k1": "ggt_composite_pairs_fwd", "k2": "ggt_composite_pairs_bwd",
           "k3": "ggt_composite_tables_fwd", "k4": "ggt_composite_tables_bwd",
           "k5": "ggt_composite_pairs_fwd2", "k6": "ggt_composite_pairs_bwd2",
           "p1": "ggt_probe_affine", "p2": "ggt_probe_read_at", "p3": "ggt_probe_write_at",
           "h1": "ggt_hash_grid_fwd", "h2": "ggt_hash_grid_bwd", "h3": "ggt_hash_grid_bwd2",
           "v1": "ggt_voxel_cluster", "g1": "ggt_pixel_gather_fwd", "g2": "ggt_pixel_gather_bwd"}
"""This script's short names of the kernels, and the C entry by which the
port's launch counter (`gaussiangrasper_torch._build.launches`) counts
each one's launches."""
COMPOSITORS = ("k1", "k2", "k5", "k6")
HASH_KERNELS = ("h1", "h2", "h3")


def reset_launches() -> None:
    """Every launch count set to 0."""
    from gaussiangrasper_torch._build import launches

    launches.clear()


def launch_counts(*names: str) -> dict:
    """The launch counts of the kernels `names` (KERNELS' short names)."""
    from gaussiangrasper_torch._build import launches

    return {n: launches[KERNELS[n]] for n in names}


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


def walk_ops(work: dict, n_live: float, c: int):
    """(operations outside the tensor cores, colour products on them) of the
    forward walk on these inputs as the kernel's per-warp cull leaves it
    (`composite_pairs_fwd_plain(count_warp_rows=True)`): the visits of
    walking lanes in the rows their warp keeps, the box tests, and the
    composited visits."""
    # per kept visit: dx, dy, sigma (9), exp, o*exp, min, two tests = 16; per box test: four
    # adds and four compares = 8; per composited live visit: log1p, cum add, test, exp, w,
    # logt add = 6, and the 2C flops of its colour terms, which the kernels take on the tensor
    # cores
    ops = 16.0 * work["kept_visits"] + 8.0 * work["box_tests"] + 6.0 * n_live
    return ops, 2.0 * c * n_live


def all_visits_bound(counts, ncomp, n_live: float, c: int) -> dict:
    """The bound with every pair-pixel visit up to each pixel's cut
    charged its 16 operations, as if no visit could be left out: the
    colour products at the 3xTF32 rate, the rest at the f32 peak."""
    import torch

    cnt = counts.double()[:, None].expand_as(ncomp)
    visits = float(torch.where(ncomp < cnt, ncomp.double() + 1.0, cnt).sum())
    t_ops = (16.0 * visits + 6.0 * n_live) / F32_PEAK_FLOPS + 2.0 * c * n_live / TF32X3_PEAK_FLOPS
    return {"bound_all_visits_ms": 1e3 * t_ops, "visits": visits}


def fwd_bound(counts, ncomp, live, work: dict, c: int, nbytes: float) -> dict:
    n_live = float(live.double().sum())
    ops, tc_ops = walk_ops(work, n_live, c)
    return roofline(ops, nbytes, tc_ops, **all_visits_bound(counts, ncomp, n_live, c),
                    kept_visits=float(work["kept_visits"]), box_tests=float(work["box_tests"]),
                    live_visits=n_live)


def k1_bound(args, ncomp, live, work: dict) -> dict:
    """Least time for K1's work on these inputs: operations from the
    walk's own counts (`walk_ops`), the colour products at the 3xTF32 rate
    and the rest at the f32 peak, and compulsory bytes (the (N, 6 + C)
    table, the walked pair_gidx, outputs) at the HBM rate; beside it the
    bound that charges every visit (`all_visits_bound`)."""
    gidx, starts, counts, attrs, bg, tw, ts = args
    c = attrs.shape[1] - 6
    t, p = ncomp.shape
    nbytes = 4.0 * (attrs.numel() + float(counts.sum()) + 2 * t + c + t * p * (c + 3))
    return fwd_bound(counts, ncomp, live, work, c, nbytes)


def k3_bound(targs, ncomp, live, work: dict) -> dict:
    """K1's operations on the table's rows (`work` counted on the stream
    of the same rows); bytes: the walked table rows, counts, bg and the
    outputs."""
    counts, tables, bg, tw, ts = targs
    c = tables.shape[2] - 6
    t, p = ncomp.shape
    nbytes = 4.0 * (float(counts.sum()) * tables.shape[2] + t + c + t * p * (c + 3))
    return fwd_bound(counts, ncomp, live, work, c, nbytes)


def check_k1(label: str, args, time_it: bool) -> dict:
    """Kernel vs plain version on the same inputs; raises past the bounds."""
    import torch
    from gaussiangrasper_torch.ops import rasterize_cuda as rc

    got = rc.composite_pairs_fwd(*args)
    want = rc.composite_pairs_fwd_plain(*args, count_live=True, count_warp_rows=time_it)
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
        work = want[5]
        row.update(k1_bound(args, want[3], want[4], work))
        row.update(warp_row_work(work["warp_rows"], work["live_warp_rows"], row["ms"]),
                   kept_warp_rows=work["kept_warp_rows"], products=work["products"])
        if row["channels"] > rc.KERNEL_CHANNELS[-1]:
            row["piece_kernel_ms"] = piece_kernel_ms(args, bwd=False)
    emit(row)
    if not finite or err > K1_ERR_MAX or dn_max > 1 or share > K1_NCOMP_SHARE_MAX:
        raise RuntimeError(f"k1 {label}: kernel disagrees with its plain version: {row}")
    return row


def piece_kernel_ms(args, bwd: bool) -> list:
    """K1's (or, with `bwd`, K2's) launch alone on each channel piece, its
    inputs cut and padded beforehand: the wrapper's time past their sum is
    the cutting, padding and joining."""
    from gaussiangrasper_torch.ops import rasterize_cuda as rc

    attrs, bg = args[3], args[4]
    times = []
    for lo, hi in rc.channel_pieces(attrs.shape[1] - 6):
        width = rc.channel_width(rc.KERNEL_CHANNELS, hi - lo)
        a, b = rc.cut_channels(attrs, lo, hi, width), rc.cut_channels(bg, lo, hi, width, 0)
        if bwd:
            g = rc.cut_channels(args[5], lo, hi, width, 0)
            times.append(cuda_ms(lambda: rc._kernel_bwd(*args[:3], a, b, g, *args[6:], False), 20))
        else:
            times.append(cuda_ms(lambda: rc._kernel_fwd(*args[:3], a, b, *args[5:], False), 20))
    return times


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


def warp_row_work(warp_rows: int, live: int, ms: float) -> dict:
    """A compositor kernel's work in warp x row pairs on its inputs (a warp
    an 8 x 4 pixel block, rc.warp_pixels), counted by the plain version
    (`count_warp_rows`): walked by some lane, and live (a lane composites
    the row); with the kernel's ms, the SM clocks it spends a live
    warp-row at the card's maximum SM clock."""
    import torch

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
        _, rows, live_rows = rc.composite_pairs_bwd_plain(*args, count_warp_rows=True)
        row.update(warp_row_work(rows, live_rows, row["ms"]))
        if c > rc.KERNEL_CHANNELS[-1]:
            row["piece_kernel_ms"] = piece_kernel_ms(args, bwd=True)
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

    got = rc.composite_pairs_fwd(*args, two_tile=True)
    k1 = rc._launch_kernel(*args)
    torch.cuda.synchronize()
    equal = [bool(torch.equal(a, b)) for a, b in zip(got, k1)]
    row = {"phase": "k5", "case": label, "tiles": int(args[1].shape[0]),
           "channels": int(args[3].shape[1] - 6), "pairs": int(args[2].sum()),
           "bit_equal_to_k1": dict(zip(("out", "alpha", "logt", "ncomp"), equal))}
    ok = all(equal) and all(bool(torch.isfinite(x).all()) for x in got)
    want = None
    if plain or time_it:
        want = rc.composite_pairs_fwd_plain(*args, count_live=True, count_warp_rows=time_it)
    if plain:
        err = max(float((a - b).abs().max()) for a, b in zip(got[:3], want[:3]))
        dn = (got[3] - want[3]).abs()
        row.update(max_abs_err=err, ncomp_diff_pixels=int((dn > 0).sum()),
                   ncomp_diff_max=float(dn.max()))
        ok = ok and err <= K1_ERR_MAX and float(dn.max()) <= 1 \
            and int((dn > 0).sum()) <= K1_NCOMP_SHARE_MAX * dn.numel()
    if time_it:
        row["ms"] = cuda_ms(lambda: rc._launch_kernel(*args, two_tile=True), 20)
        row["k1_ms"] = cuda_ms(lambda: rc._launch_kernel(*args), 20)
        row["plain_ms"] = cuda_ms(lambda: rc.composite_pairs_fwd_plain(*args), 3)
        row.update(k1_bound(args, want[3], want[4], want[5]))
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
    got = per_gaussian(args, rc.composite_pairs_bwd(*args, two_tile=True))
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
        row["ms"] = cuda_ms(lambda: rc._launch_bwd_kernel(*args, two_tile=True), 20)
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
            "k1": narrow_inputs(inp["k1"], 3)}


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
        # K3's rows are the stream's (no clip), so K1's count on the stream is K3's work
        work = rc.composite_pairs_fwd_plain(*inp["k1"], count_warp_rows=True)[4]
        row.update(k3_bound(targs, want[3], want[4], work))
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

    kernels = ("k3", "k4", "k1", "k2")
    paths = {"table": table_compositor, "pairs": None}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    field, alive = bench_field(N_FULL, seed=0, device=device)
    cam = bench_camera(WIDTH, HEIGHT, device)
    render_ms = {p: [] for p in paths}
    reset_launches()
    with torch.no_grad():
        for _ in range(TABLE_RENDERS):
            outs = {}
            for p, comp in paths.items():
                outs[p], ms = timed(lambda: render(field, alive, cam, STEP, cfg, compositor=comp))
                render_ms[p].append(ms)
    render_launches = launch_counts(*kernels)
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
    reset_launches()
    for i in range(TABLE_ITERS):
        for p, comp in paths.items():
            res, ms = timed(lambda: iteration(comp))
            iter_ms[p].append(ms)
            if i == 0:
                first[p] = res
    launches = launch_counts(*kernels)
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


P1_LARGE = 1 << 26  # floats: 256 MB in, 256 MB out
P3_LARGE = dict(blocks=2048, rows=1 << 17)


def p3_large_inputs(device, seed: int = 9):
    """P3 where bytes decide: P3_LARGE's blocks at seeded random starts in
    [0, rows - 128], overlapping (about 86% of the rows covered, most of
    them by two blocks or more), and their seeded values."""
    import torch

    rows, t = P3_LARGE["rows"], P3_LARGE["blocks"]
    gen = torch.Generator(device=device).manual_seed(seed)
    starts = torch.randint(0, rows - 128 + 1, (t,), generator=gen, device=device,
                           dtype=torch.int32)
    vals = torch.randn(t, 128, 128, generator=gen, device=device)
    return vals, starts, rows


def probes_phase(device) -> dict:
    """Both probe entry points in-process, then each probe kernel against
    its plain version on the card (exact) and timed, at the probes' shapes
    and, for P1 and P3, at a shape where bytes decide."""
    import torch
    from gaussiangrasper_torch.probes import copy_probe, kernel_probe
    from gaussiangrasper_torch.probes import kernels as pk

    reset_launches()
    rcs = {"kernel_probe": kernel_probe.main([]), "copy_probe": copy_probe.main([])}
    torch.cuda.synchronize()
    launches = launch_counts("p1", "p2", "p3", "k3")
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
    xl = torch.randn(P1_LARGE, generator=torch.Generator(device=device).manual_seed(3),
                     device=device)
    lvals, lstarts, lrows = p3_large_inputs(device)
    lcovered = pk.covered_rows(lstarts, lrows).to(device)
    # compulsory words: inputs read once, outputs written once; P3 reads and
    # writes only the covered rows, each from the block that wins it
    cases = {
        "p1": (lambda: pk._launch_affine(x), lambda: pk.affine_plain(x),
               lambda: torch.add(one, x, alpha=2.0), 2 * x.numel(), None, (50, 20)),
        "p2": (lambda: pk._launch_read_at(src, rstarts), lambda: pk.read_at_plain(src, rstarts),
               lambda: windows[rstarts_long], 2 * 3 * 128 * 128 + 3, None, (50, 20)),
        "p3": (lambda: pk._launch_write_at(vals, wstarts, 512),
               lambda: pk.write_at_plain(vals, wstarts, 512), None,
               2 * int(covered.sum()) * 128 + 3, covered, (50, 20)),
        "p1_large": (lambda: pk._launch_affine(xl), lambda: pk.affine_plain(xl),
                     lambda: torch.add(one, xl, alpha=2.0), 2 * xl.numel(), None, (20, 5)),
        "p3_large": (lambda: pk._launch_write_at(lvals, lstarts, lrows),
                     lambda: pk.write_at_plain(lvals, lstarts, lrows), None,
                     2 * int(lcovered.sum()) * 128 + lstarts.numel(), lcovered, (20, 3)),
    }
    rows = {}
    for name, (kernel, plain, library, words, rows_checked, (reps, plain_reps)) in cases.items():
        got, want = kernel(), plain()
        lib_equal = library is None or bool(torch.equal(library(), want))
        torch.cuda.synchronize()
        if rows_checked is not None:
            got, want = got[rows_checked], want[rows_checked]
        r = {"max_abs_err": float((got - want).abs().max()), "equal": bool(torch.equal(got, want)),
             "library_equal": lib_equal, "ms": device_ms(kernel, reps),
             "plain_ms": device_ms(plain, plain_reps),
             "library_ms": device_ms(library, reps) if library else None,
             "host_ms": cuda_ms(kernel, reps)}
        del got, want
        r["us"] = 1e3 * r["ms"]
        r.update(roofline(0.0, 4.0 * words))
        r["bound_share"] = r["bound_ms"] / r["ms"]
        rows[name] = r
    rows["p3_large"].update(blocks=P3_LARGE["blocks"], rows=lrows,
                            covered_rows=int(lcovered.sum()))
    rows["p1_large"]["elements"] = P1_LARGE
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

    state = train_state_at(N_FULL, CAPACITY, seed=0, device=device)
    batch = train_batch(WIDTH, HEIGHT, 32, 800, 1000, seed=8, device=device)
    cam = bench_camera(WIDTH, HEIGHT, device)
    torch.cuda.synchronize()
    reset_launches()
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
    launches = launch_counts("k1", "k2")
    if launches != {"k1": TRAIN_STEPS, "k2": TRAIN_STEPS}:
        raise RuntimeError(f"launches {launches} for {TRAIN_STEPS} train steps")
    gather_launches = launch_counts("g1", "g2")
    if gather_launches != {"g1": TRAIN_STEPS, "g2": TRAIN_STEPS}:
        raise RuntimeError(f"pixel gather launches {gather_launches} for {TRAIN_STEPS} train steps")
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
           "launches": launches, "gather_launches": gather_launches, "ms_per_step": ms,
           "px_per_s": WIDTH * HEIGHT / (ms / 1e3),
           "batch_ms_per_step": [1e3 * b / 10 for b in batch_s], "loss_every_10": losses,
           "final_metrics": final, "alive_before_refine": alive_before,
           "alive_after_refine": alive_after, "train_profile": profile,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    row["device_idle_share"] = 1.0 - profile["device_busy_ms"] / profile["step_ms"]
    emit(row)
    return row


def timed_train_step(train_step, steps: list):
    """A stand-in for train_state.train_step that times each step between
    two synchronizations and appends (width, ms, loss, psnr) to `steps`;
    this script's instrument, not the trainer's."""
    import torch

    def timed_step(state, cam, batch, cfg, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_step(state, cam, batch, cfg, *a, **k)
        torch.cuda.synchronize()
        steps.append((cam.width, 1e3 * (time.perf_counter() - t0),
                      float(out[1]["loss"]), float(out[1]["psnr"])))
        return out

    return timed_step


def counted_cli(seconds: dict, launches: dict, name: str, fn, argv, hashes: Optional[dict] = None,
                voxels: Optional[dict] = None):
    """Run one CLI's main in-process on the card, every compositor's,
    hash-grid kernel's and the voxel labelling's launch count set to 0 just
    before and read just after; its seconds and compositor counts go into
    `seconds` / `launches` under `name`, the hash-grid kernels' (h1
    forward, h2 backward, h3 double backward) into `hashes` and the voxel
    labelling's (V1) into `voxels`, where given."""
    import torch

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = fn([str(a) for a in argv])
    torch.cuda.synchronize()
    seconds[name] = time.perf_counter() - t0
    launches[name] = launch_counts(*COMPOSITORS)
    if hashes is not None:
        hashes[name] = launch_counts(*HASH_KERNELS)
    if voxels is not None:
        voxels[name] = launch_counts("v1")["v1"]
    return out


def trainer_phase(scene: Path, out_dir: Path, label: str, tp: int) -> dict:
    """The training CLI in-process on the tabletop, writing its run under
    `out_dir`, then the render CLI on the run. A shim around
    train_state.train_step / refine_step times each step between two
    synchronizations and records losses and alive counts; it is this
    script's instrument, not the trainer's."""
    import torch
    from gaussiangrasper_torch.engine import train_state
    from gaussiangrasper_torch.ops import rasterize_cuda as rc
    from gaussiangrasper_torch.scripts import render, train

    steps, refines = [], []
    train_step, refine_step = train_state.train_step, train_state.refine_step
    timed_step = timed_train_step(train_step, steps)

    def counted_refine(state, *a, **k):
        new = refine_step(state, *a, **k)
        refines.append([state.step, int(state.alive.sum()), int(new.alive.sum())])
        return new

    seconds, counts = {}, {}
    rc.TP = tp
    train_state.train_step, train_state.refine_step = timed_step, counted_refine
    torch.cuda.reset_peak_memory_stats()
    try:
        trainer = counted_cli(seconds, counts, "train", train.main,
                              ["--data", scene, "--max-iterations", TRAINER_STEPS, "--capacity",
                               CAPACITY, "--steps-per-save", TRAINER_STEPS, "--output-dir", out_dir])
    finally:
        train_state.train_step, train_state.refine_step = train_step, refine_step
        rc.TP = 1
    wall_s, launches = seconds["train"], counts["train"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    run = Path(out_dir) / "gaussian-splatting"
    counted_cli(seconds, counts, "render", render.main, ["--run-dir", run, "--num-views", 2])
    render_launches = counts["render"]
    metrics = json.loads((run / "renders" / "metrics.json").read_text())["results"]
    # one more full-resolution step of the trained state through the same
    # kernels, traced
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


SHARDS = 4  # the band path split in one process: the card holds one rank
SHARDED_STEPS = 200  # two refines (steps 99, 199), all at 400x400
STEP0_LOSS_RTOL = 1e-6  # a sharded or multi-scene step 0 against the single-scene trainer's


def sharded_split(device, cfg) -> dict:
    """The tile-sharded compositor split SHARDS ways in one process at full
    width (the bench field and camera, C 39): the shard half for every
    shard, torch.cat for the all-gathers, the band half for every band.
    Image and alpha bit-equal to rasterize_projected's on the same inputs,
    the per-Gaussian gradients of a seeded loss within K2's criterion;
    K1 / K2 launch counts set to 0 just before the split's forward and
    backward and read just after; then the times of both paths."""
    import torch
    from gaussiangrasper_torch.models.model import render_inputs
    from gaussiangrasper_torch.ops.rasterize import rasterize_projected
    from gaussiangrasper_torch.parallel.tile_shard import composite_tile_split

    field, alive = bench_field(N_FULL, seed=0, device=device)
    with torch.no_grad():
        proj, colors, opac, bg = render_inputs(field, alive, bench_camera(WIDTH, HEIGHT, device),
                                               STEP, cfg)
    c = colors.shape[1]
    g_img = torch.as_tensor(np.random.default_rng(11).standard_normal((HEIGHT, WIDTH, c),
                                                                      np.float32), device=device)

    def split(p, col, o):
        return composite_tile_split(p, col, o, bg, WIDTH, HEIGHT, cfg.raster, d=SHARDS)

    def whole(p, col, o):
        return rasterize_projected(p, col, o, bg, WIDTH, HEIGHT, cfg.raster)

    def forward(composite):
        leaves = [x.detach().clone().requires_grad_(True) for x in (proj.xys, proj.conics, opac,
                                                                   colors)]
        out = composite(proj._replace(xys=leaves[0], conics=leaves[1]), leaves[3], leaves[2])
        return out, (out["image"] * g_img).sum() + 0.5 * out["alpha"].sum(), leaves

    def per_gaussian_grads(loss, leaves):
        g = torch.autograd.grad(loss, leaves, retain_graph=True)
        return torch.cat([g[0], g[1], g[2][:, None], g[3]], 1)

    torch.cuda.synchronize()
    reset_launches()
    out_s, loss_s, leaves_s = forward(split)
    got = per_gaussian_grads(loss_s, leaves_s)
    torch.cuda.synchronize()
    launches = launch_counts("k1", "k2")
    out_w, loss_w, leaves_w = forward(whole)
    want = per_gaussian_grads(loss_w, leaves_w)
    errs, scales = grad_errors(got, want, c)
    with torch.no_grad():
        ms = {"split_render": cuda_ms(lambda: split(proj, colors, opac), 10),
              "unsharded_render": cuda_ms(lambda: whole(proj, colors, opac), 10)}
    ms["split_backward"] = cuda_ms(lambda: torch.autograd.grad(loss_s, leaves_s, retain_graph=True),
                                   10)
    ms["unsharded_backward"] = cuda_ms(
        lambda: torch.autograd.grad(loss_w, leaves_w, retain_graph=True), 10)
    profile = device_profile(lambda: torch.autograd.grad(*forward(split)[1:]), top=10)
    bins = out_s["bins"]
    row = {"phase": "sharded_split", "shards": SHARDS, "gaussians": N_FULL, "channels": c,
           **{k: int(getattr(bins, k)) for k in ("gathered_rows", "gather_overflow",
                                                 "merge_overflow", "overflow", "dropped_tiles")},
           "band_stream_rows": [int(x) for x in out_s["band_rows"]],
           "launches": launches,
           "image_bit_equal": torch.equal(out_s["image"], out_w["image"]),
           "alpha_bit_equal": torch.equal(out_s["alpha"], out_w["alpha"]),
           "image_max_abs_diff": float((out_s["image"] - out_w["image"]).detach().abs().max()),
           "grad_rel_err": errs, "grad_scale": scales, "ms": ms, "split_profile": profile}
    emit(row)
    if not (row["image_bit_equal"] and row["alpha_bit_equal"]) or max(errs.values()) > K2_ERR_MAX \
            or launches != {"k1": SHARDS, "k2": SHARDS} or row["gather_overflow"] \
            or row["merge_overflow"]:
        raise RuntimeError(f"sharded_split: the {SHARDS}-way split disagrees with "
                           f"rasterize_projected: {row}")
    return row


def sharded_train(scene: Path, out_dir: Path, trainer_row: dict) -> dict:
    """`ggt-torch-train --mesh 1,1 --tile-shard on` in-process (a real NCCL
    world of one rank) for SHARDED_STEPS on the trainer phase's tabletop,
    then the render CLI on the run, every launch count set to 0 just
    before each. Shims around the host loop's make_sharded_train_step, refine step and
    budget derivation time each step between two synchronizations and
    record its gather stats; they are this script's instruments."""
    import torch
    import torch.distributed as dist
    from gaussiangrasper_torch._build import launches
    from gaussiangrasper_torch.engine import train_state
    from gaussiangrasper_torch.parallel import host_loop
    from gaussiangrasper_torch.scripts import render, train

    steps, builds, budgets, refines, profiles = [], [], [], [], []
    make_step, refine_step, derive = (host_loop.make_sharded_train_step, train_state.refine_step,
                                      host_loop.derive_gather_budget)
    stat_keys = ("gathered_rows", "gather_overflow", "merge_overflow", "overflow")

    def timed_make_step(*a, **k):
        builds.append({"before_step": len(steps), "gather_budget": k.get("gather_budget")})
        step = make_step(*a, **k)

        def timed(state, cam, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(state, cam, batch)
            torch.cuda.synchronize()
            steps.append((cam.width, 1e3 * (time.perf_counter() - t0), float(out[1]["loss"]),
                          {key: int(out[1][key]) for key in stat_keys}))
            if len(steps) == SHARDED_STEPS:
                # the last step twice more, the second traced (a step leaves its input
                # state as it was); the launch counts skip these runs
                counted = launches.copy()
                profiles.append(device_profile(lambda: step(state, cam, batch), top=10))
                launches.clear()
                launches.update(counted)
            return out

        return timed

    def counted_refine(state, *a, **k):
        new = refine_step(state, *a, **k)
        refines.append({"after_step": state.step - 1,
                        "alive_before_after": [int(state.alive.sum()), int(new.alive.sum())]})
        return new

    def recorded_derive(alive, d, **k):
        budgets.append(derive(alive, d, **k))
        return budgets[-1]

    seconds, counts = {}, {}
    host_loop.make_sharded_train_step, host_loop.derive_gather_budget = timed_make_step, \
        recorded_derive
    train_state.refine_step = counted_refine
    try:
        trainer = counted_cli(seconds, counts, "train", train.main,
                              ["--data", scene, "--max-iterations", SHARDED_STEPS, "--capacity",
                               CAPACITY, "--steps-per-save", SHARDED_STEPS, "--output-dir", out_dir,
                               "--mesh", "1,1", "--tile-shard", "on"])
    finally:
        host_loop.make_sharded_train_step, host_loop.derive_gather_budget = make_step, derive
        train_state.refine_step = refine_step
    run = Path(out_dir) / "gaussian-splatting"
    counted_cli(seconds, counts, "render", render.main, ["--run-dir", run, "--num-views", 2])
    metrics = json.loads((run / "renders" / "metrics.json").read_text())["results"]
    losses = [loss for _, _, loss, _ in steps]
    ms = {f"{w}x{w}": float(np.median([m for w2, m, _, _ in steps if w2 == w]))
          for w in sorted({w for w, _, _, _ in steps})}
    step0 = [losses[0], trainer_row["losses"][0]]
    row = {"phase": "sharded_train", "mesh": "1,1", "tile_shard": "on", "steps": len(steps),
           "capacity": CAPACITY, "launches_train": counts["train"],
           "launches_render": counts["render"], "wall_s": seconds["train"],
           "step0_loss_sharded_trainer": step0,
           "step0_loss_rel_diff": abs(step0[0] - step0[1]) / abs(step0[1]),
           "ms_per_step_median": ms,
           "trainer_ms_per_step_median": trainer_row["ms_per_step_median"],
           "gather_stats_first_step": steps[0][3],
           "gather_stats_after_refine": [dict(r, **steps[r["after_step"] + 1][3])
                                         for r in refines if r["after_step"] + 1 < len(steps)],
           "gather_budgets_derived": budgets, "step_builds": builds,
           "loss_first_last": [losses[0], losses[-1]],
           "render_metrics": {k: metrics[k] for k in ("psnr", "ssim") if k in metrics},
           "world_closed": not dist.is_initialized(), "step_profile": profiles[0],
           "device_idle_share": 1.0 - profiles[0]["device_busy_ms"] / steps[-1][1]}
    emit(row)
    want = {"k1": SHARDED_STEPS, "k2": SHARDED_STEPS, "k5": 0, "k6": 0}
    if counts["train"] != want or counts["render"] != {"k1": 2, "k2": 0, "k5": 0, "k6": 0} \
            or len(steps) != SHARDED_STEPS or len(refines) != SHARDED_STEPS // 100 \
            or len(budgets) != 1 + len(refines) or not all(math.isfinite(x) for x in losses) \
            or row["step0_loss_rel_diff"] > STEP0_LOSS_RTOL or not row["world_closed"] \
            or trainer.state.step != SHARDED_STEPS \
            or not all(math.isfinite(v) for v in row["render_metrics"].values()):
        raise RuntimeError(f"sharded_train: {row}")
    return row


def multi_scene_phase(scene: Path, moved: Path, tmp: Path, trainer_row: dict, device) -> dict:
    """`ggt-torch-train --data <tabletop> <moved-object tabletop>` in-process
    for SHARDED_STEPS with the shared fea_up, launch counts set to 0 just
    before; each scene's step-0 loss beside a single-scene Trainer's on
    that scene (the trainer phase's for the tabletop, one Trainer step
    here for the other), fea_up across the scenes, then each scene's
    checkpoint through the render CLI (its run dir given the run's
    config.json with that scene's capture)."""
    import dataclasses

    import torch
    from gaussiangrasper_torch.engine import multi_scene, train_state
    from gaussiangrasper_torch.engine.trainer import TrainerConfig, make_trainer
    from gaussiangrasper_torch.scripts import render, train

    scene_losses, step_ms = [], []
    train_step, ms_step = train_state.train_step, multi_scene.multi_scene_train_step

    def recorded(*a, **k):
        out = train_step(*a, **k)
        scene_losses.append(float(out[1]["loss"]))
        return out

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ms_step(*a, **k)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    seconds, counts = {}, {}
    out_dir = tmp / "multi"
    train_state.train_step, multi_scene.multi_scene_train_step = recorded, timed
    try:
        states = counted_cli(seconds, counts, "train", train.main,
                             ["--data", scene, moved, "--max-iterations", SHARDED_STEPS,
                              "--capacity", CAPACITY, "--steps-per-save", SHARDED_STEPS,
                              "--output-dir", out_dir])
    finally:
        train_state.train_step, multi_scene.multi_scene_train_step = train_step, ms_step
    per_scene = [scene_losses[0::2], scene_losses[1::2]]
    fea_diff = max(float((states[0].fea_up[k] - states[1].fea_up[k]).abs().max())
                   for k in states[0].fea_up)

    # one single-scene Trainer step on the moved capture, from the same seed
    single = []
    train_state.train_step = lambda *a, **k: single.append(train_step(*a, **k)) or single[-1]
    try:
        t = make_trainer(TrainerConfig(data=moved, output_dir=tmp / "single_moved",
                                       max_iterations=1, capacity=CAPACITY), device=device)
        t.setup()
        t.train()
    finally:
        train_state.train_step = train_step
    step0 = [[per_scene[0][0], trainer_row["losses"][0]],
             [per_scene[1][0], float(single[0][1]["loss"])]]
    del t, single

    run = out_dir / "gaussian-splatting"
    config = json.loads((run / "config.json").read_text())
    renders = {}
    for i, data in enumerate((scene, moved)):
        (run / f"scene_{i}" / "config.json").write_text(json.dumps(dict(config, data=str(data))))
        counted_cli(seconds, counts, f"render_{i}", render.main,
                    ["--run-dir", run / f"scene_{i}", "--num-views", 2])
        renders[i] = json.loads((run / f"scene_{i}" / "renders" / "metrics.json").read_text())
    row = {"phase": "multi_scene", "scenes": 2, "steps": len(step_ms), "capacity": CAPACITY,
           "launches_train": counts["train"],
           "launches_render": {i: counts[f"render_{i}"] for i in range(2)},
           "wall_s": seconds["train"],
           "step0_loss_multi_single": step0,
           "step0_loss_rel_diff": [abs(a - b) / abs(b) for a, b in step0],
           "fea_up_max_abs_diff_across_scenes": fea_diff,
           "ms_per_step_median": float(np.median(step_ms)),
           "ms_per_scene_step_trainer_400x400": trainer_row["ms_per_step_median"]["400x400"],
           "loss_first_last": [[x[0], x[-1]] for x in per_scene],
           "render_psnr": {i: renders[i]["results"]["psnr"] for i in renders}}
    emit(row)
    want = {"k1": 2 * SHARDED_STEPS, "k2": 2 * SHARDED_STEPS, "k5": 0, "k6": 0}
    if counts["train"] != want or fea_diff != 0.0 or len(step_ms) != SHARDED_STEPS \
            or max(row["step0_loss_rel_diff"]) > STEP0_LOSS_RTOL \
            or any(counts[f"render_{i}"]["k1"] != 2 for i in range(2)) \
            or not all(math.isfinite(x) for x in scene_losses) \
            or not all(math.isfinite(v) for v in row["render_psnr"].values()):
        raise RuntimeError(f"multi_scene: {row}")
    return row


ZOO_STEPS = 150  # nerfacto at its registered widths on trainer's 800x800 tabletop
ZOO_CLI_STEPS = 20  # every other ray-marched name, and generfacto
# instant-ngp: ~100 grid updates, for the EMA to empty cells and move the sizer. The sizer first
# moves near step 1160 (the plain lookup's deterministic table gradient: step 1159 on every run;
# the hash kernels' float-atomic one: steps 1113-1188 over runs, once past step 1200), so the run
# goes on well past that
ZOO_INGP_STEPS = 1600
ZOO_SMALL_SCENE = dict(width=200, height=200, n_views=4, seed_points=2000, seed=0)
ZOO_RAYS = 256  # rays of each field's card-against-CPU render
ZOO_OUT_ERR = 1e-5  # outputs, card against CPU, plus 4x the CPU's own float32 spread
ZOO_GRAD_ERR = 1e-4  # of each leaf's largest entry, plus ZOO_GRAD_SPREAD x the leaf's CPU spread
ZOO_GRAD_SPREAD = 10  # times the leaf's CPU float32 spread: see zoo_fields, zoo_grad_spread.py
ZOO_NUDGES = (1, -1, 2, -2, 3, -3, 4, -4)  # CPU float32 runs beside the plain one (zoo_fields)
ZOO_F64_ERR = 1e-8  # float64, card against CPU, of each output's / leaf's largest entry
ZOO_FIELDS = [  # the seven fields at the registered methods' widths, and the three variants
    ("nerfacto", {"use_proposal": True}), ("vanilla", {}), ("mipnerf", {}),
    ("instant-ngp", {}), ("tensorf", {}), ("neus", {}), ("neus-facto", {}),
    ("semantic", {"field": "nerfacto", "use_proposal": True, "num_semantic_classes": 64}),
    ("appearance", {"field": "nerfacto", "use_proposal": True, "num_appearance_embeds": 8}),
    ("deformation", {"field": "vanilla", "deformation": True}),
]


def zoo_render(cfg, field, cam, coords, draws, grid, device, dtype, nudge=0):
    """One render_rays forward and backward of `coords`' rays on `device` in
    `dtype` (a copy of `field`), the ray origins and the draws moved by
    `nudge` ulps: outputs and every parameter's gradient as float64 numpy."""
    import copy

    import torch
    from gaussiangrasper_torch._device import full_f32
    from gaussiangrasper_torch.core.rays import generate_rays
    from gaussiangrasper_torch.models.nerf import render_rays

    f = copy.deepcopy(field).to(device=device, dtype=dtype)
    rb = generate_rays(cam, coords).map(lambda x: x.to(device=device, dtype=dtype))
    d = {k: torch.tensor(v, dtype=dtype, device=device) for k, v in draws.items()}
    for _ in range(abs(nudge)):
        def up(x):
            return torch.nextafter(x, torch.full_like(x, nudge * float("inf")))
        rb = rb._replace(origins=up(rb.origins))
        d = {k: up(v) for k, v in d.items()}
    g = None if grid is None else grid._replace(density=grid.density.to(device, dtype),
                                                aabb=grid.aabb.to(device, dtype))
    extra = {}
    if cfg.deformation:
        extra["times"] = torch.tensor(0.3, dtype=dtype, device=device)
    if cfg.num_appearance_embeds:
        extra["appearance_idx"] = 3
    with full_f32():
        out = render_rays(f, rb, d, cfg, grid=g, **extra)
        total = 0.0
        for k in sorted(out):
            if k == "num_live_samples":
                continue
            v = out[k]
            w = torch.cos(torch.arange(v.numel(), device=device, dtype=dtype).reshape(v.shape) * 0.37)
            total = total + torch.sum(v * w)
        total.backward()
    return ({k: v.detach().double().cpu().numpy() for k, v in out.items()},
            {n: p.grad.double().cpu().numpy() for n, p in f.named_parameters() if p.grad is not None})


def zoo_fields(cam, device, seed: int = 11, fields=None, check: bool = True) -> dict:
    """Each field and variant: one render_rays forward and backward of
    ZOO_RAYS rays at the registered widths, the same params and draws on the
    card and the CPU, in float32 under full_f32() and in float64.

    A leaf's float32 gradient is chaotic in the sample positions: a sample
    that moves by an ulp across a hash, plane or line cell's edge moves its
    whole contribution to another entry, and sample_pdf turns an ulp of a
    flat CDF into a large move of a fine sample. The card's float32
    positions and CDFs differ from the CPU's by such ulps. So each leaf is
    bounded by its own CPU spread: the largest error against float64, over
    its largest entry, of the CPU float32 run and of those with the ray
    origins and the draws moved by ZOO_NUDGES ulps. `seed` draws the rays,
    the draws and the grid; `fields` (ZOO_FIELDS by default) and `check`
    (raise on a row out of bounds) are for zoo_grad_spread.py."""
    import dataclasses

    import torch
    from gaussiangrasper_torch.models import occupancy
    from gaussiangrasper_torch.models.nerf import NerfConfig, draw_shapes, init_nerf

    rng = np.random.default_rng(seed)
    coords = torch.tensor(np.stack([rng.integers(0, cam.height, ZOO_RAYS),
                                    rng.integers(0, cam.width, ZOO_RAYS)], -1))
    cam_cpu = type(cam)(*(getattr(cam, f).cpu() if torch.is_tensor(getattr(cam, f))
                          else getattr(cam, f) for f in cam.__dataclass_fields__))
    rows = {}
    for label, kw in ZOO_FIELDS if fields is None else fields:
        kw = dict(kw)
        cfg = NerfConfig(field=kw.pop("field", label), **kw)
        field = init_nerf(cfg, seed=3)
        draws = {k: rng.random(s) for k, s in draw_shapes(cfg, ZOO_RAYS).items()}
        grid = None
        if cfg.field == "instant-ngp":  # half the cells occupied
            s = cfg.scene_scale
            grid = occupancy.OccupancyGrid(
                torch.tensor((rng.random((64, 64, 64)) > 0.5).astype(np.float32)),
                torch.tensor([[-s] * 3, [s] * 3], dtype=torch.float32), 0.01)
        t0 = time.perf_counter()
        runs = {(dev, str(dt)): zoo_render(cfg, field, cam_cpu, coords, draws, grid, dev, dt)
                for dev in ("cpu", device) for dt in (torch.float32, torch.float64)}
        nudged = [zoo_render(cfg, field, cam_cpu, coords, draws, grid, "cpu", torch.float32, n)[1]
                  for n in ZOO_NUDGES]
        (o32, g32), (o64, g64) = runs[("cpu", "torch.float32")], runs[("cpu", "torch.float64")]
        (c32, cg32), (c64, cg64) = runs[(device, "torch.float32")], runs[(device, "torch.float64")]
        out_ratio, out_f64 = 0.0, 0.0
        for k in o32:
            scale = max(np.abs(o64[k]).max(), 1e-30)
            out_f64 = max(out_f64, float(np.abs(c64[k] - o64[k]).max() / scale))
            bound = ZOO_OUT_ERR + 4 * np.abs(o32[k] - o64[k])
            out_ratio = max(out_ratio, float((np.abs(c32[k] - o32[k]) / bound).max()))
        # each leaf against its own bound: 1e-4 of its largest entry plus
        # ZOO_GRAD_SPREAD times its CPU float32 spread
        scales = {n: max(np.abs(g64[n]).max(), 1e-30) for n in g64}
        cpu_rel = {n: max(float(np.abs(g[n] - g64[n]).max() / scales[n]) for g in [g32] + nudged)
                   for n in g64}
        grad_rel = {n: float(np.abs(cg32[n] - g32[n]).max() / scales[n]) for n in g64}
        bound = {n: ZOO_GRAD_ERR + ZOO_GRAD_SPREAD * cpu_rel[n] for n in g64}
        over = {n: grad_rel[n] / bound[n] for n in g64}
        grad_f64 = max(float(np.abs(cg64[n] - g64[n]).max() / scales[n]) for n in g64)
        worst = max(over, key=over.get)
        spread = {n: grad_rel[n] / cpu_rel[n] for n in g64 if cpu_rel[n] > 0}
        rows[label] = {
            "config": {k: v for k, v in dataclasses.asdict(cfg).items()
                       if v != getattr(NerfConfig(), k)},
            "out_max_abs_err_f32": max(float(np.abs(c32[k] - o32[k]).max()) for k in o32),
            "out_err_over_bound_f32": out_ratio,
            "out_rel_err_f64": out_f64,
            "grad_worst_leaf": worst, "grad_rel_err_f32": grad_rel[worst],
            "grad_bound_f32": bound[worst], "cpu_f32_leaf_spread": cpu_rel[worst],
            "grad_err_over_bound_f32": over[worst],
            "grad_err_over_cpu_spread_max": max(spread.values(), default=0.0),
            "grad_rel_err_f32_max": max(grad_rel.values()), "grad_rel_err_f64": grad_f64,
            "seconds": time.perf_counter() - t0}
        r = rows[label]
        r["within_bounds"] = bool(out_ratio <= 1.0 and out_f64 <= ZOO_F64_ERR
                                  and grad_f64 <= ZOO_F64_ERR and over[worst] <= 1.0)
        if check and not r["within_bounds"]:
            raise RuntimeError(f"nerf_zoo fields {label}: {r}")
    return rows


# hash-grid launches (h1, h2, h3) in one nerf_step of each method that has a grid (models/nerf.py):
# the proposal family looks up proposal 0, proposal 1 and the field, and runs each one's backward;
# the hierarchical nerfacto fields look the field up twice (coarse, fine); instant-ngp once.
# neus-facto looks up in sdf_and_features and in sdf_gradient; sdf_gradient's create_graph
# backward is one h2, the loss's backward runs the other lookup's h2, the double backward h3, and
# an h2 of zeros into sdf_gradient's lookup (relu's double backward hands its input zeros).
ZOO_HASH_STEP = {
    "nerfacto": [3, 3, 0], "nerfacto-big": [3, 3, 0], "nerfacto-huge": [3, 3, 0],
    "depth-nerfacto": [2, 2, 0], "semantic-nerfw": [2, 2, 0], "phototourism": [2, 2, 0],
    "instant-ngp": [1, 1, 0], "instant-ngp-bounded": [1, 1, 0], "neus-facto": [2, 3, 1]}


def zoo_hash_faults(hashes: dict, step_hashes: dict, nerfacto_eval_calls: int,
                    steps: dict) -> dict:
    """Each CLI's hash-grid launches against ZOO_HASH_STEP: every nerf_step
    exactly its method's count (no grid: none), the whole run none for a
    method without a grid, the forward alone outside the steps (the eval
    renders, instant-ngp's grid updates) for one with, and nerfacto's eval
    exactly 3 forwards a render_rays call. Returns what is off, by name."""
    faults = {}
    for name, total in hashes.items():
        want = ZOO_HASH_STEP.get(name, [0, 0, 0])
        per_step = step_hashes.get(name, [])
        outside = [total[h] - sum(s[i] for s in per_step) for i, h in enumerate(total)]
        ok = len(per_step) == steps.get(name, 0) and all(s == want for s in per_step)
        if name not in ZOO_HASH_STEP:
            ok = ok and total == {"h1": 0, "h2": 0, "h3": 0}
        elif name == "nerfacto":
            ok = ok and outside == [3 * nerfacto_eval_calls, 0, 0] and nerfacto_eval_calls > 0
        elif name != "neus-facto":  # neus-facto's eval renders take sdf_gradient's backward
            ok = ok and outside[0] > 0 and outside[1:] == [0, 0]
        if not ok:
            faults[name] = {"total": total, "want_a_step": want, "steps": len(per_step),
                            "off_steps": [s for s in per_step if s != want][:3],
                            "outside_steps": outside}
    return faults


def nerf_zoo_phase(scene: Path, tmp: Path, device) -> dict:
    """The ray-marched zoo on the card: nerfacto as registered through the
    train CLI on trainer's tabletop (ZOO_STEPS steps, then the 4-view eval),
    a traced step, each field card against CPU, every other name through the
    CLI on a 200x200 tabletop, and LPIPS card against CPU at 800x800."""
    import os

    import torch
    from gaussiangrasper_torch.data.synthetic import generate_tabletop
    from gaussiangrasper_torch.engine import nerf_trainer as nt
    from gaussiangrasper_torch.engine.dynamic_batch import DynamicBatchSizer
    from gaussiangrasper_torch.scripts import train
    from gaussiangrasper_torch.utils import perceptual
    from gaussiangrasper_torch.utils.image_io import read_image, read_png

    t_phase = time.perf_counter()
    step_ms, eval_s, captured = [], [], {}
    step, render_image, render_rays = nt.nerf_step, nt.NerfTrainer.render_image, nt.render_rays
    # each CLI's hash-grid launches in every nerf_step, and its render_rays calls outside them
    current, in_step, step_hashes, eval_calls = [""], [False], {}, {}

    def counted_step(*a, **k):
        before = launch_counts(*HASH_KERNELS)
        in_step[0] = True
        try:
            out = step(*a, **k)
        finally:
            in_step[0] = False
        after = launch_counts(*HASH_KERNELS)
        step_hashes.setdefault(current[0], []).append([after[h] - before[h] for h in after])
        return out

    def counted_render_rays(*a, **k):
        if not in_step[0]:
            eval_calls[current[0]] = eval_calls.get(current[0], 0) + 1
        return render_rays(*a, **k)

    def timed_step(*a, **k):
        captured["args"] = (a, k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = counted_step(*a, **k)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    def timed_render(self, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = render_image(self, *a, **k)
        torch.cuda.synchronize()
        eval_s.append(time.perf_counter() - t0)
        return out

    seconds, counts, hashes = {}, {}, {}
    nt.nerf_step, nt.NerfTrainer.render_image = timed_step, timed_render
    nt.render_rays, current[0] = counted_render_rays, "nerfacto"
    try:
        trainer = counted_cli(seconds, counts, "nerfacto", train.main,
                              ["--method", "nerfacto", "--data", scene, "--output-dir", tmp / "zoo",
                               "--experiment-name", "nerfacto", "--max-iterations", ZOO_STEPS,
                               "--steps-per-save", ZOO_STEPS], hashes)
    finally:
        nt.nerf_step, nt.NerfTrainer.render_image, nt.render_rays = step, render_image, render_rays
    psnr = [h["psnr"] for h in trainer.history]
    evals = json.loads((tmp / "zoo" / "nerfacto" / "renders" / "metrics.json").read_text())
    # one more step of the trained state, traced: device busy ms and top ops
    a, k = captured["args"]
    prof = device_profile(lambda: step(*a, **k), top=5)
    wall = [step_ms[-1]]
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(*a, **k)
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t0))
    wall_ms = float(np.median(wall))
    nerfacto = {
        "steps": len(step_ms), "ms_per_step_median": float(np.median(step_ms)),
        "psnr_first_50": float(np.mean(psnr[:50])), "psnr_last_50": float(np.mean(psnr[-50:])),
        "eval_psnr": [r["psnr"] for r in evals], "eval_s_per_view": eval_s,
        "traced_step": {"device_busy_ms": prof["device_busy_ms"], "wall_ms_median": wall_ms,
                        "idle_share": 1.0 - prof["device_busy_ms"] / wall_ms,
                        "top5_ms": prof["top_ms"]},
        "launches": counts["nerfacto"], "wall_s": seconds["nerfacto"],
        "hash_launches": hashes["nerfacto"], "eval_render_rays_calls": eval_calls.get("nerfacto", 0)}
    del trainer, captured, a, k
    torch.cuda.empty_cache()

    from gaussiangrasper_torch.core.cameras import Camera
    from gaussiangrasper_torch.data.dataparsers.zoo import resolve_parser

    parsed = resolve_parser(scene).parse()  # the cameras as the trainer sees them
    pc = parsed.cameras[0]
    cam = Camera.create(pc.fx, pc.fy, pc.cx, pc.cy, pc.camera_to_world, pc.width, pc.height)
    fields = zoo_fields(cam, device)

    small = generate_tabletop(tmp / "zoo_small", **ZOO_SMALL_SCENE)
    names = ["nerfacto-big", "nerfacto-huge", "vanilla-nerf", "depth-nerfacto", "mipnerf",
             "instant-ngp", "instant-ngp-bounded", "tensorf", "dnerf", "semantic-nerfw",
             "phototourism", "neus", "neus-facto"]
    cli, sizer_check = {}, None
    os.environ["GGT_GUIDANCE"] = "color"
    nt.nerf_step = counted_step
    try:
        for name in names + ["generfacto"]:
            steps = ZOO_INGP_STEPS if name == "instant-ngp" else ZOO_CLI_STEPS
            current[0] = name
            out = counted_cli(seconds, counts, name, train.main,
                              ["--method", name, "--data", small, "--output-dir", tmp / "zoo",
                               "--experiment-name", name, "--max-iterations", steps,
                               "--steps-per-save", steps], hashes)
            run = tmp / "zoo" / name
            if name == "generfacto":
                img = read_png(run / "generated.png")
                cli[name] = {"seconds": seconds[name], "generated_png": list(img.shape),
                             "launches": counts[name], "hash_launches": hashes[name]}
                continue
            rows = json.loads((run / "renders" / "metrics.json").read_text())
            ckpt = sorted(p.name for p in (run / "checkpoints").iterdir())
            cli[name] = {"seconds": seconds[name], "steps": len(out.history),
                         "checkpoints": ckpt, "eval_psnr": [r["psnr"] for r in rows],
                         "loss_first_last": [out.history[0]["loss"], out.history[-1]["loss"]],
                         "launches": counts[name], "hash_launches": hashes[name]}
            if name == "instant-ngp":
                # the ray counts against the control law replayed on the
                # measured live samples
                rays = [h["num_rays_per_batch"] for h in out.history]
                sizer = DynamicBatchSizer(target_num_samples=out.config.target_num_samples,
                                          max_num_samples_per_ray=out.config.model.num_coarse
                                          + out.config.model.num_fine)
                want = []
                for h in out.history:
                    want.append(sizer.num_rays)
                    sizer.update(int(h["num_samples"]))
                sizer_check = {"num_rays_per_batch": sorted(set(rays)), "follows_sizer": rays == want,
                               "moved": len(set(rays)) > 1,
                               "live_samples_first_last": [out.history[0]["num_samples"],
                                                           out.history[-1]["num_samples"]]}
                cli[name]["sizer"] = sizer_check
            if len(ckpt) != 1 or not all(math.isfinite(p) for p in cli[name]["eval_psnr"]) \
                    or len(rows) != 4:
                raise RuntimeError(f"nerf_zoo {name}: {cli[name]}")
            del out
            torch.cuda.empty_cache()
    finally:
        nt.nerf_step = step
        os.environ.pop("GGT_GUIDANCE", None)

    # LPIPS with seeded random VGG16 weights: view 0 and the nerfacto render of it
    path = tmp / "vgg16_random.npz"
    np.savez(path, **perceptual.random_weights(0))
    prev = os.environ.get("GGT_VGG16_WEIGHTS")
    os.environ["GGT_VGG16_WEIGHTS"] = str(path)
    perceptual.reset_cache()
    try:
        gt = read_image(parsed.image_filenames[0])[..., :3].astype(np.float32) / 255.0
        pred = read_png(tmp / "zoo" / "nerfacto" / "renders" / "00000.png").astype(np.float32) / 255.0
        on_card = perceptual.lpips(pred, gt, device=device)
        on_cpu = perceptual.lpips(pred, gt, device="cpu")
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            perceptual.lpips(pred, gt, device=device)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
    finally:
        if prev is None:
            os.environ.pop("GGT_VGG16_WEIGHTS", None)
        else:
            os.environ["GGT_VGG16_WEIGHTS"] = prev
        perceptual.reset_cache()
    lp = {"size": list(gt.shape[:2]), "card": on_card, "cpu": on_cpu,
          "abs_err": abs(on_card - on_cpu), "ms_per_pair_median": float(np.median(ms))}
    row = {"phase": "nerf_zoo", "nerfacto": nerfacto, "fields": fields, "cli": cli, "lpips": lp,
           "seconds": time.perf_counter() - t_phase}
    emit(row)
    no_kernels = {"k1": 0, "k2": 0, "k5": 0, "k6": 0}
    hash_faults = zoo_hash_faults(hashes, step_hashes, eval_calls.get("nerfacto", 0),
                                  {"nerfacto": nerfacto["steps"],
                                   **{n: c["steps"] for n, c in cli.items() if "steps" in c}})
    if hash_faults:
        raise RuntimeError(f"nerf_zoo hash-grid launches: {hash_faults}")
    if nerfacto["psnr_last_50"] <= nerfacto["psnr_first_50"] or nerfacto["steps"] != ZOO_STEPS \
            or len(nerfacto["eval_psnr"]) != 4 \
            or not all(math.isfinite(p) for p in nerfacto["eval_psnr"]) \
            or not sizer_check or not sizer_check["follows_sizer"] or not sizer_check["moved"] \
            or lp["abs_err"] > 1e-5 or not math.isfinite(lp["card"]) \
            or any(c != no_kernels for c in counts.values() if isinstance(c, dict)):
        raise RuntimeError(f"nerf_zoo: {row}")
    return row


# nerfacto-train-800's three hash-grid lookups a step (portbench/configs/nerfacto.json): name,
# samples a ray, levels, log2 of the table, the finest resolution
HASH_LOOKUPS = (("proposal_0", 256, 5, 17, 256), ("proposal_1", 96, 5, 17, 256),
                ("field", 48, 16, 19, 2048))
HASH_RAYS = 4096
HASH_GRAD_ERR = 1e-4  # kernels against the plain path on the card: each gradient, of its largest
# entry (table U(-1, 1)); the outputs bit-equal


def hash_points(rays: int, samples: int, seed: int, device):
    """(rays x samples, 3) points in [0, 1]: sorted uniform depths in [0.05,
    6] along rays from a 3-unit orbit toward the [-1, 1]^3 middle of the
    scene, mapped as the nerfacto cell maps positions (scene_scale 2)."""
    import torch

    g = torch.Generator(device).manual_seed(seed)
    ang = torch.rand(rays, generator=g, device=device) * (2 * math.pi)
    origins = torch.stack([3 * torch.cos(ang), 3 * torch.sin(ang), torch.full_like(ang, 0.5)], -1)
    target = torch.rand(rays, 3, generator=g, device=device) * 2 - 1
    dirs = torch.nn.functional.normalize(target - origins, dim=-1)
    t = torch.sort(0.05 + 5.95 * torch.rand(rays, samples, generator=g, device=device), -1)[0]
    pts = origins[:, None] + dirs[:, None] * t[..., None]
    return torch.clamp(pts / 4.0 + 0.5, 0.0, 1.0).reshape(-1, 3).contiguous()


def hash_grid_phase(device) -> dict:
    """csrc/hash_grid.cu at the nerfacto cell's three lookups, rays along
    `hash_points`: a lookup's forward and backward through `hash_grid_encode`
    with every launch count set to 0 just before (one forward and one
    backward, no double backward) against the plain path on the card (the
    outputs bit-equal, the gradients within HASH_GRAD_ERR); each kernel's ms
    (CUDA events, the wrapper's zero fill in the backward's), the backward
    with and without dL/dx, the plain path's forward and its backward alone;
    and two bytes bounds: every input and output byte once, and the 8
    corner reads of every lookup as 8-byte words. At the field's lookup also
    the double backward (h3, neus-facto's path; the cell never runs it)
    against the plain path's, and each path's time."""
    import torch
    from gaussiangrasper_torch.models import encodings as enc

    rows = {}
    for i, (name, samples, levels, log2, max_res) in enumerate(HASH_LOOKUPS):
        grid = enc.HashGrid(num_levels=levels, log2_hashmap_size=log2, max_res=max_res).to(device)
        gen = torch.Generator(device).manual_seed(20 + i)
        with torch.no_grad():
            grid.table.uniform_(-1.0, 1.0, generator=gen)
        x = hash_points(HASH_RAYS, samples, i, device)
        n, table, res = x.shape[0], grid.table.detach(), grid.resolutions
        g_out = torch.randn(n, 2 * levels, generator=gen, device=device)
        want_x = i > 0  # the proposal 1 and field positions take a gradient, proposal 0's not

        def lookup(kernel: bool):
            grid.table.grad = None
            xp = x.clone().requires_grad_(want_x)
            out = (enc.hash_grid_encode(grid, xp) if kernel
                   else enc.encode_plain(grid.table, res, xp))
            out.backward(g_out)
            return out.detach(), grid.table.grad, xp.grad

        reset_launches()
        got = lookup(True)
        launched = launch_counts(*HASH_KERNELS)
        want = lookup(False)
        errs = [float((got[0] - want[0]).abs().max())]
        errs += [float((a - b).abs().max() / b.abs().max()) for a, b in zip(got[1:], want[1:])
                 if b is not None]
        plain_out = enc.encode_plain(grid.table, res, x.clone().requires_grad_(want_x))
        table_bytes, point_bytes = table.numel() * 4, n * (12 + 8 * levels)
        rows[name] = {
            "points": n, "levels": levels, "table_rows": 2 ** log2, "launches": launched,
            "fwd_ms": cuda_ms(lambda: enc.hash_grid_fwd_cuda(x, table, res), 20),
            "bwd_ms": cuda_ms(lambda: enc.hash_grid_bwd_cuda(x, table, res, g_out, False, True),
                              20),
            "bwd_dx_ms": cuda_ms(lambda: enc.hash_grid_bwd_cuda(x, table, res, g_out, True, True),
                                 20),
            "kernel_fwd_bwd_ms": cuda_ms(lambda: lookup(True), 10),
            "plain_fwd_bwd_ms": cuda_ms(lambda: lookup(False), 5),
            "plain_fwd_ms": cuda_ms(lambda: enc.encode_plain(table, res, x), 5),
            "plain_bwd_ms": cuda_ms(lambda: plain_out.backward(g_out, retain_graph=True), 5),
            "out_max_abs_err": errs[0], "grad_rel_errs": errs[1:],
            # either kernel: the table (or its gradient) once, x and out (or dL/dout) once
            "bound_ms": 1e3 * (table_bytes + point_bytes) / HBM_BYTES_PER_S,
            "gather_bound_ms": 1e3 * (n * levels * 64 + point_bytes) / HBM_BYTES_PER_S}
        if name == "field":
            rows[name]["double_backward"] = hash_double_backward(grid, x, g_out)
        del grid, x, g_out, got, want, plain_out
        torch.cuda.empty_cache()
        double = rows[name].get("double_backward", {"grad_rel_errs": [0.0]})
        if errs[0] != 0 or max(errs[1:]) > HASH_GRAD_ERR \
                or max(double["grad_rel_errs"]) > HASH_GRAD_ERR \
                or launched != {"h1": 1, "h2": 1, "h3": 0}:
            raise RuntimeError(f"hash_grid {name}: {rows[name]}")
    row = {"phase": "hash_grid", "rows": rows}
    emit(row)
    return row


VOXEL_OBJECT, VOXEL_SIZE = 10_000, 0.02  # efd-grasp-query's object size and voxel
VOXEL_BOX = ((-0.6, -0.6, -3.2), (0.6, 0.6, -2.8))  # its objects' centre box


def voxel_cluster_phase(device) -> dict:
    """csrc/voxel_cluster.cu at efd-grasp-query's shape: the VOXEL_OBJECT
    Gaussians of bench_field(N_FULL) nearest a seeded centre in VOXEL_BOX,
    voxelized by `voxel_cluster.voxel_keys`, as `grasp.largest_cluster` does. The kernels' roots equal to
    the host union-find's on each of 20 launches; medians of 20 calls: the
    kernels' ms (CUDA events), `largest_component` and `largest_cluster` on
    the card between syncs (host clock: the copies, the bincount and, for
    the latter, the voxelization), and the host union-find's ms (3 calls).
    Bound: the keys read and the roots written once, though at ~8,300
    voxels three launches' latency sets the time."""
    import torch
    from gaussiangrasper_torch.ops import voxel_cluster as vc
    from gaussiangrasper_torch.scripts import grasp

    field, _ = bench_field(N_FULL, seed=0, device="cpu")
    centre = np.random.default_rng(20).uniform(*VOXEL_BOX)
    d = ((field.means.numpy() - centre) ** 2).sum(-1)
    points = field.means.numpy()[np.argsort(d, kind="stable")[:VOXEL_OBJECT]]
    keys, inverse, dims = vc.voxel_keys(points, VOXEL_SIZE)
    keys_t = torch.as_tensor(keys, device=device)

    def host_ms(fn, reps: int) -> tuple:
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return out, float(np.median(times))

    want, union_find_ms = host_ms(lambda: vc.roots_host(keys, dims), 3)
    reset_launches()
    mismatched = sum(not np.array_equal(vc.roots_cuda(keys_t, dims).cpu().numpy(), want)
                     for _ in range(20))
    mask, card_ms = host_ms(lambda: vc.largest_component(keys, inverse, dims), 20)
    _, cluster_ms = host_ms(lambda: grasp.largest_cluster(points, VOXEL_SIZE), 20)
    kernel_ms = cuda_ms(lambda: vc.roots_cuda(keys_t, dims), 20)
    labels = want[inverse]
    row = {"phase": "voxel_cluster", "points": len(points), "voxels": len(keys),
           "dims": dims.tolist(), "components": int(len(np.unique(want))),
           "cluster_points": int(mask.sum()), "launches": launch_counts("v1")["v1"],
           "roots_mismatched_launches": mismatched,
           "kernel_ms": kernel_ms,
           "largest_component_ms": card_ms, "largest_cluster_ms": cluster_ms,
           "host_union_find_ms": union_find_ms,
           "bound_ms": 1e3 * 12 * len(keys) / HBM_BYTES_PER_S}
    emit(row)
    if mismatched or not np.array_equal(mask, labels == np.bincount(labels).argmax()):
        raise RuntimeError(f"voxel_cluster: the kernels' roots or mask differ from the host's: {row}")
    return row


GATHER_GROUPS, GATHER_PAIRS, GATHER_POINTS = 32, 800, 1000  # efd-train-800's EFD batch
GATHER_INSTANCES = 4  # the tabletop's ids: the other 28 groups' pairs pad at pixel (0, 0)
GATHER_GRAD_ERR = 1e-6  # of the sum of a pixel's terms' magnitudes, against a float64 sum


def gather_rows(seed: int) -> np.ndarray:
    """(2 G P + S, 2) int32 rows as `train_loss` concatenates efd-train-800's
    batch: GATHER_INSTANCES groups' pairs at seeded pixels, the rest at (0,
    0) as the sampler pads them, then seeded points."""
    rng = np.random.default_rng(seed)
    pairs = np.zeros((2, GATHER_GROUPS, GATHER_PAIRS, 2), np.int32)
    pairs[:, :GATHER_INSTANCES] = rng.integers(0, WIDTH, (2, GATHER_INSTANCES, GATHER_PAIRS, 2))
    points = rng.integers(0, WIDTH, (GATHER_POINTS, 2))
    return np.concatenate([pairs.reshape(-1, 2), points]).astype(np.int32)


def pixel_gather_phase(device) -> dict:
    """csrc/pixel_gather.cu at efd-train-800's shape: the 32-channel feature
    slice of an (800, 800, 39) image, `gather_rows`' 52,200 rows. Through
    `gather_pixels` with every launch count set to 0 just before (one
    forward, one backward) against the plain advanced index: the outputs
    bit-equal, each path's gradient within GATHER_GRAD_ERR of the sum of its
    terms' magnitudes at each entry against a float64 sum. Device time a
    call (`device_ms`, the profiler over 20 calls: kernels of tens of
    microseconds, where CUDA events around one call time the host's launch
    path; the gradient taken at the slice, so autograd's slice backward is
    in no path's time): each kernel alone (the backward's with the
    wrapper's zero fill), the pair's forward plus backward through
    autograd, the plain path's, and the library's index_select forward and
    index_add_ backward on the (H W, F) view (a view of the slice, no
    copy). Bound: the pixels read, the rows written, g_out's rows read, the
    gradient's zero fill and its pixels added, once."""
    import torch
    from gaussiangrasper_torch.ops import pixel_gather as pg

    gen = torch.Generator(device).manual_seed(40)
    img = torch.rand(HEIGHT, WIDTH, 39, device=device, generator=gen)
    fea = img[..., 3:35]
    idx = torch.as_tensor(gather_rows(41), device=device)
    n, f = idx.shape[0], fea.shape[2]
    g_out = torch.randn(n, f, device=device, generator=gen)
    leaf = img.clone().requires_grad_(True)
    view = leaf[..., 3:35]
    key = idx[:, 0].long() * WIDTH + idx[:, 1].long()

    def fwd_bwd(read, at):
        return torch.autograd.grad(read(), at, g_out)[0]

    kernel = lambda: pg.gather_pixels(view, idx)  # noqa: E731
    plain = lambda: view[idx[:, 0], idx[:, 1]]  # noqa: E731
    library = lambda: view.reshape(-1, f).index_select(0, key)  # noqa: E731
    reset_launches()
    out = kernel()
    got = torch.autograd.grad(out, view, g_out)[0]
    launched = launch_counts("g1", "g2")
    want_out = plain()
    want = fwd_bwd(plain, view)
    ref = torch.zeros(HEIGHT * WIDTH, f, dtype=torch.float64, device=device)
    mass = torch.zeros_like(ref).index_add_(0, key, g_out.double().abs()).clamp(min=1e-300)
    ref.index_add_(0, key, g_out.double())
    rel = {name: float(((g.reshape(-1, f).double() - ref).abs() / mass).max())
           for name, g in (("kernel", got), ("plain", want))}
    padding = int((idx == 0).all(1).sum())
    row = {"phase": "pixel_gather", "image": [HEIGHT, WIDTH, 39], "channels": f, "rows": n,
           "rows_at_0_0": padding, "launches": launched,
           "out_bit_equal": bool(torch.equal(out, want_out)), "grad_rel_err": rel,
           "grad_max_abs_diff": float((got - want).abs().max()),
           "fwd_ms": device_ms(lambda: pg.pixel_gather_fwd_cuda(fea, idx), 20),
           "bwd_ms": device_ms(lambda: pg.pixel_gather_bwd_cuda(idx, g_out, HEIGHT, WIDTH), 20),
           "ms": device_ms(lambda: fwd_bwd(kernel, view), 20),
           "plain_ms": device_ms(lambda: fwd_bwd(plain, view), 20),
           "library_ms": device_ms(lambda: fwd_bwd(library, view), 20),
           "bound_ms": 1e3 * (2 * n * f * 4 + 2 * n * 8 + HEIGHT * WIDTH * f * 4
                              + 3 * len(torch.unique(key)) * f * 4) / HBM_BYTES_PER_S,
           "bound_by": "bytes"}
    row["max_abs_err"] = rel["kernel"]
    emit(row)
    if not row["out_bit_equal"] or max(rel.values()) > GATHER_GRAD_ERR \
            or launched != {"g1": 1, "g2": 1} or padding < 2 * 28 * GATHER_PAIRS:
        raise RuntimeError(f"pixel_gather: {row}")
    return row


def hash_double_backward(grid, x, g_out) -> dict:
    """dL/dx of a lookup with create_graph, differentiated again (the
    gradient a random gg_x, as neus-facto's eikonal loss does): dL/dg_out,
    the table's and x's gradients by the kernels (one h2, then one h3)
    against the plain path's, and the time of that second backward alone by
    each path (the bwd2 kernel; autograd's VJP of the plain backward)."""
    import torch
    from gaussiangrasper_torch.models import encodings as enc

    gen = torch.Generator(x.device).manual_seed(31)
    gg_x = torch.randn(x.shape, generator=gen, device=x.device)
    res, got = grid.resolutions, {}
    for path in ("kernel", "plain"):
        reset_launches()
        xp, g = x.clone().requires_grad_(True), g_out.clone().requires_grad_(True)
        out = enc.hash_grid_encode(grid, xp) if path == "kernel" else \
            enc.encode_plain(grid.table, res, xp)
        (dx,) = torch.autograd.grad(out, xp, g, create_graph=True)
        inputs = [g, grid.table, xp]
        grads = torch.autograd.grad(dx, inputs, gg_x, retain_graph=True)
        got[path] = {"grads": grads, "launches": launch_counts(*HASH_KERNELS),
                     "ms": cuda_ms(lambda: torch.autograd.grad(dx, inputs, gg_x,
                                                               retain_graph=True), 5)}
    errs = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(got["kernel"]["grads"], got["plain"]["grads"])]
    if got["kernel"]["launches"] != {"h1": 1, "h2": 1, "h3": 1}:
        errs.append(float("inf"))
    table = grid.table.detach()
    return {"grad_rel_errs": errs, "launches": got["kernel"]["launches"],
            "bwd2_ms": cuda_ms(lambda: enc.hash_grid_bwd2_cuda(x, table, res, g_out, gg_x, True,
                                                               True, True), 20),
            "kernel_ms": got["kernel"]["ms"], "plain_ms": got["plain"]["ms"],
            "bound_ms": 1e3 * (2 * table.numel() * 4 + x.shape[0] * (36 + 16 * table.shape[0]))
            / HBM_BYTES_PER_S}


CAPTURE_LENS = (-0.08, 0.02, 5e-4, -5e-4)  # OpenCV k1, k2, p1, p2 of the capture phase
CAPTURE_POSE_NOISE = (0.5, 0.005)  # degrees and scene units (5 mm) for views 1-7
POSE_PERTURB = (0.06, -0.04, 0.0, 0.0, 0.0, 0.02)  # tests/test_pose_opt.py's perturbation
POSE_STEPS, POSE_LR = 60, 1e-2
POSE_GRAD_FIELD = (20_000, 400, 300)  # Gaussians (the bench field's first), width, height
# The delta gradient through K1 / K2 against the CPU plain path: a sum over
# every Gaussian's projected centre and conic, in float32, in another order
# (and K2's products in 3xTF32). The CPU path's own spread, the field's rows
# reversed so that every sum runs in another order, is ~2e-7 of the largest
# entry (PERF.md §6); the bound is K2's per-Gaussian criterion, every
# entry within 1e-4 of the largest, 500 times that spread, with the norm
# within 1e-4 and a cosine of at least 1 - 1e-6. The phase prints the CPU's
# and the card's own spread beside the reading.
POSE_GRAD_RTOL = 1e-4
POSE_GRAD_COS_MIN = 1.0 - 1e-6


def distort_frame(img: np.ndarray, fx: float, fy: float, cx: float, cy: float,
                  lens) -> np.ndarray:
    """The uint8 frame a camera with OpenCV's lens (k1, k2, p1, p2) and the
    same K would have taken of the scene `img` shows through a pinhole: each
    distorted pixel's ray is found by 20 fixed-point iterations of the lens
    model (OpenCV's undistortPoints, run longer), and `img` is sampled there
    bilinearly, 0 outside it, in float64 numpy on the host."""
    k1, k2, p1, p2 = lens
    h, w = img.shape[:2]
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    xd, yd = (u - cx) / fx, (v - cy) / fy
    x, y = xd.copy(), yd.copy()
    for _ in range(20):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        x = (xd - (2 * p1 * x * y + p2 * (r2 + 2 * x * x))) / radial
        y = (yd - (p1 * (r2 + 2 * y * y) + 2 * p2 * x * y)) / radial
    sx, sy = fx * x + cx, fy * y + cy
    x0, y0 = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
    ax, ay = (sx - x0)[..., None], (sy - y0)[..., None]
    src = img.astype(np.float64)

    def tap(yy, xx):
        ok = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        return np.where(ok[..., None], src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)], 0.0)

    out = (1 - ay) * ((1 - ax) * tap(y0, x0) + ax * tap(y0, x0 + 1)) \
        + ay * ((1 - ax) * tap(y0 + 1, x0) + ax * tap(y0 + 1, x0 + 1))
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def distorted_capture(scene: Path, out: Path, seed: int = 5) -> Path:
    """`scene` (the trainer phase's tabletop) as a capture through an
    OPENCV lens: its frames rewritten by `distort_frame` with CAPTURE_LENS,
    the coefficients in transforms.json, and the poses of views 1-7 moved
    on their right by a seeded rotation of CAPTURE_POSE_NOISE[0] degrees
    about a random axis and a translation of CAPTURE_POSE_NOISE[1] along a
    random direction. Depth, normal, masks, features and the seed points
    are the pinhole scene's (linked, not copied)."""
    from gaussiangrasper_torch.utils.image_io import read_png, write_png

    out.mkdir()
    for sub in ("depths", "normals", "masks", "boundary_mask", "features", "sparse"):
        (out / sub).symlink_to(scene / sub)
    (out / "images").mkdir()
    meta = json.loads((scene / "transforms.json").read_text())
    rng = np.random.default_rng(seed)
    for i, frame in enumerate(meta["frames"]):
        write_png(out / frame["file_path"], distort_frame(
            read_png(scene / frame["file_path"]), meta["fl_x"], meta["fl_y"], meta["cx"],
            meta["cy"], CAPTURE_LENS))
        if i == 0:
            continue
        axis = rng.standard_normal(3)
        axis /= np.linalg.norm(axis)
        angle = math.radians(CAPTURE_POSE_NOISE[0])
        k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
        rot = np.eye(3) + math.sin(angle) * k + (1 - math.cos(angle)) * k @ k
        step = rng.standard_normal(3)
        c2w = np.array(frame["transform_matrix"], np.float64)
        c2w[:3, 3] += c2w[:3, :3] @ (CAPTURE_POSE_NOISE[1] * step / np.linalg.norm(step))
        c2w[:3, :3] = c2w[:3, :3] @ rot
        frame["transform_matrix"] = c2w.tolist()
    meta.update(dict(zip(("k1", "k2", "p1", "p2"), CAPTURE_LENS)))
    (out / "transforms.json").write_text(json.dumps(meta))
    return out


def capture_phase(scene: Path, tmp: Path, trainer_row: dict, device) -> dict:
    """A lens-distorted capture trained with pose optimization: the
    tabletop rewritten by `distorted_capture`, then `Trainer` with
    model.pose_opt_mode "SO3xR3" (the JAX train CLI has no pose flag, so
    neither has the port's) at the trainer phase's settings: 300 steps,
    capacity 400k, C 39. Every view is undistorted once on the card as the
    datamanager caches it (timed a view); view 0 is undistorted again on
    the card and on the CPU from the same bytes, which must agree bit for
    bit; the pose deltas' max |value| is read after steps 99, 199 and 299
    (camera_opt updates at step % 100 == 99), finite and nonzero after 99;
    K1 / K2 launches counted from 0 just before the trainer is built."""
    import torch
    from gaussiangrasper_torch.data import manager
    from gaussiangrasper_torch.data.undistort import undistort
    from gaussiangrasper_torch.engine import train_state
    from gaussiangrasper_torch.engine.trainer import TrainerConfig, make_trainer
    from gaussiangrasper_torch.models.model import GaussianSplatConfig

    t0 = time.perf_counter()
    cap = distorted_capture(scene, tmp / "capture")
    data_s = time.perf_counter() - t0
    view_ms, steps, deltas = [], [], {}
    undistort_image = manager.undistort_image

    def timed_undistort(img, cam, device=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = undistort_image(img, cam, device)
        torch.cuda.synchronize()
        view_ms.append(1e3 * (time.perf_counter() - t))
        return out

    timed_step = timed_train_step(train_state.train_step, steps)

    def step_and_read(state, cam, batch, cfg, *a, **k):
        new, metrics = timed_step(state, cam, batch, cfg, *a, **k)
        if new.step % 100 == 0:
            deltas[str(new.step - 1)] = float(new.pose.abs().max())
        return new, metrics

    config = TrainerConfig(data=cap, output_dir=tmp / "capture_run", max_iterations=TRAINER_STEPS,
                           steps_per_save=TRAINER_STEPS, capacity=CAPACITY,
                           model=GaussianSplatConfig(pose_opt_mode="SO3xR3"))
    torch.cuda.synchronize()
    reset_launches()
    train_step, manager.undistort_image = train_state.train_step, timed_undistort
    train_state.train_step = step_and_read
    t0 = time.perf_counter()
    try:
        trainer = make_trainer(config, device=device)
        trainer.setup()
        trainer.train()
    finally:
        train_state.train_step, manager.undistort_image = train_step, undistort_image
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = launch_counts("k1", "k2")

    dm = trainer.dm
    cam0, new0 = dm.outputs.cameras[0], dm.cameras[0]
    raw = (dm.dataset.get_data(0)["image"] * 255).astype(np.uint8)
    card, _ = undistort_image(raw, cam0, device)
    cpu, cpu_cam = undistort_image(raw, cam0, "cpu")
    cached = dm.view_data(0)["image"]
    k = np.array([[cam0.fx, 0, cam0.cx], [0, cam0.fy, cam0.cy], [0, 0, 1]])
    raw_d = torch.as_tensor(raw, device=device)
    device_ms = cuda_ms(lambda: undistort(raw_d, k, cam0.distortion, fisheye=False), 10)
    by_width = {w: [ms for w2, ms, _, _ in steps if w2 == w] for w in (WIDTH // 2, WIDTH)}
    ms = {f"{w}x{w}": float(np.median(v)) for w, v in by_width.items()}
    losses = [loss for _, _, loss, _ in steps]
    row = {"phase": "capture", "lens": dict(zip(("k1", "k2", "p1", "p2"), CAPTURE_LENS)),
           "pose_noise_deg_units": CAPTURE_POSE_NOISE, "data_s": data_s, "wall_s": wall_s,
           "undistort_ms_per_view_cached": view_ms, "undistort_device_ms": device_ms,
           "new_k": {"fx": new0.fx, "fy": new0.fy, "cx": new0.cx, "cy": new0.cy},
           "old_k": {"fx": cam0.fx, "fy": cam0.fy, "cx": cam0.cx, "cy": cam0.cy},
           "view0_card_vs_cpu_differing_px": int((card != cpu).any(-1).sum()),
           "view0_cached_equals_cpu": bool(np.array_equal(cached, cpu.astype(np.float32) / 255.0)),
           "steps": len(steps), "ms_per_step_median": ms,
           "trainer_phase_ms_per_step_median": trainer_row["ms_per_step_median"],
           "loss_first_last": [losses[0], losses[-1]],
           "pose_delta_max_abs_after_step": deltas, "launches": launches}
    emit(row)
    if launches != {"k1": TRAINER_STEPS, "k2": TRAINER_STEPS}:
        raise RuntimeError(f"capture: launches {launches}")
    if row["view0_card_vs_cpu_differing_px"] or not row["view0_cached_equals_cpu"] \
            or (cpu_cam.fx, cpu_cam.cy) != (new0.fx, new0.cy):
        raise RuntimeError("capture: view 0 undistorted on the card differs from the CPU path")
    if len(view_ms) != TRAINER_SCENE["n_views"] or new0.fx == cam0.fx or new0.distortion.any():
        raise RuntimeError(f"capture: {len(view_ms)} views undistorted, K {row['new_k']}")
    if sorted(deltas) != ["199", "299", "99"] or not all(
            math.isfinite(v) and v > 0 for v in deltas.values()):
        raise RuntimeError(f"capture: pose deltas {deltas}")
    if len(steps) != TRAINER_STEPS or not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        raise RuntimeError(f"capture: {len(steps)} steps, losses {losses[::50]}")
    return row


SEGMENT_CPU_VIEWS = 2  # views of the segment phase held bit-equal to the CPU path
SEGMENT_TRAIN_STEPS = 20


def segment_phase(scene: Path, tmp: Path, device) -> dict:
    """The classic segmentation backend on trainer's tabletop: a copy of the
    capture without its synthetic masks, segmented by `segment.main` on the
    card from a fresh generator carried across the 8 views (as cv2's thread
    RNG runs), each view timed between two synchronizations; the first
    SEGMENT_CPU_VIEWS views segmented again on the CPU path from the
    generator state the card started that view from, bit-equal; then
    `ggt-torch-train` for SEGMENT_TRAIN_STEPS steps on the segmented copy,
    every launch count set to 0 just before: a finite step-0 loss, a
    positive contrastive term (`feature_loss`) at step 0, K1 / K2 launches."""
    import torch
    from gaussiangrasper_torch.engine import train_state
    from gaussiangrasper_torch.scripts import segment, train
    from gaussiangrasper_torch.utils import cv_segment
    from gaussiangrasper_torch.utils.image_io import read_image

    t_phase = time.perf_counter()
    seg = tmp / "segmented"
    shutil.copytree(scene, seg, ignore=shutil.ignore_patterns("masks", "boundary_mask"))
    views = []
    classic = segment.classic_instance_masks

    def timed_masks(img, *a, **k):
        state = cv_segment.DEFAULT_RNG.state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = classic(img, *a, **k)
        torch.cuda.synchronize()
        views.append({"rng_state": state, "ms": 1e3 * (time.perf_counter() - t0),
                      "instances": int(out.max()) + 1})
        return out

    cv_segment.DEFAULT_RNG = cv_segment.OpenCVRNG()  # a fresh thread's generator
    segment.classic_instance_masks = timed_masks
    t0 = time.perf_counter()
    try:
        segment.main(["--data", str(seg)])
    finally:
        segment.classic_instance_masks = classic
    main_s = time.perf_counter() - t0

    images = sorted((seg / "images").iterdir())
    cpu_ms, equal = [], []
    for path, view in zip(images[:SEGMENT_CPU_VIEWS], views):
        img = read_image(path)[..., :3]
        t0 = time.perf_counter()
        host = classic(img, rng=cv_segment.OpenCVRNG(view["rng_state"]), device="cpu")
        cpu_ms.append(1e3 * (time.perf_counter() - t0))
        equal.append(bool(np.array_equal(np.load(seg / "masks" / f"{path.stem}.npy"), host)))

    steps = []
    train_step = train_state.train_step

    def recorded_step(state, cam, batch, cfg, *a, **k):
        new, metrics = train_step(state, cam, batch, cfg, *a, **k)
        steps.append((float(metrics["loss"]), float(metrics["feature_loss"])))
        return new, metrics

    seconds, counts = {}, {}
    train_state.train_step = recorded_step
    try:
        counted_cli(seconds, counts, "train", train.main,
                    ["--data", seg, "--max-iterations", SEGMENT_TRAIN_STEPS, "--capacity",
                     CAPACITY, "--steps-per-save", SEGMENT_TRAIN_STEPS, "--output-dir",
                     tmp / "segment_run"])
    finally:
        train_state.train_step = train_step
    ms = [v["ms"] for v in views]
    row = {"phase": "segment", "views": len(views), "backend": "classic",
           "ms_per_view": ms, "ms_per_view_median": float(np.median(ms)) if ms else None,
           "instances_per_view": [v["instances"] for v in views], "main_s": main_s,
           "cpu_views_bit_equal": equal, "cpu_ms_per_view": cpu_ms,
           "train_steps": len(steps), "train_s": seconds["train"],
           "loss_first_last": [steps[0][0], steps[-1][0]] if steps else None,
           "feature_loss_first_last": [steps[0][1], steps[-1][1]] if steps else None,
           "launches": counts["train"]}
    shutil.rmtree(seg)
    shutil.rmtree(tmp / "segment_run")
    row["phase_s"] = time.perf_counter() - t_phase
    emit(row)
    if len(views) != TRAINER_SCENE["n_views"] or len(equal) != SEGMENT_CPU_VIEWS \
            or not all(equal):
        raise RuntimeError(f"segment: {len(views)} views, CPU path bit-equal {equal}")
    if min(row["instances_per_view"]) < 2:
        raise RuntimeError(f"segment: instances a view {row['instances_per_view']}")
    if row["launches"] != {"k1": SEGMENT_TRAIN_STEPS, "k2": SEGMENT_TRAIN_STEPS, "k5": 0, "k6": 0}:
        raise RuntimeError(f"segment: launches {row['launches']}")
    if len(steps) != SEGMENT_TRAIN_STEPS or not all(math.isfinite(x) for st in steps for x in st) \
            or not steps[0][1] > 0:
        raise RuntimeError(f"segment: {len(steps)} steps, (loss, feature_loss) {steps[:3]}")
    return row


SAM_CLIP_SCENE = {**TRAINER_SCENE, "n_views": 2}  # two of trainer's 800x800 tabletop views
SAM_CLIP_STEPS = 20
SAM_CLIP_PROMPTS = ("a red mug", "the blue sphere on the table")
SAM_ERR = 1e-4  # card against CPU: of each output's largest |value| (embedding, logits, IoU)
CLIP_ERR = 1e-4  # card against CPU: of the features' largest |value|
NEAR_ZERO = 1e-4  # mask pixels whose upscaled CPU logit lies this close to 0 are not compared


class RecordedSam:
    """A SamModel stand-in that keeps the image embedding and the decoder's
    outputs of its last call."""

    def __init__(self, model):
        self.model, self.out = model, None

    def __call__(self, pixel_values, input_points):
        emb = self.model.image_embeddings(pixel_values)
        masks, iou = self.model.decode(emb, input_points)
        self.out = (emb, masks, iou)
        return masks, iou


def sam_clip_phase(tmp: Path, device) -> dict:
    """SAM and CLIP's text tower as the port's own modules, with seeded
    random weights at the published widths (SamConfig(); CLIP ViT-B/16's
    text tower: 512 wide, 12 layers, 8 heads, 77 positions, a synthetic
    49408-token vocabulary and its merges, projection 512) written as
    snapshots in the hub cache layout under HF_HUB_CACHE, so the loader
    runs: `segment --backend sam` on a two-view 800x800 tabletop (each view
    timed), view 0's image embedding, pred_masks logits and IoU scores on
    the card against the same modules on this machine's CPU (SAM_ERR), its
    first masks and its instance map pixel for pixel but where a CPU logit
    lies within NEAR_ZERO of 0 (that count printed), the encoder's ms;
    then `ggt-torch-train` SAM_CLIP_STEPS steps on those masks (K1 / K2 from
    0, a finite step-0 loss) and `ggt-torch-query --text` once per prompt
    on views 0 and 1 (K1 from 0, relevancy maps in [0, 1]); the prompts and
    the canonical phrases' features on the card against the CPU (CLIP_ERR),
    a prompt batch's ms."""
    import os

    import torch
    from gaussiangrasper_torch._device import full_f32
    from gaussiangrasper_torch.data.synthetic import generate_tabletop
    from gaussiangrasper_torch.engine import train_state
    from gaussiangrasper_torch.models import clip_text, sam
    from gaussiangrasper_torch.scripts import query, segment, train
    from gaussiangrasper_torch.utils import clip_tokenizer, hub_snapshot
    from gaussiangrasper_torch.utils.image_io import read_image

    t_phase = time.perf_counter()
    card = nvidia_smi()
    hub = tmp / "hub"
    t0 = time.perf_counter()
    sam_cfg = sam.SamConfig()
    sam_name = "facebook/sam-vit-base"
    hub_snapshot.write_snapshot(hub, sam_name, {"config.json": sam_cfg.to_dict(),
                                                "model.safetensors": sam.random_weights(sam_cfg, 0)})
    clip_cfg = clip_text.ClipTextConfig(eos_token_id=2)  # the published snapshots' pooling rule
    vocab, merges = clip_tokenizer.synthetic_vocab(clip_tokenizer.MAX_MERGES, seed=0)
    if len(vocab) != clip_cfg.vocab_size:
        raise RuntimeError(f"sam_clip: synthetic vocabulary of {len(vocab)}")
    clip_snap = hub_snapshot.write_snapshot(hub, query.CLIP_MODEL, {
        "config.json": clip_text.config_json(clip_cfg), "vocab.json": vocab, "merges.txt": merges,
        "model.safetensors": clip_text.random_weights(clip_cfg, 1)})
    snapshot_s = time.perf_counter() - t0
    scene = generate_tabletop(tmp / "sam_scene", **SAM_CLIP_SCENE)
    shutil.rmtree(scene / "masks")
    shutil.rmtree(scene / "boundary_mask")

    prev_hub = os.environ.get("HF_HUB_CACHE")
    os.environ["HF_HUB_CACHE"] = str(hub)
    views = []
    masks_fn = segment.sam_instance_masks

    def timed_masks(img, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = masks_fn(img, *a, **k)
        torch.cuda.synchronize()
        views.append({"ms": 1e3 * (time.perf_counter() - t0), "instances": int(out.max()) + 1})
        return out

    steps, seconds, counts = [], {}, {}
    train_step = train_state.train_step

    def recorded_step(state, cam, batch, cfg, *a, **k):
        new, metrics = train_step(state, cam, batch, cfg, *a, **k)
        steps.append(float(metrics["loss"]))
        return new, metrics

    try:
        segment.sam_instance_masks = timed_masks
        t0 = time.perf_counter()
        try:
            segment.main(["--data", str(scene), "--backend", "sam"])
        finally:
            segment.sam_instance_masks = masks_fn
        segment_s = time.perf_counter() - t0

        # view 0 on the card and on the CPU, the same modules and snapshot
        first = sorted((scene / "images").iterdir())[0]
        img = read_image(first)[..., :3]
        rec = {}
        for where, dev in (("card", device), ("cpu", "cpu")):
            model, proc = segment.load_sam(sam_name, dev)
            rec[where] = RecordedSam(model)
            t0 = time.perf_counter()
            inst = segment.sam_instance_masks(img, sam_name, model=rec[where], proc=proc,
                                              device=dev)
            rec[where + "_s"] = time.perf_counter() - t0
            rec[where + "_instances"] = inst
            if where == "card":
                pixels = proc(img, [[0, 0]], dev)["pixel_values"]
                with torch.no_grad(), full_f32():
                    encoder_ms = cuda_ms(lambda: model.image_embeddings(pixels), 3)
            del model
        torch.cuda.empty_cache()
        errs = {}
        for name, a, b in zip(("image_embedding", "pred_masks", "iou_scores"),
                              rec["card"].out, rec["cpu"].out):
            scale = float(b.abs().max())
            errs[name] = {"max_abs_err": float((a.cpu() - b).abs().max()), "max_abs": scale}
        with torch.no_grad():
            h, w = img.shape[:2]
            rh, rw = proc.resized_shape(h, w)
            logits = proc.upscale_logits(rec["cpu"].out[1][0, :, :1], (h, w), (rh, rw))[:, 0]
            card_logits = proc.upscale_logits(rec["card"].out[1][0, :, :1], (h, w),
                                              (rh, rw))[:, 0].cpu()
        near = logits.abs() < NEAR_ZERO
        mask_differ = (card_logits > 0) != (logits > 0)
        near_any = near.any(0).numpy()
        written = np.load(scene / "masks" / f"{first.stem}.npy")
        inst_differ = (written != rec["cpu_instances"]) & ~near_any

        # the training CLI on the SAM masks, then the query CLI with --text
        train_state.train_step = recorded_step
        try:
            counted_cli(seconds, counts, "train", train.main,
                        ["--data", scene, "--max-iterations", SAM_CLIP_STEPS, "--capacity",
                         CAPACITY, "--steps-per-save", SAM_CLIP_STEPS, "--output-dir",
                         tmp / "sam_run"])
        finally:
            train_state.train_step = train_step
        run = tmp / "sam_run" / "gaussian-splatting"
        rel = []
        for i, prompt in enumerate(SAM_CLIP_PROMPTS):
            counted_cli(seconds, counts, f"query_{i}", query.main,
                        ["--run-dir", run, "--text", prompt, "--views", "0", "1", "--output",
                         tmp / f"sam_query_{i}"])
            rel += [np.load(tmp / f"sam_query_{i}" / f"view{v:04d}_q0.npy") for v in (0, 1)]

        prompts = list(SAM_CLIP_PROMPTS) + list(query.CANONICAL_PHRASES)
        feats = {}
        for where, dev in (("card", device), ("cpu", "cpu")):
            enc = clip_text.ClipTextEncoder(clip_snap, dev)
            feats[where] = enc(prompts).cpu()
            if where == "card":
                batch_ms = cuda_ms(lambda: enc(list(SAM_CLIP_PROMPTS)), 5)
            del enc
        n_tokens = int(clip_tokenizer.ClipTokenizer(clip_snap)(prompts)[1].sum(1).max())
    finally:
        if prev_hub is None:
            os.environ.pop("HF_HUB_CACHE", None)
        else:
            os.environ["HF_HUB_CACHE"] = prev_hub
    clip_err = float((feats["card"] - feats["cpu"]).abs().max())
    clip_scale = float(feats["cpu"].abs().max())
    query_counts = {k: sum(counts[f"query_{i}"][k] for i in range(len(SAM_CLIP_PROMPTS)))
                    for k in counts["query_0"]}
    ms = [v["ms"] for v in views]
    row = {"phase": "sam_clip", "card": card, "snapshot_s": snapshot_s,
           "sam": {"views": len(views), "ms_per_view": ms, "segment_main_s": segment_s,
                   "instances_per_view": [v["instances"] for v in views],
                   "encoder_ms": encoder_ms, "view0_cpu_s": rec["cpu_s"],
                   "points": int(rec["cpu"].out[1].shape[1]), "card_vs_cpu": errs,
                   "first_masks_differing_px": int((mask_differ & ~near).sum()),
                   "first_masks_near_zero_px": int(near.sum()),
                   "first_masks_px": int(near.numel()),
                   "instance_map_differing_px": int(inst_differ.sum()),
                   "instance_map_near_zero_px": int(near_any.sum())},
           "train": {"steps": len(steps), "seconds": seconds["train"],
                     "loss_first_last": [steps[0], steps[-1]] if steps else None,
                     "launches": counts["train"]},
           "query": {"prompts": list(SAM_CLIP_PROMPTS), "views": [0, 1],
                     "seconds": [seconds[f"query_{i}"] for i in range(len(SAM_CLIP_PROMPTS))],
                     "launches": query_counts,
                     "relevancy_min_max": [float(min(r.min() for r in rel)),
                                           float(max(r.max() for r in rel))]},
           "clip": {"prompts": len(prompts), "tokens_max": n_tokens,
                    "card_vs_cpu_max_abs_err": clip_err, "max_abs": clip_scale,
                    "prompt_batch_ms": batch_ms, "prompt_batch": len(SAM_CLIP_PROMPTS)}}
    shutil.rmtree(scene)
    shutil.rmtree(tmp / "sam_run")
    shutil.rmtree(hub)
    row["phase_s"] = time.perf_counter() - t_phase
    emit(row)
    bad = [n for n, e in errs.items() if not e["max_abs_err"] <= SAM_ERR * e["max_abs"]]
    if bad:
        raise RuntimeError(f"sam_clip: SAM card vs CPU past {SAM_ERR}: {errs}")
    if row["sam"]["first_masks_differing_px"] or row["sam"]["instance_map_differing_px"]:
        raise RuntimeError(f"sam_clip: masks differ from the CPU's: {row['sam']}")
    if len(views) != SAM_CLIP_SCENE["n_views"] or min(row["sam"]["instances_per_view"]) < 1:
        raise RuntimeError(f"sam_clip: views {views}")
    if not clip_err <= CLIP_ERR * clip_scale:
        raise RuntimeError(f"sam_clip: CLIP card vs CPU {clip_err} past {CLIP_ERR} of {clip_scale}")
    if counts["train"] != {"k1": SAM_CLIP_STEPS, "k2": SAM_CLIP_STEPS, "k5": 0, "k6": 0}:
        raise RuntimeError(f"sam_clip: train launches {counts['train']}")
    if query_counts != {"k1": 2 * len(SAM_CLIP_PROMPTS), "k2": 0, "k5": 0, "k6": 0}:
        raise RuntimeError(f"sam_clip: query launches {query_counts}")
    if len(steps) != SAM_CLIP_STEPS or not math.isfinite(steps[0]):
        raise RuntimeError(f"sam_clip: {len(steps)} steps, losses {steps[:3]}")
    lo, hi = row["query"]["relevancy_min_max"]
    if not (0.0 <= lo and hi <= 1.0 and all(np.isfinite(r).all() for r in rel)):
        raise RuntimeError(f"sam_clip: relevancy maps span [{lo}, {hi}]")
    return row


def pose_recovery(field, alive, cam, mode: str, steps: int):
    """tests/test_pose_opt.py's recovery on (field, cam): render the target
    at `cam`, start from `cam` moved by POSE_PERTURB, run Adam(POSE_LR) on
    the delta alone for `steps` steps. Returns (losses, the final delta,
    the first step's gradient, the moved camera, each step's host ms)."""
    import dataclasses

    import torch
    from gaussiangrasper_torch.core.pose_opt import apply_pose_delta
    from gaussiangrasper_torch.models.model import GaussianSplatConfig, render

    cfg = GaussianSplatConfig(pose_opt_mode=mode)
    dev = cam.camera_to_world.device
    with torch.no_grad():
        target = render(field, alive, cam, STEP, cfg)["rgb"]
    moved = dataclasses.replace(cam, camera_to_world=apply_pose_delta(
        cam.camera_to_world, torch.tensor(POSE_PERTURB, device=dev), "SO3xR3"))
    delta = torch.zeros(6, device=dev, requires_grad=True)
    opt = torch.optim.Adam([delta], lr=POSE_LR)
    losses, ms, first = [], [], None
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = torch.mean((render(field, alive, moved, STEP, cfg, pose_delta=delta)["rgb"]
                           - target) ** 2)
        opt.zero_grad()
        loss.backward()
        if first is None:
            first = delta.grad.detach().clone()
        opt.step()
        losses.append(float(loss.detach()))  # synchronizes: the step's time ends here
        ms.append(1e3 * (time.perf_counter() - t0))
    return losses, delta.detach(), first, moved, ms


def pose_phase(device) -> dict:
    """Pose recovery through K1 / K2 at full width (the bench field, 200k
    Gaussians, 800x800, C 39, the bench camera) in "SO3xR3" and "SE3", with
    tests/test_pose_opt.py's bar in each: the final loss under 0.2x the
    first and a translation delta above 1e-3; the residual rotation
    (degrees) and translation of the recovered pose against the unperturbed
    one. Then the first step's delta gradient on a mid-size field (the bench
    field's first 20k Gaussians at 400x300) on the card against the CPU
    plain path from the same inputs, held to POSE_GRAD_RTOL and
    POSE_GRAD_COS_MIN; the CPU's and the card's own spread (the field's
    rows reversed) are printed beside it."""
    import torch
    from gaussiangrasper_torch.core.pose_opt import apply_pose_delta

    field, alive = bench_field(N_FULL, seed=0, device=device)
    cam = bench_camera(WIDTH, HEIGHT, device)
    rows = {}
    for mode in ("SO3xR3", "SE3"):
        torch.cuda.synchronize()
        reset_launches()
        losses, delta, _, moved, step_ms = pose_recovery(field, alive, cam, mode, POSE_STEPS)
        final = apply_pose_delta(moved.camera_to_world, delta, mode).cpu().double().numpy()
        cos = np.clip((np.trace(final[:, :3]) - 1.0) / 2.0, -1.0, 1.0)
        rows[mode] = {"loss_first_last": [losses[0], losses[-1]],
                      "loss_ratio": losses[-1] / losses[0], "delta": delta.cpu().tolist(),
                      "residual_rotation_deg": math.degrees(math.acos(cos)),
                      "residual_translation": float(np.linalg.norm(final[:, 3])),
                      "ms_per_step_median": float(np.median(step_ms)),
                      "ms_first_step": step_ms[0],
                      "launches": launch_counts("k1", "k2"),
                      "bar_met": bool(losses[-1] < 0.2 * losses[0]
                                      and float(delta[:3].abs().max()) > 1e-3)}
    # the first step's gradient, card vs CPU, on a mid-size field
    n_mid, w_mid, h_mid = POSE_GRAD_FIELD
    mid = field._replace(**{k: v[:n_mid] for k, v in field._asdict().items()})
    mid_alive = alive[:n_mid]
    rev = mid._replace(**{k: v.flip(0) for k, v in mid._asdict().items()})
    grads = {}
    for name, f, dev in (("card", mid, device), ("card_reversed", rev, device),
                         ("cpu", mid, "cpu"), ("cpu_reversed", rev, "cpu")):
        f = f._replace(**{k: v.to(dev) for k, v in f._asdict().items()})
        c = bench_camera(w_mid, h_mid, dev)
        grads[name] = pose_recovery(f, mid_alive.to(dev), c, "SO3xR3", 1)[2].cpu().double()

    def compare(a, b):
        a, b = grads[a], grads[b]
        return {"cos": float(a @ b / (a.norm() * b.norm())),
                "norm_rel": float(abs(a.norm() - b.norm()) / b.norm()),
                "max_rel": float((a - b).abs().max() / b.abs().max())}

    grad = {"field": {"gaussians": n_mid, "width": w_mid, "height": h_mid},
            "cpu": grads["cpu"].tolist(), "card": grads["card"].tolist(),
            "card_vs_cpu": compare("card", "cpu"),
            "cpu_spread_reversed": compare("cpu_reversed", "cpu"),
            "card_spread_reversed": compare("card_reversed", "card"),
            "bound": {"cos_min": POSE_GRAD_COS_MIN, "max_rel": POSE_GRAD_RTOL,
                      "norm_rel": POSE_GRAD_RTOL}}
    row = {"phase": "pose", "gaussians": N_FULL, "width": WIDTH, "height": HEIGHT,
           "perturbation": POSE_PERTURB, "steps": POSE_STEPS, "lr": POSE_LR,
           "modes": rows, "first_step_gradient": grad}
    emit(row)
    want = {"k1": POSE_STEPS + 1, "k2": POSE_STEPS}
    for mode, r in rows.items():
        if not r["bar_met"] or r["launches"] != want:
            raise RuntimeError(f"pose {mode}: {r}")
    g = grad["card_vs_cpu"]
    if g["cos"] < POSE_GRAD_COS_MIN or g["norm_rel"] > POSE_GRAD_RTOL \
            or g["max_rel"] > POSE_GRAD_RTOL:
        raise RuntimeError(f"pose: the card's delta gradient against the CPU's {g}")
    return row


EDIT_STEPS = 580  # the reference's fine-tune, the update CLI's default
EDIT_DELTA = (-0.55, 0.45, 0.0)  # move_object's move of sphere 1


def ply_counts(path: Path) -> dict:
    """The element counts of a PLY header (raises on a malformed file)."""
    head = path.read_bytes().split(b"end_header\n")[0].decode("ascii").splitlines()
    if head[:2] != ["ply", "format binary_little_endian 1.0"]:
        raise RuntimeError(f"{path}: not a binary PLY: {head[:2]}")
    return {ln.split()[1]: int(ln.split()[2]) for ln in head if ln.startswith("element ")}


def sphere1_radii(grasp: dict, outputs) -> float:
    """The grasp's distance from sphere 1's centre in sphere 1's radii; the
    grasp is in the dataparser-oriented, scaled frame of `outputs`."""
    from gaussiangrasper_torch.data.synthetic import SPHERES

    tf, sc = np.asarray(outputs.dataparser_transform), float(outputs.dataparser_scale)
    c1, r1, _ = SPHERES[1]
    return float(np.linalg.norm(np.asarray(grasp["position"]) - (tf[:, :3] @ c1 + tf[:, 3]) * sc)
                 / (r1 * sc))


def edit_phase(scene: Path, run: Path, tmp: Path) -> dict:
    """The paper's last steps on the TP 1 trainer's run, each CLI in-process
    on the card: grasp (sphere 1's embedding against the other three),
    project_hull, update (EDIT_STEPS fine-tune iterations on the moved
    capture, each step timed between two synchronizations), then
    export_ply, export_pointcloud --mesh and export_texture on the edited
    run, and the PSNR of the pre-edit and the edited state on after-view 0."""
    import torch
    from gaussiangrasper_torch.data.dataparsers.zoo import resolve_parser
    from gaussiangrasper_torch.data.synthetic import clip_vectors, move_object
    from gaussiangrasper_torch.engine import checkpoint as ckpt
    from gaussiangrasper_torch.engine import train_state
    from gaussiangrasper_torch.models import losses
    from gaussiangrasper_torch.models.model import render
    from gaussiangrasper_torch.scripts import (common, export_ply, export_pointcloud,
                                               export_texture, grasp, project_hull, update)
    from gaussiangrasper_torch.utils.image_io import read_png

    t0 = time.perf_counter()
    after, obj = move_object(tmp / "after_updating", delta=EDIT_DELTA, **TRAINER_SCENE)
    after_s = time.perf_counter() - t0
    move = np.eye(4)
    move[:3, 3] = EDIT_DELTA
    clips = clip_vectors()
    files = {"obj": obj, "move": move, "query": clips[1],
             "canon": np.stack([clips[0], clips[2], clips[3]])}
    for name, arr in files.items():
        np.save(tmp / f"{name}.npy", arr)
    obj_p, move_p, q_p, canon_p = (tmp / f"{n}.npy" for n in files)
    seconds, launches, voxels = {}, {}, {}

    g = counted_cli(seconds, launches, "grasp", grasp.main,
                    ["--run-dir", run, "--text-embedding", q_p, "--canonical-embedding", canon_p,
                     "--threshold", "0.5", "--output", tmp / "grasp"], voxels=voxels)
    grasp_radii = sphere1_radii(g, resolve_parser(scene, "auto").parse())
    selected = ply_counts(tmp / "grasp" / "selected.ply")["vertex"]

    counted_cli(seconds, launches, "project_hull", project_hull.main,
                ["--data", scene, "--edit-object", obj_p, "--transform-npy", move_p,
                 "--output", tmp / "masks"])
    masks = [np.load(p) for p in sorted((tmp / "masks").glob("*.npy"))]
    mask_share = [float(m.mean()) for m in masks]

    steps = []
    train_step = train_state.train_step
    train_state.train_step = timed_train_step(train_step, steps)
    try:
        ft = counted_cli(seconds, launches, "update", update.main,
                         ["--run-dir", run, "--edit-object", obj_p, "--transform-npy", move_p,
                          "--after-data", after, "--max-iterations", EDIT_STEPS])
    finally:
        train_state.train_step = train_step
    alive_after = int(ft.state.alive.sum())
    del ft
    torch.cuda.empty_cache()
    pre = ckpt.load_checkpoint(ckpt.latest_checkpoint(run / "checkpoints"))
    step0 = ckpt.load_checkpoint(run / "edit" / "checkpoints" / "step_000000000.pt")
    moved = int((pre.field.means != step0.field.means).any(1).sum())
    edit_ckpts = sorted(p.name for p in (run / "edit" / "checkpoints").iterdir())
    del pre, step0

    ft_run = run / "edit" / "finetune"
    ply = counted_cli(seconds, launches, "export_ply", export_ply.main, ["--run-dir", ft_run])
    gaussians = export_ply.read_gaussian_ply(ply)
    counted_cli(seconds, launches, "export_pointcloud", export_pointcloud.main,
                ["--run-dir", ft_run, "--num-views", TRAINER_SCENE["n_views"], "--mesh"])
    points = ply_counts(ft_run / "pointcloud.ply")
    mesh = ply_counts(ft_run / "pointcloud_mesh.ply")
    # at the CLI's defaults (TSDF 128, 16 texels a chart edge): no cut
    obj_path = counted_cli(seconds, launches, "export_texture", export_texture.main,
                           ["--run", ft_run, "--output", tmp / "texture"])
    obj_lines = obj_path.read_text().splitlines()
    texture = read_png(tmp / "texture" / "mesh.png")

    # the pre-edit and the edited state against after-view 0
    def after_psnr(run_dir, step=None):
        config, trainer, state = common.load_run(run_dir, step=step, data_override=after)
        with torch.no_grad():
            rgb = render(state.field, state.alive, trainer.dm.camera(0), state.step,
                         config.model)["rgb"]
        gt = torch.as_tensor(trainer.dm.view_data(0)["image"], device=rgb.device)
        return float(losses.psnr(rgb, gt))

    def psnr_pair(_argv):
        return after_psnr(run), after_psnr(ft_run)

    psnr_pre, psnr_edit = counted_cli(seconds, launches, "psnr_renders", psnr_pair, [])

    by_width = {w: [ms for w2, ms, _, _ in steps if w2 == w] for w in (WIDTH // 2, WIDTH)}
    loss = [l for _, _, l, _ in steps]
    row = {"phase": "edit", "after_capture_s": after_s, "cli_seconds": seconds,
           "launches": launches, "v1_launches": voxels, "steps": len(steps),
           "gaussians_moved": moved,
           "alive_after_finetune": alive_after,
           "ms_per_step_median": {f"{w}x{w}": float(np.median(v)) for w, v in by_width.items() if v},
           "steps_at": {f"{w}x{w}": len(v) for w, v in by_width.items()},
           "loss_first_last": [loss[0], loss[-1]], "loss_every_100": loss[::100],
           "grasp": {"distance_radii": grasp_radii, "score": g["score"],
                     "num_gaussians": g["num_gaussians"], "selected_ply_points": selected},
           "hull_mask_share": mask_share, "edit_checkpoints": edit_ckpts,
           "psnr_after_view0": {"pre_edit": psnr_pre, "edited": psnr_edit},
           "export_ply_gaussians": len(gaussians["means"]), "pointcloud_points": points["vertex"],
           "mesh": {"vertices": mesh["vertex"], "faces": mesh["face"]},
           "texture": {"obj_vertices": sum(ln.startswith("v ") for ln in obj_lines),
                       "obj_faces": sum(ln.startswith("f ") for ln in obj_lines),
                       "png": list(texture.shape), "cut": None}}
    emit(row)
    views = TRAINER_SCENE["n_views"]
    none = {"k1": 0, "k2": 0, "k5": 0, "k6": 0}
    want = {"grasp": none, "project_hull": none, "export_ply": none,
            "update": {**none, "k1": EDIT_STEPS, "k2": EDIT_STEPS},
            "export_pointcloud": {**none, "k1": views}, "export_texture": {**none, "k1": views},
            "psnr_renders": {**none, "k1": 2}}
    if launches != want or voxels != {"grasp": 1}:
        raise RuntimeError(f"edit: launches {launches}, want {want}; V1's {voxels}, want 1")
    if len(steps) != EDIT_STEPS or not all(math.isfinite(x) for x in loss) or not loss[-1] < loss[0]:
        raise RuntimeError(f"edit: {len(steps)} steps, losses {loss[::100]}")
    if moved == 0:
        raise RuntimeError("edit: no Gaussian moved")
    if edit_ckpts != ["step_000000000.pt", "step_009999999.pt"] or len(masks) != views \
            or not any(m.any() for m in masks) or masks[0].shape != (HEIGHT, WIDTH):
        raise RuntimeError(f"edit: checkpoints {edit_ckpts}, {len(masks)} masks {mask_share}")
    if (len(gaussians["means"]) != alive_after or not np.isfinite(gaussians["means"]).all()
            or points["vertex"] == 0 or mesh["face"] == 0 or row["texture"]["obj_faces"] == 0
            or texture.ndim != 3 or selected != g["num_gaussians"]):
        raise RuntimeError(f"edit: malformed exports {row}")
    if not psnr_edit > psnr_pre:
        raise RuntimeError(f"edit: the edited state fits the after capture worse: {psnr_edit} <= "
                           f"{psnr_pre}")
    return row


# tests/test_e2e_tabletop.py's setting (:23-44); e2e_grasp_seeds.py runs it
# through the JAX package
E2E = dict(width=64, height=64, n_views=6, feature_downscale=2)
E2E_STEPS, E2E_UPDATE_STEPS = 300, 80
E2E_MODEL = dict(feature_dim=16, sh_degree=1, num_downscales=0, warmup_length=30, refine_every=50,
                 stop_split_at=E2E_STEPS)
E2E_RASTER = dict(tile_size=16, max_gaussians_per_tile=1024, tile_chunk=4, max_tiles_per_gaussian=16)
# the trainer seeds of the grasp sweep, the test's own (TrainerConfig's default) first
E2E_SEEDS = (42, 0, 1, 2, 3, 4, 5, 6, 7, 8)
# of E2E_SEEDS, the seeds at which the JAX package's grasp lies 3 radii or
# more from sphere 1 (e2e_grasp_seeds.py on a CPU; PERF.md, F4)
E2E_JAX_GRASP_MISSES = (0, 1, 2, 5, 6, 7)
# the sweep's depth here: the first five of E2E_SEEDS (each ~14 s on the
# card), held to the JAX package's misses at the same seeds
E2E_SWEEP_SEEDS = E2E_SEEDS[:5]


def e2e_small_phase() -> dict:
    """The JAX package's end-to-end test (tests/test_e2e_tabletop.py, its
    64x64 six-view tabletop, feature 16 and RasterizeConfig) through the
    port on the card, with the test's bars: 300 train steps, the depth
    error, the lifted features against the synthetic CLIP vectors, the
    relevancy peak of view 0 (the query CLI on the trainer run), the grasp
    CLI, then the update CLI for 80 iterations on the moved capture. The
    grasp's bar (within 3 radii of sphere 1) is held over the trainer seeds
    E2E_SWEEP_SEEDS, each a train and a grasp: it fails where more of them
    miss it than miss it in the JAX package (ROADMAP.md queue 3, F4). Each bar's
    outcome is printed; a missed bar fails the phase."""
    import torch
    from gaussiangrasper_torch.data.synthetic import clip_vectors, generate_tabletop, move_object
    from gaussiangrasper_torch.engine import checkpoint as ckpt
    from gaussiangrasper_torch.engine.trainer import TrainerConfig, make_trainer
    from gaussiangrasper_torch.models.efd import mlp_apply
    from gaussiangrasper_torch.models.model import GaussianSplatConfig, render
    from gaussiangrasper_torch.ops.rasterize import RasterizeConfig
    from gaussiangrasper_torch.scripts import grasp, query, update

    def psnr(a, b):
        return -10.0 * math.log10(float(torch.mean((a - b) ** 2)) + 1e-12)

    seconds, launches, voxels = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        scene = generate_tabletop(tmp / "scene", **E2E)
        model = GaussianSplatConfig(raster=RasterizeConfig(**E2E_RASTER), **E2E_MODEL)

        def config(seed):
            return TrainerConfig(data=scene, output_dir=tmp / f"runs{seed}",
                                 experiment_name="tabletop", max_iterations=E2E_STEPS,
                                 steps_per_save=E2E_STEPS, capacity=4096, prefetch=False,
                                 seed=seed, model=model)

        cfg = config(E2E_SEEDS[0])
        trainer = make_trainer(cfg)
        state0 = trainer.setup()
        cam0, batch0 = trainer.dm.get_batch(0)
        gt0 = batch0["image"]
        with torch.no_grad():
            psnr_before = psnr(render(state0.field, state0.alive, cam0, 0, model)["rgb"], gt0)

        def train(_argv):
            state = trainer.train()
            with torch.no_grad():
                return state, render(state.field, state.alive, cam0, E2E_STEPS, model)

        state, r1 = counted_cli(seconds, launches, "train", train, [])
        psnr_after = psnr(r1["rgb"], gt0)
        dmask = batch0["depth"] > 0.05
        depth_err = float(torch.median((r1["depth"][..., 0] - batch0["depth"]).abs()[dmask]))

        # lifted features of each object's pixels against the synthetic CLIP vectors
        ids = np.load(scene / "masks" / "r_000.npy")
        clips = clip_vectors()
        feat = r1["feature"].cpu()
        own, cross = [], []
        for oid in (0, 1, 2, 3):
            ys, xs = np.nonzero(ids == oid)
            if len(ys) == 0:
                continue
            sel = slice(0, len(ys), max(len(ys) // 64, 1))
            with torch.no_grad():
                lifted = mlp_apply(state.fea_up, feat[ys[sel], xs[sel]].to(state.field.means.device))
            lifted = lifted.cpu().numpy()
            lifted = lifted / (np.linalg.norm(lifted, axis=-1, keepdims=True) + 1e-8)
            for cid, vec in clips.items():
                (own if cid == oid else cross).append(float(np.mean(lifted @ vec)))

        # the query CLI on the run: sphere 1's vector against the other three
        run = cfg.run_dir
        np.save(tmp / "q.npy", clips[1])
        np.save(tmp / "canon.npy", np.stack([clips[0], clips[2], clips[3]]))
        counted_cli(seconds, launches, "query", query.main,
                    ["--run-dir", run, "--text-embedding", tmp / "q.npy", "--canonical-embedding",
                     tmp / "canon.npy", "--views", "0", "--output", tmp / "query"])
        rel = np.load(tmp / "query" / "view0000_q0.npy")
        peak = np.unravel_index(np.argmax(rel), rel.shape)

        def grasp_argv(run_dir, seed):
            return ["--run-dir", run_dir, "--text-embedding", tmp / "q.npy",
                    "--canonical-embedding", tmp / "canon.npy", "--threshold", "0.5",
                    "--output", tmp / f"grasp{seed}"]

        g = counted_cli(seconds, launches, "grasp", grasp.main, grasp_argv(run, E2E_SEEDS[0]),
                        voxels=voxels)
        radii = {E2E_SEEDS[0]: sphere1_radii(g, trainer.dm.outputs)}

        # the other seeds' train and grasp, as the test runs them: view 0's
        # batch drawn before training
        def sweep(_argv):
            for seed in E2E_SWEEP_SEEDS[1:]:
                t = make_trainer(config(seed))
                t.setup()
                t.dm.get_batch(0)
                t.train()
                radii[seed] = sphere1_radii(grasp.main([str(a) for a in grasp_argv(
                    t.config.run_dir, seed)]), t.dm.outputs)

        counted_cli(seconds, launches, "grasp_sweep", sweep, [], voxels=voxels)

        after, obj = move_object(tmp / "after", delta=EDIT_DELTA, **E2E)
        np.save(tmp / "obj.npy", obj)
        move = np.eye(4)
        move[:3, 3] = EDIT_DELTA
        np.save(tmp / "move.npy", move)
        counted_cli(seconds, launches, "update", update.main,
                    ["--run-dir", run, "--edit-object", tmp / "obj.npy", "--transform-npy",
                     tmp / "move.npy", "--after-data", after, "--max-iterations", E2E_UPDATE_STEPS])
        acam, abatch = make_trainer(TrainerConfig(data=after, prefetch=False, model=model)).dm.get_batch(0)
        edited = ckpt.load_checkpoint(ckpt.latest_checkpoint(run / "edit" / "checkpoints"),
                                      state.field.means.device)
        with torch.no_grad():
            psnr_old = psnr(render(state.field, state.alive, acam, E2E_STEPS, model)["rgb"],
                            abatch["image"])
            psnr_new = psnr(render(edited.field, edited.alive, acam, E2E_STEPS, model)["rgb"],
                            abatch["image"])

    misses = [seed for seed, r in radii.items() if not r < 3]
    jax_misses = [seed for seed in E2E_JAX_GRASP_MISSES if seed in E2E_SWEEP_SEEDS]
    row = {"phase": "e2e_small", **E2E, "steps": E2E_STEPS, "update_steps": E2E_UPDATE_STEPS,
           "cli_seconds": seconds, "launches": launches, "v1_launches": voxels,
           "psnr_before_after": [psnr_before, psnr_after], "median_depth_err": depth_err,
           "feature_own_cross": [float(np.mean(own)), float(np.mean(cross))],
           "query_peak": [int(peak[0]), int(peak[1])], "query_peak_object": int(ids[peak]),
           "grasp_distance_radii_by_seed": radii, "grasp_misses": misses,
           "jax_grasp_misses": jax_misses,
           "after_psnr_pre_edit_edited": [psnr_old, psnr_new]}
    bars = {"psnr_climb_1.5dB": psnr_after > psnr_before + 1.5, "psnr_over_13dB": psnr_after > 13.0,
            "depth_err_under_0.15": depth_err < 0.15,
            "features_own_over_cross_by_0.1": np.mean(own) > np.mean(cross) + 0.1,
            "query_peak_on_sphere_1": int(ids[peak]) == 1,
            "grasp_within_3_radii_at_no_more_seeds_than_jax":
                len(misses) <= len(jax_misses),
            "edit_gain_0.5dB": psnr_new > psnr_old + 0.5}
    bars = {k: bool(v) for k, v in bars.items()}
    row["bars"] = bars
    emit(row)
    want_train = {"k1": E2E_STEPS + 1, "k2": E2E_STEPS, "k5": 0, "k6": 0}
    want_update = {"k1": E2E_UPDATE_STEPS, "k2": E2E_UPDATE_STEPS, "k5": 0, "k6": 0}
    sweep = len(E2E_SWEEP_SEEDS) - 1
    want_sweep = {"k1": sweep * E2E_STEPS, "k2": sweep * E2E_STEPS, "k5": 0, "k6": 0}
    if (launches["train"] != want_train or launches["update"] != want_update
            or launches["query"] != {"k1": 1, "k2": 0, "k5": 0, "k6": 0}
            or launches["grasp_sweep"] != want_sweep
            or voxels != {"grasp": 1, "grasp_sweep": sweep}):
        raise RuntimeError(f"e2e_small: launches {launches}, V1's {voxels} (one a grasp)")
    missed = [k for k, v in bars.items() if not v]
    if missed:
        raise RuntimeError(f"e2e_small: bars missed {missed}")
    return row


# --- tools: camera paths, the device trace, the viewer, capture -> dataset, equirect ------

TRAJ_SPIRAL_FRAMES = 16
TRACE_STEPS = 20  # the trace covers steps 12..16
VIEWER_TRAIN_STEPS = 30
VIEWER_POLL_S = 0.1  # the client's frame request interval while the trainer runs
VIEWER_SIZE = (320, 240)  # the live viewer's frame (serve_in_background's default)
VIEWER_RES = 800  # the frame width of the /render requests with `res`
GEN_SUBSAMPLE = 32  # every 32nd valid pixel seeds the generated capture's cloud
GEN_TRAIN_STEPS = 20
GEN_NORMAL_MEDIAN_DEG_MAX = 2.0  # generated normals against the ray tracer's own
# the viewer's rgb frame (JPEG q85) against a direct render of its pose, in grey
# levels over pixels and channels: q85 moves a smooth frame by about a level on
# average and by tens at sharp edges; another pose or mode, or a black frame, is
# off by tens on average
JPEG_Q85_MEAN_MAX = 3.0
JPEG_Q85_MAX = 128
EQUIRECT_SIZE = (512, 1024)  # a seeded panorama, height x width


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http(url: str, body=None, timeout: float = 120) -> bytes:
    import urllib.request

    req = urllib.request.Request(url, data=None if body is None else json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def tools_traj(run: Path, state, cfg, parsed, tmp: Path, seconds: dict, counts: dict) -> dict:
    """render --traj interpolate and spiral on the run: frame counts, each
    frame equal to a direct render of its path camera on the card, the
    direct render's ms a frame."""
    import torch
    from gaussiangrasper_torch.core.cameras import Camera
    from gaussiangrasper_torch.scripts import render
    from gaussiangrasper_torch.utils.image_io import read_png

    out = {}
    for kind in ("interpolate", "spiral"):
        name = f"render_traj_{kind}"
        d = tmp / name
        counted_cli(seconds, counts, name, render.main,
                    ["--run-dir", run, "--traj", kind, "--num-views", TRAJ_SPIRAL_FRAMES,
                     "--output", d])
        frames = sorted((d / "traj").glob("*.png"))
        path = render.trajectory(parsed, kind, TRAJ_SPIRAL_FRAMES)
        want = 6 * (len(parsed) - 1) + 1 if kind == "interpolate" else TRAJ_SPIRAL_FRAMES
        ms, unequal = [], 0
        for f, pc in zip(frames, path):
            cam = Camera.create(pc.fx, pc.fy, pc.cx, pc.cy, pc.camera_to_world, pc.width,
                                pc.height, device=state.field.means.device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rgb = render.render_view(state, cam, cfg)["rgb"]
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            unequal += not np.array_equal(read_png(f), render._to_u8(rgb.cpu().numpy()))
        out[kind] = {"frames": len(frames), "want": want, "frames_unequal": unequal,
                     "cli_s": seconds[name], "render_ms_median": float(np.median(ms)),
                     "launches": counts[name]}
        if len(frames) != want or len(path) != want or unequal or counts[name]["k1"] != want:
            raise RuntimeError(f"tools render --traj {kind}: {out[kind]}")
        shutil.rmtree(d)
    return out


def tools_trace(scene: Path, tmp: Path, seconds: dict, counts: dict) -> dict:
    """ggt-torch-train --profiler trace for TRACE_STEPS steps: the Chrome
    trace exists, its step ranges are 12..16, K1 and K2 launch in it at
    least once a traced step; its top 5 kernels by device time."""
    from gaussiangrasper_torch.scripts import train

    counted_cli(seconds, counts, "trace", train.main,
                ["--data", scene, "--max-iterations", TRACE_STEPS, "--capacity", CAPACITY,
                 "--steps-per-save", TRACE_STEPS, "--output-dir", tmp / "trace", "--profiler",
                 "trace"])
    traces = list((tmp / "trace" / "gaussian-splatting" / "profiler_traces").iterdir())
    events = json.loads(traces[0].read_text())["traceEvents"]
    steps = sorted({e["name"] for e in events if e.get("name", "").startswith("train_step#")},
                   key=lambda s: int(s.split("#")[1]))
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_name: dict = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e.get("dur", 0.0) / 1e3
    n_k1 = sum("composite_pairs_fwd_kernel" in e["name"] for e in kernels)
    n_k2 = sum("composite_pairs_bwd_kernel" in e["name"] for e in kernels)
    out = {"file": traces[0].name, "bytes": traces[0].stat().st_size, "steps": steps,
           "kernel_events": len(kernels), "k1_kernels": n_k1, "k2_kernels": n_k2,
           "device_ms": sum(by_name.values()),
           "top5_device_ms": [[k[:80], v] for k, v in
                              sorted(by_name.items(), key=lambda kv: -kv[1])[:5]],
           "cli_s": seconds["trace"], "launches": counts["trace"]}
    if (len(traces) != 1 or steps != [f"train_step#{i}" for i in range(12, 17)] or n_k1 < 5
            or n_k2 < 5 or counts["trace"]["k1"] != TRACE_STEPS
            or counts["trace"]["k2"] != TRACE_STEPS):
        raise RuntimeError(f"tools trace: {out}")
    shutil.rmtree(tmp / "trace")
    return out


def tools_viewer(scene: Path, run: Path, trainer, tmp: Path, trainer_row: dict, seconds: dict,
                 counts: dict) -> dict:
    """The viewer over the run's state on an ephemeral port: /scene, /render
    in each mode at the default size and at res 800 (the rgb frame within
    JPEG q85's error of a direct render of the pose), the crop box hiding
    half the scene, /render_path, /export.ply; then ggt-torch-train
    --viewer-port for VIEWER_TRAIN_STEPS steps with a client asking a frame
    every VIEWER_POLL_S."""
    import threading

    import torch
    from gaussiangrasper_torch.core.cameras import Camera
    from gaussiangrasper_torch.engine import train_state
    from gaussiangrasper_torch.models.model import render as render_fn
    from gaussiangrasper_torch.scripts import train, viewer
    from gaussiangrasper_torch.scripts.export_ply import read_gaussian_ply
    from gaussiangrasper_torch.utils.image_io import read_jpeg

    state, cfg = trainer.state, trainer.config.model
    means = state.field.means[state.alive]
    center = means.median(0).values.cpu().numpy().astype(np.float64)
    cams = np.stack([np.asarray(c.camera_to_world)[:3, 3] for c in trainer.dm.cameras])
    up = cams.mean(0) - center
    eye = center + 2.5 * up / np.linalg.norm(up)
    pose = {"eye": eye.tolist(), "center": center.tolist(), "up": [0.0, 1.0, 0.0]}
    right = viewer.look_at(eye, center, [0.0, 1.0, 0.0])[:, 0]
    axis = int(np.argmax(np.abs(right)))
    # the crop box keeping the Gaussians on the image's left of the centre
    lo, hi = [-1e9] * 3, [1e9] * 3
    if right[axis] > 0:
        hi[axis] = float(center[axis])
    else:
        lo[axis] = float(center[axis])
    out = {"pose": pose, "crop_axis": axis}

    w, h = VIEWER_SIZE
    big = (VIEWER_RES * h // w, VIEWER_RES, 3)

    def checks(_argv):
        srv = viewer.serve_in_background(lambda: state, cfg, 0, w, h,
                                         scene_info=viewer.scene_info_from_dm(trainer.dm),
                                         out_dir=tmp / "viewer_frames")
        srv.throttle.training = False  # no trainer here
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            info = json.loads(http(base + "/scene"))
            out["scene_cameras"], out["scene_points"] = len(info["cameras"]), len(info["points"])
            frames, ms = {}, {}
            for res in (w, VIEWER_RES):
                for mode in ("rgb", "depth", "normal", "feature"):
                    t0 = time.perf_counter()
                    jpeg = http(base + "/render", {**pose, "mode": mode, "res": res})
                    ms[f"{mode}_{res}"] = 1e3 * (time.perf_counter() - t0)
                    frames[f"{mode}_{res}"] = read_jpeg(jpeg)
            out["frame_shapes"] = {k: list(v.shape) for k, v in frames.items()}
            out["http_ms_a_frame"] = ms
            cam = Camera.create(0.7 * w, 0.7 * w, w / 2, h / 2,
                                viewer.look_at(eye, center, [0.0, 1.0, 0.0]), w, h,
                                device=state.field.means.device)
            with torch.no_grad():
                rgb = render_fn(state.field, state.alive, cam, state.step, cfg)["rgb"]
            direct = (np.clip(rgb.cpu().numpy(), 0, 1) * 255).astype(np.uint8).astype(np.int64)
            diff = np.abs(frames[f"rgb_{w}"].astype(np.int64) - direct)
            out["rgb_vs_direct"] = {"mean_abs": float(diff.mean()), "max_abs": int(diff.max()),
                                    "bound_mean": JPEG_Q85_MEAN_MAX, "bound_max": JPEG_Q85_MAX}
            full = frames[f"rgb_{w}"].astype(np.float64)
            left_only = read_jpeg(http(base + "/render", {**pose, "crop_min": lo, "crop_max": hi}))
            left_only = left_only.astype(np.float64)
            sums = {"full_left": full[:, :w // 2].sum(), "full_right": full[:, w // 2:].sum(),
                    "crop_left": left_only[:, :w // 2].sum(),
                    "crop_right": left_only[:, w // 2:].sum()}
            out["crop_sums"] = sums
            out["crop_means"] = [float(full.mean()), float(left_only.mean())]
            job = json.loads(http(base + "/render_path", {
                "keyframes": [pose, {**pose, "eye": (eye + 0.3 * right).tolist()}],
                "n_frames": 7, "mode": "rgb", "res": w}))
            out["render_path_frames"] = job["n"]
            last = read_jpeg(http(base + "/frames/" + job["frames"][-1]))
            ply = tmp / "viewer_export.ply"
            ply.write_bytes(http(base + "/export.ply"))
            out["export_ply_rows"] = int(read_gaussian_ply(ply)["means"].shape[0])
            out["renders"] = srv.throttle.renders
        finally:
            srv.shutdown()
            srv.server_close()
        bad = []
        if out["scene_cameras"] != len(trainer.dm) or not out["scene_points"]:
            bad.append("scene")
        for k, f in frames.items():
            want = (h, w, 3) if k.endswith(f"_{w}") else big
            if f.shape != want or f.std() == 0:
                bad.append(k)
        if diff.mean() > JPEG_Q85_MEAN_MAX or diff.max() > JPEG_Q85_MAX:
            bad.append("rgb_vs_direct")
        if not (sums["crop_right"] < 0.25 * sums["full_right"]
                and sums["crop_left"] > 0.5 * sums["full_left"]):
            bad.append("crop")
        if job["n"] != 8 or last.shape != (h, w, 3):
            bad.append("render_path")
        if out["export_ply_rows"] != int(state.alive.sum()):
            bad.append("export_ply")
        if bad:
            raise RuntimeError(f"tools viewer: {bad}: {out}")

    counted_cli(seconds, counts, "viewer", checks, [])
    out["launches"] = counts["viewer"]
    # every frame the server rendered, and the direct render
    if counts["viewer"]["k1"] != out["renders"] + 1 or counts["viewer"]["k2"]:
        raise RuntimeError(f"tools viewer: launches {counts['viewer']}, renders {out['renders']}")

    # the trainer's live viewer: a client asks a frame every VIEWER_POLL_S
    port = free_port()
    done, got, errors = threading.Event(), [], []

    def client():
        while not done.is_set():
            try:
                got.append(read_jpeg(http(f"http://127.0.0.1:{port}/render",
                                          {**pose, "mode": "rgb", "res": w}, timeout=30)).shape)
            except OSError as e:  # the server is not up yet, or shut down
                errors.append(type(e).__name__)
            time.sleep(VIEWER_POLL_S)

    steps = []
    step_fn = train_state.train_step
    train_state.train_step = timed_train_step(step_fn, steps)
    th = threading.Thread(target=client, daemon=True)
    th.start()
    try:
        live = counted_cli(seconds, counts, "viewer_train", train.main,
                           ["--data", scene, "--max-iterations", VIEWER_TRAIN_STEPS, "--capacity",
                            CAPACITY, "--steps-per-save", VIEWER_TRAIN_STEPS, "--output-dir",
                            tmp / "viewer_train", "--viewer-port", port])
    finally:
        train_state.train_step = step_fn
        done.set()
        th.join(timeout=60)
    throttle = live.viewer.throttle
    loss0, want0 = steps[0][2], trainer_row["losses"][0]
    out["train"] = {"steps": len(steps), "frames_served": throttle.renders,
                    "frames_received": len(got), "client_errors": len(errors),
                    "render_s": throttle.render_s, "wall_s": seconds["viewer_train"],
                    "render_share_of_wall": throttle.render_s / seconds["viewer_train"],
                    "train_util": throttle.train_util,
                    "ms_per_step_median": float(np.median([ms for _, ms, _, _ in steps])),
                    "step0_loss": [loss0, want0],
                    "step0_rel_diff": abs(loss0 - want0) / abs(want0),
                    "launches": counts["viewer_train"]}
    # two threads launch K1 here, and an increment of its count that one of
    # them interrupts may be lost: the count lies between the steps and the
    # steps plus the frames
    k1 = counts["viewer_train"]["k1"]
    if (len(steps) != VIEWER_TRAIN_STEPS or not got or any(s != (h, w, 3) for s in got)
            or out["train"]["step0_rel_diff"] != 0.0
            or counts["viewer_train"]["k2"] != VIEWER_TRAIN_STEPS
            or not VIEWER_TRAIN_STEPS < k1 <= VIEWER_TRAIN_STEPS + throttle.renders):
        raise RuntimeError(f"tools viewer_train: {out['train']}")
    shutil.rmtree(tmp / "viewer_train")
    return out


def raw_capture(scene: Path, out: Path) -> Path:
    """The tabletop's views as an RGB-D capture: color/, depth/*.npy (its
    z-depth), poses/*.npy (OpenCV camera-to-world) and intrinsics.json."""
    meta = json.loads((scene / "transforms.json").read_text())
    for d in ("color", "depth", "poses"):
        (out / d).mkdir(parents=True, exist_ok=True)
    (out / "intrinsics.json").write_text(json.dumps({
        "fx": meta["fl_x"], "fy": meta["fl_y"], "cx": meta["cx"], "cy": meta["cy"],
        "width": meta["w"], "height": meta["h"]}))
    for fr in meta["frames"]:
        stem = Path(fr["file_path"]).stem
        shutil.copy(scene / fr["file_path"], out / "color" / f"{stem}.png")
        shutil.copy(scene / "depths" / f"{stem}.npy", out / "depth" / f"{stem}.npy")
        c2w = np.asarray(fr["transform_matrix"], np.float64)
        c2w[:3, 1:3] *= -1.0  # OpenGL -> OpenCV
        np.save(out / "poses" / f"{stem}.npy", c2w)
    return out


def tools_generate_data(scene: Path, tmp: Path, seconds: dict, counts: dict) -> dict:
    """ggt-torch-generate-data on the tabletop's views as a raw capture:
    the cloud's size against a count on the host, the normals against the
    ray tracer's, the result read by the port's dataparser and trained for
    GEN_TRAIN_STEPS steps."""
    from gaussiangrasper_torch.data.dataparsers.zoo import resolve_parser
    from gaussiangrasper_torch.scripts import generate_data, train

    cap = raw_capture(scene, tmp / "raw_capture")
    out_dir = tmp / "generated"
    res = counted_cli(seconds, counts, "generate_data", generate_data.main,
                      ["--capture", cap, "--output", out_dir, "--subsample", GEN_SUBSAMPLE])
    want, angles = 0, []
    for f in sorted((cap / "depth").iterdir()):
        depth = np.load(f)
        valid = (depth > np.float32(0.05)) & (depth < np.float32(3.0))
        want += -(-int(valid.sum()) // GEN_SUBSAMPLE)
        i = sorted((cap / "depth").iterdir()).index(f)
        got = np.load(out_dir / "normals" / f"frame_{i:05d}.npy")
        ref = np.load(scene / "normals" / f.name)
        inner = np.zeros_like(valid)
        inner[1:-1, 1:-1] = valid[1:-1, 1:-1]
        cos = np.clip(np.sum(got[inner] * ref[inner], -1), -1.0, 1.0)
        angles.append(np.degrees(np.arccos(cos)))
    angles = np.concatenate(angles)
    parsed = resolve_parser(out_dir).parse()
    counted_cli(seconds, counts, "generate_data_train", train.main,
                ["--data", out_dir, "--max-iterations", GEN_TRAIN_STEPS, "--capacity", CAPACITY,
                 "--steps-per-save", GEN_TRAIN_STEPS, "--output-dir", tmp / "generated_run"])
    out = {"points": res["points"], "points_want": want, "frames": res["frames"],
           "normal_angle_deg": {"median": float(np.median(angles)),
                                "p90": float(np.percentile(angles, 90)),
                                "bound_median": GEN_NORMAL_MEDIAN_DEG_MAX},
           "parsed_cameras": len(parsed.cameras), "parsed_seed_points": len(parsed.seed_points[0]),
           "cli_s": seconds["generate_data"], "train_s": seconds["generate_data_train"],
           "train_launches": counts["generate_data_train"]}
    if (res["points"] != want or out["normal_angle_deg"]["median"] > GEN_NORMAL_MEDIAN_DEG_MAX
            or len(parsed.cameras) != res["frames"] or len(parsed.seed_points[0]) != want
            or counts["generate_data_train"]["k1"] != GEN_TRAIN_STEPS
            or counts["generate_data_train"]["k2"] != GEN_TRAIN_STEPS):
        raise RuntimeError(f"tools generate_data: {out}")
    for d in ("raw_capture", "generated", "generated_run"):
        shutil.rmtree(tmp / d)
    return out


def tools_equirect(device) -> dict:
    """A seeded panorama's crops on the card against the CPU path, bit for
    bit, and the card's ms a crop."""
    import torch
    from gaussiangrasper_torch.data import equirect

    h, w = EQUIRECT_SIZE
    pano = np.random.default_rng(11).integers(0, 256, (h, w, 3), dtype=np.uint8)
    fov, pairs = equirect.sampling_pattern(8)
    size = equirect.crop_resolution((h, w), len(pairs))
    on_card = torch.as_tensor(pano, device=device)
    ms, unequal = [], 0
    for yaw, pitch in pairs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = equirect.equirect_to_perspective(on_card, fov, yaw, pitch, size)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        host = equirect.equirect_to_perspective(pano, fov, yaw, pitch, size)
        unequal += int((card.cpu() != host).sum())
    out = {"panorama": [h, w], "crops": len(pairs), "crop": list(size), "fov": fov,
           "samples_unequal": unequal, "ms_a_crop_median": float(np.median(ms)),
           "ms_first_crop": ms[0]}
    if unequal:
        raise RuntimeError(f"tools equirect: card against the CPU: {out}")
    return out


def tools_phase(scene: Path, run: Path, tmp: Path, trainer_row: dict, device) -> dict:
    """The capture and viewing tools on trainer's run and tabletop, one
    JSON line; every launch count set to 0 just before each tool."""
    from gaussiangrasper_torch.scripts.common import load_run

    t0 = time.perf_counter()
    seconds, counts = {}, {}
    _, trainer, _ = load_run(run, device=device)
    row = {"phase": "tools"}
    row["render_traj"] = tools_traj(run, trainer.state, trainer.config.model, trainer.dm.cameras,
                                    tmp, seconds, counts)
    row["trace"] = tools_trace(scene, tmp, seconds, counts)
    row["viewer"] = tools_viewer(scene, run, trainer, tmp, trainer_row, seconds, counts)
    del trainer
    row["generate_data"] = tools_generate_data(scene, tmp, seconds, counts)
    row["equirect"] = tools_equirect(device)
    row["launches"] = counts
    row["seconds"] = time.perf_counter() - t0
    emit(row)
    return row


def serve_phase(device, cfg) -> dict:
    """Full-width run directory through the render and query CLIs."""
    import torch
    from gaussiangrasper_torch.engine import checkpoint as ckpt
    from gaussiangrasper_torch.engine.weights import ServeState
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

        reset_launches()
        t0 = time.perf_counter()
        render.main(["--run-dir", str(run), "--num-views", str(views), "--device", "cuda"])
        query.main(["--run-dir", str(run), "--text-embedding", str(run / "q.npy"),
                    "--canonical-embedding", str(run / "canon.npy"),
                    "--views", *map(str, range(views)), "--device", "cuda"])
        torch.cuda.synchronize()
        launches = launch_counts("k1")["k1"]
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
    fwd = _build.load_library("composite_pairs_fwd")
    fwd_smem = {f"c{c}": fwd.ggt_composite_fwd_smem_bytes(c, 32) for c in rc.TABLE_FWD_CHANNELS}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas,
          "sampler_branch": sampler, "sampler_library": str(native.LIB_PATH.relative_to(ROOT)),
          "max_active_clusters": clusters, "fwd_dynamic_smem_bytes_per_cta": fwd_smem})
    if min(clusters.values()) == 0:
        raise RuntimeError(f"no cluster of K5 / K6 fits on this card: {clusters}")

    device = torch.device("cuda")
    cfg = GaussianSplatConfig()
    field, alive = bench_field(N_FULL, seed=0, device=device)
    with torch.no_grad():
        cam_mid = bench_camera(400, 300, device)
        mid39 = k1_inputs(field, alive, cam_mid, cfg)
        check_k1("mid_c39", mid39, time_it=False)
        mid3 = narrow_inputs(mid39, 3)
        check_k1("mid_c3", mid3, time_it=False)
        mid23 = narrow_inputs(mid39, 23)  # F = 16: padded to the C = 39 kernel by the wrapper
        check_k1("mid_c23", mid23, time_it=False)
        full_args = k1_inputs(field, alive, bench_camera(WIDTH, HEIGHT, device), cfg)
        full = check_k1("full_width_c39", full_args, time_it=True)
        wide = widen_inputs(full_args, 71)  # F = 64: two channel pieces of 39 and 32
        full71 = check_k1("full_width_c71", wide, time_it=True)
        check_k2("mid_c39", mid39, time_it=False)
        check_k2("mid_c3", mid3, time_it=False)
        check_k2("mid_c23", mid23, time_it=False)
        full2 = check_k2("full_width_c39", full_args, time_it=True)
        full2_71 = check_k2("full_width_c71", wide, time_it=True)
        del wide
        dense = dense_tile_phase(device)
        odd39 = k1_inputs(field, alive, bench_camera(400, 288, device), cfg)  # 13 x 9 tiles
        odd3 = narrow_inputs(odd39, 3)
        check_k5("mid_odd_c39", odd39, time_it=False, plain=True)
        check_k5("mid_odd_c3", odd3, time_it=False, plain=True)
        full5 = check_k5("full_width_c39", full_args, time_it=True, plain=False)
        check_k6("mid_odd_c39", odd39, time_it=False)
        check_k6("mid_odd_c3", odd3, time_it=False)
        full6 = check_k6("full_width_c39", full_args, time_it=True)
        del mid39, mid3, mid23, full_args, odd39, odd3
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
    gather = pixel_gather_phase(device)
    table = table_phase(device, cfg)
    probes = probes_phase(device)
    # the large probe shapes' ~1 GB and the earlier phases' blocks, cached by
    # the allocator, are released before the trainers
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        from gaussiangrasper_torch.data.synthetic import generate_tabletop

        t0 = time.perf_counter()
        scene = generate_tabletop(Path(tmp) / "tabletop", **TRAINER_SCENE)
        emit({"phase": "trainer_data", "seconds": time.perf_counter() - t0, **TRAINER_SCENE})
        segment = segment_phase(scene, Path(tmp), device)
        torch.cuda.empty_cache()
        sam_clip = sam_clip_phase(Path(tmp), device)
        torch.cuda.empty_cache()
        # the TP 1 run stays for the edit phase
        trainer = trainer_phase(scene, Path(tmp) / "tp1", "trainer", tp=1)
        trainer2 = trainer_phase(scene, Path(tmp) / "tp2", "trainer_tp2", tp=2)
        shutil.rmtree(Path(tmp) / "tp2")
        l1, l2 = trainer["losses"], trainer2["losses"]
        drift = [abs(a - b) / abs(b) for a, b in zip(l2, l1)]
        emit({"phase": "trainer_tp2_vs_trainer", "step0_loss": [l1[0], l2[0]],
              "last_loss": [l1[-1], l2[-1]],
              "rel_drift_at_step": {str(i): drift[i] for i in (0, 1, 10, 100, 250, len(drift) - 1)},
              "max_rel_drift": max(drift)})
        if drift[0] > 1e-6:
            raise RuntimeError(f"trainer_tp2: step-0 loss {l2[0]} != {l1[0]}")
        torch.cuda.empty_cache()
        split = sharded_split(device, cfg)
        torch.cuda.empty_cache()
        sharded = sharded_train(scene, Path(tmp) / "sharded", trainer)
        shutil.rmtree(Path(tmp) / "sharded")
        torch.cuda.empty_cache()
        edit = edit_phase(scene, Path(tmp) / "tp1" / "gaussian-splatting", Path(tmp))
        torch.cuda.empty_cache()
        tools = tools_phase(scene, Path(tmp) / "tp1" / "gaussian-splatting", Path(tmp), trainer,
                            device)
        shutil.rmtree(Path(tmp) / "tp1")
        torch.cuda.empty_cache()
        capture = capture_phase(scene, Path(tmp), trainer, device)
        torch.cuda.empty_cache()
        # edit_phase's post-move capture: sphere 1 moved, the trainer phase's settings
        multi = multi_scene_phase(scene, Path(tmp) / "after_updating", Path(tmp), trainer, device)
        shutil.rmtree(Path(tmp) / "multi")
        torch.cuda.empty_cache()
        zoo = nerf_zoo_phase(scene, Path(tmp), device)
    torch.cuda.empty_cache()
    hashg = hash_grid_phase(device)
    torch.cuda.empty_cache()
    pose = pose_phase(device)
    torch.cuda.empty_cache()
    e2e = e2e_small_phase()
    voxel = voxel_cluster_phase(device)

    def kernel_row(name, source, replaces, row, launches):
        return {"name": name, "route": "cuda", "source": f"gaussiangrasper_torch/csrc/{source}.cu",
                "replaces": replaces, "launches": sum(launches.values()),
                "launches_by_path": launches, "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "wrapper_ms": row.get("wrapper_ms"), "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row.get("library_ms")}

    def large_row(row):
        return {k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                                    "bound_by", "bound_share")}

    def hash_rows():
        """H1-H3's rows: ms and bounds summed over the cell's three lookups
        a step (H2: proposal 0 without dL/dx, the others with), H3 at the
        field's lookup; launches by path from the zoo's CLIs (the runs'
        own counts, set to 0 before each) and this script's hash phase."""
        r, d = hashg["rows"], hashg["rows"]["field"]["double_backward"]
        cli_hashes = {"nerfacto": zoo["nerfacto"]["hash_launches"],
                      **{n: c["hash_launches"] for n, c in zoo["cli"].items()}}

        def by_path(h, phase):
            return {**{n: c[h] for n, c in cli_hashes.items() if c[h]}, "hash_grid_phase": phase}

        total = lambda key: sum(v[key] for v in r.values())  # noqa: E731
        h1 = {"max_abs_err": max(v["out_max_abs_err"] for v in r.values()), "ms": total("fwd_ms"),
              "plain_ms": total("plain_fwd_ms"), "bound_ms": total("bound_ms"),
              "bound_by": "bytes"}
        h2 = {"max_abs_err": max(max(v["grad_rel_errs"]) for v in r.values()),
              "ms": r["proposal_0"]["bwd_ms"] + r["proposal_1"]["bwd_dx_ms"]
              + r["field"]["bwd_dx_ms"], "plain_ms": total("plain_bwd_ms"),
              "bound_ms": total("bound_ms"), "bound_by": "bytes"}
        h3 = {"max_abs_err": max(d["grad_rel_errs"]), "ms": d["bwd2_ms"],
              "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"], "bound_by": "bytes"}
        src, none = "hash_grid", "none (models/encodings.py's plain lookup)"
        return [kernel_row("hash_grid_fwd", src, none, h1, by_path("h1", 3 + 1)),
                kernel_row("hash_grid_bwd", src, none, h2, by_path("h2", 3 + 1)),
                kernel_row("hash_grid_bwd2", src, none, h3, by_path("h3", 1))]

    def voxel_row():
        """V1's row: launches of the grasp CLIs (edit and e2e_small, each
        counted from 0, one a grasp) and the phase's own."""
        row = {"max_abs_err": voxel["roots_mismatched_launches"], "ms": voxel["kernel_ms"],
               "plain_ms": voxel["host_union_find_ms"], "bound_ms": voxel["bound_ms"],
               "bound_by": "launch latency (bytes bound given)"}
        return kernel_row("voxel_cluster", "voxel_cluster",
                          "none (scripts/grasp.py's host union-find)", row,
                          {"edit_grasp": edit["v1_launches"]["grasp"],
                           "e2e_small_grasp": e2e["v1_launches"]["grasp"],
                           "e2e_small_grasp_sweep": e2e["v1_launches"]["grasp_sweep"],
                           "voxel_cluster_phase": voxel["launches"]})

    def gather_row():
        """G1's row: the kernel pair's forward plus backward; launches (each
        entry's) of the train phase and of this script's phase."""
        by_path = {"train": sum(train["gather_launches"].values()),
                   "pixel_gather_phase": sum(gather["launches"].values())}
        return kernel_row("pixel_gather", "pixel_gather",
                          "none (models/model.py's advanced index, autograd's index_put)",
                          gather, by_path)

    def c71_row(row):
        return {k: row[k] for k in ("max_abs_err", "ms", "piece_kernel_ms", "plain_ms", "bound_ms",
                                    "bound_by")}

    emit({"kernels": [
        {**kernel_row("composite_pairs_fwd", "composite_pairs_fwd",
                      "rasterize_pallas.py:490 (_fwd_pairs_kernel)", full,
                      {"serve": serve["k1_launches"], "train": train["launches"]["k1"],
                       "trainer": trainer["launches_train"]["k1"],
                       "trainer_render": trainer["launches_render"]["k1"],
                       "trainer_tp2_render": trainer2["launches_render"]["k1"],
                       "table_phase_pair_render": table["render_launches"]["k1"],
                       "table_phase_pair_train": table["train_launches"]["k1"],
                       **{f"edit_{n}": edit["launches"][n]["k1"] for n in
                          ("update", "export_pointcloud", "export_texture", "psnr_renders")},
                       "capture": capture["launches"]["k1"],
                       "segment_train": segment["launches"]["k1"],
                       "sam_clip_train": sam_clip["train"]["launches"]["k1"],
                       "sam_clip_query": sam_clip["query"]["launches"]["k1"],
                       **{f"pose_{m}": pose["modes"][m]["launches"]["k1"] for m in pose["modes"]},
                       **{f"e2e_small_{n}": e2e["launches"][n]["k1"]
                          for n in ("train", "query", "grasp_sweep", "update")},
                       "sharded_split": split["launches"]["k1"],
                       "sharded_train": sharded["launches_train"]["k1"],
                       "sharded_render": sharded["launches_render"]["k1"],
                       "multi_scene": multi["launches_train"]["k1"],
                       **{f"multi_scene_render_{i}": multi["launches_render"][i]["k1"]
                          for i in range(2)},
                       **{f"tools_{n}": tools["launches"][n]["k1"] for n in
                          ("render_traj_interpolate", "render_traj_spiral", "trace", "viewer",
                           "viewer_train", "generate_data_train")}}),
         "c71": c71_row(full71), "dense_tile": {k: dense[k] for k in ("max_abs_err", "ms")}},
        {**kernel_row("composite_pairs_bwd", "composite_pairs_bwd",
                      "rasterize_pallas.py:600 (_bwd_pairs_kernel)", full2,
                      {"train": train["launches"]["k2"],
                       "trainer": trainer["launches_train"]["k2"],
                       "table_phase_pair_train": table["train_launches"]["k2"],
                       "edit_update": edit["launches"]["update"]["k2"],
                       "capture": capture["launches"]["k2"],
                       "segment_train": segment["launches"]["k2"],
                       "sam_clip_train": sam_clip["train"]["launches"]["k2"],
                       **{f"pose_{m}": pose["modes"][m]["launches"]["k2"] for m in pose["modes"]},
                       **{f"e2e_small_{n}": e2e["launches"][n]["k2"]
                          for n in ("train", "grasp_sweep", "update")},
                       "sharded_split": split["launches"]["k2"],
                       "sharded_train": sharded["launches_train"]["k2"],
                       "multi_scene": multi["launches_train"]["k2"],
                       **{f"tools_{n}": tools["launches"][n]["k2"] for n in
                          ("trace", "viewer_train", "generate_data_train")}}),
         "c71": c71_row(full2_71)},
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
        {**kernel_row("probe_affine", "probes", "pallas_probe.py:38 (kernel)",
                      probes["p1"], {"kernel_probe": probes["launches"]["p1"]}),
         "large": large_row(probes["p1_large"])},
        kernel_row("probe_read_at", "probes", "dma_probe.py:37 (_read_kernel)",
                   probes["p2"], {"copy_probe": probes["launches"]["p2"]}),
        {**kernel_row("probe_write_at", "probes", "dma_probe.py:65 (_write_kernel)",
                      probes["p3"], {"copy_probe": probes["launches"]["p3"]}),
         "large": large_row(probes["p3_large"])},
    ] + hash_rows() + [voxel_row(), gather_row()]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def narrow_inputs(args, c: int):
    """The same stream with only the first c colour channels (3: rgb; 23:
    the channels of a 16-d feature)."""
    import torch

    narrow = list(args)
    narrow[3] = torch.cat([narrow[3][:, :6], narrow[3][:, 6:6 + c]], 1).contiguous()
    narrow[4] = narrow[4][:c].contiguous()
    return tuple(narrow)


def widen_inputs(args, c: int):
    """The same stream with c colour channels (c > 39: a feature dim over
    32): the main path's 39 (x), then 1 - x, 0.25 x, 1 - x, ..., cut to c;
    bg likewise."""
    import torch

    attrs, bg = args[3], args[4]
    cols, bgs = [], []
    while 39 * len(cols) < c:
        i = len(cols)
        cols.append(attrs[:, 6:] * 0.5 ** i if i % 2 == 0 else 1.0 - attrs[:, 6:])
        bgs.append(bg * 0.5 ** i if i % 2 == 0 else 1.0 - bg)
    wide = torch.cat([attrs[:, :6]] + cols, 1)[:, :6 + c].contiguous()
    return args[:3] + (wide, torch.cat(bgs)[:c].contiguous()) + args[5:]


DENSE_ROWS = 2048


def dense_tile_inputs(device, channels: int = 39):
    """K1's inputs for two dense 32 x 32 tiles, background 0: each walks
    DENSE_ROWS large faint splats (conic 1e-5, opacity 0.0042: alpha just
    above 1/255 at every pixel, so every row composites and no pixel is cut
    before the last), colours of alternating sign by channel with
    magnitudes in [3.5, 4) on tile 0 and [4, 4.5) on tile 1, so |out| ends
    near 3.8 and 4.3, on either side of a binade edge. A tile this dense
    is where truncated colour sums err the most."""
    import torch

    rng = np.random.default_rng(11)
    n = 2 * DENSE_ROWS
    xy = rng.uniform(0.0, 32.0, (n, 2)) + np.repeat([[0.0, 0.0], [32.0, 0.0]], DENSE_ROWS, 0)
    geo = np.tile([1e-5, 0.0, 1e-5, 0.0042], (n, 1))
    mag = np.concatenate([rng.uniform(3.5, 4.0, (DENSE_ROWS, channels)),
                          rng.uniform(4.0, 4.5, (DENSE_ROWS, channels))])
    colors = mag * np.where(np.arange(channels) % 2 == 0, 1.0, -1.0)
    attrs = np.concatenate([xy, geo, colors], 1).astype(np.float32)

    def t(x):
        return torch.as_tensor(x, device=device)

    return (t(np.arange(n, dtype=np.int32)), t(np.array([0, DENSE_ROWS], np.int32)),
            t(np.full(2, DENSE_ROWS, np.int32)), t(attrs), torch.zeros(channels, device=device),
            2, 32)


def stream_table(args, kt=None):
    """K3's inputs (counts, tables, bg, tw, ts): the stream's rows of each
    tile packed into a (T, kt, 6 + C) table, kt the largest count unless
    given."""
    import torch

    gidx, starts, counts, attrs, bg, tw, ts = args
    kt = int(counts.max()) if kt is None else kt
    tables = torch.zeros(counts.shape[0], kt, attrs.shape[1], device=attrs.device)
    for t, (s, n) in enumerate(zip(starts.tolist(), counts.tolist())):
        tables[t, :n] = attrs[gidx[s: s + n].long()]
    return counts, tables, bg, tw, ts


def dense_tile_phase(device) -> dict:
    """K1 on two dense tiles (`dense_tile_inputs`: 2048 live rows a pixel,
    |out| ~4) against the plain version with K1's criterion, the share of
    the error's mass that lowers |out| beside it, K5 and K3 on the same rows
    bit-equal to K1; K1's time there."""
    import torch
    from gaussiangrasper_torch.ops import rasterize_cuda as rc

    args = dense_tile_inputs(device)
    row = check_k1("dense_tile_c39", args, time_it=False)
    got = rc._launch_kernel(*args)
    want = rc.composite_pairs_fwd_plain(*args, count_live=True)
    k5 = rc._launch_kernel(*args, two_tile=True)
    k3 = rc._launch_table_fwd(*stream_table(args))
    torch.cuda.synchronize()
    d = (got[0] - want[0]).double()
    row = {"phase": "dense_tile", "max_abs_err": row["max_abs_err"],
           "mean_abs_err": float(d.abs().mean()),
           "toward_zero": float(-(d * torch.sign(want[0])).sum() / d.abs().sum().clamp(min=1e-300)),
           "max_abs_out": float(want[0].abs().max()), "min_abs_out": float(want[0].abs().min()),
           "live_rows": [int(want[4].min()), int(want[4].max())],
           "k5_bit_equal": all(bool(torch.equal(a, b)) for a, b in zip(k5, got)),
           "k3_bit_equal": all(bool(torch.equal(a, b)) for a, b in zip(k3, got)),
           "ms": cuda_ms(lambda: rc._launch_kernel(*args), 20)}
    emit(row)
    if not (row["k5_bit_equal"] and row["k3_bit_equal"]) or row["live_rows"][0] != DENSE_ROWS:
        raise RuntimeError(f"dense_tile: K5 or K3 differs from K1, or a row did not composite: {row}")
    return row


def bench_camera(width: int, height: int, device):
    """bench.py's camera scaled to width x height: f = 1000 * width / 800,
    at the origin looking down -z."""
    from gaussiangrasper_torch.core.cameras import Camera

    f = 1000.0 * width / WIDTH
    return Camera.create(f, f, width / 2, height / 2, np.eye(4, dtype=np.float32)[:3],
                         width, height, device=device)


if __name__ == "__main__":
    sys.exit(main())
