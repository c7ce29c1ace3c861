"""The work the inputs need, counted by the benchmark, and its least time
on one H100 at the published peaks (NVIDIA's data sheet, SXM part, 700 W).

Rooflines and every `mfu` divide these least times by measured time, so
a kernel that culls harder or skips work cannot move its own yardstick:
K1's and K2's visits come from the reference's walk on the traced step's
inputs, not from a kernel's cull or counters. The arithmetic follows
chip_smoke.py at commit d90391f (`roofline`, `walk_ops`, `grad_ops`): f32
work at 67 TFLOP/s, the colour products at the 3xTF32 rate (495 / 3
TFLOP/s, three TF32 products for one of f32 grade), and bytes at
3.35 TB/s, each input read once and each output written once.
"""

from __future__ import annotations

from typing import Dict

F32_PEAK = 67e12
TF32_PEAK = 495e12
TF32X3_PEAK = TF32_PEAK / 3
HBM_PEAK = 3.35e12
F32 = 4


def least_s(ops: float = 0.0, tc_ops: float = 0.0, nbytes: float = 0.0) -> float:
    """The larger of the operations' time (f32 outside the tensor cores
    plus 3xTF32 products) and the bytes' time."""
    return max(ops / F32_PEAK + tc_ops / TF32X3_PEAK, nbytes / HBM_PEAK)


def k1_least(visits: float, live: float, walked_rows: float, n_rows: int, c: int,
             pixels: int, tiles: int) -> Dict[str, float]:
    """The ideal front-to-back walk: each pixel visits its tile's pairs up
    to the last one it composites (16 operations: dx, dy, sigma, exp,
    alpha, the tests), each composited visit adds 6 (log1p, the running
    sum, the cut test, exp, the weight, logT) and its 2C colour products.
    Bytes: the (N, 6 + C) attribute rows, the walked stream indices, the
    tiles' bounds, bg, and out, alpha, logT, ncomp written once."""
    ops = 16.0 * visits + 6.0 * live
    tc = 2.0 * c * live
    nbytes = F32 * (n_rows * (6 + c) + walked_rows + 2 * tiles + c + pixels * (c + 3))
    return {"ops": ops, "tc_ops": tc, "bytes": nbytes, "least_s": least_s(ops, tc, nbytes)}


def k2_least(visits: float, live: float, walked_rows: float, n_rows: int, c: int,
             pixels: int, tiles: int) -> Dict[str, float]:
    """The same visits in reverse: 16 operations a visit, 40 more a
    composited one (log1p, exp, dalpha, the conic chain, the sums) and its
    4C products (<c, g> and dcolour). Bytes: the attribute rows, the walked
    indices, bg, g_out, g_alpha, logT, ncomp read once, and the
    per-Gaussian (N, 6 + C) gradient written once."""
    ops = 16.0 * visits + 40.0 * live
    tc = 4.0 * c * live
    nbytes = F32 * (2 * n_rows * (6 + c) + walked_rows + 2 * tiles + c + pixels * (c + 3))
    return {"ops": ops, "tc_ops": tc, "bytes": nbytes, "least_s": least_s(ops, tc, nbytes)}


def splat_step_least(n_live: int, sh_bases: int, feature_dim: int, clip_dim: int,
                     hidden: int, height: int, width: int, pairs: int, points: int,
                     k1: Dict[str, float], k2: Dict[str, float],
                     params_per_row: int, accum_params_per_row: int,
                     accum: int, refine_every: int) -> Dict[str, float]:
    """Least seconds of one training step of the splat model by part, over
    the live rows: projection (~300 operations a Gaussian forward, 600
    back; 10 floats in, 12 out), SH colour (3 operations a basis and 2 a
    coefficient product, forward, twice that back), K1 and K2, the losses
    (an 11-tap separable blur of 5 maps of 3 channels for SSIM, the L1,
    depth and normal terms: ~800 operations a pixel with the backward;
    the pixel maps read and written once), the feature pairs and the
    fea_up MLP (forward and two backward products), grouped Adam (a due
    group's parameter reads p, g, m, v and writes p, m, v; a group that
    accumulates over `accum` steps reads and writes its accumulator on
    the others), and refine every `refine_every` steps (the live rows'
    parameters and moments read and written once)."""
    proj = least_s(ops=900.0 * n_live, nbytes=F32 * n_live * 2 * (10 + 12))
    sh_ops = 3.0 * (sh_bases * 3 + sh_bases * 3 * 2) * n_live
    sh = least_s(ops=sh_ops, nbytes=F32 * n_live * 2 * (sh_bases * 3 + 3))
    px = height * width
    loss = least_s(ops=800.0 * px, nbytes=F32 * px * 2 * (3 + 3 + 1 + 1 + 3 + 3 + 1 + feature_dim))
    mlp_flops = 2.0 * (feature_dim * hidden + hidden * clip_dim)
    fea = least_s(ops=3 * mlp_flops * points + 3 * 8.0 * feature_dim * (2 * pairs + points),
                  nbytes=F32 * points * clip_dim)
    due = params_per_row - accum_params_per_row
    adam_bytes = F32 * n_live * (7 * due + 3 * accum_params_per_row * (accum - 1) / accum
                                 + 7 * accum_params_per_row / accum)
    adam = least_s(ops=12.0 * n_live * params_per_row, nbytes=adam_bytes)
    refine = least_s(nbytes=F32 * n_live * params_per_row * 3 * 2) / refine_every
    parts = {"projection": proj, "sh": sh, "k1": k1["least_s"], "k2": k2["least_s"],
             "losses": loss, "features": fea, "adam": adam, "refine": refine}
    parts["step"] = sum(parts.values())
    return parts


def query_least(n_live: int, sh_bases: int, feature_dim: int, clip_dim: int, hidden: int,
                height: int, width: int, canonicals: int, k1: Dict[str, float]) -> Dict[str, float]:
    """Least seconds of one served text query: projection and SH forward,
    K1, the lift of every pixel's feature through fea_up (f32 products;
    the (H, W, 512) map written once), and the relevancy (the map read
    once, 2 x 512 operations a pixel for each of 1 + K dot products and
    the norms), the reply copied out once."""
    proj = least_s(ops=300.0 * n_live + 9.0 * sh_bases * n_live,
                   nbytes=F32 * n_live * (10 + 12 + sh_bases * 3))
    px = height * width
    lift = least_s(ops=2.0 * px * (feature_dim * hidden + hidden * clip_dim),
                   nbytes=F32 * px * (feature_dim + clip_dim))
    rel = least_s(ops=2.0 * px * clip_dim * (canonicals + 2), nbytes=F32 * px * (clip_dim + 1))
    parts = {"projection": proj, "k1": k1["least_s"], "lift": lift, "relevancy": rel}
    parts["request"] = sum(parts.values())
    return parts


def nerfacto_step_least(rays: int, samples: list, levels: list, features: int,
                        mlp_flops_per_sample: list, table_params: int,
                        params: int) -> Dict[str, float]:
    """Least seconds of one nerfacto training step by part. For each
    sampling level (the proposal fields, then the field): each sample's
    hash lookup (8 corners a grid level: the spatial hash, about 12
    operations, and the trilinear weight and its F products) and the
    level's MLP products, forward and twice again backward; the
    distortion loss's S^2 pairs of the last level; the hash tables read
    once; and Adam over every parameter (p, g, m, v read; p, m, v
    written), as nerfstudio's nerfacto updates them all each step."""
    ops = 0.0
    for s, lv, mlp in zip(samples, levels, mlp_flops_per_sample):
        per_sample = lv * 8 * (12 + 2 * features + 4) + mlp
        ops += 3.0 * rays * s * per_sample
    ops += 3.0 * 6.0 * rays * samples[-1] ** 2
    march = least_s(ops=ops, nbytes=F32 * table_params)
    adam = least_s(ops=12.0 * params, nbytes=F32 * 7 * params)
    parts = {"march": march, "adam": adam}
    parts["step"] = sum(parts.values())
    return parts
