"""K1's and K2's least times on one render's inputs: the reference
projects, bins and walks the field as the step or request did, counting
each pixel's visits up to its last composited pair and its composited
ones (`composite_pairs_fwd_plain(walk_counts=True)`), which `work` turns
into least times. The program's own cull or counters take no part."""

from __future__ import annotations

import importlib
from typing import Dict, Tuple

from . import common, work

REF = "gaussiangrasper-efd"


def splat_walk(field, alive, camera, step: int, model_cfg) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(K1's, K2's) work and least time on `field` (the reference's
    GaussianParams) seen by `camera` (the reference's Camera) at `step`."""
    import torch

    pkg = common.reference(REF)
    ref_model = importlib.import_module(f"{pkg.__name__}.model")
    ref_raster = importlib.import_module(f"{pkg.__name__}.raster")
    raster = model_cfg.raster
    with torch.no_grad(), pkg.precision(False):
        proj, colors, opac, bg = ref_model.render_inputs(field, alive, camera, step, model_cfg)
        bins = ref_raster.bin_gaussians(proj, camera.width, camera.height, raster, opacities=opac,
                                        build_table=False, keep_pairs=True)
        k = min(raster.max_gaussians_per_tile, proj.xys.shape[0])
        starts, counts = ref_raster.stream_bounds(bins.pair_gidx, bins.pair_starts,
                                                  bins.tile_count, k)
        attrs = ref_raster.pack_attrs(proj.xys, proj.conics, opac, colors)
        tw, _ = ref_raster.tile_grid(camera.width, camera.height, raster.tile_size)
        out, _, _, _, visits, live = ref_raster.composite_pairs_fwd_plain(
            bins.pair_gidx.int(), starts, counts, attrs, bg, tw, raster.tile_size, walk_counts=True)
    args = (float(visits.double().sum()), float(live.double().sum()), float(counts.double().sum()),
            attrs.shape[0], attrs.shape[1] - 6, out.shape[0] * out.shape[1], out.shape[0])
    return work.k1_least(*args), work.k2_least(*args)
