"""PyTorch port vs the JAX package: binning, the K1 compositor and the
rasterizer.

- binning: integer outputs bit-equal to JAX `bin_gaussians(keep_pairs=True)`.
- K1: `composite_pairs_fwd_plain` (what the port runs on CPU tensors, and
  what chip_smoke.py holds the CUDA kernel against) vs the JAX Pallas
  kernel `_call_fwd_pairs` in interpret mode: out / alpha / logt at
  atol 1e-5 / rtol 1e-4 (float32, different exp/log1p rounding and sum
  order), ncomp exactly equal.
- rasterize_projected vs the port's and JAX's brute-force oracles at
  atol 2e-5 (the tolerance tests/test_pallas.py uses).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiangrasper_torch.ops import rasterize_cuda as rc
from gaussiangrasper_torch.ops.oracle import render_oracle as t_oracle
from gaussiangrasper_torch.ops.rasterize import RasterizeConfig, bin_gaussians, rasterize_projected
from gaussiangrasper_tpu.ops import rasterize_pallas as rp
from gaussiangrasper_tpu.ops.oracle import render_oracle as j_oracle
from gaussiangrasper_tpu.ops.rasterize import RasterizeConfig as JConfig
from gaussiangrasper_tpu.ops.rasterize import bin_gaussians as j_bin
from tests.test_torch_core import H, W, T, close, make_scene, project_both

BIN_CASES = {
    "plain": dict(n=300, cfg={}),
    "depth_tie": dict(n=300, cfg={}, tie=True),
    "overflow": dict(n=300, cfg=dict(max_gaussians_per_tile=40)),
    "pair_overflow": dict(n=300, cfg=dict(pair_budget_per_tile=30)),
    "dropped_tiles": dict(n=300, cfg=dict(max_tiles_per_gaussian=2), big=True),
}


def _bins_both(scene, jp, tp, cfg):
    jb = j_bin(jp, W, H, JConfig(**cfg), opacities=jnp.asarray(scene["opacities"]),
               build_table=False, keep_pairs=True)
    tb = bin_gaussians(tp, W, H, RasterizeConfig(**cfg), opacities=T(scene["opacities"]))
    return jb, tb


@pytest.mark.parametrize("case", list(BIN_CASES))
def test_binning_bit_equal(case):
    spec = BIN_CASES[case]
    scene = make_scene(20 + len(case), spec["n"])
    if spec.get("tie"):
        scene["means"][1::2, 2] = scene["means"][0::2, 2]  # pairs share a depth
    if spec.get("big"):
        scene["scales"] *= 6.0
    jp, tp = project_both(scene)
    tp = type(tp)(*(T(x) for x in jp))  # binning alone: the same projection in both
    jb, tb = _bins_both(scene, jp, tp, spec["cfg"])
    valid = min(int(np.asarray(jb.tile_count).sum()), jb.pair_gidx.shape[0])
    np.testing.assert_array_equal(tb.pair_gidx.numpy()[:valid], np.asarray(jb.pair_gidx)[:valid])
    assert tb.pair_gidx.shape == jb.pair_gidx.shape
    for name in ("pair_starts", "tile_count", "num_tiles_hit", "overflow", "dropped_tiles",
                 "pair_overflow"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)),
                                      err_msg=name)
    if case in ("overflow", "pair_overflow", "dropped_tiles"):
        assert int(getattr(tb, case)) > 0
    if spec.get("tie"):
        np.testing.assert_array_equal(tp.depths[1::2].numpy(), tp.depths[0::2].numpy())


def saturated_scene():
    """Nearly opaque Gaussians piled on one spot (tests/test_pallas.py:108):
    the transmittance cut must engage."""
    n = 400
    rng = np.random.default_rng(42)
    scene = make_scene(0, n)
    scene["means"] = np.concatenate(
        [rng.normal(size=(n, 2)) * 0.05, -2.0 - rng.uniform(size=(n, 1)) * 2.0], -1
    ).astype(np.float32)
    scene["scales"] = np.full((n, 3), 0.08, np.float32)
    scene["quats"] = np.tile(np.array([1.0, 0, 0, 0], np.float32), (n, 1))
    scene["opacities"] = np.full(n, 0.95, np.float32)
    return scene


def k1_inputs(scene, n_channels):
    """The clamped stream inputs of K1 for one scene, as numpy."""
    n = scene["means"].shape[0]
    scene["colors"] = np.random.default_rng(7).uniform(size=(n, n_channels)).astype(np.float32)
    jp, tp = project_both(scene)
    tp = type(tp)(*(T(x) for x in jp))
    jb, _ = _bins_both(scene, jp, tp, dict(max_gaussians_per_tile=n))
    b = jb.pair_gidx.shape[0]
    starts = np.minimum(np.asarray(jb.pair_starts), b).astype(np.int32)
    counts = np.minimum(np.minimum(np.asarray(jb.tile_count), n),
                        np.maximum(b - starts, 0)).astype(np.int32)
    attrs = np.concatenate([np.asarray(jp.xys), np.asarray(jp.conics),
                            scene["opacities"][:, None], scene["colors"]], 1).astype(np.float32)
    bg = np.linspace(0.1, 0.9, n_channels).astype(np.float32)
    return jp, np.asarray(jb.pair_gidx), starts, counts, attrs, bg


@pytest.mark.parametrize("scene_name,n_channels", [("saturated", 3), ("random", 39), ("empty", 3)])
def test_k1_plain_matches_pallas_interpret(scene_name, n_channels):
    if scene_name == "saturated":
        scene = saturated_scene()
    else:
        scene = make_scene(10, 300)
        if scene_name == "empty":
            scene["means"][:, 2] = 5.0  # all behind the camera
    jp, gidx, starts, counts, attrs, bg = k1_inputs(scene, n_channels)
    tw = -(-W // 32)
    n = attrs.shape[0]
    kr = -(-n // rp.KC) * rp.KC
    pair_attrs = rp._gather_pairs(jnp.asarray(gidx), jp.xys, jp.conics,
                                  jnp.asarray(attrs[:, 5]), jnp.asarray(attrs[:, 6:]), kr)
    ref = rp._call_fwd_pairs(jnp.asarray(starts), jnp.asarray(counts), pair_attrs,
                             jnp.asarray(bg)[None], tw, 32, starts.shape[0], n_channels, kr,
                             interpret=True)
    got = rc.composite_pairs_fwd(T(gidx), T(starts), T(counts), T(attrs), T(bg), tw, 32)
    for name, a, b in zip(("out", "alpha", "logt"), ref, got):
        close(b, a, atol=1e-5, rtol=1e-4, msg=name)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    if scene_name == "saturated":
        assert float(got[1].max()) > 1.0 - 2e-4  # the cut engaged
        assert (got[3].numpy() < counts[:, None]).any()
    if scene_name == "empty":
        assert counts.sum() == 0
        close(got[0], np.broadcast_to(bg, got[0].shape))


@pytest.mark.parametrize("scene_name", ["random", "saturated"])
def test_rasterize_projected_matches_oracles(scene_name):
    scene = saturated_scene() if scene_name == "saturated" else make_scene(11, 300)
    n = scene["means"].shape[0]
    jp, tp = project_both(scene)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    cfg = RasterizeConfig(max_gaussians_per_tile=n)
    out = rasterize_projected(tp, T(scene["colors"]), T(scene["opacities"]), T(bg), W, H, cfg)
    assert out["image"].shape == (H, W, 3) and out["alpha"].shape == (H, W)
    assert int(out["bins"].pair_overflow) == 0
    ours = t_oracle(tp, T(scene["colors"]), T(scene["opacities"]), T(bg), W, H, tile_size=32)
    theirs = j_oracle(jp, jnp.asarray(scene["colors"]), jnp.asarray(scene["opacities"]),
                      jnp.asarray(bg), W, H, tile_size=32)
    close(ours, theirs, atol=2e-5, rtol=1e-4, msg="oracle vs JAX oracle")
    close(out["image"], theirs, atol=2e-5, rtol=1e-4, msg="rasterize vs JAX oracle")
    close(out["image"], ours, atol=2e-5, rtol=1e-4, msg="rasterize vs oracle")


def test_pair_stream_backward_is_the_next_slice():
    """The backward that the serving slice left to the training slice (K2)
    now runs: rasterize_projected's gradients for the projected centres,
    conics, colours, opacities and background match jax.grad of the JAX
    rasterize_projected (the xla backend on the CPU) at 1e-4 of each
    gradient's max (float32 sums in another order)."""
    import jax

    from gaussiangrasper_tpu.ops.rasterize import rasterize_projected as j_rasterize

    scene = make_scene(12, 300)
    jp, tp0 = project_both(scene)
    rng = np.random.default_rng(13)
    wimg = rng.normal(size=(H, W, 3)).astype(np.float32)
    walpha = rng.normal(size=(H, W)).astype(np.float32)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    leaves = [np.asarray(jp.xys), np.asarray(jp.conics), scene["colors"], scene["opacities"], bg]

    def jloss(xys, conics, colors, opac, bgj):
        out = j_rasterize(jp._replace(xys=xys, conics=conics), colors, opac, bgj, W, H, JConfig())
        return jnp.sum(out["image"] * wimg) + jnp.sum(out["alpha"] * walpha)

    want = jax.grad(jloss, argnums=tuple(range(5)))(*map(jnp.asarray, leaves))
    tl = [T(x).requires_grad_(True) for x in leaves]
    tp = type(tp0)(*(T(x) for x in jp))._replace(xys=tl[0], conics=tl[1])
    out = rasterize_projected(tp, tl[2], tl[3], tl[4], W, H)
    loss = (out["image"] * T(wimg)).sum() + (out["alpha"] * T(walpha)).sum()
    for name, g, ref in zip(("xys", "conics", "colors", "opacities", "bg"),
                            torch.autograd.grad(loss, tl), want):
        ref = np.asarray(ref)
        assert torch.isfinite(g).all(), name
        assert float((g - T(ref)).abs().max()) <= 1e-4 * float(np.abs(ref).max()), name
        assert float(np.abs(ref).max()) > 0, name


def test_kernel_wrapper_checks_inputs():
    i32 = torch.int32
    with pytest.raises(ValueError, match="int32"):
        rc.composite_pairs_fwd(torch.zeros(4, dtype=torch.int64), torch.zeros(1, dtype=i32),
                               torch.zeros(1, dtype=i32), torch.zeros(2, 9), torch.zeros(3),
                               1, 32)
    # a segment past the end of the stream, and an index past the table
    for gidx, count in (([0, 1, 0, 1], 5), ([0, 1, 2, 1], 4)):
        with pytest.raises(ValueError, match="must lie in"):
            rc.composite_pairs_fwd(torch.tensor(gidx, dtype=i32), torch.zeros(1, dtype=i32),
                                   torch.tensor([count], dtype=i32), torch.zeros(2, 9),
                                   torch.zeros(3), 1, 32)
