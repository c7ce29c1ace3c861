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
- K2's precision scheme: the plain version with its two 39-wide products
  (gc and dcolour) taken in 3xTF32, as the CUDA kernel takes them on the
  tensor cores, vs `_call_bwd_pairs` in interpret mode: per-Gaussian sums
  within 1e-4 of each column group's max (the kernel's criterion on the
  card); with one or two TF32 passes some group misses it.
"""

import functools

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
    tb = bin_gaussians(tp, W, H, RasterizeConfig(**cfg), opacities=T(scene["opacities"]),
                       build_table=False, keep_pairs=True)
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


def test_pair_stream_backward_matches_jax_grad():
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


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as `cvt.rna.tf32.f32` rounds it: the 13 low
    mantissa bits dropped, to the nearest, ties away from zero (an add on
    the bit pattern carries into the exponent where it must)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """float32 as the tensor core reads an f32 bit pattern for a TF32
    operand: the 13 low mantissa bits dropped (toward zero)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def einsum_3xtf32(equation, a, b):
    """The product as K2 takes it on the tensor cores: each operand split
    into hi = tf32(x) and lo = x - hi, which the tensor core truncates to
    TF32, then lo hi + hi lo + hi hi (lo lo dropped), summed in float32."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32_truncated(a - ah), tf32_truncated(b - bh)
    return (_einsum(equation, al, bh) + _einsum(equation, ah, bl)) + _einsum(equation, ah, bh)


def einsum_1xtf32(equation, a, b):
    """A single-pass TF32 product: hi hi only."""
    return _einsum(equation, tf32(a), tf32(b))


def einsum_2xtf32(equation, a, b):
    """Two passes: lo hi + hi hi (the operand b's low part dropped)."""
    ah, bh = tf32(a), tf32(b)
    return _einsum(equation, tf32_truncated(a - ah), bh) + _einsum(equation, ah, bh)


_einsum = torch.einsum
K2_PRODUCTS = ("tc,tpc->tp", "tp,tpc->tc")  # gc and dcolour in composite_pairs_bwd_plain
K2_GROUPS = (("dxy", 0, 2), ("dconic", 2, 5), ("dopacity", 5, 6), ("dcolor", 6, 45))


def test_tf32_rounding_helper():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, 3.0e-5], dtype=torch.float32)
    want = [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9, -(1.0 + 2.0 ** -10), 1.0]
    assert tf32(x)[:5].tolist() == want  # ties away from zero, both signs
    y = tf32(x[5:])
    assert (y.view(torch.int32) & 0x1FFF).item() == 0 and abs(float(y - x[5:])) <= 2.0 ** -11 * 3.0e-5
    z = torch.tensor([1.0 + 2.0 ** -10 + 2.0 ** -11, -(1.0 + 2.0 ** -11)], dtype=torch.float32)
    assert tf32_truncated(z).tolist() == [1.0 + 2.0 ** -10, -1.0]  # toward zero


@functools.lru_cache(maxsize=None)
def k2_precision_case(scene_name):
    """K2's inputs at C 39 for one scene, and the per-Gaussian sums of
    `_call_bwd_pairs` in interpret mode on them (float64, (N, 45))."""
    scene = saturated_scene() if scene_name == "saturated" else make_scene(10, 300)
    jp, gidx, starts, counts, attrs, bg = k1_inputs(scene, 39)
    tw = -(-W // 32)
    kr = -(-attrs.shape[0] // rp.KC) * rp.KC
    pair_attrs = rp._gather_pairs(jnp.asarray(gidx), jp.xys, jp.conics, jnp.asarray(attrs[:, 5]),
                                  jnp.asarray(attrs[:, 6:]), kr)
    _, alpha, logt, ncomp = rp._call_fwd_pairs(jnp.asarray(starts), jnp.asarray(counts), pair_attrs,
                                               jnp.asarray(bg)[None], tw, 32, starts.shape[0], 39,
                                               kr, interpret=True)
    rng = np.random.default_rng(5)
    g_out = rng.normal(size=alpha.shape + (39,)).astype(np.float32)
    g_alpha = rng.normal(size=alpha.shape).astype(np.float32)
    ref = rp._call_bwd_pairs(jnp.asarray(starts), jnp.asarray(counts), pair_attrs, jnp.asarray(bg),
                             jnp.asarray(g_out), jnp.asarray(g_alpha), logt, ncomp, tw, 32, kr,
                             interpret=True)
    args = (T(gidx), T(starts), T(counts), T(attrs), T(bg), T(g_out), T(g_alpha), T(logt),
            T(ncomp), tw, 32)
    return args, k2_per_gaussian(gidx, attrs.shape[0], np.asarray(ref)[: gidx.shape[0], :45])


def k2_per_gaussian(gidx, n, rows):
    acc = np.zeros((n, 45), np.float64)
    np.add.at(acc, gidx, rows)
    return acc


def k2_emulated_errors(scene_name, product, monkeypatch):
    """The plain version with gc and dcolour taken by `product`: per column
    group, max |error| of the per-Gaussian sums against the JAX kernel's
    over the group's max |value|."""
    args, ref_g = k2_precision_case(scene_name)
    exact = rc.composite_pairs_bwd_plain(*args)
    products = []

    def patched(equation, *operands):
        if equation in K2_PRODUCTS:
            products.append(equation)
            return product(equation, *operands)
        return _einsum(equation, *operands)

    monkeypatch.setattr(torch, "einsum", patched)
    got = rc.composite_pairs_bwd_plain(*args)
    monkeypatch.undo()
    assert set(products) == set(K2_PRODUCTS)
    assert not torch.equal(got, exact)  # the scheme rounds: the emulation took effect
    got_g = k2_per_gaussian(args[0].numpy(), args[3].shape[0], got.numpy())
    errs = {}
    for name, lo, hi in K2_GROUPS:
        scale = float(np.abs(ref_g[:, lo:hi]).max())
        assert scale > 0, name
        errs[name] = float(np.abs(got_g[:, lo:hi] - ref_g[:, lo:hi]).max()) / scale
    return errs


@pytest.mark.parametrize("scene_name", ["random", "saturated"])
def test_k2_tensor_core_precision_meets_criterion(scene_name, monkeypatch):
    errs = k2_emulated_errors(scene_name, einsum_3xtf32, monkeypatch)
    for name, err in errs.items():
        assert err <= 1e-4, name


@pytest.mark.parametrize("scene_name", ["random", "saturated"])
@pytest.mark.parametrize("scheme", ["1xtf32", "2xtf32"])
def test_k2_fewer_tf32_passes_break_criterion(scene_name, scheme, monkeypatch):
    """The criterion is tight enough to tell K2's scheme from a cheaper
    one: with one TF32 pass, or two (one operand's low part dropped), the
    per-Gaussian sums miss 1e-4 in some column group, so a kernel that
    dropped to either fails the card's check."""
    product = {"1xtf32": einsum_1xtf32, "2xtf32": einsum_2xtf32}[scheme]
    errs = k2_emulated_errors(scene_name, product, monkeypatch)
    assert max(errs.values()) > 1e-4, errs


def test_k2_warp_row_counts():
    """count_warp_rows against a count written out tile by tile and warp by
    warp: walked (row k below some lane's min(ncomp, count)) and live (a
    lane's row also passes sigma >= 0 and alpha >= 1/255)."""
    jp, gidx, starts, counts, attrs, bg = k1_inputs(make_scene(10, 300), 3)
    tw = -(-W // 32)
    args = (T(gidx), T(starts), T(counts), T(attrs), T(bg))
    _, _, logt, ncomp = rc.composite_pairs_fwd_plain(*args, tw, 32)
    zeros = torch.zeros(ncomp.shape + (3,))
    _, rows, live = rc.composite_pairs_bwd_plain(*args, zeros, zeros[..., 0], logt, ncomp, tw, 32,
                                                 count_warp_rows=True)
    warps = rc.warp_pixels(32)
    assert sorted(warps.tolist()) == list(range(32 * 32))
    first = warps.view(-1, 32)[:, 0]  # each warp's 8 x 4 block starts on the block grid
    assert bool((first % 32 % 8 == 0).all() and (first // 32 % 4 == 0).all())
    kstart = torch.minimum(ncomp.long(), T(counts).long()[:, None])
    want_rows = want_live = 0
    for t in range(starts.shape[0]):
        px = float((t % tw) * 32) + (warps % 32).float()
        py = float((t // tw) * 32) + (warps // 32).float()
        ks = kstart[t, warps].view(-1, 32)
        want_rows += int(ks.amax(1).sum())
        for k in range(int(ks.max())):
            row = T(attrs[gidx[starts[t] + k]])
            dx, dy = px - row[0], py - row[1]
            sigma = 0.5 * (row[2] * dx * dx + row[4] * dy * dy) + row[3] * dx * dy
            alpha = torch.clamp(row[5] * torch.exp(-sigma), max=0.999)
            ok = (kstart[t, warps] > k) & (sigma >= 0) & (alpha >= 1.0 / 255.0)
            want_live += int(ok.view(-1, 32).any(1).sum())
    assert (rows, live) == (want_rows, want_live)
    assert 0 < live < rows
