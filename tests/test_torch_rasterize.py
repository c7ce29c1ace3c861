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

from gaussiangrasper_torch import _build
from gaussiangrasper_torch.ops import rasterize_cuda as rc
from gaussiangrasper_torch.ops.oracle import render_oracle as t_oracle
from gaussiangrasper_torch.ops.rasterize import RasterizeConfig, bin_gaussians, rasterize_projected
from gaussiangrasper_torch.probes import kernels as pk
from gaussiangrasper_tpu.ops import rasterize_pallas as rp
from gaussiangrasper_tpu.ops.oracle import render_oracle as j_oracle
from gaussiangrasper_tpu.ops.rasterize import RasterizeConfig as JConfig
from gaussiangrasper_tpu.ops.rasterize import bin_gaussians as j_bin
from tests.test_torch_core import H, W, T, close, make_scene, project_both
from tests.test_torch_gpu import dense_tile_args, precision_reading, tensor_core_fwd

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


def meta_entry_call(name: str, two_tile: bool):
    """A call of the public kernel entry `name` on meta tensors of valid
    shapes and dtypes (2 tiles of 32 x 32 pixels, C 3)."""
    def m(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    i32, t, p, c = torch.int32, 2, 32 * 32, 3
    stream = (m(8, dtype=i32), m(t, dtype=i32), m(t, dtype=i32), m(4, 6 + c), m(c))
    table = (m(t, dtype=i32), m(t, 5, 6 + c), m(c))
    grads = (m(t, p, c), m(t, p), m(t, p), m(t, p))
    blocks = m(2, dtype=i32)
    return {
        "composite_pairs_fwd": lambda: rc.composite_pairs_fwd(*stream, 1, 32, two_tile=two_tile),
        "composite_pairs_bwd": lambda: rc.composite_pairs_bwd(*stream, *grads, 1, 32,
                                                              two_tile=two_tile),
        "composite_tables_fwd": lambda: rc.composite_tables_fwd(*table, 1, 32),
        "composite_tables_bwd": lambda: rc.composite_tables_bwd(*table, *grads, 1, 32),
        "affine": lambda: pk.affine(m(8, pk.COLS)),
        "read_at": lambda: pk.read_at(m(512, pk.COLS), blocks),
        "write_at": lambda: pk.write_at(m(2, pk.BLOCK_ROWS, pk.COLS), blocks, 512),
    }[name]


@pytest.mark.parametrize("name, two_tile", [
    ("composite_pairs_fwd", False), ("composite_pairs_fwd", True), ("composite_pairs_bwd", False),
    ("composite_pairs_bwd", True), ("composite_tables_fwd", False),
    ("composite_tables_bwd", False), ("affine", False), ("read_at", False), ("write_at", False)])
def test_kernel_entries_raise_off_cuda_and_cpu(name, two_tile):
    """The one device rule (`_device.use_kernel`) of every public kernel
    entry: a device other than cuda or cpu raises ValueError naming the
    entry, before any input check that reads values (a host sync a meta
    tensor cannot take), and nothing is launched."""
    before = _build.launches.copy()
    with pytest.raises(ValueError, match=f"^{name} runs on cuda or cpu, not meta$"):
        meta_entry_call(name, two_tile)()
    assert _build.launches == before


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
    acc = np.zeros((n, rows.shape[1]), np.float64)
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


K1_PRODUCT = "tp,tc->tpc"  # the colour terms in composite_pairs_fwd_plain


@functools.lru_cache(maxsize=None)
def k1_precision_case(scene_name):
    """K1's inputs at C 39 for one scene and `_call_fwd_pairs`'s outputs on
    them in interpret mode."""
    scene = saturated_scene() if scene_name == "saturated" else make_scene(10, 300)
    jp, gidx, starts, counts, attrs, bg = k1_inputs(scene, 39)
    tw = -(-W // 32)
    kr = -(-attrs.shape[0] // rp.KC) * rp.KC
    pair_attrs = rp._gather_pairs(jnp.asarray(gidx), jp.xys, jp.conics, jnp.asarray(attrs[:, 5]),
                                  jnp.asarray(attrs[:, 6:]), kr)
    ref = rp._call_fwd_pairs(jnp.asarray(starts), jnp.asarray(counts), pair_attrs,
                             jnp.asarray(bg)[None], tw, 32, starts.shape[0], 39, kr, interpret=True)
    args = (T(gidx), T(starts), T(counts), T(attrs), T(bg), tw, 32)
    return args, [np.asarray(x) for x in ref]


def k1_emulated_errors(scene_name, product, monkeypatch):
    """The plain forward with its colour terms taken by `product`: max
    |out - JAX out|, and the same for alpha, logt (ncomp must be equal)."""
    args, ref = k1_precision_case(scene_name)
    exact = rc.composite_pairs_fwd_plain(*args)
    taken = []

    def patched(equation, *operands):
        if equation == K1_PRODUCT:
            taken.append(equation)
            return product(equation, *operands)
        return _einsum(equation, *operands)

    monkeypatch.setattr(torch, "einsum", patched)
    got = rc.composite_pairs_fwd_plain(*args)
    monkeypatch.undo()
    assert taken and not torch.equal(got[0], exact[0])  # the emulation took effect
    for a, b in zip(got[1:], exact[1:]):  # only the colour sums round differently
        assert torch.equal(a, b)
    np.testing.assert_array_equal(got[3].numpy(), ref[3])
    return {name: float(np.abs(a.numpy() - b).max())
            for name, a, b in zip(("out", "alpha", "logt"), got, ref)}


@pytest.mark.parametrize("scene_name", ["random", "saturated"])
def test_k1_tensor_core_precision_meets_criterion(scene_name, monkeypatch):
    """K1's colour sums in 3xTF32 (the kernel's mma.sync scheme, emulated in
    the plain version) stay within chip_smoke.py's 1e-4 of the JAX kernel."""
    errs = k1_emulated_errors(scene_name, einsum_3xtf32, monkeypatch)
    assert max(errs.values()) <= 1e-4, errs


@pytest.mark.parametrize("scene_name", ["random", "saturated"])
def test_k1_one_tf32_pass_breaks_criterion(scene_name, monkeypatch):
    """With one TF32 pass (hi hi) the colour sums miss 1e-4, so the card's
    check would catch a K1 that dropped to it."""
    errs = k1_emulated_errors(scene_name, einsum_1xtf32, monkeypatch)
    assert errs["out"] > 1e-4, errs


@pytest.mark.parametrize("scene_name", ["random", "saturated"])
def test_k1_truncating_tensor_core_sums_meet_criterion(scene_name):
    """K1's colour sums as the card's tensor cores take them (3xTF32 in
    groups of 8 rows, each product's sum rounded toward zero:
    `tensor_core_fwd`) stay within chip_smoke.py's 1e-4 of the JAX kernel,
    err toward zero, and leave alpha, logt and ncomp as they are."""
    args, ref = k1_precision_case(scene_name)
    exact = rc.composite_pairs_fwd_plain(*args)
    got = tensor_core_fwd(args, "rz")
    for a, b in zip(got[1:], exact[1:]):
        assert torch.equal(a, b)
    assert float(np.abs(got[0].numpy() - ref[0]).max()) <= 1e-4
    d = (got[0] - exact[0]).double()
    assert float((d * torch.sign(exact[0])).sum()) < -0.5 * float(d.abs().sum())


def test_k1_warp_row_counts():
    """The forward's count_warp_rows against a count written out tile by
    tile, warp by warp and window by window: walked (row k before or at
    some lane's cut, below the count), live (a lane composites row k), kept
    (the row's cull box meets the warp's pixel bounds), kept visits (the
    walking lanes of kept rows), box tests (the rows of each 32-row window
    a warp enters with a lane walking) and products (a window's kept rows 8
    at a time, a group with a composited row)."""
    jp, gidx, starts, counts, attrs, bg = k1_inputs(saturated_scene(), 3)
    tw = -(-W // 32)
    args = (T(gidx), T(starts), T(counts), T(attrs), T(bg), tw, 32)
    *_, work = rc.composite_pairs_fwd_plain(*args, count_warp_rows=True)
    _, _, _, ncomp = rc.composite_pairs_fwd_plain(*args)
    warps = rc.warp_pixels(32).view(-1, 32)
    want = dict.fromkeys(work, 0)
    for t in range(starts.shape[0]):
        n = int(counts[t])
        for lanes in warps:
            px = float((t % tw) * 32) + (lanes % 32).float()
            py = float((t // tw) * 32) + (lanes // 32).float()
            cutk = ncomp[t, lanes]  # a cut pixel stops at its cut row, an uncut one at the count
            for w0 in range(0, n, 32):
                if not bool((cutk >= w0).any()):
                    break
                want["box_tests"] += min(32, n - w0)
                groups = []
                for k in range(w0, min(w0 + 32, n)):
                    walking = cutk >= k
                    if not bool(walking.any()):
                        break
                    row = T(attrs[gidx[starts[t] + k]])
                    dx, dy = px - row[0], py - row[1]
                    sigma = 0.5 * (row[2] * dx * dx + row[4] * dy * dy) + row[3] * dx * dy
                    alpha = torch.clamp(row[5] * torch.exp(-sigma), max=0.999)
                    comp = walking & (cutk > k) & (sigma >= 0) & (alpha >= 1.0 / 255.0)
                    want["warp_rows"] += 1
                    want["live_warp_rows"] += int(comp.any())
                    # the cull box, in float32: |dx| <= sqrt(2 L c / det), |dy| <= sqrt(2 L a
                    # / det) with L = log(255 o) + 0.05, widened by 0.1% and 1e-3
                    x, y, a, b, c, o = attrs[gidx[starts[t] + k], :6]
                    f = np.float32
                    det = a * c - b * b
                    if not o >= f(1.0 / 255.0):
                        rx = ry = f(-1.0)
                    elif a > 0 and c > 0 and det > f(1e-4) * a * c:
                        l2 = f(2.0) * (np.log(f(255.0) * o) + f(0.05))
                        rx = np.sqrt(l2 * c / det) * f(1.001) + f(1e-3)
                        ry = np.sqrt(l2 * a / det) * f(1.001) + f(1e-3)
                    else:
                        rx = ry = f(np.inf)
                    if (x + rx < f(px.min()) or x - rx > f(px.max())
                            or y + ry < f(py.min()) or y - ry > f(py.max())):
                        continue
                    want["kept_warp_rows"] += 1
                    want["kept_visits"] += int(walking.sum())
                    groups.append(bool(comp.any()))
                want["products"] += sum(any(groups[i:i + 8]) for i in range(0, len(groups), 8))
    assert work == want
    assert 0 < work["products"] < work["live_warp_rows"] <= work["kept_warp_rows"] \
        < work["warp_rows"]
    assert work["kept_visits"] < 32 * work["kept_warp_rows"]


def test_k1_colour_sums_on_a_dense_tile_emulated():
    """The CPU half of the dense-tile check (`dense_tile_args`: 2048 live
    rows a pixel, |out| ~4): the plain version within 1e-4 of JAX's
    `_call_fwd_pairs` in interpret mode; the tensor cores' sums emulated
    (`tensor_core_fwd`) as the first tensor-core K1 took them, each product
    truncated into the running sum ("rz"), err past 1e-4, all toward zero
    (the card showed the same), where rounding to nearest ("rn") leaves no
    such bias; as K1 takes them now, each group's products
    into a zeroed sum added in IEEE f32 ("group"), within 1e-4 of the plain
    version and of JAX."""
    args = dense_tile_args("cpu")
    gidx, starts, counts, attrs, bg, tw, ts = (a.numpy() if torch.is_tensor(a) else a for a in args)
    kr = -(-attrs.shape[0] // rp.KC) * rp.KC
    pair_attrs = rp._gather_pairs(jnp.asarray(gidx), jnp.asarray(attrs[:, :2]),
                                  jnp.asarray(attrs[:, 2:5]), jnp.asarray(attrs[:, 5]),
                                  jnp.asarray(attrs[:, 6:]), kr)
    ref = torch.tensor(np.asarray(rp._call_fwd_pairs(
        jnp.asarray(starts), jnp.asarray(counts), pair_attrs, jnp.asarray(bg)[None], tw, ts,
        starts.shape[0], attrs.shape[1] - 6, kr, interpret=True)[0]))
    want = rc.composite_pairs_fwd_plain(*args)[0]
    assert 3.5 < float(want.abs().min()) and float(want.abs().max()) < 4.5
    assert float((want - ref).abs().max()) <= 1e-4
    rz = precision_reading(tensor_core_fwd(args, "rz")[0], want)
    assert rz["max_abs"] > 1e-4 and rz["toward_zero"] > 0.99
    assert abs(precision_reading(tensor_core_fwd(args, "rn")[0], want)["toward_zero"]) < 0.5
    group = tensor_core_fwd(args, "group")[0]
    assert precision_reading(group, want)["max_abs"] <= 1e-4
    assert float((group - ref).abs().max()) <= 1e-4


def patch_kernels_with_plain(monkeypatch, seen):
    """The launch halves of the compositor wrappers replaced by the plain
    versions on the (padded) CPU tensors they receive, recording each C."""
    def fwd(gidx, starts, counts, attrs, bg, tw, ts, two_tile):
        seen.append(attrs.shape[1] - 6)
        return rc.composite_pairs_fwd_plain(gidx, starts, counts, attrs, bg, tw, ts)

    def bwd(*args):
        seen.append(args[3].shape[1] - 6)
        return rc.composite_pairs_bwd_plain(*args[:-1])

    def table_fwd(counts, tables, bg, tw, ts):
        seen.append(tables.shape[2] - 6)
        return rc.composite_tables_fwd_plain(counts, tables, bg, tw, ts)

    def table_bwd(*args):
        seen.append(args[1].shape[2] - 6)
        return rc.composite_tables_bwd_plain(*args)

    for name, fn in (("_kernel_fwd", fwd), ("_kernel_bwd", bwd), ("_kernel_table_fwd", table_fwd),
                     ("_kernel_table_bwd", table_bwd)):
        monkeypatch.setattr(rc, name, fn)


def wrappers_against_plain_and_jax(channels, monkeypatch):
    """The compositor wrappers at `channels` with the kernels' plain versions
    in their place (`patch_kernels_with_plain`) against the plain versions
    on the whole width and JAX's pair kernels in interpret mode. The
    forward equals the plain version exactly and JAX's `_call_fwd_pairs`
    to K1's tolerance; the backward's per-Gaussian sums (pair stream, K2 and
    K6's wrappers, and table) equal the plain version's within K2's
    criterion (1e-4 of each column group's max), and JAX's
    `_call_bwd_pairs` within it too. Returns the widths the launches saw."""
    scene = make_scene(10, 300)
    jp, gidx, starts, counts, attrs, bg = k1_inputs(scene, channels)
    tw = -(-W // 32)
    kr = -(-attrs.shape[0] // rp.KC) * rp.KC
    pair_attrs = rp._gather_pairs(jnp.asarray(gidx), jp.xys, jp.conics, jnp.asarray(attrs[:, 5]),
                                  jnp.asarray(attrs[:, 6:]), kr)
    ref = rp._call_fwd_pairs(jnp.asarray(starts), jnp.asarray(counts), pair_attrs,
                             jnp.asarray(bg)[None], tw, 32, starts.shape[0], channels, kr,
                             interpret=True)
    args = (T(gidx), T(starts), T(counts), T(attrs), T(bg), tw, 32)
    seen = []
    patch_kernels_with_plain(monkeypatch, seen)
    got = rc._launch_kernel(*args)
    want = rc.composite_pairs_fwd_plain(*args)
    assert got[0].shape == want[0].shape == (starts.shape[0], 1024, channels)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for name, a, b in zip(("out", "alpha", "logt"), ref, got):
        close(b, a, atol=1e-5, rtol=1e-4, msg=name)

    rng = np.random.default_rng(5)
    g_out = rng.normal(size=(starts.shape[0], 1024, channels)).astype(np.float32)
    g_alpha = rng.normal(size=(starts.shape[0], 1024)).astype(np.float32)
    bargs = args[:5] + (T(g_out), T(g_alpha), got[2], got[3]) + args[5:]
    want_g = k2_per_gaussian(gidx, attrs.shape[0], rc.composite_pairs_bwd_plain(*bargs).numpy())
    jref = rp._call_bwd_pairs(jnp.asarray(starts), jnp.asarray(counts), pair_attrs,
                              jnp.asarray(bg), jnp.asarray(g_out), jnp.asarray(g_alpha),
                              jnp.asarray(got[2].numpy()), jnp.asarray(got[3].numpy()), tw, 32, kr,
                              interpret=True)
    jref_g = k2_per_gaussian(gidx, attrs.shape[0], np.asarray(jref)[: gidx.shape[0], :6 + channels])
    for two_tile in (False, True):
        gpairs = rc._launch_bwd_kernel(*bargs, two_tile=two_tile)
        assert gpairs.shape == (gidx.shape[0], 6 + channels)
        got_g = k2_per_gaussian(gidx, attrs.shape[0], gpairs.numpy())
        for ref_g in (want_g, jref_g):
            for lo, hi in ((0, 2), (2, 5), (5, 6), (6, 6 + channels)):
                scale = float(np.abs(ref_g[:, lo:hi]).max())
                assert scale > 0
                assert float(np.abs(got_g[:, lo:hi] - ref_g[:, lo:hi]).max()) <= 1e-4 * scale

    # the table wrappers on the same rows, packed (T, K, 6 + C)
    kt = int(counts.max())
    tables = torch.zeros(starts.shape[0], kt, 6 + channels)
    for t in range(starts.shape[0]):
        tables[t, :counts[t]] = T(attrs[gidx[starts[t]:starts[t] + counts[t]]])
    tcounts = T(counts)
    tgot = rc._launch_table_fwd(tcounts, tables, T(bg), tw, 32)
    for a, b in zip(tgot, rc.composite_tables_fwd_plain(tcounts, tables, T(bg), tw, 32)):
        assert torch.equal(a, b)
    tb = (tcounts, tables, T(bg), T(g_out), T(g_alpha), tgot[2], tgot[3], tw, 32)
    gattr = rc._launch_table_bwd(*tb)
    plain = rc.composite_tables_bwd_plain(*tb)
    assert gattr.shape == tables.shape
    for lo, hi in ((0, 2), (2, 5), (5, 6), (6, 6 + channels)):
        scale = float(plain[..., lo:hi].abs().max())
        assert float((gattr[..., lo:hi] - plain[..., lo:hi]).abs().max()) <= 1e-4 * scale
    return seen


@pytest.mark.parametrize("feature_dim", [8, 16])
def test_padded_wrappers_match_unpadded_plain_and_jax(feature_dim, monkeypatch):
    """F 8 and 16 (C 15 and 23): one piece, zero-padded to the C 39
    kernels (C 7 for K3 at F 0 would take its own), the outputs cut back."""
    seen = wrappers_against_plain_and_jax(3 + feature_dim + 4, monkeypatch)
    assert sorted(set(seen)) == [39]  # every launch at the instantiated width


@pytest.mark.parametrize("channels", [47, 71, 122])
def test_chunked_wrappers_match_unchunked_plain_and_jax(channels, monkeypatch):
    """C 47, 71 and 122 (F 40, 64 and 115, the widest the JAX package
    takes): the wrappers launch once a piece of at most 39 channels, each
    padded to an instantiated width; the forward keeps the first piece's
    alpha / logt / ncomp, the backward sums the pieces' geometric columns
    (g_alpha in the first piece alone) and joins their colour columns."""
    seen = wrappers_against_plain_and_jax(channels, monkeypatch)
    pieces = rc.channel_pieces(channels)
    assert pieces[0] == (0, 39) and pieces[-1][1] == channels
    assert all(0 < hi - lo <= 39 for lo, hi in pieces)
    widths = [39] * (len(pieces) - 1)
    last = channels - 39 * (len(pieces) - 1)
    k1 = widths + [3 if last <= 3 else 39]
    k3 = widths + [next(c for c in rc.TABLE_FWD_CHANNELS if c >= last)]
    assert seen == k1 + k1 + k1 + k3 + k1  # K1, K2, K6, K3, K4


def test_wrappers_raise_past_122_channels():
    """C 123 (a 129-value attribute row) raises in both packages: JAX's
    pair gather and the port's wrappers, on CPU tensors too, naming the
    limit; `cut_channels` pads a piece and passes an instantiated width
    through untouched."""
    attrs = np.random.default_rng(3).uniform(size=(4, 6 + 123)).astype(np.float32)
    gidx, starts, counts = np.arange(4, dtype=np.int32), np.zeros(1, np.int32), np.full(1, 4, np.int32)
    bg = np.zeros(123, np.float32)
    with pytest.raises(ValueError, match="exceeds the 128-lane row"):
        rp._gather_pairs(jnp.asarray(gidx), jnp.asarray(attrs[:, :2]), jnp.asarray(attrs[:, 2:5]),
                         jnp.asarray(attrs[:, 5]), jnp.asarray(attrs[:, 6:]), rp.KC)
    args = (T(gidx), T(starts), T(counts), T(attrs), T(bg), 1, 32)
    for two_tile in (False, True):
        with pytest.raises(ValueError, match=r"C <= 122, a feature dim of at most 115"):
            rc.composite_pairs_fwd(*args, two_tile=two_tile)
    tables = torch.zeros(counts.shape[0], 1, 6 + 123)
    with pytest.raises(ValueError, match=r"C <= 122"):
        rc.composite_tables_fwd(T(np.zeros_like(counts)), tables, T(bg), 1, 32)
    x = torch.arange(2 * (6 + 5), dtype=torch.float32).reshape(2, 6 + 5)
    padded = rc.cut_channels(x, 0, 5, rc.channel_width(rc.TABLE_FWD_CHANNELS, 5))
    assert padded.shape == (2, 6 + 7) and torch.equal(padded[:, :11], x)
    assert not padded[:, 11:].any()
    piece = rc.cut_channels(x, 2, 4, 3)  # geometric columns, channels 2-3, one zero
    assert torch.equal(piece[:, :8], torch.cat([x[:, :6], x[:, 8:10]], 1)) and not piece[:, 8].any()
    x = torch.ones(2, 6 + 3)
    assert rc.cut_channels(x, 0, 3, rc.channel_width(rc.KERNEL_CHANNELS, 3)) is x  # untouched
