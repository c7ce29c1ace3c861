"""PyTorch port vs the JAX package: the ray-marched (NeRF-family) modules.

The same numpy inputs, and the same draws (the uniforms the JAX package
takes from its keys, replayed by repeating its key splits), go through the
JAX function and the port's, at tests/test_model_zoo.py's tiny sizes.

- Pixel samplers, hash indices and the occupancy update: bit-equal.
- Rays (every camera type, with and without distortion): 1e-6.
- Encodings, mip, TensoRF, SDF values and gradients, proposal losses:
  1e-6 abs / 1e-5 rel.
- `render_rays` of each field and variant from converted params: in float64
  (both packages) outputs and gradients within 1e-9 of each leaf's largest
  entry, the check that the port computes the JAX function; in float32
  outputs within 1e-5 abs / 1e-5 rel of the JAX package's plus three times
  its own float32 error against its float64 result, and each gradient
  leaf's float32 error against the float64 gradient, over the leaf's
  largest entry, within 1e-5 plus five times the JAX package's worst such
  error over the leaves. Leaf for leaf the port's float32 error is 2-4x
  the jitted JAX program's (11.6x at dnerf's last deformation bias, 4.9%
  of the leaf against the JAX package's 0.42%; its worst leaf is 1.3%).
  That float32 error is not small: a fine sample's position moves by an
  ulp when the coarse weights do (sample_pdf), and a 2^9 pi positional
  encoding or a 2048-cell hash level turns that ulp into a 1e-4..1e-3
  relative change of the first layer's gradient. The loss weights every
  output, the distortion loss included; the JAX
  proposal renderer is compiled without XLA's algebraic simplifier, which
  makes the jitted distortion gradient wrong (F11, pinned against a
  float64 finite difference).
- `sds_loss`, its gradient and the orbit camera with shared draws: 1e-6;
  LPIPS with seeded random weights: 1e-5; the dynamic batch sizer: the same
  ray counts.
"""

import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiangrasper_torch.core import rays as trays
from gaussiangrasper_torch.core.cameras import Camera as TCamera
from gaussiangrasper_torch.core.scene_box import OrientedBox as TBox
from gaussiangrasper_torch.core.scene_box import aabb_of as t_aabb_of
from gaussiangrasper_torch.data import pixel_samplers as tps
from gaussiangrasper_torch.engine.dynamic_batch import DynamicBatchSizer as TSizer
from gaussiangrasper_torch.engine.weights import nerf_params_from_numpy, occupancy_from_numpy
from gaussiangrasper_torch.models import encodings as tenc
from gaussiangrasper_torch.models import generative as tgen
from gaussiangrasper_torch.models import mip as tmip
from gaussiangrasper_torch.models import nerf as tnerf
from gaussiangrasper_torch.models import occupancy as tocc
from gaussiangrasper_torch.models import proposal as tprop
from gaussiangrasper_torch.models import sdf_field as tsdf
from gaussiangrasper_torch.models import tensorf_field as ttf
from gaussiangrasper_torch.utils import perceptual as tperc
from gaussiangrasper_tpu.core import rays as jrays
from gaussiangrasper_tpu.core.cameras import Camera as JCamera
from gaussiangrasper_tpu.core.scene_box import OrientedBox as JBox
from gaussiangrasper_tpu.core.scene_box import aabb_of as j_aabb_of
from gaussiangrasper_tpu.data import pixel_samplers as jps
from gaussiangrasper_tpu.engine.dynamic_batch import DynamicBatchSizer as JSizer
from gaussiangrasper_tpu.models import encodings as jenc
from gaussiangrasper_tpu.models import generative as jgen
from gaussiangrasper_tpu.models import mip as jmip
from gaussiangrasper_tpu.models import nerf as jnerf
from gaussiangrasper_tpu.models import occupancy as jocc
from gaussiangrasper_tpu.models import proposal as jprop
from gaussiangrasper_tpu.models import sdf_field as jsdf
from gaussiangrasper_tpu.models import tensorf_field as jtf
from gaussiangrasper_tpu.utils import perceptual as jperc

ATOL, RTOL = 1e-6, 1e-5
NO_ALGSIMP = {"xla_disable_hlo_passes": "algsimp"}  # F11


def close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol, err_msg=msg)


def T(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype)


def tiny_kwargs(field, **kw):
    """tests/test_model_zoo.py's tiny_cfg."""
    d = dict(field=field, num_coarse=8, num_fine=8, hidden=16, hash_levels=4,
             log2_hashmap_size=8, tensorf_resolution=16, far=4.0)
    d.update(kw)
    return d


def flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float64)
    return out


def jax_draws(cfg, key, num_rays):
    """The uniforms `render_rays` draws from `key` in the JAX package, by
    the port's names (models/nerf.py draw_shapes)."""
    def u(k, shape):
        return np.asarray(jax.random.uniform(k, shape, jnp.float32))

    r = (num_rays,)
    if cfg.field == "mipnerf":
        k1, k2 = jax.random.split(key)
        return {"edge_jitter": u(k1, r + (cfg.num_coarse - 1,)), "pdf_u": u(k2, r + (cfg.num_fine + 1,))}
    if cfg.field in ("neus", "neus-facto", "instant-ngp"):
        return {"jitter": u(key, r + (cfg.num_coarse + cfg.num_fine,))}
    if cfg.use_proposal:
        key, sub = jax.random.split(key)
        out = {"edge_jitter": u(sub, r + (cfg.num_proposal_samples[0] - 1,))}
        for i, n in enumerate(list(cfg.num_proposal_samples[1:]) + [cfg.num_fine]):
            key, sub = jax.random.split(key)
            out[f"pdf_u_{i}"] = u(sub, r + (n + 1,))
        return out
    k1, k2 = jax.random.split(key)
    return {"jitter": u(k1, r + (cfg.num_coarse,)), "pdf_u": u(k2, r + (cfg.num_fine,))}


def cams(c2w, w=16, h=12, f=12.0):
    return (JCamera.create(f, f, w / 2, h / 2, c2w, w, h),
            TCamera.create(f, f, w / 2, h / 2, c2w, w, h))


C2W = np.concatenate([np.eye(3), [[0.1], [-0.2], [1.5]]], 1).astype(np.float32)

# --- data, rays, boxes ----------------------------------------------------------


@pytest.mark.parametrize("name", ["uniform", "patch", "pair"])
def test_pixel_samplers_bit_equal(name):
    js = jps.make_pixel_sampler(name, 300, patch_size=4, pair_radius=3)
    ts = tps.make_pixel_sampler(name, 300, patch_size=4, pair_radius=3)
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    for h, w in ((48, 64), (7, 5), (3, 2)):
        ja, ta = js.sample(a, h, w), ts.sample(b, h, w)
        assert ja.dtype == ta.dtype == np.int32
        np.testing.assert_array_equal(ta, ja)
    with pytest.raises(KeyError):
        tps.make_pixel_sampler("nope", 8)


CAMERA_TYPES = ["perspective", "fisheye", "equirectangular", "omnidirectional_l",
                "omnidirectional_r", "vr180_l", "vr180_r"]


@pytest.mark.parametrize("distorted", [False, True])
@pytest.mark.parametrize("camera_type", CAMERA_TYPES)
def test_generate_rays_matches_jax(camera_type, distorted):
    rng = np.random.default_rng(1)
    rot = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    c2w = np.concatenate([rot, [[0.3], [-0.4], [1.2]]], 1).astype(np.float32)
    jc, tc = cams(c2w, w=20, h=14, f=11.0)
    dist = np.array([-0.08, 0.02, 0.003, -0.001, 5e-4, -5e-4], np.float32) if distorted else None
    coords = np.stack([rng.integers(0, 14, 40), rng.integers(0, 20, 40)], -1)
    for c in (coords, None):  # explicit pixels and the full grid
        jr = jrays.generate_rays(jc, None if c is None else jnp.asarray(c), camera_type, dist)
        tr = trays.generate_rays(tc, None if c is None else torch.tensor(c), camera_type, dist)
        for k in ("origins", "directions", "pixel_area"):
            close(getattr(tr, k), getattr(jr, k), atol=1e-6, rtol=0, msg=k)


def test_undistort_coords_and_samples_match_jax():
    rng = np.random.default_rng(2)
    dx, dy = rng.uniform(-0.6, 0.6, (2, 50)).astype(np.float32)
    dist = np.array([-0.1, 0.03, -0.002, 0.001, 1e-3, -7e-4], np.float32)
    jx, jy = jrays.undistort_coords(jnp.asarray(dx), jnp.asarray(dy), jnp.asarray(dist))
    tx, ty = trays.undistort_coords(T(dx), T(dy), T(dist))
    close(tx, jx, atol=1e-6, rtol=0)
    close(ty, jy, atol=1e-6, rtol=0)

    jc, tc = cams(C2W)
    coords = np.stack([rng.integers(0, 12, 9), rng.integers(0, 16, 9)], -1)
    jb, tb = jrays.generate_rays(jc, jnp.asarray(coords)), trays.generate_rays(tc, torch.tensor(coords))
    key = jax.random.PRNGKey(3)
    js = jrays.sample_along_rays(jb, 0.1, 3.0, 6, key)
    ts = trays.sample_along_rays(tb, 0.1, 3.0, 6, {"jitter": jax.random.uniform(key, (9, 6))})
    for k in ("positions", "directions", "starts", "ends"):
        close(getattr(ts, k), getattr(js, k), msg=k)
    close(ts.deltas, js.deltas)
    # no draw source: midpoints
    close(trays.sample_along_rays(tb, 0.1, 3.0, 6).positions,
          jrays.sample_along_rays(jb, 0.1, 3.0, 6).positions)
    with pytest.raises(KeyError):
        trays.sample_along_rays(tb, 0.1, 3.0, 6, {})
    with pytest.raises(ValueError):
        trays.sample_along_rays(tb, 0.1, 3.0, 6, {"jitter": np.zeros((9, 5))})


def test_sample_pdf_weights_composite_match_jax():
    rng = np.random.default_rng(3)
    bins = np.sort(rng.uniform(0.1, 4.0, (6, 10)), -1).astype(np.float32)
    w = (rng.random((6, 9)) * (rng.random((6, 9)) > 0.4)).astype(np.float32)
    w[2] = 0.0  # an empty ray: the 1e-5 floor makes it uniform
    key = jax.random.PRNGKey(4)

    def jf(b, ww):
        return jnp.sum(jnp.sin(3.0 * jrays.sample_pdf(b, ww, 13, key)))

    jt = jrays.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 13, key)
    tb, tw = T(bins).requires_grad_(), T(w).requires_grad_()
    tt = trays.sample_pdf(tb, tw, 13, {"pdf_u": np.asarray(jax.random.uniform(key, (6, 13)))})
    close(tt, jt)
    jg = jax.grad(jf, argnums=(0, 1))(jnp.asarray(bins), jnp.asarray(w))
    torch.sum(torch.sin(3.0 * tt)).backward()
    close(tb.grad, jg[0], atol=1e-5)
    close(tw.grad, jg[1], atol=1e-5)
    # u equal to CDF entries (0 and 0.5 of a two-bin uniform): the same bins
    b2 = np.tile(np.linspace(0, 1, 3, dtype=np.float32), (2, 1))
    w2 = np.ones((2, 2), np.float32)
    tie = np.array([[0.0, 0.5, 0.25], [0.5, 0.75, 0.0]], np.float32)
    t2 = trays.sample_pdf(T(b2), T(w2), 3, {"pdf_u": tie})
    np.testing.assert_allclose(t2.numpy(), tie, atol=1e-6)

    dens = rng.random((5, 7, 1)).astype(np.float32) * 3
    deltas = rng.random((5, 7, 1)).astype(np.float32)
    deltas[:, -1] = 1e10  # the hierarchical renderer's last delta
    vals = rng.random((5, 7, 3)).astype(np.float32)
    jw = jrays.render_weights(jnp.asarray(dens), jnp.asarray(deltas))
    tw2 = trays.render_weights(T(dens), T(deltas))
    assert torch.isfinite(tw2).all()
    close(tw2, jw)
    bg = np.array([0.2, 0.4, 0.6], np.float32)
    close(trays.composite(tw2, T(vals), T(bg)), jrays.composite(jw, jnp.asarray(vals), jnp.asarray(bg)))
    close(trays.composite(tw2, T(vals)), jrays.composite(jw, jnp.asarray(vals)))


def test_scene_boxes_match_jax():
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(200, 3)).astype(np.float32)
    jb, tb = j_aabb_of(pts), t_aabb_of(T(pts))
    close(tb.aabb, jb.aabb, atol=0, rtol=0)
    np.testing.assert_array_equal(tb.within(T(pts * 0.9)).numpy(), np.asarray(jb.within(pts * 0.9)))
    close(tb.get_center(), jb.get_center())
    q, t, s = np.array([0.9, 0.1, -0.3, 0.2], np.float32), np.array([0.1, 0.2, 0.0], np.float32), \
        np.array([1.5, 1.0, 2.0], np.float32)
    np.testing.assert_array_equal(TBox(T(q), T(t), T(s)).within(T(pts)).numpy(),
                                  np.asarray(JBox(jnp.asarray(q), jnp.asarray(t), jnp.asarray(s)).within(pts)))


# --- encodings, mip -------------------------------------------------------------

# tiny_cfg's grid, then the registered methods' grids (nerfacto, -big, -huge, the
# proposal fields) and a one-level grid
GRIDS = [dict(num_levels=4, log2_hashmap_size=8), dict(num_levels=12, log2_hashmap_size=17),
         dict(num_levels=16, log2_hashmap_size=19), dict(num_levels=16, log2_hashmap_size=21),
         dict(num_levels=5, log2_hashmap_size=15, max_res=256), dict(num_levels=1, log2_hashmap_size=4)]


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"L{g['num_levels']}H{g['log2_hashmap_size']}")
def test_hash_indices_bit_equal(grid):
    """The resolutions equal, and every corner's table row equal to the JAX
    package's uint32 hash (its expression at models/encodings.py:87-93,
    evaluated by JAX); an index-valued table read at integer points gives
    each point's corner-0 row through both packages' encoders."""
    jg = jenc.init_hash_grid(jax.random.PRNGKey(0), **grid)
    res = tenc.grid_resolutions(grid["num_levels"], 16, grid.get("max_res", 2048))
    np.testing.assert_array_equal(res.numpy(), np.asarray(jg["resolutions"]))
    hashmap = 2 ** grid["log2_hashmap_size"]
    rng = np.random.default_rng(6)
    x = rng.random((500, 3)).astype(np.float32)
    x[:3] = [[0, 0, 0], [1, 1, 1], [1, 0, 0.5]]
    th, _ = tenc.hash_indices(T(x), res, hashmap)
    offs = jnp.array([[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)], jnp.int32)
    for li in range(grid["num_levels"]):
        p0 = jnp.floor(jnp.asarray(x) * jg["resolutions"][li]).astype(jnp.int32)
        c = (p0[:, None, :] + offs[None]).astype(jnp.uint32)
        jh = ((c[..., 0] * jnp.uint32(1) ^ c[..., 1] * jnp.uint32(2654435761)
               ^ c[..., 2] * jnp.uint32(805459861)) % jnp.uint32(hashmap)).astype(jnp.int32)
        np.testing.assert_array_equal(th[li].numpy(), np.asarray(jh))
    # the unit cube's corners: frac 0 at every level, so each level's
    # feature is the row of the point's own corner
    xi = np.array([[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)], np.float32)
    table = np.broadcast_to(np.arange(hashmap, dtype=np.float32)[None, :, None],
                            (grid["num_levels"], hashmap, 2)).copy()
    jout = jenc.hash_grid_encode({"table": jnp.asarray(table), "resolutions": jg["resolutions"]},
                                 jnp.asarray(xi))
    tgrid = tenc.HashGrid(**grid)
    with torch.no_grad():
        tgrid.table.copy_(T(table))
    np.testing.assert_array_equal(tenc.hash_grid_encode(tgrid, T(xi)).detach().numpy(),
                                  np.asarray(jout))


def test_encodings_match_jax():
    rng = np.random.default_rng(7)
    x = rng.uniform(-2, 2, (30, 3)).astype(np.float32)
    close(tenc.positional_encoding(T(x), 6), jenc.positional_encoding(jnp.asarray(x), 6))
    close(tenc.positional_encoding(T(x), 2, include_input=False),
          jenc.positional_encoding(jnp.asarray(x), 2, include_input=False))
    d = x / np.linalg.norm(x, axis=-1, keepdims=True)
    for deg in (1, 3, 4):
        close(tenc.sh_encoding(T(d), deg), jenc.sh_encoding(jnp.asarray(d), deg))

    jg = jenc.init_hash_grid(jax.random.PRNGKey(1), num_levels=4, log2_hashmap_size=8,
                             max_res=128)
    jg["table"] = jax.random.uniform(jax.random.PRNGKey(2), jg["table"].shape, minval=-1, maxval=1)
    x01 = rng.random((40, 3)).astype(np.float32)
    jout, jvjp = jax.vjp(lambda t: jenc.hash_grid_encode({**jg, "table": t}, jnp.asarray(x01)),
                         jg["table"])
    tg = tenc.HashGrid(num_levels=4, log2_hashmap_size=8, max_res=128)
    with torch.no_grad():
        tg.table.copy_(T(jg["table"]))
    tout = tg(T(x01))
    close(tout, jout)
    cot = rng.normal(size=tout.shape).astype(np.float32)
    (tout * T(cot)).sum().backward()
    close(tg.table.grad, jvjp(jnp.asarray(cot))[0])
    assert tg.resolutions.requires_grad is False and "resolutions" not in dict(tg.named_parameters())


def test_mip_matches_jax():
    rng = np.random.default_rng(8)
    o = rng.normal(size=(5, 3)).astype(np.float32)
    d = rng.normal(size=(5, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    s = np.sort(rng.uniform(0.1, 3.0, (5, 7)), -1).astype(np.float32)
    e = s + rng.uniform(0.01, 0.3, (5, 7)).astype(np.float32)
    area = rng.uniform(1e-4, 1e-2, (5, 1)).astype(np.float32)

    def jf(o, d, s, e, a):
        m, c = jmip.conical_frustum_to_gaussian(o, d, s, e, jmip.pixel_radius(a))
        return m, c, jmip.integrated_pos_enc(m, c, 5)

    jm, jc, je = jax.jit(jf)(*map(jnp.asarray, (o, d, s, e, area)))
    ts = [T(v).requires_grad_() for v in (o, d, s, e, area)]
    tm, tc = tmip.conical_frustum_to_gaussian(*ts[:4], tmip.pixel_radius(ts[4]))
    te = tmip.integrated_pos_enc(tm, tc, 5)
    for got, want in ((tm, jm), (tc, jc), (te, je)):
        close(got, want)
    wts = rng.normal(size=je.shape).astype(np.float32)
    jg = jax.jit(jax.grad(lambda *a: jnp.sum(jf(*a)[2] * wts), argnums=tuple(range(5))))(
        *map(jnp.asarray, (o, d, s, e, area)))
    torch.sum(te * T(wts)).backward()
    for t, g in zip(ts, jg):
        close(t.grad, g, atol=ATOL * max(1.0, np.abs(g).max()))


# --- occupancy, proposal losses -------------------------------------------------


def test_occupancy_update_bit_equal():
    rng = np.random.default_rng(9)
    jg = jocc.init_grid([[-1, -1, -1], [1, 1, 1]], resolution=8)
    tg = tocc.init_grid([[-1, -1, -1], [1, 1, 1]], resolution=8)
    for step in range(3):
        pos = rng.uniform(-1.3, 1.3, (600, 3)).astype(np.float32)  # beyond the box: clipped
        pos[:50] = pos[0]  # many samples in one cell
        dens = (rng.random(600) * (rng.random(600) > 0.5)).astype(np.float32) * 0.05
        jg = jocc.update_grid(jg, jnp.asarray(pos), jnp.asarray(dens))
        tg = tocc.update_grid(tg, T(pos), T(dens))
        np.testing.assert_array_equal(tg.density.numpy(), np.asarray(jg.density))
    q = rng.uniform(-1, 1, (4, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(tocc.occupancy_mask(tg, T(q)).numpy(),
                                  np.asarray(jocc.occupancy_mask(jg, jnp.asarray(q))))
    dd = rng.random((4, 5, 1)).astype(np.float32)
    np.testing.assert_array_equal(tocc.masked_densities(tg, T(q), T(dd)).numpy(),
                                  np.asarray(jocc.masked_densities(jg, jnp.asarray(q), jnp.asarray(dd))))
    conv = occupancy_from_numpy(np.asarray(jg.density), np.asarray(jg.aabb), jg.threshold)
    assert torch.equal(conv.density, tg.density) and conv.resolution == 8


def test_proposal_losses_match_jax():
    rng = np.random.default_rng(10)
    t_env = np.sort(rng.uniform(0.05, 4.0, (6, 9)), -1).astype(np.float32)
    w_env = rng.random((6, 8)).astype(np.float32) * 0.3
    t = np.sort(rng.uniform(0.05, 4.0, (6, 7)), -1).astype(np.float32)
    t[:, 2] = t_env[:, 3]  # query edges on proposal edges: the left / right sides
    t[:, 0], t[:, -1] = t_env[:, 0], t_env[:, -1]
    w = rng.random((6, 6)).astype(np.float32) * 0.3
    close(tprop.outer_weights(T(t_env), T(w_env), T(t)),
          jprop.outer_weights(jnp.asarray(t_env), jnp.asarray(w_env), jnp.asarray(t)))

    def jf(we, tt, ww):
        return (jprop.interlevel_loss([(jnp.asarray(t_env), we)], tt, ww)
                + jprop.distortion_loss(tt, ww, 0.05, 4.0))

    args = [jnp.asarray(a) for a in (w_env, t, w)]
    jl, jg = jax.value_and_grad(jf, argnums=(0, 1, 2))(*args)  # op by op (F11)
    tw_env, tt, tw = (T(a).requires_grad_() for a in (w_env, t, w))
    tl = tprop.interlevel_loss([(T(t_env), tw_env)], tt, tw) + tprop.distortion_loss(tt, tw, 0.05, 4.0)
    close(tl, jl)
    tl.backward()
    for got, want in zip((tw_env, tt, tw), jg):
        close(got.grad, want)


def test_distortion_gradient_jit_gap_pinned():
    """F11, the reference's: jitted with XLA's default passes, the JAX
    distortion loss's gradient in the edges is wrong. In float64, at
    test_proposal_losses_match_jax's inputs, a central finite difference is
    the witness: the op-by-op JAX gradient, the JAX gradient compiled
    without the algebraic simplifier (algsimp) and the port's all agree with
    it, while the default jit misses by over a tenth of the largest entry
    (a third, as read). The weights' gradient is right either way."""
    rng = np.random.default_rng(10)
    t_env = np.sort(rng.uniform(0.05, 4.0, (6, 9)), -1)
    rng.random((6, 8))  # w_env: the draws of test_proposal_losses_match_jax
    t = np.sort(rng.uniform(0.05, 4.0, (6, 7)), -1)
    t[:, 2] = t_env[:, 3]
    t[:, 0], t[:, -1] = t_env[:, 0], t_env[:, -1]
    w = rng.random((6, 6)) * 0.3
    with jax.enable_x64(True):
        def f(tt, ww):
            return jprop.distortion_loss(tt, ww, 0.05, 4.0)

        grad = jax.grad(f, argnums=(0, 1))
        op = [np.asarray(g) for g in grad(t, w)]
        fixed = [np.asarray(g) for g in jax.jit(grad, compiler_options=NO_ALGSIMP)(t, w)]
        default = [np.asarray(g) for g in jax.jit(grad)(t, w)]
        fd = [np.zeros_like(t), np.zeros_like(w)]
        for k, i in [(k, i) for k in (0, 1) for i in np.ndindex(fd[k].shape)]:
            hi, lo = [t.copy(), w.copy()], [t.copy(), w.copy()]
            hi[k][i] += 1e-6
            lo[k][i] -= 1e-6
            fd[k][i] = (float(f(*hi)) - float(f(*lo))) / 2e-6
    tt, tw = T(t, torch.float64).requires_grad_(), T(w, torch.float64).requires_grad_()
    tprop.distortion_loss(tt, tw, 0.05, 4.0).backward()
    for k, (name, port) in enumerate((("t", tt.grad.numpy()), ("w", tw.grad.numpy()))):
        scale = np.abs(fd[k]).max()
        for label, g in (("op by op", op[k]), ("no algsimp", fixed[k]), ("port", port)):
            np.testing.assert_allclose(g, fd[k], atol=1e-7 * scale, rtol=0, err_msg=f"{label} {name}")
    assert np.abs(default[0] - fd[0]).max() > 0.1 * np.abs(fd[0]).max()  # the gap in the edges
    np.testing.assert_allclose(default[1], fd[1], atol=1e-7 * np.abs(fd[1]).max(), rtol=0)


# --- TensoRF and SDF fields -----------------------------------------------------


def test_tensorf_matches_jax():
    """Values outside [0, 1] (the clip) and the L1 term with its gradient;
    the fields' gradients are held in test_render_rays_matches_jax."""
    jp = jtf.init_tensorf(jax.random.PRNGKey(11), resolution=16, density_components=4,
                          appearance_components=6, appearance_dim=9, hidden=16)
    field = torch.nn.Module()
    for k, v in ttf.init_tensorf(resolution=16, density_components=4, appearance_components=6,
                                 appearance_dim=9, hidden=16).items():
        setattr(field, k, v)
    field.load_state_dict({k: T(v) for k, v in flat_tree(jp).items()})
    rng = np.random.default_rng(12)
    x01 = rng.uniform(-0.1, 1.1, (20, 3)).astype(np.float32)
    d = rng.normal(size=(20, 3)).astype(np.float32)
    jd, jr = jax.jit(lambda p: (jtf.tensorf_density(p, jnp.asarray(x01)),
                                jtf.tensorf_rgb(p, jnp.asarray(x01), jnp.asarray(d))))(jp)
    close(ttf.tensorf_density(field, T(x01)), jd)
    close(ttf.tensorf_rgb(field, T(x01), T(d)), jr)
    jl, jg = jax.value_and_grad(jtf.tensorf_l1_reg)(jp)
    tl = ttf.tensorf_l1_reg(field)
    close(tl, jl)
    tl.backward()
    for n in ("density_planes", "density_lines"):
        close(getattr(field, n).grad, jg[n], msg=n)


@pytest.mark.parametrize("variant", ["neus", "neus-facto"])
def test_sdf_field_matches_jax(variant):
    """Values, the spatial gradient, the NeuS alphas and weights, the colour
    head, and the parameters' gradient through the spatial gradient (the
    double backward)."""
    jp = jsdf.init_sdf_field(jax.random.PRNGKey(13), variant=variant, hidden=16, hash_levels=4,
                             log2_hashmap_size=8)
    field = torch.nn.Module()
    for k, v in tsdf.init_sdf_field(variant, hidden=16, hash_levels=4, log2_hashmap_size=8).items():
        setattr(field, k, v)
    field.load_state_dict({k: T(v) for k, v in flat_tree(jp).items()})
    rng = np.random.default_rng(14)
    pos = rng.uniform(-1.5, 1.5, (4, 6, 3)).astype(np.float32)
    dirs = np.broadcast_to(rng.normal(size=(4, 1, 3)), (4, 6, 3)).astype(np.float32)
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    deltas = rng.uniform(0.05, 0.3, (4, 6, 1)).astype(np.float32)

    def jf(p):
        sdf, geo = jsdf.sdf_and_features(p, jnp.asarray(pos), 2.0)
        g = jsdf.sdf_gradient(p, jnp.asarray(pos), 2.0)
        a = jsdf.neus_alphas(sdf, g, jnp.asarray(dirs), jnp.asarray(deltas), jnp.exp(10.0 * p["s"]))
        w = jsdf.alphas_to_weights(a)
        n = g / jnp.maximum(jnp.linalg.norm(g, axis=-1, keepdims=True), 1e-6)
        rgb = jsdf.sdf_rgb(p, jnp.asarray(pos), jnp.asarray(dirs), n, geo)
        return jnp.sum(w * rgb) + jnp.sum((jnp.linalg.norm(g, axis=-1) - 1) ** 2), (sdf, g, a, w, rgb)

    (jl, jouts), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(jp)
    sdf, geo = tsdf.sdf_and_features(field, T(pos), 2.0)
    g = tsdf.sdf_gradient(field, T(pos), 2.0)
    a = tsdf.neus_alphas(sdf, g, T(dirs), T(deltas), torch.exp(10.0 * field.s))
    w = tsdf.alphas_to_weights(a)
    n = g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True), min=1e-6)
    rgb = tsdf.sdf_rgb(field, T(pos), T(dirs), n, geo)
    tl = torch.sum(w * rgb) + torch.sum((torch.linalg.norm(g, dim=-1) - 1) ** 2)
    for got, want in zip((sdf, g, a, w, rgb), jouts):
        close(got, want)
    close(tl, jl)
    tl.backward()
    jg = flat_tree(jg)
    for name, p in field.named_parameters():
        close(p.grad, jg[name], atol=ATOL * max(1.0, np.abs(jg[name]).max()), msg=name)
    with torch.no_grad():  # the gradient is taken locally, not differentiable
        g2 = tsdf.sdf_gradient(field, T(pos), 2.0)
    assert not g2.requires_grad
    close(g2, jouts[1])


# --- render_rays: every field and variant ---------------------------------------

RENDER_CASES = [
    ("vanilla", {}), ("nerfacto", {}), ("mipnerf", {}), ("instant-ngp", {}),
    ("tensorf", {}), ("neus", {}), ("neus-facto", {}),
    ("nerfacto", {"use_proposal": True, "num_proposal_samples": (8, 8)}),
    ("nerfacto", {"num_semantic_classes": 5}),
    ("nerfacto", {"num_appearance_embeds": 3}),
    ("vanilla", {"deformation": True}),
]
NUM_RAYS = 16


def _case_id(case):
    field, kw = case
    return "-".join([field] + [k for k in kw if k != "num_proposal_samples"])


def _weighted(outs, xp):
    """A loss that weights every output entry differently."""
    total = 0.0
    for k in sorted(outs):
        if k == "num_live_samples":
            continue
        v = outs[k]
        if xp is jnp:
            total = total + jnp.sum(v * jnp.cos(jnp.arange(v.size).reshape(v.shape) * 0.37))
        else:
            total = total + torch.sum(v * torch.cos(
                torch.arange(v.numel(), dtype=v.dtype).reshape(v.shape) * 0.37))
    return total


@pytest.mark.parametrize("case", RENDER_CASES, ids=_case_id)
def test_render_rays_matches_jax(case, monkeypatch):
    field, kw = case
    jcfg = jnerf.NerfConfig(**tiny_kwargs(field, **kw))
    tcfg = tnerf.NerfConfig(**tiny_kwargs(field, **kw))
    params = jnerf.init_nerf(jax.random.PRNGKey(3), jcfg)
    if jcfg.deformation:  # a warp that is not the identity
        params["deform_mlp"]["w2"] = 0.1 * jax.random.normal(jax.random.PRNGKey(4),
                                                             params["deform_mlp"]["w2"].shape)
    np_params = jax.tree.map(np.asarray, params)
    grid = None
    if field == "instant-ngp":  # half the cells occupied
        dens = (np.random.default_rng(5).random((8, 8, 8)) > 0.5).astype(np.float32)
        grid = jocc.OccupancyGrid(jnp.asarray(dens), jnp.asarray([[-2.0] * 3, [2.0] * 3]), 0.01)
    rng = np.random.default_rng(0)
    coords = np.stack([rng.integers(0, 12, NUM_RAYS), rng.integers(0, 16, NUM_RAYS)], -1)
    key = jax.random.PRNGKey(7)
    extra = {}
    if jcfg.deformation:
        extra["times"] = np.float32(0.3)
    if jcfg.num_appearance_embeds:
        extra["appearance_idx"] = 2
    jc, tc = cams(C2W)

    def jax_run(p, rb, g):
        def loss(p):
            o = jnerf.render_rays(p, rb, key, jcfg, grid=g, **extra)
            return _weighted(o, jnp), o
        (_, o), gr = jax.value_and_grad(loss, has_aux=True)(p)
        return o, gr

    def to_numpy(o, gr):
        return jax.tree.map(np.asarray, o), flat_tree(gr)

    # XLA's algebraic simplifier makes the jitted distortion gradient wrong
    # (F11, test_distortion_gradient_jit_gap_pinned): the proposal renderer
    # is compiled without that pass
    jit = functools.partial(jax.jit, compiler_options=NO_ALGSIMP) if jcfg.use_proposal else jax.jit
    jrb = jrays.generate_rays(jc, jnp.asarray(coords))
    j32 = to_numpy(*jit(jax_run)(params, jrb, grid))
    orig_uniform = jax.random.uniform
    with jax.enable_x64(True):
        # the float32 draws, widened: the same numbers as the float32 run's
        monkeypatch.setattr(jax.random, "uniform",
                            lambda k, shape=(), dtype=None, minval=0.0, maxval=1.0: orig_uniform(
                                k, shape, jnp.float32, minval, maxval).astype(jnp.float64))
        wide = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)  # noqa: E731
        if "times" in extra:
            extra["times"] = np.float64(extra["times"])
        j64 = to_numpy(*jit(jax_run)(wide(np_params), wide(jrb), None if grid is None else grid._replace(
            density=wide(grid.density), aabb=wide(grid.aabb))))
    monkeypatch.undo()

    draws = jax_draws(jcfg, key, NUM_RAYS)
    tb = trays.generate_rays(tc, torch.tensor(coords))
    res = {}
    for name, dt in (("t32", torch.float32), ("t64", torch.float64)):
        f = nerf_params_from_numpy(np_params, tcfg).to(dt)
        tgrid = None if grid is None else occupancy_from_numpy(np.asarray(grid.density),
                                                               np.asarray(grid.aabb), 0.01)
        if tgrid is not None:
            tgrid = tgrid._replace(density=tgrid.density.to(dt), aabb=tgrid.aabb.to(dt))
        textra = {k: (torch.tensor(v, dtype=dt) if k == "times" else v) for k, v in extra.items()}
        out = tnerf.render_rays(f, tb.map(lambda x: x.to(dt)),
                                {k: torch.tensor(v, dtype=dt) for k, v in draws.items()}, tcfg,
                                grid=tgrid, **textra)
        _weighted(out, torch).backward()
        res[name] = ({k: v.detach().double().numpy() for k, v in out.items()},
                     {n: np.zeros(p.shape) if p.grad is None else p.grad.double().numpy()
                      for n, p in f.named_parameters()})
    (o32, g32), (o64, g64) = res["t32"], res["t64"]
    (jo32, jg32), (jo64, jg64) = j32, j64
    assert set(o32) == set(jo32)
    assert set(g32) == {n for n in jg32 if not n.endswith("resolutions")}
    for k in jo32:
        scale = max(np.abs(jo64[k]).max(), 1e-30)
        np.testing.assert_allclose(o64[k], jo64[k], atol=1e-9 * scale, rtol=0, err_msg=f"f64 {k}")
        jax_err = np.abs(jo32[k] - jo64[k])
        assert np.all(np.abs(o32[k] - jo32[k]) <= 1e-5 + 1e-5 * np.abs(jo32[k]) + 3 * jax_err), \
            (k, np.abs(o32[k] - jo32[k]).max(), jax_err.max())
    scales = {n: max(np.abs(jg64[n]).max(), 1e-30) for n in g32}
    for n in g32:
        np.testing.assert_allclose(g64[n], jg64[n], atol=1e-9 * scales[n], rtol=0,
                                   err_msg=f"f64 {n}")
    # float32: each leaf's error against the float64 gradient, over the
    # leaf's largest entry, beside the JAX package's worst such error
    jax_rel = max(np.abs(jg32[n] - jg64[n]).max() / scales[n] for n in g32)
    for n in g32:
        rel = np.abs(g32[n] - jg64[n]).max() / scales[n]
        assert rel <= 1e-5 + 5 * jax_rel, (n, rel, jax_rel)


def test_field_parameter_names_are_the_jax_keys():
    for field, kw in RENDER_CASES + [("nerfacto", {"use_proposal": True, "deformation": True})]:
        jcfg = jnerf.NerfConfig(**tiny_kwargs(field, **kw))
        keys = set(flat_tree(jnerf.init_nerf(jax.random.PRNGKey(0), jcfg)))
        f = tnerf.NerfField(tnerf.NerfConfig(**tiny_kwargs(field, **kw)))
        assert set(f.state_dict()) == keys, (field, kw)
        buffers = {n for n, _ in f.named_buffers()}
        assert buffers == {k for k in keys if k.endswith("resolutions")}
    with pytest.raises(ValueError, match="semantic head"):
        tnerf.NerfField(tnerf.NerfConfig(field="tensorf", num_semantic_classes=3))
    assert [f.name for f in dataclasses.fields(tnerf.NerfConfig)] == \
        [f.name for f in dataclasses.fields(jnerf.NerfConfig)]
    assert tnerf.NerfConfig() == tnerf.NerfConfig(**dataclasses.asdict(jnerf.NerfConfig()))


# --- dynamic batch, generative, LPIPS -------------------------------------------


def test_dynamic_batch_sizer_same_ray_counts():
    rng = np.random.default_rng(15)
    for kw in ({}, dict(target_num_samples=4096, max_num_samples_per_ray=16, min_rays=8, max_rays=512)):
        j, t = JSizer(**kw), TSizer(**kw)
        seq = [t.num_rays]
        assert t.num_rays == j.num_rays
        for _ in range(40):
            m = int(rng.integers(0, 4 * j.num_rays * 64))
            assert t.update(m) == j.update(m)
            seq.append(t.num_rays)
        assert len(set(seq)) > 2
    with pytest.raises(ValueError):
        TSizer(min_rays=48)


def test_sds_loss_and_orbit_camera_match_jax():
    key = jax.random.PRNGKey(17)
    ks = jax.random.split(key, 5)
    cam_draws = {"vertical": jax.random.uniform(ks[0]), "central": jax.random.uniform(ks[1]),
                 "radius": jax.random.normal(ks[2], (3,)), "jitter": jax.random.normal(ks[3], (3,)),
                 "focal": jax.random.uniform(ks[4])}
    jcam, jv, jcen = jgen.random_orbit_camera(key, 24, radius_mean=1.8)
    tcam, tv, tcen = tgen.random_orbit_camera({k: np.asarray(v) for k, v in cam_draws.items()},
                                              24, radius_mean=1.8)
    close(tcam.camera_to_world, jcam.camera_to_world)
    for a in ("fx", "fy", "cx", "cy"):
        close(getattr(tcam, a), getattr(jcam, a))
    close(tv, jv, atol=1e-4)
    close(tcen, jcen, atol=1e-4)

    rgb = np.random.default_rng(18).random((6, 5, 3)).astype(np.float32)
    guidance_j, guidance_t = jgen.ColorTargetGuidance(), tgen.ColorTargetGuidance()
    k_t, k_eps, _ = jax.random.split(key, 3)
    sds_draws = {"t": np.asarray(jax.random.uniform(k_t, ())),
                 "eps": np.asarray(jax.random.normal(k_eps, rgb.shape))}
    jl, jg = jax.value_and_grad(lambda x: jgen.sds_loss(guidance_j, key, x))(jnp.asarray(rgb))
    x = T(rgb).requires_grad_()
    tl = tgen.sds_loss(guidance_t, sds_draws, x)
    close(tl, jl)
    tl.backward()
    close(x.grad, jg)
    acc = np.random.default_rng(19).random((30, 1)).astype(np.float32)
    close(tgen.opacity_loss(T(acc)), jgen.opacity_loss(jnp.asarray(acc)))
    with pytest.raises(SystemExit, match="locally cached"):
        tgen.StableDiffusionGuidance(None)


def test_lpips_matches_jax(tmp_path, monkeypatch):
    path = tmp_path / "vgg16.npz"
    np.savez(path, **jperc.random_weights(3))
    monkeypatch.setenv("GGT_VGG16_WEIGHTS", str(path))
    for mod in (jperc, tperc):
        mod.reset_cache()
    try:
        assert tperc.default_weight_path() == path and tperc.lpips_available()
        rng = np.random.default_rng(20)
        a = rng.random((36, 20, 3)).astype(np.float32)
        b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
        want = jperc.lpips(a, b)
        got = tperc.lpips(a, b, device="cpu")
        assert want > 0 and abs(got - want) <= 1e-5, (got, want)
        assert tperc.lpips(torch.tensor(a), torch.tensor(a), device="cpu") == 0.0
        for k, v in tperc.random_weights(3).items():
            np.testing.assert_array_equal(v, jperc.random_weights(3)[k])
    finally:
        for mod in (jperc, tperc):
            mod.reset_cache()
    monkeypatch.setenv("GGT_VGG16_WEIGHTS", str(Path(tmp_path) / "missing.npz"))
    assert tperc.lpips(a, b, device="cpu") is None and not tperc.lpips_available()
    tperc.reset_cache()
