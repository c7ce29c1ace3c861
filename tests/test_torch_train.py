"""PyTorch port vs the JAX package: the training slice.

Every input is made with numpy from a seed and goes through both packages
on the CPU (JAX forced there by conftest). Tolerances and their reasons:

- K2's plain version vs the JAX Pallas kernel `_call_bwd_pairs` in
  interpret mode, row by row: max error <= 1e-5 of each column group's max
  |value|. The two walks sum the suffixes in another order (a sequential
  walk vs a triangular matmul) with other exp/log1p rounding.
- Gradients (composite, render, train_loss): max error <= 1e-4 of the
  leaf's max |gradient| (float32 sums over pixels and pairs in another
  order; the SSIM blur and the 512-wide MLP add their own).
- Three train steps: loss terms at rtol 1e-4. Adam with eps 1e-15 moves a
  parameter whose summed gradient is near zero by about +-lr on a sign
  that rounding can flip, so parameters are held at atol 2 * lr_group * N
  (N updates of the group) and the first step's gradients, which the
  accumulating groups keep in their accumulator, at 1e-4 relative.
- Refinement with injected noise: the alive mask exact, fields at 1e-6.
- The stream clipped by both K (`max_gaussians_per_tile`) and the pair
  budget B (`pair_budget_per_tile`), as in a long run past its capacity:
  `overflow` and `pair_overflow` positive and equal across the packages,
  and the loss, gradients, densify statistics and refine under the same
  tolerances as the unclipped cases.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiangrasper_torch import _build
from gaussiangrasper_torch.core.cameras import Camera as TCamera
from gaussiangrasper_torch.engine import checkpoint as tckpt
from gaussiangrasper_torch.engine import optimizers as topt
from gaussiangrasper_torch.engine import refinement as tref
from gaussiangrasper_torch.engine.train_state import grow_capacity as t_grow
from gaussiangrasper_torch.engine.train_state import refine_step as t_refine_step
from gaussiangrasper_torch.engine.train_state import train_step as t_step
from gaussiangrasper_torch.engine.weights import train_state_from_numpy
from gaussiangrasper_torch.models.efd import params_from_numpy
from gaussiangrasper_torch.models.gaussian_field import FIELD_KEYS, GaussianParams as TParams
from gaussiangrasper_torch.models.gaussian_field import init_from_seeds as t_init_from_seeds
from gaussiangrasper_torch.models.model import GaussianSplatConfig as TConfig
from gaussiangrasper_torch.models.model import render as t_render
from gaussiangrasper_torch.models.model import train_loss as t_train_loss
from gaussiangrasper_torch.ops import rasterize_cuda as rc
from gaussiangrasper_torch.ops.rasterize import RasterizeConfig as TRC
from gaussiangrasper_tpu.core.cameras import Camera as JCamera
from gaussiangrasper_tpu.engine import optimizers as jopt
from gaussiangrasper_tpu.engine import refinement as jref
from gaussiangrasper_tpu.engine.train_state import grow_capacity as j_grow
from gaussiangrasper_tpu.engine.train_state import init_train_state as j_init
from gaussiangrasper_tpu.engine.train_state import train_step as j_step
from gaussiangrasper_tpu.models.efd import init_mlp
from gaussiangrasper_tpu.models.gaussian_field import GaussianParams as JParams
from gaussiangrasper_tpu.models.gaussian_field import init_from_seeds as j_init_from_seeds
from gaussiangrasper_tpu.models.model import GaussianSplatConfig as JConfig
from gaussiangrasper_tpu.models.model import render as j_render
from gaussiangrasper_tpu.models.model import train_loss as j_train_loss
from gaussiangrasper_tpu.ops import rasterize_pallas as rp
from gaussiangrasper_tpu.ops.rasterize import RasterizeConfig as JRC
from tests.test_torch_core import W as SW, T, close, make_scene
from tests.test_torch_rasterize import k1_inputs, saturated_scene

F, W, H, N, CAP = 8, 48, 32, 120, 160
INTR = (40.0, 40.0, W / 2, H / 2)
CFG_KW = dict(feature_dim=F, warmup_length=0, sh_degree_interval=3)


# K and B below the tiles' 22..62 pairs of make_field(7) / make_field(0):
# both packages drop pairs past K in the busy tiles and past B at the end
# of the stream. The JAX side runs its TPU path, the pair-stream Pallas
# backend (interpreted here): "auto" picks the xla walk off a TPU, which
# reads the (T, K) table and has no pair budget.
CLIPPED = dict(max_gaussians_per_tile=40, pair_budget_per_tile=20, backend="pallas")
RASTER_CASES = {"unclipped": {}, "pairs_dropped": CLIPPED}


def configs(raster=None, **kw):
    kw = {**CFG_KW, **kw}
    raster = {"tile_size": 16, "max_gaussians_per_tile": 256, **(raster or {})}
    return JConfig(raster=JRC(**raster), **kw), TConfig(raster=TRC(**raster), **kw)


def close_scaled(got, want, rel, msg=""):
    """max |got - want| <= rel * max |want| (plus a denormal floor)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, msg
    assert np.isfinite(got).all(), msg
    err = float(np.abs(got - want).max()) if want.size else 0.0
    scale = float(np.abs(want).max()) if want.size else 0.0
    assert err <= rel * scale + 1e-30, f"{msg}: err {err} vs scale {scale}"


def make_field(seed=0):
    """Numpy leaves of a capacity-CAP field: N alive, the rest dead slots,
    five alive Gaussians behind the camera (culled by the projection)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    sh = np.zeros((CAP, 25, 3), f32)
    sh[:, 0] = rng.uniform(-1.5, 1.5, (CAP, 3))
    sh[:, 1:] = 0.2 * rng.normal(size=(CAP, 24, 3))
    field = {
        "means": np.concatenate([rng.uniform(-1, 1, (CAP, 2)), rng.uniform(-4, -2, (CAP, 1))], 1).astype(f32),
        "log_scales": rng.uniform(-3.5, -2.0, (CAP, 3)).astype(f32),
        "quats": rng.normal(size=(CAP, 4)).astype(f32),
        "opacity_logits": rng.normal(size=CAP).astype(f32),
        "sh_coeffs": sh,
        "features": rng.uniform(-1, 1, (CAP, F)).astype(f32),
    }
    field["means"][:5, 2] = 1.0
    return field, np.arange(CAP) < N


def make_batch(seed=1):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    g, p, s = 4, 8, 16

    def pix(*shape):
        return np.stack([rng.integers(0, H, shape), rng.integers(0, W, shape)], -1).astype(np.int32)

    return {
        "image": rng.random((H, W, 3), f32),
        "depth": rng.uniform(2.0, 4.0, (H, W)).astype(f32),
        "normal": rng.normal(size=(H, W, 3)).astype(f32),
        "valid_mask": rng.random((H, W)) > 0.2,
        "pair_a": pix(g, p), "pair_b": pix(g, p),
        "pair_valid": rng.random((g, p)) > 0.1,
        "group_valid": np.array([True, True, True, False]),
        "points": pix(s), "point_valid": rng.random(s) > 0.1,
        "gt_clip": rng.normal(size=(s, 512)).astype(f32),
    }


def fea_up_arrays():
    return {k: np.array(v) for k, v in init_mlp(jax.random.PRNGKey(1), F, 512, (128,)).items()}


def cameras():
    c2w = np.eye(4, dtype=np.float32)[:3]
    return JCamera.create(*INTR, c2w, W, H), TCamera.create(*INTR, c2w, W, H)


def jfield_of(field):
    return JParams(**{k: jnp.asarray(v) for k, v in field.items()})


def tfield_of(field, grad=False):
    return TParams(*(T(field[k]).requires_grad_(grad) for k in FIELD_KEYS))


def opt_numpy(jstate):
    return {name: {"mu": jax.tree.map(np.array, o.adam.mu), "nu": jax.tree.map(np.array, o.adam.nu),
                   "count": np.array(o.adam.count), "accum": jax.tree.map(np.array, o.accum)}
            for name, o in jstate.opt.items()}


def convert(jstate):
    return train_state_from_numpy(
        {k: np.array(getattr(jstate.field, k)) for k in FIELD_KEYS}, np.array(jstate.alive),
        jax.tree.map(np.array, jstate.fea_up), opt_numpy(jstate),
        {k: np.array(v) for k, v in jstate.stats._asdict().items()}, int(jstate.step))


# --- K2 ----------------------------------------------------------------------


@pytest.mark.parametrize("scene_name,n_channels", [("saturated", 3), ("random", 39), ("empty", 3)])
def test_k2_plain_matches_pallas_interpret(scene_name, n_channels):
    if scene_name == "saturated":
        scene = saturated_scene()
    else:
        scene = make_scene(10, 300)
        if scene_name == "empty":
            scene["means"][:, 2] = 5.0
    jp, gidx, starts, counts, attrs, bg = k1_inputs(scene, n_channels)
    tw = -(-SW // 32)
    n = attrs.shape[0]
    kr = -(-n // rp.KC) * rp.KC
    pair_attrs = rp._gather_pairs(jnp.asarray(gidx), jp.xys, jp.conics, jnp.asarray(attrs[:, 5]),
                                  jnp.asarray(attrs[:, 6:]), kr)
    _, alpha, logt, ncomp = rp._call_fwd_pairs(jnp.asarray(starts), jnp.asarray(counts), pair_attrs,
                                               jnp.asarray(bg)[None], tw, 32, starts.shape[0],
                                               n_channels, kr, interpret=True)
    rng = np.random.default_rng(3)
    g_out = rng.normal(size=alpha.shape + (n_channels,)).astype(np.float32)
    g_alpha = rng.normal(size=alpha.shape).astype(np.float32)  # nonzero: sky_alpha_reg's term
    ref = rp._call_bwd_pairs(jnp.asarray(starts), jnp.asarray(counts), pair_attrs, jnp.asarray(bg),
                             jnp.asarray(g_out), jnp.asarray(g_alpha), logt, ncomp, tw, 32, kr,
                             interpret=True)
    ref = np.asarray(ref)[: gidx.shape[0], : 6 + n_channels]
    before = _build.launches.copy()
    got = rc.composite_pairs_bwd(T(gidx), T(starts), T(counts), T(attrs), T(bg), T(g_out),
                                 T(g_alpha), T(logt), T(ncomp), tw, 32)
    assert _build.launches == before  # CPU tensors: the plain version
    for name, lo, hi in (("dxy", 0, 2), ("dconic", 2, 5), ("dopacity", 5, 6),
                         ("dcolor", 6, 6 + n_channels)):
        close_scaled(got[:, lo:hi], ref[:, lo:hi], 1e-5, msg=name)
    if scene_name == "empty":
        assert counts.sum() == 0 and not got.any()
    else:
        assert float(np.abs(ref).max()) > 0.1
    if scene_name == "saturated":
        assert (np.asarray(ncomp) < counts[:, None]).any()  # the cut engaged


@pytest.mark.parametrize("scene_name,n_channels", [("random", 39), ("saturated", 3)])
def test_composite_pair_stream_backward_matches_jax_vjp(scene_name, n_channels):
    scene = saturated_scene() if scene_name == "saturated" else make_scene(13, 300)
    jp, gidx, starts, counts, attrs, bg = k1_inputs(scene, n_channels)
    tiles = jnp.asarray(np.asarray(counts))  # clamped counts: no K or B clip here
    tw = -(-SW // 32)
    k = attrs.shape[0]
    args = (jnp.asarray(attrs[:, 0:2]), jnp.asarray(attrs[:, 2:5]), jnp.asarray(attrs[:, 5]),
            jnp.asarray(attrs[:, 6:]), jnp.asarray(bg))
    (out, alpha), vjp = jax.vjp(
        lambda *a: rp.composite_pair_stream(jnp.asarray(gidx), jnp.asarray(starts), tiles, *a,
                                            tw, 32, k_cap=k), *args)
    rng = np.random.default_rng(4)
    g_out = rng.normal(size=out.shape).astype(np.float32)
    g_alpha = rng.normal(size=alpha.shape).astype(np.float32)
    jgrads = vjp((jnp.asarray(g_out), jnp.asarray(g_alpha)))

    targs = [T(np.asarray(a)).requires_grad_(True) for a in args]
    tout, talpha = rc.composite_pair_stream(T(gidx), T(starts), T(counts), *targs, tw, 32, k_cap=k)
    close(tout, out, atol=1e-5, rtol=1e-4, msg="out")
    tgrads = torch.autograd.grad((tout * T(g_out)).sum() + (talpha * T(g_alpha)).sum(), targs)
    for name, a, b in zip(("xys", "conics", "opacities", "colors", "bg"), tgrads, jgrads):
        close_scaled(a, b, 1e-4, msg=name)


# --- render and loss gradients -------------------------------------------------


def test_render_grads_match_jax():
    field, alive = make_field(5)
    jcfg, tcfg = configs()
    jcam, tcam = cameras()
    rng = np.random.default_rng(6)
    C = 3 + F + 1 + 3
    wimg = rng.normal(size=(H, W, C)).astype(np.float32)
    walpha = rng.normal(size=(H, W)).astype(np.float32)
    step = 9  # SH degree 3

    def jloss(f):
        o = j_render(f, jnp.asarray(alive), jcam, step, jcfg)
        img = jnp.concatenate([o["rgb"], o["feature"], o["depth"], o["normal"]], -1)
        return jnp.sum(img * wimg) + jnp.sum(o["alpha"] * walpha)

    jg = jax.jit(jax.grad(jloss))(jfield_of(field))
    tf = tfield_of(field, grad=True)
    o = t_render(tf, torch.as_tensor(alive), tcam, step, tcfg)
    img = torch.cat([o["rgb"], o["feature"], o["depth"], o["normal"]], -1)
    loss = (img * T(wimg)).sum() + (o["alpha"] * T(walpha)).sum()
    tg = torch.autograd.grad(loss, list(tf))
    for name, a in zip(FIELD_KEYS, tg):
        close_scaled(a, getattr(jg, name), 1e-4, msg=name)
        assert not a[~torch.as_tensor(alive)].any(), f"{name}: dead slots got a gradient"
    assert not tg[0][:5].any()  # culled by the projection


@pytest.mark.parametrize("raster", list(RASTER_CASES))
def test_train_loss_terms_and_grads_match_jax(raster):
    field, alive = make_field(7)
    field["log_scales"][10:15, 0] -= 3.0  # anisotropic past the ratio 10: scale_reg bites
    batch = make_batch(8)
    fea = fea_up_arrays()
    jcfg, tcfg = configs(RASTER_CASES[raster], sky_alpha_reg=0.3)
    jcam, tcam = cameras()
    step = 10  # every-10-step regularizers on, SH degree 3

    def f(ms, probe):
        return j_train_loss(ms, jnp.asarray(alive), jcam, {k: jnp.asarray(v) for k, v in batch.items()},
                            step, jcfg, probe=probe)

    jms = {"field": jfield_of(field), "fea_up": {k: jnp.asarray(v) for k, v in fea.items()}, "pose": None}
    (jtotal, jaux), (jg, jgp) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        jms, jnp.zeros((CAP, 2), jnp.float32))

    tf = tfield_of(field, grad=True)
    tfea = {k: v.requires_grad_(True) for k, v in params_from_numpy(fea).items()}
    probe = torch.zeros(CAP, 2, requires_grad=True)
    total, aux = t_train_loss({"field": tf, "fea_up": tfea}, torch.as_tensor(alive), tcam,
                              {k: torch.as_tensor(v) for k, v in batch.items()}, step, tcfg, probe=probe)
    assert set(aux["loss_dict"]) == set(jaux["loss_dict"])
    for k, v in jaux["loss_dict"].items():
        close(aux["loss_dict"][k], v, atol=1e-6, rtol=1e-4, msg=k)
        assert float(v) != 0.0, k
    close(total, jtotal, atol=1e-6, rtol=1e-4, msg="total")
    close(aux["psnr"], jaux["psnr"], atol=1e-4, rtol=1e-5, msg="psnr")
    close(aux["radii"], jaux["radii"], msg="radii")
    for k in ("overflow", "dropped_tiles", "pair_overflow"):
        assert int(aux[k]) == int(jaux[k]), k
        assert int(aux[k]) == 0 or (raster == "pairs_dropped" and k != "dropped_tiles"), k
    if raster == "pairs_dropped":
        assert int(aux["overflow"]) > 0 and int(aux["pair_overflow"]) > 0

    leaves = list(tf) + list(tfea.values()) + [probe]
    grads = torch.autograd.grad(total, leaves)
    for name, a in zip(FIELD_KEYS, grads):
        close_scaled(a, getattr(jg["field"], name), 1e-4, msg=name)
    for i in range(2):
        close_scaled(grads[len(tf) + 2 * i], np.asarray(jg["fea_up"][f"w{i}"]).T, 1e-4, msg=f"w{i}")
        close_scaled(grads[len(tf) + 2 * i + 1], jg["fea_up"][f"b{i}"], 1e-4, msg=f"b{i}")
    close_scaled(grads[-1], jgp, 1e-4, msg="probe")
    assert float(grads[-1].abs().max()) > 0


def test_train_loss_pose_opt_raises():
    """Pose optimization no longer raises: with a "pose" leaf and the
    batch's cam_idx, train_loss gives the JAX package's loss and delta
    gradient (tests/test_torch_pose_opt.py holds the rest)."""
    field, alive = make_field(0)
    jcfg, tcfg = configs(pose_opt_mode="SE3")
    jcam, tcam = cameras()
    batch = make_batch()
    fea = fea_up_arrays()
    pose = np.random.default_rng(3).normal(scale=0.02, size=(2, 6)).astype(np.float32)

    def f(p):
        jb = {**{k: jnp.asarray(v) for k, v in batch.items()}, "cam_idx": jnp.asarray(1)}
        ms = {"field": jfield_of(field), "fea_up": {k: jnp.asarray(v) for k, v in fea.items()},
              "pose": p}
        return j_train_loss(ms, jnp.asarray(alive), jcam, jb, 0, jcfg)[0]

    jtotal, jg = jax.jit(jax.value_and_grad(f))(jnp.asarray(pose))
    tpose = torch.as_tensor(pose).requires_grad_(True)
    total, _ = t_train_loss({"field": tfield_of(field), "fea_up": params_from_numpy(fea),
                             "pose": tpose}, torch.as_tensor(alive), tcam,
                            {**{k: torch.as_tensor(v) for k, v in batch.items()}, "cam_idx": 1},
                            0, tcfg)
    close(total, jtotal, atol=1e-6, rtol=1e-4, msg="total")
    (g,) = torch.autograd.grad(total, [tpose])
    close_scaled(g, jg, 1e-4, msg="pose")
    assert float(g[1].abs().min()) > 0 and not g[0].any()


# --- optimizer ------------------------------------------------------------------


@pytest.mark.parametrize("group", ["xyz", "opacity", "up_net"])
def test_lr_at_matches_jax(group):
    for step in (0, 1, 999, 15000, 29999, 30000, 45000):
        close(topt.lr_at(topt.DEFAULT_GROUPS[group], step),
              jopt.lr_at(jopt.DEFAULT_GROUPS[group], step), atol=0, rtol=1e-6, msg=f"{group} {step}")


def test_adam_accumulates_and_counts_like_optax():
    rng = np.random.default_rng(9)
    field, _ = make_field(9)
    fea = fea_up_arrays()
    jstate = {"field": jfield_of(field), "fea_up": {k: jnp.asarray(v) for k, v in fea.items()}}
    tstate = {"field": tfield_of(field), "fea_up": params_from_numpy(fea)}
    jo, to = jopt.init_opt_state(jstate), topt.init_opt_state(tstate)
    for step in range(8, 12):  # accum-10 groups update at step 9 only
        gfield = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in field.items()}
        gfea = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in fea.items()}
        jg = {"field": jfield_of(gfield), "fea_up": {k: jnp.asarray(v) for k, v in gfea.items()}}
        tg = {"field": tfield_of(gfield), "fea_up": params_from_numpy(gfea)}
        jstate, jo = jopt.apply_updates_grouped(jstate, jg, jo, step)
        tstate, to = topt.apply_updates_grouped(tstate, tg, to, step)
        for name in jo:
            want = int(step >= 9) if topt.DEFAULT_GROUPS[name].accum == 10 else step - 7
            assert int(to[name].count) == int(jo[name].adam.count) == want, (name, step)
        for k in FIELD_KEYS:
            close(getattr(tstate["field"], k), getattr(jstate["field"], k), atol=1e-6, rtol=1e-6, msg=k)
        close(to["xyz"].accum, jo["xyz"].accum, atol=1e-6, rtol=1e-6, msg="accum")
        close(to["up_net"].mu["layers.1.weight"], np.asarray(jo["up_net"].adam.mu["w1"]).T,
              atol=1e-7, rtol=1e-5, msg="up_net mu")
    # after step 9 the xyz accumulator restarted: it holds steps 10 and 11 summed
    assert float(to["xyz"].accum.abs().max()) > 0


# --- refinement -----------------------------------------------------------------


def test_accumulate_stats_first_step_branch():
    rng = np.random.default_rng(10)
    radii = np.where(rng.random(CAP) > 0.3, rng.uniform(1, 20, CAP), 0.0).astype(np.float32)
    jst, tst = jref.DensifyStats.zeros(CAP), tref.DensifyStats.zeros(CAP)
    for i in range(3):
        g = rng.normal(size=(CAP, 2)).astype(np.float32)
        jst = jref.accumulate_stats(jst, jnp.asarray(g), jnp.asarray(radii), W, H)
        tst = tref.accumulate_stats(tst, T(g), T(radii), W, H)
        for name, a, b in zip(jst._fields, jst, tst):
            close(b, a, msg=f"{name} {i}")
        if i == 0:
            assert (tst.vis_counts == 1).all()  # every Gaussian, visible or not
    assert float(tst.vis_counts.max()) == 3.0 and float(tst.vis_counts.min()) == 1.0


REFINE_CASES = {
    # step, warmup: densify + cull on (cooled), then an opacity reset step, then warmup
    "densify_cull": (4100, 0, 4),
    "screen_size": (3500, 0, 4),
    "opacity_reset": (3100, 0, 4),
    "warmup": (300, 500, 4),
    # densify + cull on the statistics of three train steps with pairs dropped
    "pairs_dropped": (4100, 0, 4),
}


def clipped_step_stats(field, alive):
    """Each package's densify statistics after three train steps (8, 9,
    10) from one converted state, the stream clipped by K and B: every
    step's overflow and pair_overflow positive and equal across the
    packages, the statistics held to each other (which Gaussians count as
    seen exactly, the gradient-norm sums to 1e-4 of their largest)."""
    jcfg, tcfg = configs(CLIPPED, sky_alpha_reg=0.3)
    jcam, tcam = cameras()
    batch = make_batch(1)
    jstate = j_init(jax.random.PRNGKey(2), jfield_of(field), jnp.asarray(alive),
                    {k: jnp.asarray(v) for k, v in fea_up_arrays().items()})
    jstate = jstate._replace(step=jnp.asarray(8, jnp.int32))
    tstate = convert(jstate)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    for _ in range(3):
        jstate, jm = j_step(jstate, jcam, jb, jcfg)
        tstate, tm = t_step(tstate, tcam, tb, tcfg)
        for k in ("overflow", "pair_overflow"):
            assert int(tm[k]) == int(jm[k]) > 0, k
    jst, tst = jstate.stats, tstate.stats
    np.testing.assert_array_equal(tst.vis_counts.numpy(), np.asarray(jst.vis_counts))
    close_scaled(tst.grad_norm_sum, jst.grad_norm_sum, 1e-4, msg="grad_norm_sum")
    close(tst.max_radii, jst.max_radii, atol=1e-6, rtol=1e-6, msg="max_radii")
    seen = np.asarray(jst.vis_counts) > 0
    assert float(np.asarray(jst.grad_norm_sum)[seen].max()) > 0
    return ({k: np.array(v) for k, v in jst._asdict().items()},
            {k: v.clone() for k, v in tst._asdict().items()})


@pytest.mark.parametrize("case", list(REFINE_CASES))
def test_refine_matches_jax_with_injected_noise(case):
    step, warmup, ntrain = REFINE_CASES[case]
    field, alive = make_field(11)
    rng = np.random.default_rng(12)
    field["log_scales"][:40] = np.log(0.02)   # small: duplicates
    field["log_scales"][40:45] = np.log(0.8)  # too big: culled after 3000
    stats = {"grad_norm_sum": rng.uniform(0, 0.003, CAP).astype(np.float32),
             "vis_counts": rng.integers(1, 5, CAP).astype(np.float32),
             "max_radii": rng.uniform(0, 0.3, CAP).astype(np.float32)}
    tstats = {k: T(v) for k, v in stats.items()}
    if case == "pairs_dropped":
        stats, tstats = clipped_step_stats(field, alive)
    groups = {name: (rng.normal(size=field[leaf].shape).astype(np.float32),
                     rng.random(field[leaf].shape, np.float32))
              for leaf, name in jopt.FIELD_GROUP_OF.items()}
    key = jax.random.PRNGKey(13)
    noise = np.asarray(jax.random.normal(key, (CAP, 3), jnp.float32))
    kw = dict(width=W, height=H, num_train_data=ntrain, warmup_length=warmup)
    jadam = {n: jopt._adam_tx(jopt.DEFAULT_GROUPS[n]).init(jnp.asarray(mu))._replace(
        mu=jnp.asarray(mu), nu=jnp.asarray(nu)) for n, (mu, nu) in groups.items()}
    jf, ja, jadam2, jstats = jref.refine(
        jfield_of(field), jnp.asarray(alive), jadam,
        jref.DensifyStats(**{k: jnp.asarray(v) for k, v in stats.items()}), step, key, **kw)
    tf, ta, tadam2, tstats = tref.refine(
        tfield_of(field), torch.as_tensor(alive), {n: (T(mu), T(nu)) for n, (mu, nu) in groups.items()},
        tref.DensifyStats(**tstats), step, T(noise), **kw)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    for k in FIELD_KEYS:
        close(getattr(tf, k), getattr(jf, k), atol=1e-6, rtol=1e-6, msg=k)
    for n in groups:
        close(tadam2[n][0], jadam2[n].mu, msg=f"{n} mu")
        close(tadam2[n][1], jadam2[n].nu, msg=f"{n} nu")
    for name, a, b in zip(jstats._fields, jstats, tstats):
        close(b, a, msg=name)
    changed = bool((ta.numpy() != alive).any())
    assert changed == (case in ("densify_cull", "screen_size", "pairs_dropped")), case
    if case == "opacity_reset":
        assert not tadam2["opacity"][0].any() and float(tf.opacity_logits.std()) == 0.0


def test_grow_capacity_matches_jax():
    field, alive = make_field(14)
    jstate = j_init(jax.random.PRNGKey(0), jfield_of(field), jnp.asarray(alive),
                    {k: jnp.asarray(v) for k, v in fea_up_arrays().items()})
    tstate = convert(jstate)
    jg, tg = j_grow(jstate, CAP + 40), t_grow(tstate, CAP + 40)
    assert tg.field.capacity == CAP + 40 and t_grow(tg, CAP) is tg
    for k in FIELD_KEYS:
        np.testing.assert_array_equal(getattr(tg.field, k).numpy(), np.asarray(getattr(jg.field, k)))
    np.testing.assert_array_equal(tg.alive.numpy(), np.asarray(jg.alive))
    for name, o in jg.opt.items():
        np.testing.assert_array_equal(tg.opt[name].mu.numpy() if name != "up_net"
                                      else tg.opt[name].mu["layers.0.weight"].numpy(),
                                      np.asarray(o.adam.mu) if name != "up_net"
                                      else np.asarray(o.adam.mu["w0"]).T)
        assert tuple(tg.opt[name].accum.shape if name != "up_net"
                     else tg.opt[name].accum["layers.1.bias"].shape) == \
            (np.asarray(o.accum).shape if name != "up_net" else np.asarray(o.accum["b1"]).shape)
    for a, b in zip(jg.stats, tg.stats):
        assert b.shape == (CAP + 40,) and not b.any() and not np.asarray(a).any()


def test_init_from_seeds_matches_jax():
    rng = np.random.default_rng(15)
    n = 200
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    xyz[1] = xyz[0]  # a duplicate point: distance 0
    rgb = rng.integers(0, 256, (n, 3)).astype(np.float32)
    key = jax.random.PRNGKey(16)
    jf, ja = j_init_from_seeds(key, xyz, rgb, feature_dim=F, capacity=n + 10)
    k_quat, k_feat = jax.random.split(key)
    draws = {"quats": np.asarray(jax.random.uniform(k_quat, (3, n))),
             "features": np.asarray(jax.random.uniform(k_feat, (n, F)))}
    tf, ta = t_init_from_seeds(xyz, rgb, draws, capacity=n + 10)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    for k in FIELD_KEYS:
        close(getattr(tf, k), getattr(jf, k), atol=1e-6, rtol=1e-6, msg=k)


# --- the train step -------------------------------------------------------------


@pytest.fixture(scope="module")
def three_steps():
    """JAX and port states from one converted state at step 8, stepped
    three times (steps 8, 9 and 10: accumulate, apply, regularize)."""
    field, alive = make_field(0)
    batch = make_batch(1)
    jcfg, tcfg = configs(sky_alpha_reg=0.3)
    jcam, tcam = cameras()
    jstate = j_init(jax.random.PRNGKey(2), jfield_of(field), jnp.asarray(alive),
                    {k: jnp.asarray(v) for k, v in fea_up_arrays().items()})
    jstate = jstate._replace(step=jnp.asarray(8, jnp.int32))
    tstate = convert(jstate)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    out = []
    for _ in range(3):
        jstate, jm = j_step(jstate, jcam, jb, jcfg)
        tstate, tm = t_step(tstate, tcam, tb, tcfg)
        out.append(dict(jstate=jax.tree.map(np.array, jstate), jm=jax.tree.map(np.array, jm),
                        tstate=tstate, tm=tm))
    return out


def test_three_train_steps_match_jax(three_steps):
    # the first step's gradients, kept whole in the accumulating groups
    first = three_steps[0]
    for name in ("xyz", "color", "feature"):
        close_scaled(first["tstate"].opt[name].accum, first["jstate"].opt[name].accum, 1e-4, msg=name)
    for i, s in enumerate(three_steps):
        assert set(s["tm"]) == set(s["jm"])
        for k, v in s["jm"].items():
            close(s["tm"][k], v, atol=1e-6, rtol=1e-4, msg=f"step {i} {k}")
        assert all(bool(torch.isfinite(torch.as_tensor(v)).all()) for v in s["tm"].values())
    last = three_steps[-1]
    ts, js = last["tstate"], last["jstate"]
    assert ts.step == int(js.step) == 11
    updates = {}
    for name in topt.DEFAULT_GROUPS:
        if name in ts.opt:
            updates[name] = int(ts.opt[name].count)
            assert updates[name] == int(js.opt[name].adam.count), name
    assert updates == {"xyz": 1, "color": 1, "feature": 1, "opacity": 3, "scaling": 3,
                       "rotation": 3, "up_net": 3}
    for leaf, name in topt.FIELD_GROUP_OF.items():
        atol = 2.0 * topt.DEFAULT_GROUPS[name].lr_init * updates[name]
        close(getattr(ts.field, leaf), getattr(js.field, leaf), atol=atol, rtol=0, msg=leaf)
    for i in range(2):
        close(ts.fea_up[f"layers.{i}.weight"], js.fea_up[f"w{i}"].T,
              atol=2.0 * 1e-3 * 3, rtol=0, msg=f"w{i}")
    for name, a, b in zip(js.stats._fields, js.stats, ts.stats):
        close(b, a, atol=1e-6, rtol=1e-3, msg=name)


def test_refine_step_after_train_steps(three_steps):
    _, tcfg = configs()
    ts = dataclasses.replace(three_steps[-1]["tstate"], step=4100)
    out = t_refine_step(ts, tcfg, W, H, num_train_data=4)
    assert out.field.capacity == CAP and int(out.alive.sum()) != int(ts.alive.sum())
    assert not out.stats.vis_counts.any()
    for x in out.field:
        assert bool(torch.isfinite(x).all())


def test_checkpoint_round_trip(three_steps, tmp_path):
    ts = three_steps[-1]["tstate"]
    assert tckpt.latest_checkpoint(tmp_path / "none") is None
    tckpt.save_checkpoint(tmp_path, dataclasses.replace(ts, step=5))
    path = tckpt.save_checkpoint(tmp_path, ts)
    assert tckpt.latest_checkpoint(tmp_path) == path and len(list(tmp_path.iterdir())) == 1
    back = tckpt.load_checkpoint(path)
    assert back.step == ts.step
    for a, b in zip(ts.field, back.field):
        torch.testing.assert_close(b, a, atol=0, rtol=0)
    torch.testing.assert_close(back.alive, ts.alive)
    for name, st in ts.opt.items():
        for part in ("mu", "nu", "count", "accum"):
            for a, b in zip(topt.leaves(getattr(st, part)), topt.leaves(getattr(back.opt[name], part))):
                torch.testing.assert_close(b, a, atol=0, rtol=0)
    for a, b in zip(ts.stats, back.stats):
        torch.testing.assert_close(b, a, atol=0, rtol=0)
    draw = torch.randn(4, generator=torch.Generator().set_state(ts.generator.get_state()))
    torch.testing.assert_close(torch.randn(4, generator=back.generator), draw)
