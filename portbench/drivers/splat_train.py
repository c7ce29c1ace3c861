"""Driver `splat_train`: the splat trainer's loop, `Trainer.train`, the loop
behind `ggt-torch-train`, on the configuration's capture.

Set-up makes the state at `start_step` from the capture's seed cloud (each
point jittered by the seed), seeded SH rest bands and a seeded fea_up, at
the configuration's capacity, hands it to the trainer, and runs the loop
through `warmup_steps` steps and the refine after them. The window then
runs the same loop until the deadline. A gate in place of the module
attribute `train_state.train_step` counts steps and ends the loop
(`StopWindow`); the trainer's `finally` closes its prefetcher.

The check (`Check`) follows the first three steps of the warm-up with the
plain reference from the same start state and the batches those steps
were fed, each batch first checked against the capture's own files; holds
the first step's composited maps (taken from the program's
`model.rasterize_projected` in the warm-up) and every loss term; and it
runs the reference's refine on the state the first refine was given.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from harness import common, inputs, walk, work
from harness.common import StopWindow, cpu
from harness.compare import leaf_diffs, leaf_gaps, loss_gap, map_err, term_gap, worst
from harness.gate import Gate
from harness.trace import Profile, Spans, SyncTimer, warm_profiler

REF = "gaussiangrasper-efd"
COMPARED = 3
TERMS = ("main_loss", "feature_loss", "up_loss", "depth_loss", "normal_loss", "sh_reg", "scale_reg")
REGS = ("sh_reg", "scale_reg")
# channel groups of the composited maps, alpha appended last
GROUPS = {"rgb": (0, 3), "feature": (3, 35), "depth": (35, 36), "normal": (36, 39),
          "alpha": (39, 40)}


def _ref(mod: str):
    return common.reference(REF, mod)


def half_batch(batch: dict) -> dict:
    """The fault "half of the batch left out, the mean taken over the
    rest": the second half of the pixel rows, pair groups and points
    marked invalid."""
    out = dict(batch)
    vm = batch["valid_mask"].clone()
    vm[vm.shape[0] // 2:] = False
    out["valid_mask"] = vm
    for k in ("group_valid", "point_valid"):
        v = batch[k].clone()
        v[v.shape[0] // 2:] = False
        out[k] = v
    return out


def altered(to_device):
    """The fault "an answer altered where it is produced": the data layer's
    batches leave it with their image's first row raised by 1e-3."""

    def wrapped(host):
        out = dict(to_device(host))
        img = out["image"].clone()
        img[0] += 1e-3
        out["image"] = img
        return out

    return wrapped


def map_altered(raster):
    """The fault "an answer altered where it is produced": the compositor's
    maps with their first row raised by 1e-3."""

    def wrapped(*a, **k):
        out = dict(raster(*a, **k))
        img = out["image"].clone()
        img[0] += 1e-3
        out["image"] = img
        return out

    return wrapped


def planted(step_fn, fault: Optional[str]):
    """train_step with the fault planted: "half_batch" (the second half of
    the batch marked invalid) or "unchanged" (the state handed back)."""
    if fault == "half_batch":
        return lambda state, camera, batch, cfg, *a, **k: step_fn(
            state, camera, half_batch(batch), cfg, *a, **k)
    if fault == "unchanged":
        return lambda state, camera, batch, cfg, *a, **k: (
            state, step_fn(state, camera, batch, cfg, *a, **k)[1])
    return step_fn


def tree_cpu(tree):
    return {k: cpu(v) for k, v in tree.items()} if isinstance(tree, dict) else cpu(tree)


def tree_to(tree, device):
    return ({k: v.to(device) for k, v in tree.items()} if isinstance(tree, dict)
            else tree.to(device))


def initial_state(data: Path, seed: int, model: dict, capacity: int, jitter: float, device):
    """The start state's field, alive mask and fea_up, made by the
    benchmark: the capture's seed cloud, each point moved by N(0, jitter)
    per axis, through the reference's `init_from_seeds` (quats and
    features drawn from the seed), SH rest bands 0.1 N(0, 1) drawn on the
    device, fea_up with nn.Linear's default draws."""
    import torch

    ref_model = _ref("model")
    xyz = np.load(data / "bench_raw" / "points_xyz.npy")
    rgb = np.load(data / "bench_raw" / "points_rgb.npy")
    rng = np.random.default_rng(seed)
    xyz = (xyz + rng.normal(0.0, jitter, xyz.shape)).astype(np.float32)
    n = xyz.shape[0]
    draws = {"quats": rng.random((3, n), np.float32),
             "features": rng.random((n, model["feature_dim"]), np.float32)}
    field, alive = ref_model.init_from_seeds(xyz, rgb, draws, sh_degree=model["sh_degree"],
                                             capacity=capacity, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    sh = field.sh_coeffs.clone()
    sh[:n, 1:] = 0.1 * torch.randn((n, sh.shape[1] - 1, 3), generator=g, device=device)
    field = field._replace(sh_coeffs=sh)
    dims = (model["feature_dim"], model["fea_up_hidden"], model["clip_dim"])
    fea_up = inputs.fea_up_state(inputs.seeded_fea_up_arrays(seed + 1, dims), device)
    return field, alive, fea_up


class SplatTrain:
    """One run of the cell: `setup`, `warmup`, `window`, then `check`."""

    def __init__(self, cell: dict, seed: int, traced: bool = False, fault: Optional[str] = None,
                 device: str = "cuda"):
        self.cell = cell
        self.conf = cell["config_data"]
        self.traffic = cell["traffic_data"]
        self.seed = int(seed)
        self.device = device
        self.traced = traced
        self.spans = Spans(traced)
        self.fault = fault
        self.captured: Dict[str, object] = {"batches": [], "losses": [], "terms": []}
        self.refine_timer = SyncTimer()
        self.window_steps = 0
        self.window_s = 0.0
        self.failed = 0
        self._grab = False
        self.profile: Optional[Profile] = None
        self.traced_input = None

    # ---- set-up ----------------------------------------------------------

    def setup(self) -> None:
        from gaussiangrasper_torch.data.dataparsers.zoo import resolve_parser
        from gaussiangrasper_torch.data.manager import FullImageDatamanager, SamplerConfig
        from gaussiangrasper_torch.engine import train_state
        from gaussiangrasper_torch.engine.trainer import Trainer, TrainerConfig
        from gaussiangrasper_torch.models.gaussian_field import GaussianParams
        from gaussiangrasper_torch.models.model import GaussianSplatConfig
        from gaussiangrasper_torch.ops.rasterize import RasterizeConfig

        t = self.traffic
        m = self.conf["model"]
        self.data = inputs.tabletop(self.conf["scene"])
        self.model_cfg = GaussianSplatConfig(
            **{k: v for k, v in m.items() if k not in ("fea_up_hidden", "raster")},
            raster=RasterizeConfig(**m["raster"]))
        outputs = resolve_parser(self.data).parse()
        self.dm = FullImageDatamanager(outputs, SamplerConfig(**self.conf["sampler"]),
                                       seed=self.seed, device=self.device)
        run_root = Path(tempfile.gettempdir()) / "portbench"
        tcfg = TrainerConfig(data=self.data, output_dir=run_root, experiment_name="splat_train",
                             max_iterations=10 ** 9, steps_per_save=10 ** 9, seed=self.seed,
                             model=self.model_cfg)
        self.trainer = Trainer(tcfg, self.dm)
        field, alive, fea_up = initial_state(self.data, self.seed, m, self.conf["capacity"],
                                             t["seed_jitter"], self.device)
        self.s0 = {"field": [cpu(x) for x in field], "alive": cpu(alive),
                   "fea_up": {k: cpu(v) for k, v in fea_up.items()}}
        state = train_state.init_train_state(GaussianParams(*field), alive, fea_up, seed=self.seed)
        self.trainer.state = dataclasses.replace(state, step=t["start_step"])
        self.train_state = train_state
        self.real_step, self.real_refine = train_state.train_step, train_state.refine_step
        self.gate = Gate(self.real_step, self.spans, "train_step")
        self.gate.body = planted(self.real_step, self.fault)
        if self.fault == "batch_altered":
            self.dm.to_device = altered(self.dm.to_device)
        from gaussiangrasper_torch.models import model

        self.model_mod, self.real_raster = model, model.rasterize_projected
        if self.fault == "map_altered":
            model.rasterize_projected = map_altered(self.real_raster)
        train_state.train_step = self.gate
        train_state.refine_step = self._refine
        warm_profiler()

    def close(self) -> None:
        self.train_state.train_step = self.real_step
        self.train_state.refine_step = self.real_refine
        self.model_mod.rasterize_projected = self.real_raster

    @property
    def attempted(self) -> int:
        return self.window_steps

    def _profiling(self) -> bool:
        return self.profile is not None and not self.profile.stopped

    def _refine(self, state, *a, **k):
        with self.spans.span("refine_step"):
            refine = (lambda s, *a_, **k_: s) if self.fault == "refine_unchanged" else self.real_refine
            if "refine_in" not in self.captured:
                self.captured["refine_in"] = self._state_to_cpu(state)
                self.captured["refine_gen"] = state.generator.get_state().clone()
                self.captured["refine_args"] = (a, k)
                out = refine(state, *a, **k)
                self.captured["refine_out"] = self._state_to_cpu(out)
                return out
            if self.fault == "refine_unchanged":
                return state
            if self.traced and not self._profiling():
                # a layer's own time between syncs, outside the profiled
                # stretch only: the syncs change the loop they sit in
                return self.refine_timer.wrap(self.real_refine)(state, *a, **k)
            return self.real_refine(state, *a, **k)

    @staticmethod
    def _state_to_cpu(state) -> dict:
        return {"step": state.step, "field": [cpu(x) for x in state.field], "alive": cpu(state.alive),
                "fea_up": {k: cpu(v) for k, v in state.fea_up.items()},
                "opt": {g: (tree_cpu(st.mu), tree_cpu(st.nu)) for g, st in state.opt.items()},
                "stats": [cpu(x) for x in state.stats]}

    def _capture(self, done, args, out) -> None:
        if done > COMPARED:
            return
        camera, batch = args[1], args[2]
        self.captured["batches"].append(({k: cpu(v) for k, v in batch.items()},
                                         cpu(camera.camera_to_world)))
        self.captured["losses"].append(cpu(out[1]["loss"]))
        self.captured["terms"].append({k: float(out[1][k]) for k in TERMS})
        if done == 1:
            s1 = out[0]
            self.captured["s1"] = {"opt": {g: tree_cpu(st.mu) for g, st in s1.opt.items()},
                                   "grad_norm_sum": cpu(s1.stats.grad_norm_sum)}
        if done == COMPARED:
            s3 = out[0]
            self.captured["s3"] = {"field": [cpu(x) for x in s3.field],
                                   "fea_up": {k: cpu(v) for k, v in s3.fea_up.items()}}

    def _keep_maps(self, fn):
        """`rasterize_projected` handing the first step's composited maps
        (and alpha) to the check."""

        def wrapped(*a, **k):
            out = fn(*a, **k)
            if self._grab:
                self._grab = False
                self.captured["maps"] = cpu(torch_cat_alpha(out["image"], out["alpha"]))
            return out

        return wrapped

    def warmup(self) -> None:
        """The first `warmup_steps` steps and the refine after them, through
        the window's own loop; the first three are captured for the check,
        and the first one's composited maps."""
        model = self.model_mod
        real_raster = model.rasterize_projected
        model.rasterize_projected = self._keep_maps(real_raster)
        self.gate.limit = self.traffic["warmup_steps"]
        self.gate.on_step = self._capture
        self.gate.before_step = lambda done, args: setattr(self, "_grab", done == 0)
        try:
            with common.program_stdout_to_stderr():
                self.trainer.train()
        except StopWindow:
            pass
        finally:
            model.rasterize_projected = real_raster
        self._grab = False
        self.gate.limit = None
        self.gate.on_step = None
        self.gate.before_step = None

    # ---- the window --------------------------------------------------------

    def window(self, seconds: float) -> float:
        """Runs the loop until the deadline; returns the window's start
        (perf_counter) for set-up's end."""
        import torch

        from gaussiangrasper_torch.data import prefetch
        from gaussiangrasper_torch.utils.writer import MetricsWriter

        patched = []
        if self.traced:
            for owner, name, label in ((prefetch.PrefetchingDatamanager, "next_train", "data_wait"),
                                       (MetricsWriter, "step", "writer")):
                fn = getattr(owner, name)
                patched.append((owner, name, fn))
                setattr(owner, name, self.spans.wrap(fn, label))
            self.gate.before_step = self._trace_hook
        else:
            self.gate.before_step = self._device_hook
        self.gate.done = 0
        common.sync()
        t0 = time.perf_counter()
        self.gate.deadline = t0 + seconds
        try:
            with common.program_stdout_to_stderr():
                self.trainer.train()
        except StopWindow:
            pass
        finally:
            common.sync()
            self.window_s = time.perf_counter() - t0
            for owner, name, fn in patched:
                setattr(owner, name, fn)
            self.gate.deadline = None
            self.gate.before_step = None
            if self.profile is not None and not self.profile.stopped:
                self.profile.stop()
        self.window_steps = self.gate.done
        return t0

    def _trace_hook(self, done: int, args) -> None:
        """Profile `trace_steps` steps from the first step at
        `trace_phase` (mod refine_every), so a refine falls inside; keep
        the first traced step's field and the reference's own camera of
        its view, for the work count."""
        t = self.traffic
        state, camera = args[0], args[1]
        if self.profile is None and done >= t["trace_after"] and \
                state.step % self.model_cfg.refine_every == t["trace_phase"]:
            _, cam = camera_for(self.data, cpu(camera.camera_to_world), self.device)
            self.traced_input = (state.field, state.alive, state.step, cam)
            self.trace_first = done
            self.profile = Profile()
            self.profile.start()
        elif self.profile is not None and not self.profile.stopped and \
                done == self.trace_first + t["trace_steps"]:
            self.profile.stop()

    def _device_hook(self, done: int, args) -> None:
        """With --trace 0: profile the `device_steps` window steps from the
        `device_after`th, for the device time a step (the window starts at
        a refine, so one falls inside where device_after + device_steps
        passes refine_every)."""
        t = self.traffic
        if self.profile is None and done == t["device_after"]:
            self.trace_first = done
            self.profile = Profile()
            self.profile.start()
        elif self._profiling() and done == self.trace_first + t["device_steps"]:
            self.profile.stop()

    # ---- metrics -----------------------------------------------------------

    def rays_per_s(self) -> float:
        """Supervised pixels of every window step over the window's time."""
        return self.window_steps * self.conf["scene"]["width"] * self.conf["scene"]["height"] \
            / self.window_s

    def end_to_end(self, setup_s: float) -> Dict[str, dict]:
        """train_step_device_ms: the union of the device's kernel, copy and
        set intervals over the profiled stretch of `device_steps` steps, a
        step; setup_s. The window's rays/s goes to stderr (per layer, it is
        `rays_per_s.efd_train`)."""
        print(f"portbench window: {self.window_steps} steps in {self.window_s:.3f} s, "
              f"{self.rays_per_s()!r} rays/s", file=sys.stderr)
        if self.profile is None or self.window_steps < self.trace_first + self.traffic["device_steps"]:
            raise RuntimeError("the window closed before its profiled stretch ended")
        tr = self.profile.reduce()
        print(f"portbench device stretch: {len(tr.kernels)} device events, {tr.busy_s!r} s busy "
              f"of {tr.window_s!r} s", file=sys.stderr)
        return {"train_step_device_ms": {"value": 1e3 * tr.busy_s / self.traffic["device_steps"],
                                         "unit": "ms"},
                "setup_s": {"value": setup_s, "unit": "s"}}

    def layer_context(self) -> dict:
        """What the per-layer readers take: the trace, the spans' times and
        the work the traced step's inputs need."""
        ctx = {"trace": self.profile.reduce() if self.profile else None,
               "data_wait_s": list(self.trainer.data_wait_s),
               "refine_s": list(self.refine_timer.seconds),
               "step_s": self.window_s / max(self.window_steps, 1),
               "rays_per_s": self.rays_per_s()}
        if self.traced_input is None:
            return ctx
        field, alive, step, cam = self.traced_input
        k1, k2 = walk.splat_walk(_ref("model").GaussianParams(*field), alive, cam, step,
                                 self.ref_cfg())
        m = self.conf["model"]
        n_live = int(alive.sum())
        per_row = 3 + 3 + 4 + 1 + 3 * (m["sh_degree"] + 1) ** 2 + m["feature_dim"]
        accum_per_row = 3 + 3 * (m["sh_degree"] + 1) ** 2 + m["feature_dim"]
        s = self.conf["sampler"]
        ctx["work"] = {"k1": k1, "k2": k2, "step": work.splat_step_least(
            n_live, (m["sh_degree"] + 1) ** 2, m["feature_dim"], m["clip_dim"], m["fea_up_hidden"],
            cam.height, cam.width, s["max_groups"] * s["pairs_per_group"], s["num_points"], k1, k2,
            per_row, accum_per_row, _ref("train").DEFAULT_GROUPS["xyz"].accum,
            self.model_cfg.refine_every)}
        return ctx

    def ref_cfg(self):
        return common.reference(REF).config_from(self.conf["model"])

    def free_program(self) -> None:
        import torch

        self.close()
        self.traced_input = None
        self.trainer = None
        self.dm = None
        gc.collect()
        torch.cuda.empty_cache()


def torch_cat_alpha(image, alpha):
    """The composited channels (H, W, C) with alpha (H, W) appended."""
    import torch

    return torch.cat([image, alpha[..., None]], -1)


def camera_for(data: Path, c2w_program, device):
    """The reference's own camera of the capture view whose pose the
    program's camera carries: (view index, Camera), from transforms.json;
    index -1 where no view matches."""
    import torch

    ref_geo = _ref("geometry")
    poses, meta = inputs.capture_views(data)
    got = np.asarray(c2w_program, np.float64)
    errs = [float(np.abs(p[:3, :4] - got).max()) for p in poses]
    i = int(np.argmin(errs))
    if errs[i] > 1e-6:
        return -1, None
    cam = ref_geo.Camera.create(meta["fl_x"], meta["fl_y"], meta["cx"], meta["cy"],
                                poses[i][:3, :4], int(meta["w"]), int(meta["h"]), device=device)
    return i, cam


def batch_errors(data: Path, view: int, batch: dict) -> int:
    """How many entries of a fed batch break what the capture's files and
    the sampler's contract say: image, depth, normal and valid mask equal
    to the view's files; the SAM mask the file's ids gated by validity;
    every valid pair inside one mask id; every valid point inside a mask,
    its CLIP target the feature file's vector there, invalid ones zero."""
    stem = f"r_{view:03d}"
    rgb = (np.load(data / "bench_raw" / f"{stem}_rgb.npy") / 255.0).astype(np.float32)
    depth = np.load(data / "depths" / f"{stem}.npy").astype(np.float32)
    normal = np.load(data / "normals" / f"{stem}.npy").astype(np.float32)
    valid = np.load(data / "boundary_mask" / f"{stem}.npy").astype(bool)
    sam = np.where(valid, np.load(data / "masks" / f"{stem}.npy"), -1).astype(np.int32)
    feat = np.load(data / "features" / f"{stem}.npy").astype(np.float32)
    b = {k: v.numpy() for k, v in batch.items()}
    bad = int((b["image"] != rgb).sum() + (b["depth"] != depth).sum()
              + (b["normal"] != normal).sum() + (b["valid_mask"] != valid).sum()
              + (b["sam_mask"] != sam).sum())
    pa, pb, pv = b["pair_a"], b["pair_b"], b["pair_valid"] & b["group_valid"][:, None]
    ida, idb = sam[pa[..., 0], pa[..., 1]], sam[pb[..., 0], pb[..., 1]]
    bad += int((pv & ((ida != idb) | (ida < 0))).sum())
    pts, ok = b["points"], b["point_valid"]
    bad += int((ok & (sam[pts[:, 0], pts[:, 1]] < 0)).sum())
    h, w = sam.shape
    fy, fx = (pts[:, 0] * feat.shape[0]) // h, (pts[:, 1] * feat.shape[1]) // w
    want = np.where(ok[:, None], feat[fy, fx], 0.0)
    bad += int((b["gt_clip"] != want).sum())
    return bad


def leaf_tensors(field, fea_up: dict) -> Dict[str, "object"]:
    names = ("means", "log_scales", "quats", "opacity_logits", "sh_coeffs", "features")
    out = dict(zip(names, field))
    out.update({f"fea_up.{k}": v for k, v in fea_up.items()})
    return out


def first_grads(s1: dict, b1: float) -> Dict[str, "object"]:
    """Each leaf's first gradient as the optimizer took it, from its state
    after one step: every group was due on that step (start_step is one
    before an accumulation boundary), its moments zero before, so
    g = mu / (1 - b1); and the screen-space probe's gradient norms, which
    the densify statistics took whole on that first step."""
    group_of = {"means": "xyz", "sh_coeffs": "color", "features": "feature",
                "opacity_logits": "opacity", "log_scales": "scaling", "quats": "rotation"}
    out = {leaf: s1["opt"][g] / (1.0 - b1) for leaf, g in group_of.items()}
    out.update({f"fea_up.{k}": v / (1.0 - b1) for k, v in s1["opt"]["up_net"].items()})
    out["screen_probe"] = s1["grad_norm_sum"]
    return out


class Check:
    """The reference's side of the check, on what the run captured."""

    def __init__(self, run: SplatTrain):
        self.run = run

    def reference_steps(self, tf32: bool, device: str) -> dict:
        """The reference's three steps from the start state on the fed
        batches (each on the reference's own camera of its view)."""
        import torch

        run = self.run
        ref_train = _ref("train")
        ref_model = _ref("model")
        s0 = run.s0
        field = ref_model.GaussianParams(*(x.to(device) for x in s0["field"]))
        state = ref_train.init_train_state(field, s0["alive"].to(device),
                                           {k: v.to(device) for k, v in s0["fea_up"].items()},
                                           seed=run.seed)
        state = dataclasses.replace(state, step=run.traffic["start_step"])
        cfg = run.ref_cfg()
        losses, terms, s1, maps = [], [], None, None
        with common.reference(REF).precision(tf32):
            for i, (batch, c2w) in enumerate(run.captured["batches"]):
                _, cam = camera_for(run.data, c2w, device)
                if i == 0:
                    with torch.no_grad():
                        outs = ref_model.render(state.field, state.alive, cam, state.step, cfg)
                    maps = torch.cat([outs["rgb"], outs["feature"], outs["depth"], outs["normal"],
                                      outs["alpha"][..., None]], -1)
                    del outs
                state, m = ref_train.train_step(state, cam, {k: v.to(device) for k, v in batch.items()},
                                                cfg)
                losses.append(float(m["loss"]))
                terms.append({k: float(m[k]) for k in TERMS})
                if i == 0:
                    s1 = {"opt": {g: st.mu for g, st in state.opt.items()},
                          "grad_norm_sum": state.stats.grad_norm_sum}
        return {"losses": losses, "terms": terms, "s1": s1, "maps": maps,
                "s3": {"field": list(state.field), "fea_up": dict(state.fea_up)}}

    def reference_refine(self, tf32: bool, device: str) -> dict:
        """The reference's refine on the state the program's first refine
        was given, with the same split noise (the program generator's
        state before it drew)."""
        import torch

        run = self.run
        ref_train, ref_model = _ref("train"), _ref("model")
        cin = run.captured["refine_in"]
        gen = torch.Generator(device=device)
        gen.set_state(run.captured["refine_gen"])
        group_cfgs = ref_train.DEFAULT_GROUPS
        opt = {}
        for g, (mu, nu) in cin["opt"].items():
            z = torch.zeros((), dtype=torch.int32, device=device)
            opt[g] = ref_train.GroupOptState(tree_to(mu, device), tree_to(nu, device), z, None)
        state = ref_train.TrainState(
            step=cin["step"], field=ref_model.GaussianParams(*(x.to(device) for x in cin["field"])),
            alive=cin["alive"].to(device), fea_up={k: v.to(device) for k, v in cin["fea_up"].items()},
            opt=opt, stats=ref_train.DensifyStats(*(x.to(device) for x in cin["stats"])),
            generator=gen)
        a, k = run.captured["refine_args"]
        with common.reference(REF).precision(tf32):
            out = ref_train.refine_step(state, *a, **k)
        return {"field": list(out.field), "alive": out.alive}

    def numbers(self, device: Optional[str] = None, control: bool = False) -> Dict[str, float]:
        """batch_errors; the first step's loss_gap_step1 (the total), term_gap
        (each loss term; the regularizers, off on that step, on the second)
        and map_err (each channel group's largest gap of the composited maps
        over its largest reference value: projection, SH, binning and the
        compositor); the first gradient's grad_gap (gaps of norms) and
        grad_diff (norms of differences); delta_gap; refine_alive and
        refine_gap. With `control`, the reference in TF32 stands in the
        program's place."""
        device = device or self.run.device
        import torch

        run = self.run
        ref = self.reference_steps(False, device)
        ref_b1 = _ref("train").B1
        if control:
            prog = self.reference_steps(True, device)
        else:
            prog = {k: run.captured[k] for k in ("s1", "s3", "terms", "maps")}
            prog["losses"] = [float(x) for x in run.captured["losses"]]
        prog_losses, prog_s1, prog_s3 = prog["losses"], prog["s1"], prog["s3"]
        out = {}
        bad = 0
        for batch, c2w in run.captured["batches"]:
            view, _ = camera_for(run.data, c2w, "cpu")
            bad += 10 ** 9 if view < 0 else batch_errors(run.data, view, batch)
        out["batch_errors"] = float(bad)
        # the first step's loss: the later steps' losses swing with Adam's
        # sign-like first updates of near-zero gradients (PERF.md); the
        # change after three steps (delta_gap) holds the later steps
        out["loss_gap_step1"] = loss_gap(prog_losses[:1], ref["losses"][:1])
        # every term of the first step; the regularizers (on every 10th
        # step, so off on the first) on the second
        out["term_gap"] = max(term_gap(prog["terms"][0], ref["terms"][0]),
                              term_gap({k: prog["terms"][1][k] for k in REGS},
                                       {k: ref["terms"][1][k] for k in REGS}))
        out["map_err"] = map_err(prog["maps"], ref["maps"], GROUPS)
        del prog["maps"], ref["maps"]
        to = lambda d: {k: v.to(device) for k, v in d.items()}  # noqa: E731
        g_ref = to(first_grads(ref["s1"], ref_b1))
        g_prog = to(first_grads(prog_s1, ref_b1))
        gaps, diffs = leaf_gaps(g_prog, g_ref, g_ref), leaf_diffs(g_prog, g_ref, g_ref)
        out["grad_gap"], out["grad_diff"] = max(gaps.values()), max(diffs.values())
        print(f"check detail grad_gap: {worst(gaps)}; grad_diff: {worst(diffs)}", file=sys.stderr)
        s0 = leaf_tensors([x.to(device) for x in run.s0["field"]], to(run.s0["fea_up"]))
        d_ref = {k: v.to(device) - s0[k] for k, v in leaf_tensors(ref["s3"]["field"], ref["s3"]["fea_up"]).items()}
        d_prog = {k: v.to(device) - s0[k]
                  for k, v in leaf_tensors(prog_s3["field"], prog_s3["fea_up"]).items()}
        gaps = leaf_gaps(d_prog, d_ref, g_ref)
        out["delta_gap"] = max(gaps.values())
        print(f"check detail delta_gap: {worst(gaps)}", file=sys.stderr)
        del ref, g_ref, g_prog, d_ref, d_prog, s0
        want = self.reference_refine(False, device)
        if control:
            got = self.reference_refine(True, device)
            got_field, got_alive = got["field"], got["alive"]
        else:
            got_field = [x.to(device) for x in run.captured["refine_out"]["field"]]
            got_alive = run.captured["refine_out"]["alive"].to(device)
        both = got_alive & want["alive"]
        out["refine_alive"] = float((got_alive != want["alive"]).sum())
        gaps = []
        for g, w in zip(got_field, want["field"]):
            w_b, g_b = w[both], g[both]
            gaps.append(float((g_b - w_b).abs().max()) / max(float(w_b.abs().max()), 1e-30))
        out["refine_gap"] = max(gaps)
        return out


Run = SplatTrain
FAULTS = ("unchanged", "refine_unchanged", "half_batch", "batch_altered", "map_altered")
