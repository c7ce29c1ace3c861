"""Driver `nerf_train`: the ray-marched trainer's loop, `NerfTrainer.train`,
the loop behind `ggt-torch-train --method <name>`, on the configuration's
capture.

Set-up builds the trainer from the configuration (`NerfConfig`,
`NerfTrainerConfig`), loads into its field weights the benchmark drew on
the device from the seed, and runs `warmup_steps` steps from step 0
through the loop. The window then runs the same loop until the deadline.
A gate in place of the module attribute `nerf_trainer.nerf_step` counts
steps and ends the loop (`StopWindow`).

The check (`Check`) replays the first three steps with the plain
reference: the same seed gives it the same pixel draws (numpy) and the
same renderer draws (a torch.Generator on the device), which it draws
itself and holds against the coordinates the program's steps were fed.
Of the first step it also holds render_rays' outputs, the proposal
levels' weights and the loss terms, which the warm-up takes from the
program's `nerf_trainer.render_rays` and `proposal.interlevel_loss`.
"""

from __future__ import annotations

import gc
import math
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from harness import common, inputs, work
from harness.common import StopWindow, cpu
from harness.compare import leaf_diffs, leaf_gaps, loss_gap, map_err, median_leaf_gap, term_gap, worst
from harness.gate import Gate
from harness.trace import Profile, Spans, warm_profiler

REF = "nerfacto"
COMPARED = 3
RENDER_KEYS = ("rgb", "depth", "accumulation")
TERMS = ("interlevel", "distortion")


def _ref():
    return common.reference(REF, "nerf")


def ref_config(cfg: dict):
    return common.reference(REF).config_from(cfg["model"])


def make_weights(cfg: dict, seed: int, device) -> Dict[str, "object"]:
    """The field's state, drawn by the benchmark on `device` from one
    torch.Generator, name by name: hash tables U(-1e-4, 1e-4), MLP weights
    and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)), appearance embeddings
    0.1 N(0, 1) (the fields' own init laws), the grids' resolutions as the
    reference computes them."""
    import torch

    ref = _ref()
    with torch.device(device):
        module = ref.NerfField(ref_config(cfg))
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "appearance":
                p.copy_(0.1 * torch.randn(p.shape, generator=g, device=device))
                continue
            if leaf == "table":
                bound = 1e-4
            else:
                owner = module.get_submodule(name.rsplit(".", 1)[0])
                bound = 1.0 / math.sqrt(getattr(owner, "w" + leaf[1:]).shape[0])
            p.copy_((torch.rand(p.shape, generator=g, device=device) * 2.0 - 1.0) * bound)
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def half_rays(args):
    """The fault "half of the batch left out, the mean taken over the
    rest": nerf_step on the first half of the rays."""
    a = list(args)
    n = a[3].shape[0] // 2
    for i in (3, 4, 5, 6):  # coords, target, target_depth, target_sem
        a[i] = a[i][:n]
    return a


def altered(args):
    """The fault "an answer altered where it is produced": one ray's pixel
    row, as the loop drew it, moved by one."""
    args = list(args)
    coords = args[3].clone()
    coords[0, 0] = (coords[0, 0] + 1) % args[2].height
    args[3] = coords
    return tuple(args)


def planted(step_fn, fault: Optional[str]):
    """nerf_step with the fault planted: "half_batch" (the first half of the
    rays alone) or "unchanged" (the field and Adam state put back after the
    step)."""
    def step(*args, **kw):
        if fault == "half_batch":
            return step_fn(*half_rays(args), **kw)
        field, opt = args[0], args[1]
        keep = {k: v.detach().clone() for k, v in field.state_dict().items()}
        keep_opt = dict(opt)
        out = step_fn(*args, **kw)
        field.load_state_dict(keep)
        opt.update(keep_opt)
        return out

    return step if fault in ("half_batch", "unchanged") else step_fn


class NerfTrain:
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
        self.captured: Dict[str, object] = {"coords": [], "views": [], "losses": []}
        self.profile: Optional[Profile] = None
        self.window_steps = 0
        self.window_s = 0.0
        self.failed = 0
        self._grab = False

    def setup(self) -> None:
        from gaussiangrasper_torch.data.dataparsers.zoo import resolve_parser
        from gaussiangrasper_torch.data.manager import FullImageDatamanager, SamplerConfig
        from gaussiangrasper_torch.engine import nerf_trainer as nt
        from gaussiangrasper_torch.models.nerf import NerfConfig

        c = self.conf
        self.data = inputs.tabletop(c["scene"])
        outputs = resolve_parser(self.data).parse()
        self.dm = FullImageDatamanager(outputs, SamplerConfig(), seed=self.seed, device=self.device)
        model = NerfConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                              for k, v in c["model"].items()})
        tcfg = nt.NerfTrainerConfig(data=self.data, output_dir=Path(tempfile.gettempdir()) / "portbench",
                                    experiment_name="nerf_train", max_iterations=10 ** 9,
                                    steps_per_save=10 ** 9, seed=self.seed, model=model,
                                    **c["trainer"])
        self.trainer = nt.NerfTrainer(tcfg, self.dm)
        self.trainer.setup()
        self.weights = make_weights(c, self.seed, self.device)
        self.trainer.field.load_state_dict(self.weights)
        self.weights = {k: cpu(v) for k, v in self.weights.items()}
        self.nt = nt
        self.real_step = nt.nerf_step
        self.gate = Gate(self.real_step, self.spans, "nerf_step")
        self.gate.body = planted(self.real_step, self.fault)
        if self.fault == "batch_altered":
            self.gate.feed = altered
        nt.nerf_step = self.gate
        if self.traced:
            warm_profiler()

    def close(self) -> None:
        self.nt.nerf_step = self.real_step

    @property
    def attempted(self) -> int:
        return self.window_steps

    def _grabbing(self, owner, name: str, keep):
        """Put a stand-in for `owner.name` that hands its arguments and
        output to `keep` while the first step runs; returns the original."""
        fn = getattr(owner, name)

        def wrapped(*a, **k):
            out = fn(*a, **k)
            if self._grab:
                keep(a, out)
            return out

        setattr(owner, name, wrapped)
        return fn

    def _keep_render(self, args, out) -> None:
        self.captured["render"] = {k: cpu(out[k]) for k in RENDER_KEYS}
        self.captured["terms"] = {k: float(out[k].detach().mean()) for k in TERMS}

    def _keep_proposal(self, args, out) -> None:
        self.captured["proposal_weights"] = [cpu(w) for _, w in args[0]]

    def _capture(self, done, args, out) -> None:
        if done > COMPARED:
            return
        field, opt, camera, coords = args[0], args[1], args[2], args[3]
        self.captured["coords"].append(cpu(coords))
        self.captured["views"].append(cpu(camera.camera_to_world))
        self.captured["losses"].append(cpu(out["loss"]))
        if done == 1:
            self.captured["mu1"] = {k: cpu(v) for k, v in opt["mu"].items()}
        if done == COMPARED:
            self.captured["p3"] = {k: cpu(v) for k, v in field.named_parameters()}

    def warmup(self) -> None:
        """The first `warmup_steps` steps through the window's own loop; the
        first three are captured for the check, and of the first one the
        render's outputs and the proposal weights."""
        from gaussiangrasper_torch.models import proposal

        real = [(self.nt, "render_rays", self._grabbing(self.nt, "render_rays", self._keep_render)),
                (proposal, "interlevel_loss",
                 self._grabbing(proposal, "interlevel_loss", self._keep_proposal))]
        self.gate.limit = self.traffic["warmup_steps"]
        self.gate.on_step = self._capture
        self.gate.before_step = lambda done, args: setattr(self, "_grab", done == 0)
        try:
            with common.program_stdout_to_stderr():
                self.trainer.train()
        except StopWindow:
            pass
        finally:
            for owner, name, fn in real:
                setattr(owner, name, fn)
        self._grab = False
        self.gate.limit = None
        self.gate.on_step = None
        self.gate.before_step = None
        self.trainer.start_step = self.traffic["warmup_steps"]

    def _trace_hook(self, done: int, args) -> None:
        t = self.traffic
        if self.profile is None and done == t["trace_after"]:
            self.profile = Profile()
            self.profile.start()
        elif self.profile is not None and not self.profile.stopped and \
                done == t["trace_after"] + t["trace_steps"]:
            self.profile.stop()

    def window(self, seconds: float) -> float:
        if self.traced:
            self.gate.before_step = self._trace_hook
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
            self.gate.deadline = None
            self.gate.before_step = None
            if self.profile is not None and not self.profile.stopped:
                self.profile.stop()
        self.window_steps = self.gate.done
        return t0

    def end_to_end(self, setup_s: float) -> Dict[str, dict]:
        rays = self.conf["trainer"]["rays_per_batch"]
        return {"train_rays_per_s": {"value": self.window_steps * rays / self.window_s,
                                     "unit": "rays/s"},
                "setup_s": {"value": setup_s, "unit": "s"}}

    def layer_context(self) -> dict:
        m = self.conf["model"]
        samples = list(m["num_proposal_samples"]) + [m["num_fine"]]
        levels = [m["proposal_hash_levels"]] * len(m["num_proposal_samples"]) + [m["hash_levels"]]
        prop_mlp = 2.0 * (m["proposal_hash_levels"] * 2 * 16 + 16 * 1)
        geo_in = m["hash_levels"] * m["hash_features"]
        colour_in = 15 + 15 + (m["appearance_embed_dim"] if m.get("num_appearance_embeds") else 0)
        main_mlp = 2.0 * (geo_in * 64 + 64 * 16) + 2.0 * (colour_in * 64 + 64 * 3) + 40.0
        mlps = [prop_mlp] * len(m["num_proposal_samples"]) + [main_mlp]
        tables = sum(v.numel() for k, v in self.weights.items() if k.endswith("table"))
        params = sum(v.numel() for k, v in self.weights.items() if not k.endswith("resolutions"))
        step = work.nerfacto_step_least(self.conf["trainer"]["rays_per_batch"], samples, levels,
                                        m["hash_features"], mlps, tables, params)
        return {"trace": self.profile.reduce() if self.profile else None,
                "step_s": self.window_s / max(self.window_steps, 1), "work": {"step": step}}

    def free_program(self) -> None:
        import torch

        self.close()
        self.trainer = None
        self.dm = None
        gc.collect()
        torch.cuda.empty_cache()


def view_arrays(data: Path, view: int) -> dict:
    """The view's image and depth from the capture's own files."""
    stem = f"r_{view:03d}"
    return {"image": (np.load(data / "bench_raw" / f"{stem}_rgb.npy") / 255.0).astype(np.float32),
            "depth": np.load(data / "depths" / f"{stem}.npy").astype(np.float32)}


class Check:
    def __init__(self, run: NerfTrain):
        self.run = run

    def reference_steps(self, tf32: bool, device: str) -> dict:
        """Three reference steps from the benchmark's weights, with the
        pixel and renderer draws of the seed."""
        import torch

        run = self.run
        ref = _ref()
        cfg = ref_config(run.conf)
        with torch.device(device):
            field = ref.NerfField(cfg)
        field.load_state_dict({k: v.to(device) for k, v in run.weights.items()})
        params = dict(field.named_parameters())
        opt = {"mu": {n: torch.zeros_like(p) for n, p in params.items()},
               "nu": {n: torch.zeros_like(p) for n, p in params.items()},
               "count": torch.zeros((), dtype=torch.int32, device=device)}
        poses, meta = inputs.capture_views(run.data)
        rng = np.random.default_rng(run.seed)
        gen = torch.Generator(device=device).manual_seed(run.seed)
        t = run.conf["trainer"]
        sampler = ref.PixelSampler(t["rays_per_batch"])
        n_app = max(cfg.num_appearance_embeds, 1)
        weights = {"coarse": t["coarse_rgb_lambda"], "depth": 0.0,
                   "interlevel": t["interlevel_lambda"], "distortion": t["distortion_lambda"]}
        out = {"losses": [], "coords": [], "views": []}
        with common.reference(REF).precision(tf32):
            for i in range(COMPARED):
                idx = int(rng.integers(0, len(poses)))
                h, w = int(meta["h"]), int(meta["w"])
                pix = sampler.sample(rng, h, w)
                coords = torch.as_tensor(pix, dtype=torch.int64).to(device)
                view = view_arrays(run.data, idx)
                ys, xs = coords[:, 0].cpu().numpy(), coords[:, 1].cpu().numpy()
                target = torch.as_tensor(view["image"][ys, xs], device=device)
                depth = torch.as_tensor(view["depth"][ys, xs], device=device)
                cam = ref.Camera.create(meta["fl_x"], meta["fl_y"], meta["cx"], meta["cy"],
                                        poses[idx][:3, :4], w, h, device=device)
                m = ref.nerf_step(field, opt, cam, coords, target, depth, gen, cfg, t["lr"], weights,
                                  app_idx=idx % n_app)
                out["losses"].append(float(m["loss"]))
                out["coords"].append(coords.cpu())
                out["views"].append(idx)
                if i == 0:
                    out["mu1"] = {k: v.clone() for k, v in opt["mu"].items()}
                    r = m["render"]
                    out["render"] = {k: r[k] for k in RENDER_KEYS}
                    out["terms"] = {k: float(r[k].mean()) for k in TERMS}
                    out["proposal_weights"] = r["proposal_weights"]
        out["p3"] = {k: v.detach().clone() for k, v in field.named_parameters()}
        return out

    def numbers(self, device: Optional[str] = None, control: bool = False) -> Dict[str, float]:
        """batch_errors; loss_gap (the reported rgb loss of three steps);
        the first step's term_gap (rgb mse, interlevel, distortion) and
        render_gap (render_rays' rgb, depth and accumulation and each
        proposal level's weights: the worst one's largest gap over its
        largest reference value); the first gradient's grad_gap (gaps of
        norms) and grad_diff (norms of differences); delta_gap_median. With
        `control`, the reference in TF32 stands in the program's place."""
        device = device or self.run.device
        import torch

        run = self.run
        ref_b1 = _ref().B1
        want = self.reference_steps(False, device)
        if control:
            got = self.reference_steps(True, device)
        else:
            got = {k: run.captured[k] for k in ("mu1", "p3", "coords", "render", "terms",
                                                "proposal_weights")}
            got["losses"] = [float(x) for x in run.captured["losses"]]
            poses, _ = inputs.capture_views(run.data)
            got["views"] = []
            for c2w in run.captured["views"]:
                errs = [float(np.abs(p[:3, :4] - c2w.double().numpy()).max()) for p in poses]
                got["views"].append(int(np.argmin(errs)) if min(errs) < 1e-6 else -1)
        bad = sum(int(a != b) for a, b in zip(got["views"], want["views"]))
        bad += sum(int((a.cpu() != b.cpu()).sum()) for a, b in zip(got["coords"], want["coords"]))
        out = {"batch_errors": float(bad), "loss_gap": loss_gap(got["losses"], want["losses"])}
        out["term_gap"] = term_gap(dict(got["terms"], mse=got["losses"][0]),
                                   dict(want["terms"], mse=want["losses"][0]))
        pairs = [(got["render"][k], want["render"][k]) for k in RENDER_KEYS]
        pairs += list(zip(got["proposal_weights"], want["proposal_weights"]))
        out["render_gap"] = max(map_err(a, b.to(device)) for a, b in pairs)
        to = lambda d: {k: v.to(device) for k, v in d.items()}  # noqa: E731
        g_want = {k: v / (1.0 - ref_b1) for k, v in to(want["mu1"]).items()}
        g_got = {k: v / (1.0 - ref_b1) for k, v in to(got["mu1"]).items()}
        gaps, diffs = leaf_gaps(g_got, g_want, g_want), leaf_diffs(g_got, g_want, g_want)
        out["grad_gap"], out["grad_diff"] = max(gaps.values()), max(diffs.values())
        print(f"check detail grad_gap: {worst(gaps)}; grad_diff: {worst(diffs)}", file=sys.stderr)
        p0 = to({k: v for k, v in run.weights.items() if k in want["p3"]})
        d_want = {k: v.to(device) - p0[k] for k, v in want["p3"].items()}
        d_got = {k: v.to(device) - p0[k] for k, v in got["p3"].items()}
        # the median leaf's gap: the worst leaf's swings with one small leaf's round-off
        # (a proposal MLP's 1- and 16-entry leaves; PERF.md)
        out["delta_gap_median"] = median_leaf_gap(d_got, d_want, g_want)
        return out


Run = NerfTrain
FAULTS = ("unchanged", "half_batch", "batch_altered")
