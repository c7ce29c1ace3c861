"""Driver `query_loop`: served text queries in a closed loop, one client
that waits for each reply (a robot or an operator).

Set-up draws the served field from the seed (`inputs.bench_field`) and a
seeded fea_up, writes a serving run with the program's
`checkpoint.save_run`, and loads it with `checkpoint.load_run`, as the
render and query CLIs do. Each request is one view, a camera on an orbit
arc drawn from the seed, and one query embedding from a seeded set,
against seeded canonical phrases; the program serves it through
`scripts/render.render_view` -> `render.lift` -> `query.relevancy_map`,
and the reply (the relevancy map and the argmax pixel with its depth and
normal) is copied to the host. A request is timed from when it is sent
until its reply is on the host.

The check renders a sample of the window's requests, drawn from the seed,
again with the plain reference and holds the program's maps, a seeded
sample of the lifted CLIP map's pixels, and the replies against it.

A traced run profiles a stretch of requests served exactly as the timed
ones are; the layers' own times between syncs (`render_ms`,
`lift_relevancy_ms`) come from the requests after that stretch, and the
request time `mfu` divides by from the requests before it.
"""

from __future__ import annotations

import gc
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from harness import common, inputs, walk, work
from harness.compare import map_err
from harness.trace import Profile, Spans, SyncTimer, warm_profiler

REF = "gaussiangrasper-efd"
FIELD_KEYS = ("means", "log_scales", "quats", "opacity_logits", "sh_coeffs", "features")
# channel groups of the rendered maps, alpha appended last
GROUPS = {"rgb": (0, 3), "feature": (3, 35), "depth": (35, 36), "normal": (36, 39),
          "alpha": (39, 40)}


def _ref(mod: str):
    return common.reference(REF, mod)


class Requests:
    """The request sequence of a seed: orbit angles, query indices, and
    the query and canonical embeddings."""

    def __init__(self, traffic: dict, seed: int):
        rng = np.random.default_rng(seed)
        n = traffic["max_requests"]
        lo, hi = traffic["arc"]
        self.angles = rng.uniform(lo, hi, n)
        self.which = rng.integers(0, traffic["queries"], n)
        self.queries = rng.standard_normal((traffic["queries"], traffic["clip_dim"])).astype(np.float32)
        self.canonical = rng.standard_normal((traffic["canonicals"], traffic["clip_dim"])).astype(np.float32)
        self.sampled = sorted(rng.choice(traffic["sample_from"], traffic["sampled"], replace=False).tolist())
        self.lift_pixels = rng.choice(traffic["width"] * traffic["height"], traffic["lift_pixels"],
                                      replace=False)


class QueryLoop:
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
        self.req = Requests(self.traffic, self.seed)
        self.latency: List[float] = []
        self.failed = 0
        self.kept: Dict[int, dict] = {}
        self.render_timer, self.lift_timer = SyncTimer(), SyncTimer()
        self.synced = False
        self.profile: Optional[Profile] = None
        self.traced_request = None

    def camera(self, i: int, camera_cls):
        t = self.traffic
        return camera_cls.create(t["focal"], t["focal"], t["width"] / 2, t["height"] / 2,
                                 inputs.orbit_c2w(float(self.req.angles[i])), t["width"],
                                 t["height"], device=self.device)

    def setup(self) -> None:
        import torch

        from gaussiangrasper_torch.engine import checkpoint
        from gaussiangrasper_torch.engine.weights import ServeState
        from gaussiangrasper_torch.models.efd import FeaUp
        from gaussiangrasper_torch.models.gaussian_field import GaussianParams
        from gaussiangrasper_torch.models.model import GaussianSplatConfig
        from gaussiangrasper_torch.ops.rasterize import RasterizeConfig

        t, m = self.traffic, self.conf["model"]
        self.field = inputs.bench_field(t["gaussians"], self.seed, self.device, m["feature_dim"])
        dims = (m["feature_dim"], m["fea_up_hidden"], m["clip_dim"])
        self.fea_arrays = inputs.seeded_fea_up_arrays(self.seed + 1, dims)
        cfg = GaussianSplatConfig(**{k: v for k, v in m.items() if k not in ("fea_up_hidden", "raster")},
                                  raster=RasterizeConfig(**m["raster"]))
        alive = torch.ones(t["gaussians"], dtype=torch.bool, device=self.device)
        run_dir = Path(tempfile.gettempdir()) / "portbench" / "query_run"
        checkpoint.save_run(run_dir, ServeState(GaussianParams(*(self.field[k] for k in FIELD_KEYS)), alive,
            FeaUp.from_numpy(self.fea_arrays), t["step"]), cfg, experiment_name="query_loop")
        self.cfg, self.state, _ = checkpoint.load_run(run_dir, self.device)
        self.field = {k: v.detach().to("cpu", copy=True) for k, v in self.field.items()}
        self.lift_rows = torch.as_tensor(self.req.lift_pixels, device=self.device)
        # warm the shapes every request uses
        for i in range(t["warmup_requests"]):
            self.serve(i % len(self.req.angles), keep=False)
        common.sync()
        self.latency.clear()
        if self.traced:
            warm_profiler()

    def serve(self, i: int, keep: bool) -> None:
        """One request, from its send to its reply on the host."""
        import torch

        from gaussiangrasper_torch.core.cameras import Camera
        from gaussiangrasper_torch.scripts import query, render

        def lift_relevancy(fea_up, feature, q, canon):
            lifted = render.lift(fea_up, feature)
            rows = lifted.reshape(-1, lifted.shape[-1])[self.lift_rows].clone() if keep else None
            return query.relevancy_map(lifted, q, canon), rows

        render_view = render.render_view
        if self.synced:
            render_view = self.render_timer.wrap(render_view)
            lift_relevancy = self.lift_timer.wrap(lift_relevancy)
        t0 = time.perf_counter()
        with self.spans.span("request"):
            cam = self.camera(i, Camera)
            q = torch.as_tensor(self.req.queries[self.req.which[i]], device=self.device)
            canon = torch.as_tensor(self.req.canonical, device=self.device)
            with self.spans.span("render"):
                outs = render_view(self.state, cam, self.cfg)
            with self.spans.span("lift_relevancy"):
                rel, lift_rows = lift_relevancy(self.state.fea_up, outs["feature"], q, canon)
            if self.fault == "answer":
                rel = torch.roll(rel, 1, 0)
            with self.spans.span("reply"):
                best = torch.argmax(rel)
                y, x = best // rel.shape[1], best % rel.shape[1]
                point = torch.cat([torch.stack([y, x]).float(), outs["depth"][y, x],
                                   outs["normal"][y, x]])
                reply = {"relevancy": rel.cpu(), "point": point.cpu()}
        self.latency.append(time.perf_counter() - t0)
        if not (torch.isfinite(reply["relevancy"]).all() and torch.isfinite(reply["point"]).all()):
            self.failed += 1
        if keep:
            maps = torch.cat([outs["rgb"], outs["feature"], outs["depth"], outs["normal"],
                              outs["alpha"][..., None]], -1).clone()
            self.kept[i] = {"maps": maps, "lift_rows": lift_rows, **reply}

    def window(self, seconds: float) -> float:
        t = self.traffic
        sampled = set(self.req.sampled)
        common.sync()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        i = 0
        with common.program_stdout_to_stderr():
            while time.perf_counter() < deadline and i < len(self.req.angles):
                if self.traced and i == t["trace_after"]:
                    self.request_s = float(np.mean(self.latency))
                    self.profile = Profile()
                    self.profile.start()
                    self.traced_request = i
                if self.profile is not None and not self.profile.stopped and \
                        i == t["trace_after"] + t["trace_requests"]:
                    self.profile.stop()
                    self.synced = True
                self.serve(i, keep=i in sampled)
                i += 1
        common.sync()
        self.window_s = time.perf_counter() - t0
        if self.profile is not None and not self.profile.stopped:
            self.profile.stop()
        self.synced = False
        self.served = i
        return t0

    @property
    def attempted(self) -> int:
        return self.served

    def end_to_end(self, setup_s: float) -> Dict[str, dict]:
        q = np.percentile(np.asarray(self.latency) * 1e3, [50, 95])
        return {"query_p50_ms": {"value": float(q[0]), "unit": "ms"},
                "query_p95_ms": {"value": float(q[1]), "unit": "ms"},
                "setup_s": {"value": setup_s, "unit": "s"}}

    def walk_work(self, i: int) -> dict:
        """K1's least time on request i's inputs, from the reference's walk."""
        import torch

        field = _ref("model").GaussianParams(*(self.field[k].to(self.device) for k in FIELD_KEYS))
        alive = torch.ones(field.means.shape[0], dtype=torch.bool, device=self.device)
        return walk.splat_walk(field, alive, self.camera(i, _ref("geometry").Camera),
                               self.traffic["step"], self.ref_cfg())[0]

    def layer_context(self) -> dict:
        m, t = self.conf["model"], self.traffic
        ctx = {"trace": self.profile.reduce() if self.profile else None,
               "render_s": list(self.render_timer.seconds),
               "lift_relevancy_s": list(self.lift_timer.seconds),
               "request_s": getattr(self, "request_s", 0.0)}
        if self.traced_request is not None:
            k1 = self.walk_work(self.traced_request)
            ctx["work"] = {"k1": k1, "request": work.query_least(
                t["gaussians"], (m["sh_degree"] + 1) ** 2, m["feature_dim"], m["clip_dim"],
                m["fea_up_hidden"], t["height"], t["width"], t["canonicals"], k1)}
        return ctx

    def ref_cfg(self):
        return common.reference(REF).config_from(self.conf["model"])

    def free_program(self) -> None:
        import torch

        self.state = None
        gc.collect()
        torch.cuda.empty_cache()


class Check:
    def __init__(self, run: QueryLoop):
        self.run = run

    def reference_request(self, i: int, tf32: bool) -> dict:
        import torch

        run = self.run
        ref_model, ref_geo, ref_query = _ref("model"), _ref("geometry"), _ref("query")
        dev = run.device
        field = ref_model.GaussianParams(*(run.field[k].to(dev) for k in FIELD_KEYS))
        alive = torch.ones(field.means.shape[0], dtype=torch.bool, device=dev)
        fea_up = inputs.fea_up_state(run.fea_arrays, dev)
        cam = run.camera(i, ref_geo.Camera)
        q = torch.as_tensor(run.req.queries[run.req.which[i]], device=dev)
        canon = torch.as_tensor(run.req.canonical, device=dev)
        with torch.no_grad(), common.reference(REF).precision(tf32):
            outs = ref_model.render(field, alive, cam, run.traffic["step"], run.ref_cfg())
            lifted = ref_query.lift(fea_up, outs["feature"])
            rel = ref_query.relevancy_map(lifted, q, canon)
        maps = torch.cat([outs["rgb"], outs["feature"], outs["depth"], outs["normal"],
                          outs["alpha"][..., None]], -1)
        rows = torch.as_tensor(run.req.lift_pixels, device=dev)
        return {"maps": maps, "relevancy": rel,
                "lift_rows": lifted.reshape(-1, lifted.shape[-1])[rows].clone()}

    def numbers(self, control: bool = False) -> Dict[str, float]:
        """render_err: the worst channel group's largest gap over its
        largest reference value, with depth and normal at the returned
        point against the reference's maps there; lift_err: the largest gap
        of the lifted CLIP map at the seeded pixels over its largest
        reference value there; relevancy_err: the largest gap of the
        relevancy maps; point_gap: how far the returned point's reference
        relevancy lies below the reference's best. With `control`, the
        reference in TF32 stands in the program's place."""
        import torch

        run = self.run
        out = {"render_err": 0.0, "lift_err": 0.0, "relevancy_err": 0.0, "point_gap": 0.0,
               "missing": 0.0}
        for i in run.req.sampled:
            if i not in run.kept:
                out["missing"] += 1
                continue
            want = self.reference_request(i, False)
            if control:
                got = self.reference_request(i, True)
                rel = got["relevancy"]
                best = int(torch.argmax(rel))
                y, x = best // rel.shape[1], best % rel.shape[1]
                got = {"maps": got["maps"], "relevancy": rel.cpu(), "lift_rows": got["lift_rows"],
                       "point": torch.tensor([y, x, *got["maps"][y, x, 35:39].tolist()])}
            else:
                got = run.kept[i]
            wmaps = want["maps"]
            out["render_err"] = max(out["render_err"], map_err(got["maps"], wmaps, GROUPS))
            out["lift_err"] = max(out["lift_err"], map_err(got["lift_rows"], want["lift_rows"]))
            wrel = want["relevancy"].cpu()
            out["relevancy_err"] = max(out["relevancy_err"], float((got["relevancy"] - wrel).abs().max()))
            y, x = int(got["point"][0]), int(got["point"][1])
            out["point_gap"] = max(out["point_gap"], float(wrel.max() - wrel[y, x]))
            at = wmaps[y, x, 35:39].cpu()
            scale = max(float(wmaps[..., 35:39].abs().max()), 1e-30)
            out["render_err"] = max(out["render_err"],
                                    float((got["point"][2:6] - at).abs().max()) / scale)
        return out


Run = QueryLoop
FAULTS = ("answer",)
