"""Driver `grasp_loop`: open-vocabulary grasp requests in a closed loop, one
client that sends a query embedding and waits for the grasp pose (a robot
told "grasp the mug").

Set-up draws the served field of `query_loop` from the seed
(`inputs.bench_field`, 200k Gaussians, and a seeded fea_up) and gives it
`objects` seeded objects: each the `object_size` Gaussians nearest a
seeded centre among those no earlier object took, sharing one latent
drawn as the field's features are, U(-1, 1), with seeded normal noise.
Each query embedding is its object's lift with seeded noise. The
canonical phrases are generic, as CLIP's "object" or "stuff" are: the mean
direction of the field's lifted features plus a seeded random direction
of `canonical_spread` times its length. Set-up checks that each query
selects at least `min_object_share` of its object and at most
`max_other_share` of the other Gaussians, writes a serving run with the
program's `checkpoint.save_run` and loads it with `checkpoint.load_run`.
Each request sends one query, drawn from the seed, against the
canonicals; the program serves it through `scripts/grasp.grasp_request`
(relevancy, threshold, largest 26-connected cluster, pose) and the reply is
the grasp dict on the host. A request is timed from when it is sent until
its reply is on the host. The check samples `sampled` of the first
`sample_from` requests; those the window did not reach are served after
it, on the same state, and not timed.

The check runs the plain reference (`reference/gaussiangrasper-efd/
grasp.py`) on the sampled requests and holds the program's relevancy, its
selection, its cluster and its pose to it.
"""

from __future__ import annotations

import gc
import math
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from harness import common, inputs
from harness.trace import Profile, warm_profiler

REF = "gaussiangrasper-efd"
FIELD_KEYS = ("means", "log_scales", "quats", "opacity_logits", "sh_coeffs", "features")


def _ref(mod: str):
    return common.reference(REF, mod)


def _unit(x):
    import torch

    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def give_objects(field: dict, fea_up: dict, t: dict, seed: int):
    """Gives `field` (on its device, changed in place) its objects; returns
    (the objects' Gaussian indices, the query embeddings, the canonicals)."""
    import torch

    dev = field["means"].device
    fdim = field["features"].shape[1]
    rng = np.random.default_rng(seed)
    lift = _ref("grasp").lift

    def normal(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)

    with torch.no_grad():
        mean = _unit(_unit(lift(fea_up, field["features"])).mean(0))
        canonical = mean + t["canonical_spread"] * _unit(normal(t["canonicals"], mean.shape[0]))
        lo, hi = np.asarray(t["centre_box"], np.float64)
        taken = torch.zeros(field["means"].shape[0], dtype=torch.bool, device=dev)
        members, queries = [], []
        for _ in range(t["objects"]):
            latent = torch.as_tensor(rng.uniform(-1.0, 1.0, fdim), dtype=torch.float32, device=dev)
            c = torch.as_tensor(rng.uniform(lo, hi), dtype=torch.float32, device=dev)
            d = ((field["means"] - c) ** 2).sum(-1).masked_fill(taken, math.inf)
            idx = torch.topk(d, t["object_size"], largest=False).indices
            taken[idx] = True
            field["features"][idx] = latent + t["latent_noise"] * normal(t["object_size"], fdim)
            q = lift(fea_up, latent[None])[0]
            queries.append(q + t["query_noise"] * torch.linalg.vector_norm(q) / math.sqrt(q.shape[0])
                           * normal(q.shape[0]))
            members.append(idx)
    return members, torch.stack(queries), canonical


class GraspLoop:
    def __init__(self, cell: dict, seed: int, traced: bool = False, fault: Optional[str] = None,
                 device: str = "cuda"):
        self.cell = cell
        self.conf = cell["config_data"]
        self.traffic = cell["traffic_data"]
        self.seed = int(seed)
        self.device = device
        self.traced = traced
        self.fault = fault
        t = self.traffic
        rng = np.random.default_rng(self.seed)
        self.which = rng.integers(0, t["objects"], t["max_requests"])
        self.sampled = sorted(rng.choice(t["sample_from"], t["sampled"], replace=False).tolist())
        self.threshold = 0.5 if fault == "threshold_05" else t["threshold"]
        self.latency: List[float] = []
        self.failed = 0
        self.kept: Dict[int, dict] = {}
        self.capture: Optional[dict] = None
        self.patched: Dict[str, object] = {}
        self.profile: Optional[Profile] = None
        self.served = 0

    def setup(self) -> None:
        import torch

        from gaussiangrasper_torch.engine import checkpoint
        from gaussiangrasper_torch.engine.weights import ServeState
        from gaussiangrasper_torch.models.efd import FeaUp
        from gaussiangrasper_torch.models.gaussian_field import GaussianParams
        from gaussiangrasper_torch.models.model import GaussianSplatConfig
        from gaussiangrasper_torch.ops.rasterize import RasterizeConfig
        from gaussiangrasper_torch.scripts import grasp

        if not hasattr(grasp, "grasp_request"):  # an older program: fail before drawing the field
            raise SystemExit("portbench: the program has no scripts/grasp.grasp_request; no result")
        t, m = self.traffic, self.conf["model"]
        field = inputs.bench_field(t["gaussians"], self.seed, self.device, m["feature_dim"])
        self.fea_arrays = inputs.seeded_fea_up_arrays(self.seed + 1, (m["feature_dim"], m["fea_up_hidden"],
                                                                      m["clip_dim"]))
        fea_up = inputs.fea_up_state(self.fea_arrays, self.device)
        self.members, self.queries, self.canonical = give_objects(field, fea_up, t, self.seed + 2)
        self.check_objects(field, fea_up)
        cfg = GaussianSplatConfig(**{k: v for k, v in m.items() if k not in ("fea_up_hidden", "raster")},
                                  raster=RasterizeConfig(**m["raster"]))
        alive = torch.ones(t["gaussians"], dtype=torch.bool, device=self.device)
        run_dir = Path(tempfile.gettempdir()) / "portbench" / "grasp_run"
        checkpoint.save_run(run_dir, ServeState(GaussianParams(*(field[k] for k in FIELD_KEYS)), alive,
                                                FeaUp.from_numpy(self.fea_arrays), t["step"]),
                            cfg, experiment_name="grasp_loop")
        _, self.state, _ = checkpoint.load_run(run_dir, self.device)
        self.field = {k: v.detach().to("cpu", copy=True) for k, v in field.items()}
        self.plant(grasp)
        for i in range(t["warmup_requests"]):
            self.serve(i, keep=False)
        common.sync()
        self.latency.clear()
        if self.traced:
            warm_profiler()

    def check_objects(self, field: dict, fea_up: dict) -> None:
        """Each query selects at least `min_object_share` of its object and
        at most `max_other_share` of the other Gaussians (the reference's
        relevancy), or the set-up fails."""
        import torch

        t = self.traffic
        n = field["means"].shape[0]
        for k, idx in enumerate(self.members):
            rel = _ref("grasp").relevancy(fea_up, field["features"], self.queries[k], self.canonical)
            own = torch.zeros(n, dtype=torch.bool, device=rel.device)
            own[idx] = True
            sel = rel > t["threshold"]
            got, other = float(sel[own].float().mean()), float(sel[~own].float().mean())
            if got < t["min_object_share"] or other > t["max_other_share"]:
                raise RuntimeError(f"object {k}: the query selects {got:.4f} of it and {other:.4f} "
                                   f"of the rest (wanted >= {t['min_object_share']}, "
                                   f"<= {t['max_other_share']})")

    def plant(self, grasp) -> None:
        """Keeps the program's relevancy of the sampled requests, and plants
        the fault, by the module attributes `grasp_request` looks up."""
        run = self
        relevancy, cluster, propose = (grasp.gaussian_relevancy, grasp.largest_cluster,
                                       grasp.propose_grasp)
        self.patched = {"gaussian_relevancy": relevancy, "largest_cluster": cluster,
                        "propose_grasp": propose}
        self.grasp = grasp

        def kept_relevancy(*a, **k):
            rel = relevancy(*a, **k)
            if run.capture is not None:
                run.capture["relevancy"] = rel.detach().clone()
            return rel

        grasp.gaussian_relevancy = kept_relevancy
        if self.fault == "six_connected":
            def six_connected(points, voxel=0.02):
                from scipy import ndimage

                idx = np.floor(points / voxel).astype(np.int64)
                idx -= idx.min(0)
                grid = np.zeros(idx.max(0) + 1, bool)
                grid[tuple(idx.T)] = True
                labels, _ = ndimage.label(grid)
                of = labels[tuple(idx.T)]
                return of == np.bincount(of).argmax()

            grasp.largest_cluster = six_connected
        elif self.fault == "approach_kept":
            def not_negated(*a, **k):
                out = propose(*a, **k)
                out["approach"] = [-v for v in out["approach"]]
                return out

            grasp.propose_grasp = not_negated

    def serve(self, i: int, keep: bool, timed: bool = True) -> None:
        """One request, from its send to the grasp dict on the host."""
        import torch

        q = torch.as_tensor(self.queries[self.which[i]], device=self.device)
        canon = torch.as_tensor(self.canonical, device=self.device)
        self.capture = {} if keep else None
        t0 = time.perf_counter()
        reply = self.grasp.grasp_request(self.state, q, canon, self.threshold, self.traffic["voxel"])
        if timed:
            self.latency.append(time.perf_counter() - t0)
        pose = np.concatenate([reply["position"], reply["approach"], reply["axis"], [reply["width"]]])
        if not np.isfinite(pose).all():
            self.failed += 1
        if keep:
            self.kept[i] = {"reply": reply, "relevancy": self.capture["relevancy"].cpu()}
        self.capture = None

    def window(self, seconds: float) -> float:
        t = self.traffic
        sampled = set(self.sampled)
        common.sync()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        i = 0
        with common.program_stdout_to_stderr():
            while time.perf_counter() < deadline and i < t["max_requests"]:
                if self.traced and i == t["trace_after"]:
                    self.profile = Profile()
                    self.profile.start()
                if self.profile is not None and not self.profile.stopped and \
                        i == t["trace_after"] + t["trace_requests"]:
                    self.profile.stop()
                self.serve(i, keep=i in sampled)
                i += 1
        common.sync()
        if self.profile is not None and not self.profile.stopped:
            self.profile.stop()
        self.served = i
        with common.program_stdout_to_stderr():
            for j in self.sampled:
                if j >= i:
                    self.serve(j, keep=True, timed=False)
        return t0

    @property
    def attempted(self) -> int:
        return self.served

    def end_to_end(self, setup_s: float) -> Dict[str, dict]:
        q = np.percentile(np.asarray(self.latency) * 1e3, [50, 95])
        return {"query_p50_ms": {"value": float(q[0]), "unit": "ms"},
                "query_p95_ms": {"value": float(q[1]), "unit": "ms"},
                "setup_s": {"value": setup_s, "unit": "s"}}

    def layer_context(self) -> dict:
        return {"trace": self.profile.reduce() if self.profile else None}

    def free_program(self) -> None:
        import torch

        for name, fn in self.patched.items():
            setattr(self.grasp, name, fn)
        self.patched = {}
        self.state = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


class Check:
    def __init__(self, run: GraspLoop):
        self.run = run

    def reference_request(self, i: int, tf32: bool) -> dict:
        import torch

        run = self.run
        dev = run.device
        field = _ref("model").GaussianParams(*(run.field[k].to(dev) for k in FIELD_KEYS))
        alive = torch.ones(field.means.shape[0], dtype=torch.bool, device=dev)
        fea_up = inputs.fea_up_state(run.fea_arrays, dev)
        q = torch.as_tensor(run.queries[run.which[i]], device=dev)
        with common.reference(REF).precision(tf32):
            return _ref("grasp").request(field, alive, fea_up, q, run.canonical.to(dev),
                                         run.traffic["threshold"], run.traffic["voxel"])

    def numbers(self, control: bool = False) -> Dict[str, float]:
        """relevancy_err: the largest gap of the per-Gaussian relevancy;
        selected_mismatch, cluster_mismatch: Gaussians in one side's
        selection (above the threshold) or cluster and not in the other's;
        grasp_gap: the largest gap of the position, the approach, the
        closing axis (a line: its sign left out) and the width. With
        `control`, the reference in TF32 stands in the program's place."""
        run = self.run
        out = {"missing": 0.0, "relevancy_err": 0.0, "selected_mismatch": 0.0,
               "cluster_mismatch": 0.0, "grasp_gap": 0.0}
        for i in run.sampled:
            if i not in run.kept:
                out["missing"] += 1
                continue
            want = self.reference_request(i, False)
            if control:
                got = self.reference_request(i, True)
                rel = got["relevancy"]
            else:
                got = run.kept[i]["reply"]
                rel = run.kept[i]["relevancy"].numpy()
            out["relevancy_err"] = max(out["relevancy_err"],
                                       float(np.abs(rel - want["relevancy"]).max()))
            for key, name in (("selected", "selected_mismatch"), ("cluster", "cluster_mismatch")):
                diff = np.setxor1d(np.asarray(got[key]), np.asarray(want[key]))
                out[name] = max(out[name], float(len(diff)))
            gaps = [np.abs(np.subtract(got[k], want[k])).max() for k in ("position", "approach")]
            axis_g, axis_w = np.asarray(got["axis"]), np.asarray(want["axis"])
            gaps.append(min(np.abs(axis_g - axis_w).max(), np.abs(axis_g + axis_w).max()))
            gaps.append(abs(got["width"] - want["width"]))
            out["grasp_gap"] = max(out["grasp_gap"], float(max(gaps)))
        return out


Run = GraspLoop
FAULTS = ("six_connected", "approach_kept", "threshold_05")
