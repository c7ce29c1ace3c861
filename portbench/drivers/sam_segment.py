"""Driver `sam_segment`: SAM's automatic masks in a closed loop, one client
that sends a view and waits for its instance-id map (a capture being
segmented before EFD training, or again after a re-scan).

Set-up reads the tabletop capture's views (`inputs.tabletop`, each view's
RGB bytes as the capture wrote them), draws the weights from the seed as
`sam.random_weights` draws them, and loads them through `sam.load_state`
into a model built on the meta device, the calls `sam.load` makes on a
snapshot. Each request is one view, the views taken in turn; the program
serves it through `scripts/segment.sam_instance_masks` (64 point prompts,
`min_area` from the traffic) and the reply is the int32 id map on the
host. A request is timed from when it is sent until its map is on the
host.

For the check, the sampled requests keep what the program computed on the
way: the processor's pixel values and points, the image embedding, the
low-res logits and the IoU scores (forward hooks, on those requests only).
The check runs the plain reference (`reference/sam-vit-huge/`) on the
same pixel values and points with the same weights and holds the program
to it: the embedding, the logits and the scores, each as a share of its
scale, and the id map pixel for pixel, but pixels whose deciding reference
logit lies within `id_margin` (a share of the logits' scale) of 0, and
with the masks taken in the program's order where that order
differs from the reference's only between scores within `iou_err`.

A traced run profiles `trace_requests` requests after `trace_after`; the
request time `mfu` divides by is the mean of the requests before them.
"""

from __future__ import annotations

import gc
import sys
import time
import types
from typing import Dict, List, Optional

import numpy as np

from harness import common, inputs, sam_work
from harness.trace import Profile, warm_profiler

REF = "sam-vit-huge"


def _ref():
    return common.reference(REF, "sam")


def grid_points(h: int, w: int) -> int:
    """The number of prompts `sam_instance_masks` makes on an h x w view."""
    return len(range(0, h, max(h // 8, 1))) * len(range(0, w, max(w // 8, 1)))


def _pad_top_left(layer, x):
    """A windowed block whose windows pad at the top and left: the
    planted fault `pad_top_left` (the program pads at the bottom and right)."""
    import torch.nn.functional as F

    ws = layer.window_size
    y = layer.layer_norm1(x)
    b, h, w, ch = y.shape
    ph, pw = -h % ws, -w % ws
    y = F.pad(y, (0, 0, pw, 0, ph, 0))
    hp, wp = h + ph, w + pw
    y = y.reshape(b, hp // ws, ws, wp // ws, ws, ch).permute(0, 1, 3, 2, 4, 5)
    y = layer.attn(y.contiguous().reshape(-1, ws, ws, ch))
    y = y.reshape(b, hp // ws, wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    y = y.contiguous().reshape(b, hp, wp, -1)[:, ph:, pw:, :]
    x = x + y
    return x + layer.mlp(layer.layer_norm2(x))


def plant(model, fault: Optional[str]):
    """The model the requests go through, with `fault` planted."""
    import torch

    layers = model.vision_encoder.layers
    vc = model.config.vision
    if fault == "windowed_global":
        layers[vc.global_attn_indexes[0]].window_size = vc.window_size
    elif fault == "no_rel_pos":
        for layer in layers:
            layer.attn.use_rel_pos = False
    elif fault == "pad_top_left":
        for layer in layers:
            if layer.window_size > 0:
                layer.forward = types.MethodType(_pad_top_left, layer)
    elif fault == "order_reversed":
        class Reversed(torch.nn.Module):
            """The scores negated on their way to the ordering: the masks
            taken in descending order of their first IoU score."""

            def __init__(self, inner):
                super().__init__()
                self.inner = inner

            def forward(self, *args):
                masks, iou = self.inner(*args)
                return masks, -iou

        return Reversed(model)
    return model


class SamSegment:
    def __init__(self, cell: dict, seed: int, traced: bool = False, fault: Optional[str] = None,
                 device: str = "cuda"):
        self.cell = cell
        self.conf = cell["config_data"]
        self.traffic = cell["traffic_data"]
        self.seed = int(seed)
        self.device = device
        self.traced = traced
        self.fault = fault
        rng = np.random.default_rng(self.seed)
        t = self.traffic
        self.sampled = sorted(rng.choice(t["sample_from"], t["sampled"], replace=False).tolist())
        self.latency: List[float] = []
        self.failed = 0
        self.kept: Dict[int, dict] = {}
        self.capture: Optional[dict] = None
        self.profile: Optional[Profile] = None
        self.served = 0

    def setup(self) -> None:
        import torch

        from gaussiangrasper_torch.models import sam
        from gaussiangrasper_torch.utils.sam_processor import SamProcessor

        t = self.traffic
        data = inputs.tabletop(t["scene"])
        self.views = [np.load(data / "bench_raw" / f"r_{v:03d}_rgb.npy")
                      for v in range(t["scene"]["n_views"])]
        hf = self.conf["hf_config"]
        cfg = sam.SamConfig.from_dict(hf)
        self.weights = sam.random_weights(cfg, seed=self.seed)
        with torch.device("meta"):
            model = sam.SamModel(cfg)
        sam.load_state(model, dict(self.weights))
        self.model = model.to(self.device).eval()
        size = cfg.vision.image_size
        self.proc = SamProcessor(longest_edge=size, pad_size=(size, size))
        self.served_model = plant(self.model, self.fault)
        self.model.register_forward_pre_hook(self._keep_inputs)
        self.model.register_forward_hook(self._keep_outputs)
        self.model.vision_encoder.register_forward_hook(self._keep_embedding)
        for i in range(t["warmup_requests"]):
            self.serve(i, keep=False)
        common.sync()
        self.latency.clear()
        if self.traced:
            warm_profiler()

    # the sampled requests' intermediate results, on the device until the reply is out
    def _keep_inputs(self, _mod, args):
        if self.capture is not None:
            self.capture["pixel_values"] = args[0].clone()
            self.capture["points"] = args[1][0, :, 0].clone()

    def _keep_outputs(self, _mod, _args, out):
        if self.capture is not None:
            self.capture["logits"] = out[0][0].clone()
            self.capture["iou"] = out[1][0].clone()

    def _keep_embedding(self, _mod, _args, out):
        if self.capture is not None:
            self.capture["embedding"] = out.clone()

    def serve(self, i: int, keep: bool) -> None:
        """One request, from its send to its id map on the host."""
        from gaussiangrasper_torch.scripts import segment

        view = self.views[i % len(self.views)]
        self.capture = {} if keep else None
        t0 = time.perf_counter()
        ids = segment.sam_instance_masks(view, "", self.traffic["min_area"], self.served_model,
                                         self.proc, self.device)
        self.latency.append(time.perf_counter() - t0)
        if ids.shape != view.shape[:2] or ids.dtype != np.int32:
            self.failed += 1
        if keep:
            self.kept[i] = {k: common.cpu(v) for k, v in self.capture.items()}
            self.kept[i]["ids"] = ids
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
                    self.request_s = float(np.mean(self.latency))
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
        h, w = self.views[0].shape[:2]
        return {"trace": self.profile.reduce() if self.profile else None,
                "request_s": getattr(self, "request_s", 0.0),
                "work": sam_work.request_least(self.conf["hf_config"], grid_points(h, w), (h, w))}

    def free_program(self) -> None:
        import torch

        self.model = self.served_model = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


class Check:
    def __init__(self, run: SamSegment):
        self.run = run
        self._weights = None

    def weights(self):
        if self._weights is None:
            self._weights = {k: v.to(self.run.device) for k, v in self.run.weights.items()}
        return self._weights

    def reference_request(self, kept: dict, tf32: bool) -> dict:
        import torch

        run = self.run
        dev = run.device
        hf = run.conf["hf_config"]
        size = hf["vision_config"]["image_size"]
        h, w = kept["ids"].shape
        scale = size / max(h, w)
        resized = (int(h * scale + 0.5), int(w * scale + 0.5))
        with torch.no_grad(), common.reference(REF).precision(tf32):
            out = _ref().forward(self.weights(), hf, kept["pixel_values"].to(dev),
                                 kept["points"].to(dev))
            out["view_logits"] = _ref().upscale(out["logits"][:, 0], (size, size), resized, (h, w))
        return out

    @staticmethod
    def order(got_iou, want_iou, tol: float):
        """The program's order of the masks (ascending first score) where
        it inverts the reference's only between scores within `tol`, else
        the reference's own."""
        import torch

        g, r = got_iou[:, 0].double(), want_iou[:, 0].double().to(got_iou.device)
        mine = torch.argsort(g)
        rank = torch.empty_like(mine)
        rank[mine] = torch.arange(len(mine), device=mine.device)
        inverted = (rank[:, None] < rank[None, :]) & (r[:, None] > r[None, :] + tol)
        return mine if not bool(inverted.any()) else torch.argsort(r)

    @staticmethod
    def near_deciding(view_logits, order, min_area: int, margin: float, differ):
        """Pixels whose id a logit within `margin` x the logits' scale of 0
        could decide: the logit of the mask that decides the pixel's id in
        the reference's map, or of a kept mask after it in `order` (one
        that a sign's flip would make the decider); for a pixel left as
        background, of every kept mask. Also the least such margin that
        would leave out every pixel of `differ` (0 if none differ)."""
        import torch

        scale = float(view_logits.abs().max())
        kept = [int(k) for k in order.tolist() if int((view_logits[k] > 0).sum()) >= min_area]
        closest = torch.full(view_logits.shape[1:], float("inf"), device=view_logits.device)
        open_ = torch.ones(view_logits.shape[1:], dtype=torch.bool, device=view_logits.device)
        for k in reversed(kept):  # the last kept mask with a positive logit decides
            lk = view_logits[k]
            closest = torch.where(open_, torch.minimum(closest, lk.abs()), closest)
            open_ &= ~(lk > 0)
        closest = closest.cpu() / max(scale, 1e-30)
        need = float(closest[differ].max()) if bool(differ.any()) else 0.0
        return closest < margin, need

    def numbers(self, control: bool = False) -> Dict[str, float]:
        """embed_err, logit_err, iou_err: the largest gap of the image
        embedding, the low-res logits (every prompt's three masks) and the
        IoU scores over the reference's largest value; id_mismatch: pixels
        of the reply that differ from the reference's id map, leaving out
        those whose deciding reference logit on the view lies within
        `id_margin` x the logits' scale of 0 (`near_deciding`). With
        `control`, the reference in TF32 stands in the program's place."""
        import torch

        run = self.run
        ref = _ref()
        lim = run.cell["limits"]
        out = {"missing": 0.0, "embed_err": 0.0, "logit_err": 0.0, "iou_err": 0.0,
               "id_mismatch": 0.0}
        for i in run.sampled:
            if i not in run.kept:
                out["missing"] += 1
                continue
            kept = run.kept[i]
            want = self.reference_request(kept, False)
            if control:
                got = self.reference_request(kept, True)
                got = {"embedding": got["embedding"], "logits": got["logits"], "iou": got["iou"],
                       "view_logits": got["view_logits"]}
            else:
                got = {k: kept[k].to(run.device) for k in ("embedding", "logits", "iou")}
            for key, name in (("embedding", "embed_err"), ("logits", "logit_err"), ("iou", "iou_err")):
                scale = max(float(want[key].abs().max()), 1e-30)
                gap = float((got[key] - want[key]).abs().max()) / scale
                out[name] = max(out[name], gap)
            tol = lim["iou_err"] * float(want["iou"].abs().max())
            order = self.order(got["iou"], want["iou"], tol)
            ref_map = ref.instance_map(want["view_logits"], order, run.traffic["min_area"])
            if control:
                ids = ref.instance_map(got["view_logits"], torch.argsort(got["iou"][:, 0]),
                                       run.traffic["min_area"]).cpu()
            else:
                ids = torch.from_numpy(kept["ids"])
            differ = ids != ref_map.cpu()
            near, need = self.near_deciding(want["view_logits"], order, run.traffic["min_area"],
                                            run.traffic["id_margin"], differ)
            out["id_mismatch"] = max(out["id_mismatch"], float((differ & ~near).sum()))
            print(f"portbench check request {i}: {int(near.sum())} pixels with a deciding logit "
                  f"within the margin left out, {int((differ & near).sum())} of them differ; the "
                  f"least margin that leaves out every differing pixel: {need!r}", file=sys.stderr)
        return out


Run = SamSegment
FAULTS = ("windowed_global", "no_rel_pos", "pad_top_left", "order_reversed")
