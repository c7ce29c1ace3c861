"""The measures that decide `correct`, shared by the drivers."""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional


def _norm(x) -> float:
    import torch

    return float(torch.linalg.vector_norm(x.double()))


def _kept(want, ref_grads) -> List[str]:
    """The leaves compared: with `ref_grads`, those whose reference gradient
    norm is at least a thousandth of the median leaf's (the others move by
    round-off alone)."""
    keys = list(want)
    if ref_grads is None:
        return keys
    gn = {k: _norm(ref_grads[k]) for k in ref_grads}
    med = statistics.median(gn.values())
    return [k for k in keys if k not in gn or gn[k] >= 1e-3 * med]


def leaf_gaps(got, want, ref_grads=None) -> Dict[str, float]:
    """Each kept leaf's gap between the two sides' norms, over the larger
    of the reference's norm of that leaf and of its median leaf."""
    keys = _kept(want, ref_grads)
    w = {k: _norm(want[k]) for k in keys}
    med = statistics.median(w.values())
    return {k: abs(_norm(got[k]) - w[k]) / max(w[k], med, 1e-30) for k in keys}


def leaf_diffs(got, want, ref_grads=None) -> Dict[str, float]:
    """Each kept leaf's norm of the difference of the two sides, over the
    same scale as `leaf_gaps`: where a gap of norms sees a gradient's size,
    this sees its direction too."""
    keys = _kept(want, ref_grads)
    w = {k: _norm(want[k]) for k in keys}
    med = statistics.median(w.values())
    return {k: _norm(got[k].to(want[k].device) - want[k]) / max(w[k], med, 1e-30) for k in keys}


def median_leaf_gap(got, want, ref_grads=None) -> float:
    """`leaf_gaps`' median leaf instead of its worst: steady from seed to
    seed where one small leaf's gap swings with round-off (PERF.md,
    nerfacto's delta_gap)."""
    return statistics.median(leaf_gaps(got, want, ref_grads).values())


def worst(gaps: Dict[str, float], n: int = 3) -> str:
    """The `n` largest of the leaves' gaps, for the run's stderr."""
    top = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
    return ", ".join(f"{k} {v:.3g}" for k, v in top)


def loss_gap(got, want) -> float:
    """The worst step's |loss - reference loss| over |reference loss|."""
    return max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got, want))


def term_gap(got: Dict[str, float], want: Dict[str, float]) -> float:
    """The worst named scalar's |got - want| over |want|; a term that is 0
    on both sides reads 0."""
    return max((abs(got[k] - w) / abs(w) if w != 0 else (0.0 if got[k] == 0 else float("inf")))
               for k, w in want.items())


def map_err(got, want, groups: Optional[Dict[str, tuple]] = None) -> float:
    """The worst channel group's largest gap between two maps (..., C) over
    the group's largest reference value; maps of different shapes read
    inf. `groups` None: the whole last axis as one group."""
    if tuple(got.shape) != tuple(want.shape):
        return float("inf")
    out = 0.0
    got = got.to(want.device)
    groups = groups or {"all": (0, want.shape[-1])}
    for lo, hi in groups.values():
        scale = max(float(want[..., lo:hi].abs().max()), 1e-30)
        out = max(out, float((got[..., lo:hi] - want[..., lo:hi]).abs().max()) / scale)
    return out
