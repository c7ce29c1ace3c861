"""Named dataparsers and layout auto-detection (the JAX package's
data/dataparsers/zoo.py `resolve_parser`, for the two parsers the port has).

`colmap` and `phototourism` read a COLMAP reconstruction, `nerfstudio` and
`dnerf` a transforms.json (dnerf's per-frame `time` lands in
metadata["times"]). The JAX package's other named parsers, and the
auto-detection branches that would pick them, raise NotImplementedError:
they are still to be ported (ROADMAP.md, Queue 1 item 1, left out of the
data-layer slice).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict

from gaussiangrasper_torch.data.dataparsers.colmap import ColmapDataParser
from gaussiangrasper_torch.data.dataparsers.transforms_json import TransformsJsonParser

PARSERS: Dict[str, Callable] = {
    "colmap": ColmapDataParser,
    "nerfstudio": TransformsJsonParser,
    "dnerf": TransformsJsonParser,
    "phototourism": ColmapDataParser,
}

NOT_PORTED = ("blender", "instant-ngp", "minimal", "scannet", "sdfstudio", "arkitscenes",
              "nuscenes", "dycheck", "sitcoms3d", "nerfosr", "phototourism-raw")
"""The JAX package's other named parsers."""


def _not_ported(name: str):
    raise NotImplementedError(
        f"dataparser {name!r} is not ported to gaussiangrasper_torch yet (ROADMAP.md, Queue 1 "
        f"item 1: the other dataparsers); the port reads {sorted(PARSERS)}")


def resolve_parser(data: Path, name: str = "auto"):
    """Instantiate a parser by name, or auto-detect it from the on-disk
    layout as the JAX package does."""
    data = Path(data)
    if name != "auto":
        if name in NOT_PORTED:
            _not_ported(name)
        if name not in PARSERS:
            raise KeyError(f"unknown dataparser {name!r}; have "
                           f"{sorted(list(PARSERS) + list(NOT_PORTED))}")
        return PARSERS[name](data)
    for marker, parser in (("meta_data.json", "sdfstudio"), ("cameras.json", "sitcoms3d"),
                           ("train.npz", "minimal")):
        if (data / marker).exists():
            _not_ported(parser)
    if (data / "scene.json").exists() and (data / "splits").exists():
        _not_ported("dycheck")
    if (data / "intrinsic" / "intrinsic_color.txt").exists():
        _not_ported("scannet")
    if (data / f"{data.name}_frames").exists():
        _not_ported("arkitscenes")
    if any((data / v).exists() for v in ("v1.0-mini", "v1.0-trainval")):
        _not_ported("nuscenes")
    if (data / "transforms.json").exists() or list(data.glob("transforms_*.json")):
        return TransformsJsonParser(data)
    return ColmapDataParser(data)
