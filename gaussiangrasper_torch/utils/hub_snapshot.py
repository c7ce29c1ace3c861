"""Cached hub snapshots, read without the hub client, transformers or
safetensors.

A model name `org/name` resolves as transformers resolves it offline: in
each hub cache root ($HF_HUB_CACHE, then $HF_HOME/hub, then
~/.cache/huggingface/hub), the snapshot is
`models--org--name/snapshots/<the commit in refs/main>/`. A directory that
holds a config.json is taken as the snapshot itself. Weights come from
`model.safetensors` (an 8-byte little-endian header length, a JSON header of
dtype / shape / byte offsets, then the raw tensors) or `pytorch_model.bin`
through `torch.load(weights_only=True)`. Nothing is fetched: where no snapshot is
found, `SnapshotNotFound` names every path searched.

    snap = snapshot_dir("openai/clip-vit-base-patch16")
    config = read_config(snap)
    weights = load_weights(snap, lambda key: key.startswith("text_model."))
"""

from __future__ import annotations

import json
import os
import struct
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

SAFETENSORS = "model.safetensors"
TORCH_BIN = "pytorch_model.bin"

_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
           "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


class SnapshotNotFound(FileNotFoundError):
    """No cached snapshot of a model; the message names every path searched."""


def cache_roots() -> List[Path]:
    """The hub cache roots in search order: $HF_HUB_CACHE, $HF_HOME/hub,
    ~/.cache/huggingface/hub (each once, the unset ones left out)."""
    roots = []
    if os.environ.get("HF_HUB_CACHE"):
        roots.append(Path(os.environ["HF_HUB_CACHE"]))
    if os.environ.get("HF_HOME"):
        roots.append(Path(os.environ["HF_HOME"]) / "hub")
    roots.append(Path.home() / ".cache" / "huggingface" / "hub")
    out = []
    for r in roots:
        if r not in out:
            out.append(r)
    return out


def repo_dir(root: Path, name: str) -> Path:
    return root / ("models--" + name.replace("/", "--"))


def snapshot_dir(name: str) -> Path:
    """The local snapshot of `name` (a hub name, or a directory holding a
    config.json); raises SnapshotNotFound naming the paths searched."""
    if (Path(name) / "config.json").is_file():
        return Path(name)
    searched = []
    for root in cache_roots():
        repo = repo_dir(root, name)
        ref = repo / "refs" / "main"
        if ref.is_file():
            snap = repo / "snapshots" / ref.read_text().strip()
            if (snap / "config.json").is_file():
                return snap
            searched.append(str(snap / "config.json"))
        else:
            searched.append(str(ref))
    raise SnapshotNotFound(f"no snapshot of {name} at {', '.join(searched)}")


def read_config(snap: Path) -> dict:
    return json.loads((Path(snap) / "config.json").read_text())


def read_safetensors(path: Path, keep: Optional[Callable[[str], bool]] = None
                     ) -> Dict[str, torch.Tensor]:
    """The tensors of a .safetensors file (those whose key `keep` accepts),
    each copied out of the file's bytes on the CPU."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        out = {}
        for key, meta in header.items():
            if key == "__metadata__" or (keep is not None and not keep(key)):
                continue
            lo, hi = meta["data_offsets"]
            f.seek(8 + n + lo)
            buf = bytearray(f.read(hi - lo))
            dtype = _DTYPES[meta["dtype"]]
            t = torch.frombuffer(buf, dtype=dtype) if buf else torch.empty(0, dtype=dtype)
            out[key] = t.reshape(meta["shape"])
    return out


def write_safetensors(path: Path, tensors: Dict[str, torch.Tensor]) -> None:
    """Write `tensors` in the safetensors layout (keys sorted, each tensor
    contiguous, offsets in key order, the header padded to 8 bytes)."""
    header, blobs, offset = {}, [], 0
    for key in sorted(tensors):
        t = tensors[key].detach().to("cpu").contiguous()
        data = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[key] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                       "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for b in blobs:
            f.write(b)


def load_weights(snap: Path, keep: Optional[Callable[[str], bool]] = None
                 ) -> Dict[str, torch.Tensor]:
    """The snapshot's weights (those `keep` accepts) on the CPU, from
    model.safetensors or pytorch_model.bin."""
    snap = Path(snap)
    if (snap / SAFETENSORS).is_file():
        return read_safetensors(snap / SAFETENSORS, keep)
    if (snap / TORCH_BIN).is_file():
        state = torch.load(snap / TORCH_BIN, map_location="cpu", weights_only=True)
        return {k: v for k, v in state.items() if keep is None or keep(k)}
    raise SnapshotNotFound(f"no weights in {snap} ({SAFETENSORS} or {TORCH_BIN})")


def write_snapshot(root: Path, name: str, files: Dict[str, object],
                   commit: str = "0" * 40) -> Path:
    """A snapshot of `name` in the hub cache layout under `root`: `files`
    maps a file name to a dict (written as JSON), a str (text) or a dict
    of tensors under a .safetensors name. Returns the snapshot directory."""
    repo = repo_dir(Path(root), name)
    snap = repo / "snapshots" / commit
    snap.mkdir(parents=True, exist_ok=True)
    (repo / "refs").mkdir(exist_ok=True)
    (repo / "refs" / "main").write_text(commit)
    for fname, content in files.items():
        if fname.endswith(".safetensors"):
            write_safetensors(snap / fname, content)
        elif isinstance(content, str):
            (snap / fname).write_text(content, encoding="utf-8")
        else:
            (snap / fname).write_text(json.dumps(content, ensure_ascii=False), encoding="utf-8")
    return snap
