"""Export trained Gaussians to an INRIA-convention .ply (counterpart of the
JAX package's scripts/export_ply.py).

Fields x, y, z, nx, ny, nz, f_dc_0..2, f_rest_0..(3 (K - 1) - 1), opacity
(logit), scale_0..2 (log), rot_0..3: the layout 3DGS viewers read, binary
little-endian float32. For the same state the bytes are the JAX writer's.

    python -m gaussiangrasper_torch.scripts.export_ply --run-dir RUN [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from gaussiangrasper_torch._device import resolve_device
from gaussiangrasper_torch.models.gaussian_field import GaussianParams
from gaussiangrasper_torch.scripts.common import load_run


def write_gaussian_ply(path: Path, field: GaussianParams, alive: np.ndarray) -> int:
    """Write the alive Gaussians; returns how many."""
    def host(x):
        return x.detach().cpu().numpy()[alive]

    means, sh, opac = host(field.means), host(field.sh_coeffs), host(field.opacity_logits)
    log_scales, quats = host(field.log_scales), host(field.quats)
    n, k, _ = sh.shape

    f_dc = sh[:, 0, :]
    # INRIA stores the rest coefficients channel-major: all K - 1 of R, then G, then B
    f_rest = sh[:, 1:, :].transpose(0, 2, 1).reshape(n, -1)

    names = (["x", "y", "z", "nx", "ny", "nz"] + [f"f_dc_{i}" for i in range(3)]
             + [f"f_rest_{i}" for i in range(3 * (k - 1))] + ["opacity"]
             + [f"scale_{i}" for i in range(3)] + [f"rot_{i}" for i in range(4)])
    data = np.concatenate([means, np.zeros((n, 3), np.float32), f_dc, f_rest, opac[:, None],
                           log_scales, quats], axis=-1).astype("<f4")

    with open(path, "wb") as fh:
        header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
        header += [f"property float {nm}" for nm in names]
        header += ["end_header"]
        fh.write(("\n".join(header) + "\n").encode("ascii"))
        fh.write(data.tobytes())
    return n


def read_gaussian_ply(path: Path) -> dict:
    """Inverse of write_gaussian_ply: a dict of numpy arrays."""
    with open(path, "rb") as fh:
        names = []
        n = 0
        while True:
            line = fh.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property float"):
                names.append(line.split()[-1])
            elif line == "end_header":
                break
        data = np.frombuffer(fh.read(n * len(names) * 4), "<f4").reshape(n, len(names))
    col = {nm: i for i, nm in enumerate(names)}
    n_rest = sum(1 for nm in names if nm.startswith("f_rest_"))
    k = n_rest // 3 + 1
    f_rest = data[:, [col[f"f_rest_{i}"] for i in range(n_rest)]]
    sh = np.zeros((n, k, 3), np.float32)
    sh[:, 0, :] = data[:, [col["f_dc_0"], col["f_dc_1"], col["f_dc_2"]]]
    sh[:, 1:, :] = f_rest.reshape(n, 3, k - 1).transpose(0, 2, 1)
    return {
        "means": data[:, [col["x"], col["y"], col["z"]]],
        "sh_coeffs": sh,
        "opacity_logits": data[:, col["opacity"]],
        "log_scales": data[:, [col[f"scale_{i}"] for i in range(3)]],
        "quats": data[:, [col[f"rot_{i}"] for i in range(4)]],
    }


def main(argv=None) -> Path:
    """Export; returns the .ply path."""
    p = argparse.ArgumentParser(description="Export Gaussians as INRIA .ply")
    p.add_argument("--run-dir", type=Path, required=True)
    p.add_argument("--output", type=Path, default=None)
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    _, _, state = load_run(args.run_dir, step=args.step, device=resolve_device(args.device))
    out = args.output or (args.run_dir / "point_cloud.ply")
    n = write_gaussian_ply(out, state.field, state.alive.cpu().numpy())
    print(f"wrote {n} gaussians to {out}")
    return out


if __name__ == "__main__":
    main()
