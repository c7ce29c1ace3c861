"""Field encodings: positional (NeRF), spherical harmonics, multiresolution
hash grid (counterpart of the JAX package's models/encodings.py).

The hash grid is a gather from one (L, 2^H, F) table with trilinear
weights. `hash_grid_encode` runs it two ways, chosen by the table alone:

- a float32 table on the card: `HashGridEncode`, the kernels of
  `csrc/hash_grid.cu` (`hash_grid_fwd_cuda`, `hash_grid_bwd_cuda`, and
  `hash_grid_bwd2_cuda` for a gradient taken with create_graph), which
  take F = 2 and raise for anything else. The backward merges a warp's
  equal corner rows, then adds into the table gradient by float atomics:
  the plain path's math, with last bits that depend on the atomics' order
  across warps;
- a CPU table, or a float64 one (the card-against-CPU float64 references
  of the tests): `encode_plain`, plain torch ops, whose backward is
  autograd's scatter-add into the table. It is the kernels' reference in
  the tests, and bit-equal to the JAX package.

While the port's spans are on, every call counts its (point, level)
lookups in `hash/lookups`, and those the kernels take in
`hash/lookups_kernel`; the forward runs in the span `hash`, the kernel
path's backward in `hash_bwd` and its double backward in `hash_bwd2`, on
autograd's thread."""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.autograd.function import once_differentiable

from gaussiangrasper_torch._build import check_error as _check, entry as _entry
from gaussiangrasper_torch.core import sh as sh_mod
from gaussiangrasper_torch.utils.profiler import PROFILER

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF
# the 8 cell corners, (i, j, k) with k fastest
_OFFSETS = tuple((i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1))


def positional_encoding(x: torch.Tensor, num_freqs: int,
                        include_input: bool = True) -> torch.Tensor:
    """NeRF sin/cos encoding at frequencies 2^0..2^(L-1) (times pi)."""
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    scaled = x[..., None] * freqs  # (..., D, L)
    enc = torch.cat([torch.sin(math.pi * scaled), torch.cos(math.pi * scaled)], dim=-1)
    enc = enc.reshape(*x.shape[:-1], -1)
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc


def sh_encoding(dirs: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """Direction encoding by the real SH basis up to `degree`."""
    return sh_mod.sh_basis(dirs)[..., : sh_mod.num_sh_bases(degree)]


def grid_resolutions(num_levels: int, base_res: int, max_res: int) -> torch.Tensor:
    """floor(base_res * growth^l), growth = (max_res / base_res)^(1/(L-1)).

    Evaluated in float64 (with a 1e-9 relative guard for the levels whose
    value is an integer, the last one = max_res among them) and returned in
    float32. The JAX package evaluates it in float32, where exp can land an
    ulp below an integer and floor drops a level by one; at the JAX
    package's registered grids (4, 5, 12 and 16 levels up to 256 / 2048)
    both give the same resolutions, and converted params carry the JAX
    package's own buffer."""
    ratio = math.log(max_res / base_res) / max(num_levels - 1, 1) if num_levels > 1 else 0.0
    res = [math.floor(base_res * math.exp(ratio * level) * (1.0 + 1e-9))
           for level in range(num_levels)]
    return torch.tensor(res, dtype=torch.float32)


class HashGrid(nn.Module):
    """The hash table `table` (L, 2^H, F), a parameter, and the per-level
    `resolutions` (L,), a buffer (the lookup does not differentiate it)."""

    def __init__(self, num_levels: int = 16, features_per_level: int = 2,
                 log2_hashmap_size: int = 19, base_res: int = 16, max_res: int = 2048,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        shape = (num_levels, 2 ** log2_hashmap_size, features_per_level)
        # U(-1e-4, 1e-4)
        self.table = nn.Parameter((torch.rand(shape, generator=generator) * 2.0 - 1.0) * 1e-4)
        self.register_buffer("resolutions", grid_resolutions(num_levels, base_res, max_res))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return hash_grid_encode(self, x)


def init_hash_grid(num_levels: int = 16, features_per_level: int = 2,
                   log2_hashmap_size: int = 19, base_res: int = 16, max_res: int = 2048,
                   generator: Optional[torch.Generator] = None) -> HashGrid:
    return HashGrid(num_levels, features_per_level, log2_hashmap_size, base_res, max_res,
                    generator)


def hash_indices(x: torch.Tensor, resolutions: torch.Tensor, hashmap_size: int):
    """(L, N, 8) int64 table rows of each point's 8 corners at each level
    and (L, N, 3) fractional positions, for x (N, 3) in [0, 1].

    The JAX package multiplies uint32 corners by the primes and XORs them,
    wrapping mod 2^32; here each product is taken in int64 (corner < 2^12,
    prime < 2^32) and masked to 32 bits, which gives the same bits."""
    pos = x[None] * resolutions[:, None, None]  # (L, N, 3)
    p0 = torch.floor(pos)
    frac = pos - p0
    offs = torch.tensor(_OFFSETS, dtype=torch.int64, device=x.device)
    corners = p0.to(torch.int64)[:, :, None, :] + offs  # (L, N, 8, 3)
    h = ((corners[..., 0] * _PRIMES[0]) & _U32) \
        ^ ((corners[..., 1] * _PRIMES[1]) & _U32) \
        ^ ((corners[..., 2] * _PRIMES[2]) & _U32)
    return h % hashmap_size, frac


def encode_plain(table: torch.Tensor, resolutions: torch.Tensor,
                 xf: torch.Tensor) -> torch.Tensor:
    """The lookup in plain torch ops: table (L, T, F), xf (N, 3) in [0, 1]
    -> (N, L * F)."""
    num_levels, hashmap_size, f = table.shape
    h, frac = hash_indices(xf, resolutions, hashmap_size)
    rows = h + (torch.arange(num_levels, device=xf.device) * hashmap_size)[:, None, None]
    vals = table.reshape(num_levels * hashmap_size, f)[rows]  # (L, N, 8, F)
    offs = torch.tensor(_OFFSETS, device=xf.device)
    axis_w = torch.where(offs == 1, frac[:, :, None, :], 1.0 - frac[:, :, None, :])
    w = axis_w[..., 0] * axis_w[..., 1] * axis_w[..., 2]  # (L, N, 8)
    feats = torch.sum(vals * w[..., None], dim=2)  # (L, N, F)
    return feats.permute(1, 0, 2).reshape(xf.shape[0], num_levels * f)


_MAX_POINTS = 2 ** 31 - 256  # the kernels index points by int


def _launch(x: torch.Tensor, table: torch.Tensor, *more: torch.Tensor) -> Tuple[int, int, int, int]:
    """(N, L, T, stream) of a launch, after checking what every kernel
    takes: contiguous float32 tensors on x's card, x (N, 3), table (L, T, 2)."""
    n = x.shape[0]
    num_levels, hashmap_size, f = table.shape
    tensors = (x, table) + more
    if not all(t.is_cuda and t.device == x.device and t.dtype == torch.float32
               and t.is_contiguous() for t in tensors) or x.shape[1:] != (3,) or f != 2 \
            or n > _MAX_POINTS or not 1 <= num_levels <= 65535:
        raise ValueError(
            f"hash_grid kernels take contiguous float32 tensors on one card, x (N <= {_MAX_POINTS}, "
            f"3) and a table (1..65535, T, 2); got x {tuple(x.shape)}, table {tuple(table.shape)}, "
            + ", ".join(f"{t.dtype} on {t.device}" for t in tensors))
    return n, num_levels, hashmap_size, torch.cuda.current_stream(x.device).cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def hash_grid_fwd_cuda(x: torch.Tensor, table: torch.Tensor,
                       resolutions: torch.Tensor) -> torch.Tensor:
    """The forward kernel: x (N, 3), table (L, T, 2), resolutions (L,) ->
    (N, 2 L)."""
    n, num_levels, hashmap_size, stream = _launch(x, table, resolutions)
    out = torch.empty(n, 2 * num_levels, dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    lib, fn = _entry("hash_grid", "ggt_hash_grid_fwd",
                     [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
    err = fn(x.data_ptr(), table.data_ptr(), resolutions.data_ptr(), n, num_levels, hashmap_size,
             out.data_ptr(), stream)
    _check(lib, err, "hash_grid_fwd launch")
    hash_grid_fwd_cuda.launches += 1
    return out


hash_grid_fwd_cuda.launches = 0


def hash_grid_bwd_cuda(x: torch.Tensor, table: torch.Tensor, resolutions: torch.Tensor,
                       g_out: torch.Tensor, want_x: bool, want_table: bool):
    """The backward kernel: (dL/dx (N, 3) or None, dL/dtable (L, T, 2) or
    None) from g_out (N, 2 L), each given where wanted."""
    n, num_levels, hashmap_size, stream = _launch(x, table, resolutions, g_out)
    g_x = torch.zeros_like(x) if want_x else None
    g_table = torch.zeros_like(table) if want_table else None
    if n == 0 or not (want_x or want_table):
        return g_x, g_table
    lib, fn = _entry("hash_grid", "ggt_hash_grid_bwd",
                     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3)
    err = fn(x.data_ptr(), table.data_ptr(), resolutions.data_ptr(), g_out.data_ptr(), n,
             num_levels, hashmap_size, _ptr(g_table), _ptr(g_x), stream)
    _check(lib, err, "hash_grid_bwd launch")
    hash_grid_bwd_cuda.launches += 1
    return g_x, g_table


hash_grid_bwd_cuda.launches = 0


def hash_grid_bwd2_cuda(x: torch.Tensor, table: torch.Tensor, resolutions: torch.Tensor,
                        g_out: torch.Tensor, gg_x: torch.Tensor, want_g_out: bool,
                        want_table: bool, want_x: bool):
    """The backward's backward kernel: from gg_x = dL/d(dL/dx) (N, 3), the
    gradients that L takes through the backward's dL/dx: (dL/dg_out (N, 2 L),
    dL/dtable (L, T, 2), dL/dx (N, 3)), each None where not wanted."""
    n, num_levels, hashmap_size, stream = _launch(x, table, resolutions, g_out, gg_x)
    gg_out = torch.empty_like(g_out) if want_g_out else None
    g_table = torch.zeros_like(table) if want_table else None
    g_x = torch.zeros_like(x) if want_x else None
    if n == 0 or not (want_g_out or want_table or want_x):
        return gg_out, g_table, g_x
    lib, fn = _entry("hash_grid", "ggt_hash_grid_bwd2",
                     [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4)
    err = fn(x.data_ptr(), table.data_ptr(), resolutions.data_ptr(), g_out.data_ptr(),
             gg_x.data_ptr(), n, num_levels, hashmap_size, _ptr(gg_out), _ptr(g_table), _ptr(g_x),
             stream)
    _check(lib, err, "hash_grid_bwd2 launch")
    hash_grid_bwd2_cuda.launches += 1
    return gg_out, g_table, g_x


hash_grid_bwd2_cuda.launches = 0


class HashGridEncode(torch.autograd.Function):
    """The lookup through the kernels: (x (N, 3), table (L, T, 2),
    resolutions (L,)) -> (N, 2 L). Its backward is `HashGridGrad`,
    so that a gradient taken with create_graph (neus-facto's SDF gradient,
    which its eikonal loss differentiates again) has a backward of its own."""

    @staticmethod
    def forward(ctx, x, table, resolutions):
        ctx.save_for_backward(x, table, resolutions)
        return hash_grid_fwd_cuda(x, table, resolutions)

    @staticmethod
    def backward(ctx, g_out):
        x, table, resolutions = ctx.saved_tensors
        with PROFILER.section("hash_bwd"):
            g_x, g_table = HashGridGrad.apply(x, table, resolutions, g_out.contiguous(),
                                              *ctx.needs_input_grad[:2])
        return g_x, g_table, None


class HashGridGrad(torch.autograd.Function):
    """The backward kernel as a function of (x, table, resolutions, g_out):
    (dL/dx or None, dL/dtable or None). Its own backward is the bwd2 kernel
    for the gradient that reaches dL/dx, and the forward and backward kernels
    for the one that reaches dL/dtable (the lookup again, with that gradient
    as the table)."""

    @staticmethod
    def forward(ctx, x, table, resolutions, g_out, want_x, want_table):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, table, resolutions, g_out)
        return hash_grid_bwd_cuda(x, table, resolutions, g_out, want_x, want_table)

    @staticmethod
    @once_differentiable
    def backward(ctx, gg_x, gg_table):
        x, table, resolutions, g_out = ctx.saved_tensors
        need_x, need_table, _, need_g = ctx.needs_input_grad[:4]
        d_g = d_table = d_x = None
        with PROFILER.section("hash_bwd2"):
            if gg_x is not None:
                d_g, d_table, d_x = hash_grid_bwd2_cuda(x, table, resolutions, g_out,
                                                        gg_x.contiguous(), need_g, need_table,
                                                        need_x)
            if gg_table is not None:
                gg_table = gg_table.contiguous()
                if need_g:
                    d = hash_grid_fwd_cuda(x, gg_table, resolutions)
                    d_g = d if d_g is None else d_g + d
                if need_x:
                    d = hash_grid_bwd_cuda(x, gg_table, resolutions, g_out, True, False)[0]
                    d_x = d if d_x is None else d_x + d
        return d_x, d_table, None, d_g, None, None


def hash_grid_encode(grid: HashGrid, x: torch.Tensor) -> torch.Tensor:
    """Trilinear-interpolated hash lookup: x (..., 3) in [0, 1] ->
    (..., L * F), through the kernels for a float32 table on the card, else
    `encode_plain`."""
    table = grid.table
    num_levels, _, f = table.shape
    batch = x.shape[:-1]
    xf = x.reshape(-1, 3)
    kernel = table.is_cuda and table.dtype == torch.float32
    if PROFILER.on():  # host ints: no sync
        lookups = xf.shape[0] * num_levels
        PROFILER.count("hash/lookups", lookups)
        if kernel:
            PROFILER.count("hash/lookups_kernel", lookups)
    with PROFILER.section("hash"):
        if kernel:
            out = HashGridEncode.apply(xf.contiguous(), table.contiguous(),
                                       grid.resolutions.detach().to(torch.float32))
        else:
            out = encode_plain(table, grid.resolutions.detach(), xf)
    return out.reshape(*batch, num_levels * f)
