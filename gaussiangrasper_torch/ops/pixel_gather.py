"""The EFD loss's pixel gather: `fea[idx[:, 0], idx[:, 1]]`, rows of an
(H, W, F) feature map at (N, 2) (row, col) pixels (`models/model.train_loss`
reads the contrastive pairs' two ends and the distillation points in one
call).

`gather_pixels` runs it two ways, chosen by the map's device alone
(`_device.use_kernel`):

- on the card: `PixelGather`, the kernels of `csrc/pixel_gather.cu`,
  which take a float32 map and raise ValueError for another dtype. The
  forward reads the map's strided view as it is (a copy, bit-equal to the
  plain read); the backward zero-fills an (H, W, F) gradient and adds
  each row into its pixel, a warp's rows of equal pixel merged first,
  then float atomics: the plain path's sums, with last bits that depend
  on the atomics' order across warps;
- on the CPU: the plain advanced index, whose backward is autograd's
  `index_put_` with accumulate. On the card that is a sort of every row's
  pixel and a serial walk of each run of equal pixels, which the
  sampler's padding rows at (0, 0) make long.

While the port's spans are on, every call counts its rows in
`efd/gather_rows`, and those the kernels take in `efd/gather_rows_kernel`;
the kernels' backward runs in the span `gather_bwd`, on autograd's thread."""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from gaussiangrasper_torch._build import launch
from gaussiangrasper_torch._device import use_kernel
from gaussiangrasper_torch.utils.profiler import PROFILER


def _check(fea: torch.Tensor, idx: torch.Tensor) -> None:
    if fea.ndim != 3 or fea.dtype != torch.float32 or idx.dtype != torch.int32 \
            or idx.ndim != 2 or idx.shape[1] != 2 or not idx.is_contiguous() \
            or idx.device != fea.device or idx.shape[0] >= 2 ** 31:
        raise ValueError(f"the pixel gather kernels take an (H, W, F) float32 map and "
                         f"contiguous (N, 2) int32 indices on its device; got {fea.dtype} "
                         f"{tuple(fea.shape)} on {fea.device}, {idx.dtype} {tuple(idx.shape)} "
                         f"on {idx.device}")


def pixel_gather_fwd_cuda(fea: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The forward kernel: fea (H, W, F), any strides; idx (N, 2) int32 ->
    (N, F)."""
    _check(fea, idx)
    h, w, f = fea.shape
    n = idx.shape[0]
    out = torch.empty(n, f, dtype=torch.float32, device=fea.device)
    if n * f == 0:
        return out
    launch("pixel_gather", "ggt_pixel_gather_fwd",
           [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 3
           + [ctypes.c_void_p],
           fea.data_ptr(), idx.data_ptr(), n, f, h, w, *fea.stride(), out.data_ptr(),
           device=fea.device)
    return out


def pixel_gather_bwd_cuda(idx: torch.Tensor, g_out: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The backward kernel: dL/dfea (H, W, F), contiguous, from idx (N, 2)
    int32 and g_out = dL/dout (N, F)."""
    g_out = g_out.contiguous()
    g_fea = torch.zeros(h, w, g_out.shape[1], dtype=torch.float32, device=g_out.device)
    _check(g_fea, idx)
    n, f = g_out.shape
    if g_out.dtype != torch.float32 or n != idx.shape[0]:
        raise ValueError(f"g_out is ({idx.shape[0]}, F) float32; got {g_out.dtype} "
                         f"{tuple(g_out.shape)}")
    if n * f == 0:
        return g_fea
    launch("pixel_gather", "ggt_pixel_gather_bwd",
           [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
           idx.data_ptr(), g_out.data_ptr(), n, f, h, w, g_fea.data_ptr(), device=g_out.device)
    return g_fea


class PixelGather(torch.autograd.Function):
    """The gather through the kernels: (fea (H, W, F), idx (N, 2) int32) ->
    (N, F); its backward (`PixelGatherBackward` in a trace) makes no host
    sync."""

    @staticmethod
    def forward(ctx, fea, idx):
        ctx.save_for_backward(idx)
        ctx.hw = fea.shape[:2]
        return pixel_gather_fwd_cuda(fea, idx)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_out):
        (idx,) = ctx.saved_tensors
        with PROFILER.section("gather_bwd"):
            return pixel_gather_bwd_cuda(idx, g_out, *ctx.hw), None


def gather_pixels(fea: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`fea[idx[:, 0], idx[:, 1]]`: fea (H, W, F), idx (N, 2) integer (row,
    col) -> (N, F), through the kernels on the card (fea float32), the plain
    advanced index on the CPU."""
    kernel = use_kernel(fea.device, "gather_pixels")
    if PROFILER.on():  # host ints: no sync
        PROFILER.count("efd/gather_rows", idx.shape[0])
        if kernel:
            PROFILER.count("efd/gather_rows_kernel", idx.shape[0])
    if kernel:
        return PixelGather.apply(fea, idx.to(torch.int32).contiguous())
    return fea[idx[:, 0], idx[:, 1]]
