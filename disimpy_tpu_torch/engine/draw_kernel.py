"""The krng draws of one fused epoch or one bounce pass: CUDA kernel (K7)
and plain version.

:func:`unit_directions_epoch` writes the (J, 3, n) unit directions of J
consecutive steps and :func:`bounce_uniform` the permeability uniforms of
one bounce pass. A CUDA tensor goes to the hand-written kernel
``csrc/krng_draw.cu`` (one launch per call, one thread per spin); a CPU
tensor goes to the plain versions in ``engine/krng.py``. There is no
fallback from one to the other: a kernel that fails to build or launch
raises.

``seed`` and the step may be Python ints or 0-d int32 tensors on the
kernel's device; the kernel reads them from device memory, so a captured
CUDA graph replays its launch while the fused window advances them there
(``engine/fused.py``).

The kernel replaces the threefry that XLA fuses into the JAX package's
fused window (``disimpy_tpu/engine/krng.py:77-101``); it has no Pallas
counterpart.
"""

import ctypes

import torch

from . import krng, launch_count


def unit_directions_epoch(seed, t_base, J, ids, dtype=torch.float32):
    """(J, 3, n) isotropic unit directions of steps ``t_base .. t_base + J
    - 1`` for the spins ``ids`` ((n,) int32): ``krng.unit_directions_epoch``
    (the stacked per-step draws), in float32 or float64."""
    kind = ids.device.type
    if kind == "cpu":
        return krng.unit_directions_epoch(seed, t_base, J, ids, dtype)
    if kind == "cuda":
        return directions_cuda(seed, t_base, J, ids, dtype)
    raise ValueError(f"the draws run on cpu or cuda, not {kind}")


def bounce_uniform(seed, t, ids, bounce, idx=None, dtype=torch.float32):
    """Uniforms in [0, 1) for the ``bounce``-th collision resolve of the
    spins ``ids[idx]`` (all of ``ids`` when ``idx`` is None):
    ``krng.bounce_uniform(seed, t, ids[idx], bounce)``. ``bounce`` is an
    int or an integer tensor with one entry per selected spin."""
    kind = ids.device.type
    if kind == "cpu":
        sel = ids if idx is None else ids[idx]
        return krng.bounce_uniform(seed, t, sel, bounce, dtype)
    if kind == "cuda":
        return uniforms_cuda(seed, t, ids, bounce, idx, dtype)
    raise ValueError(f"the draws run on cpu or cuda, not {kind}")


def device_scalars(values, device):
    """A (len(values),) int32 tensor on ``device`` holding Python ints taken
    modulo 2**32; a CUDA device gets it from pinned memory, without a host
    sync."""
    words = [krng.int32(v) for v in values]
    if torch.device(device).type == "cpu":
        return torch.tensor(words, dtype=torch.int32)
    host = torch.tensor(words, dtype=torch.int32, pin_memory=True)
    return host.to(device, non_blocking=True)


def scalar_ptrs(device, *values):
    """Device pointers to int32 scalars: a 0-d int32 tensor on ``device``
    is read where it lies; Python ints are copied there first. Returns
    (pointers, the tensors to keep alive until the launch is enqueued)."""
    ints = [v for v in values if not isinstance(v, torch.Tensor)]
    copy = device_scalars(ints, device) if ints else None
    ptrs, k = [], 0
    for v in values:
        if isinstance(v, torch.Tensor):
            if (v.device != device or v.dtype != torch.int32
                    or v.numel() != 1):
                raise ValueError("a device scalar must be one int32 on "
                                 f"{device}, not {v.dtype} {tuple(v.shape)} "
                                 f"on {v.device}")
            ptrs.append(v.data_ptr())
        else:
            ptrs.append(copy[k].data_ptr())
            k += 1
    return ptrs, copy


def _lib():
    from ._build import load

    lib = load("krng_draw").lib
    lib.krng_directions_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
    lib.krng_directions_launch.restype = ctypes.c_int
    lib.krng_uniforms_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
    lib.krng_uniforms_launch.restype = ctypes.c_int
    return lib


def _float_flag(dtype):
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the draws run in float32 or float64, not {dtype}")
    return int(dtype == torch.float64)


def _check_ids(ids):
    if ids.device.type != "cuda":
        raise ValueError(f"the draw kernel takes CUDA tensors, not {ids.device}")
    if ids.dtype != torch.int32 or ids.ndim != 1 or not ids.is_contiguous():
        raise ValueError("ids must be a contiguous (n,) int32 tensor")


def directions_cuda(seed, t_base, J, ids, dtype=torch.float32):
    """K7's directions on CUDA ``ids``; see :func:`unit_directions_epoch`."""
    _check_ids(ids)
    f64 = _float_flag(dtype)
    n = ids.shape[0]
    device = ids.device
    out = torch.empty((J, 3, n), dtype=dtype, device=device)
    lib = _lib()
    with torch.cuda.device(device):
        (p_seed, p_t), keep = scalar_ptrs(device, seed, t_base)
        rc = lib.krng_directions_launch(
            p_seed, p_t, ids.data_ptr(), n, int(J), f64, out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    del keep
    if rc != 0:
        raise RuntimeError(f"krng_draw kernel launch failed: CUDA error {rc}")
    launch_count.add("krng_draw")
    return out


def uniforms_cuda(seed, t, ids, bounce, idx=None, dtype=torch.float32):
    """K7's bounce uniforms on CUDA ``ids``; see :func:`bounce_uniform`."""
    _check_ids(ids)
    f64 = _float_flag(dtype)
    device = ids.device
    m = ids.shape[0]
    if idx is not None:
        if (idx.device != device or idx.ndim != 1
                or idx.dtype not in (torch.int32, torch.int64)):
            raise ValueError("idx must be a (m,) integer tensor on the ids' "
                             "device")
        idx = idx.to(torch.int64).contiguous()
        m = idx.shape[0]
    bounce_arr, bounce_int = None, 0
    if isinstance(bounce, torch.Tensor):
        if bounce.device != device or tuple(bounce.shape) != (m,):
            raise ValueError(f"a bounce tensor must have shape ({m},) on "
                             f"{device}")
        bounce_arr = bounce.to(torch.int32).contiguous()
    else:
        bounce_int = krng.int32(bounce)
    out = torch.empty((m,), dtype=dtype, device=device)
    lib = _lib()
    with torch.cuda.device(device):
        (p_seed, p_t), keep = scalar_ptrs(device, seed, t)
        rc = lib.krng_uniforms_launch(
            p_seed, p_t, ids.data_ptr(),
            None if idx is None else idx.data_ptr(),
            None if bounce_arr is None else bounce_arr.data_ptr(),
            bounce_int, m, f64, out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    del keep
    if rc != 0:
        raise RuntimeError(f"krng_draw kernel launch failed: CUDA error {rc}")
    launch_count.add("krng_draw")
    return out
