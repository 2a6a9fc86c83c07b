"""One classic time step on an analytic substrate: CUDA kernel (K8) and
plain version.

:func:`analytic_step` advances every spin by one step inside (or, with
permeability, around) a sphere, an infinite cylinder along +x or an
axis-aligned ellipsoid: it draws the step's direction, loops the spin's
collisions to the end and returns the new positions, the iteration-budget
flags and the membrane crossings, with the hand-written kernel
``csrc/analytic_step.cu`` (one launch per step, no host sync: one thread
per spin draws its direction and runs its first collision check, and the
spins that still collide are queued in the block's shared memory and
carried to the end of the step one per thread). It takes CUDA tensors
only; ``stepping.step`` sends CPU tensors to ``stepping.plain_step``, the
plain torch bounce loop fed the draws of ``engine/rng.py``. There is no
fallback from one to the other: a kernel that fails to build or launch
raises.

The kernel replaces the XLA ops of the JAX package's masked bounce loop
(``disimpy_tpu/engine/stepping.py:143-176``); it has no Pallas counterpart.
"""

import ctypes

import torch

from . import draw_kernel, launch_count

KINDS = {"sphere": 0, "cylinder": 1, "ellipsoid": 2}


def _lib():
    from ._build import load

    lib = load("analytic_step").lib
    lib.analytic_step_launch.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
        + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4)
    lib.analytic_step_launch.restype = ctypes.c_int
    return lib


def per_spin_values(name, value, n, dtype, device):
    """``value`` (a float, or a tensor of one or ``n`` values) as a
    contiguous tensor on ``device`` and its stride per spin (0 or 1). A
    float is written by a fill kernel, not copied from the host, so the
    call may run inside a CUDA graph capture."""
    if not isinstance(value, torch.Tensor):
        return torch.full((), float(value), dtype=dtype, device=device), 0
    if value.device != device or value.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} on {device}, not "
                         f"{value.dtype} on {value.device}")
    if value.numel() not in (1, n):
        raise ValueError(f"{name} must hold 1 or {n} values, not "
                         f"{value.numel()}")
    return value.contiguous(), int(value.numel() == n and n > 1)


def analytic_step(kind, positions, spec, epsilon, max_iter, seed, t, ids):
    """One step of the classic engine on an analytic substrate, on the card.

    ``kind`` is "sphere", "cylinder" or "ellipsoid"; ``positions`` (3, n)
    in step-length units (float32 or float64) on a CUDA device, ``spec``
    the substrate's spec on the same device (radius or semiaxes,
    perm_prob; radius and perm_prob may hold one value per spin),
    ``epsilon`` a float or a tensor of one or n values. ``seed`` and ``t``
    key the draws (Python ints or 0-d int32 tensors on the device), ``ids``
    the (n,) int32 spin ids. Returns ``(positions (3, n), exc (n,) bool,
    crossings (n,) int32)``.
    """
    if kind not in KINDS:
        raise ValueError(f"analytic_step takes {sorted(KINDS)}, not {kind!r}")
    dtype = positions.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the analytic kernel takes float32 or float64, not "
                         f"{dtype}")
    device = positions.device
    if device.type != "cuda":
        raise ValueError(f"the analytic kernel takes CUDA tensors, not "
                         f"{device}")
    n = positions.shape[1]
    if positions.ndim != 2 or positions.shape[0] != 3:
        raise ValueError("positions must be (3, n)")
    positions = positions.contiguous()
    if ids.device != device or ids.dtype != torch.int32 or tuple(
            ids.shape) != (n,) or not ids.is_contiguous():
        raise ValueError(f"ids must be a contiguous ({n},) int32 tensor on "
                         f"{device}")
    if kind == "ellipsoid":
        semiaxes = spec.semiaxes
        if tuple(semiaxes.shape) != (3,):
            raise ValueError("the ellipsoid's semiaxes must be (3,)")
        # As the plain version computes it.
        geom, geom_stride = (1.0 / (semiaxes * semiaxes)).contiguous(), 0
        if geom.device != device or geom.dtype != dtype:
            raise ValueError(f"semiaxes must be {dtype} on {device}")
    else:
        geom, geom_stride = per_spin_values("radius", spec.radius, n, dtype,
                                            device)
    perm, perm_stride = per_spin_values("perm_prob", spec.perm_prob, n, dtype,
                                        device)
    eps, eps_stride = per_spin_values("epsilon", epsilon, n, dtype, device)
    out = torch.empty((3, n), dtype=dtype, device=device)
    exc = torch.empty((n,), dtype=torch.bool, device=device)
    crossings = torch.empty((n,), dtype=torch.int32, device=device)
    lib = _lib()
    with torch.cuda.device(device):
        (p_seed, p_t), keep = draw_kernel.scalar_ptrs(device, seed, t)
        rc = lib.analytic_step_launch(
            KINDS[kind], int(dtype == torch.float64), positions.data_ptr(),
            ids.data_ptr(), p_seed, p_t, geom.data_ptr(), geom_stride,
            perm.data_ptr(), perm_stride, eps.data_ptr(), eps_stride, n,
            int(max_iter), out.data_ptr(), exc.data_ptr(),
            crossings.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    del keep
    if rc != 0:
        raise RuntimeError(f"analytic_step kernel launch failed: CUDA error "
                           f"{rc}")
    launch_count.add("analytic_step")
    return out, exc, crossings
