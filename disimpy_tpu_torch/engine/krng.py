"""Threefry2x32 counter-based RNG on torch integer tensors.

The fused mesh kernel draws per-spin randomness keyed by the spin's carried
global id, so the stream is independent of the ensemble's sort order and of
how spins are split. This module implements the Threefry2x32 block cipher
(Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC'11) with
13 rounds; ``csrc/threefry.cuh`` holds the same cipher as device code for
the epoch kernel (``csrc/fused_epoch.cu``) and the draw kernel
(``csrc/krng_draw.cu``, ``engine/draw_kernel.py``), and all give the same
words bit for bit. The draw functions below are that kernel's plain
versions.

torch has no logical right shift on int32 (``>>`` is arithmetic) and does
not promise wrapping int32 overflow, so every word is carried as an int64
holding the unsigned 32-bit value (masked with ``0xFFFFFFFF`` after each
add and shift) and is viewed back as int32 at the end.

Every function works elementwise on tensors of any shape; scalar arguments
may be Python ints (any sign: they are taken modulo 2**32) or 0-d int32
tensors on the tensors' device.
"""

import math

import torch

_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_MASK = 0xFFFFFFFF


def _u32(x):
    """An int32-valued tensor or Python int as unsigned words in int64."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _MASK
    return int(x) & _MASK


def int32(x):
    """A Python int taken modulo 2**32 as a signed int32 value."""
    x = int(x) & _MASK
    return x - (1 << 32) if x >= (1 << 31) else x


def _to_int32(x):
    """Unsigned words held in int64 -> the int32 with the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1, rounds=13):
    """Threefry2x32 block cipher: key (k0, k1), counter (x0, x1).

    Arguments are int32 tensors or Python ints (broadcastable, at least one
    a tensor); returns two int32 tensors of the broadcast shape.
    ``rounds`` in {13, 20}.
    """
    k0, k1 = _u32(k0), _u32(k1)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (_u32(x0) + ks[0]) & _MASK
    x1 = (_u32(x1) + ks[1]) & _MASK
    for r in range(rounds):
        x0 = (x0 + x1) & _MASK
        x1 = _rotl(x1, _ROTATIONS[r % 8])
        x1 = x1 ^ x0
        if r % 4 == 3:
            g = r // 4 + 1  # key injection after every 4 rounds
            x0 = (x0 + ks[g % 3]) & _MASK
            x1 = (x1 + ks[(g + 1) % 3] + g) & _MASK
    return _to_int32(x0), _to_int32(x1)


def uniform01(bits, dtype=torch.float32):
    """Map int32 random bits to uniforms in [0, 1) with 24-bit resolution."""
    return ((bits.to(torch.int64) & _MASK) >> 8).to(dtype) * (1.0 / (1 << 24))


def step_words(seed, t, ids, draw):
    """Two int32 random words for (seed, time step, spin id, draw index).

    The key is (seed, t) and the counter (id, draw): every (spin, step,
    draw) triple gets an independent block wherever the spin sits in the
    sorted ensemble.
    """
    return threefry2x32(seed, t, ids, draw)


def unit_directions(seed, t, ids, dtype=torch.float32):
    """Isotropic unit directions (3, n) keyed per (seed, t, spin id).

    Archimedes sampling: z uniform in [-1, 1], uniform azimuth.
    """
    w0, w1 = step_words(seed, t, ids, 0)
    u0 = uniform01(w0, dtype)
    u1 = uniform01(w1, dtype)
    z = 1.0 - 2.0 * u0
    rho = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = (2.0 * math.pi) * u1
    return torch.stack((rho * torch.cos(phi), rho * torch.sin(phi), z))


def unit_directions_epoch(seed, t_base, J, ids, dtype=torch.float32):
    """(J, 3, n) unit directions of steps ``t_base .. t_base + J - 1``:
    :func:`unit_directions` stacked over the epoch's steps."""
    return torch.stack([
        unit_directions(seed, t_base + s, ids, dtype) for s in range(J)
    ])


def bounce_uniform(seed, t, ids, bounce, dtype=torch.float32):
    """Uniform in [0, 1) for the ``bounce``-th collision resolve."""
    w0, _ = threefry2x32(seed, t, ids, _u32(bounce) + 1)
    return uniform01(w0, dtype)
