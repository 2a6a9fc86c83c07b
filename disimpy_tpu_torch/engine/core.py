"""Free-diffusion window, signal reduction and the float32 matmul guard.

Phase accrual is the MR physics: after step t each spin gains
``phi += GAMMA * dt * g(t) . r(t)``. With positions in step-length units and
``g_eff = GAMMA * dt * step_l * g``, the per-step update is the matrix
product ``phases += g_eff[t] @ positions``, an (n_meas, 3) x (3, n_spins)
contraction.

Every random draw is keyed with the id-keyed threefry streams of
``engine/krng.py``, so a spin's walk does not depend on how the ensemble is
ordered or split.
"""

import torch

from . import krng

# Mixed into the simulation seed for the free-diffusion step directions, so
# they are independent of the mesh engine's streams (engine/fused.py).
FREE_SALT = 0x66726565


def require_full_fp32():
    """Raise unless float32 matrix products run in full float32.

    TF32 keeps about three decimal digits; positions reach ~1e2 step
    lengths, so the phase products would lose the precision the signal
    oracles need.
    """
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "the phase products need full float32 matrix products: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')"
        )


def run_window_free(positions, phases, g_eff, ts, seed32):
    """Advance free diffusion through the time steps ``ts``.

    ``positions`` (3, n) and ``phases`` (n_meas, n) are float32 tensors on
    one device; ``g_eff`` (len(ts), n_meas, 3) is on the same device; ``ts``
    is a sequence of absolute step indices (keys the per-step streams);
    ``seed32`` an int32-range simulation seed. Returns the new
    ``(positions, phases)``.
    """
    require_full_fp32()
    n = positions.shape[1]
    ids = torch.arange(n, dtype=torch.int32, device=positions.device)
    seed_k = int(seed32) ^ FREE_SALT
    for i, t in enumerate(ts):
        positions = positions + krng.unit_directions(
            seed_k, int(t), ids, positions.dtype
        )
        phases = phases + g_eff[i] @ positions
    return positions, phases


def reduce_signal(phases, iter_exc):
    """Total signal per measurement: ``Re sum_spins exp(i phi)``, excluding
    iteration-budget-exceeded spins."""
    cos = torch.cos(phases)
    return torch.where(iter_exc[None, :], torch.zeros_like(cos), cos).sum(dim=1)


def per_spin_signal(phases, iter_exc):
    """Per-spin signals ``Re exp(i phi)`` with NaN for excluded spins."""
    cos = torch.cos(phases)
    return torch.where(
        iter_exc[None, :], torch.full_like(cos, float("nan")), cos
    )
