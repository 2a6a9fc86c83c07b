"""The time loop of the classic engine, signal reduction and the float32
matmul guard.

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

from . import rng
from .stepping import STEP_FUNCTIONS

# Mixed into the simulation seed for the free-diffusion step directions, so
# they are independent of the mesh engine's streams (engine/fused.py).
FREE_SALT = 0x66726565
# Mixed into the simulation seed for the classic engine's draws (analytic
# substrates and the per-bounce mesh engine).
CLASSIC_SALT = 0x636C6173


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


def run_window(kind, spec, positions, phases, iter_exc, g_eff, ts, seed32,
               epsilon, max_iter, collect_positions=False, track=None,
               compartments=None, ids=None, blocks=1):
    """Advance the ensemble through the time steps ``ts``.

    Parameters
    ----------
    kind : str
        Substrate kind ("free", "sphere", "cylinder", "ellipsoid", "mesh").
    spec : engine.specs dataclass
        Substrate geometry in step-length units, on the ensemble's device.
        An analytic spec's fields may hold one value per spin.
    positions : torch.Tensor
        (3, n) positions in step-length units (substrate frame), in the
        engine dtype.
    phases : torch.Tensor
        (n_meas, n) accumulated phases (rad), in the engine dtype.
    iter_exc : torch.Tensor
        (n,) bool: spins that have exceeded the collision-iteration budget.
    g_eff : torch.Tensor
        (len(ts), n_meas, 3) per-step phase coefficients in the engine dtype.
    ts : sequence of int
        Absolute time-step indices (they key the per-step streams, so a
        windowed run reproduces a single full one).
    seed32 : int
        Int32-range value derived from the simulation seed.
    epsilon : float or torch.Tensor
        Surface offset after collisions (step-length units): a scalar, or
        an (n,) tensor with one value per spin.
    max_iter : int
        Collision-iteration budget per step.
    collect_positions : bool
        If True, also return the positions after every step of the window
        (trajectory output).
    track : None or "exchange"
        "exchange" also carries each spin's compartment through the window;
        ``compartments`` is then ``(crossings, parity, intra_steps)``: (n,)
        int32 membrane transits so far, (n,) bool current compartment (True
        = intra) and (n,) int32 steps dwelt intra so far.
    ids : torch.Tensor, optional
        (n,) int32 spin ids that key the streams; ``arange(n)`` by default.
        A part of a split run passes its global ids, so every spin keeps
        the stream it has in a single run.
    blocks : int
        The ensemble is ``blocks`` equal runs side by side (a sweep); each
        block's phases accrue through its own (n_meas, 3) x (3, n / blocks)
        product, the one a standalone run of that block does.

    Returns
    -------
    (positions, phases, iter_exc), trajectory [, compartments]
        ``trajectory`` is (len(ts), 3, n) when ``collect_positions`` else
        None. With ``track="exchange"`` a third element holds the updated
        (crossings, parity, intra_steps).
    """
    if track not in (None, "exchange"):
        raise ValueError(f"Incorrect value ({track!r}) for track")
    if track == "exchange" and (compartments is None
                                or len(compartments) != 3):
        raise ValueError("track='exchange' needs compartments = (crossings, "
                         "parity, intra_steps)")
    require_full_fp32()
    step_fn = STEP_FUNCTIONS[kind]
    n = positions.shape[1]
    dtype = positions.dtype
    if ids is None:
        ids = torch.arange(n, dtype=torch.int32, device=positions.device)
    seed_k = int(seed32) ^ (FREE_SALT if kind == "free" else CLASSIC_SALT)
    width = n // blocks
    if track == "exchange":
        crossings, parity, intra_steps = compartments
    trajectory = None
    if collect_positions:
        trajectory = torch.empty((len(ts), 3, n), dtype=dtype,
                                 device=positions.device)
    for i, t in enumerate(ts):
        positions, exc_t, cross_t = step_fn(
            positions, spec, epsilon, max_iter,
            rng.step_directions(seed_k, t, ids, dtype),
            rng.bounce_uniforms(seed_k, t, ids, dtype),
        )
        if blocks == 1:
            phases = phases + g_eff[i] @ positions
        else:
            phases = torch.cat([
                phases[:, b * width:(b + 1) * width]
                + g_eff[i] @ positions[:, b * width:(b + 1) * width]
                .contiguous()
                for b in range(blocks)
            ], dim=1)
        iter_exc = iter_exc | exc_t
        if track == "exchange":
            # Parity flips on odd transits; the spin dwells the whole step
            # in the compartment it ends the step in.
            crossings = crossings + cross_t
            parity = parity ^ (cross_t & 1).bool()
            intra_steps = intra_steps + parity.to(torch.int32)
        if collect_positions:
            trajectory[i] = positions
    if track == "exchange":
        return ((positions, phases, iter_exc), trajectory,
                (crossings, parity, intra_steps))
    return (positions, phases, iter_exc), trajectory


def reduce_signal(phases, iter_exc, weights=None):
    """Total signal per measurement: ``Re sum_spins exp(i phi)``, excluding
    iteration-budget-exceeded spins; ``weights`` (n,) optionally scales
    each spin's contribution (relaxation weighting)."""
    cos = torch.cos(phases)
    if weights is not None:
        cos = cos * weights[None, :]
    return torch.where(iter_exc[None, :], torch.zeros_like(cos), cos).sum(dim=1)


def per_spin_signal(phases, iter_exc, weights=None):
    """Per-spin signals ``Re exp(i phi)`` (times ``weights`` when given)
    with NaN for excluded spins."""
    cos = torch.cos(phases)
    if weights is not None:
        cos = cos * weights[None, :]
    return torch.where(
        iter_exc[None, :], torch.full_like(cos, float("nan")), cos
    )
