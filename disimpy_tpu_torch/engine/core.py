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

A window is one step function, :func:`step_body`, run once per time step
on a :class:`ClassicState` of buffers. On a CUDA device each step is kernel
launches with no host read-back, so the window replays one captured CUDA
graph of it per step (``engine/graphs.py``), as the JAX package runs its
classic window as one compiled program (a ``lax.scan`` over the steps).
"""

import dataclasses

import torch

from . import graphs, stepping

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


@dataclasses.dataclass
class ClassicState:
    """A classic window's buffers, which :func:`step_body` updates in place.

    ``positions`` (3, n), ``ids`` (n,) int32, ``iter_exc`` (n,) bool,
    ``phases`` (n_meas, n); ``g`` (n_t, n_meas, 3) the window's phase
    coefficients; ``scalars`` (2,) int32 (draw key, absolute step) and
    ``step`` (1,) int64 (the step's index in the window), which each step
    advances by ``advance`` and 1; ``epsilon`` a float or the state's copy
    of a per-spin tensor; ``compartments`` (crossings, parity,
    intra_steps) or None; ``trajectory`` (n_t, 3, n) or None.
    """

    positions: torch.Tensor
    ids: torch.Tensor
    iter_exc: torch.Tensor
    phases: torch.Tensor
    g: torch.Tensor
    scalars: torch.Tensor
    advance: torch.Tensor
    step: torch.Tensor
    epsilon: object
    compartments: tuple = None
    trajectory: torch.Tensor = None

    @classmethod
    def like(cls, positions, phases, iter_exc, g_eff, epsilon,
             compartments=None, n_collect=None):
        """Empty buffers of the given tensors' shapes and devices, with a
        trajectory of ``n_collect`` steps unless it is None."""
        from .draw_kernel import device_scalars

        device = positions.device
        return cls(
            positions=torch.empty_like(positions),
            ids=torch.empty(positions.shape[1], dtype=torch.int32,
                            device=device),
            iter_exc=torch.empty_like(iter_exc),
            phases=torch.empty_like(phases),
            g=torch.empty_like(g_eff),
            scalars=torch.empty(2, dtype=torch.int32, device=device),
            advance=device_scalars((0, 1), device),
            step=torch.empty(1, dtype=torch.int64, device=device),
            epsilon=(torch.empty_like(epsilon)
                     if isinstance(epsilon, torch.Tensor) else epsilon),
            compartments=None if compartments is None else tuple(
                torch.empty_like(c) for c in compartments),
            trajectory=(torch.empty((n_collect,) + tuple(positions.shape),
                                    dtype=positions.dtype, device=device)
                        if n_collect is not None else None),
        )

    def load(self, positions, ids, iter_exc, phases, g_eff, seed_k, t0,
             epsilon, compartments=None):
        """Copy a window's start into the buffers, with the scalars
        (seed_k, t0) and the step index at 0."""
        from .draw_kernel import device_scalars

        device = self.positions.device
        self.positions.copy_(positions)
        self.ids.copy_(ids)
        self.iter_exc.copy_(iter_exc)
        self.phases.copy_(phases)
        self.g.copy_(g_eff)
        self.scalars.copy_(device_scalars((seed_k, t0), device))
        self.step.zero_()
        if isinstance(self.epsilon, torch.Tensor):
            self.epsilon.copy_(epsilon)
        if self.compartments is not None:
            for mine, theirs in zip(self.compartments, compartments):
                mine.copy_(theirs)


def step_body(kind, spec, st, max_iter, blocks=1):
    """Run one time step on the :class:`ClassicState` ``st``, in place.

    Steps every spin (``stepping.step``: the step kernels on CUDA, the
    plain step functions on the CPU), then folds the step into ``st``: the
    phase product ``g[step] @ positions`` (the coefficients read through
    the device index; one (n_meas, 3) x (3, n / blocks) product per block
    of a sweep), iter_exc ``|=``, the exchange trackers (parity flips on
    odd transits; the spin dwells the whole step in the compartment it ends
    it in), the trajectory row; then the positions, and the scalars and the
    step index advance. Nothing here syncs the host on CUDA, so one call
    can be captured into a CUDA graph and replayed.
    """
    positions, exc, cross = stepping.step(
        kind, st.positions, spec, st.epsilon, max_iter, st.scalars[0],
        st.scalars[1], st.ids)
    g = st.g.index_select(0, st.step)[0]
    if blocks == 1:
        st.phases += g @ positions
    else:
        width = positions.shape[1] // blocks
        for b in range(blocks):
            cols = slice(b * width, (b + 1) * width)
            st.phases[:, cols] += g @ positions[:, cols].contiguous()
    st.iter_exc |= exc
    if st.compartments is not None:
        crossings, parity, intra_steps = st.compartments
        crossings += cross
        parity ^= (cross & 1).bool()
        intra_steps += parity.to(torch.int32)
    if st.trajectory is not None:
        st.trajectory.index_copy_(0, st.step, positions[None])
    st.positions.copy_(positions)
    st.scalars += st.advance
    st.step += 1


# Captured steps by id of their spec, then by window shape
# (engine/graphs.py).
_GRAPHS = {}


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
        Consecutive absolute time-step indices (they key the per-step
        streams, so a windowed run reproduces a single full one).
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

    Every step is one :func:`step_body`. On a CUDA device with
    ``config.classic_cuda_graph`` (the default) each step is a replay of
    one captured CUDA graph, kept per (spec, window shape) for the spec's
    ``graphs.GRAPHS_PER_SPEC`` most recent shapes, so no Python runs
    between the steps' kernels and nothing is read back within the window.
    Otherwise, and on the CPU, every step runs eagerly. Both give
    the same values bit for bit. The arguments are not modified.

    Returns
    -------
    (positions, phases, iter_exc), trajectory [, compartments]
        ``trajectory`` is (len(ts), 3, n) when ``collect_positions`` else
        None. With ``track="exchange"`` a third element holds the updated
        (crossings, parity, intra_steps).
    """
    from . import config

    if track not in (None, "exchange"):
        raise ValueError(f"Incorrect value ({track!r}) for track")
    if track == "exchange" and (compartments is None
                                or len(compartments) != 3):
        raise ValueError("track='exchange' needs compartments = (crossings, "
                         "parity, intra_steps)")
    ts = [int(t) for t in ts]
    if ts != list(range(ts[0], ts[0] + len(ts)) if ts else []):
        raise ValueError("ts must be consecutive time steps")
    require_full_fp32()
    n = positions.shape[1]
    device = positions.device
    if ids is None:
        ids = torch.arange(n, dtype=torch.int32, device=device)
    seed_k = int(seed32) ^ (FREE_SALT if kind == "free" else CLASSIC_SALT)
    compartments = compartments if track == "exchange" else None

    def make_state():
        return ClassicState.like(positions, phases, iter_exc, g_eff, epsilon,
                                 compartments,
                                 len(ts) if collect_positions else None)

    graphed = (device.type == "cuda" and config.classic_cuda_graph
               and len(ts) > 0)
    if graphed:
        eps_key = (tuple(epsilon.shape) if isinstance(epsilon, torch.Tensor)
                   else float(epsilon))
        entry = graphs.cached(_GRAPHS, spec, (
            kind, n, phases.shape[0], len(ts), str(positions.dtype), eps_key,
            int(max_iter), track, bool(collect_positions), blocks),
            make_state)
        entry.lock.acquire()
        st = entry.state
    else:
        st = make_state()
    try:
        st.load(positions, ids, iter_exc, phases, g_eff, seed_k,
                ts[0] if ts else 0, epsilon, compartments)

        def body():
            step_body(kind, spec, st, max_iter, blocks)

        if graphed:
            entry.run(body, len(ts))
        else:
            for _ in ts:
                body()
        out = [(st.positions, st.phases, st.iter_exc), st.trajectory]
        if track == "exchange":
            out.append(st.compartments)
        if graphed:
            # The static buffers serve the next window of this shape.
            out = [None if o is None else (
                tuple(t.clone() for t in o) if isinstance(o, tuple)
                else o.clone()) for o in out]
        return tuple(out)
    finally:
        if graphed:
            entry.lock.release()


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
