"""Write the JAX package's outputs that the port's CPU tests compare against.

    JAX_PLATFORMS=cpu python scripts/make_torch_oracles.py

Runs, on the CPU, the JAX package calls whose compiles no test fixture
already pays for, and stores their outputs in
``tests/oracles/jax_reference_runs.npz`` (a few tens of kB). Each key is
prefixed by the run it comes from:

- ``fused_*``: ``disimpy_tpu.simulations.simulation`` with the fused engine
  in Pallas interpret mode (``config.use_fused = True, pallas_interpret =
  True``) on the 512-spin, 10-step, perm 0.5 closed-cylinder setup of
  ``tests/test_torch_simulation.py``, with ``exchange_stats=True``,
  ``relaxation=(25e-3, 150e-3)``, ``all_signals=True`` and
  ``final_pos=True``: per-spin signals, final positions, crossings and
  intra steps;
- ``sphere_*``: ``simulation`` on ``substrates.sphere(5e-6,
  perm_prob=0.5)`` (the classic engine), 1200 spins x 60 steps, dt 2e-4,
  b = 0, seed 5, ``exchange_stats=True`` (the setup of
  ``tests/test_permeability.py``): crossings and intra steps;
- ``sweep_sphere`` / ``sweep_cylinder``: ``disimpy_tpu.sweeps`` at 2000
  spins on the 100-step gradient of ``tests/test_sweeps.py``, sphere radii
  (2, 5, 10) um and cylinder radii (1, 4, 8) um along (0, 1, 1);
- ``nonperiodic_*``: the closed cylinder mesh, non-periodic with 2 um of
  padding (the ``mesh_misst_p0_pad1`` cell of ``PARITY_r05.json``) at the
  MISST step length: 512 "intra" starts from ``simulations._fill_mesh``
  (seed 123), the first epoch's anchor-sorted spin ids, and
  ``engine.fused.run_window_fused`` in Pallas interpret mode over 8 steps
  with a seeded random gradient (seed 17): final positions, phases,
  iter_exc, the effective epsilon and the gradient;
- ``neuron_*``: the start classifier (``_make_intra_classifier``) of the
  neuron mesh, non-periodic, n_sv 20^3, on 1,024 points near its surface
  (seeded vertices plus offsets of up to 1 um, seed 19), and its answers.

- ``epoch_*``: the Pallas epoch kernel (``pallas_fused.fused_epoch`` in
  interpret mode) on the periodic closed cylinder's default pack at the
  ~1.2 um step of ``tests/test_torch_fused.py``: 1,024 spins uniform in the
  voxel (``RandomState(0)``), anchor-sorted, with the JAX krng directions
  of steps 8..11 (seed 12345, epsilon 1e-4): the sorted inputs, and per
  permeability (0 and 0.5) the positions, iter_exc and transit counts;
- ``simrun_*``: the fused ``simulation()`` of ``tests/test_torch_simulation.py``
  (the ``fused_*`` setup without tracking or relaxation) at perm 0 and
  0.5, signals and final positions, and ``engine.fused.run_window_fused``
  called as ``simulation()`` calls it at perm 0: positions, phases and
  iter_exc;
- ``knob_*``: that ``simulation()`` again under each of the fused engine's
  two knobs, ``config.fused_resort_every = 2`` and ``config.fused_cell_steps
  = 2.0``, at perm 0 and 0.5: signals and final positions;
- ``query_pallas_*``: the Pallas nearest-hit kernel
  (``pallas_mesh.nearest_hit_pallas`` in interpret mode) on the 700-spin
  icosphere query of ``tests/test_torch_classic.py`` (``RandomState(1)``):
  distances and normals;
- ``percell_*``: ``simulation`` through the classic engine on the periodic
  closed cylinder (n_sv 10^3, "intra" starts) packed in the per-cell
  layout (``mesh_accel.HALO_BYTES_LIMIT = 0``), float64, 1,024 spins x 40
  steps of a 4-b PGSE gradient (seed 7, ``all_signals=True``): per-spin
  signals and final positions (``tests/test_torch_percell.py``).

The inputs are rebuilt the same way by ``tests/test_torch_exchange.py``,
``tests/test_torch_sweeps.py``, ``tests/test_torch_nonperiodic.py``,
``tests/test_torch_fused.py``, ``tests/test_torch_simulation.py``,
``tests/test_torch_knobs.py``, ``tests/test_torch_classic.py`` and
``tests/test_torch_percell.py``;
rerun this script when the JAX package or those setups change.
"""

import dataclasses
import os
import pathlib
import pickle
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from disimpy_tpu import gradients, meshes, simulations, substrates, sweeps  # noqa: E402
from disimpy_tpu.engine import (config, fused, krng, mesh_accel,  # noqa: E402
                                pallas_fused, pallas_mesh)

OUT = ROOT / "tests" / "oracles" / "jax_reference_runs.npz"
D = 2e-9

# The fused setup (tests/test_torch_simulation.py).
FUSED_SPINS, FUSED_STEPS, FUSED_SEED, FUSED_DT = 512, 10, 3, 1.2e-4
RELAXATION = (25e-3, 150e-3)
# The analytic setup (tests/test_permeability.py).
SPHERE_SPINS, SPHERE_STEPS, SPHERE_SEED = 1200, 60, 5
# The sweeps (tests/test_sweeps.py gradient, more spins).
SWEEP_SPINS = 2000
SPHERE_RADII = np.array([2e-6, 5e-6, 10e-6])
CYLINDER_RADII = np.array([1e-6, 4e-6, 8e-6])
ORIENTATION = np.array([0.0, 1.0, 1.0])
# The non-periodic padded closed cylinder (tests/test_torch_nonperiodic.py).
NP_SPINS, NP_STEPS, NP_MEAS, NP_SEED = 512, 8, 4, 123
NP_DT = 70e-3 / 999  # the MISST protocol's step duration
NP_PADDING = 2e-6
# The neuron classifier points (tests/test_torch_nonperiodic.py).
NEURON_POINTS, NEURON_SEED = 1024, 19
# The epoch kernel case (tests/test_torch_fused.py).
EPOCH_SPINS, EPOCH_SEED, EPOCH_T_BASE, EPOCH_EPS = 1024, 12345, 8, 1e-4
EPOCH_STEP = float(np.sqrt(6 * D * 1.2e-4))
# The fused engine's knobs (tests/test_torch_knobs.py): name -> (J, width).
KNOBS = {"J2": (2, None), "w2": (4, 2.0)}
# The nearest-hit query (tests/test_torch_classic.py).
QUERY_SPINS, QUERY_STEP = 700, float(np.sqrt(6 * D * 8e-5))
# The per-cell layout's whole run (tests/test_torch_percell.py).
PERCELL_SPINS, PERCELL_STEPS, PERCELL_SEED = 1024, 40, 7
PERCELL_BVALS = np.array([0.0, 1e9, 2e9, 4e9])


def nonperiodic_cylinder(mod, mesh, init_pos="intra"):
    """The mesh_misst_p0_pad1_nsv10x10x10 substrate of module ``mod``."""
    return mod.mesh(mesh["vertices"], mesh["faces"], False,
                    padding=np.full(3, NP_PADDING), init_pos=init_pos,
                    n_sv=np.array([10, 10, 10]), quiet=True)


def nonperiodic_gradient():
    """(NP_STEPS, NP_MEAS, 3) phase coefficients per step-length unit."""
    return np.random.RandomState(17).normal(
        scale=0.05, size=(NP_STEPS, NP_MEAS, 3)).astype(np.float32)


def neuron_points(substrate):
    """Seeded points within 1 um of the neuron mesh's vertices."""
    rng = np.random.RandomState(NEURON_SEED)
    vertices = np.asarray(substrate.vertices)[:-8]  # no voxel corners
    pick = rng.randint(0, len(vertices), NEURON_POINTS)
    return vertices[pick] + rng.uniform(-1e-6, 1e-6, (NEURON_POINTS, 3))


def nonperiodic_run(mesh):
    """Starts, first-epoch sorted ids and the fused window of the
    non-periodic padded closed cylinder (JAX, Pallas interpret mode)."""
    sub = nonperiodic_cylinder(substrates, mesh)
    starts = simulations._fill_mesh(NP_SPINS, sub, True, NP_SEED)
    step_l = np.sqrt(6 * D * NP_DT)
    spec = fused.pack_fused(sub, 1 / step_l, n_hint=float(NP_SPINS))
    pos = jnp.asarray(starts.T * (1.0 / step_l), jnp.float32)
    ids = jnp.arange(NP_SPINS, dtype=jnp.int32)
    cell = fused._cell_keys(spec, pos)[0]
    ids_s = lax.sort((cell, ids), num_keys=1)[1]
    eps = simulations._effective_epsilon(
        1e-13, 1 / step_l, float(np.max(sub.voxel_size)) / step_l, NP_STEPS,
        jnp.float32, True)
    g_eff = nonperiodic_gradient()
    try:
        config.pallas_interpret = True
        (p, ph, exc), _ = fused.run_window_fused(
            spec, pos, jnp.zeros((NP_MEAS, NP_SPINS), jnp.float32),
            jnp.zeros(NP_SPINS, bool), jnp.asarray(g_eff),
            jnp.arange(0, NP_STEPS), jnp.asarray(NP_SEED, jnp.int32),
            jnp.asarray(eps, jnp.float32), jnp.asarray(1000, jnp.int32),
            interpret=True,
        )
    finally:
        config.pallas_interpret = False
    return dict(nonperiodic_starts=starts, nonperiodic_ids=ids_s,
                nonperiodic_g_eff=g_eff, nonperiodic_eps=np.float64(eps),
                nonperiodic_pos=p, nonperiodic_phases=ph,
                nonperiodic_iter_exc=exc)


def epoch_run(mesh):
    """The Pallas epoch kernel in interpret mode on 1,024 anchor-sorted
    spins of the periodic closed cylinder's default pack, at perm 0 and
    0.5: the sorted inputs and the kernel's outputs."""
    import tempfile

    sub = substrates.mesh(mesh["vertices"], mesh["faces"], True,
                          n_sv=np.array([10, 10, 10]), quiet=True)
    with tempfile.TemporaryDirectory() as tmp:
        spec = fused.pack_fused(sub, 1 / EPOCH_STEP,
                                cache_path=os.path.join(tmp, "cyl.pkl"))
    n, J = EPOCH_SPINS, spec.resort_every
    voxel = np.asarray(spec.voxel_size)
    pos = jnp.asarray((np.random.RandomState(0).random_sample((3, n))
                       * voxel[:, None]).astype(np.float32))
    cell, start, packed, packed2, shiftvox = fused._cell_keys(spec, pos)
    ids = jnp.arange(n, dtype=jnp.int32)
    cell_s, order = lax.sort((cell, ids), num_keys=1)
    n1n2 = spec.n_sv[1] * spec.n_sv[2]
    cxi = cell_s // n1n2
    cyi = (cell_s - cxi * n1n2) // spec.n_sv[2]
    czi = cell_s - cxi * n1n2 - cyi * spec.n_sv[2]
    inputs = dict(
        pos_s=(pos - shiftvox)[:, order], ids_s=order,
        dirs=jnp.stack([krng.unit_directions(EPOCH_SEED, EPOCH_T_BASE + s,
                                             order) for s in range(J)]),
        start_s=start[order], packed_s=packed[order],
        packed2_s=packed2[order],
        corner_s=(jnp.stack((cxi, cyi, czi)).astype(jnp.float32)
                  * spec.sv_width[:, None]),
    )
    out = {f"epoch_{k}": v for k, v in inputs.items()}
    for perm, tag in ((0.0, "p0"), (0.5, "p05")):
        pspec = dataclasses.replace(
            spec, perm_prob=jnp.asarray(np.float32(perm)))
        p, exc, cross = pallas_fused.fused_epoch(
            pspec, *(inputs[k] for k in ("pos_s", "dirs", "ids_s", "start_s",
                                         "packed_s", "packed2_s")),
            fused._run_ends(cell_s), inputs["corner_s"], EPOCH_T_BASE, J,
            EPOCH_SEED, EPOCH_EPS, 1000, interpret=True,
        )
        out.update({f"epoch_pos_{tag}": p, f"epoch_iter_exc_{tag}": exc,
                    f"epoch_cross_{tag}": cross})
    return out


def fused_substrate(mesh, start, perm):
    """The periodic closed cylinder seeded at ``start``."""
    return substrates.mesh(mesh["vertices"], mesh["faces"], True,
                           init_pos=start, perm_prob=perm,
                           n_sv=np.array([10, 10, 10]), quiet=True)


def simulation_runs(mesh, start):
    """The fused simulation() of tests/test_torch_simulation.py at perm 0
    and 0.5, at the default knobs and under each of KNOBS, and the window
    it runs at perm 0, all in Pallas interpret mode."""
    out = {}
    gradient = fused_gradient()
    try:
        config.use_fused = True
        config.pallas_interpret = True
        for name, (J, width) in [("default", (4, None))] + list(KNOBS.items()):
            config.fused_resort_every, config.fused_cell_steps = J, width
            for perm, tag in ((0.0, "p0"), (0.5, "p05")):
                signals, pos = simulations.simulation(
                    FUSED_SPINS, D, gradient, FUSED_DT,
                    fused_substrate(mesh, start, perm), seed=FUSED_SEED,
                    final_pos=True, quiet=True)
                prefix = "simrun" if name == "default" else f"knob_{name}"
                out[f"{prefix}_signals_{tag}"] = signals
                out[f"{prefix}_pos_{tag}"] = pos
        config.fused_resort_every, config.fused_cell_steps = 4, None
        # The window itself, called as simulation() calls it (the same
        # shapes and static arguments).
        step_l = np.sqrt(6 * D * FUSED_DT)
        sub = fused_substrate(mesh, start, 0.0)
        spec = fused.pack_fused(sub, 1 / step_l, n_hint=float(FUSED_SPINS))
        g_eff = (gradients.GAMMA * FUSED_DT * step_l) * np.transpose(
            gradient, (1, 0, 2))
        eps = simulations._effective_epsilon(
            1e-13, 1 / step_l, float(np.max(sub.voxel_size)) / step_l,
            FUSED_STEPS, jnp.float32, False)
        (p, ph, exc), _ = fused.run_window_fused(
            spec, jnp.asarray(start.T * (1.0 / step_l), jnp.float32),
            jnp.zeros((len(gradient), FUSED_SPINS), jnp.float32),
            jnp.zeros(FUSED_SPINS, bool), jnp.asarray(g_eff, jnp.float32),
            jnp.arange(0, FUSED_STEPS), jnp.asarray(FUSED_SEED, jnp.int32),
            jnp.asarray(eps, jnp.float32), jnp.asarray(1000, jnp.int32),
            interpret=True, track=False, compartments=None, ablate=0,
            runtime_level=True, count_units=False, fold_unroll=2,
            contig=True, blkfast=False, align=False, passgate=False,
        )
        out.update(window_positions=p, window_phases=ph, window_iter_exc=exc)
    finally:
        config.use_fused = None
        config.pallas_interpret = False
        config.fused_resort_every, config.fused_cell_steps = 4, None
    return out


def query_run():
    """The Pallas nearest-hit kernel in interpret mode on the 700-spin
    icosphere query of tests/test_torch_classic.py."""
    vertices, faces = meshes.icosphere(radius=5e-6, subdivisions=2)
    sub = substrates.mesh(vertices, faces, True, n_sv=np.array([4, 4, 4]),
                          quiet=True)
    rng = np.random.RandomState(1)
    voxel = np.asarray(sub.voxel_size) / QUERY_STEP
    r0 = (rng.random_sample((QUERY_SPINS, 3)) * 1.4 - 0.2) * voxel
    direction = rng.standard_normal((QUERY_SPINS, 3))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    rem = rng.random_sample(QUERY_SPINS)
    spec = mesh_accel.pack_mesh(sub, 1 / QUERY_STEP, jnp.float32)
    d, normal = pallas_mesh.nearest_hit_pallas(
        spec, *(jnp.asarray(x, jnp.float32) for x in (r0, direction, rem)),
        pallas_mesh.pallas_table(spec), interpret=True)
    return dict(query_pallas_d=d, query_pallas_n=normal)


def percell_gradient():
    """The per-cell run's PGSE gradient (delta 1 ms, Delta 2 ms, along x)."""
    return gradients.pgse(1e-3, 2e-3, PERCELL_STEPS, PERCELL_BVALS,
                          np.tile([1.0, 0.0, 0.0], (len(PERCELL_BVALS), 1)))


def percell_run(mesh):
    """The classic engine on the periodic closed cylinder's per-cell pack
    (the halo table limited away), float64."""
    gradient, dt = percell_gradient()
    limit = mesh_accel.HALO_BYTES_LIMIT
    try:
        mesh_accel.HALO_BYTES_LIMIT = 0
        sub = substrates.mesh(mesh["vertices"], mesh["faces"], True,
                              init_pos="intra", n_sv=np.array([10, 10, 10]),
                              quiet=True)
        signals, pos = simulations.simulation(
            PERCELL_SPINS, D, gradient, dt, sub, seed=PERCELL_SEED,
            dtype="float64", all_signals=True, final_pos=True, quiet=True)
    finally:
        mesh_accel.HALO_BYTES_LIMIT = limit
    return dict(percell_signals=signals, percell_pos=pos)


def fused_gradient():
    """The 4-b PGSE gradient of tests/test_torch_simulation.py."""
    bs = np.linspace(1, 3e9, 4)
    gradient = np.zeros((1, 700, 3))
    gradient[0, 1:300, 0] = 1
    gradient[0, -300:-1, 0] = -1
    gradient = np.concatenate([gradient for _ in bs], axis=0)
    gradient, _ = gradients.interpolate_gradient(gradient, 70e-3 / 699,
                                                 FUSED_STEPS)
    return gradients.set_b(gradient, FUSED_DT, bs)


def sweep_gradient(n_t=100):
    """The gradient of tests/test_sweeps.py."""
    gradient = np.zeros((1, 100, 3))
    gradient[0, 1:11, 0] = 1
    gradient[0, -11:-1, 0] = -1
    return gradients.interpolate_gradient(gradient, 80e-3 / 99, n_t)


def main():
    out = {}
    with open(ROOT / "tests" / "oracles" / "cylinder_mesh_closed.pkl",
              "rb") as f:
        mesh = pickle.load(f)
    kw = dict(n_sv=np.array([10, 10, 10]), quiet=True)
    start = simulations._fill_mesh(
        FUSED_SPINS, substrates.mesh(mesh["vertices"], mesh["faces"], True,
                                     **kw), True, 5)
    sub = substrates.mesh(mesh["vertices"], mesh["faces"], True,
                          init_pos=start, perm_prob=0.5, **kw)
    try:
        config.use_fused = True
        config.pallas_interpret = True
        signals, pos, stats = simulations.simulation(
            FUSED_SPINS, D, fused_gradient(), FUSED_DT, sub, seed=FUSED_SEED,
            final_pos=True, all_signals=True, quiet=True,
            relaxation=RELAXATION, exchange_stats=True,
        )
    finally:
        config.use_fused = None
        config.pallas_interpret = False
    out.update(fused_signals=signals, fused_pos=pos,
               fused_crossings=stats["crossings"],
               fused_intra_steps=stats["intra_steps"])

    _, stats = simulations.simulation(
        SPHERE_SPINS, D, np.zeros((1, SPHERE_STEPS, 3)), 2e-4,
        substrates.sphere(5e-6, perm_prob=0.5), quiet=True, seed=SPHERE_SEED,
        exchange_stats=True,
    )
    out.update(sphere_crossings=stats["crossings"],
               sphere_intra_steps=stats["intra_steps"])

    gradient, dt = sweep_gradient()
    out["sweep_sphere"] = sweeps.sweep_sphere_radii(
        SWEEP_SPINS, D, gradient, dt, SPHERE_RADII)
    out["sweep_cylinder"] = sweeps.sweep_cylinder_radii(
        SWEEP_SPINS, D, gradient, dt, CYLINDER_RADII,
        orientation=ORIENTATION)

    out.update(nonperiodic_run(mesh))
    out.update(epoch_run(mesh))
    out.update(simulation_runs(mesh, start))
    out.update(query_run())
    out.update(percell_run(mesh))

    with open(ROOT / "tests" / "oracles" / "neuron-model.pkl", "rb") as f:
        neuron = pickle.load(f)
    sub = substrates.mesh(neuron["vertices"], neuron["faces"], False,
                          n_sv=np.array([20, 20, 20]), quiet=True)
    points = neuron_points(sub)
    out.update(neuron_points=points,
               neuron_inside=simulations._make_intra_classifier(sub)(points))

    np.savez_compressed(OUT, **{k: np.asarray(v) for k, v in out.items()})
    print(f"{OUT.relative_to(ROOT)}: "
          + ", ".join(f"{k} {np.asarray(v).shape}" for k, v in out.items()))


if __name__ == "__main__":
    main()
