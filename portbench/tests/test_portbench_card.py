"""On the card: the program within each cell's limit and the control (the
reference in the precision below the configured one, in the program's
place) beyond it, on three seeds, at 65,536 spins and 30 steps of the
cell's own mesh and waveform (the benchmark's runs hold the full size)."""

import pytest
import torch

import run
from harness import stats, waveforms
from reference import walk

CELLS = ("cylinder.fused", "neuron.fused", "cylinder.classic-f64",
         "neuron.classic-f64")
SPINS = 65536
STEPS = 30
SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_program_within_and_control_beyond_the_limit(card, fresh_home, cell):
    from disimpy_tpu_torch import simulations, substrates

    _, _, traffic, limits, sizes, builder = run._cell(
        cell, {"traffic": {"n_t": STEPS, "n_walkers": SPINS}})
    v, f, kwargs = builder.build(sizes, traffic)
    g = waveforms.make(traffic)
    sub = substrates.mesh(v, f, quiet=True, **kwargs)
    dtype = getattr(torch, traffic["dtype"])
    control = limits["control"]
    common = (v, f, SPINS, traffic["diffusivity"], g, traffic["dt"])
    semantics = (kwargs["init_pos"], traffic["engine"], dtype)
    padding = kwargs.get("padding", (0.0, 0.0, 0.0))

    for seed in SEEDS:
        signal, positions = simulations.simulation(
            SPINS, traffic["diffusivity"], g, traffic["dt"], sub, seed=seed,
            dtype=traffic["dtype"], device="cuda", **traffic["simulation"])
        ref = walk.simulate(*common, seed, *semantics, device="cuda",
                            padding=padding)
        low = walk.simulate(*common, seed, *semantics,
                            dtype=getattr(torch, control["dtype"]),
                            device="cuda", padding=padding,
                            max_iter=control.get("max_iter", 1000))
        sound = stats.compared(signal, positions, ref, SPINS)
        assert all(sound[k] <= limits[k]["limit"] for k in sound)
        beyond = stats.compared(low.signal, low.positions, ref, SPINS)
        assert any(beyond[k] > limits[k]["limit"] for k in beyond)
