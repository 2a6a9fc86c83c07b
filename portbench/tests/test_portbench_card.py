"""On the card: the program within each cell's limit and the control (the
reference in the precision below the configured one, in the program's
place) beyond it, on three seeds, at 65,536 spins and 30 steps of the
cell's own configuration and waveform (the benchmark's runs hold the full
size). The substrate and the reference come from the configuration's
builder, as in a benchmark run."""

import pytest
import torch

import run
from harness import stats, waveforms

CELLS = ("cylinder.fused", "neuron.fused", "cylinder.classic-f64",
         "neuron.classic-f64")
SPINS = 65536
STEPS = 30
SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_program_within_and_control_beyond_the_limit(card, fresh_home, cell):
    from disimpy_tpu_torch import simulations

    _, _, traffic, limits, sizes, builder = run._cell(
        cell, {"traffic": {"n_t": STEPS, "n_walkers": SPINS}})
    g = waveforms.make(traffic)
    sub = builder.substrate(sizes, traffic)
    control = limits["control"]

    def reference(seed, dtype=torch.float64, max_iter=1000):
        return builder.reference(
            sizes, traffic, seed, g,
            cfg_dtype=getattr(torch, traffic["dtype"]), dtype=dtype,
            device="cuda", work=False, max_iter=max_iter)

    for seed in SEEDS:
        signal, positions = simulations.simulation(
            SPINS, traffic["diffusivity"], g, traffic["dt"], sub, seed=seed,
            dtype=traffic["dtype"], device="cuda", **traffic["simulation"])
        ref = reference(seed)
        low = reference(seed, getattr(torch, control["dtype"]),
                        control.get("max_iter", 1000))
        sound = stats.compared(signal, positions, ref, SPINS)
        assert all(sound[k] <= limits[k]["limit"] for k in sound)
        beyond = stats.compared(low.signal, low.positions, ref, SPINS)
        assert any(beyond[k] > limits[k]["limit"] for k in beyond)
