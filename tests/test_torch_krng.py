"""The port's torch threefry (engine/krng.py) against the JAX package's.

Words and permeability uniforms must be equal bit for bit (integer ops and
an exact int -> float scaling); unit directions go through float32 cos/sin,
whose torch and XLA implementations differ by an ulp: held to 2e-6.
"""

import numpy as np
import numpy.testing as npt
import pytest
import torch
from scipy.stats import kstest

import jax.numpy as jnp

from disimpy_tpu.engine import krng as jkrng
from disimpy_tpu_torch.engine import krng

import torch_threads  # noqa: F401  (shares the cores among xdist workers)

SEEDS = [0, 1, 123, -5, 2**31 - 1, -2**31]


def _u32(x):
    return int(np.array([x], dtype=np.uint32).view(np.int32)[0])


def _run_tf(ctr, key, rounds):
    x0, x1 = krng.threefry2x32(
        _u32(key[0]), _u32(key[1]), torch.tensor([_u32(ctr[0])], dtype=torch.int32),
        torch.tensor([_u32(ctr[1])], dtype=torch.int32), rounds=rounds,
    )
    return (
        int(x0.numpy().view(np.uint32)[0]),
        int(x1.numpy().view(np.uint32)[0]),
    )


def test_threefry2x32_known_answer_vectors():
    # Random123 kat_vectors (Salmon et al., SC'11), as in tests/test_fused.py.
    assert _run_tf((0, 0), (0, 0), 20) == (0x6B200159, 0x99BA4EFE)
    assert _run_tf(
        (0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), 20
    ) == (0x1CB996FC, 0xBB002BE7)
    assert _run_tf(
        (0x243F6A88, 0x85A308D3), (0x13198A2E, 0x03707344), 20
    ) == (0xC4923A9C, 0x483DF7A0)
    assert _run_tf((0, 0), (0, 0), 13) == (0x9D1C5EC6, 0x8BD50731)
    assert _run_tf(
        (0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), 13
    ) == (0xFD36D048, 0x2D17272C)


@pytest.fixture(scope="module")
def random_ids():
    rng = np.random.RandomState(0)
    return rng.randint(-2**31, 2**31, size=20000, dtype=np.int64).astype(
        np.int32)


@pytest.mark.parametrize("seed", SEEDS)
def test_words_and_uniforms_equal_jax(random_ids, seed):
    ids_t, ids_j = torch.from_numpy(random_ids), jnp.asarray(random_ids)
    for t in (0, 7, -3, 2**31 - 1):
        for draw in (0, 1, -1):
            a = krng.step_words(seed, t, ids_t, draw)
            b = jkrng.step_words(seed, t, ids_j, draw)
            for x, y in zip(a, b):
                npt.assert_array_equal(x.numpy(), np.asarray(y))
        for bounce in (0, 3, 999):
            npt.assert_array_equal(
                krng.bounce_uniform(seed, t, ids_t, bounce).numpy(),
                np.asarray(jkrng.bounce_uniform(seed, t, ids_j, bounce)),
            )
    # A per-spin tensor of bounce indices (the plain kernel's pass index).
    bounces = torch.from_numpy(random_ids % 17)
    npt.assert_array_equal(
        krng.bounce_uniform(seed, 5, ids_t, bounces).numpy(),
        np.asarray(jkrng.bounce_uniform(
            seed, 5, ids_j, jnp.asarray(random_ids % 17))),
    )


@pytest.mark.parametrize("seed", SEEDS)
def test_unit_directions_match_jax(random_ids, seed):
    d = krng.unit_directions(seed, 11, torch.from_numpy(random_ids)).numpy()
    d_j = np.asarray(jkrng.unit_directions(seed, 11, jnp.asarray(random_ids)))
    # float32 cos/sin of the same angle: torch and XLA differ by ~1 ulp.
    npt.assert_allclose(d, d_j, rtol=0, atol=2e-6)
    npt.assert_allclose(np.linalg.norm(d, axis=0), 1.0, atol=1e-6)


def test_kernel_rng_distributions():
    n = int(1e5)
    ids = torch.arange(n, dtype=torch.int32)
    d = krng.unit_directions(1, 0, ids).numpy()
    for comp in d:  # uniform marginals of a uniform unit vector
        assert kstest(comp, "uniform", args=(-1, 2)).pvalue > 1e-3
    u = krng.bounce_uniform(1, 0, ids, 0).numpy()
    assert kstest(u, "uniform").pvalue > 1e-3
    # Keyed by id: the draw for spin i is the same wherever it sits.
    npt.assert_array_equal(
        krng.unit_directions(1, 0, ids[::7]).numpy(), d[:, ::7]
    )
