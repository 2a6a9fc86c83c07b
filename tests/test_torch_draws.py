"""The draw kernel's plain versions (engine/draw_kernel.py, engine/krng.py)
against the per-step krng draws and the JAX package's krng.

The CUDA kernel (csrc/krng_draw.cu) runs only on the card, where
``chip_smoke.py`` holds it to these plain versions; here its wrappers must
refuse CPU tensors. The epoch's directions must equal the stacked per-step
draws bit for bit (the same torch operators); against JAX they go through
another float32 cos/sin, held to the 2e-6 of tests/test_torch_krng.py.
Uniforms are integer words and an exact scaling: equal bit for bit to
element-wise calls and to JAX.
"""

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax.numpy as jnp

from disimpy_tpu.engine import krng as jkrng
from disimpy_tpu_torch.engine import draw_kernel, krng, rng

import torch_threads  # noqa: F401  (shares the cores among xdist workers)

SEED, T_BASE = -1234567, 2**31 - 3


@pytest.fixture(scope="module")
def ids():
    rand = np.random.RandomState(3).randint(
        -2**31, 2**31, size=2000, dtype=np.int64).astype(np.int32)
    return torch.from_numpy(
        np.concatenate(([0, -1, 2**31 - 1, -2**31], rand)).astype(np.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("J", [1, 2, 3, 4, 5])
def test_epoch_directions_equal_the_stacked_steps(ids, J, dtype):
    # T_BASE + s runs past 2**31: the step wraps modulo 2**32 in both.
    want = torch.stack([krng.unit_directions(SEED, T_BASE + s, ids, dtype)
                        for s in range(J)])
    for got in (krng.unit_directions_epoch(SEED, T_BASE, J, ids, dtype),
                draw_kernel.unit_directions_epoch(SEED, T_BASE, J, ids,
                                                  dtype)):
        assert got.dtype == dtype and got.shape == (J, 3, ids.shape[0])
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype, atol", [(torch.float32, 2e-6),
                                         (torch.float64, 1e-12)])
def test_epoch_directions_match_jax(ids, dtype, atol):
    got = draw_kernel.unit_directions_epoch(SEED, 40, 3, ids, dtype).numpy()
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.float64
    for s in range(3):
        want = np.asarray(jkrng.unit_directions(
            SEED, 40 + s, jnp.asarray(ids.numpy()), jdtype))
        # cos/sin of the same angle: torch and XLA differ by ~1 ulp.
        npt.assert_allclose(got[s], want, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gathered_per_spin_uniforms_equal_scalar_calls_and_jax(ids, dtype):
    rand = np.random.RandomState(4)
    idx = torch.from_numpy(rand.permutation(ids.shape[0])[:300])
    bounce = torch.from_numpy(rand.randint(0, 60, size=300).astype(np.int32))
    bounce[:2] = torch.tensor([0, 2**31 - 1], dtype=torch.int32)
    got = draw_kernel.bounce_uniform(SEED, 9, ids, bounce, idx, dtype)
    assert got.dtype == dtype and got.shape == (300,)
    one_by_one = torch.cat([
        krng.bounce_uniform(SEED, 9, ids[i:i + 1], int(b), dtype)
        for i, b in zip(idx.tolist(), bounce.tolist())])
    assert torch.equal(got, one_by_one)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.float64
    want = np.asarray(jkrng.bounce_uniform(
        SEED, 9, jnp.asarray(ids[idx].numpy()), jnp.asarray(bounce.numpy()),
        jdtype))
    npt.assert_array_equal(got.numpy(), want)
    # One bounce index for every spin, no gather.
    npt.assert_array_equal(
        draw_kernel.bounce_uniform(SEED, 9, ids, 5, dtype=dtype).numpy(),
        np.asarray(jkrng.bounce_uniform(SEED, 9, jnp.asarray(ids.numpy()), 5,
                                        jdtype)))


def test_device_scalars_equal_the_int_forms(ids):
    # 2**32 + 5 and -2**31 arrive as the int32 words the ints stand for.
    seed, t = 2**32 + 5, -2**31
    scal = draw_kernel.device_scalars((seed, t), "cpu")
    assert scal.dtype == torch.int32 and scal.tolist() == [5, -2**31]
    assert torch.equal(
        draw_kernel.unit_directions_epoch(scal[0], scal[1], 4, ids),
        draw_kernel.unit_directions_epoch(seed, t, 4, ids))
    bounce = torch.arange(ids.shape[0], dtype=torch.int32) % 7
    assert torch.equal(
        draw_kernel.bounce_uniform(scal[0], scal[1], ids, bounce),
        draw_kernel.bounce_uniform(seed, t, ids, bounce))


def test_classic_draws_route_through_the_draw_functions(ids):
    for dtype in (torch.float32, torch.float64):
        assert torch.equal(rng.step_directions(SEED, 17, ids, dtype),
                           krng.unit_directions(SEED, 17, ids, dtype))
        uniform = rng.bounce_uniforms(SEED, 17, ids, dtype)
        idx = torch.tensor([5, 0, 3])
        assert torch.equal(uniform(2), krng.bounce_uniform(SEED, 17, ids, 2,
                                                           dtype))
        assert torch.equal(uniform(torch.tensor([1, 2, 3]), idx),
                           krng.bounce_uniform(SEED, 17, ids[idx],
                                               torch.tensor([1, 2, 3]),
                                               dtype))


def test_kernel_wrappers_refuse_cpu_tensors(ids):
    with pytest.raises(ValueError, match="CUDA"):
        draw_kernel.directions_cuda(SEED, 0, 4, ids)
    with pytest.raises(ValueError, match="CUDA"):
        draw_kernel.uniforms_cuda(SEED, 0, ids, 0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        draw_kernel.unit_directions_epoch(SEED, 0, 4, ids.to("meta"))
