"""The torch compute core of disimpy_tpu_torch.

Layout
------
``krng``
    Counter-based Threefry2x32 streams keyed per (seed, step, spin id).
``rng``
    The classic engine's draws (step directions, permeability uniforms)
    on krng streams.
``geometry``
    Ray/triangle test, reflection and crossing, in (n, 3) and (3, n)
    layouts.
``specs``
    The classic engine's substrate specs (free, sphere, cylinder,
    ellipsoid, mesh) and ``spec_from_numpy``.
``stepping``
    One time step per substrate kind: the analytic bounce loops and the
    per-bounce mesh step.
``core``
    The classic engine's time loop (``run_window``), signal reduction,
    the float32 matmul guard.
``mesh_accel``
    The classic mesh table pack (host NumPy) and its gather query.
``mesh_kernel``
    Nearest hit per spin on the halo layout: the CUDA kernel's binding and
    its plain torch version.
``fused``
    The fused mesh engine: the table pack (host NumPy) and the epoch driver.
``fused_kernel``
    One epoch of mesh physics: the CUDA kernel's binding and its plain
    torch version.
``_build``
    Builds ``csrc/*.cu`` with nvcc at first use and loads it with ctypes.
``config``
    Engine and query selection.
"""
