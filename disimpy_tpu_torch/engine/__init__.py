"""The torch compute core of disimpy_tpu_torch.

Layout
------
``krng``
    Counter-based Threefry2x32 streams keyed per (seed, step, spin id).
``draw_kernel``
    An epoch's directions or a bounce pass's uniforms on krng streams: the
    CUDA kernel's binding; krng's functions are its plain versions.
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
    One time step per substrate kind: the plain analytic bounce loops and
    the per-bounce mesh step, and ``step``, which sends a step to the
    step kernels on CUDA.
``analytic_kernel``
    One classic step on an analytic substrate: the CUDA kernel's binding
    and its plain torch version.
``core``
    The classic engine's step body and time loop (``run_window``), which
    replays one captured CUDA graph per step; signal reduction, the
    float32 matmul guard.
``graphs``
    One step of a window captured as a CUDA graph and replayed, cached per
    spec and window shape, for both engines.
``mesh_accel``
    The classic mesh table pack (host NumPy) and its gather query.
``mesh_kernel``
    Nearest hit per spin on either mesh layout (K2 halo, K10 per-cell),
    and one whole classic mesh step on it: the CUDA kernels' bindings and
    their plain torch versions.
``fused``
    The fused mesh engine: the table pack (host NumPy), the epoch body and
    the window loop, which replays one captured CUDA graph per epoch.
``fused_kernel``
    One epoch of mesh physics: the CUDA kernel's binding and its plain
    torch version.
``launch_count``
    Launches of each CUDA kernel, counted where its wrapper launches it
    and, for a captured CUDA graph, at each replay.
``_build``
    Builds ``csrc/*.cu`` with nvcc at first use and loads it with ctypes.
``config``
    Engine and query selection, the fused engine's knobs and the two
    engines' CUDA graph switches.
"""
