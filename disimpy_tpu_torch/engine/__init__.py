"""The torch compute core of disimpy_tpu_torch.

Layout
------
``krng``
    Counter-based Threefry2x32 streams keyed per (seed, step, spin id).
``geometry``
    The ray/triangle test used by mesh point seeding.
``core``
    Free-diffusion window, signal reduction, the float32 matmul guard.
``fused``
    The fused mesh engine: the table pack (host NumPy) and the epoch driver.
``fused_kernel``
    One epoch of mesh physics: the CUDA kernel's binding and its plain
    torch version.
``_build``
    Builds ``csrc/*.cu`` with nvcc at first use and loads it with ctypes.
``config``
    Engine selection.
"""
