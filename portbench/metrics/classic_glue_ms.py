"""Device milliseconds per call of the classic time loop's work outside
the mesh step's kernels and K7: mostly the phase product, then the
signal's reduction and the step's copies."""

# The classic mesh step's kernels: K2's first pass and K9 on the halo
# layout, K10's sort, pass, second check and remainder on the per-cell one.
MESH_STEP = ("cell_pass", "scan_pass", "scatter_pass", "hit_pass",
             "relist_cells", "relist_scan", "relist_scatter", "later_pass",
             "bounce_pass", "finish_pass", "stencil_cells", "stencil_sums",
             "stencil_scan", "stencil_scatter", "stencil_pass",
             "stencil_recheck")
K7 = ("directions_kernel",)


def read(ctx):
    from harness.trace import kernel_id

    step = [s for name, (s, _) in ctx.kernels.items()
            if kernel_id(name) in MESH_STEP]
    if not step:
        return None
    rest = sum(s for name, (s, _) in ctx.kernels.items()
               if kernel_id(name) not in MESH_STEP + K7)
    return rest * 1e3 / len(ctx.calls)
