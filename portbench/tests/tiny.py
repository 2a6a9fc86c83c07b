"""A tiny cell for the CPU: the cells' own mesh, few spins and steps."""

TINY = {
    "traffic": {"n_walkers": 512, "n_t": 12, "compare_calls": 2,
                "trace_calls": 2},
    "sizes": {},
}
