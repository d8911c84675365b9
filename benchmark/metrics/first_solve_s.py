"""Host clock around the first ``solve()`` in set-up (s): the solve stream's
plan and executor, the residual's ELL pattern, their upload and the first
refined solve (``api.py``'s caches)."""


def read(run):
    return run.setup["first_solve_s"]
