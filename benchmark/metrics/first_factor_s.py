"""Host clock around the first ``factor()`` in set-up (s): the plans, the
executor's stream tables, their upload and the first factorization
(``api.py``'s caches), and on a checkout's first run the kernels' build."""


def read(run):
    return run.setup["first_factor_s"]
