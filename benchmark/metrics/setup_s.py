"""Process start to the first timed step (s): imports, the kernels' build on
a checkout's first run, the inputs, ``analyse``, the first ``factor`` and
``solve``, and one warm step."""


def read(run):
    return run.setup["setup_s"]
