"""Host clock around ``analyse()`` in set-up (s): ordering, elimination
tree, supernodes (``analyse/``, ``native/libspllt_symbolic.so``)."""


def read(run):
    return run.setup["analyse_s"]
