"""setup_s: seconds from process start to the window (imports, broker,
clients, kernels, warm-up, the cell's backlog)."""


def read(r):
    return r.setup_s
