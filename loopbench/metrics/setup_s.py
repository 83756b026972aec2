"""setup_s: from the start of the process's benchmark code (before torch
is imported) to the end of the warm calls: imports, the kernels' library
(built by the first run of a checkout), the frames rendered on the card and
pinned on the host, the entry built, the warm calls."""


def read(run):
    return run.setup_s
