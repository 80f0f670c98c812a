"""setup_s (host clock): from the process's start to the window's first
query: imports, the CUDA context, the seeded table and models, the
program's loading, block upload, probes and each client's distinct queries
once. Moves: itself."""


def read(run):
    return run.setup_s
