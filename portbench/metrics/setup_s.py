"""setup_s: from the process's start to the end of the warm-up sorts (context, kernel builds, keys, encryption, captures)."""


def read(run):
    return run.setup_s
