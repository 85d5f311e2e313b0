"""keygen_s: set-up's span around the program's key generation (secret's residues, public key, relinearisation and rotation keys), ending in a device synchronise."""


def read(run):
    return run.setup_span("keygen")
