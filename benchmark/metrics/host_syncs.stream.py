"""Host waits for the stream in one warm request, its read-back included,
counted by torch's sync debug mode."""


def read(run):
    return run.syncs
