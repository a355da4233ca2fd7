"""Set-up: from the process's start to the first timed wave or step
(weights from the seed, the engine or train step built, the warm-up)."""


def read(record, ctx):
    return record["setup_s"]
