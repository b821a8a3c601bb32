"""The set-up time: process start to the first timed step (imports,
kernel builds and loads, the key, the table, the inputs, the warm-up)."""


def read(rec):
    return rec["setup_s"]
