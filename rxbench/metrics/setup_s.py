"""Seconds from the start of the run's process to the start of the window."""


def read(record):
    return record.setup_s
