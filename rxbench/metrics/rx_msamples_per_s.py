"""Samples of every chunk whose results reached the host in the window, over
the window, in millions a second."""


def read(record):
    if record.window_s <= 0:
        return None
    return record.n_chunks * record.chunk_samples / record.window_s / 1e6
