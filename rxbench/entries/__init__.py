"""Entries: one module a program entry, named by a traffic file's
``entry``. Each has ``slots``, ``shapes`` and ``reference_frames`` (plain
benchmark code) and ``Receiver``, which imports the program when it is built."""
