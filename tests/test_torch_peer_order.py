"""The order of a step across processes (parallel/peer.py ``StepOrder``),
simulated on the host: no card and no process group.

Each rank's stream is a queue of the operations that ``halo_windows_dist``
enqueues for the steps ``StepOrder`` hands out: stores of a flag, waits on a
flag, the push into the left rank's buffer, and the decode that reads the
rank's own buffer. The streams are interleaved at random (seeded), one
operation at a time, a wait running only once its flag holds. Checked in
every schedule: no push lands in a buffer whose previous use the left rank
is still reading (from its decode until its store of ``free`` two steps
later), no decode starts before its right neighbour's push of that step has
landed, and every stream runs to its end. A rank that runs one step fewer
must leave the others waiting for ever, and an order without one of its
waits must break a check, or the checks could not fail."""

import random

import pytest

from liquiddsp_tpu_torch.parallel.peer import N_BUFFERS, StepOrder

STEPS = 12
SCHEDULES = 200


def stream_ops(rank, world, steps=STEPS, drop=()):
    """The operations of ``rank``'s stream for ``steps`` steps; ``drop``
    names Step fields whose operation is left out (a broken order)."""
    order = StepOrder(rank > 0, rank < world - 1)
    ops = []
    for _ in range(steps):
        st = order.next()
        i = st.buf
        if st.release is not None and "release" not in drop:
            ops.append(("store", rank, "free", i, st.release))
        if st.wait_free is not None and "wait_free" not in drop:
            ops.append(("wait", rank - 1, "free", i, st.wait_free))
        ops.append(("push", st.n, i))
        if st.arrive is not None and "arrive" not in drop:
            ops.append(("store", rank - 1, "arrived", i, st.arrive))
        if st.wait_arrived is not None and "wait_arrived" not in drop:
            ops.append(("wait", rank, "arrived", i, st.wait_arrived))
        ops.append(("read", st.n, i))
    return ops


def simulate(streams, seed):
    """Run the streams interleaved at random; True when all end, False when
    every stream left waits on a flag that no operation left will store.
    Raises AssertionError on a push into a buffer in use or a decode
    before its push."""
    world = len(streams)
    rng = random.Random(seed)
    flags = [{"free": [0] * N_BUFFERS, "arrived": [0] * N_BUFFERS} for _ in range(world)]
    landed = [[None] * N_BUFFERS for _ in range(world)]  # the step whose push is in a buffer
    reading = [[None] * N_BUFFERS for _ in range(world)]  # the step that reads a buffer
    pos = [0] * world

    def ready(r):
        if pos[r] == len(streams[r]):
            return False
        op = streams[r][pos[r]]
        return op[0] != "wait" or flags[op[1]][op[2]][op[3]] >= op[4]

    while True:
        runnable = [r for r in range(world) if ready(r)]
        if not runnable:
            return all(pos[r] == len(streams[r]) for r in range(world))
        r = rng.choice(runnable)
        op = streams[r][pos[r]]
        pos[r] += 1
        kind = op[0]
        if kind == "store":
            _, owner, name, i, v = op
            assert v >= flags[owner][name][i], "a counter went down"
            flags[owner][name][i] = v
            if name == "free":
                reading[owner][i] = None  # the owner's use of two steps ago is over
        elif kind == "push" and r > 0:
            _, n, i = op
            assert reading[r - 1][i] is None, (
                f"rank {r}'s push of step {n} into buffer {i} while rank {r - 1} reads "
                f"its step {reading[r - 1][i]}")
            landed[r - 1][i] = n
        elif kind == "read" and r < world - 1:  # a buffer that the right rank pushes into
            _, n, i = op
            assert landed[r][i] == n, (
                f"rank {r} decodes step {n} from buffer {i}, which holds rank {r + 1}'s push "
                f"of step {landed[r][i]}")
            reading[r][i] = n


def test_step_order_values():
    """Step n takes buffer n % 2 for use n // 2 + 1; a rank stores and waits
    only for the neighbours it has."""
    mid = StepOrder(True, True)
    got = [mid.next() for _ in range(4)]
    assert [s.buf for s in got] == [0, 1, 0, 1]
    assert [s.use for s in got] == [1, 1, 2, 2]
    assert [s.release for s in got] == [0, 0, 1, 1]
    assert [s.wait_free for s in got] == [0, 0, 1, 1]
    assert [s.arrive for s in got] == [1, 1, 2, 2]
    assert [s.wait_arrived for s in got] == [1, 1, 2, 2]
    first, last = StepOrder(False, True).next(), StepOrder(True, False).next()
    assert first.wait_free is None and first.arrive is None
    assert first.release == 0 and first.wait_arrived == 1
    assert last.release is None and last.wait_arrived is None
    assert last.wait_free == 0 and last.arrive == 1


@pytest.mark.parametrize("world", [2, 3, 4])
def test_every_schedule_finishes_in_order(world):
    streams = [stream_ops(r, world) for r in range(world)]
    for seed in range(SCHEDULES):
        assert simulate(streams, seed), f"schedule {seed} deadlocked"


@pytest.mark.parametrize("world", [2, 3, 4])
def test_a_rank_that_skips_a_step_deadlocks(world):
    for skipper in range(world):
        streams = [stream_ops(r, world, STEPS - (r == skipper)) for r in range(world)]
        for seed in range(SCHEDULES // world):
            assert not simulate(streams, seed), f"rank {skipper} skipped a step unnoticed"


@pytest.mark.parametrize("drop, broken", [
    ("wait_free", "while rank"),  # a push into a buffer that is still read
    ("wait_arrived", "which holds"),  # a decode before the push
])
def test_the_checks_catch_an_order_without_a_wait(drop, broken):
    streams = [stream_ops(r, 3, drop=(drop,)) for r in range(3)]
    caught = []
    for seed in range(SCHEDULES):
        try:
            simulate(streams, seed)
        except AssertionError as e:
            caught.append(str(e))
    assert any(broken in e for e in caught), caught[:3]


@pytest.mark.parametrize("drop", ["release", "arrive"])
def test_an_order_without_a_store_deadlocks(drop):
    streams = [stream_ops(r, 3, drop=(drop,)) for r in range(3)]
    for seed in range(SCHEDULES // 4):
        assert not simulate(streams, seed)
