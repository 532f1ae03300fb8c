"""`train/prefetch.py`'s `ProcessPrefetcher`, the worker process that
`train()` loads its batches through."""

import os
import time

import numpy as np
import pytest

from metamorph_tpu_torch.train.prefetch import ProcessPrefetcher


def _batches(n):
    for i in range(n):
        yield {"i": i, "x": np.full((64, 1024), i, dtype=np.float32),
               "strided": np.arange(40)[::4] + i, "none": None}


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_process_prefetcher_yields_in_order_from_another_process(depth):
    """Every item, in order and whole (a contiguous array goes as a
    mapped memory file, a strided one in the pickle), writable, the
    transform applied in the worker, then StopIteration (again after it)."""
    pf = ProcessPrefetcher(iter(_batches(7)), depth=depth,
                           transform=lambda b: (b, os.getpid()))
    got = list(pf)
    assert [b["i"] for b, _ in got] == list(range(7))
    assert all((b["x"] == b["i"]).all() and b["x"].shape == (64, 1024)
               and b["x"].flags.writeable and b["none"] is None
               and (b["strided"] == np.arange(0, 40, 4) + b["i"]).all()
               for b, _ in got)
    assert {pid for _, pid in got} != {os.getpid()}
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()


class _Unpicklable(Exception):
    def __init__(self):
        super().__init__("a lambda rides on this one")
        self.fn = lambda: None


def _failing(exc):
    yield 1
    raise exc


@pytest.mark.parametrize("exc, match", [
    (ValueError("bad row 3"), "bad row 3"),
    (_Unpicklable(), "a lambda rides on this one")])
def test_process_prefetcher_raises_the_workers_error(exc, match):
    """The worker's exception is raised in the parent after the items
    before it; one that does not pickle comes back as its traceback."""
    pf = ProcessPrefetcher(_failing(exc))
    assert next(pf) == 1
    with pytest.raises(Exception, match=match):
        next(pf)
    with pytest.raises(StopIteration):
        next(pf)


def test_process_prefetcher_names_a_worker_that_died():
    def dying():
        yield 1
        time.sleep(0.5)     # the item is sent before the worker dies
        os._exit(3)

    pf = ProcessPrefetcher(dying())
    assert next(pf) == 1
    with pytest.raises(RuntimeError, match="exited with code 3"):
        next(pf)
    pf.close()


def test_process_prefetcher_close_stops_a_blocked_worker():
    """A worker blocked on a full queue is stopped by `close`, and SIGTERM
    (the parent's preemption signal) does not stop it."""
    def endless():
        i = 0
        while True:
            yield i
            i += 1

    pf = ProcessPrefetcher(endless(), depth=2)
    assert next(pf) == 0
    proc = pf._proc
    os.kill(proc.pid, 15)
    time.sleep(0.2)
    assert proc.is_alive() and next(pf) == 1
    pf.close()
    assert not proc.is_alive() and proc.exitcode is not None
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()
