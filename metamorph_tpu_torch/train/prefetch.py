"""Background data prefetching: overlap host-side loading with device
compute.

`Prefetcher` (a copy of `metamorph_tpu/train/prefetch.py`) pulls items on a
thread into a bounded queue: enough where the producer's work leaves the
GIL (the native packer, copies). `ProcessPrefetcher` runs the producer in
a worker process, as the reference's DataLoader workers do
(`train.py:1037`): `train()` loads through it, because the recipe's loader
is Python (reading, decoding, tokenising, collating), and on a thread that
work holds the GIL that the thread launching the step's kernels waits for,
which lengthens a step of ~0.7 s by ~0.1 s on an H100."""

from __future__ import annotations

import mmap
import multiprocessing
import os
import pickle
import queue
import signal
import socket
import struct
import threading
import traceback
import weakref
from typing import Any, Callable, Iterator, Optional


class Prefetcher:
    """Wrap an iterator; pull items on a background thread into a bounded
    queue, optionally transforming them on the worker."""

    def __init__(self, it: Iterator, depth: int = 2,
                 transform: Optional[Callable[[Any], Any]] = None):
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._transform = transform
        self._done = object()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for item in self._it:
                if self._transform is not None:
                    item = self._transform(item)
                self._q.put(item)
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


POLL_S = 1.0   # how often a blocked side checks that the other is alive
_ALIGN = 64    # byte alignment of each array in a batch's memory file


def _dumps(kind: str, payload: Any, buffers: list) -> bytes:
    """Pickle protocol 5 with contiguous arrays out of band (into
    `buffers`); an exception that does not pickle goes as its traceback."""
    try:
        return pickle.dumps((kind, payload), 5, buffer_callback=buffers.append)
    except Exception:
        if kind != "error":
            raise
        buffers.clear()
        return pickle.dumps(("error", RuntimeError(
            "the data worker raised:\n" + "".join(
                traceback.format_exception(payload)))))


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _pack(kind: str, payload: Any) -> int:
    """A memory file holding the part count and sizes (int64), the pickle
    and its arrays, each part at an aligned offset."""
    buffers: list = []
    parts = [memoryview(_dumps(kind, payload, buffers))]
    parts += [b.raw() for b in buffers]
    sizes = [p.nbytes for p in parts]
    head = struct.pack(f"{len(sizes) + 1}q", len(sizes), *sizes)
    fd = os.memfd_create("mm_prefetch")
    try:
        total = _aligned(len(head)) + sum(map(_aligned, sizes))
        os.ftruncate(fd, total)
        with mmap.mmap(fd, total) as m:
            m[:len(head)] = head
            pos = _aligned(len(head))
            for part, n in zip(parts, sizes):
                m[pos:pos + n] = part
                pos += _aligned(n)
    except BaseException:
        os.close(fd)
        raise
    return fd


def _unpack(fd: int) -> tuple:
    """The (kind, payload) in a memory file: its arrays are views of a
    private (copy-on-write) mapping of it, freed with the last of them."""
    m = mmap.mmap(fd, os.fstat(fd).st_size, flags=mmap.MAP_PRIVATE,
                  prot=mmap.PROT_READ | mmap.PROT_WRITE)
    (count,) = struct.unpack_from("q", m)
    sizes = struct.unpack_from(f"{count}q", m, 8)
    view, pos, parts = memoryview(m), _aligned(8 * (count + 1)), []
    for n in sizes:
        parts.append(view[pos:pos + n])
        pos += _aligned(n)
    return pickle.loads(parts[0], buffers=parts[1:])


def _produce(it: Iterator, sock: socket.socket, slots, transform,
             parent: int) -> None:
    """The worker process: each item (transformed) into a memory file whose
    descriptor goes to the parent, once one of `slots` is free; then
    ("done",), or the error that ended the iteration."""
    # the parent handles interrupts and preemption, and stops the worker
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    signal.signal(signal.SIGTERM, signal.SIG_IGN)

    def send(kind, payload):
        while not slots.acquire(timeout=POLL_S):
            if os.getppid() != parent:          # the parent has gone
                os._exit(0)
        try:
            fd = _pack(kind, payload)
        except BaseException:
            slots.release()
            raise
        try:
            socket.send_fds(sock, [b"m"], [fd])
        except OSError:                         # the parent has gone
            os._exit(0)
        finally:
            os.close(fd)

    try:
        for item in it:
            send("item", item if transform is None else transform(item))
    except BaseException as e:  # surfaced on the consumer side
        send("error", e)
    else:
        send("done", None)


def _stop(proc, sock: socket.socket) -> None:
    if proc.is_alive():
        proc.kill()
    proc.join()
    sock.close()


class ProcessPrefetcher:
    """`Prefetcher` with the producer (the iterator and `transform`) in a
    forked worker process, at most `depth` items ahead. Each item comes
    back as a memory file (`memfd`) whose descriptor crosses a socket:
    its arrays (pickle protocol 5, out of band) are mapped, not copied,
    so receiving a batch costs the parent well under a millisecond, where
    a pipe's copies and unpickling of a 7 MB batch took ~20 ms of its
    thread. The worker is forked, as torch's DataLoader workers are on
    Linux: it takes the iterator as it is (its tokenizer, callables and
    resume position), which spawn would need to pickle, and the parent's
    copy does not advance, so carry what the parent needs in the items.
    Fork is sound only while the worker runs no CUDA and takes no lock
    another thread of the parent may hold: the recipe's loader runs
    numpy, PIL and the native packer. The worker ignores SIGINT and
    SIGTERM and ends when its parent does; one that dies makes
    `__next__` raise. `close` (or the parent's exit) stops it."""

    def __init__(self, it: Iterator, depth: int = 2,
                 transform: Optional[Callable[[Any], Any]] = None):
        ctx = multiprocessing.get_context("fork")
        self._sock, theirs = socket.socketpair(socket.AF_UNIX,
                                               socket.SOCK_SEQPACKET)
        self._slots = ctx.Semaphore(depth)
        self._proc = ctx.Process(
            target=_produce, daemon=True,
            args=(it, theirs, self._slots, transform, os.getpid()))
        self._proc.start()
        theirs.close()
        self._sock.settimeout(POLL_S)
        self._stop = weakref.finalize(self, _stop, self._proc, self._sock)
        self._ended = False

    def __iter__(self):
        return self

    def _recv(self) -> tuple:
        while True:
            try:
                _, fds, _, _ = socket.recv_fds(self._sock, 1, 1)
                break
            except TimeoutError:
                if not self._proc.is_alive():
                    raise self._died() from None
        if not fds:                 # the worker's end closed
            raise self._died()
        try:
            return _unpack(fds[0])
        finally:
            os.close(fds[0])
            self._slots.release()

    def _died(self) -> RuntimeError:
        self._proc.join(POLL_S)
        self.close()
        return RuntimeError(f"the data worker exited with code "
                            f"{self._proc.exitcode}")

    def __next__(self):
        if self._ended:
            raise StopIteration
        kind, payload = self._recv()
        if kind == "item":
            return payload
        self.close()
        if kind == "error":
            raise payload
        raise StopIteration

    def close(self) -> None:
        """Stops the worker (if it still runs) and waits for it."""
        self._ended = True
        self._stop()
