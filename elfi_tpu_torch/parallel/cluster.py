"""Elastic TCP cluster backend (counterpart of
:mod:`elfi_tpu.parallel.cluster`): an externally managed worker farm.

The master (this backend) listens on a TCP socket
(:mod:`multiprocessing.connection`: pickle transport and HMAC
authentication) and any number of workers -- started whenever, on any
machine that reaches the master and has the package -- connect and pull
batch tasks::

    # master
    et.set_client(et.ClusterBackend())
    print(et.get_client().address)           # "host:port/authkey-hex"

    # each worker, started and stopped at any time
    python -m elfi_tpu_torch.worker HOST:PORT/AUTHKEY

Every master makes its own random authkey (the HMAC secret of
:mod:`multiprocessing.connection`) and hands it out in ``.address``, so no
well-known key lets a third party reach the unpickling listener.

A batch is a pure function of (seed, batch index), so the tasks of a
worker that disconnects are reassigned, the tasks of a hung worker are
reclaimed after ``task_timeout`` seconds (the worker is quarantined, not
dropped), late workers receive queued tasks at once, and with no worker
attached the master computes the batch itself, on its own program's
device: on the card, a kernel graph launches its kernel there.
``num_cores`` follows the number of live workers.

A program ships to each worker once per ``cache_key``; later tasks name
it by key.  Workers compute on their CPU by design, as the JAX package's
do: a worker compiles the program it is sent for the CPU, so device nodes
draw CPU streams there, and its numpy outputs are copied onto the
submitting program's device when the master reads them.
"""

from __future__ import annotations

import logging
import secrets
import threading
import time
from collections import OrderedDict
from multiprocessing.connection import Client as _ConnClient, Listener

from .backends import (BackendBase, _Thunk, _run_host_task, _to_device,
                       _to_host)

__all__ = ["ClusterBackend", "worker_main", "parse_address"]

logger = logging.getLogger(__name__)


def parse_address(spec):
    """Parse a ``HOST:PORT[/AUTHKEY-hex]`` handout string into
    ``((host, port), authkey_bytes)``."""
    if "/" in spec:
        hostport, keyhex = spec.split("/", 1)
        authkey = bytes.fromhex(keyhex)
    else:
        hostport, authkey = spec, None
    host, port = hostport.rsplit(":", 1)
    return (host, int(port)), authkey


class _Worker:
    def __init__(self, conn):
        self.conn = conn
        self.inflight = set()   # task ids assigned and not yet returned
        self.shipped = set()    # program keys this worker already holds
        self.reclaimed = set()  # overdue task ids requeued elsewhere


class _Task:
    def __init__(self, program, seed, batch_index, overrides, batch_size):
        self.program = program
        self.seed = seed
        self.batch_index = batch_index
        self.overrides = overrides
        self.batch_size = batch_size
        self.result = None
        self.error = None
        self.done = False
        self.worker = None
        self.assigned_at = None


class ClusterBackend(BackendBase):
    """Task farm over externally launched TCP workers (elastic).  ``device``
    is the master's: where a batch computed locally runs and where
    workers' outputs are copied (None: the current CUDA device)."""

    def __init__(self, address=("127.0.0.1", 0), authkey=None,
                 local_fallback=True, task_timeout=600, device=None):
        super().__init__(device)
        self._queue = []                 # task ids waiting for a worker
        self._workers = []
        self._joined = []                # connections accepted by the thread
        self._lock = threading.Lock()
        self.local_fallback = local_fallback
        self.task_timeout = task_timeout
        self.programs_shipped = 0        # sends that carried a program
        self._authkey = authkey if authkey is not None \
            else secrets.token_bytes(16)
        self._listener = Listener(tuple(address), authkey=self._authkey)
        self._accepting = True
        self._acceptor = threading.Thread(target=self._accept_loop,
                                          daemon=True)
        self._acceptor.start()

    @property
    def address(self):
        """Worker handout string ``host:port/authkey-hex``: pass it to
        ``python -m elfi_tpu_torch.worker``."""
        host, port = self._listener.address
        return f"{host}:{port}/{self._authkey.hex()}"

    @property
    def num_cores(self):
        self._absorb_joined()
        return max(2, len(self._workers))

    # -- connections -------------------------------------------------------------
    def _accept_loop(self):
        # the acceptor thread only accepts; all connection I/O happens on
        # the caller's thread (Connection objects are not thread-safe)
        while self._accepting:
            try:
                conn = self._listener.accept()
            except (OSError, EOFError):
                break
            except Exception:  # noqa: BLE001  a failed HMAC challenge
                continue
            with self._lock:
                self._joined.append(conn)

    def _absorb_joined(self):
        with self._lock:
            fresh, self._joined = self._joined, []
        for conn in fresh:
            self._workers.append(_Worker(conn))

    def _drop_worker(self, worker):
        """A worker died: requeue its in-flight tasks (a batch replays
        exactly)."""
        try:
            worker.conn.close()
        except OSError:
            pass
        if worker in self._workers:
            self._workers.remove(worker)
        for tid in worker.inflight - worker.reclaimed:
            # reclaimed ids were already requeued by _reclaim_overdue
            task = self._tasks.get(tid)
            if task is not None and not task.done:
                task.worker = None
                task.assigned_at = None
                self._queue.append(tid)

    # -- tasks -------------------------------------------------------------------
    def submit(self, program, seed, batch_index, overrides, batch_size):
        tid = self._next
        self._next += 1
        task = _Task(program, seed, batch_index, _to_host(overrides),
                     batch_size)
        self._tasks[tid] = task
        self._queue.append(tid)
        self._pump()
        return tid

    def _send_task(self, worker, tid, task):
        """Send a task; the program rides along only the first time this
        worker sees its key."""
        pkey = task.program.cache_key
        program = None if pkey in worker.shipped else task.program
        worker.conn.send(("task", tid, pkey, program, task.seed,
                          task.batch_index, task.overrides,
                          task.batch_size))
        if program is not None:
            worker.shipped.add(pkey)
            self.programs_shipped += 1

    def _pump(self):
        """Assign queued tasks to idle workers and drain results; all
        socket I/O happens here, on the calling thread."""
        self._absorb_joined()
        for worker in list(self._workers):
            try:
                while worker.conn.poll(0):
                    kind, tid, value = worker.conn.recv()
                    worker.inflight.discard(tid)
                    worker.reclaimed.discard(tid)
                    task = self._tasks.get(tid)
                    if task is None:
                        continue
                    if kind == "result":
                        task.result = value
                        task.done = True
                    elif kind == "noprog":
                        # the worker evicted this key after it was marked
                        # shipped: requeue, so the next send carries the
                        # program -- only while this worker owns the
                        # assignment, or a late reply would queue it twice
                        worker.shipped.discard(value)
                        if task.worker is worker and not task.done:
                            task.worker = None
                            task.assigned_at = None
                            self._queue.append(tid)
                    elif task.worker is worker and not task.done:
                        # an error of a superseded assignment is ignored:
                        # the replayed run decides the outcome
                        task.error = RuntimeError(
                            f"cluster worker failed: {value}")
                        task.done = True
            except (EOFError, OSError):
                self._drop_worker(worker)
        idle = [w for w in self._workers if not w.inflight]
        while self._queue and idle:
            tid = self._queue.pop(0)
            task = self._tasks.get(tid)
            if task is None or task.done:
                continue
            worker = idle.pop(0)
            try:
                self._send_task(worker, tid, task)
                worker.inflight.add(tid)
                task.worker = worker
                task.assigned_at = time.monotonic()
            except (OSError, ValueError, EOFError):
                self._drop_worker(worker)
                self._queue.insert(0, tid)

    def _reclaim_overdue(self):
        """Requeue the tasks of a worker past ``task_timeout``.  The worker
        is quarantined, not dropped: its connection stays open, and when a
        slow worker finally replies it rejoins the idle pool.  Dropping it
        would destroy every worker in turn whenever a batch legitimately
        outlives the deadline."""
        if self.task_timeout is None:
            return
        now = time.monotonic()
        for worker in list(self._workers):
            overdue = [tid for tid in worker.inflight - worker.reclaimed
                       if (t := self._tasks.get(tid)) is not None
                       and not t.done and t.assigned_at is not None
                       and now - t.assigned_at > self.task_timeout]
            if overdue:
                logger.warning(
                    "cluster worker unresponsive for >%ss on task(s) %s; "
                    "quarantining it and replaying deterministically",
                    self.task_timeout, overdue)
                for tid in overdue:
                    worker.reclaimed.add(tid)
                    task = self._tasks[tid]
                    task.worker = None
                    task.assigned_at = None
                    self._queue.append(tid)

    def _run_local(self, task):
        """Compute a batch here, on the master's program's device."""
        task.result = task.program.run(task.seed, task.batch_index,
                                       task.overrides, task.batch_size)
        task.done = True

    def is_ready(self, task_id):
        if isinstance(self._tasks.get(task_id), _Thunk):
            return True
        self._pump()
        task = self._tasks.get(task_id)
        return task is not None and task.done

    def get_result(self, task_id):
        # the task stays registered while we wait: _pump matches incoming
        # results against self._tasks by id
        task = self._tasks[task_id]
        if isinstance(task, _Thunk):
            return super().get_result(task_id)
        local_after = time.monotonic() + 0.05
        while not task.done:
            self._pump()
            if task.done:
                break
            self._reclaim_overdue()
            responsive = [w for w in self._workers if not w.reclaimed]
            if (self.local_fallback and not responsive
                    and task.worker is None
                    and time.monotonic() > local_after):
                # nobody attached, or everyone quarantined
                try:
                    self._queue.remove(task_id)
                except ValueError:
                    pass
                try:
                    self._run_local(task)
                except Exception as e:  # noqa: BLE001  raised below
                    task.error, task.done = e, True
                break
            time.sleep(0.002)
        self._tasks.pop(task_id, None)
        if task.error is not None:
            raise task.error
        return _to_device(task.result, task.program.device)

    def remove_task(self, task_id):
        task = self._tasks.pop(task_id, None)
        try:
            self._queue.remove(task_id)
        except ValueError:
            pass
        # a worker still computing the cancelled batch must not count as
        # responsive and busy forever: marking the assignment reclaimed
        # lets local fallback run, and the worker rejoins the idle pool
        # if it ever replies
        worker = getattr(task, "worker", None)
        if worker is not None:
            worker.reclaimed.add(task_id)

    def close(self):
        self._accepting = False
        # closing the listener does not interrupt a blocked accept(): poke
        # it with a throwaway connection so the acceptor thread exits
        try:
            _ConnClient(self._listener.address,
                        authkey=self._authkey).close()
        except Exception:  # noqa: BLE001  the acceptor may be gone already
            pass
        self._acceptor.join(timeout=2)
        try:
            self._listener.close()
        except OSError:
            pass
        for worker in self._workers:
            try:
                worker.conn.send(("stop",))
            except (OSError, ValueError):
                pass
            try:
                worker.conn.close()
            except OSError:
                pass
        self._workers.clear()


def worker_main(address, authkey=None, program_cache_size=32):
    """Worker loop: connect to the master and run batch tasks on this
    process's CPU until a stop message or a dropped connection.  Entry
    point: ``python -m elfi_tpu_torch.worker HOST:PORT/AUTHKEY``.

    Programs arrive once per key and are kept in an LRU of
    ``program_cache_size``.  A task naming a key this worker has evicted
    is answered with ``("noprog", tid, key)``, and the master ships the
    program again with the requeued task."""
    if isinstance(address, str):
        address, parsed_key = parse_address(address)
        authkey = authkey if authkey is not None else parsed_key
    conn = _ConnClient(tuple(address), authkey=authkey)
    programs = OrderedDict()             # program key -> CompiledProgram
    try:
        while True:
            msg = conn.recv()
            if msg[0] == "stop":
                break
            _, tid, pkey, program, seed, batch_index, overrides, \
                batch_size = msg
            if program is not None:
                programs[pkey] = program
                while len(programs) > max(1, program_cache_size):
                    programs.popitem(last=False)
            elif pkey not in programs:
                conn.send(("noprog", tid, pkey))
                continue
            programs.move_to_end(pkey)
            try:
                out = _run_host_task(programs[pkey], seed, batch_index,
                                     overrides, batch_size)
                reply = ("result", tid, out)
            except Exception as e:  # noqa: BLE001  the master replays
                reply = ("error", tid, repr(e))
            # sent outside the guard: a broken pipe to the master ends the
            # worker, it is not a task error
            conn.send(reply)
    except (EOFError, OSError):
        # the master closed the connection (shutdown, or it forgot a
        # quarantined worker)
        pass
    finally:
        conn.close()
