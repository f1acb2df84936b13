"""A single-process device mesh: airdos_tpu's ``Mesh`` + ``shard_map``.

airdos_tpu is single-controller: one Python process runs ``System``, and
with ``n_chips > 1`` only the solves inside it are sharded
(``jax.shard_map`` under ``jit`` over a one-axis mesh "edges").  The port
keeps that shape with PyTorch's own single-process pattern, the one of
``torch.nn.parallel.parallel_apply``: one Python thread per rank, each
queueing its kernels asynchronously on its own CUDA stream of its rank's
device, and the exchanges as device-to-device copies (NVLink P2P between
cards of one host).

- ``make_mesh(n, device)``: on CUDA the ranks are ``cuda:0 .. cuda:n-1``,
  and fewer visible cards raise, as airdos_tpu's ``make_mesh`` does.
  Virtual ranks (n ranks on one card) are given only when the variable
  ``AIRDOS_TORCH_VIRTUAL_DEVICES`` holds a count: it is the counterpart of
  XLA's ``--xla_force_host_platform_device_count``, and the card then
  shows that many ranks, all on the current device.  On the CPU the ranks
  are always virtual, as JAX's forced host devices are.
- ``Mesh.run(shard_fn, replicated, sharded, sharded_out)`` is
  ``shard_map``: each tensor of ``sharded`` is split along dim 0 into
  equal shards (the caller pads), ``replicated`` goes whole to every
  rank, and ``shard_fn(group, *replicated, *shards)`` runs once per rank:
  rank 0 in the calling thread on its current stream, rank r > 0 in a
  thread named "<caller>:rank<r>" on a new stream of the caller's stream
  priority (utils/gate.py: tracking -1, the online workers 0).  Outputs
  come from rank 0, except the fields named in ``sharded_out``, which
  are the ranks' outputs concatenated in rank order.
- The ranks take turns on the host, in rank order, one turn from a
  collective to the next: rank r runs until its next collective, posts
  its tensor and hands the turn to rank r + 1; rank 0 gets it back when
  every rank has posted.  The threads then never run Python at once:
  with all of them free to run, the interpreter lock changed hands at
  nearly every torch call, and a sharded solve on one card was slower
  in every run (PERF.md section 6).  The launches stay asynchronous, so
  the ranks' device work still overlaps.
- ``group.psum(x)`` (``jax.lax.psum``) and ``group.all_gather(x)``
  (``jax.lax.all_gather``): rank 0 combines the posted tensors on its
  device strictly in rank order (x_0 + x_1 + ... + x_{n-1}, or a stack)
  and leaves every rank its copy of the result.  One reduction order, on
  one device, so two runs are bit-equal and every rank's replicated step
  starts from identical bits.
- Cross-stream order: every exchange is ordered by stream waits made by
  rank 0 while the other ranks wait for their turn (rank 0's stream
  waits on each posting rank's before reading, each rank's waits on rank
  0's before using the result), and a tensor read on another stream than
  its own is recorded on that stream (``record_stream``), so the caching
  allocator does not hand out its memory while the read is in flight.
- A rank that raises aborts the run: the ranks waiting for a turn raise
  ``MeshAborted``, and ``run`` re-raises the first real exception in rank
  order.  The ranks must make the same sequence of collectives (the
  solvers' protocols are symmetric).
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Callable, Optional, Sequence

import torch

from airdos_tpu_torch.utils.gate import new_stream, on_stream

VIRTUAL_DEVICES_ENV = "AIRDOS_TORCH_VIRTUAL_DEVICES"


def _virtual_device_count() -> int:
    """The rank count that AIRDOS_TORCH_VIRTUAL_DEVICES asks for, 0 when
    unset or empty."""
    raw = os.environ.get(VIRTUAL_DEVICES_ENV, "").strip()
    if not raw:
        return 0
    n = int(raw)
    if n < 1:
        raise ValueError(f"{VIRTUAL_DEVICES_ENV}={raw!r}: need a count >= 1")
    return n


class Mesh:
    """An ordered tuple of rank devices along one axis ("edges")."""

    def __init__(self, devices: Sequence, virtual: bool,
                 axis: str = "edges"):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.virtual = virtual
        self.axis = axis

    @property
    def size(self) -> int:
        return len(self.devices)

    def describe(self) -> str:
        if self.virtual:
            return f"{self.size} virtual ranks on {self.devices[0]}"
        return f"{self.size} devices: " + ", ".join(map(str, self.devices))

    def __repr__(self) -> str:
        return f"Mesh({self.describe()}, axis={self.axis!r})"

    def run(self, shard_fn: Callable, replicated: Sequence = (),
            sharded: Sequence = (), sharded_out: Sequence[str] = ()):
        """shard_fn(group, *replicated, *shards) on every rank; returns
        rank 0's output with the fields named in sharded_out (a NamedTuple
        output's) replaced by the ranks' outputs concatenated along dim 0
        in rank order.  Every sharded tensor's dim 0 must be a multiple of
        the mesh size."""
        n = self.size
        for x in sharded:
            if x.shape[0] % n:
                raise ValueError(f"a sharded tensor of {x.shape[0]} rows on "
                                 f"a {n}-rank mesh: pad it to a multiple")
        ex = _Exchange(self)
        shards = [torch.tensor_split(x, n) for x in sharded]
        per_rank = [tuple(ex.place(r, x) for x in replicated) +
                    tuple(ex.place(r, s[r]) for s in shards)
                    for r in range(n)]
        results: list = [None] * n
        errors: list = [None] * n

        def rank_main(r):
            try:
                ex.wait_turn(r)
                with ex.rank_context(r):
                    results[r] = shard_fn(Group(ex, r), *per_rank[r])
                ex.pass_turn(r)
            except BaseException as e:        # re-raised by run()
                errors[r] = e
                ex.abort()

        caller = threading.current_thread().name
        threads = [threading.Thread(target=rank_main, args=(r,), daemon=True,
                                    name=f"{caller}:rank{r}")
                   for r in range(1, n)]
        for th in threads:
            th.start()
        rank_main(0)
        for th in threads:
            th.join()
        raised = [e for e in errors if e is not None]
        if raised:
            real = [e for e in raised if not isinstance(e, MeshAborted)]
            raise (real or raised)[0]

        out = results[0]
        if sharded_out:
            fields = {name: torch.cat([ex.to_rank0(r, getattr(res, name))
                                       for r, res in enumerate(results)])
                      for name in sharded_out}
            out = out._replace(**fields)
        ex.finish()
        return out


class MeshAborted(RuntimeError):
    """Raised in the ranks that wait for their turn when another rank has
    raised; Mesh.run re-raises that rank's exception instead."""


class _Exchange:
    """The shared state of one Mesh.run: the rank streams, whose turn it
    is, and the posting slots of the collectives."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.n = mesh.size
        dev0 = mesh.devices[0]
        self._cv = threading.Condition()
        self._turn = 0
        self._aborted = False
        self.slots: list = [None] * self.n
        self.out: list = [None] * self.n
        if dev0.type == "cuda":
            s0 = torch.cuda.current_stream(dev0)
            self.streams = [s0] + [new_stream(d, s0.priority)
                                   for d in mesh.devices[1:]]
            for s in self.streams[1:]:
                s.wait_stream(s0)              # the inputs are ready
        else:
            self.streams = [None] * self.n

    def rank_context(self, r: int):
        """Rank r's device and stream for its thread's launches."""
        if self.streams[r] is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.mesh.devices[r]))
        stack.enter_context(on_stream(self.streams[r]))
        return stack

    def _move(self, x: torch.Tensor, src: Optional[int], dst: int):
        """x (rank src's tensor; None: the caller's, on rank 0's stream)
        made readable by rank dst on its stream.  Called only while rank
        dst's thread is not launching."""
        if not isinstance(x, torch.Tensor):
            return x
        dev = self.mesh.devices[dst]
        s_src = self.streams[0 if src is None else src]
        s_dst = self.streams[dst]
        if s_dst is None or s_src is s_dst:
            return x.to(dev)
        if x.device == dev:
            s_dst.wait_stream(s_src)
            x.record_stream(s_dst)
            return x
        # a copy between cards runs on the source's stream and is ordered
        # after both devices' current streams: make them the two ranks'
        with on_stream(s_src), on_stream(s_dst):
            return x.to(dev)

    def place(self, r: int, x):
        return self._move(x, None, r)

    def to_rank0(self, r: int, x):
        return self._move(x, r, 0)

    def wait_turn(self, rank: int) -> None:
        with self._cv:
            while self._turn != rank and not self._aborted:
                self._cv.wait()
            if self._aborted:
                raise MeshAborted(f"rank {rank}: another rank raised")

    def pass_turn(self, rank: int) -> None:
        with self._cv:
            self._turn = (rank + 1) % self.n
            self._cv.notify_all()

    def abort(self) -> None:
        with self._cv:
            self._aborted = True
            self._cv.notify_all()

    def exchange(self, rank: int, x, combine):
        """Post x and hand the turn on; when it comes back, every rank has
        posted (rank 0 then combines the postings in rank order) and rank
        0 has combined (every other rank then takes its copy)."""
        self.slots[rank] = x
        self.pass_turn(rank)
        self.wait_turn(rank)
        if rank == 0:
            acc = combine([self.to_rank0(r, self.slots[r])
                           for r in range(self.n)])
            self.out = [self._move(acc, 0, r) for r in range(self.n)]
            self.slots = [None] * self.n
        return self.out[rank]

    def finish(self) -> None:
        """Order the caller's stream after every rank's work."""
        s0 = self.streams[0]
        for s in self.streams[1:]:
            if s is not None:
                s0.wait_stream(s)


def _rank_order_sum(parts):
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


class Group:
    """One rank's handle on its mesh inside Mesh.run: ``rank``, ``size``,
    ``device`` and the collectives."""

    def __init__(self, ex: _Exchange, rank: int):
        self._ex = ex
        self.rank = rank
        self.size = ex.n
        self.device = ex.mesh.devices[rank]

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's x, added on rank 0 in rank order."""
        return self._ex.exchange(self.rank, x, _rank_order_sum)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's x stacked in rank order: [size, *x.shape]."""
        return self._ex.exchange(self.rank, x, torch.stack)

    def barrier(self) -> None:
        """Return once every rank has reached its barrier."""
        self._ex.exchange(self.rank, None, lambda parts: None)


def make_mesh(n_devices: Optional[int] = None, device="cuda",
              axis: str = "edges") -> Mesh:
    """airdos_tpu/parallel/sharded_ba.py:24 on torch devices: the first
    n_devices visible ranks (all of them for None); fewer raise.  See the
    module docstring for what is visible on CUDA and on the CPU."""
    dev = torch.device(device)
    if dev.type == "cpu":
        n = n_devices or _virtual_device_count() or 1
        return Mesh([dev] * n, virtual=True, axis=axis)
    if dev.type != "cuda":
        raise ValueError(f"no mesh on {dev.type} devices")
    if not torch.cuda.is_available():
        raise RuntimeError(f"requested a {n_devices}-device mesh on CUDA "
                           "but torch sees no CUDA device")
    n_virtual = _virtual_device_count()
    if n_virtual:
        base = dev if dev.index is not None else \
            torch.device("cuda", torch.cuda.current_device())
        visible, virtual = [base] * n_virtual, True
    else:
        visible = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        virtual = False
    if n_devices is not None:
        if len(visible) < n_devices:
            raise RuntimeError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(visible)} devices are visible: {visible} (set "
                f"{VIRTUAL_DEVICES_ENV}={n_devices} for virtual ranks on "
                "one card)")
        visible = visible[:n_devices]
    return Mesh(visible, virtual=virtual, axis=axis)
