"""The verify plane's device mesh: the port's counterpart of
consensus_specs_tpu/utils/jax_env.py (named ``torch_env`` because the
port imports no jax).

A JAX mesh is one controller passing a ``jax.sharding.Mesh`` through every
call of one process. The port keeps that shape: a :class:`Mesh` is an
ordered, n-d array of **slots**, and the process passes it as ``mesh=``
through the service, the collector, the backend and ``vm.execute``. A
slot is a ``torch.device`` with CUDA streams of its own:

- on a machine with n cards the slots are the cards;
- on one card, n slots share it, each on its own streams (the counterpart
  of the virtual host devices the JAX package's smoke, bench ``--mesh``
  and tests run on);
- on the CPU, n slots are n CPU "devices", run one after another (the
  plain path).

A slot's stream is the thread's own: each (thread, card, slot ordinal on
that card) gets one stream, made at first use, so two threads driving one
mesh never share a stream, and every per-stream cache and CUDA graph keys
apart. ``distinct_devices`` says how many cards a mesh really spans.

:func:`get_mesh` is the one place the process decides whether the verify
plane runs sharded: ``CONSENSUS_SPECS_TPU_MESH=auto|off|<n>`` resolves to
a 1-D mesh on axis ``batch``, or to ``None`` for the single-device path,
by JAX's rules (off/0/1/empty/malformed give ``None``; counts floor to a
power of two). The one difference: on the card, a count above the cards
present places the slots round-robin over them; on ``device="cpu"``,
``<n>`` gives n CPU slots (as JAX's virtual host devices do). ``auto``
gives one slot per visible card, so it is ``None`` on one card and on the
CPU. There is no ``force_cpu``: the port has no platform to force.
"""
import contextlib
import os
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..obs.devices import lane_of

MESH_ENV = "CONSENSUS_SPECS_TPU_MESH"
_OFF = ("", "off", "none", "0", "1")

# (thread id, device, ordinal) -> torch.cuda.Stream
_STREAMS: Dict[tuple, "torch.cuda.Stream"] = {}
_STREAMS_LOCK = threading.Lock()


def canonical(device) -> torch.device:
    """``device`` with its index: "cuda" names the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Slot:
    """One slot of a mesh: its flat index (row-major), its device, its
    ordinal among the mesh's slots on that device, and its lane in the
    device ledger (the device's lane, with ``.<ordinal>`` when several
    slots share the device)."""

    __slots__ = ("index", "device", "ordinal", "lane")

    def __init__(self, index: int, device: torch.device, ordinal: int,
                 lane):
        self.index = index
        self.device = device
        self.ordinal = ordinal
        self.lane = lane

    @property
    def stream(self) -> Optional["torch.cuda.Stream"]:
        """This thread's stream of the slot (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        key = (threading.get_ident(), self.device, self.ordinal)
        with _STREAMS_LOCK:
            s = _STREAMS.get(key)
            if s is None:
                s = _STREAMS[key] = torch.cuda.Stream(self.device)
            return s

    def context(self):
        """The slot's device and this thread's stream of it, current for
        the ``with`` block (nothing on the CPU)."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self.stream))
        return stack

    def synchronize(self) -> None:
        """Wait for the work this thread put on the slot's stream."""
        if self.device.type == "cuda":
            self.stream.synchronize()

    def __repr__(self):
        return f"Slot({self.index}, {self.device}, lane={self.lane})"


class Mesh:
    """An n-d array of slot devices with named axes. ``shape`` maps each
    axis to its size, as a JAX mesh's does; ``slots`` lists the slots in
    row-major order, so a (2, 2) mesh flattens to the same 4 slots as a
    4-slot 1-D mesh over the same devices. Equality and hashing are
    structural (axis names, shape, devices)."""

    def __init__(self, devices, axis_names: Sequence[str] = ("batch",)):
        arr = np.empty(np.shape(np.asarray(devices, dtype=object)),
                       dtype=object)
        for idx, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            arr[idx] = canonical(d)
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-d devices for axes {axis_names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one slot")
        kinds = {d.type for d in arr.flat}
        if len(kinds) != 1:
            raise ValueError(f"a mesh's slots are of one type, not {kinds}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, arr.shape))
        flat = list(arr.flat)
        per_dev: Dict[torch.device, int] = {}
        for d in flat:
            per_dev[d] = per_dev.get(d, 0) + 1
        seen: Dict[torch.device, int] = {}
        slots = []
        for i, d in enumerate(flat):
            j = seen.get(d, 0)
            seen[d] = j + 1
            lane = lane_of(d)
            if per_dev[d] > 1:
                lane = f"{lane}.{j}"
            slots.append(Slot(i, d, j, lane))
        self.slots: List[Slot] = slots
        self._key = (self.axis_names, arr.shape, tuple(flat))

    @property
    def size(self) -> int:
        return len(self.slots)

    @property
    def device_type(self) -> str:
        return self.slots[0].device.type

    @property
    def distinct_devices(self) -> int:
        """How many distinct devices (cards) the slots span."""
        return len({s.device for s in self.slots})

    @property
    def lanes(self) -> List:
        return [s.lane for s in self.slots]

    def has_device(self, device) -> bool:
        return canonical(device) in {s.device for s in self.slots}

    def synchronize(self) -> None:
        for s in self.slots:
            s.synchronize()

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key == other._key

    def __hash__(self):
        return hash(self._key)

    def __repr__(self):
        return (f"Mesh({self.shape}, slots={self.size}, "
                f"distinct_devices={self.distinct_devices}, "
                f"type={self.device_type})")


def resolve(device, mesh) -> torch.device:
    """The device of a call given ``device=`` and ``mesh=``: without a
    mesh, ``device`` resolved as every entry point does; with one, its
    first slot's device. A ``device`` that is not one of the mesh's
    devices raises."""
    from ..device import resolve_device

    if mesh is None:
        return resolve_device(device)
    if device is not None and not mesh.has_device(device):
        raise ValueError(f"device {device} is not a device of {mesh!r}")
    return mesh.slots[0].device


def _pow2_floor(n: int) -> int:
    b = 1
    while b * 2 <= n:
        b <<= 1
    return b


def make_mesh(n_slots: int, device=None, axis_names=("batch",),
              shape=None) -> Mesh:
    """A mesh of ``n_slots`` slots on ``device``'s type: on the card,
    round-robin over the visible cards (slot i on card i mod count); on
    the CPU, n CPU slots. ``shape`` (default ``(n_slots,)``) lays the
    slots out over ``axis_names`` in row-major order."""
    from ..device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        devs = [torch.device("cuda", i % n_cards) for i in range(n_slots)]
    else:
        devs = [dev] * n_slots
    shape = (n_slots,) if shape is None else tuple(shape)
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), axis_names)


def get_mesh(spec: Optional[str] = None, device=None) -> Optional[Mesh]:
    """Resolve the process's verify-plane mesh, or ``None``.

    ``spec`` (default: env ``CONSENSUS_SPECS_TPU_MESH``, unset == off):
    ``off``/``none``/``0``/``1``/empty: ``None``; ``auto``: one slot per
    visible card (largest power-of-two prefix), ``None`` below two cards
    and on the CPU; ``<n>``: n slots, floored to a power of two, round-
    robin over the cards (or n CPU slots on ``device="cpu"``). Malformed
    specs give ``None``. ``device`` as every entry point takes it (None:
    the card, raising without one)."""
    if spec is None:
        spec = os.environ.get(MESH_ENV, "off")
    spec = spec.strip().lower()
    if spec in _OFF:
        return None
    from ..device import resolve_device

    dev = resolve_device(device)
    if spec == "auto":
        have = torch.cuda.device_count() if dev.type == "cuda" else 1
        n = _pow2_floor(max(1, have))
    else:
        try:
            want = int(spec)
        except ValueError:
            return None
        if want <= 1:
            return None
        n = _pow2_floor(want)
    if n <= 1:
        return None
    return make_mesh(n, dev)


def maybe_mesh(device=None) -> Optional[Mesh]:
    """``get_mesh()`` that never raises: the serve plane's construction-
    time hook. Any failure to resolve a mesh means the single-device
    path."""
    try:
        return get_mesh(device=device)
    except Exception:
        return None
