"""Cross-slot RLC reduction: one Fq12 product over the whole mesh (the
port's counterpart of consensus_specs_tpu/ops/mesh_rlc.py).

The mesh-sharded verify plane runs each micro-batch's Miller loops and
per-chunk RLC ladders data-parallel over the mesh's slots
(``ops/vm.execute(mesh=)``), which leaves one sequential tail: multiplying
the per-chunk Fq12 products into the single element the combined final
exponentiation consumes. Each slot folds its LOCAL shard of chunk
products (``cuda_tower.fq12_fold``: one launch of csrc/fq12_fold.cu a
slot on the card, the JAX package's per-device ``lax.scan``;
``_local_fold_plain`` on the CPU), then a log2(n)-round XOR butterfly
exchanges partial products between slots (``i -> i ^ step``), the
counterpart of the JAX package's ``ppermute`` rounds: an all-reduce whose
monoid is the Fq12 multiply, ``towers.fq12_mul`` (every Fq product one
``fq.mont_mul``, kernel 2 on the card).

The operand order is the JAX package's, so the limbs are too: each fold
starts from the identity and multiplies every element (``one * f`` is
computed, not skipped), and in a round each slot computes
``local = local * recv``. Slot 0's value is returned: for 4 slots
``(l0 * l1) * (l2 * l3)``.

Identity filler: the batch pads up to a multiple of the slot count with
f = 1, which cannot perturb the combined element.
"""
import numpy as np
import torch

from . import cuda_tower, fq
from . import towers as tw


def fq12_identity(batch_shape=()) -> np.ndarray:
    """(batch..., 12, L) host-side flat Fq12 one: the padding filler."""
    out = np.zeros(tuple(batch_shape) + (12, fq.NUM_LIMBS), dtype=np.uint64)
    out[..., 0, :] = fq.ONE_MONT
    return out


def _local_fold(fs: torch.Tensor) -> torch.Tensor:
    """Sequential Fq12 product of a slot-local (k, 12, L) shard, from the
    identity: one launch of csrc/fq12_fold.cu on the card,
    ``_local_fold_plain`` on the CPU."""
    if fs.is_cuda:
        return cuda_tower.fq12_fold(fs, from_one=True)
    return _local_fold_plain(fs)


def _local_fold_plain(fs: torch.Tensor) -> torch.Tensor:
    """Sequential Fq12 product of a slot-local (k, ..., 12, L) shard, from
    the identity (one * fs[0] computed, as the JAX scan computes it)."""
    acc = tw.fq12_one((), fs.device)
    for i in range(fs.shape[0]):
        acc = tw.fq12_mul(acc, fs[i])
    return acc


def butterfly_reduce(locals_, mesh, op):
    """XOR butterfly all-reduce of one value a slot (``locals_[i]`` on
    slot i's device) under ``op``: log2(n) rounds, in each of which every
    slot's value is copied to its partner ``i ^ step`` (every copy issued
    before any product, each on the receiving slot's stream after the
    sending slot's stream has reached its value), then every slot
    computes ``local = op(local, recv)`` on its own stream. Returns the
    list of every slot's value (all equal as field elements; slot 0's
    carries the JAX package's limbs)."""
    n = mesh.size
    assert n & (n - 1) == 0, "the mesh's slot count must be a power of two"
    slots = mesh.slots
    locals_ = list(locals_)
    step = 1
    while step < n:
        ready = [None] * n
        if mesh.device_type == "cuda":
            for s in slots:
                with s.context():
                    ready[s.index] = torch.cuda.Event()
                    ready[s.index].record(s.stream)
        recv = [None] * n
        for s in slots:
            src = slots[s.index ^ step]
            with s.context():
                if ready[src.index] is not None:
                    s.stream.wait_event(ready[src.index])
                    # the sender's stream frees it: mark this use
                    locals_[src.index].record_stream(s.stream)
                buf = torch.empty_like(locals_[src.index], device=s.device)
                recv[s.index] = buf.copy_(locals_[src.index],
                                          non_blocking=True)
        for s in slots:
            with s.context():
                locals_[s.index] = op(locals_[s.index], recv[s.index])
        step *= 2
    return locals_


def _mesh_reduce(rows: np.ndarray, filler: np.ndarray, mesh, fold, op):
    """Pad ``rows`` (m, ...) with ``filler`` to a multiple of the slot
    count, fold each slot's contiguous block on its device and stream,
    reduce across slots and return slot 0's value as uint64."""
    n = mesh.size
    pad = (-rows.shape[0]) % n
    if pad:
        rows = np.concatenate([rows, filler[:pad]], axis=0)
    block = rows.shape[0] // n
    locals_ = []
    for s in mesh.slots:
        with s.context():
            shard = fq.limbs_from_numpy(
                rows[s.index * block:(s.index + 1) * block], s.device)
            locals_.append(fold(shard))
    locals_ = butterfly_reduce(locals_, mesh, op)
    with mesh.slots[0].context():
        out = locals_[0].cpu().numpy().astype(np.uint64)
    mesh.synchronize()
    return out


def mesh_fq12_product(products: np.ndarray, mesh) -> np.ndarray:
    """Multiply a (n, 12, L) batch of flat Fq12 elements (loose Montgomery
    limbs) into ONE element over the mesh's slots: a local fold a slot,
    then the butterfly. Returns (12, L), slot 0's value (the JAX
    package's device-0 replica)."""
    n = mesh.size
    return _mesh_reduce(np.asarray(products, dtype=np.uint64),
                        fq12_identity((n,)), mesh, _local_fold,
                        tw.fq12_mul)
