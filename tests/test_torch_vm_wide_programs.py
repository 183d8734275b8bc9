"""The wide ``aggregate_verify`` programs of the port against the JAX
package's, on the CPU.

``bls_backend.batch_aggregate_verify`` runs PROG A ``aggregate_verify``
at the k bucket and fold ``_fold_for`` picks: k512 fold 2 and k2048 fold
1 for the sync committee and the widest committee (chip_smoke.py's phase
``wide_aggregate`` runs both on the card). Each package's builder and
assembler at ``_program``'s shape must give the same program: steps,
registers, and the bytes of every assembled array. Tier-1 holds k32 fold
1 (a few seconds of IR build a package); the two wide buckets take
minutes and tens of GB of host memory a package, so their test is marked
``slow``. Each package's program is reduced to its digest and dropped
before the other's is built, so only one is in memory at a time.
"""
import gc
import hashlib

import numpy as np
import pytest

from consensus_specs_tpu.utils.jax_env import force_cpu

force_cpu()

from consensus_specs_tpu.ops import bls_backend as jax_backend  # noqa: E402
from consensus_specs_tpu.ops import vmlib as jax_vmlib  # noqa: E402
from consensus_specs_tpu_torch.ops import bls_backend, vmlib  # noqa: E402
from tests.torch_threads import one_thread  # noqa: E402

one_thread()


def _shape(backend):
    """The assembly shape each package's ``_program`` uses."""
    return dict(w_mul=backend.W_MUL, w_lin=backend.W_LIN,
                pad_steps_to=backend.PAD_STEPS,
                pad_regs_to=backend._pow2(64), annotate=False)


def _digest(builders, backend, kind, k, fold):
    """Steps, registers and a digest of every assembled array and name
    list of one package's program at ``_program``'s shape."""
    prog = builders[kind](k, fold).assemble(**_shape(backend))
    h = hashlib.sha256()
    for a in prog.instr + (prog.input_regs, prog.output_regs):
        a = np.ascontiguousarray(a)
        h.update(repr((a.dtype.str, a.shape)).encode())
        h.update(a.tobytes())
    h.update(repr((list(prog.input_names), list(prog.output_names),
                   sorted(prog.const_regs.items()))).encode())
    out = (int(prog.n_steps), int(prog.n_regs), h.hexdigest())
    del prog
    gc.collect()
    return out


def _assert_same_program(kind, k, fold, n_items):
    """The program ``_fold_for`` picks for ``n_items`` checks of k keys,
    equal in both packages."""
    assert _shape(bls_backend) == _shape(jax_backend)
    assert bls_backend._fold_for(kind, k, n_items) == \
        jax_backend._fold_for(kind, k, n_items) == fold
    want = _digest(jax_vmlib.BUILDERS, jax_backend, kind, k, fold)
    got = _digest(vmlib.BUILDERS, bls_backend, kind, k, fold)
    assert got == want
    return got


def test_aggregate_verify_k32_fold1_identical_to_jax():
    steps, regs, _ = _assert_same_program("aggregate_verify", 32, 1, 1)
    assert steps > 0 and regs > 0


@pytest.mark.slow
@pytest.mark.parametrize("k,fold", [(512, 2), (2048, 1)])
def test_wide_aggregate_verify_identical_to_jax(k, fold):
    steps, regs, _ = _assert_same_program("aggregate_verify", k, fold, 3)
    # the step kernel's shared memory: 30,720 B of stages and result slots
    # at 96 x 192 lanes plus 4 B a register, within 232,448 B
    assert 30720 + 4 * regs <= 232448 and steps < (1 << 20)
