"""The ``mesh=`` of the port's three hash-to-G2 codecs on a 4-slot CPU
mesh, each held against the same call unsharded on the codec's tensor
path (CONSENSUS_SPECS_TPU_CODEC_DEVICE=1: the hash-finish program on the
plain VM steps): ``_h2g_finish_batch`` on the SSWU outputs that
``hash_to_g2_batch`` hands it, ``hash_to_g2_batch`` and
``message_limbs_batch``. The helpers, and the run-once ``vm.execute``,
are tests/test_torch_mesh_codec.py's."""
import pytest
from tests.test_torch_mesh_codec import (  # noqa: F401 (fixtures)
    CPU, DST, MESSAGES, check_sharded, execute_meshes, h2g_inputs, mesh)
from tests.torch_threads import one_thread

from consensus_specs_tpu_torch.ops import codec

one_thread()

HASH_CALLS = {
    "_h2g_finish_batch": lambda mesh: codec._h2g_finish_batch(
        *h2g_inputs(), CPU, mesh=mesh),
    "hash_to_g2_batch": lambda mesh: codec.hash_to_g2_batch(
        MESSAGES, DST, CPU, mesh=mesh),
    "message_limbs_batch": lambda mesh: codec.message_limbs_batch(
        MESSAGES, DST, CPU, mesh=mesh),
}


@pytest.mark.parametrize("name", list(HASH_CALLS))
def test_hash_codec_sharded_equals_unsharded(name, mesh, execute_meshes,
                                             monkeypatch):
    """The hashed points' limbs equal the unsharded call's, one a
    message; the finish program ran on the mesh."""
    got = check_sharded(HASH_CALLS[name], mesh, execute_meshes, monkeypatch)
    assert len(got) == len(MESSAGES)
