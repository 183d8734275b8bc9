"""The port's debug codecs against the JAX package's: seeded random
objects of every phase0 and altair minimal container, each mode, with
equal SSZ bytes and roots; the encoder's plain data equal; the decoder
rebuilding the same object from either package's encoding, root
annotations re-checked (consensus_specs_tpu_torch/debug/)."""
from random import Random

import pytest

from consensus_specs_tpu.builder import build_spec_module as jax_spec_module
from consensus_specs_tpu.debug import encode as jax_encode
from consensus_specs_tpu.debug import random_value as jax_random
from consensus_specs_tpu_torch.builder import build_spec_module
from consensus_specs_tpu_torch.debug.decode import decode
from consensus_specs_tpu_torch.debug.encode import encode
from consensus_specs_tpu_torch.debug.random_value import (
    RandomizationMode, get_random_ssz_object,
)
from consensus_specs_tpu.utils.ssz.ssz_typing import Container as JaxContainer
from consensus_specs_tpu_torch.utils.ssz.ssz_typing import Container
from tests.torch_threads import one_thread

one_thread()


def _containers(spec, base=Container):
    return [(name, obj) for name, obj in sorted(vars(spec).items())
            if isinstance(obj, type) and issubclass(obj, base)
            and obj is not base and obj.fields()]


@pytest.mark.parametrize("fork", ["phase0", "altair"])
@pytest.mark.parametrize("mode", list(RandomizationMode), ids=lambda m: m.name)
def test_random_objects_encode_and_decode_as_jax(fork, mode):
    spec = build_spec_module(fork, "minimal")
    jax_spec = jax_spec_module(fork, "minimal")
    port_types = _containers(spec)
    jax_types = dict(_containers(jax_spec, JaxContainer))
    assert [n for n, _ in port_types] == sorted(jax_types)
    jax_mode = jax_random.RandomizationMode(mode.value)
    seed = 4040 + 10 * mode.value + (fork == "altair")
    rng, jax_rng = Random(seed), Random(seed)
    for name, typ in port_types:
        chaos = mode == RandomizationMode.mode_random
        value = get_random_ssz_object(rng, typ, 100, 5, mode, chaos=chaos)
        want = jax_random.get_random_ssz_object(
            jax_rng, jax_types[name], 100, 5, jax_mode, chaos=chaos)
        assert value.encode_bytes() == want.encode_bytes(), name
        assert value.hash_tree_root() == want.hash_tree_root(), name
        plain = encode(value, include_hash_tree_roots=True)
        assert plain == jax_encode.encode(want, include_hash_tree_roots=True)
        back = decode(plain, typ)
        assert back.encode_bytes() == value.encode_bytes(), name
        assert back.hash_tree_root() == value.hash_tree_root(), name


def test_decode_rejects_wrong_root_annotations():
    spec = build_spec_module("phase0", "minimal")
    cp = spec.Checkpoint(epoch=3, root=b"\x01" * 32)
    plain = encode(cp, include_hash_tree_roots=True)
    plain["hash_tree_root"] = "0x" + "00" * 32
    with pytest.raises(AssertionError):
        decode(plain, spec.Checkpoint)
    plain = encode(cp, include_hash_tree_roots=True)
    plain["root_hash_tree_root"] = "0x" + "11" * 32
    with pytest.raises(AssertionError):
        decode(plain, spec.Checkpoint)


def test_encode_wide_uints_as_strings_and_unions():
    from consensus_specs_tpu.utils.ssz import ssz_typing as jax_typing
    from consensus_specs_tpu_torch.utils.ssz import ssz_typing as t

    assert encode(t.uint256(2 ** 200)) == jax_encode.encode(
        jax_typing.uint256(2 ** 200)) == str(2 ** 200)
    assert encode(t.uint64(7)) == 7
    union, jax_union = t.Union[None, t.uint16], jax_typing.Union[
        None, jax_typing.uint16]
    for selector, value in ((0, None), (1, 5)):
        v = union(selector=selector, value=value if value is None
                  else t.uint16(value))
        w = jax_union(selector=selector, value=value if value is None
                      else jax_typing.uint16(value))
        assert encode(v) == jax_encode.encode(w)
        assert decode(encode(v), union).encode_bytes() == w.encode_bytes()
