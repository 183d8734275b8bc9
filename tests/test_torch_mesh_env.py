"""The port's mesh provider and layouts against the JAX package's.

``utils/torch_env`` (the counterpart of ``consensus_specs_tpu/utils/
jax_env.py``): ``get_mesh`` and ``maybe_mesh`` spec by spec against JAX's
``get_mesh`` on the conftest's 8 virtual CPU devices wherever the two
rules agree, the round-robin placement over cards (the one difference),
``Mesh`` equality, hashing, the (2, 2) flattening and the slot lanes; then
``bls_backend._FoldLayout`` and ``_rlc_chunk`` under a mesh against the
JAX package's, with both ``_program``s stubbed (the layout rules are
integer arithmetic), as tests/test_mesh_rlc.py runs them."""
import types

import numpy as np
import pytest
import torch
from tests.torch_threads import one_thread

from consensus_specs_tpu.ops import bls_backend as jbb
from consensus_specs_tpu.utils import jax_env
from consensus_specs_tpu_torch.ops import bls_backend as tbb
from consensus_specs_tpu_torch.utils import torch_env

one_thread()

ENV = "CONSENSUS_SPECS_TPU_MESH"


def _jax_slots(spec):
    m = jax_env.get_mesh(spec)
    return None if m is None else int(np.prod(list(m.shape.values())))


def _torch_slots(spec):
    m = torch_env.get_mesh(spec, device="cpu")
    return None if m is None else m.size


@pytest.mark.parametrize("spec", ["off", "none", "0", "1", "", "OFF ",
                                  "garbage", "-3", "2", "4", "6", "8"])
def test_get_mesh_agrees_with_jax_spec_by_spec(spec):
    """Off, 0, 1, empty and malformed specs give None; counts floor to a
    power of two. Up to the 8 virtual devices the JAX package has here,
    the two rules agree."""
    assert _torch_slots(spec) == _jax_slots(spec)
    m = torch_env.get_mesh(spec, device="cpu")
    if m is not None:
        assert m.axis_names == ("batch",)
        assert m.shape == {"batch": m.size}
        assert m.distinct_devices == 1 and m.device_type == "cpu"


def test_get_mesh_where_the_rules_differ():
    """A count above what JAX has clamps there (8 virtual devices), while
    the port gives n CPU slots; ``auto`` is one slot a card, so None on
    the CPU, where JAX spans its 8 virtual devices."""
    assert _jax_slots("16") == 8 and _torch_slots("16") == 16
    assert _jax_slots("12") == 8 and _torch_slots("12") == 8
    assert _jax_slots("auto") == 8 and _torch_slots("auto") is None


def test_maybe_mesh_reads_the_env_and_never_raises(monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    assert torch_env.maybe_mesh("cpu") is None
    assert jax_env.maybe_mesh() is None
    monkeypatch.setenv(ENV, "2")
    assert torch_env.maybe_mesh("cpu").size == 2
    assert jax_env.maybe_mesh().shape["batch"] == 2
    monkeypatch.setenv(ENV, "4")
    # the card asked for where there is none: None, not an exception
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert torch_env.maybe_mesh() is None
    with pytest.raises(RuntimeError):
        torch_env.get_mesh()


def test_count_above_the_cards_places_slots_round_robin(monkeypatch):
    """On the card, n slots go round-robin over the visible cards (slot i
    on card i mod count), each slot's lane says which, and
    ``distinct_devices`` counts the cards; ``auto`` is one slot a card.
    (Slots make their streams at first use, so no card is touched.)"""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    m = torch_env.get_mesh("4")
    assert [str(s.device) for s in m.slots] == [
        "cuda:0", "cuda:1", "cuda:0", "cuda:1"]
    assert m.lanes == ["0.0", "1.0", "0.1", "1.1"]
    assert m.distinct_devices == 2 and m.device_type == "cuda"
    assert torch_env.get_mesh("auto").size == 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert torch_env.get_mesh("auto") is None
    one = torch_env.get_mesh("2")
    assert one.distinct_devices == 1 and one.lanes == ["0.0", "0.1"]
    two = torch_env.make_mesh(2, "cuda")
    assert two == one and hash(two) == hash(one)


def test_mesh_equality_hashing_and_2d_flattening():
    """Structural equality and hashing (the final-exp batcher keys its
    windows on the mesh); a (2, 2) ("host", "chip") mesh flattens row-major
    to the same 4 slots as a 4-slot 1-D mesh over the same devices."""
    a = torch_env.make_mesh(4, "cpu")
    b = torch_env.make_mesh(4, "cpu")
    assert a == b and hash(a) == hash(b) and len({a, b}) == 1
    assert a != torch_env.make_mesh(2, "cpu")
    grid = torch_env.make_mesh(4, "cpu", axis_names=("host", "chip"),
                               shape=(2, 2))
    assert grid.shape == {"host": 2, "chip": 2}
    assert grid != a
    assert [(s.index, s.device, s.ordinal) for s in grid.slots] == \
        [(s.index, s.device, s.ordinal) for s in a.slots]
    assert grid.size == 4
    assert a.lanes == ["cpu.0", "cpu.1", "cpu.2", "cpu.3"]
    with pytest.raises(ValueError):
        torch_env.Mesh(np.array([torch.device("cpu")] * 2), ("a", "b"))


def test_resolve_raises_on_a_device_the_mesh_lacks(monkeypatch):
    mesh = torch_env.make_mesh(2, "cpu")
    assert torch_env.resolve(None, mesh) == torch.device("cpu")
    assert torch_env.resolve("cpu", mesh) == torch.device("cpu")
    assert torch_env.resolve("cpu", None) == torch.device("cpu")
    with pytest.raises(ValueError):
        torch_env.resolve("cuda:3", mesh)


# -- _FoldLayout and _rlc_chunk under a mesh, against the JAX package -------


def _jax_mesh(n_dev: int):
    """The JAX-style shape stub the JAX package's layout tests use."""
    return types.SimpleNamespace(shape={"batch": n_dev})


def _mesh(n_dev: int):
    return torch_env.make_mesh(n_dev, "cpu")


@pytest.fixture()
def stub_programs(monkeypatch):
    def stub(mod):
        def fake_program(kind, k=0, fold=None):
            if fold is None:
                fold = mod._fold_for(kind, k)
            return f"prog[{kind},k={k},f={fold}]", fold
        monkeypatch.setattr(mod, "_program", fake_program)
    stub(jbb)
    stub(tbb)


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
@pytest.mark.parametrize("n_items", [1, 3, 8, 17])
@pytest.mark.parametrize("kind,k", [("hard_part", 0), ("rlc_combine", 2),
                                    ("miller_product", 16),
                                    ("aggregate_verify", 2)])
def test_fold_layout_and_chunk_equal_jax(stub_programs, n_dev, n_items,
                                         kind, k):
    """Program kind, fold, rows and nb equal to the JAX package's layout
    for the same mesh size (the port's own ``Mesh`` against the JAX-style
    shape stub), and the chunk of an n_items combine."""
    jmesh = _jax_mesh(n_dev) if n_dev > 1 else None
    mesh = _mesh(n_dev) if n_dev > 1 else None
    want = jbb._FoldLayout(kind, k, n_items, jmesh)
    got = tbb._FoldLayout(kind, k, n_items, mesh)
    assert (got.program, got.fold, got.rows, got.nb) == \
        (want.program, want.fold, want.rows, want.nb)
    assert [got.split(i) for i in range(n_items)] == \
        [want.split(i) for i in range(n_items)]
    assert tbb._rlc_chunk(n_items, mesh) == jbb._rlc_chunk(n_items, jmesh)
    assert tbb._rows_for(n_items, got.fold, mesh) == \
        jbb._rows_for(n_items, want.fold, jmesh)
    if jmesh is not None:
        assert want.rows % n_dev == 0


def test_fold_layout_pinned_cases(stub_programs):
    lay = tbb._FoldLayout("hard_part", 0, 17, _mesh(8))
    assert (lay.fold, lay.rows, lay.nb) == (4, 8, 32)
    lay = tbb._FoldLayout("hard_part", 0, 1, _mesh(8))
    assert (lay.fold, lay.rows) == (1, 8)
    lay = tbb._FoldLayout("hard_part", 0, 17, None)
    assert (lay.fold, lay.rows) == (16, 2)
    assert tbb._rlc_chunk(16, _mesh(8)) == 2
    assert tbb._rlc_chunk(64, _mesh(4)) == 16  # capped at chunk max
    assert tbb._rlc_chunk(2, _mesh(2)) == 1
