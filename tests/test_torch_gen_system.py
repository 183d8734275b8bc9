"""The port's generator system against the JAX package's: the snappy codec,
the PyYAML-free YAML writer (byte for byte against ``yaml.safe_dump``),
the runner's lifecycle, the generators' module tables and the random
scenario-matrix codegen (consensus_specs_tpu_torch/gen/, utils/snappy.py,
tools/torch_gen_random_tests.py)."""
import importlib
import importlib.util
import os
import random
import string

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from consensus_specs_tpu.gen import gen_runner as jax_runner
from consensus_specs_tpu.gen import gen_typing as jax_typing
from consensus_specs_tpu.utils import snappy as jax_snappy
from consensus_specs_tpu_torch.gen import gen_runner, gen_typing, yaml_writer
from consensus_specs_tpu_torch.utils import snappy
from tests.torch_threads import one_thread

one_thread()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------------------
# (a) snappy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 59, 60, 61, 255, 4096, 70000])
def test_snappy_compress_equals_jax_and_round_trips(n):
    """The sizes of tests/test_gen_system.py's round trip: each literal
    tag width, and a stream past 65,536 bytes."""
    rng = random.Random(7 + n)
    data = bytes(rng.randrange(256) for _ in range(n))
    got = snappy.compress(data)
    assert got == jax_snappy.compress(data)
    assert snappy.decompress(got) == data
    assert jax_snappy.decompress(got) == data


def test_snappy_decodes_copies_and_refuses_bad_streams():
    # "abcabcabcabc": literal "abc", then a 1-byte-offset copy of 9 at 3
    stream = bytes([12]) + bytes([(3 - 1) << 2]) + b"abc" \
        + bytes([((9 - 4) << 2) | 1, 3])
    assert snappy.decompress(stream) == b"abcabcabcabc"
    # a 2-byte-offset copy: "xy" then 4 more at offset 2
    two = bytes([6]) + bytes([(2 - 1) << 2]) + b"xy" \
        + bytes([((4 - 1) << 2) | 2, 2, 0])
    assert snappy.decompress(two) == jax_snappy.decompress(two) == b"xyxyxy"
    for bad in (bytes([4, ((4 - 4) << 2) | 1, 0]),     # zero offset
                bytes([4, ((4 - 4) << 2) | 1, 9]),     # before the start
                bytes([9]) + bytes([(3 - 1) << 2]) + b"abc"):  # length
        with pytest.raises(ValueError):
            snappy.decompress(bad)
        with pytest.raises(ValueError):
            jax_snappy.decompress(bad)


# ---------------------------------------------------------------------------
# (b) the YAML writer
# ---------------------------------------------------------------------------


def _pyyaml(value):
    return yaml.safe_dump(value, default_flow_style=None, sort_keys=False)


_SAMPLES = [
    {"mapping": list(range(40))},                     # wraps at width 80
    ["0x" + "ab" * 48] * 2,                           # one hex per line
    {"a": ["0x" + "ab" * 48] * 2}, 5, 2 ** 256, "abc", "0x12", "", [], {},
    {"a": [], "b": {}}, [[1, 2], [3, [4, 5]], []], {"x": [[], {}]},
    {"a": [{"b": 1, "c": [1, 2]}, {"d": "x y"}], "e": True, "f": "None",
     "g": "12", "h": "true", "i": "- x", "j": "a: b", "k": "a #b",
     "l": "it's"},
    " lead", "trail ", "x" * 200, " ".join(["word"] * 40),
    {"desc": " ".join(["word"] * 40)}, ["a b " * 30], {"k" * 122: 2},
    {"a": "it's a \"q\" \\ x"}, {"n": "None"}, ["it's " * 30],
    "-", "?", ":x", "a,b", "[x]", "#", "~", "null", "Yes", "1.5",
    "2001-01-01", "=", "<<", "---x", "...", "1_000", "0o17", "0b101",
    {"steps": [{"tick": 0}, {"block": "block_0x1234"},
               {"checks": {"head": {"slot": 1, "root": "0x" + "ab" * 32}}}]},
]


@pytest.mark.parametrize("value", _SAMPLES, ids=range(len(_SAMPLES)))
def test_yaml_writer_equals_pyyaml_on_samples(value):
    assert yaml_writer.dump(value) == _pyyaml(value)


# letters, digits, spaces and YAML's indicator characters: printable
# ASCII, as every string a generator writes is
_TEXT = st.text(alphabet=string.ascii_letters + string.digits
                + " _-:#,.'\"[]{}!&*?|>%@`~=<", max_size=24)
_HEX = st.binary(max_size=100).map(lambda b: "0x" + b.hex())
_SCALARS = (st.integers(min_value=-(2 ** 256), max_value=2 ** 256)
            | st.booleans() | _HEX | _TEXT
            | st.integers(min_value=0, max_value=2 ** 256).map(str))
_KEYS = st.text(alphabet=string.ascii_lowercase + "_0123456789",
                min_size=1, max_size=16)
_WIDE = st.lists(st.integers(min_value=0, max_value=2 ** 64), min_size=20,
                 max_size=60)
_PLAIN = st.recursive(
    _SCALARS | _WIDE,
    lambda inner: st.lists(inner, max_size=10)
    | st.dictionaries(_KEYS, inner, max_size=6),
    max_leaves=40)


@settings(max_examples=300, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(_PLAIN)
def test_yaml_writer_equals_pyyaml_on_plainified_values(value):
    """Nested dicts and lists of ints up to 2**256, bools, 0x strings,
    decimal strings, text with indicator characters, empty containers
    and lists that wrap past width 80, through each package's
    ``_plainify``."""
    plain = gen_runner._plainify(value)
    assert plain == jax_runner._plainify(value)
    assert yaml_writer.dump(plain) == _pyyaml(plain)


@pytest.mark.parametrize("value", [
    {1: 2}, 1.5, None, [None], "line\nbreak", "tab\there", "caf\xe9",
    "\x00\x07", {"a": "x\x7f"}, {"": 1}, {"k" * 123: 2}, [{"": []}],
], ids=range(12))
def test_yaml_writer_refuses_what_plainify_never_gives(value):
    """Non-string keys, floats, None, strings outside printable ASCII and
    keys PyYAML would not write as simple keys raise."""
    with pytest.raises((TypeError, ValueError)):
        yaml_writer.dump(value)


# ---------------------------------------------------------------------------
# (c) the runner's lifecycle, on both packages
# ---------------------------------------------------------------------------


def _lifecycle_providers(typing, calls):
    def make_case(name, fn):
        return typing.TestCase(fork_name="phase0", preset_name="minimal",
                               runner_name="demo", handler_name="h",
                               suite_name="s", case_name=name, case_fn=fn)

    def good():
        calls.append("good")
        return [("value", "data", {"x": 1, "roots": [b"\x01" * 32] * 3}),
                ("blob", "ssz", b"\x01\x02"), ("raw", "bytes", b"\x03"),
                ("note", "meta", "hi"), ("bls_setting", "meta", 1)]

    def bad():
        raise RuntimeError("boom")

    def filtered():
        return None

    def empty():
        return []

    return [typing.TestProvider(
        prepare=lambda: None,
        make_cases=lambda: [make_case("ok", good), make_case("crash", bad),
                            make_case("filtered", filtered),
                            make_case("empty", empty)])]


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def test_gen_runner_lifecycle_equals_jax(tmp_path):
    calls = []
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    rc = gen_runner.run_generator(
        "demo", _lifecycle_providers(gen_typing, calls),
        args=["-o", str(port_dir)])
    jax_rc = jax_runner.run_generator(
        "demo", _lifecycle_providers(jax_typing, []),
        args=["-o", str(jax_dir)])
    assert rc == jax_rc == 1  # the failure is reported
    ok_dir = port_dir / "minimal/phase0/demo/h/s/ok"
    assert snappy.decompress((ok_dir / "blob.ssz_snappy").read_bytes()) \
        == b"\x01\x02"
    assert (ok_dir / "meta.yaml").read_text() == "{note: hi, bls_setting: 1}\n"
    assert not (ok_dir / "INCOMPLETE").exists()
    crash_dir = port_dir / "minimal/phase0/demo/h/s/crash"
    assert (crash_dir / "INCOMPLETE").exists()
    assert gen_runner.detect_incomplete(port_dir) == [str(crash_dir)]
    # filtered and empty cases leave no directory behind
    assert not (port_dir / "minimal/phase0/demo/h/s/filtered").exists()
    assert not (port_dir / "minimal/phase0/demo/h/s/empty").exists()
    log = (port_dir / gen_runner.ERROR_LOG).read_text()
    assert log.count("boom") == 1
    port_tree, jax_tree = _tree(port_dir), _tree(jax_dir)
    # the error log names each tree's own case directory
    assert port_tree.pop(gen_runner.ERROR_LOG).replace(
        str(port_dir).encode(), b"") == jax_tree.pop(
        jax_runner.ERROR_LOG).replace(str(jax_dir).encode(), b"")
    assert port_tree == jax_tree

    # incremental: the complete case is skipped, the crashed one retried;
    # -f regenerates the complete one; -c collects only
    calls.clear()
    providers = _lifecycle_providers(gen_typing, calls)
    gen_runner.run_generator("demo", providers, args=["-o", str(port_dir)])
    assert calls == []
    gen_runner.run_generator("demo", providers,
                             args=["-o", str(port_dir), "-f"])
    assert calls == ["good"]
    assert gen_runner.run_generator(
        "demo", providers, args=["-o", str(tmp_path / "c"), "-c"]) == 0
    assert not (tmp_path / "c" / "minimal").exists()
    # -l filters presets
    assert gen_runner.run_generator(
        "demo", providers, args=["-o", str(tmp_path / "l"), "-l",
                                 "mainnet"]) == 0
    assert not (tmp_path / "l" / "minimal").exists()


# ---------------------------------------------------------------------------
# (g) the generators and their module tables
# ---------------------------------------------------------------------------

GENERATORS = ["bls", "epoch_processing", "finality", "fork_choice", "forks",
              "genesis", "merkle", "operations", "random", "rewards",
              "sanity", "shuffling", "ssz_generic", "ssz_static",
              "transition"]
STATE_RUNNERS = ["epoch_processing", "finality", "fork_choice", "forks",
                 "genesis", "operations", "random", "rewards", "sanity",
                 "transition"]
# the JAX tables' entries the port's tables leave out, by runner: none,
# the draft forks' (sharding, custody_game) included
DRAFT_FORKS = {}


def test_every_generator_has_a_port_twin_with_a_main():
    import pkgutil

    import consensus_specs_tpu.gen.generators as jax_gens
    import consensus_specs_tpu_torch.gen.generators as port_gens

    names = sorted(m.name for m in pkgutil.iter_modules(port_gens.__path__))
    assert names == sorted(m.name for m in pkgutil.iter_modules(
        jax_gens.__path__)) == GENERATORS
    for name in names:
        mod = importlib.import_module(f"{port_gens.__name__}.{name}")
        assert callable(mod.main), name


def _relative(table, package):
    def rel(paths):
        paths = [paths] if isinstance(paths, str) else list(paths)
        assert all(p.startswith(package + ".") for p in paths), paths
        return [p[len(package) + 1:] for p in paths]
    return {fork: {h: rel(p) for h, p in mods.items()}
            for fork, mods in table.items()}


@pytest.mark.parametrize("runner", STATE_RUNNERS)
def test_module_table_equals_jax(runner):
    jax_gen = importlib.import_module(
        f"consensus_specs_tpu.gen.generators.{runner}")
    port_gen = importlib.import_module(
        f"consensus_specs_tpu_torch.gen.generators.{runner}")
    want = _relative(jax_gen.ALL_MODS, "consensus_specs_tpu.test")
    got = _relative(port_gen.ALL_MODS, "consensus_specs_tpu_torch.test")
    left_out = [fork for fork in want if fork not in got]
    assert left_out == DRAFT_FORKS.get(runner, [])
    assert got == {fork: t for fork, t in want.items()
                   if fork not in left_out}
    for mods in got.values():
        for paths in mods.values():
            for path in paths:
                importlib.import_module("consensus_specs_tpu_torch.test."
                                        + path)


def test_combine_mods_equals_jax():
    from consensus_specs_tpu.gen.gen_from_tests import combine_mods as jax
    from consensus_specs_tpu_torch.gen.gen_from_tests import combine_mods

    a, b = {"x": "m1", "y": ["m2", "m3"]}, {"x": ("m4",), "z": "m5"}
    assert combine_mods(a, b) == jax(a, b) == {
        "x": ["m1", "m4"], "y": ["m2", "m3"], "z": ["m5"]}


# ---------------------------------------------------------------------------
# (h) the random scenario-matrix codegen
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fork", ["phase0", "altair"])
def test_random_codegen_renders_the_committed_modules(fork):
    spec = importlib.util.spec_from_file_location(
        "torch_gen_random_tests",
        os.path.join(REPO, "tools", "torch_gen_random_tests.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    path = os.path.join(
        REPO, f"consensus_specs_tpu_torch/test/{fork}/random/"
              "test_random_matrix.py")
    assert tool.render(fork) == open(path).read()
    # the cases are the JAX tool's, seeds included: only the header
    # names another tool
    jax_path = os.path.join(
        REPO, f"consensus_specs_tpu/test/{fork}/random/test_random_matrix.py")
    body = tool.render(fork).split('"""', 2)[2]
    assert body == open(jax_path).read().split('"""', 2)[2]
