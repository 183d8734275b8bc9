"""Test-vector generator typing of the port (the counterpart of
consensus_specs_tpu/gen/gen_typing.py; reference:
gen_helpers/gen_base/gen_typing.py:16-35)."""
from dataclasses import dataclass
from typing import Any, Callable, Iterable, List, Tuple

# a case function returns a list of (name, kind, value) parts;
# kinds: "meta" (yaml scalar collection), "data" (yaml), "ssz" (ssz_snappy),
# "bytes" (raw ssz_snappy)
TestCasePart = Tuple[str, str, Any]


@dataclass
class TestCase:
    fork_name: str
    preset_name: str
    runner_name: str
    handler_name: str
    suite_name: str
    case_name: str
    case_fn: Callable[[], List[TestCasePart]]


@dataclass
class TestProvider:
    """prepare() runs once (e.g. switch the BLS backend); make_cases yields
    the provider's TestCases."""
    prepare: Callable[[], None]
    make_cases: Callable[[], Iterable[TestCase]]
