"""Preset and runtime-config loaders (the port's copy of
consensus_specs_tpu/config/config_util.py).

(reference: tests/core/pyspec/eth2spec/config/config_util.py:6-63 and the
compile-time loaders in setup.py:763-787)

The files under ``presets/`` and ``configs/`` are flat ``KEY: value`` lines
with comments, so the port reads them itself instead of through PyYAML:
``read_flat_yaml`` gives what ``yaml.load(f, Loader=yaml.BaseLoader)`` gives
on such a file (every value a string, quotes removed, comments dropped) and
raises on any line outside that subset.
"""
import os
import re
from pathlib import Path
from typing import Any, Dict, Sequence

# repo root holds configs/ and presets/, shared by both packages
_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
PRESETS_DIR = _REPO_ROOT / "presets"
CONFIGS_DIR = _REPO_ROOT / "configs"

_KEY = re.compile(r"^([A-Za-z_][A-Za-z0-9_]*):(?:\s+|$)(.*)$")


def _scalar(raw: str, where: str) -> str:
    """One plain or quoted YAML scalar, with any trailing comment."""
    if raw[:1] in ("'", '"'):
        quote = raw[0]
        out, i = [], 1
        while i < len(raw):
            c = raw[i]
            if c == quote:
                if quote == "'" and raw[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                rest = raw[i + 1:].strip()
                if rest and not rest.startswith("#"):
                    raise ValueError(f"{where}: text after a quoted value")
                return "".join(out)
            if c == "\\" and quote == '"':
                nxt = raw[i + 1:i + 2]
                esc = {"n": "\n", "t": "\t", '"': '"', "\\": "\\"}
                if nxt not in esc:
                    raise ValueError(f"{where}: unsupported escape \\{nxt}")
                out.append(esc[nxt])
                i += 2
                continue
            out.append(c)
            i += 1
        raise ValueError(f"{where}: unterminated quoted value")
    # a plain scalar ends at the first " #" (a YAML comment)
    m = re.search(r"\s#", raw)
    value = (raw[:m.start()] if m else raw).strip()
    if value[:1] in ("[", "{", "&", "*", "!", "|", ">") \
            or value.startswith("- "):
        raise ValueError(f"{where}: not a flat scalar: {value!r}")
    return value


def read_flat_yaml(path: os.PathLike) -> Dict[str, str]:
    """``KEY: value`` lines into a dict of strings (a repeated key keeps its
    last value, as PyYAML's loader does)."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for n, line in enumerate(f, 1):
            text = line.rstrip("\n")
            stripped = text.strip()
            if not stripped or stripped.startswith("#") or stripped == "---":
                continue
            where = f"{path}:{n}"
            if text[0].isspace():
                raise ValueError(f"{where}: nested YAML is not supported")
            m = _KEY.match(text)
            if m is None:
                raise ValueError(f"{where}: not a KEY: value line")
            out[m.group(1)] = _scalar(m.group(2).strip(), where)
    return out


def parse_config_vars(conf: Dict[str, Any]) -> Dict[str, Any]:
    """Parse YAML values into python types: 0x-prefixed strings stay as hex
    bytes markers, decimal strings become ints
    (reference: config/config_util.py:6-21)."""
    out: Dict[str, Any] = {}
    for k, v in conf.items():
        if isinstance(v, str) and v.startswith("0x"):
            out[k] = bytes.fromhex(v[2:])
        elif k == "PRESET_BASE":
            out[k] = str(v)
        elif isinstance(v, str) and v.isdigit():
            out[k] = int(v)
        else:
            out[k] = v
    return out


def load_preset(preset_files: Sequence[os.PathLike]) -> Dict[str, Any]:
    """Merge per-fork preset files with duplicate-key checking
    (reference: config/config_util.py:24-39)."""
    preset: Dict[str, Any] = {}
    for fname in preset_files:
        data = read_flat_yaml(fname)
        for k in data:
            if k in preset:
                raise KeyError(f"duplicate preset var {k!r} in {fname}")
        preset.update(data)
    return parse_config_vars(preset)


def load_config_file(path: os.PathLike) -> Dict[str, Any]:
    """(reference: config/config_util.py:42-48)"""
    return parse_config_vars(read_flat_yaml(path))


_defaults_cache: Dict[str, Dict[str, Any]] = {}

# fork lineage: preset files are merged in this order up to the built fork
# (reference: setup.py per-fork md-doc lists, :843-872)
PRESET_FORK_FILES = ["phase0", "altair", "merge", "sharding", "custody_game"]


def load_preset_for_fork(preset_name: str, fork: str) -> Dict[str, Any]:
    idx = PRESET_FORK_FILES.index(fork) if fork in PRESET_FORK_FILES else len(PRESET_FORK_FILES)
    files = []
    for name in PRESET_FORK_FILES[: idx + 1]:
        path = PRESETS_DIR / preset_name / f"{name}.yaml"
        if path.exists():
            files.append(path)
    return load_preset(files)


def load_defaults(preset_name: str) -> Dict[str, Any]:
    """Cached full config for a preset (reference: config/config_util.py:56-63)."""
    if preset_name not in _defaults_cache:
        _defaults_cache[preset_name] = load_config_file(CONFIGS_DIR / f"{preset_name}.yaml")
    return _defaults_cache[preset_name]
