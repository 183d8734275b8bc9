"""Test-harness decorator algebra of the port: its copy of
consensus_specs_tpu/test/context.py, over the port's spec builder and BLS
switchboard.

(reference: tests/core/pyspec/eth2spec/test/context.py — spec_targets :53-64,
genesis cache :83-104, balance profiles :123-199, decorators :237-516)

Conventions match the reference:
  @with_phases([...]) / @with_all_phases  — run once per fork, passing `spec`
  @spec_state_test                        — + cached genesis `state`
  @always_bls / @never_bls                — pin BLS on/off (place ABOVE
                                            @spec_state_test)
  @with_presets({MINIMAL}, reason=...)    — skip on other presets
  expect_assertion_error(fn)              — invalid-input helper

Tests are generator functions yielding (name, value) or (name, kind, value)
test-vector parts; in pytest mode the parts are drained, in generator mode
they are collected for the vector writers.

``bls`` is the port's switchboard, which verifies on the CUDA card unless
``bls.use_py_ecc()`` selected the CPU oracle; the harness never picks the
CPU by itself (the pytest fixture in ``test/harness.py`` does). The
``bls_setting`` that ``always_bls`` / ``never_bls`` set is carried outward
through every decorator, so a runner can pick the ``@always_bls`` cases
from the finished test function.
"""
import inspect
from random import Random

from ..builder import build_spec_module
from ..utils import bls

PHASE0 = "phase0"
ALTAIR = "altair"
MERGE = "merge"
# Experimental draft forks (reference helpers/constants.py:12-14) — excluded
# from ALL_PHASES so `with_all_phases` never picks them up, but runnable via
# an explicit `with_phases([SHARDING])` (executable here, unlike reference)
SHARDING = "sharding"
CUSTODY_GAME = "custody_game"
MINIMAL = "minimal"
MAINNET = "mainnet"
ALL_PHASES = (PHASE0, ALTAIR, MERGE)
EXPERIMENTAL_PHASES = (SHARDING, CUSTODY_GAME)
ALL_PRESETS = (MINIMAL, MAINNET)

DEFAULT_TEST_PRESET = MINIMAL
DEFAULT_PYTEST_FORKS = None  # None = all; set from --fork flags
DEFAULT_BLS_ACTIVE = True


class SkippedTest(Exception):
    pass


def _wraps(fn):
    """Copy only __name__/__doc__ and a ``bls_setting`` (NOT __wrapped__):
    pytest must not introspect through to the raw test signature and
    mistake `spec`/`state` for fixtures."""

    def apply(wrapper):
        wrapper.__name__ = getattr(fn, "__name__", wrapper.__name__)
        wrapper.__doc__ = getattr(fn, "__doc__", None)
        if hasattr(fn, "bls_setting"):
            wrapper.bls_setting = fn.bls_setting
        return wrapper

    return apply


def _invoke(fn, kw):
    """Call fn with only the kwargs its signature accepts (wrappers declare
    **kw and receive everything; raw test functions get filtered)."""
    sig = inspect.signature(fn)
    if any(p.kind == p.VAR_KEYWORD for p in sig.parameters.values()):
        return fn(**kw)
    accepted = {k: v for k, v in kw.items() if k in sig.parameters}
    return fn(**accepted)


def expect_assertion_error(fn):
    """(reference context.py:259-270; IndexError counts as a failed assert,
    and our SSZ layer raises ValueError where remerkleable did)"""
    bls_active = bls.bls_active
    try:
        fn()
    except (AssertionError, IndexError, ValueError):
        return
    except Exception:
        raise
    finally:
        bls.bls_active = bls_active
    raise AssertionError("expected an assertion error, but got none.")


# ---------------------------------------------------------------------------
# balance profiles (reference context.py:123-199)
# ---------------------------------------------------------------------------


def default_activation_threshold(spec):
    """Helper method to use the default balance activation threshold for state creation for tests."""
    return spec.MAX_EFFECTIVE_BALANCE


def zero_activation_threshold(spec):
    """Helper method to use 0 gwei as the activation threshold for state creation for tests."""
    return 0


def default_balances(spec):
    """Helper method to create a series of default balances. 8 validators per slot."""
    num_validators = spec.SLOTS_PER_EPOCH * 8
    return [spec.MAX_EFFECTIVE_BALANCE] * num_validators


def scaled_churn_balances(spec):
    """Validator set large enough for a churn limit ABOVE
    MIN_PER_EPOCH_CHURN_LIMIT: active_count // CHURN_LIMIT_QUOTIENT must
    exceed the minimum, so the count scales by the QUOTIENT (the +2 lands
    firmly past the boundary)."""
    num_validators = spec.config.CHURN_LIMIT_QUOTIENT * (2 + spec.config.MIN_PER_EPOCH_CHURN_LIMIT)
    return [spec.MAX_EFFECTIVE_BALANCE] * int(num_validators)


def low_balances(spec):
    """Helper method to create a series of low balances. 8 validators per slot."""
    num_validators = spec.SLOTS_PER_EPOCH * 8
    low_balance = 18 * 10**9
    return [low_balance] * num_validators


def misc_balances(spec):
    """Helper method to create a series of balances that includes some misc. balances."""
    num_validators = spec.SLOTS_PER_EPOCH * 8
    balances = [spec.MAX_EFFECTIVE_BALANCE * 2 * i // num_validators for i in range(num_validators)]
    rng = Random(1234)
    rng.shuffle(balances)
    return balances


def low_single_balance(spec):
    """A single validator with a low balance."""
    return [1]


def large_validator_set(spec):
    """Helper method to create a large series of default balances."""
    num_validators = 2 * spec.SLOTS_PER_EPOCH * spec.MAX_COMMITTEES_PER_SLOT * spec.TARGET_COMMITTEE_SIZE
    return [spec.MAX_EFFECTIVE_BALANCE] * int(num_validators)


# ---------------------------------------------------------------------------
# genesis state cache (reference context.py:83-104)
# ---------------------------------------------------------------------------

_genesis_cache = {}


def _config_key(spec):
    return tuple(sorted((k, v) for k, v in spec.config.__dict__.items()))


def get_genesis_state(spec, balances_fn, threshold_fn):
    from .helpers.genesis import create_genesis_state

    key = (spec.fork, spec.preset_base, balances_fn.__qualname__,
           threshold_fn.__qualname__, _config_key(spec))
    if key not in _genesis_cache:
        balances = balances_fn(spec)
        threshold = threshold_fn(spec)
        _genesis_cache[key] = create_genesis_state(spec, balances, threshold)
    return _genesis_cache[key].copy()


# ---------------------------------------------------------------------------
# decorators (reference context.py:237-516)
# ---------------------------------------------------------------------------


def vector_test(description=None):
    """Outermost: drains test-vector parts in pytest mode, collects them in
    generator mode (reference test/utils/utils.py:7-74)."""

    def runner(fn):
        @_wraps(fn)
        def entry(*args, **kw):
            generator_mode = kw.pop("generator_mode", False)
            out = _invoke(fn, kw)
            if out is None:
                return None
            if generator_mode:
                parts = []
                if description is not None:
                    parts.append(("description", "meta", description))
                for part in out:
                    if len(part) == 2:
                        (name, value) = part
                        if value is None:
                            # e.g. `post: None` for invalid cases — the
                            # part's absence IS the signal (formats docs)
                            continue
                        if isinstance(value, list):
                            # indexed parts + count meta (reference
                            # test/utils/utils.py:40-55)
                            for i, item in enumerate(value):
                                parts.append(_infer_part(f"{name}_{i}", item))
                            parts.append((f"{name}_count", "meta", len(value)))
                            continue
                        parts.append(_infer_part(name, value))
                    else:
                        parts.append(part)
                return parts
            # pytest mode: drain
            for _ in out:
                pass
            return None

        return entry

    return runner


def _infer_part(name, value):
    from ..utils.ssz.ssz_typing import View

    if isinstance(value, View):
        # serialize NOW: the test generator keeps mutating the live object
        # after yielding it (e.g. `yield 'pre', state` then process_*)
        return (name, "ssz", value.encode_bytes())
    if isinstance(value, bytes):
        return (name, "bytes", value)
    import copy as _copy

    return (name, "data", _copy.deepcopy(value))


def bls_switch(fn):
    """(reference context.py:299-313)"""

    @_wraps(fn)
    def entry(*args, **kw):
        old_state = bls.bls_active
        bls.bls_active = kw.pop("bls_active", DEFAULT_BLS_ACTIVE)
        try:
            res = _invoke(fn, kw)
            if res is not None:
                yield from res
        finally:
            bls.bls_active = old_state

    return entry


def always_bls(fn):
    """Force BLS on for this test via an inner bls_switch — the override is
    beyond the reach of the outer switch (reference context.py:285-296)."""

    @_wraps(fn)
    def entry(*args, **kw):
        kw["bls_active"] = True
        return bls_switch(fn)(*args, **kw)

    entry.bls_setting = 1
    return entry


def never_bls(fn):
    """Force BLS off for this test via an inner bls_switch
    (reference context.py:272-283)."""

    @_wraps(fn)
    def entry(*args, **kw):
        kw["bls_active"] = False
        return bls_switch(fn)(*args, **kw)

    entry.bls_setting = 2
    return entry


def disable_process_reveal_deadlines(fn):
    """Monkeypatch the custody fork's process_reveal_deadlines to a no-op so
    long multi-period scenarios don't mass-slash unrevealed validators
    (reference context.py:316-331)."""

    @_wraps(fn)
    def entry(*args, spec, **kw):
        has_pass = hasattr(spec, "process_reveal_deadlines")
        old = spec.process_reveal_deadlines if has_pass else None
        if has_pass:
            spec.process_reveal_deadlines = lambda state: None
        try:
            kw["spec"] = spec
            res = _invoke(fn, kw)
            if res is not None:
                yield from res
        finally:
            if has_pass:
                spec.process_reveal_deadlines = old

    entry.reveal_deadlines_setting = 1
    return entry


def spec_test(fn):
    return vector_test()(bls_switch(fn))


def with_custom_state(balances_fn, threshold_fn):
    def deco(fn):
        @_wraps(fn)
        def entry(*args, spec, **kw):
            state = get_genesis_state(spec, balances_fn, threshold_fn)
            kw["spec"] = spec
            kw["state"] = state
            return _invoke(fn, kw)

        return entry

    return deco


def with_state(fn):
    return with_custom_state(default_balances, default_activation_threshold)(fn)


def spec_state_test(fn):
    return spec_test(with_state(fn))


def spec_configured_state_test(config_overrides):
    """(reference context.py:251-256, 422-458)"""

    def deco(fn):
        return spec_test(with_config_overrides(config_overrides)(with_state(fn)))

    return deco


def with_config_overrides(config_overrides):
    """Swap `spec.config` fields for the duration of the test and yield the
    modified config as a test-vector part (reference context.py:422-458)."""

    def deco(fn):
        @_wraps(fn)
        def entry(*args, spec, **kw):
            old_config = spec.config
            new_config = old_config.copy()
            for k, v in config_overrides.items():
                setattr(new_config, k, v)
            spec.config = new_config
            try:
                kw["spec"] = spec
                res = _invoke(fn, kw)
                if res is not None:
                    yield from res
            finally:
                spec.config = old_config

        return entry

    return deco


def _phases_to_run(phases):
    from ..builder import IMPLEMENTED_FORKS

    run = [
        p for p in phases
        if p in (ALL_PHASES + EXPERIMENTAL_PHASES) and p in IMPLEMENTED_FORKS
    ]
    if DEFAULT_PYTEST_FORKS:
        run = [p for p in run if p in DEFAULT_PYTEST_FORKS]
    return run


def with_phases(phases, other_phases=None):
    """Run the test once per fork in `phases`, passing `spec` (+ `phases` dict
    of all involved fork modules when the test wants it)
    (reference context.py:350-402)."""

    def decorator(fn):
        @_wraps(fn)
        def wrapper(*args, **kw):
            run_phases = _phases_to_run(phases)
            # generator mode runs one (fork, preset) at a time via `phase`
            only_phase = kw.pop("phase", None)
            if only_phase is not None:
                run_phases = [p for p in run_phases if p == only_phase]
                if len(run_phases) == 0:
                    return None  # this test doesn't cover the requested fork
            if len(run_phases) == 0:
                import pytest

                pytest.skip("no phases to run")
            preset = kw.pop("preset", DEFAULT_TEST_PRESET)
            from ..builder import IMPLEMENTED_FORKS

            involved = (set(phases) | set(other_phases or [])) & set(IMPLEMENTED_FORKS)
            phase_dict = {
                p: build_spec_module(p, preset)
                for p in (ALL_PHASES + EXPERIMENTAL_PHASES) if p in involved
            }
            ret = None
            for phase in run_phases:
                spec = build_spec_module(phase, preset)
                kw2 = dict(kw)
                kw2["spec"] = spec
                kw2["phases"] = phase_dict
                ret = _invoke(fn, kw2)
            return ret  # generator-mode caller runs one phase at a time

        wrapper.phases = phases
        return wrapper

    return decorator


def with_all_phases(fn):
    return with_phases(ALL_PHASES)(fn)


def with_all_phases_except(exclusion_phases):
    def decorator(fn):
        return with_phases([p for p in ALL_PHASES if p not in exclusion_phases])(fn)

    return decorator


def with_presets(preset_bases, reason=None):
    """Skip unless the active preset is in `preset_bases`
    (reference context.py:405-419)."""

    def decorator(fn):
        @_wraps(fn)
        def wrapper(*args, **kw):
            if DEFAULT_TEST_PRESET not in preset_bases:
                import pytest

                pytest.skip(reason or f"preset {DEFAULT_TEST_PRESET} not supported")
            return _invoke(fn, kw)

        return wrapper

    return decorator


def only_generator(reason):
    """Mark a test as generator-only (skipped under pytest)
    (reference context.py:473-481)."""

    def decorator(fn):
        @_wraps(fn)
        def wrapper(*args, **kw):
            if not kw.get("generator_mode", False):
                import pytest

                pytest.skip(reason)
            return _invoke(fn, kw)

        return wrapper

    return decorator


def fork_transition_test(pre_fork_name, post_fork_name, fork_epoch=2):
    """Run a test across an upgrade boundary: the test receives the PRE-fork
    ``spec`` and ``state``, the POST-fork ``post_spec``, the ``fork_epoch``,
    and a ``phases`` dict; both specs' configs carry the fork epoch for the
    duration (reference context.py:484-516)."""

    def deco(fn):
        @_wraps(fn)
        def wrapper(*args, **kw):
            from ..builder import IMPLEMENTED_FORKS

            only_phase = kw.pop("phase", None)
            if only_phase is not None and only_phase != pre_fork_name:
                return None
            if pre_fork_name not in IMPLEMENTED_FORKS or post_fork_name not in IMPLEMENTED_FORKS:
                import pytest

                pytest.skip(f"{pre_fork_name}->{post_fork_name} not implemented")
            preset = kw.pop("preset", DEFAULT_TEST_PRESET)
            spec = build_spec_module(pre_fork_name, preset)
            post_spec = build_spec_module(post_fork_name, preset)
            epoch_attr = f"{post_fork_name.upper()}_FORK_EPOCH"

            old_pre_config, old_post_config = spec.config, post_spec.config
            for mod in (spec, post_spec):
                new_config = mod.config.copy()
                setattr(new_config, epoch_attr, mod.Epoch(fork_epoch))
                mod.config = new_config
            try:
                state = get_genesis_state(
                    spec, default_balances, default_activation_threshold
                )
                kw.update(
                    spec=spec,
                    post_spec=post_spec,
                    state=state,
                    fork_epoch=fork_epoch,
                    phases={pre_fork_name: spec, post_fork_name: post_spec},
                )
                inner = spec_test(fn)
                parts = inner(*args, **kw)
                if kw.get("generator_mode") and parts is not None:
                    parts = [
                        ("fork", "meta", post_fork_name),
                        ("fork_epoch", "meta", int(fork_epoch)),
                    ] + list(parts)
                return parts
            finally:
                spec.config = old_pre_config
                post_spec.config = old_post_config

        wrapper.phases = [pre_fork_name]
        return wrapper

    return deco


def spec_targets():
    from ..builder import spec_targets as _targets

    return _targets()
